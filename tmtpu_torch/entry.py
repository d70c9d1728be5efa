"""Entry points: the port of ``__graft_entry__.py``.

- ``entry(device=None)``: the flagship step, the fused ed25519 verify +
  vote tally (``sharding.verify_tally_step_kernel``), with its arguments on
  the device: a 32-lane example batch, powers of 1000 and the host
  verdicts.
- ``dryrun_multichip(n_devices, devices=None)``: a certificate of every
  sharded verify path over a mesh of ``n_devices`` devices: ed25519 through
  the plain step and through the kernel, sr25519 and secp256k1 lane-sharded,
  each at >= 1,024 distinct lanes with known corrupt lanes, checked against
  the per-lane oracles on a sample, the exact tally, the bitarray words and
  the unsharded verifiers. On CPU shards the kernel wrappers take their
  plain versions, as the reference's CPU mesh runs its Pallas kernel in
  interpret mode. Prints PASS or FAIL per path and raises if any failed.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch

from tmtpu_torch import device as device_mod
from tmtpu_torch.gpu import sharding


def entry(device=None):
    """(step, args) with ``step(*args)`` -> (mask bool [32], limb sums)."""
    dev = device_mod.resolve(device)
    packed = sharding.example_batch(32, dev)
    powers = torch.from_numpy(sharding.power_limbs([1000] * 32)).to(dev)
    host_ok = torch.ones(32, dtype=torch.bool, device=dev)
    return sharding.verify_tally_step_kernel, (packed, powers, host_ok)


SR_CORRUPT = 7
K1_CORRUPT = 11


def certificate_lanes(lanes: int) -> dict:
    """The certificate's signed lanes, as the reference's: {curve: (pks,
    msgs, sigs, corrupt lanes)}, every key distinct."""
    from tmtpu_torch.crypto.ed25519 import PrivKeyEd25519
    from tmtpu_torch.crypto.secp256k1 import N as K1_N
    from tmtpu_torch.crypto.secp256k1 import PrivKeySecp256k1
    from tmtpu_torch.crypto.sr25519 import gen_priv_key_from_secret

    def signed(keys, msgs, corrupt, byte, bit):
        sigs = [bytearray(k.sign(m)) for k, m in zip(keys, msgs)]
        for c in corrupt:
            sigs[c][byte] ^= bit  # invalid, still well-formed
        return [k.pub_key().bytes() for k in keys], msgs, [bytes(s) for s in sigs], corrupt

    seeds = np.random.default_rng(42).integers(0, 256, (lanes, 32), dtype=np.uint8)
    ed = signed([PrivKeyEd25519(seeds[i].tobytes()) for i in range(lanes)],
                [b"dryrun-cert-vote-%06d" % i for i in range(lanes)],
                {5, lanes // 2, lanes - 1}, 3, 1)
    sr = signed([gen_priv_key_from_secret(b"cert-sr-%d" % i) for i in range(lanes)],
                [b"cert-sr-msg-%d" % i for i in range(lanes)], {SR_CORRUPT}, 1, 1)
    k1 = signed([PrivKeySecp256k1((int.from_bytes(hashlib.sha256(b"cert-k1-%d" % i).digest(),
                                                  "big") % (K1_N - 1) + 1).to_bytes(32, "big"))
                 for i in range(lanes)],
                [b"cert-k1-msg-%d" % i for i in range(lanes)], {K1_CORRUPT}, 40, 1)
    return {"ed25519": ed, "sr25519": sr, "secp256k1": k1}


def _words(mask: np.ndarray) -> np.ndarray:
    """The bitarray words of a host mask (``pack_bitarray``'s layout)."""
    return (mask.reshape(-1, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Certify every sharded path over ``devices`` (None: the first
    ``n_devices`` cards; raises with fewer). Raises AssertionError naming
    the paths that failed."""
    from tmtpu_torch.crypto import ed25519_ref as ref
    from tmtpu_torch.crypto.secp256k1 import PubKeySecp256k1
    from tmtpu_torch.crypto.sr25519 import PubKeySr25519
    from tmtpu_torch.gpu import k1_verify as kv
    from tmtpu_torch.gpu import sr_verify as sv
    from tmtpu_torch.gpu import verify as tv

    t_start = time.perf_counter()
    mesh = sharding.make_mesh(n_devices) if devices is None else tuple(devices)
    if len(mesh) != n_devices:
        raise ValueError(f"{n_devices} devices asked for, {len(mesh)} given")
    root = device_mod.resolve(mesh[0])
    # >= 1k lanes, whole bitarray words on every shard
    quantum = 32 * n_devices
    lanes = -(-1024 // quantum) * quantum
    results = {}

    def report(name, ok, detail=""):
        results[name] = ok
        print(f"dryrun_multichip({n_devices}): {name}: {'PASS' if ok else 'FAIL'} {detail} "
              f"[t={time.perf_counter() - t_start:.1f}s]", flush=True)

    def certify(name, check):
        try:
            ok, detail = check()
        except Exception as exc:  # noqa: BLE001 - every path is reported, then raised
            ok, detail = False, repr(exc)[:200]
        report(name, ok, detail)

    corpus = certificate_lanes(lanes)
    print(f"dryrun_multichip({n_devices}): prep {time.perf_counter() - t_start:.1f}s "
          f"({lanes} lanes over {', '.join(map(str, mesh))})", flush=True)

    # ---- ed25519: distinct real votes, 3 corrupt lanes, power 7 --------
    pks, msgs, sigs, corrupt = corpus["ed25519"]
    sample = sorted(corrupt | set(range(0, lanes, lanes // 13)))
    oracle = {i: ref.verify(pks[i], msgs[i], sigs[i]) for i in sample}
    expected = np.ones(lanes, dtype=bool)
    expected[sorted(corrupt)] = False
    packed, host_ok = tv.prepare_batch_packed(pks, msgs, sigs)
    limbs = sharding.power_limbs([7] * lanes)
    words = {}

    def ed_path(name, build):
        def check():
            mask_d, sums = build(mesh)(packed, limbs, host_ok)
            mask = mask_d.cpu().numpy()
            tally = sharding.combine_limbs(sums.cpu().tolist())
            words[name] = sharding.pack_bitarray(mask_d).cpu().numpy().astype(np.uint32)
            ok = (host_ok.all() and not any(oracle[c] for c in corrupt)
                  and np.array_equal(mask, expected)
                  and all(mask[i] == oracle[i] for i in sample)
                  and tally == 7 * (lanes - len(corrupt))
                  and np.array_equal(words[name], _words(expected))
                  and all(np.array_equal(w, words[name]) for w in words.values()))
            return ok, f"{lanes} lanes, tally={tally}"
        certify(name, check)

    ed_path("ed25519-plain-sharded", sharding.sharded_verify_tally_compact)
    ed_path("ed25519-kernel-sharded", sharding.sharded_verify_tally)

    # ---- sr25519 and secp256k1: lane-sharded masks ---------------------
    def mask_path(name, curve, prep, build, single, pub_cls, bad):
        c_pks, c_msgs, c_sigs, _ = corpus[curve]

        def check():
            c_packed, c_ok = prep(c_pks, c_msgs, c_sigs)
            mask = build(mesh)(c_packed).cpu().numpy() & c_ok
            want = single(c_pks, c_msgs, c_sigs, device=root)
            serial = {bad: False, 0: True, lanes - 1: True}
            serial_ok = all(pub_cls(c_pks[i]).verify_signature(c_msgs[i], c_sigs[i]) == v
                            for i, v in serial.items())
            ok = (np.array_equal(mask, want) and not mask[bad]
                  and int(mask.sum()) == lanes - 1 and serial_ok)
            return ok, f"{lanes} lanes"
        certify(name, check)

    mask_path("sr25519-lane-sharded", "sr25519", sv.prepare_sr_batch_packed,
              sharding.sharded_verify_sr, sv.batch_verify_sr, PubKeySr25519, SR_CORRUPT)
    mask_path("secp256k1-lane-sharded", "secp256k1", kv.prepare_k1_batch_packed,
              sharding.sharded_verify_k1, kv.batch_verify_k1, PubKeySecp256k1, K1_CORRUPT)

    failed = [k for k, v in results.items() if not v]
    print(f"dryrun_multichip({n_devices}): {len(results) - len(failed)}/{len(results)} "
          f"paths certified, total {time.perf_counter() - t_start:.1f}s", flush=True)
    if failed:
        raise AssertionError(f"sharded paths FAILED certification: {failed}")
