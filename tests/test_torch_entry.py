"""The port's entry points (tmtpu_torch/entry.py, the twin of
__graft_entry__.py) and the device half of bench.py (bench_torch.py), on
the CPU: the entry step against the reference's and the oracle, the
multi-device certificate on four CPU shards, and one JSON line from each
of bench_torch.py's modes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tmtpu.tpu import sharding as jsh
from tmtpu_torch import entry
from tmtpu_torch.crypto import ed25519_ref as ref
from tmtpu_torch.gpu import k1_verify as kv
from tmtpu_torch.gpu import sharding as sh
from tmtpu_torch.gpu import sr_verify as sv
from tmtpu_torch.gpu import verify as tv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device_only_sig_s", "pipeline",
              "structures", "lanes", "phases"}


def test_entry_step_on_the_cpu_against_the_oracle():
    step, args = entry.entry(device="cpu")
    packed, powers, host_ok = args
    assert packed.shape == (128, 32) and packed.dtype == torch.uint8
    assert powers.shape == (2, 32) and host_ok.all()
    # one real signature tiled: the reference's example batch, byte for byte
    want = np.concatenate([np.asarray(a) for a in jsh.example_batch(32)])
    np.testing.assert_array_equal(packed.numpy(), want)
    pk, r, s, _h = (p[:, 0].numpy().tobytes() for p in tv.split_packed(packed))
    assert ref.verify(pk, b"tmtpu-example-vote-sign-bytes" * 4, r + s)
    mask, sums = step(*args)
    assert mask.all() and sh.combine_limbs(sums.tolist()) == 32 * 1000


@pytest.mark.slow  # the reference's step runs op by op on XLA:CPU (~35 s)
def test_entry_step_matches_reference_entry():
    import __graft_entry__ as graft

    ref_step, ref_args = graft.entry()
    ref_mask, ref_sums, ref_bits = ref_step(*ref_args)
    step, args = entry.entry(device="cpu")
    mask, sums = step(*args)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    assert sh.combine_limbs(sums.tolist()) == jsh.limb_sums_to_int(ref_sums)
    np.testing.assert_array_equal(sh.pack_bitarray(mask).numpy().astype(np.uint32),
                                  np.asarray(ref_bits))


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(4)


@pytest.fixture(scope="module")
def cert_lanes():
    """The certificate's 1,024 lanes a curve, signed once for this module."""
    return entry.certificate_lanes(1024)


def test_dryrun_multichip_on_four_cpu_shards(cert_lanes, monkeypatch, capsys):
    monkeypatch.setattr(entry, "certificate_lanes", lambda lanes: cert_lanes)
    entry.dryrun_multichip(4, devices=("cpu",) * 4)
    lines = capsys.readouterr().out.splitlines()
    passed = [line for line in lines if ": PASS " in line]
    assert [line.split(": ")[1] for line in passed] == [
        "ed25519-plain-sharded", "ed25519-kernel-sharded", "sr25519-lane-sharded",
        "secp256k1-lane-sharded"]
    assert not any(": FAIL " in line for line in lines)
    assert "1024 lanes, tally=7147" in passed[0]  # 7 x (1024 - 3)
    assert lines[-1].startswith("dryrun_multichip(4): 4/4 paths certified")


def test_dryrun_multichip_raises_when_a_path_fails(cert_lanes, monkeypatch, capsys):
    """Every verify that says yes to every lane: each path sees its
    corrupt lanes pass, reports FAIL, and the certificate raises."""
    monkeypatch.setattr(entry, "certificate_lanes", lambda lanes: cert_lanes)

    def yes(*planes):
        return torch.ones(planes[0].shape[1], dtype=torch.bool)

    monkeypatch.setattr(tv, "verify_core_compact", lambda *a: yes(*a))
    for module in (tv, sv, kv):
        monkeypatch.setattr(module, "plain_packed", yes)
    with pytest.raises(AssertionError, match="FAILED certification"):
        entry.dryrun_multichip(4, devices=("cpu",) * 4)
    out = capsys.readouterr().out
    assert out.count(": FAIL ") == 4 and ": PASS " not in out


def test_dryrun_multichip_needs_n_devices():
    with pytest.raises(ValueError, match="4 devices asked for, 2 given"):
        entry.dryrun_multichip(4, devices=("cpu",) * 2)


@pytest.mark.parametrize("mode", [[], ["--flood", "--shards", "4"]])
def test_bench_torch_prints_one_json_line(mode):
    lanes = "96" if mode else "64"
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "bench_torch.py", "--device", "cpu", "--lanes", lanes,
                           *mode], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "sig/s" and out["value"] > 0 and out["lanes"] == int(lanes)
    if mode:
        assert out["metric"] == "multichip_flood_verify_tally"
        assert out["n_devices"] == 4 and out["shard_lanes"] == [32, 32, 32, 0]
        assert out["single_device_ref"]["lanes"] == 96
        assert out["single_device_full"]["lanes"] == 96 and out["split_speedup"] > 0
    else:
        assert BENCH_KEYS <= set(out)
        assert out["metric"] == "ed25519_batch_verify_10k_voteset_e2e"
        assert out["backend"] == "cpu" and out["pipeline"] == "sync"
        assert set(out["phases"]) == {"prepare", "transfer", "compile", "execute", "readback"}
        assert "e2e_ms_per_10k" not in out  # only for a full 10,000-vote set
