"""One live 10,000-validator consensus round verified on the CUDA card by
the port's sidecar daemon: the twin of tools/tpu_live_round.py.

One running validator (``ConsensusState``, kvstore app, power 40) and
``--co`` co-signers (power 1 each; 9,999 make ``MaxVotesCount`` = 10,000,
types/vote_set.go:14-19). When the node proposes height 1, a relay thread
signs every co-signer's prevote and precommit and floods them into the
receive loop. ``--mixed`` splits the co-signers round-robin over ed25519,
sr25519 and secp256k1.

The node runs unmodified with ``crypto_backend=sidecar``
(``set_default_backend``, ``configure_sidecar``, ``cs.verify_backend``):
every batched vote verify ships to ``python -m tmtpu_torch sidecar``,
which this tool starts on a unix socket in a temporary home, waits for,
and stops with SIGTERM at the end (it must exit 0). The tool reaches the
port only through that process and the wire protocol; it imports nothing
of ``tmtpu_torch`` and loads no JAX.

The run fails (``"ok": false``, exit 1) if any lane fell back to in-process
verification (``sidecar_client_fallback``, counted until the node has
stopped: the daemon stops last), if JAX was loaded in this process, if a
curve of the round got no dispatch, or, on the card, no launch of its
kernel; at full scale (5,000 co-signers or more) also if the flood did not
ride flushes of 500 votes or more. ``node_flush_s`` is the part of the
window inject -> commit that the consensus thread spent in its flushes to
the daemon. Signing is pure Python where the ``cryptography`` package is absent,
so it runs in a pool of processes after the proposal and is reported
apart (``sign_s``); ``inject_to_commit_s`` is the measured window.

One JSON line, last on stdout. ``--device cpu`` runs the daemon's plain
versions (tests); such a run reports ``"device": "cpu"`` and no card.

    python3 tools/gpu_live_round.py [--co 9999] [--mixed]
    python3 tools/gpu_live_round.py --device cpu --co 31
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tmtpu.crypto import ed25519, secp256k1, sr25519  # noqa: E402
from tools.gpu_common import Daemon, launch_delta, smi_line  # noqa: E402

CHAIN_ID = "live-round-chain"
CURVES = ("ed25519", "sr25519", "secp256k1")
KERNELS = {"ed25519": "ed25519_verify", "sr25519": "sr25519_verify",
           "secp256k1": "k1_verify"}
_PRIV = {"ed25519": ed25519.PrivKeyEd25519, "sr25519": sr25519.PrivKeySr25519,
         "secp256k1": secp256k1.PrivKeySecp256k1}
_PUB = {"ed25519": ed25519.PubKeyEd25519, "sr25519": sr25519.PubKeySr25519,
        "secp256k1": secp256k1.PubKeySecp256k1}
FULL_SCALE = 5000
ROUND_TIMEOUT_S = 900.0


def _keygen(task):
    """(curve, secret) -> (private key bytes, public key bytes)."""
    curve, secret = task
    priv = _PRIV[curve](hashlib.sha256(secret).digest())
    return priv.bytes(), priv.pub_key().bytes()


def _sign(task):
    """(curve, private key bytes, [sign bytes]) -> [signatures]."""
    curve, priv_bytes, msgs = task
    priv = _PRIV[curve](priv_bytes)
    return [priv.sign(m) for m in msgs]


def co_signers(n, mixed, seed, pool):
    """[(curve, private key bytes, public key)] of ``n`` co-signers."""
    curves = [CURVES[i % 3] if mixed else "ed25519" for i in range(n)]
    tasks = [(c, b"live-round %d %d" % (seed, i)) for i, c in enumerate(curves)]
    keys = pool.map(_keygen, tasks, chunksize=64)
    return [(c, priv, _PUB[c](pub)) for c, (priv, pub) in zip(curves, keys)]


def run(args) -> dict:
    from tmtpu.abci.example.kvstore import KVStoreApplication
    from tmtpu.config.config import ConsensusConfig, SidecarConfig
    from tmtpu.consensus.state import ConsensusState
    from tmtpu.crypto import batch as crypto_batch
    from tmtpu.libs import breaker as _bk
    from tmtpu.libs import metrics as _m
    from tmtpu.libs.db import MemDB
    from tmtpu.proxy import AppConns, LocalClientCreator
    from tmtpu.state.execution import BlockExecutor
    from tmtpu.state.state import state_from_genesis
    from tmtpu.state.store import StateStore
    from tmtpu.store.block_store import BlockStore
    from tmtpu.types.event_bus import EventBus
    from tmtpu.types.genesis import GenesisDoc, GenesisValidator
    from tmtpu.types.priv_validator import MockPV
    from tmtpu.types.vote import PRECOMMIT, PREVOTE, Vote

    # a core a thousand co-signers, at most every core
    workers = min(os.cpu_count() or 1, max(1, args.co // 1000))
    pool = multiprocessing.get_context("spawn").Pool(workers)
    daemon = None
    try:
        t0 = time.perf_counter()
        cos = co_signers(args.co, args.mixed, args.seed, pool)
        keygen_s = time.perf_counter() - t0
        print(f"live_round: {args.co} co-signers in {keygen_s:.1f} s", file=sys.stderr)
        live_pv = MockPV(ed25519.gen_priv_key_from_secret(b"live-round live %d" % args.seed))
        gen = GenesisDoc(
            chain_id=CHAIN_ID, genesis_time=time.time_ns(),
            validators=[GenesisValidator(live_pv.get_pub_key(), 40)]
            + [GenesisValidator(pub, 1) for _c, _p, pub in cos])
        genesis_state = state_from_genesis(gen)
        vals = genesis_state.validators
        assert vals.get_proposer().pub_key.equals(live_pv.get_pub_key()), \
            "the live validator must propose height 1"
        idx_by_addr = {v.address: i for i, v in enumerate(vals.validators)}

        # the daemon is up and warm before consensus starts: no request
        # waits for the kernels' build
        daemon = Daemon(args.device)
        ready_s = daemon.start_s
        print(f"live_round: {daemon.ready.strip()} (ready in {ready_s:.1f} s)",
              file=sys.stderr)
        # the reference's 10 s; a dispatch of the plain versions takes seconds
        deadline_s = 120.0 if args.device == "cpu" else 10.0
        crypto_batch.configure_sidecar(SidecarConfig(
            addr=daemon.addr, request_deadline_ns=int(deadline_s * 1e9)))
        crypto_batch.set_default_backend("sidecar")
        _bk.get(crypto_batch.SIDECAR_BREAKER_NAME).reset()
        stats0 = daemon.stats()

        app = KVStoreApplication()
        conns = AppConns(LocalClientCreator(app))
        conns.start()
        state_store = StateStore(MemDB())
        state_store.save(genesis_state)
        bus = EventBus()
        exec_ = BlockExecutor(state_store, conns.consensus, event_bus=bus)
        cs = ConsensusState(ConsensusConfig.test_config(), genesis_state, exec_,
                            BlockStore(MemDB()), event_bus=bus, priv_validator=live_pv)
        cs.verify_backend = "sidecar"

        flushes = []  # (lanes, start, end) of each flush the node shipped
        real_pending = crypto_batch.SidecarBatchVerifier._verify_pending

        def counting(self, items, tally):
            t0 = time.perf_counter()
            try:
                return real_pending(self, items, tally)
            finally:
                flushes.append((len(items), t0, time.perf_counter()))

        crypto_batch.SidecarBatchVerifier._verify_pending = counting
        fallback0 = sum(_m.sidecar_client_fallback.summary_series().values())
        t = {}
        relay_stop = threading.Event()
        relay = []

        def flood(proposal):
            # sign everything, then inject: 10,000 validators sign at once in
            # a real network, not one after another on this host
            t0 = time.perf_counter()
            votes = {vt: [] for vt in (PREVOTE, PRECOMMIT)}
            for _c, _p, pub in cos:
                addr = pub.address()
                for vt in votes:
                    votes[vt].append(Vote(
                        type=vt, height=proposal.height, round=proposal.round,
                        block_id=proposal.block_id, timestamp=time.time_ns(),
                        validator_address=addr, validator_index=idx_by_addr[addr]))
            tasks = [(c, priv, [votes[PREVOTE][i].sign_bytes(CHAIN_ID),
                                votes[PRECOMMIT][i].sign_bytes(CHAIN_ID)])
                     for i, (c, priv, _pub) in enumerate(cos)]
            for i, (pv_sig, pc_sig) in enumerate(pool.map(_sign, tasks, chunksize=32)):
                votes[PREVOTE][i].signature = pv_sig
                votes[PRECOMMIT][i].signature = pc_sig
            t["sign_s"] = time.perf_counter() - t0
            t["inject"] = time.perf_counter()
            for v in votes[PREVOTE] + votes[PRECOMMIT]:
                if relay_stop.is_set():
                    return
                cs.add_vote_msg(v, peer_id="relay")

        def on_proposal(proposal, parts):
            if proposal.height != 1 or "proposal" in t:
                return
            t["proposal"] = time.perf_counter()
            relay.append(threading.Thread(target=flood, args=(proposal,), daemon=True,
                                          name="vote-relay"))
            relay[0].start()

        cs.on_own_proposal = on_proposal
        try:
            cs.start()
            committed = cs.wait_for_height(1, timeout=ROUND_TIMEOUT_S)
            t_commit = time.perf_counter()
            stats1 = daemon.stats()
        finally:
            # the node stops before the daemon: no flush of its shutdown may
            # find the daemon gone and verify in process
            relay_stop.set()
            for th in relay:
                th.join(timeout=60)
            cs.stop()
            conns.stop()
            for th in threading.enumerate():
                if th.name == "cs-receive":
                    th.join(timeout=60)
            crypto_batch.SidecarBatchVerifier._verify_pending = real_pending
        if not committed:
            raise RuntimeError(f"stuck at {cs.rs.height_round_step()}")
        fallback = sum(_m.sidecar_client_fallback.summary_series().values()) - fallback0
        crypto_batch.reset_sidecar_client()
        rc = daemon.stop()
        daemon = None
    finally:
        pool.terminate()
        pool.join()
        if daemon is not None:
            daemon.stop()

    commit = cs.block_store.load_seen_commit(1)
    signed = sum(1 for s in commit.signatures if not s.is_absent()) if commit else 0
    coal0, coal1 = stats0["coalescer"], stats1["coalescer"]
    dispatches = coal1["dispatches"] - coal0["dispatches"]
    requests = coal1["dispatched_requests"] - coal0["dispatched_requests"]
    lanes = coal1["dispatched_lanes"] - coal0["dispatched_lanes"]
    by_curve = {c: coal1["dispatches_by_curve"].get(c, 0)
                - coal0["dispatches_by_curve"].get(c, 0) for c in CURVES}
    launches = launch_delta(stats0, stats1)
    on_card = stats1["backend"] == "gpu"
    t_inject = t.get("inject", t["proposal"])
    # the round's flushes, up to the commit, and the seconds of the window
    # inject -> commit that the consensus thread spent in them
    flushes = [f for f in flushes if f[1] < t_commit]
    batched = [n for n, *_ in flushes if n >= 16]

    def in_window(fs):
        return sum(max(0.0, min(end, t_commit) - max(start, t_inject)) for _n, start, end in fs)
    vpf = sum(batched) / max(1, len(batched))
    curves = CURVES if args.mixed else ("ed25519",)
    failures = []
    if fallback:
        failures.append(f"{fallback:g} lanes fell back to in-process verification")
    if rc != 0:
        failures.append(f"the daemon exited {rc} on SIGTERM")
    if "jax" in sys.modules:
        failures.append("JAX was loaded in the node's process")
    if commit is None or len(commit.signatures) != args.co + 1:
        failures.append("the seen commit does not hold every validator")
    for c in curves:
        if not by_curve[c]:
            failures.append(f"no {c} dispatch in the daemon")
        if on_card and not launches[KERNELS[c]]:
            failures.append(f"no launch of {KERNELS[c]} in the daemon")
    if args.co >= FULL_SCALE:
        if vpf < 500:
            failures.append(f"the batching window collapsed: {[n for n, *_ in flushes[:20]]}")
        if sum(batched) < 1.5 * args.co:
            failures.append(f"{sum(batched)} lanes batched < 1.5 x {args.co}")
    round_s = t_commit - t["proposal"]
    return {
        "metric": "live_validator_round_gpu_sidecar",
        "ok": not failures,
        "failures": failures,
        "proposal_to_commit_s": round_s,
        "inject_to_commit_s": t_commit - t_inject,
        "sign_s": t.get("sign_s", 0.0),
        "keygen_s": keygen_s,
        "validators": args.co + 1,
        "mixed": bool(args.mixed),
        "device": stats1["device"]["kind"] if on_card else "cpu",
        "daemon_ready_s": ready_s,
        "node_flushes": len(flushes),
        "node_flushes_batched": len(batched),
        "votes_per_flush": vpf,
        "lanes_batched": sum(batched),
        "node_flush_s": in_window(flushes),
        "node_flush_s_batched": in_window([f for f in flushes if f[0] >= 16]),
        "daemon_dispatches": dispatches,
        "daemon_dispatches_by_curve": by_curve,
        "daemon_dispatch_lanes": lanes,
        "daemon_requests": requests,
        "daemon_requests_per_dispatch": requests / max(1, dispatches),
        "launches": launches,
        "cache_stats": stats1["engine"]["last_cache_stats"],
        "fallback_lanes": fallback,
        "precommits_in_commit": signed,
        "card": smi_line() if on_card else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--co", type=int, default=9_999, help="co-signers (power 1 each)")
    ap.add_argument("--mixed", action="store_true",
                    help="co-signers round-robin over ed25519, sr25519, secp256k1")
    ap.add_argument("--device", default=None,
                    help="the daemon's device: default the CUDA card; cpu for tests")
    ap.add_argument("--seed", type=int, default=0, help="seed of every key")
    args = ap.parse_args(argv)
    out = run(args)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
