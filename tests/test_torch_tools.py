"""The last device tools of the port, on the CPU at small sizes, each run as
a script in a process whose import hook refuses what its rule forbids:

- the node-side tool (``tools/gpu_light_bench.py``) drives unmodified
  tmtpu code against the port's sidecar daemon; its hook refuses ``jax``,
  ``torch``, ``tmtpu_torch`` and ``cryptography``;
- port-side tools (``tools/gpu_curve_bench.py``, ``tools/gpu_breakdown.py``)
  drive the port's modules; their hook refuses ``jax`` and ``tmtpu``.

Besides, the light client's fused sequential path is held exact against
the port's daemon in process: a chain with one forged commit signature
verifies to the same header with ``crypto_backend=sidecar`` as with
``cpu``, and a single hop onto the forged height raises the same error.
Nothing may fall back to in-process verification."""

import json
import os
import subprocess
import sys

from tests.test_light import WEEK_NS, FabChain
from tests.test_torch_sidecar import DEADLINE_S
from tmtpu.config.config import SidecarConfig
from tmtpu.crypto import batch as jbatch
from tmtpu.crypto import ed25519 as j_ed25519
from tmtpu.crypto import secp256k1 as j_secp256k1
from tmtpu.crypto import sigcache as node_sigcache
from tmtpu.crypto import sr25519 as j_sr25519
from tmtpu.libs import breaker as _bk
from tmtpu.libs import metrics as _m
from tmtpu.light import verifier
from tmtpu_torch.crypto import sigcache as port_sigcache
from tmtpu_torch.sidecar.server import SidecarServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE_SIDE_BLOCKED = ("jax", "jaxlib", "torch", "tmtpu_torch", "cryptography")
PORT_SIDE_BLOCKED = ("jax", "jaxlib", "tmtpu")
DRIFT_NS = 10_000_000_000

# run a script as __main__ behind an import hook that refuses argv[1]
BLOCKED_RUN = """
import importlib.abc, runpy, sys
BLOCKED = tuple(sys.argv[1].split(","))
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def run_tool(blocked, *argv, timeout):
    """The tool's stdout lines, parsed; it must exit 0."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("TMTPU_")}
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN, ",".join(blocked), *argv],
                          cwd=ROOT, env=dict(env, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=timeout)
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    return lines


def _fallbacks() -> float:
    return sum(_m.sidecar_client_fallback.summary_series().values())


def test_gpu_light_bench_both_arms_on_a_cpu_daemon():
    lines = run_tool(NODE_SIDE_BLOCKED, "tools/gpu_light_bench.py", "--device", "cpu",
                     "--heights", "32", "--run", "16", "--arm", "both", timeout=600)
    *scenarios, out = lines
    assert out["ok"] is True and out["failures"] == [] and out["heights"] == 32
    assert out["reduced"] and out["card"] is None and out["sequential_ratio"] > 0
    assert len(scenarios) == 4
    for ln in scenarios:
        assert ln["reached_tip"] is True and ln["heights"] == 32
        assert set(ln) >= {"value", "unit", "provider_calls", "dispatches", "run", "wall_s",
                           "sig_s", "backend", "gen_s", "reduced", "card"}
        if ln["metric"] == "light_sequential_sync_fused":
            assert ln["headers_verified"] == 31 and ln["run"] == 16
        if ln["arm"] == "sidecar":
            assert ln["daemon_dispatches"] == ln["dispatches"] >= 1
            assert ln["fallback_lanes"] == 0 and ln["arm_fallback_lanes"] == 0
            assert ln["daemon_exit"] == 0 and ln["daemon_lanes"] >= 4


def _forged_chain(heights, k):
    chain = FabChain(heights, n_vals=4)
    cs = chain.blocks[k].commit.signatures[1]
    cs.signature = bytes([cs.signature[0] ^ 0x01]) + cs.signature[1:]
    return chain


def _adjacent_run_and_hop(chain, heights, k):
    """(headers verified from height 2, the error of the hop onto k)."""
    now_ns = chain.blocks[heights].header.time + 1_000_000_000
    node_sigcache.invalidate_all()
    n = verifier.verify_adjacent_run(chain.blocks[1],
                                     [chain.blocks[h] for h in range(2, heights + 1)],
                                     WEEK_NS, now_ns, DRIFT_NS)
    node_sigcache.invalidate_all()
    try:
        verifier.verify_adjacent(chain.blocks[k - 1].signed_header,
                                 chain.blocks[k].signed_header,
                                 chain.blocks[k].validator_set, WEEK_NS, now_ns, DRIFT_NS)
    except verifier.LightError as exc:
        return n, exc
    return n, None


def test_forged_commit_stops_the_run_at_the_same_header(tmp_path):
    heights, k = 12, 8
    chain = _forged_chain(heights, k)
    port_sigcache.DEFAULT.invalidate_all()
    srv = SidecarServer(f"unix://{tmp_path}/sc.sock", device="cpu")
    srv.start()
    prev_backend = jbatch._default_backend
    br = _bk.get(jbatch.SIDECAR_BREAKER_NAME)
    fallbacks = _fallbacks()
    try:
        jbatch.configure_sidecar(SidecarConfig(addr=srv.addr,
                                               request_deadline_ns=int(DEADLINE_S * 1e9)))
        jbatch.set_default_backend("sidecar")
        br.reset()
        on_daemon = _adjacent_run_and_hop(chain, heights, k)
        dispatched = srv.snapshot()["coalescer"]["dispatches"]
        jbatch.set_default_backend("cpu")
        in_process = _adjacent_run_and_hop(chain, heights, k)
    finally:
        srv.stop()
        jbatch.set_default_backend(prev_backend)
        jbatch.configure_sidecar(SidecarConfig())
        jbatch.reset_sidecar_client()
        br.reset()
        node_sigcache.invalidate_all()
    assert _fallbacks() == fallbacks
    assert dispatched == 2  # the run, then the hop's one forged lane
    assert on_daemon[0] == in_process[0] == k - 2
    assert isinstance(on_daemon[1], verifier.ErrInvalidHeader)
    assert type(on_daemon[1]) is type(in_process[1])


_REFERENCE_KEYS = {"ed25519": j_ed25519.PubKeyEd25519, "sr25519": j_sr25519.PubKeySr25519,
                   "secp256k1": j_secp256k1.PubKeySecp256k1}


def test_gpu_curve_bench_masks_equal_the_reference_serial_verifiers():
    from tools import gpu_curve_bench as cb

    *rows, out = run_tool(PORT_SIDE_BLOCKED, "tools/gpu_curve_bench.py", "--device", "cpu",
                          "--lanes-sr", "8", "--lanes-k1", "8", "--corrupt", "1", timeout=600)
    assert out["ok"] is True and [r["metric"] for r in rows] == [
        "sr25519_batch_verify_e2e", "secp256k1_batch_verify_e2e", "mixed_batch_verify_e2e"]
    for name, lanes in (("sr25519", 8), ("secp256k1", 8), ("mixed", 24)):
        row = out["rows"][name]
        curves, pks, msgs, sigs = cb.make_row(name, lanes, 1)
        want = [i for i, (c, pk, m, s) in enumerate(zip(curves, pks, msgs, sigs))
                if not _REFERENCE_KEYS[c](pk).verify_signature(m, s)]
        assert want == cb.corrupted_lanes(lanes, 1) == [1]
        assert row["rejected"] == want and row["lanes"] == lanes
        assert row["serial_cpu_sig_s"] > 0 and row["backend"] == "cpu"
    assert set(out["rows"]["mixed"]["curves"]) == {"ed25519", "sr25519", "secp256k1"}
    assert "host_prep_lanes_s" in out["rows"]["secp256k1"]
    assert "fair_serial_baseline" in out["rows"]["sr25519"]


def test_gpu_breakdown_stages_on_the_cpu():
    from bench_torch import make_votes

    lanes, bad_every = 64, 7
    (out,) = run_tool(PORT_SIDE_BLOCKED, "tools/gpu_breakdown.py", "--device", "cpu",
                      "--lanes", str(lanes), "--bad-every", str(bad_every), timeout=600)
    # the same votes, corrupted as the tool corrupts them, through the JAX
    # package's serial verifier in this process
    pks, msgs, sigs = make_votes(lanes)
    sigs = [bytes([sg[0] ^ 0xFF]) + sg[1:] if i % bad_every == 0 else sg
            for i, sg in enumerate(sigs)]
    want = [i for i, (pk, msg, sg) in enumerate(zip(pks, msgs, sigs))
            if not j_ed25519.PubKeyEd25519(pk).verify_signature(msg, sg)]
    assert want == list(range(0, lanes, bad_every))
    assert out["rejected_lanes"] == want and out["rejected"] == len(want)
    assert out["lanes"] == lanes and out["backend"] == "cpu"
    assert out["mask_ok"] is True and out["tally"] == 1000 * (lanes - len(want))
    assert len(out["prep_ms"]) == 1 and out["dispatch_ms"] >= 0
    assert set(out["copy"]) == {"pageable_1x", "pageable_4x"}
    assert out["copy"]["pageable_4x"]["mb"] == 4 * out["copy"]["pageable_1x"]["mb"] == 4 * 128 * 64 / 1e6
    assert len(out["step_ms"]) == len(out["kernel_ms"]) == 1
    assert set(out["queue"]) == {"1"} and out["queue"]["1"]["sig_s"] > 0
