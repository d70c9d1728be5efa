"""Live consensus verified by the port's sidecar daemon, on the CPU (the
daemon runs the plain versions):

- the twin of tests/test_tpu_integration.py::
  test_100_validator_net_commits_through_device_batches: one running
  validator and 99 co-signers whose prevotes and precommits flood the
  receive loop, with ``crypto_backend=sidecar`` against the port's daemon;
- ``tools/gpu_live_round.py`` and ``tools/gpu_localnet_ab.py`` at a small
  size with ``--device cpu``, each in a process whose import hook refuses
  ``jax``, ``torch``, ``tmtpu_torch`` and ``cryptography``: the tools must
  run where neither JAX nor ``cryptography`` is installed, and reach the
  port only through the daemon's process.

Nothing may fall back to in-process verification
(``sidecar_client_fallback``)."""

import json
import os
import subprocess
import sys
import time

from tests.test_torch_sidecar import DEADLINE_S
from tmtpu.config.config import SidecarConfig
from tmtpu.crypto import batch as jbatch
from tmtpu.libs import breaker as _bk
from tmtpu.libs import metrics as _m
from tmtpu.types.vote import PRECOMMIT, PREVOTE, Vote
from tmtpu_torch.crypto import sigcache
from tmtpu_torch.sidecar.server import SidecarServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAIN_ID = "torch-consensus-chain"

# run a script as __main__ behind an import hook that refuses what the
# machine with the card lacks, or what the tools must not import
BLOCKED_RUN = """
import importlib.abc, runpy, sys
BLOCKED = ("jax", "jaxlib", "torch", "tmtpu_torch", "cryptography")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def run_tool(*argv, timeout):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TMTPU_")}
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN, *argv], cwd=ROOT,
                          env=dict(env, PYTHONPATH=ROOT), capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0 and lines, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(lines[-1])


def _fallbacks() -> float:
    return sum(_m.sidecar_client_fallback.summary_series().values())


def test_100_validator_net_commits_through_the_port_daemon(tmp_path):
    from tmtpu.abci.example.kvstore import KVStoreApplication
    from tmtpu.config.config import ConsensusConfig
    from tmtpu.consensus.state import ConsensusState
    from tmtpu.libs.db import MemDB
    from tmtpu.proxy import AppConns, LocalClientCreator
    from tmtpu.state.execution import BlockExecutor
    from tmtpu.state.state import state_from_genesis
    from tmtpu.state.store import StateStore
    from tmtpu.store.block_store import BlockStore
    from tmtpu.types.event_bus import EventBus
    from tmtpu.types.genesis import GenesisDoc, GenesisValidator
    from tmtpu.types.priv_validator import MockPV

    sigcache.DEFAULT.invalidate_all()
    srv = SidecarServer(f"unix://{tmp_path}/sc.sock", device="cpu")
    srv.start()
    prev_backend = jbatch._default_backend
    jbatch.configure_sidecar(SidecarConfig(addr=srv.addr,
                                           request_deadline_ns=int(DEADLINE_S * 1e9)))
    jbatch.set_default_backend("sidecar")
    br = _bk.get(jbatch.SIDECAR_BREAKER_NAME)
    br.reset()
    fallbacks = _fallbacks()
    flushes = []
    real = jbatch.SidecarBatchVerifier._verify_pending

    def counting(self, items, tally):
        flushes.append(len(items))
        return real(self, items, tally)

    jbatch.SidecarBatchVerifier._verify_pending = counting
    conns = None
    try:
        live_pv = MockPV()
        co_pvs = [MockPV() for _ in range(99)]
        gen = GenesisDoc(
            chain_id=CHAIN_ID, genesis_time=time.time_ns(),
            validators=[GenesisValidator(live_pv.get_pub_key(), 1000)]
            + [GenesisValidator(pv.get_pub_key(), 10) for pv in co_pvs])
        genesis_state = state_from_genesis(gen)
        vals = genesis_state.validators
        assert vals.get_proposer().pub_key.equals(live_pv.get_pub_key())
        idx_by_addr = {v.address: i for i, v in enumerate(vals.validators)}
        conns = AppConns(LocalClientCreator(KVStoreApplication()))
        conns.start()
        state_store = StateStore(MemDB())
        state_store.save(genesis_state)
        bus = EventBus()
        cs = ConsensusState(
            ConsensusConfig.test_config(), genesis_state,
            BlockExecutor(state_store, conns.consensus, event_bus=bus),
            BlockStore(MemDB()), event_bus=bus, priv_validator=live_pv)
        cs.verify_backend = "sidecar"

        def on_proposal(proposal, parts):
            if proposal.height != 1:
                return
            for vtype in (PREVOTE, PRECOMMIT):
                for pv in co_pvs:
                    addr = pv.get_pub_key().address()
                    v = Vote(type=vtype, height=proposal.height, round=proposal.round,
                             block_id=proposal.block_id, timestamp=time.time_ns(),
                             validator_address=addr, validator_index=idx_by_addr[addr])
                    pv.sign_vote(CHAIN_ID, v)
                    cs.add_vote_msg(v, peer_id="relay")

        cs.on_own_proposal = on_proposal
        try:
            cs.start()
            assert cs.wait_for_height(1, timeout=600), f"stuck at {cs.rs.height_round_step()}"
        finally:
            cs.stop()
        stats = srv.snapshot()
    finally:
        jbatch.SidecarBatchVerifier._verify_pending = real
        if conns is not None:
            conns.stop()
        srv.stop()
        jbatch.set_default_backend(prev_backend)
        jbatch.configure_sidecar(SidecarConfig())
        jbatch.reset_sidecar_client()
        br.reset()
    assert _fallbacks() == fallbacks
    commit = cs.block_store.load_seen_commit(1)
    assert cs.block_store.load_block(1) is not None
    assert commit is not None and len(commit.signatures) == 100
    assert sum(1 for s in commit.signatures if not s.is_absent()) == 100
    assert stats["coalescer"]["dispatches"] >= 1
    assert stats["coalescer"]["dispatched_lanes"] == sum(flushes)
    assert max(flushes) >= 33, flushes


def test_gpu_live_round_tool_on_a_cpu_daemon():
    out = run_tool("tools/gpu_live_round.py", "--device", "cpu", "--co", "31", timeout=600)
    assert out["ok"] is True and out["failures"] == []
    assert out["fallback_lanes"] == 0 and out["device"] == "cpu" and out["card"] is None
    assert out["validators"] == 32 and out["precommits_in_commit"] >= 22
    assert out["daemon_dispatches"] >= 1 and out["daemon_dispatches_by_curve"]["ed25519"] >= 1
    assert out["lanes_batched"] >= 31


def test_gpu_localnet_ab_tool_on_a_cpu_daemon():
    out = run_tool("tools/gpu_localnet_ab.py", "40", "--device", "cpu", timeout=900)
    sc = out["sidecar"]
    assert out["ok"] is True and sc["fallback_lanes"] == 0 and sc["daemon_exit"] == 0
    assert sc["blocks"] >= 1 and sc["dispatches"] >= 1 and out["cpu"]["blocks"] >= 1
    assert out["block_rate_ratio"] == sc["block_rate_per_min"] / out["cpu"]["block_rate_per_min"]
