"""Whole runs of the harness on the CPU at small sizes: the port's daemon
with its plain versions (no card here), the control and planted faults.

Each run is its own process, as on the chip. The daemon on the CPU runs
the plain versions, seconds a dispatch, so the configurations keep their
shape and the cut is in validators, heights and rate. The votes mix is
built and run here though no cell of ``BENCHMARK.json`` uses it yet."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.dirname(os.path.abspath(__file__))

RUNNER = '''
import argparse, json, sys
sys.path.insert(0, {root!r})
from benchmark import run


def main():
    spec = run.load_json({root!r} + "/BENCHMARK.json")
    config, mix = {cell!r}.rsplit(".", 1)
    w = {{"name": {cell!r}, "config": config, "traffic": mix, "chips": 1}}
    conf = {{"name": config, "file": "benchmark/configs/" + config + ".json"}}
    cfg = dict(run.load_json({root!r} + "/" + conf["file"]), validators={validators},
               chain_heights=3)
    traffic = dict(run.load_json({root!r} + "/benchmark/traffic/" + mix + ".json"),
                   **{traffic!r})
    args = argparse.Namespace(workload={cell!r}, seed=2 ** 31 + 99, seconds={seconds},
                              trace={trace})
    return run.run(args, device="cpu", spec=spec, cell_override=(w, conf, cfg, traffic),
                   host={host!r})


if __name__ == "__main__":
    sys.exit(main())
'''

SMALL = {
    # the daemon's first dispatch on the CPU builds its plain tables: the
    # warm-up takes it, so the window holds whole dispatches
    "fastsync10k-ed25519.replay": {"corrupt_per_height": 8, "warm_s": 6.0},
    "localnet10k-ed25519.votes": {"rate_lanes_per_s_per_node": 20.0, "corrupt_per_wave": 8,
                                  "warm_s": 0.5, "tail_s": 0.2},
}


def _run(tmp_path, cell, trace=0, host=None, root=ROOT, seconds=8):
    runner = tmp_path / "runner.py"
    runner.write_text(RUNNER.format(root=root, cell=cell, validators=16, traffic=SMALL[cell],
                                    seconds=seconds, trace=trace, host=host))
    env = dict(os.environ, TMPDIR=str(tmp_path))
    proc = subprocess.run([sys.executable, str(runner)], capture_output=True, text=True,
                          timeout=240, env=env, cwd=root)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(tmp_path, cell):
    res, err = _run(tmp_path, cell)
    assert res["correct"] is True, err[-2000:]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"
    assert all(v["value"] == 0 and v["limit"] == 0 for v in res["checks"].values())
    assert "check mask_lanes_wrong 0 limit 0" in err


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(tmp_path, cell):
    host = [sys.executable, os.path.join(ROOT, "benchmark", "control.py"), "--serve",
            "--fault", "accept_all"]
    res, _ = _run(tmp_path, cell, host=host)
    assert res["correct"] is False
    assert res["checks"]["mask_lanes_wrong"]["value"] > 0
    assert res["checks"]["tally_wrong"]["value"] > 0


def test_sound_stand_in_is_correct(tmp_path):
    host = [sys.executable, os.path.join(ROOT, "benchmark", "control.py"), "--serve",
            "--fault", "none"]
    res, _ = _run(tmp_path, "fastsync10k-ed25519.replay", host=host)
    assert res["correct"] is True


@pytest.mark.parametrize("fault", ["flip_one", "drop_half"])
@pytest.mark.parametrize("where", ["daemon", "stand-in"])
def test_planted_fault_is_not_correct(tmp_path, fault, where):
    if where == "daemon":
        host = [sys.executable, os.path.join(HERE, "fault_host.py"), "--fault", fault]
    else:
        host = [sys.executable, os.path.join(ROOT, "benchmark", "control.py"), "--serve",
                "--fault", fault]
    res, _ = _run(tmp_path, "fastsync10k-ed25519.replay", host=host)
    assert res["correct"] is False
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["mask_lanes_wrong"] + checks["lane_count_wrong"] > 0


def test_a_new_metric_is_new_files_only(tmp_path):
    """A copy of the benchmark with one more per-layer metric: a file under
    metrics/ and an entry in BENCHMARK.json. No file of the harness changes,
    and the traced run reports it."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "tmtpu_torch"), root / "tmtpu_torch")
    (root / "benchmark" / "metrics" / "dummy_requests.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window_requests()))\n")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["per_layer"].append({"name": "dummy_requests", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "sidecar daemon",
                              "moves": "sig_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res, err = _run(tmp_path, "fastsync10k-ed25519.replay", trace=1, root=str(root))
    assert res["correct"] is True, err[-2000:]
    assert res["metrics"]["dummy_requests"]["value"] == res["attempted"] > 0
    assert "busy_s" in res["device"] and res["device"]["window_s"] == 8
