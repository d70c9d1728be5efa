"""``tools/gpu_flush_ab.py`` on the CPU: this tree against itself as the
parent, a few lanes, one round (parent, this, this, parent), each tree in
a worker process of its own with its own daemon. The plain versions take
seconds a flush, so only the tool's plumbing and its results' shape are
checked here; the times mean something only on the card."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_flush_ab_takes_turns_and_reports_ratios():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "gpu_flush_ab.py"), "--device", "cpu",
         "--parent", ROOT, "--lanes", "8", "--rounds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == ["parent", "this"]
    out = json.loads(lines[-1])
    assert out["lanes"] == 8 and out["samples"] == 2 and out["card"] == "cpu"
    metrics = {"flush_ms", "flush_off_ms", "mesh_ms", "rtt_ms"}
    for tree in ("parent", "this"):
        assert set(out[tree]) == metrics and all(v > 0 for v in out[tree].values())
        assert all(lo <= hi for lo, hi in out["spread"][tree].values())
    assert set(out["ratio"]) == metrics and all(r > 0 for r in out["ratio"].values())
