"""What the node-side ``tools/gpu_*.py`` share with each other, and with
the port-side tools and ``chip_smoke.py``: the port's sidecar daemon as a
process of its own, its launch counts between two Stats, and the card's
name and power limit.

These tools import ``tmtpu`` and never ``tmtpu_torch``, ``torch`` or
``jax``: they reach the port only through ``python -m tmtpu_torch
sidecar`` and the wire protocol.
"""

from __future__ import annotations

import os
import queue
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READY_TIMEOUT_S = 600.0  # the kernels' build and the warm-up


def smi_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


class Daemon:
    """``python -m tmtpu_torch sidecar`` on a unix socket in a temporary
    home (on local TCP where that path is too long for a socket), until
    ``stop()``. ``extra_args`` are more daemon flags (``--no-sigcache``,
    ``--gather-ms``, ...)."""

    def __init__(self, device, ready_timeout_s=READY_TIMEOUT_S, extra_args=()):
        self.home = tempfile.mkdtemp(prefix="tmtpu-gpu-")
        sock = os.path.join(self.home, "sc.sock")
        addr = f"unix://{sock}" if len(sock) < 100 else "tcp://127.0.0.1:0"
        args = [sys.executable, "-m", "tmtpu_torch", "sidecar", "--home", self.home,
                "--addr", addr]
        if device:
            args += ["--device", device]
        args += list(extra_args)
        self.err_path = os.path.join(self.home, "stderr.log")
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=self._err, text=True,
                                     env=dict(os.environ, PYTHONPATH=ROOT))
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(ln) for ln in self.proc.stdout],
                         daemon=True).start()
        t0 = time.perf_counter()
        try:
            self.ready = lines.get(timeout=ready_timeout_s)
        except queue.Empty:
            self.ready = ""
        self.start_s = time.perf_counter() - t0
        if not self.ready.startswith("Sidecar listening on "):
            err = self.stderr()
            self.stop()
            raise RuntimeError(f"daemon not ready: {self.ready!r}\n{err}")
        self.addr = self.ready.split()[3]

    def stderr(self) -> str:
        self._err.flush()
        with open(self.err_path) as fh:
            return fh.read()[-4000:]

    def stats(self) -> dict:
        from tmtpu.sidecar.client import SidecarClient

        c = SidecarClient(self.addr, client_id="gpu-tool-stats", connect_timeout_s=10.0)
        try:
            return c.stats()
        finally:
            c.close()

    def stop(self) -> int:
        """SIGTERM, then the exit code (killed after 60 s: -9)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._err.close()
        shutil.rmtree(self.home, ignore_errors=True)
        return self.proc.returncode


def launch_delta(before: dict, after: dict) -> dict:
    """Each kernel's launches in the daemon between two Stats."""
    return {k: after["engine"]["launches"][k] - before["engine"]["launches"][k]
            for k in after["engine"]["launches"]}
