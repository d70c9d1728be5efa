"""Build the CUDA sources under ``csrc/`` with nvcc and load them.

Each ``csrc/<name>.cu`` becomes ``build/<name>-<hash>.so``, a shared
library with a plain C interface loaded through ``ctypes``. The hash covers
every source and header in ``csrc/`` plus the compiler flags, so an edit
rebuilds and an unchanged tree reuses the library. Builds run at first use
(or through ``build_all``, which starts one nvcc per source at once and can
also build another tree's sources into another directory), never at
import. The build directory is inside the package and ignored by git.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def sources() -> list:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def _tree_hash(csrc: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            h.update(f.encode())
            with open(os.path.join(csrc, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()[:16]


def lib_path(name: str, csrc: str = CSRC, out_dir: str = BUILD_DIR) -> str:
    return os.path.join(out_dir, f"{name}-{_tree_hash(csrc)}.so")


def build_all(names=None, csrc: str = CSRC, out_dir: str = BUILD_DIR) -> dict:
    """Build every listed kernel (default: all) of ``csrc`` into ``out_dir``
    that is not built yet, one nvcc process per source, all started
    together. Returns {name: nvcc output} for the sources compiled now;
    raises if any build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name, csrc, out_dir)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built now if needed)."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(lib_path(name))
    return _LIBS[name]
