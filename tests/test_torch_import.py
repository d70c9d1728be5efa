"""The port stands alone: no module of tmtpu_torch, and none of chip_smoke.py,
kernel_times.py and bench_torch.py, imports jax or anything of the JAX package tmtpu, nor the ``cryptography``
package (the machine with the card has none; the port signs and verifies
secp256k1 with its own pure-Python curve). The device tools ``tools/gpu_*.py``
keep one of two rules: node-side tools load no ``tmtpu_torch``, ``torch`` or
``jax``; port-side tools load no ``tmtpu`` or ``jax``."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, name) for name in ("chip_smoke.py", "kernel_times.py",
                                                 "bench_torch.py")]
    for dirpath, dirs, files in os.walk(os.path.join(ROOT, "tmtpu_torch")):
        dirs[:] = [d for d in dirs if d != "build"]  # kernel build outputs
        out += [os.path.join(dirpath, f) for f in sorted(files) if f.endswith(".py")]
    return sorted(out)


def _module_names():
    names = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        names.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return names


def test_every_module_imports_without_jax_or_tmtpu():
    code = (
        "import importlib, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tmtpu', 'cryptography')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_mesh_and_bench_are_covered():
    names = _module_names()
    assert {"tmtpu_torch.entry", "tmtpu_torch.gpu.sharding", "bench_torch"} <= set(names)


def test_host_prep_and_cache_are_covered():
    """The C host prep's binding and the signature cache are among the
    modules checked above, and the C source includes system headers only:
    it is the port's own copy and the build reads nothing of tmtpu."""
    names = _module_names()
    assert "tmtpu_torch.native" in names and "tmtpu_torch.crypto.sigcache" in names
    with open(os.path.join(ROOT, "tmtpu_torch", "native", "hostprep.c"), encoding="utf-8") as fh:
        includes = re.findall(r"^#include\s*(\S+)", fh.read(), re.M)
    assert includes and all(i.startswith("<") for i in includes), includes


_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|tmtpu|cryptography)\b", re.M)


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in _port_files()])
def test_no_source_line_imports_jax_or_tmtpu(path):
    with open(os.path.join(ROOT, path), encoding="utf-8") as fh:
        assert not _IMPORT.search(fh.read())


def test_config_and_metrics_are_covered():
    assert {"tmtpu_torch.config", "tmtpu_torch.sidecar.metrics"} <= set(_module_names())


LIBS = ("tmtpu_torch.libs.trace", "tmtpu_torch.libs.metrics")


def test_observability_libraries_are_covered_and_stand_alone():
    """The port's copies of the reference's span ring and metric registry
    are among the modules checked above, and load behind a hook
    that refuses ``jax``, ``tmtpu`` and ``torch``: they are copies, not
    bindings, and need nothing of the device."""
    assert set(LIBS) <= set(_module_names())
    _import_behind_hook(LIBS, ("jax", "jaxlib", "tmtpu", "torch"))


# --- the device tools, tools/gpu_*.py ---------------------------------------------

_GPU_TOOLS = sorted(f for f in os.listdir(os.path.join(ROOT, "tools"))
                    if f.startswith("gpu_") and f.endswith(".py"))
# node-side: import tmtpu, reach the port only through the daemon's process
NODE_SIDE = ("gpu_common.py", "gpu_light_bench.py", "gpu_live_round.py",
             "gpu_localnet_ab.py")
# port-side: import tmtpu_torch, torch and numpy, as bench_torch.py does
PORT_SIDE = ("gpu_breakdown.py", "gpu_curve_bench.py", "gpu_port_common.py")


def _import_behind_hook(names, blocked):
    """Import ``names`` in a fresh interpreter whose import hook refuses
    ``blocked``; then require that none of them was loaded."""
    code = (
        "import importlib, importlib.abc, sys\n"
        f"BLOCKED = {tuple(blocked)!r}\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        f"for name in {list(names)!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stdout + proc.stderr


def test_every_gpu_tool_keeps_one_import_rule():
    assert set(_GPU_TOOLS) == set(NODE_SIDE) | set(PORT_SIDE)
    assert not set(NODE_SIDE) & set(PORT_SIDE)


def test_gpu_tools_load_no_jax_and_no_port_module():
    """Each node-side ``tools/gpu_*.py`` imports behind a hook that refuses
    ``jax``, ``torch`` and ``tmtpu_torch``: the tools run tmtpu nodes on the
    machine with the card, and reach the port only through the daemon's
    process."""
    assert {"gpu_live_round.py", "gpu_localnet_ab.py"} <= set(NODE_SIDE)
    _import_behind_hook([f"tools.{f[:-3]}" for f in NODE_SIDE],
                        ("jax", "jaxlib", "torch", "tmtpu_torch"))


def test_port_side_gpu_tools_load_no_jax_and_no_tmtpu():
    """Each port-side ``tools/gpu_*.py`` imports behind a hook that refuses
    ``jax`` and ``tmtpu``: they drive the port's modules directly, as
    bench_torch.py does."""
    _import_behind_hook([f"tools.{f[:-3]}" for f in PORT_SIDE], ("jax", "jaxlib", "tmtpu"))


@pytest.mark.parametrize("name", NODE_SIDE)
def test_no_gpu_tool_line_imports_the_port(name):
    with open(os.path.join(ROOT, "tools", name), encoding="utf-8") as fh:
        assert not re.search(r"^\s*(from|import)\s+(tmtpu_torch|torch|jax)\b", fh.read(), re.M)


@pytest.mark.parametrize("name", PORT_SIDE)
def test_no_port_side_tool_line_imports_tmtpu(name):
    with open(os.path.join(ROOT, "tools", name), encoding="utf-8") as fh:
        assert not _IMPORT.search(fh.read())
