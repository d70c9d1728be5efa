"""The port stands alone: no module of tmtpu_torch, and neither chip_smoke.py
nor kernel_times.py, imports jax or anything of the JAX package tmtpu, nor the ``cryptography``
package (the machine with the card has none; the port signs and verifies
secp256k1 with its own pure-Python curve)."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "kernel_times.py")]
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
