"""The import check: whole top-level names, and a harness that loads none."""

import os
import subprocess
import sys

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden({"daemon": ["tmtpu_torch", "tmtpu_torch.sidecar", "torch"]}) == {}
    assert run.forbidden({"daemon": ["tmtpu"]}) == {"daemon": ["tmtpu"]}
    assert run.forbidden({"c": ["tmtpu.types", "numpy"]}) == {"c": ["tmtpu"]}
    assert run.forbidden({"h": ["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]}) == {
        "h": ["flax", "jax", "jaxlib"]}
    assert run.forbidden({"a": ["jax"], "b": ["tmtpu_torchx"]}) == {"a": ["jax"]}


def test_harness_modules_load_no_jax_and_nothing_of_the_program():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run, client, wire, readers, roofline, control, series, sweep\n"
        "from benchmark.pools import ed25519_votes\n"
        "from benchmark.reference import ed25519\n"
        "from benchmark.generators import replay, votes\n"
        "import benchmark.daemon_host\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'tmtpu', 'tmtpu_torch', 'torch'})\n"
        "print(bad)\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
