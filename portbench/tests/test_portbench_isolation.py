"""A run loads neither JAX nor the JAX package; the reference loads nothing
of the port. Modules are compared by whole top-level names."""

from __future__ import annotations

import subprocess
import sys

from portbench import harness
from portbench.isolation import forbidden_loaded, top_level


def test_top_level_names_compare_whole():
    assert top_level("arttts_tpu_torch.ops.mas") == "arttts_tpu_torch"
    assert forbidden_loaded(["arttts_tpu_torch", "arttts_tpu_torch.ops", "jaxtyping",
                             "flaxen", "numpy"]) == []
    assert forbidden_loaded(["arttts_tpu", "arttts_tpu.models.tts", "jax.numpy", "jaxlib",
                             "flax.linen"]) == ["arttts_tpu", "arttts_tpu.models.tts",
                                                "flax.linen", "jax.numpy", "jaxlib"]


def fresh(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_imports_nothing_of_the_port():
    got = fresh(
        "import sys\n"
        "import portbench.reference.tts, portbench.reference.vocoders, portbench.work\n"
        "from portbench.isolation import forbidden_loaded\n"
        "print(forbidden_loaded(forbidden=frozenset({'arttts_tpu_torch', 'arttts_tpu', 'jax',"
        " 'jaxlib', 'flax'})))\n")
    assert got == "[]"


def test_a_run_loads_no_jax():
    got = fresh(
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench.tests.tiny import run_tiny\n"
        "from portbench.isolation import forbidden_loaded\n"
        "r = run_tiny('v2.serve', seconds=0.2)\n"
        "print(forbidden_loaded(), r['correct'])\n")
    assert got == "[] True"
