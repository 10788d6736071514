"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "butterfly_tpu_torch"

SLICE_MODULES = [
    "butterfly_tpu_torch",
    "butterfly_tpu_torch.config",
    "butterfly_tpu_torch.convert",
    "butterfly_tpu_torch.fac",
    "butterfly_tpu_torch.fac.distill",
    "butterfly_tpu_torch.fac.streamer",
    "butterfly_tpu_torch.fac.uniformize",
    "butterfly_tpu_torch.ops",
    "butterfly_tpu_torch.ops.butterfly",
    "butterfly_tpu_torch.ops.fused_butterfly",
    "butterfly_tpu_torch.ops.linop",
    "butterfly_tpu_torch.ops.svd",
    "butterfly_tpu_torch.trees",
    "butterfly_tpu_torch.trees.tree",
    "butterfly_tpu_torch.utils",
    "butterfly_tpu_torch.utils.debug",
    "butterfly_tpu_torch.utils.device",
    "butterfly_tpu_torch.utils.errors",
    "butterfly_tpu_torch.utils.logging",
    "butterfly_tpu_torch.utils.nvcc",
    "butterfly_tpu_torch.utils.prng",
    "butterfly_tpu_torch.utils.timer",
]

_PROBE = """
import importlib, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "butterfly_tpu"))
assert not bad, bad

import torch
assert not torch.cuda.is_available()
from butterfly_tpu_torch.utils.errors import RuntimeButterflyError
from butterfly_tpu_torch.ops.butterfly import random_butterfly
from butterfly_tpu_torch.ops.fused_butterfly import FusedButterflyPlan
from butterfly_tpu_torch.fac.uniformize import uniformize_fused
from butterfly_tpu_torch.convert import uniform_butterfly_from_numpy
import numpy as np

def raises(fn):
    try:
        fn()
    except RuntimeButterflyError:
        return True
    return False

bf = random_butterfly(8, 4, device="cpu")
assert raises(lambda: random_butterfly(8, 4))
assert raises(lambda: FusedButterflyPlan(bf))
assert raises(lambda: uniformize_fused(np.eye(64)))
assert raises(lambda: uniform_butterfly_from_numpy(None, [np.ones((1, 2, 2, 1, 1, 1))]))
print("isolated")
"""


def test_port_imports_no_jax_and_needs_a_device():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=SLICE_MODULES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "isolated" in proc.stdout


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from) (jax|butterfly_tpu)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
