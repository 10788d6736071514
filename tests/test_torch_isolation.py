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
    "butterfly_tpu_torch.entry",
    "butterfly_tpu_torch.examples",
    "butterfly_tpu_torch.examples.bf_lbo",
    "butterfly_tpu_torch.examples.covariance",
    "butterfly_tpu_torch.examples.fast_direct_solver",
    "butterfly_tpu_torch.examples.fiedler_tree",
    "butterfly_tpu_torch.examples.helm2_bie",
    "butterfly_tpu_torch.examples.helm2_scale",
    "butterfly_tpu_torch.examples.multidevice",
    "butterfly_tpu_torch.examples.multiple_scattering",
    "butterfly_tpu_torch.examples.partition_floor",
    "butterfly_tpu_torch.examples.radiosity",
    "butterfly_tpu_torch.examples.real_fac_scale",
    "butterfly_tpu_torch.examples.retrieval",
    "butterfly_tpu_torch.examples.retrieval_lbo",
    "butterfly_tpu_torch.examples.tree_evaluator",
    "butterfly_tpu_torch.fac",
    "butterfly_tpu_torch.fac.device_solve",
    "butterfly_tpu_torch.fac.distill",
    "butterfly_tpu_torch.fac.helm2",
    "butterfly_tpu_torch.fac.middle_out",
    "butterfly_tpu_torch.fac.partition",
    "butterfly_tpu_torch.fac.solver",
    "butterfly_tpu_torch.fac.streamer",
    "butterfly_tpu_torch.fac.uniformize",
    "butterfly_tpu_torch.geom",
    "butterfly_tpu_torch.geom.bbox",
    "butterfly_tpu_torch.geom.circle",
    "butterfly_tpu_torch.geom.ellipse",
    "butterfly_tpu_torch.geom.native",
    "butterfly_tpu_torch.geom.points",
    "butterfly_tpu_torch.geom.poisson_disk",
    "butterfly_tpu_torch.geom.trimesh",
    "butterfly_tpu_torch.geom.visibility",
    "butterfly_tpu_torch.io",
    "butterfly_tpu_torch.io.serialization",
    "butterfly_tpu_torch.models",
    "butterfly_tpu_torch.models.bie",
    "butterfly_tpu_torch.models.covariance",
    "butterfly_tpu_torch.models.lbo",
    "butterfly_tpu_torch.models.radiosity",
    "butterfly_tpu_torch.models.retrieval",
    "butterfly_tpu_torch.ops",
    "butterfly_tpu_torch.ops.butterfly",
    "butterfly_tpu_torch.ops.cellsp",
    "butterfly_tpu_torch.ops.cheb",
    "butterfly_tpu_torch.ops.device_eigs",
    "butterfly_tpu_torch.ops.eval_tree",
    "butterfly_tpu_torch.ops.fused_butterfly",
    "butterfly_tpu_torch.ops.helm2",
    "butterfly_tpu_torch.ops.hostpack",
    "butterfly_tpu_torch.ops.linalg",
    "butterfly_tpu_torch.ops.linop",
    "butterfly_tpu_torch.ops.packed",
    "butterfly_tpu_torch.ops.quadrature",
    "butterfly_tpu_torch.ops.special",
    "butterfly_tpu_torch.ops.svd",
    "butterfly_tpu_torch.parallel",
    "butterfly_tpu_torch.parallel.launch",
    "butterfly_tpu_torch.parallel.pipeline",
    "butterfly_tpu_torch.parallel.sharding",
    "butterfly_tpu_torch.parallel.shmap_butterfly",
    "butterfly_tpu_torch.trees",
    "butterfly_tpu_torch.trees.fiedler_tree",
    "butterfly_tpu_torch.trees.interval_tree",
    "butterfly_tpu_torch.trees.native",
    "butterfly_tpu_torch.trees.point_tree",
    "butterfly_tpu_torch.trees.tree",
    "butterfly_tpu_torch.utils",
    "butterfly_tpu_torch.utils.debug",
    "butterfly_tpu_torch.utils.device",
    "butterfly_tpu_torch.utils.errors",
    "butterfly_tpu_torch.utils.logging",
    "butterfly_tpu_torch.utils.nvcc",
    "butterfly_tpu_torch.utils.oracle",
    "butterfly_tpu_torch.utils.prng",
    "butterfly_tpu_torch.utils.profiling",
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
from butterfly_tpu_torch.fac.partition import PartitionPlan
from butterfly_tpu_torch.ops.cellsp import Cell, CellPlan
from butterfly_tpu_torch.ops.linop import Dense
from butterfly_tpu_torch.ops.packed import pack
from butterfly_tpu_torch.ops.linalg import solve_gmres_device, solve_gmres_plan
from butterfly_tpu_torch.fac.device_solve import DeviceSolver
from butterfly_tpu_torch.fac.solver import FastDirectSolver
from butterfly_tpu_torch.examples.helm2_scale import run_one
from butterfly_tpu_torch.examples.fast_direct_solver import (
    factor_operator, run_device)
from butterfly_tpu_torch.entry import entry
from butterfly_tpu_torch.models.retrieval import (
    compress_table, compress_table_deep)
from butterfly_tpu_torch.examples import retrieval, retrieval_lbo
from butterfly_tpu_torch.examples import (
    helm2_bie, multiple_scattering, real_fac_scale)
from butterfly_tpu_torch.fac.distill import (
    distill_butterfly_batch, distill_butterfly_device)
import numpy as np
import scipy.sparse as sp
from butterfly_tpu_torch.examples import (
    bf_lbo, covariance, partition_floor)
from butterfly_tpu_torch.geom import icosphere
from butterfly_tpu_torch.models.lbo import compress_lbo_eigenfunctions
from butterfly_tpu_torch.ops.device_eigs import (
    DeviceEigSession, dense_generalized_eigh_device)

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
assert raises(lambda: CellPlan(128, [128], [Cell(0, 0, 0, None)]))
assert raises(lambda: PartitionPlan(Dense(np.eye(256))))
assert raises(lambda: pack(Dense(np.eye(4))))
fds = FastDirectSolver(np.eye(64) * 2 + 0.01, base_size=32)
assert raises(lambda: DeviceSolver(fds))
assert raises(lambda: run_one(256, 64.0, 64))
assert raises(lambda: solve_gmres_plan(lambda v: v, np.ones(4)))
assert raises(lambda: solve_gmres_device(lambda v: v, np.ones((4, 1))))
acc, fds_t, _ = factor_operator(64)
assert raises(lambda: run_device(acc, fds_t, np.random.default_rng(0)))
assert raises(entry)
assert raises(lambda: compress_table(np.ones((128, 8)), 4))
assert raises(lambda: compress_table_deep(np.ones((256, 64))))
assert raises(lambda: retrieval.main(["--n", "1024"]))
assert raises(lambda: retrieval_lbo.main(["--synthetic"]))
assert raises(lambda: helm2_bie.main(["--n", "512", "--k", "10"]))
from butterfly_tpu_torch.models.bie import card_system
assert raises(lambda: card_system(Dense(np.eye(4)), np.arange(4), np.ones(4),
                                  None, 6))
assert raises(lambda: multiple_scattering.main(["--per-boundary", "64"]))
assert raises(lambda: real_fac_scale.main(["--n", "256", "--m", "64"]))
assert raises(lambda: distill_butterfly_batch(np.ones((64, 64)), 4, 8))
assert raises(lambda: distill_butterfly_device(np.ones((64, 64)), 4, 8))
pencil = (sp.eye(8, format="csr"), sp.eye(8, format="csr"))
assert raises(lambda: DeviceEigSession(*pencil))
assert raises(lambda: dense_generalized_eigh_device(*pencil))
assert raises(lambda: compress_lbo_eigenfunctions(
    icosphere(1), eigensolver="device"))
assert raises(lambda: bf_lbo.main(["--subdiv", "1", "--eigensolver",
                                   "device"]))
assert raises(lambda: covariance.main(["--subdiv", "1", "--eigensolver",
                                       "device"]))
assert raises(lambda: retrieval_lbo.main(["--subdiv", "2", "--num-eigs",
                                          "8"]))
assert raises(lambda: partition_floor.main(["--sizes", "256"]))
from butterfly_tpu_torch.examples import radiosity as radiosity_twin
from butterfly_tpu_torch.geom.visibility import (
    CulledVisibility, ray_hits_any, segment_occluded)
from butterfly_tpu_torch.io.serialization import load_butterfly
from butterfly_tpu_torch.models.radiosity import (
    RadiosityModel, view_factor_matrix)
tris = np.random.default_rng(0).random((8, 3, 3))
rays = np.ones((4, 3))
assert raises(lambda: ray_hits_any(rays, rays, tris))
assert raises(lambda: CulledVisibility(tris, leaf_size=4))
assert raises(lambda: segment_occluded(icosphere(1), [0], [5]))
assert raises(lambda: view_factor_matrix(icosphere(1)))
assert raises(lambda: RadiosityModel(icosphere(1), 0.3))
assert raises(lambda: radiosity_twin.main(["--subdiv", "1"]))
assert raises(lambda: load_butterfly("missing.npz"))
from butterfly_tpu_torch.entry import dryrun_multichip
from butterfly_tpu_torch.examples import multidevice
from butterfly_tpu_torch.parallel.launch import run_programs, run_ranks
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError
assert raises(lambda: run_ranks(run_programs, 2, backend="gloo", args=([],)))
assert raises(lambda: dryrun_multichip(2))
assert raises(lambda: multidevice.main(["--ranks", "2"]))
try:  # NCCL takes one rank per card: no silent switch to gloo
    run_ranks(run_programs, 2, device="cuda", backend="nccl", args=([],))
    refused = False
except InvalidArgumentsError as exc:
    refused = "NCCL" in str(exc) and "backend='gloo'" in str(exc)
assert refused
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
