"""Geometry: boxes, circles, point helpers, ellipses and Poisson-disk
sampling (the Helmholtz slices), triangle meshes with the LBO's FEM
discretization (the LBO slice), ray-traced visibility (the radiosity
slice), and the native C++ mesh kit (`geom/native.py`, built from
`csrc/meshkit.cpp` at first use). Port counterparts of the same modules of
`butterfly_tpu/geom/`, copied."""

from butterfly_tpu_torch.geom.bbox import Bbox
from butterfly_tpu_torch.geom.circle import Circle, circles_are_separated
from butterfly_tpu_torch.geom.ellipse import Ellipse
from butterfly_tpu_torch.geom.points import (
    as_points,
    bounding_box,
    insert_points_sorted,
    pairwise_dists,
)
from butterfly_tpu_torch.geom.poisson_disk import sample_poisson_disk
from butterfly_tpu_torch.geom.trimesh import Trimesh, icosphere

__all__ = [
    "Bbox",
    "Circle",
    "circles_are_separated",
    "Ellipse",
    "as_points",
    "bounding_box",
    "insert_points_sorted",
    "pairwise_dists",
    "sample_poisson_disk",
    "Trimesh",
    "icosphere",
]
