"""Geometry the Helmholtz slices need: boxes, circles, point helpers,
ellipses and Poisson-disk sampling. Port counterparts of the same modules
of `butterfly_tpu/geom/`, copied; `trimesh` and `visibility` wait for later
slices."""

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
]
