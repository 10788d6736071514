"""Geometry the Helmholtz slice needs: boxes, circles, point helpers and
ellipses. Port counterparts of the same modules of `butterfly_tpu/geom/`,
copied; `poisson_disk`, `trimesh` and `visibility` wait for later slices."""

from butterfly_tpu_torch.geom.bbox import Bbox
from butterfly_tpu_torch.geom.circle import Circle, circles_are_separated
from butterfly_tpu_torch.geom.ellipse import Ellipse
from butterfly_tpu_torch.geom.points import (
    as_points,
    bounding_box,
    insert_points_sorted,
    pairwise_dists,
)

__all__ = [
    "Bbox",
    "Circle",
    "circles_are_separated",
    "Ellipse",
    "as_points",
    "bounding_box",
    "insert_points_sorted",
    "pairwise_dists",
]
