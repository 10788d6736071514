"""Hankel functions for the Helmholtz kernels, host path.

Port counterpart of the host half of `butterfly_tpu/ops/special.py`
(`hankel1_0_host`, `hankel1_1_host`, :182-187): scipy's Hankel functions of
the first kind, evaluated in float64 at factorization time. The JAX
package's jnp series (:85-180) serves only its `Helm2.kernel_matrix_jnp`,
whose only caller is its test `tests/test_helm2.py:29`; the port does not
carry either (see `ops/helm2.py`) and assembles kernels on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.special as _ss

__all__ = ["hankel1_0_host", "hankel1_1_host"]


def hankel1_0_host(x: np.ndarray) -> np.ndarray:
    return _ss.hankel1(0, np.asarray(x))


def hankel1_1_host(x: np.ndarray) -> np.ndarray:
    return _ss.hankel1(1, np.asarray(x))
