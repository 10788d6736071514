"""2-D Helmholtz layer-potential kernels and proxy re-expansion.

Replacement for the reference's Helmholtz kernel assembly
(src/helm2.c:38-365; parameters include/bf/helm2.h:10-15; layer-potential
tables include/bf/layer_pot.h:44-72). Everything is vectorized matrix
assembly — no per-entry loops: pairwise distances + Hankel evaluations over
whole blocks. A host (NumPy+scipy) path serves factorization and oracle
tests.

Port counterpart of `butterfly_tpu/ops/helm2.py`, copied so that the port
imports nothing of the JAX package. It leaves out `kernel_matrix_jnp`
(:108-134), the on-device twin of `kernel_matrix`, with its jnp Bessel and
Hankel series (`butterfly_tpu/ops/special.py:85-180`): their only caller is
the JAX package's own test of that twin (`tests/test_helm2.py:29`). The
port assembles kernels on the host in float64, where the factorization
runs, and nothing on the card needs a kernel entry.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from butterfly_tpu_torch.geom.circle import Circle
from butterfly_tpu_torch.geom.points import pairwise_dists
from butterfly_tpu_torch.ops import special
from butterfly_tpu_torch.utils.errors import InvalidArgumentsError, check


class LayerPot(enum.Enum):
    """(reference: BfLayerPotential, include/bf/layer_pot.h:28-42)"""

    SINGLE = "single"
    PV_DOUBLE = "double"
    PV_NORMAL_DERIV_SINGLE = "sprime"
    COMBINED_FIELD = "combined"


#: Which layer potentials consume source / target normals
#: (reference: BF_LAYER_POT_USES_{SRC,TGT}_NORMALS, layer_pot.h:44-53).
USES_SRC_NORMALS = {LayerPot.PV_DOUBLE, LayerPot.COMBINED_FIELD}
USES_TGT_NORMALS = {LayerPot.PV_NORMAL_DERIV_SINGLE}

#: Layer potential used for proxy re-expansion — strips the target-normal
#: derivative (reference: BF_PROXY_LAYER_POT, layer_pot.h:63-72).
PROXY_LAYER_POT = {
    LayerPot.SINGLE: LayerPot.SINGLE,
    LayerPot.PV_DOUBLE: LayerPot.PV_DOUBLE,
    LayerPot.PV_NORMAL_DERIV_SINGLE: LayerPot.SINGLE,
    LayerPot.COMBINED_FIELD: LayerPot.COMBINED_FIELD,
}


@dataclasses.dataclass(frozen=True)
class Helm2:
    """Helmholtz problem parameters (reference: BfHelm2, include/bf/helm2.h:10-15)."""

    k: float
    layer_pot: LayerPot = LayerPot.SINGLE
    alpha: complex = 1.0  # combined-field weights
    beta: complex = 0.0

    def proxy(self) -> "Helm2":
        """The kernel used when re-expanding through proxy circles."""
        return dataclasses.replace(self, layer_pot=PROXY_LAYER_POT[self.layer_pot])

    # -- kernel matrix assembly (host path) -----------------------------

    def kernel_matrix(
        self,
        src: np.ndarray,
        tgt: np.ndarray,
        src_normals: np.ndarray | None = None,
        tgt_normals: np.ndarray | None = None,
    ) -> np.ndarray:
        """Dense (len(tgt), len(src)) kernel matrix
        (reference: bfHelm2GetKernelMatrix, src/helm2.c:282-319).

        Zero-distance entries are set to 0, matching the reference's
        treatment of the (removable, quadrature-corrected) diagonal.
        """
        check(self.k > 0, "Helmholtz wavenumber must be positive", InvalidArgumentsError)
        src = np.asarray(src, dtype=np.float64)
        tgt = np.asarray(tgt, dtype=np.float64)
        r = pairwise_dists(tgt, src)
        safe = np.where(r == 0, 1.0, r)

        lp = self.layer_pot
        if lp is LayerPot.SINGLE:
            K = 0.25j * special.hankel1_0_host(self.k * safe)
        elif lp is LayerPot.PV_DOUBLE:
            check(src_normals is not None, "double layer needs source normals")
            # D(x,y) = (i/4) k H1(kr) (n_y . (x - y)) / r  (src/helm2.c:52-59)
            dot = np.einsum("tsd,sd->ts", tgt[:, None, :] - src[None, :, :], src_normals)
            K = 0.25j * self.k * special.hankel1_1_host(self.k * safe) * dot / safe
        elif lp is LayerPot.PV_NORMAL_DERIV_SINGLE:
            check(tgt_normals is not None, "S' needs target normals")
            # S'(x,y) = (i/4) k H1(kr) (n_x . (x - y)) / r  (src/helm2.c:43-50)
            dot = np.einsum("tsd,td->ts", tgt[:, None, :] - src[None, :, :], tgt_normals)
            K = 0.25j * self.k * special.hankel1_1_host(self.k * safe) * dot / safe
        elif lp is LayerPot.COMBINED_FIELD:
            check(src_normals is not None, "combined field needs source normals")
            S = 0.25j * special.hankel1_0_host(self.k * safe)
            dot = np.einsum("tsd,sd->ts", tgt[:, None, :] - src[None, :, :], src_normals)
            D = 0.25j * self.k * special.hankel1_1_host(self.k * safe) * dot / safe
            K = self.alpha * S + self.beta * D
        else:
            raise InvalidArgumentsError(f"unsupported layer potential {lp}")

        K[r == 0] = 0.0
        return K

    # -- butterfly building blocks --------------------------------------

    def rank_estimate(self, circ1: Circle, circ2: Circle, C: float = 1.0,
                      eps: float = 1e-15) -> int:
        """A-priori butterfly rank for two circles, Michielssen–Boag style
        (reference: bfHelm2RankEstForTwoCircles, src/helm2.c:14-36):
        p = k r1 r2 / d - C log10(eps)."""
        check(self.k > 0 and C > 0 and eps > 0, "bad rank-estimate args")
        r1, r2 = circ1.r, circ2.r
        R = float(np.hypot(circ1.center[0] - circ2.center[0],
                           circ1.center[1] - circ2.center[1]))
        d = R - r1 - r2
        check(d > 0, "circles must be separated for rank estimate")
        p = self.k * r1 * r2 / d - C * np.log10(eps)
        check(p > 0, "nonpositive rank estimate")
        return int(np.ceil(p))

    def reexpansion_matrix(
        self,
        src_pts_orig: np.ndarray,
        src_pts_equiv: np.ndarray,
        tgt_pts: np.ndarray,
        src_normals_orig: np.ndarray | None = None,
        src_normals_equiv: np.ndarray | None = None,
    ) -> np.ndarray:
        """Proxy "shift" matrix Z_shift = Z_equiv \\ Z_orig: maps charges on
        the original sources to equivalent charges on the proxy circle that
        reproduce the field on the target circle
        (reference: bfHelm2GetReexpansionMatrix, src/helm2.c:321-365)."""
        check(
            self.layer_pot not in USES_TGT_NORMALS,
            "re-expansion undefined for target-normal layer potentials",
        )
        Z_orig = self.kernel_matrix(src_pts_orig, tgt_pts, src_normals_orig, None)
        Z_equiv = self.kernel_matrix(src_pts_equiv, tgt_pts, src_normals_equiv, None)
        Z_shift, *_ = np.linalg.lstsq(Z_equiv, Z_orig, rcond=None)
        return Z_shift

    def _kernel_matrix_batched(
        self,
        src: np.ndarray,
        tgt: np.ndarray,
        src_normals: np.ndarray | None = None,
    ) -> np.ndarray:
        """(B, m, n) kernel matrices for B same-shape (src, tgt) point sets
        in ONE vectorized pass — the batched twin of `kernel_matrix` for the
        proxy kernels (no target-normal potentials: proxies never use them,
        PROXY_LAYER_POT). One hankel call over B*m*n arguments replaces B
        Python-level calls; the factorizer's per-block assembly overhead
        vanishes."""
        src = np.asarray(src, dtype=np.float64)
        tgt = np.asarray(tgt, dtype=np.float64)
        diff = tgt[:, :, None, :] - src[:, None, :, :]  # (B, m, n, 2)
        r = np.sqrt(np.einsum("bmnd,bmnd->bmn", diff, diff))
        safe = np.where(r == 0, 1.0, r)

        lp = self.layer_pot
        if lp is LayerPot.SINGLE:
            K = 0.25j * special.hankel1_0_host(self.k * safe)
        elif lp is LayerPot.PV_DOUBLE:
            check(src_normals is not None, "double layer needs source normals")
            dot = np.einsum("bmnd,bnd->bmn", diff, src_normals)
            K = 0.25j * self.k * special.hankel1_1_host(self.k * safe) * dot / safe
        elif lp is LayerPot.COMBINED_FIELD:
            check(src_normals is not None, "combined field needs source normals")
            S = 0.25j * special.hankel1_0_host(self.k * safe)
            dot = np.einsum("bmnd,bnd->bmn", diff, src_normals)
            D = 0.25j * self.k * special.hankel1_1_host(self.k * safe) * dot / safe
            K = self.alpha * S + self.beta * D
        else:
            raise InvalidArgumentsError(
                f"unsupported batched layer potential {lp}")
        K[r == 0] = 0.0
        return K

    def reexpansion_matrices_batched(
        self,
        src_pts_orig: np.ndarray,
        src_pts_equiv: np.ndarray,
        tgt_pts: np.ndarray,
        src_normals_orig: np.ndarray | None = None,
        src_normals_equiv: np.ndarray | None = None,
    ) -> np.ndarray:
        """Batched proxy shift matrices: (B, p, n) solving B least-squares
        problems Z_equiv[b] X[b] ~= Z_orig[b] at once via the stacked SVD —
        numerically the same truncation rule as np.linalg.lstsq(rcond=None)
        but without its ~7 ms/call Python+workspace overhead (measured: the
        per-block lstsq was 44% of an n=8k factorization's setup time)."""
        check(
            self.layer_pot not in USES_TGT_NORMALS,
            "re-expansion undefined for target-normal layer potentials",
        )
        Zo = self._kernel_matrix_batched(src_pts_orig, tgt_pts, src_normals_orig)
        Ze = self._kernel_matrix_batched(src_pts_equiv, tgt_pts, src_normals_equiv)
        U, s, Vh = np.linalg.svd(Ze, full_matrices=False)
        m, p = Ze.shape[1], Ze.shape[2]
        rcond = np.finfo(np.float64).eps * max(m, p)
        keep = s > rcond * s[:, :1]
        sinv = np.where(keep, 1.0 / np.where(s == 0, 1.0, s), 0.0)
        UhZo = np.einsum("bmk,bmn->bkn", U.conj(), Zo)
        return np.einsum("bkp,bkn->bpn", Vh.conj(), sinv[:, :, None] * UhZo)
