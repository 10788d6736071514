"""butterfly_tpu_torch — the PyTorch/CUDA port of `butterfly_tpu`.

It runs the compressed-operator apply path on an NVIDIA H100: a matrix
streamed through the host factorizer (`fac.streamer`), distilled to a
fixed-rank FFT-form butterfly (`fac.distill`), and applied by the fused
multi-level pass kernel K1, written in CUDA C++ (`csrc/k1_pass.cu`,
wrapped by `ops.fused_butterfly`).

The layout mirrors `butterfly_tpu` (`ops/`, `fac/`, `trees/`, `utils/`,
`config.py`), so each module's counterpart sits at the same path. The port
imports neither JAX nor any module of `butterfly_tpu`: host modules it
needs are copied. Entry points run on CUDA unless called with
`device="cpu"`, and raise when CUDA is absent and no device was named.
"""

__version__ = "0.1.0"

from butterfly_tpu_torch.config import FacSpec

__all__ = ["FacSpec", "__version__"]
