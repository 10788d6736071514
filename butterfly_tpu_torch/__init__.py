"""butterfly_tpu_torch — the PyTorch/CUDA port of `butterfly_tpu`.

It runs two apply paths on an NVIDIA H100. The compressed-operator path:
a matrix streamed through the host factorizer (`fac.streamer`), distilled
to a fixed-rank FFT-form butterfly (`fac.distill`), and applied by the
fused multi-level pass kernel K1, written in CUDA C++ (`csrc/k1_pass.cu`,
wrapped by `ops.fused_butterfly`). The Helmholtz partition path: a
multilevel factorization built on the host (`fac.helm2`), compiled on the
card into two block-sparse cell passes (`fac.partition`) and applied by
the cell kernel K2, written in CUDA C++ (`csrc/k2_cell.cu`, wrapped by
`ops.cellsp`). The multi-device path (`parallel/`): ranks are processes on
`torch.distributed` (`parallel.launch.run_ranks`; gloo ranks sharing one
card, or NCCL with a card per rank), the butterfly placed over a
("data", "model") mesh (`parallel.sharding`), applied with one all-to-all
and K1 per rank (`parallel.shmap_butterfly`) or pipelined by level groups
(`parallel.pipeline`), and the sharded training dryrun
(`entry.dryrun_multichip`).

The layout mirrors `butterfly_tpu` (`ops/`, `fac/`, `geom/`, `trees/`,
`parallel/`, `utils/`, `config.py`), so each module's counterpart sits at
the same path. The port imports neither JAX nor any module of `butterfly_tpu`: host
modules it needs are copied. Entry points run on CUDA unless called with
`device="cpu"`, and raise when CUDA is absent and no device was named.
"""

__version__ = "0.1.0"

from butterfly_tpu_torch.config import DeviceConfig, FacSpec

__all__ = ["DeviceConfig", "FacSpec", "__version__"]
