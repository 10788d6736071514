"""Models built on the port's operators (counterpart of
`butterfly_tpu/models/`). Only retrieval is ported so far."""

from butterfly_tpu_torch.models import retrieval

__all__ = ["retrieval"]
