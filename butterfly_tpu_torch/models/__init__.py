"""Models built on the port's operators (counterpart of
`butterfly_tpu/models/`): retrieval, the LBO eigenfunction compression
and the covariance operators built on it, and radiosity."""

from butterfly_tpu_torch.models import covariance, lbo, radiosity, retrieval

__all__ = ["covariance", "lbo", "radiosity", "retrieval"]
