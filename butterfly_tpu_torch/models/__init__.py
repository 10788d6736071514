"""Models built on the port's operators (counterpart of
`butterfly_tpu/models/`): retrieval, the LBO eigenfunction compression
and the covariance operators built on it, radiosity, and the BIE system
on a device that the Helmholtz twins solve."""

from butterfly_tpu_torch.models import (
    bie,
    covariance,
    lbo,
    radiosity,
    retrieval,
)

__all__ = ["bie", "covariance", "lbo", "radiosity", "retrieval"]
