"""Error types for butterfly_tpu_torch.

TPU-native replacement for the reference's sticky error-code system
(reference: src/error.c:9-24, include/bf/error_macros.h:3-27). Instead of
OpenGL-style sticky codes + cleanup gotos, we use ordinary Python exceptions
with a small typed hierarchy mirroring the reference's BfError enum.
"""

from __future__ import annotations


class ButterflyError(Exception):
    """Base class for all butterfly_tpu_torch errors."""


class InvalidArgumentsError(ButterflyError):
    """Bad arguments (reference: BF_ERROR_INVALID_ARGUMENTS)."""


class RuntimeButterflyError(ButterflyError):
    """Generic runtime failure (reference: BF_ERROR_RUNTIME_ERROR)."""


class NotImplementedButterflyError(ButterflyError):
    """Unimplemented path (reference: BF_ERROR_NOT_IMPLEMENTED)."""


class OutOfRangeError(ButterflyError):
    """Index out of range (reference: BF_ERROR_OUT_OF_RANGE)."""


class IncompatibleShapeError(ButterflyError):
    """Shape mismatch between operators/operands."""


def check(cond: bool, msg: str = "", exc: type = RuntimeButterflyError) -> None:
    """Raise `exc(msg)` unless `cond`.

    Cheap runtime invariant check, analogous to the reference's BF_ASSERT
    (include/bf/assert.h) but always on: these guard host-side setup code,
    never jitted device code.
    """
    if not cond:
        raise exc(msg)
