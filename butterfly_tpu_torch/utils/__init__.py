from butterfly_tpu_torch.utils.device import resolve_device
from butterfly_tpu_torch.utils.errors import (
    ButterflyError,
    IncompatibleShapeError,
    InvalidArgumentsError,
    NotImplementedButterflyError,
    OutOfRangeError,
    RuntimeButterflyError,
    check,
)
from butterfly_tpu_torch.utils.logging import (
    log_debug,
    log_error,
    log_info,
    log_metrics,
    log_todo,
    log_warn,
    set_log_level,
)
from butterfly_tpu_torch.utils.prng import (
    crandn,
    host_rng,
    randn,
    seed,
    torch_generator,
)
from butterfly_tpu_torch.utils.timer import Timer, device_time, toc

__all__ = [
    "resolve_device",
    "ButterflyError",
    "IncompatibleShapeError",
    "InvalidArgumentsError",
    "NotImplementedButterflyError",
    "OutOfRangeError",
    "RuntimeButterflyError",
    "check",
    "log_debug",
    "log_error",
    "log_info",
    "log_metrics",
    "log_todo",
    "log_warn",
    "set_log_level",
    "crandn",
    "host_rng",
    "randn",
    "seed",
    "torch_generator",
    "Timer",
    "device_time",
    "toc",
]
