"""Per-chip device runtime of the CUDA port (see runtime.py)."""

from .runtime import (BufferPool, ChipRuntime, DeviceBusy, DeviceLost,
                      DeviceRuntime, DispatchQueue, DispatchTicket,
                      K_BACKGROUND, K_CLIENT_EC, K_MAPPING,
                      K_RECOVERY_EC)

__all__ = [
    "BufferPool", "ChipRuntime", "DeviceBusy", "DeviceLost",
    "DeviceRuntime", "DispatchQueue", "DispatchTicket", "K_BACKGROUND",
    "K_CLIENT_EC", "K_MAPPING", "K_RECOVERY_EC",
]
