"""Local device enumeration for the per-chip DeviceRuntime.

Counterpart of ceph_tpu/device/mesh.py over CUDA devices: the host
enumerates its local cards once, work is placed per card with
``tensor.to(device, non_blocking=True)`` (computation follows data),
and nothing in the hot path performs a cross-card collective — EC
parity is column-independent, so a flush splits over the stripe axis.

The runtime's mesh size is its ``chips`` argument when given (logical
chips beyond the physical count map onto devices round-robin), else
the number of CUDA devices for a CUDA runtime, else 1 on the CPU.
"""

from __future__ import annotations

import torch


def local_devices(device: torch.device) -> list[torch.device]:
    """The physical devices of `device`'s type this process sees."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def chip_count(device: torch.device) -> int:
    """Mesh size for a runtime on `device`'s type."""
    return max(1, len(local_devices(device)))


def device_for(chip_index: int, device: torch.device) -> torch.device:
    """The device backing logical chip `chip_index`: a single-card
    runtime keeps its own device; on a multi-card host chips map
    round-robin onto the cards."""
    devs = local_devices(device)
    if len(devs) <= 1:
        return device
    return devs[chip_index % len(devs)]


def affinity(osd_id: int, n_chips: int) -> int:
    """OSD -> chip affinity: deterministic modulo placement, so
    co-located daemons land on distinct chips until the mesh is full
    and a chip loss maps to a knowable OSD subset."""
    return int(osd_id) % max(1, int(n_chips))


def describe(device: torch.device) -> dict:
    """Mesh identity for trace/export metadata: how many chips a
    runtime on `device`'s type sees and what backs them, so an exported
    timeline records what hardware its device lanes ran on."""
    devs = local_devices(device)
    out = {"chips": chip_count(device), "physical_devices": len(devs),
           "platform": device.type}
    if device.type == "cuda" and devs:
        out["device_name"] = torch.cuda.get_device_name(devs[0])
    return out
