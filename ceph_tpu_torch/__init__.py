"""ceph_tpu_torch — the PyTorch and CUDA port of ceph_tpu.

The erasure-code slice: ``ec.new_codec(profile)`` builds a codec whose
``encode_async`` / ``decode_async`` / ``delta_async`` batch their GF
region products through the dispatch stream (``device.stream``), the
batcher (``ec.batcher``) and the per-chip runtime (``device.runtime``)
into hand-written CUDA kernels (``csrc/ec_kernels.cu``, bound in
``ec.kernels``).  Every entry point runs on the card unless the caller
passes ``device="cpu"``, which selects the kernels' plain PyTorch
versions; with no card and no such request it raises.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default)
    and there is no card — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ceph_tpu_torch: no CUDA device available; pass "
            "device='cpu' to run the kernels' plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("ceph_tpu_torch: unsupported device %r" % (dev,))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
