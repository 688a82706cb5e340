"""Vectorised LZ match planning: the compression plane's device program.

Counterpart of ceph_tpu/device/lzkernel.py.  The expensive phase of
an LZ-class compressor, finding matches, runs as background-class
dispatches over fixed ``TLZ_BLOCK``-wide independent blocks; token
emission stays on the host (compress/tlz.py):

* **4-byte-gram hash** — position i hashes ``le32(data[i:i+4]) *
  2654435761 >> (32 - HBITS)`` (LZ4's multiplicative hash).
* **candidates by a composite-key sort** — sorting positions by the
  unique key ``hash * width + pos`` puts each position after the most
  recent earlier one with its hash, so its candidate is its sorted
  predecessor when the hashes match.  Keys are unique, so any sort
  gives the same order.
* **vectorised match extension** — candidate/position agreement over
  all ``MAX_MATCH`` offsets at once, reduced to the leading run (the
  cap is part of the format).
* lanes bucket pow2 between ``_MIN_LANES`` and ``_MAX_LANES``; larger
  batches take several dispatches.

There is no host route: ``DeviceBusy`` fails the op and a failed
dispatch raises ``IOError``.  ``match_plan_host`` (numpy) stays as the
parity oracle only.  The 32-bit multiply runs in int64 on 16-bit
halves (CUDA torch has no uint32 arithmetic; a 32 x 32-bit product
overflows int64).
"""

from __future__ import annotations

import numpy as np
import torch

from .runtime import DeviceRuntime, K_BACKGROUND

# block geometry: the format constants (compress/tlz.py writes
# TLZ_BLOCK into the container header; MAX_MATCH bounds every emitted
# match) — changing either changes the wire format
TLZ_BLOCK = 4096            # bytes per independent block (lane width)
MAX_MATCH = 32              # match-extension cap (vectorisation depth)
MIN_MATCH = 4               # shortest emitted match (the 4-gram)

_HBITS = 16                 # hash-table address bits
_HASH_MUL = np.uint32(2654435761)

_MIN_LANES = 8              # pow2 lane floor
_MAX_LANES = 64             # lane cap: bigger batches take more dispatches


def _pow2_lanes(n: int) -> int:
    return 1 << max(int(n) - 1, _MIN_LANES - 1).bit_length()


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, every intermediate under 2**49."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * int(c) + (((hi * int(c)) & 0xFFFF) << 16)) & 0xFFFFFFFF


# -- host oracle -------------------------------------------------------------


def match_plan_host(blocks: np.ndarray,
                    lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(cand, mlen) for ``blocks`` [lanes, width] uint8 with per-lane
    valid lengths ``lens``: cand[l, i] is the most recent position
    j < i in lane l whose 4-gram hash equals position i's (-1 when
    none), mlen[l, i] the number of agreeing bytes from (j, i)
    forward, capped at MAX_MATCH and masked to the lane's valid
    length.  Numpy; the parity oracle of `match_plan`."""
    lanes, width = blocks.shape
    idx = np.arange(width, dtype=np.int64)
    b = blocks.astype(np.uint32)
    g = [b[:, np.minimum(idx + t, width - 1)] for t in range(4)]
    v = g[0] | (g[1] << np.uint32(8)) | (g[2] << np.uint32(16)) \
        | (g[3] << np.uint32(24))
    h = ((v * _HASH_MUL) >> np.uint32(32 - _HBITS)).astype(np.int64)
    key = h * width + idx[None, :]
    order = np.argsort(key, axis=1)
    prev = np.concatenate(
        [np.full((lanes, 1), -1, np.int64), order[:, :-1]], axis=1)
    same = np.zeros((lanes, width), bool)
    same[:, 1:] = np.take_along_axis(h, order[:, 1:], 1) \
        == np.take_along_axis(h, order[:, :-1], 1)
    cand_sorted = np.where(same, prev, -1)
    cand = np.empty((lanes, width), np.int64)
    np.put_along_axis(cand, order, cand_sorted, axis=1)
    t = np.arange(MAX_MATCH, dtype=np.int64)
    gi = np.broadcast_to(np.minimum(idx[None, :, None] + t, width - 1),
                         (lanes, width, MAX_MATCH))
    gj = np.minimum(np.maximum(cand, 0)[:, :, None] + t, width - 1)
    li = np.take_along_axis(blocks, gi.reshape(lanes, -1),
                            1).reshape(lanes, width, MAX_MATCH)
    lj = np.take_along_axis(blocks, gj.reshape(lanes, -1),
                            1).reshape(lanes, width, MAX_MATCH)
    valid = (idx[None, :, None] + t) < lens.astype(np.int64)[:, None,
                                                             None]
    ok = (li == lj) & valid & (cand >= 0)[:, :, None]
    mlen = np.cumprod(ok.astype(np.int64), axis=2).sum(axis=2)
    return cand.astype(np.int32), mlen.astype(np.int32)


# -- device program ------------------------------------------------------------


def match_plan(data: torch.Tensor,
               lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The match-planning program (the reference's jitted ``_kernel``
    body): ``data`` [lanes, width] uint8, ``lens`` [lanes] int32 ->
    (cand, mlen), both [lanes, width] int32, equal to
    `match_plan_host`."""
    lanes, width = data.shape
    dev = data.device
    idx = torch.arange(width, device=dev)
    b = data.to(torch.int64)
    g = [b[:, (idx + t).clamp_(max=width - 1)] for t in range(4)]
    v = g[0] | (g[1] << 8) | (g[2] << 16) | (g[3] << 24)
    h = mul32(v, _HASH_MUL) >> (32 - _HBITS)
    order = torch.argsort(h * width + idx[None, :], dim=1)
    prev = torch.cat([torch.full((lanes, 1), -1, dtype=torch.int64,
                                 device=dev), order[:, :-1]], dim=1)
    h_sorted = torch.gather(h, 1, order)
    same = torch.cat([torch.zeros((lanes, 1), dtype=torch.bool,
                                  device=dev),
                      h_sorted[:, 1:] == h_sorted[:, :-1]], dim=1)
    cand_sorted = torch.where(same, prev, torch.full_like(prev, -1))
    cand = torch.empty_like(cand_sorted).scatter_(1, order, cand_sorted)
    t = torch.arange(MAX_MATCH, device=dev)
    gi = (idx[:, None] + t).clamp_(max=width - 1)
    gj = (cand.clamp(min=0)[:, :, None] + t).clamp_(max=width - 1)
    li = data[:, gi]
    lj = torch.gather(data, 1, gj.view(lanes, -1)).view(lanes, width,
                                                        MAX_MATCH)
    valid = (idx[:, None] + t)[None] < lens.to(torch.int64)[:, None, None]
    ok = (li == lj) & valid & (cand >= 0)[:, :, None]
    # the leading run of agreements: offsets before the first miss
    mlen = ((~ok).to(torch.int32).cumsum(2) == 0).sum(2)
    return cand.to(torch.int32), mlen.to(torch.int32)


def _stage_blocks(segs: list[bytes], lanes: int) -> tuple[np.ndarray,
                                                          np.ndarray]:
    lens = np.zeros(lanes, np.int32)
    stage = np.zeros((lanes, TLZ_BLOCK), np.uint8)
    for i, s in enumerate(segs):
        a = np.frombuffer(s, np.uint8)
        stage[i, :a.size] = a
        lens[i] = a.size
    return stage, lens


async def _dispatch(chip, klass: str,
                    segs: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """One match-planning dispatch of <= _MAX_LANES blocks on `chip`."""
    lanes = min(_pow2_lanes(len(segs)), _MAX_LANES)
    async with chip.staged_dispatch(
            klass, lanes, sum(len(s) for s in segs), (lanes, TLZ_BLOCK),
            "tlz") as (ticket, stage):
        blocks, lens = _stage_blocks(segs, lanes)
        stage.numpy()[:] = blocks
        chip.launch(ticket)
        c, m = match_plan(chip.place(stage), chip.place(lens))
        c = c[:len(segs)].cpu().numpy()
        m = m[:len(segs)].cpu().numpy()
    return c, m


async def match_batch(segs: list[bytes], chip: int | None = None,
                      klass: str = K_BACKGROUND, device=None
                      ) -> tuple[np.ndarray, np.ndarray, str]:
    """Plan matches for every <= TLZ_BLOCK segment on the caller's
    affinity chip of `device` (default: the card), in dispatches of at
    most _MAX_LANES blocks; returns (cand, mlen, "device") covering
    ``len(segs)`` lanes.  An empty batch dispatches nothing (path
    "host", as the reference).  DeviceBusy and a failed dispatch
    (IOError) fail the call."""
    target = DeviceRuntime.get(device).route(chip)
    n = len(segs)
    if n == 0:
        return (np.zeros((0, TLZ_BLOCK), np.int32),
                np.zeros((0, TLZ_BLOCK), np.int32), "host")
    cands: list[np.ndarray] = []
    mlens: list[np.ndarray] = []
    for lo in range(0, n, _MAX_LANES):
        c, m = await _dispatch(target, klass, segs[lo:lo + _MAX_LANES])
        cands.append(c)
        mlens.append(m)
    return np.concatenate(cands, 0), np.concatenate(mlens, 0), "device"
