"""Content-defined chunking and batched fingerprints: the data-reduction
plane's device programs.

Counterpart of ceph_tpu/dedup/chunker.py:

* **rolling-hash boundary candidates on the device** — position i
  hashes the 8-byte window ending at i as two le32 grams mixed with two
  odd constants, ``mix = (le32(b[i-7:i-3]) * C1) ^ (le32(b[i-3:i+1]) *
  C2)``; i is a candidate cut iff ``mix & (CHUNK_AVG-1) == MAGIC``.
  Blobs split into ``SEG``-byte body segments with an 8-byte left
  margin, lanes bucket pow2 between ``_MIN_LANES`` and ``_MAX_LANES``,
  and larger batches take several dispatches.
* **cut resolution on the host** — walking the mask into cuts (first
  candidate >= start+CHUNK_MIN, forced at start+CHUNK_MAX) is a cheap
  O(cuts) host walk, `resolve_cuts`.
* **fingerprints through the digest lanes** — `fingerprint_batch` runs
  the chunks through `device.digest.crc32_batch` (CHUNK_MAX equals a
  digest lane); fingerprints are ``"%08x-%x" % (crc32, len)``.

There is no host route: ``DeviceBusy`` fails the op and a failed
dispatch raises ``IOError``.  `candidate_mask_host`,
`_mask_lanes_host` and `chunk_host` (numpy) stay as the parity oracles
only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import digest
from ..device.lzkernel import mul32
from ..device.runtime import DeviceRuntime, K_BACKGROUND

# chunk-size policy: candidates fire at 1/CHUNK_AVG positions, the
# resolution walk enforces [CHUNK_MIN, CHUNK_MAX].  CHUNK_MAX equals
# digest.DEVICE_MAX_BYTES so every chunk fingerprints in one CRC lane.
CHUNK_MIN = 2048
CHUNK_AVG = 8192                # mask = CHUNK_AVG - 1 (pow2 required)
CHUNK_MAX = 16384

SEG = 8192                      # body bytes per device lane
MARGIN = 8                      # rolling-window left margin per lane

_MIX1 = np.uint32(2654435761)   # lzkernel's multiplicative hash prime
_MIX2 = np.uint32(0x85EBCA77)   # second odd prime (xxhash PRIME32_2)
_MAGIC = np.uint32(0x13AB)      # boundary residue (< CHUNK_AVG)

_MIN_LANES = 8                  # pow2 lane floor
_MAX_LANES = 32                 # lane cap: bigger batches, more dispatches

CHUNK_OID_PREFIX = "chunk."


def _pow2_lanes(n: int) -> int:
    return 1 << max(int(n) - 1, _MIN_LANES - 1).bit_length()


# -- fingerprint / chunk-oid helpers -----------------------------------------


def fingerprint(crc: int, size: int) -> str:
    return "%08x-%x" % (crc & 0xFFFFFFFF, size)


def chunk_oid(fp: str) -> str:
    return CHUNK_OID_PREFIX + fp


def parse_chunk_oid(oid: str) -> tuple[int, int] | None:
    """(crc32, size) when ``oid`` is a content-addressed chunk oid,
    else None."""
    if not oid.startswith(CHUNK_OID_PREFIX):
        return None
    body = oid[len(CHUNK_OID_PREFIX):]
    crc_s, sep, size_s = body.partition("-")
    if not sep or len(crc_s) != 8:
        return None
    try:
        return int(crc_s, 16), int(size_s, 16)
    except ValueError:
        return None


# -- host oracles --------------------------------------------------------------


def candidate_mask_host(data) -> np.ndarray:
    """Boundary-candidate mask for one whole blob: mask[i] is True iff
    the 8-byte window ending at i (zero-padded off the front, like the
    first segment's staged margin) hits the boundary residue."""
    a = np.frombuffer(bytes(data), np.uint8)
    n = a.size
    if n == 0:
        return np.zeros(0, bool)
    p = np.zeros(n + MARGIN, np.uint8)
    p[MARGIN:] = a
    b = p.astype(np.uint32)
    i = np.arange(n, dtype=np.int64)
    w = [b[i + t + 1] for t in range(8)]
    g1 = w[0] | (w[1] << np.uint32(8)) | (w[2] << np.uint32(16)) \
        | (w[3] << np.uint32(24))
    g2 = w[4] | (w[5] << np.uint32(8)) | (w[6] << np.uint32(16)) \
        | (w[7] << np.uint32(24))
    mix = (g1 * _MIX1) ^ (g2 * _MIX2)
    return (mix & np.uint32(CHUNK_AVG - 1)) == _MAGIC


def _mask_lanes_host(stage: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The staged-lane form of `candidate_mask_host` over a
    [lanes, MARGIN+SEG] stage: the oracle of `candidate_mask`."""
    idx = np.arange(SEG, dtype=np.int64)
    b = stage.astype(np.uint32)
    w = [b[:, idx + t + 1] for t in range(8)]
    g1 = w[0] | (w[1] << np.uint32(8)) | (w[2] << np.uint32(16)) \
        | (w[3] << np.uint32(24))
    g2 = w[4] | (w[5] << np.uint32(8)) | (w[6] << np.uint32(16)) \
        | (w[7] << np.uint32(24))
    mix = (g1 * _MIX1) ^ (g2 * _MIX2)
    hit = (mix & np.uint32(CHUNK_AVG - 1)) == _MAGIC
    return hit & (idx[None, :] < lens.astype(np.int64)[:, None])


def resolve_cuts(mask: np.ndarray, n: int) -> list[int]:
    """Walk a candidate mask into interior cut offsets: the next cut
    is one past the first candidate position >= start+CHUNK_MIN-1,
    forced at start+CHUNK_MAX when none fires, and the tail is never
    cut below CHUNK_MIN."""
    cuts: list[int] = []
    pos = np.flatnonzero(mask)
    start = 0
    while n - start > CHUNK_MIN:
        lo = start + CHUNK_MIN - 1
        hi = min(start + CHUNK_MAX - 1, n - 2)
        j = int(np.searchsorted(pos, lo))
        if j < pos.size and pos[j] <= hi:
            c = int(pos[j]) + 1
        elif start + CHUNK_MAX < n:
            c = start + CHUNK_MAX
        else:
            break
        cuts.append(c)
        start = c
    return cuts


def chunk_host(data) -> list[int]:
    """Interior cut offsets for one blob: the parity oracle of
    `boundary_batch`."""
    return resolve_cuts(candidate_mask_host(data), len(data))


def split(data: bytes, cuts: list[int]) -> list[bytes]:
    bounds = [0] + list(cuts) + [len(data)]
    return [bytes(data[bounds[i]:bounds[i + 1]])
            for i in range(len(bounds) - 1)]


# -- device program ------------------------------------------------------------


def candidate_mask(data: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """The boundary-candidate program (the reference's jitted
    ``_kernel`` body): ``data`` [lanes, MARGIN+SEG] uint8, ``lens``
    [lanes] int32 -> [lanes, SEG] bool, equal to `_mask_lanes_host`."""
    b = data.to(torch.int64)
    w = [b[:, t + 1:t + 1 + SEG] for t in range(8)]
    g1 = w[0] | (w[1] << 8) | (w[2] << 16) | (w[3] << 24)
    g2 = w[4] | (w[5] << 8) | (w[6] << 16) | (w[7] << 24)
    mix = mul32(g1, _MIX1) ^ mul32(g2, _MIX2)
    hit = (mix & (CHUNK_AVG - 1)) == int(_MAGIC)
    idx = torch.arange(SEG, device=data.device)
    return hit & (idx[None, :] < lens.to(torch.int64)[:, None])


def _segments(blobs) -> tuple[list[tuple[int, np.ndarray, np.ndarray]],
                              list[int]]:
    """(segments, blob lengths): each segment is (blob index, margin
    bytes, body bytes) with the margin the 8 bytes preceding the body
    in its blob (empty for a blob's first segment: the staged zero
    margin is the host mask's zero front-pad)."""
    segs: list[tuple[int, np.ndarray, np.ndarray]] = []
    ns: list[int] = []
    for bi, blob in enumerate(blobs):
        a = np.frombuffer(bytes(blob), np.uint8)
        ns.append(a.size)
        for off in range(0, a.size, SEG):
            segs.append((bi, a[max(0, off - MARGIN):off],
                         a[off:off + SEG]))
    return segs, ns


def _stage_segments(segs, lanes: int, stage: np.ndarray) -> np.ndarray:
    lens = np.zeros(lanes, np.int32)
    for i, (_bi, margin, body) in enumerate(segs):
        stage[i, :MARGIN] = 0
        if margin.size:
            stage[i, MARGIN - margin.size:MARGIN] = margin
        stage[i, MARGIN:MARGIN + body.size] = body
        lens[i] = body.size
    return lens


async def _dispatch(chip, klass: str, segs) -> np.ndarray:
    """One boundary-candidate dispatch of <= _MAX_LANES segments on
    `chip`: their [n, SEG] masks."""
    width = MARGIN + SEG
    lanes = min(_pow2_lanes(len(segs)), _MAX_LANES)
    total = sum(body.size for _bi, _m, body in segs)
    async with chip.staged_dispatch(klass, lanes, total, (lanes, width),
                                    "cdc") as (ticket, stage):
        lens = _stage_segments(segs, lanes, stage.numpy())
        chip.launch(ticket)
        m = candidate_mask(chip.place(stage), chip.place(lens))
        m = m[:len(segs)].cpu().numpy()
    return m


async def boundary_batch(blobs, chip: int | None = None,
                         klass: str = K_BACKGROUND, device=None
                         ) -> tuple[list[list[int]], str]:
    """Cut lists for every blob, the candidate masks computed in
    background-class dispatches on the caller's affinity chip of
    `device` (default: the card); returns (cuts per blob, "device").
    A batch with no bytes dispatches nothing (path "host", as the
    reference).  DeviceBusy and a failed dispatch (IOError) fail the
    call."""
    blobs = list(blobs)
    target = DeviceRuntime.get(device).route(chip)
    if not blobs:
        return [], "host"
    segs, ns = _segments(blobs)
    if not segs:
        return [[] for _ in blobs], "host"
    masks: list[np.ndarray] = []
    for lo in range(0, len(segs), _MAX_LANES):
        m = await _dispatch(target, klass, segs[lo:lo + _MAX_LANES])
        masks.extend(m)
    cuts: list[list[int]] = []
    si = 0
    for n in ns:
        k = -(-n // SEG)
        mask = (np.concatenate(masks[si:si + k])[:n] if k
                else np.zeros(0, bool))
        si += k
        cuts.append(resolve_cuts(mask, n))
    return cuts, "device"


async def fingerprint_batch(chunks, chip: int | None = None,
                            klass: str = K_BACKGROUND, device=None
                            ) -> tuple[list[str], str]:
    """Content fingerprints ``"%08x-%x" % (crc32, len)`` for a chunk
    batch through the digest plane's CRC lanes, accounted on the
    chip's fingerprint gauges."""
    chunks = list(chunks)
    crcs, path = await digest.crc32_batch(chunks, chip=chip, klass=klass,
                                          device=device)
    if path == "device":
        DeviceRuntime.get(device).route(chip).note_fingerprint(
            len(chunks), sum(len(c) for c in chunks))
    return [fingerprint(c, len(b)) for c, b in zip(crcs, chunks)], path
