"""Batched CRC32 digest lanes: the scrub plane's device program.

Counterpart of ceph_tpu/device/digest.py.  A scrub chunk's digests
(object bytes and attribute blobs) become background-class dispatches
of one gather + XOR-reduce over ``[lanes, width]``:

* **linearity decomposition** — CRC32 is affine over GF(2): with the
  byte step ``s' = (s >> 8) ^ TAB[(s ^ b) & 0xff]``, byte ``b``
  contributes ``L^t(TAB[b])`` where ``t`` is its trailing byte count
  and ``L(v) = (v >> 8) ^ TAB[v & 0xff]`` the zero-byte advance, so
  ``crc32(m) = XOR_i T[len-1-i][m[i]] ^ Z[len]`` with ``T[t] =
  L^t(TAB)`` and ``Z[n] = crc32(0^n)``.  ``T[t][0] == 0``, so a short
  lane's zero padding contributes nothing.
* **segment folding** — the position table is O(width), so a lane
  holds at most ``DEVICE_MAX_BYTES``; a longer buffer splits into
  segments that digest as independent lanes and fold back on the host
  with ``crc32_combine`` (zlib's combine).
* **bounded dispatches** — a dispatch stages at most
  ``DEVICE_MAX_STAGE_BYTES``; a batch whose segments need more is
  split into several dispatches, with identical digests.

There is no host route: no environment variable selects the host,
``DeviceBusy`` fails the op, and a failed dispatch raises ``IOError``.
``crc32_host`` (zlib) stays as the parity oracle only.  The program is
plain PyTorch; the table's words are gathered and XORed as int32 bit
patterns (CUDA torch has no uint32 arithmetic or reductions, and torch
has no XOR reduction, so lanes fold in halves).
"""

from __future__ import annotations

import functools
import zlib

import numpy as np
import torch

from .runtime import DeviceRuntime, K_BACKGROUND

_POLY = np.uint32(0xEDB88320)
_FINAL = np.uint32(0xFFFFFFFF)

# a lane holds at most 16 KiB: the position table is width x 256 words
# (16 MiB at this width); longer buffers fold from their segments
DEVICE_MAX_BYTES = 1 << 14

# staged bytes (lanes x width) one dispatch may occupy; bigger batches
# split into several dispatches
DEVICE_MAX_STAGE_BYTES = 1 << 25

_MIN_WIDTH = 256     # pow2 floor so tiny chunks share one shape
_MIN_LANES = 8


@functools.lru_cache(maxsize=1)
def _byte_table() -> np.ndarray:
    """The standard CRC32 byte table (TAB[b] = contribution of byte b
    processed last); linear in b over GF(2)."""
    tab = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        tab = np.where(tab & 1, (tab >> np.uint32(1)) ^ _POLY,
                       tab >> np.uint32(1)).astype(np.uint32)
    return tab


@functools.lru_cache(maxsize=4)
def _tables(width: int) -> tuple[np.ndarray, np.ndarray]:
    """(T, Z) for one pow2 bucket width: T[t][b] = L^t(TAB[b]), the
    per-position contribution table the device gathers, and Z[n] =
    crc32 of n zero bytes, folded back in on the host."""
    tab = _byte_table()
    T = np.empty((width, 256), np.uint32)
    T[0] = tab
    for t in range(1, width):
        p = T[t - 1]
        T[t] = (p >> np.uint32(8)) ^ tab[p & np.uint32(0xFF)]
    Z = np.empty(width + 1, np.uint32)
    Z[0] = 0
    s = _FINAL
    for n in range(1, width + 1):
        s = (s >> np.uint32(8)) ^ tab[s & np.uint32(0xFF)]
        Z[n] = s ^ _FINAL
    return T, Z


@functools.lru_cache(maxsize=16)
def _device_table(width: int, device: torch.device) -> torch.Tensor:
    """T for one width on one device, as int32 bit patterns (uploaded
    once per (width, device))."""
    return torch.from_numpy(_tables(width)[0].view(np.int32)).to(device)


def digest_lanes(data: torch.Tensor, lens: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """The digest program (the reference's jitted ``_kernel`` body):
    ``data`` [lanes, width] uint8, ``lens`` [lanes] int32, ``table``
    [width, 256] int32 -> [lanes] int32, each lane's XOR of
    ``T[len-1-i][byte_i]`` over its valid bytes (the uint32 bit
    pattern; the host XORs ``Z[len]`` in)."""
    lanes, width = data.shape
    pos = (lens.to(torch.int64)[:, None] - 1
           - torch.arange(width, device=data.device)[None, :])
    pad = pos < 0
    # in place: a 32 MiB dispatch's int64 indices are 256 MiB
    idx = pos.clamp_(0, width - 1).mul_(256).add_(data)
    contrib = torch.take(table, idx).masked_fill_(pad, 0)
    del pos, idx
    while width > 1:
        width //= 2
        contrib = contrib[:, :width] ^ contrib[:, width:]
    return contrib[:, 0]


def crc32_host(bufs) -> list[int]:
    """The parity oracle: one zlib.crc32 per buffer."""
    return [zlib.crc32(bytes(b)) & 0xFFFFFFFF for b in bufs]


# -- crc32_combine: GF(2)-matrix concatenation fold ----------------------


def _gf2_times(mat: list[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat: list[int]) -> list[int]:
    return [_gf2_times(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A + B) from crc32(A), crc32(B) and len(B), as zlib's
    crc32_combine: advance crc1 through len2 zero bytes by
    square-and-multiply over the 32x32 GF(2) operator matrices, then
    XOR crc2 in."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    # odd = the one-zero-bit advance operator
    odd = [0] * 32
    odd[0] = 0xEDB88320
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    even = _gf2_square(odd)         # 2 bits
    odd = _gf2_square(even)         # 4 bits
    crc1 &= 0xFFFFFFFF
    n = int(len2)
    while True:
        even = _gf2_square(odd)     # 8, 32, 128... zero bits
        if n & 1:
            crc1 = _gf2_times(even, crc1)
        n >>= 1
        if not n:
            break
        odd = _gf2_square(even)
        if n & 1:
            crc1 = _gf2_times(odd, crc1)
        n >>= 1
        if not n:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def _pow2(n: int, floor: int) -> int:
    return 1 << max(int(n) - 1, floor - 1).bit_length()


async def _dispatch(chip, klass: str, segs: list[bytes],
                    width: int) -> tuple[np.ndarray, np.ndarray]:
    """One digest dispatch of `segs` (each <= width bytes) on `chip`:
    (per-segment linear parts as uint32, lens)."""
    lanes = _pow2(len(segs), _MIN_LANES)
    total = sum(len(s) for s in segs)
    async with chip.staged_dispatch(klass, width, total, (lanes, width),
                                    "crc32") as (ticket, stage):
        view = stage.numpy()
        lens = np.zeros(lanes, np.int32)
        for i, s in enumerate(segs):
            a = np.frombuffer(s, np.uint8)
            view[i, :a.size] = a
            lens[i] = a.size
        chip.launch(ticket)
        lin = digest_lanes(chip.place(stage), chip.place(lens),
                           _device_table(width, chip.device))
        lin = lin.cpu().numpy().view(np.uint32)
    return lin, lens


async def crc32_batch(bufs, chip: int | None = None,
                      klass: str = K_BACKGROUND, device=None
                      ) -> tuple[list[int], str]:
    """Digest every buffer on the caller's affinity chip of `device`
    (default: the card); returns (digests, "device").  Buffers longer
    than a lane fold from their segments' digests; a batch staging more
    than DEVICE_MAX_STAGE_BYTES takes several dispatches.  A batch with
    no bytes dispatches nothing and returns its zero digests with path
    "host", as the reference does.  DeviceBusy and a failed dispatch
    (IOError) fail the call."""
    bufs = list(bufs)
    target = DeviceRuntime.get(device).route(chip)
    if not bufs:
        return [], "host"
    segs: list[bytes] = []
    owner: list[int] = []               # buffer index of each segment
    for i, b in enumerate(bufs):
        bb = bytes(b)
        for off in range(0, len(bb), DEVICE_MAX_BYTES):
            segs.append(bb[off:off + DEVICE_MAX_BYTES])
            owner.append(i)
    if not segs:
        return [0] * len(bufs), "host"
    width = _pow2(max(len(s) for s in segs), _MIN_WIDTH)
    per = DEVICE_MAX_STAGE_BYTES // width
    _t, z = _tables(width)
    seg_crc: list[int] = []
    for lo in range(0, len(segs), per):
        part = segs[lo:lo + per]
        lin, lens = await _dispatch(target, klass, part, width)
        seg_crc += [int(lin[i]) ^ int(z[lens[i]]) for i in range(len(part))]
    out: list[int] = [0] * len(bufs)
    seen: set[int] = set()
    for s, bi, crc in zip(segs, owner, seg_crc):
        if bi not in seen:
            seen.add(bi)
            out[bi] = crc
        else:
            out[bi] = crc32_combine(out[bi], crc, len(s))
    return out, "device"
