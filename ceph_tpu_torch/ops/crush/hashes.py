"""rjenkins1 32-bit hash family used throughout placement.

Reference semantics: src/crush/hash.c (crush_hashmix + crush_hash32_[1-5])
and the string hash ceph_str_hash_rjenkins (src/common/ceph_hash.cc) used
by object_locator_to_pg.  Re-derived here in two forms:

* scalar python ints (host single-query path, bit-exact, masked to u32)
* numpy uint32 vectorized (bulk host mapping and the placement seeds)

Both forms share the same mixing schedule; the device mapper's plain
torch version (ops.crush.kernels) and its CUDA kernel run it too.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
HASH_SEED = 1315423911
RJENKINS1 = 0  # the only hash id (CRUSH_HASH_RJENKINS1)


# -- scalar ---------------------------------------------------------------

def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 13
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 8)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 13
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 12
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 16)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 5
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 3
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 10)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 15
    return a, b, c


def hash32(a: int) -> int:
    a &= M32
    h = (HASH_SEED ^ a) & M32
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def hash32_2(a: int, b: int) -> int:
    a &= M32; b &= M32
    h = (HASH_SEED ^ a ^ b) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a: int, b: int, c: int) -> int:
    a &= M32; b &= M32; c &= M32
    h = (HASH_SEED ^ a ^ b ^ c) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32
    h = (HASH_SEED ^ a ^ b ^ c ^ d) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= M32; b &= M32; c &= M32; d &= M32; e &= M32
    h = (HASH_SEED ^ a ^ b ^ c ^ d ^ e) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


# -- vectorized (numpy; mirrored 1:1 by ops.crush.kernels) ----------------

def _mix_v(a, b, c, xp=np):
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(13))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(8))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(13))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(12))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(16))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(5))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(3))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(10))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def hash32_3_v(a, b, c):
    """Vectorized hash32_3 over uint32 arrays (broadcasting)."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    c = np.asarray(c, np.uint32)
    h = np.uint32(HASH_SEED) ^ a ^ b ^ c
    x = np.uint32(231232)
    y = np.uint32(1232)
    a, b, h = _mix_v(a, b, h)
    c, x, h = _mix_v(c, x, h)
    y, a, h = _mix_v(y, a, h)
    b, x, h = _mix_v(b, x, h)
    y, c, h = _mix_v(y, c, h)
    return h


def hash32_2_v(a, b):
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32)
    h = np.uint32(HASH_SEED) ^ a ^ b
    x = np.uint32(231232)
    y = np.uint32(1232)
    a, b, h = _mix_v(a, b, h)
    x, a, h = _mix_v(x, a, h)
    b, y, h = _mix_v(b, y, h)
    return h


# -- string hash (object name -> placement seed) --------------------------

def str_hash_rjenkins(key: bytes) -> int:
    """Object-name hash used for pg selection.

    Reference semantics: ceph_str_hash_rjenkins (src/common/ceph_hash.cc) —
    the classic Jenkins 96-bit mix over 12-byte blocks with golden-ratio
    initialisation and length folded into the tail block.
    """
    a = 0x9E3779B9
    b = a
    c = 0  # initval
    length = len(key)
    i = 0
    while length >= 12:
        a = (a + (key[i] | key[i + 1] << 8 | key[i + 2] << 16 | key[i + 3] << 24)) & M32
        b = (b + (key[i + 4] | key[i + 5] << 8 | key[i + 6] << 16 | key[i + 7] << 24)) & M32
        c = (c + (key[i + 8] | key[i + 9] << 8 | key[i + 10] << 16 | key[i + 11] << 24)) & M32
        a, b, c = _mix(a, b, c)
        i += 12
        length -= 12
    c = (c + len(key)) & M32
    # tail bytes fold into the high bytes of a/b/c (byte 8 is skipped:
    # that slot carries the length)
    if length >= 11:
        c = (c + (key[i + 10] << 24)) & M32
    if length >= 10:
        c = (c + (key[i + 9] << 16)) & M32
    if length >= 9:
        c = (c + (key[i + 8] << 8)) & M32
    if length >= 8:
        b = (b + (key[i + 7] << 24)) & M32
    if length >= 7:
        b = (b + (key[i + 6] << 16)) & M32
    if length >= 6:
        b = (b + (key[i + 5] << 8)) & M32
    if length >= 5:
        b = (b + key[i + 4]) & M32
    if length >= 4:
        a = (a + (key[i + 3] << 24)) & M32
    if length >= 3:
        a = (a + (key[i + 2] << 16)) & M32
    if length >= 2:
        a = (a + (key[i + 1] << 8)) & M32
    if length >= 1:
        a = (a + key[i]) & M32
    a, b, c = _mix(a, b, c)
    return c


def pps_seed_v(ps, pgp_num: int, pgp_mask: int, pool_id: int,
               hashpspool: bool):
    """Vectorized raw_pg_to_pps placement seed (osd_types.cc:1815-1831)
    — the single source for the stable-mod + pool-mix composition used
    by the host pipeline and the bulk mapper's patch path; mirrored in
    torch by ops.crush.kernels.pps_seed (the plain route) and in K4,
    whose threads hash their lanes' seeds on the card."""
    import numpy as np
    ps = np.asarray(ps, dtype=np.uint32)
    masked = np.where((ps & pgp_mask) < pgp_num, ps & pgp_mask,
                      ps & (pgp_mask >> 1)).astype(np.uint32)
    if hashpspool:
        return hash32_2_v(masked, np.uint32(pool_id)).astype(np.int64)
    return masked.astype(np.int64) + pool_id
