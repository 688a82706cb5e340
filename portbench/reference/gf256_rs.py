"""Plain Reed-Solomon over GF(2^8): the yardstick of the EC cells.

Derivation.  ISA-L's `reed_sol_van` profile (the Ceph `isa` plugin's
default) codes with `gf_gen_rs_matrix`: the first k rows are the
identity and parity row i (0 <= i < m) holds (2^i)^j at column j, in
GF(2^8) with the polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d).  A
parity chunk is the GF sum (XOR) of the data chunks, each multiplied
byte by byte by its coefficient.  An object is coded as Ceph's
`ErasureCode::encode` does: split into k contiguous chunks of
`chunk_size` bytes (ceil(len / k) rounded up to the plugin's 32-byte
alignment), the last ones zero-padded.

Because the code is linear, overwriting bytes of data chunk j changes
parity chunk i by coef[i][j] * (old ^ new) at the same offsets: that is
`delta`.  The benchmark judges the program by encoding what it expects
an object to hold and comparing every stored shard with the result.

Plain NumPy; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D
ALIGNMENT = 32      # EC_ISA_ADDRESS_ALIGNMENT of the isa plugin


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[:255]
    return exp, log


_EXP, _LOG = _tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def mul_table() -> np.ndarray:
    """[256, 256] uint8: mul_table()[c, x] = c * x in GF(2^8)."""
    t = _EXP[(_LOG[:, None] + _LOG[None, :]) % 255].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


_MUL = mul_table()


def rs_van_coefficients(k: int, m: int) -> list[list[int]]:
    """The m parity rows of gf_gen_rs_matrix(k + m, k)."""
    rows = []
    gen = 1
    for _ in range(m):
        p, row = 1, []
        for _ in range(k):
            row.append(p)
            p = gf_mul(p, gen)
        gen = gf_mul(gen, 2)
        rows.append(row)
    return rows


def chunk_size(object_size: int, k: int, alignment: int = ALIGNMENT) -> int:
    chunk = -(-object_size // k)
    return -(-chunk // alignment) * alignment


def split(data: bytes, k: int) -> np.ndarray:
    """[k, chunk] uint8: the object's data chunks, zero-padded."""
    cs = chunk_size(len(data), k)
    buf = np.zeros(k * cs, dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf.reshape(k, cs)


def parity(chunks: np.ndarray, coef: list[list[int]]) -> np.ndarray:
    """[m, chunk] uint8 parity of the [k, chunk] data chunks."""
    out = np.zeros((len(coef), chunks.shape[1]), dtype=np.uint8)
    for i, row in enumerate(coef):
        for j, c in enumerate(row):
            if c:
                out[i] ^= _MUL[c][chunks[j]]
    return out


def encode(data: bytes, k: int, m: int) -> list[bytes]:
    """The k + m shards of one object, data chunks first."""
    chunks = split(data, k)
    par = parity(chunks, rs_van_coefficients(k, m))
    return [c.tobytes() for c in chunks] + [p.tobytes() for p in par]


def delta(old: bytes, new: bytes, j: int, k: int, m: int) -> list[bytes]:
    """What an overwrite of bytes of data chunk j adds (XOR) to each of
    the m parity chunks at the same offsets."""
    d = (np.frombuffer(old, np.uint8) ^ np.frombuffer(new, np.uint8))
    return [_MUL[row[j]][d].tobytes()
            for row in rs_van_coefficients(k, m)]
