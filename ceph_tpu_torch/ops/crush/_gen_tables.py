"""Regenerate _ln_tables.py (fixed-point log tables used by straw2).

Run manually:  python -m ceph_tpu_torch.ops.crush._gen_tables CEPH_SOURCE_ROOT

The straw2 bucket algorithm draws an exponential variate per item via a
fixed-point log2 lookup (reference: src/crush/mapper.c:226-268 crush_ln,
tables in src/crush/crush_ln_table.h).  Interoperability requires the
exact table values:

* RH_LH table (129 pairs): closed forms verified to reproduce every
  reference entry —
    RH[k] = ceil(2^56 / (256 + 2k))        (reciprocal, ~2^48/(1+k/128))
    LH[k] = trunc(2^48 * log2(1 + k/128)), with LH[128] = 0xffff00000000
  We *generate* these from the formulas (and assert equality against the
  reference header when it is available).

* LL table (256 entries, ~2^48*log2(1+j/2^15) residual correction):
  the original generator is lost upstream (values deviate from every
  plausible closed form by a drifting sub-ulp offset); the values are
  extracted verbatim as interoperability constants, the same way one
  embeds a CRC polynomial table.
"""

from __future__ import annotations

import math
import os
import re
import sys

HEADER = "src/crush/crush_ln_table.h"
OUT = os.path.join(os.path.dirname(__file__), "_ln_tables.py")


def gen_rh_lh() -> list[int]:
    out = []
    for k in range(129):
        idx = 256 + 2 * k
        rh = -(-(1 << 56) // idx)  # ceil
        lh = int(2.0**48 * math.log2(1.0 + k / 128.0))
        if k == 128:
            lh = 0xFFFF00000000
        out += [rh, lh]
    return out


def parse_header(path: str, name: str) -> list[int]:
    src = open(path).read()
    m = re.search(re.escape(name) + r"\[[^\]]*\] = \{(.*?)\};", src, re.S)
    return [int(x, 16) for x in re.findall(r"0x([0-9a-fA-F]+)u?ll", m.group(1))]


def main(reference_root: str) -> None:
    header = os.path.join(reference_root, HEADER)
    rh_lh = gen_rh_lh()
    ll = parse_header(header, "__LL_tbl")
    assert len(ll) == 256
    ref_rh_lh = parse_header(header, "__RH_LH_tbl")
    assert rh_lh == ref_rh_lh, "RH/LH closed form no longer matches reference"

    with open(OUT, "w") as f:
        f.write('"""Generated by _gen_tables.py — do not edit.\n\n')
        f.write("Fixed-point log tables for straw2 (see _gen_tables.py for\n")
        f.write("provenance; RH/LH from closed form, LL extracted).\n")
        f.write('"""\n\n')
        f.write("RH_LH_TBL = [\n")
        for v in rh_lh:
            f.write(f"    0x{v:016x},\n")
        f.write("]\n\nLL_TBL = [\n")
        for v in ll:
            f.write(f"    0x{v:016x},\n")
        f.write("]\n")
    print(f"wrote {OUT}: {len(rh_lh)} RH/LH + {len(ll)} LL entries")


if __name__ == "__main__":
    main(*sys.argv[1:])
