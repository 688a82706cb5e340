"""Data-reduction plane of the CUDA port: content-defined chunking and
batched chunk fingerprints (`chunker`), and the OSD-side refcounted
chunk store (`plane.DedupPlane`) that drives them on the daemon's
chip."""

from .chunker import (CHUNK_AVG, CHUNK_MAX, CHUNK_MIN,
                      CHUNK_OID_PREFIX, boundary_batch,
                      candidate_mask_host, chunk_host, chunk_oid,
                      fingerprint, fingerprint_batch, parse_chunk_oid,
                      resolve_cuts, split)
from .plane import (OBJ_LOGICAL_ATTR, OBJ_MANIFEST_ATTR, DedupPlane,
                    InternalObjecter, ObjecterError)

__all__ = [
    "CHUNK_AVG", "CHUNK_MAX", "CHUNK_MIN", "CHUNK_OID_PREFIX",
    "DedupPlane", "InternalObjecter", "ObjecterError",
    "OBJ_LOGICAL_ATTR", "OBJ_MANIFEST_ATTR",
    "boundary_batch", "candidate_mask_host", "chunk_host",
    "chunk_oid", "fingerprint", "fingerprint_batch", "parse_chunk_oid",
    "resolve_cuts", "split",
]
