"""Data-reduction plane of the CUDA port: content-defined chunking and
batched chunk fingerprints (`chunker`).  The chunk store
(ceph_tpu/dedup/plane.py) is OSD-side and waits for the cluster
slice."""

from .chunker import (CHUNK_AVG, CHUNK_MAX, CHUNK_MIN,
                      CHUNK_OID_PREFIX, boundary_batch,
                      candidate_mask_host, chunk_host, chunk_oid,
                      fingerprint, fingerprint_batch, parse_chunk_oid,
                      resolve_cuts, split)

__all__ = [
    "CHUNK_AVG", "CHUNK_MAX", "CHUNK_MIN", "CHUNK_OID_PREFIX",
    "boundary_batch", "candidate_mask_host", "chunk_host",
    "chunk_oid", "fingerprint", "fingerprint_batch", "parse_chunk_oid",
    "resolve_cuts", "split",
]
