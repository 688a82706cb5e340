"""Helpers: the versioned map blobs (denc), retry pacing (backoff) and
the runtime's Prometheus text surface (exporter)."""
