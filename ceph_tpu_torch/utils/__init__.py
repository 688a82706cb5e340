"""Encoding helpers (the versioned map blobs)."""
