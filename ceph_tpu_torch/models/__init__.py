"""The CRUSH map model (own copy of the reference package's)."""
