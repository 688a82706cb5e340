"""Bulk PG mapping over the device mapper."""
