"""The OSD map and its PG -> OSD pipeline."""
