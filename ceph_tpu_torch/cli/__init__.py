"""Command-line tools: osdmaptool (create, print, map-test and balance
OSD maps)."""
