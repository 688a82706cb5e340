"""Command-line tools: vstart (a local cluster), rados (object I/O
against a live cluster), crushtool (compile, decompile, build and test
CRUSH maps), osdmaptool (create, print, map-test and balance OSD maps),
dencoder (encode/decode round trips of the wire types), monstore_tool
and objectstore_tool (offline store inspection)."""
