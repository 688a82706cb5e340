"""isa plugin entry (ErasureCodePluginIsa.cc analog)."""

from ..isa import make_codec
from ..plugin import register_plugin

register_plugin("isa", make_codec)
