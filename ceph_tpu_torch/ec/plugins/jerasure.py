"""jerasure plugin entry (ErasureCodePluginJerasure.cc analog)."""

from ..jerasure import make_codec
from ..plugin import register_plugin

register_plugin("jerasure", make_codec)
