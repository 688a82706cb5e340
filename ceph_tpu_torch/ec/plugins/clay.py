"""clay plugin entry (ErasureCodePluginClay.cc analog)."""

from ..clay import ErasureCodeClay
from ..plugin import register_plugin


def make_codec(profile: dict):
    codec = ErasureCodeClay()
    codec.init(profile)
    return codec


register_plugin("clay", make_codec)
