"""lrc plugin registration (the dlopen entry point analog)."""

from ..lrc import ErasureCodeLrc
from ..plugin import register_plugin


def _factory(profile):
    codec = ErasureCodeLrc()
    codec.init(profile)
    return codec


register_plugin("lrc", _factory)
