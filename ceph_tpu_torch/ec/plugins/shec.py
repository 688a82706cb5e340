"""shec plugin registration (ErasureCodePluginShec.cc analog)."""

from ..plugin import register_plugin
from ..shec import ErasureCodeShec, ErasureCodeShecSingle


def _factory(profile):
    technique = profile.get("technique", "multiple")
    cls = (ErasureCodeShecSingle if technique == "single"
           else ErasureCodeShec)
    codec = cls()
    codec.init(profile)
    return codec


register_plugin("shec", _factory)
