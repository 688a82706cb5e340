"""Erasure coding: GF math, codec plugins, CUDA kernels.

Public surface:
    new_codec(profile, device=None) — build a codec from a profile dict
    ErasureCodePluginRegistry       — the plugin registry singleton
    ErasureCodeInterface            — codec contract
"""

from .interface import ErasureCodeInterface, ErasureCodeProfile
from .plugin import ErasureCodePluginRegistry, register_plugin


def new_codec(profile: ErasureCodeProfile,
              device=None) -> ErasureCodeInterface:
    """Instantiate a codec: profile must carry plugin=<name> (default
    jerasure) plus plugin-specific keys (k, m, technique, ...).  The
    codec's async entry points dispatch on `device` — the card unless
    the caller names another (device="cpu" runs the kernels' plain
    versions); without a card they raise."""
    plugin = profile.get("plugin", "jerasure")
    codec = ErasureCodePluginRegistry.instance().factory(plugin, profile)
    codec.device = device
    return codec


__all__ = [
    "ErasureCodeInterface",
    "ErasureCodeProfile",
    "ErasureCodePluginRegistry",
    "register_plugin",
    "new_codec",
]
