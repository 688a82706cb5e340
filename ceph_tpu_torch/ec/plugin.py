"""Erasure-code plugin registry.

The reference gates every codec behind a dlopen plugin registry
(src/erasure-code/ErasureCodePlugin.cc:36-180: singleton, factory(),
load(), preload()).  Here plugins are python entry modules registered
under `ceph_tpu_torch.ec.plugins.<name>` — same boundary (codecs are looked
up by name + profile at pool creation, never linked directly), without
the dynamic-linker failure modes.  The loader still reproduces the
observable failure handling the reference tests exercise
(src/test/erasure-code/ErasureCodePluginFailToInitialize.cc etc.):
missing entry point, version mismatch, failing factory.
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable

from .interface import ErasureCodeInterface, ErasureCodeProfile

PLUGIN_API_VERSION = 1


class ErasureCodePlugin:
    """A named codec factory. Modules register one via register_plugin."""

    def __init__(self, name: str,
                 factory: Callable[[ErasureCodeProfile], ErasureCodeInterface],
                 version: int = PLUGIN_API_VERSION):
        self.name = name
        self.factory = factory
        self.version = version


class ErasureCodePluginRegistry:
    """Process-wide name -> plugin table with lazy module loading."""

    _instance: "ErasureCodePluginRegistry | None" = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self.disable_dlclose = False  # parity knob; no-op here

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = ErasureCodePluginRegistry()
            return cls._instance

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise KeyError("plugin %s already registered" % name)
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def load(self, name: str, module_path: str | None = None) -> ErasureCodePlugin:
        """Import the plugin module (which must call register_plugin) and
        return the registered plugin."""
        plugin = self.get(name)
        if plugin is None:
            path = module_path or ("ceph_tpu_torch.ec.plugins." + name)
            try:
                importlib.import_module(path)
            except ImportError as e:
                raise IOError("erasure-code plugin %s: load failed: %s"
                              % (name, e))
            plugin = self.get(name)
            if plugin is None:
                raise IOError(
                    "erasure-code plugin %s: module %s loaded but did not "
                    "register" % (name, path))
        if plugin.version != PLUGIN_API_VERSION:
            raise IOError("erasure-code plugin %s: API version %d != %d"
                          % (name, plugin.version, PLUGIN_API_VERSION))
        return plugin

    def factory(self, name: str,
                profile: ErasureCodeProfile) -> ErasureCodeInterface:
        """Instantiate a codec: load plugin, build, init with profile."""
        plugin = self.load(name)
        codec = plugin.factory(dict(profile))
        return codec

    def preload(self, names: list[str]) -> None:
        for name in names:
            self.load(name)


def register_plugin(name: str,
                    factory: Callable[[ErasureCodeProfile], ErasureCodeInterface],
                    version: int = PLUGIN_API_VERSION) -> None:
    ErasureCodePluginRegistry.instance().add(
        name, ErasureCodePlugin(name, factory, version))
