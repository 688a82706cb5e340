"""Erasure-code plugin modules. Importing a module registers its codec
factory with the ErasureCodePluginRegistry (the dlopen-directory analog,
src/erasure-code/ErasureCodePlugin.cc:120-178)."""
