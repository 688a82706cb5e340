"""CRUSH: the exact host engine, the bulk device mapper and its kernels."""
