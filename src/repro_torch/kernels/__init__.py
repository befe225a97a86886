"""Kernels of the torch port: hand-written CUDA for Hopper, each beside
its plain torch version."""
