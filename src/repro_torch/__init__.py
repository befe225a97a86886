"""DART on torch: the PGAS runtime of DART-MPI with its one-sided data
path on an NVIDIA Hopper card.

A port of the JAX package ``repro`` with the same module layout and
public names; ``repro_torch.core`` is the public API.  The package
imports torch and numpy only.
"""
