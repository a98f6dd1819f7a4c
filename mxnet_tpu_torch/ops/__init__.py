"""Operators of the PyTorch port. ``kernels`` holds the hand-written CUDA
kernels' wrappers and their plain versions; ``_build`` compiles the CUDA
sources at first use (importing this package builds nothing)."""
