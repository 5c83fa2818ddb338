"""PyTorch/CUDA port of xmask3d_tpu for NVIDIA Hopper.

The JAX package `xmask3d_tpu` is the reference; this package keeps its module
paths and public layouts (NHWC images, (B, V, C) voxel features) and imports
nothing of it. Hot ops run through hand-written CUDA kernels under `csrc/`,
built at first use by `ops/_build.py`.
"""
