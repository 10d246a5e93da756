"""PyTorch + CUDA port of the raw-signal decision step of warpdemux_tpu.

The JAX package `warpdemux_tpu` is the reference; this package computes the
same decisions with PyTorch, and every TPU kernel on its path is a CUDA
kernel written for Hopper (csrc/). CPU tensors take each kernel's plain
PyTorch version, CUDA tensors take the kernel. The package never imports
jax or warpdemux_tpu; it reads the reference package's data files (model
bundles, CNN weights, chemistry TOMLs) by path.
"""

__version__ = "0.1.0"
