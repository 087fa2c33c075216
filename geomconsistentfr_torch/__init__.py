"""PyTorch/CUDA port of geomconsistentfr_tpu: relighting inference on an NVIDIA GPU.

Imports torch, never jax or the JAX package. See README.md, "PyTorch/CUDA port".
"""
