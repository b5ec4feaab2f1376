"""PyTorch + CUDA port of arttts_tpu for NVIDIA Hopper (H100).

The JAX package `arttts_tpu` stays the reference; this package imports
neither it nor JAX. Plain tensor code is PyTorch; every TPU kernel on the
ported path is a hand-written CUDA kernel under `csrc/`, built at first use
(`ops/_build.py`).
"""
