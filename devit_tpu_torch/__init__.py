"""devit_tpu_torch: the PyTorch + CUDA port of devit_tpu for NVIDIA Hopper.

The JAX package `devit_tpu` stays the reference; module paths here mirror
its paths so each counterpart is easy to find. Nothing here imports JAX or
the JAX package. Entry points run on CUDA unless the caller passes
device="cpu" (see device.py).
"""
