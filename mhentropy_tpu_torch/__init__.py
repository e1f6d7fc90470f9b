"""mhentropy_tpu_torch — the PyTorch / CUDA port of mhentropy_tpu for NVIDIA
Hopper GPUs.

It mirrors the JAX package's layout (core/, flows/, models/, train/,
serve.py) and is tested against it; it imports torch and never JAX. The
kernels the JAX package wrote in Pallas are CUDA C++ under csrc/, built at
first use by ext.py. ROADMAP.md lists what is ported.
"""
