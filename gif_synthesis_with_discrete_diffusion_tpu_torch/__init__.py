"""PyTorch / CUDA port of ``gif_synthesis_with_discrete_diffusion_tpu``.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path and name (``models/``, ``ops/``, ``convert/``), and
every TPU kernel of the repo is a kernel written by hand for NVIDIA
Hopper in CUDA C++ (the sources under ``csrc/``, built by
``ops/cuda_build.py``; the port carries no Triton kernel). Each kernel
wrapper runs its plain PyTorch version only for tensors on the CPU.

This package imports ``torch`` and never ``jax`` or ``flax``.
"""
