"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100 (sm_90a).

The JAX package ``repro`` stays the reference; this package mirrors its module
names (``configs``, ``kernels``, ``models``, ``serve``, ``optim``, ``data``,
``train``, ``checkpoint``, ``launch``) and imports
neither ``jax`` nor anything of ``repro``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; every TPU kernel on a ported path
is a CUDA kernel written by hand (``kernels/csrc``) with a plain PyTorch twin
that the wrappers take only for tensors that lie on the CPU.
"""
