"""PyTorch/CUDA port of the ``repro`` package (MIRAGE parameter remapping
for multi-tenant LLM serving), for NVIDIA Hopper.

It mirrors ``repro``'s subpackages (``configs``, ``models``, ``kernels``,
``core``, ``serving``) and imports neither JAX nor ``repro``. Attention on
CUDA tensors runs hand-written CUDA kernels (``kernels/csrc``); on CPU
tensors it runs their plain PyTorch versions (``models/attention_ops``).
"""
