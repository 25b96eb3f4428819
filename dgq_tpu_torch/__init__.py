"""PyTorch + CUDA port of dgq_tpu's LLaMA W4A8 INT8 engine for NVIDIA Hopper.

The JAX package ``dgq_tpu`` is the reference; this package imports neither
JAX nor ``dgq_tpu``.  Kernels are hand-written CUDA C++ (``csrc/``), built
with nvcc at first use (``ops/_cuda.py``).
"""
