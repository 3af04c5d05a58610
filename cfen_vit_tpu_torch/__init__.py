"""PyTorch/CUDA port of cfen_vit_tpu for NVIDIA Hopper (H100).

The JAX package `cfen_vit_tpu` is the reference; every module here names
its counterpart there.  This package imports `torch` and never `jax`.
Maps are NCHW, tokens are batch-first [N, S, E], and parameters carry the
reference checkpoints' `state_dict` key names, so a reference `.pth` loads
with `strict=True` once its dead tensors are dropped (interop/torch_import).

The TPU kernels on the inference path are hand-written CUDA C++ for sm_90a
(csrc/, built on first use by ops/_build.py); each wrapper runs its plain
PyTorch version for CPU tensors and its kernel for CUDA tensors.
"""
