"""PyTorch + CUDA port of alvrl_tpu (Virtual Ray Light rendering).

The package mirrors the layout of ``alvrl_tpu``: each module here has a
counterpart of the same path there, which stays the reference. Plain
tensor code is PyTorch; the hot loop of the render (``ops.vrl_sum``) is
a hand-written CUDA kernel for Hopper (``csrc/vrl_sum.cu``), built with
``nvcc`` at first use. On CPU tensors every kernel wrapper runs its
plain PyTorch version instead.

This package imports torch and numpy only, never jax, flax or
``alvrl_tpu``.
"""
