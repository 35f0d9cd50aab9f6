"""PyTorch + CUDA port of biHomE for NVIDIA Hopper.

A second package beside ``bihome_tpu`` (the JAX reference, which stays
unchanged). Module names mirror the reference package so each module's
counterpart is easy to find. Public functions keep the JAX layouts: batch
dicts and perspective fields are NHWC, sample points are ``[B,P,C]``; inside
the backbone tensors are NCHW.

The package imports torch and numpy only — never ``jax`` nor anything from
``bihome_tpu``. CUDA kernels (``bihome_torch/csrc``) are compiled with nvcc
at first use, never at import.
"""
