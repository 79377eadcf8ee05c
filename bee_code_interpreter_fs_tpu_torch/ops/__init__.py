"""Kernels of the port and their plain PyTorch versions (import the
submodules: ops.flash_attention, ops._build)."""
