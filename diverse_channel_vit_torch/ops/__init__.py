"""Tensor ops: plain PyTorch functions, and the wrappers of the hand-written
CUDA kernels (``fused_block``), each beside its plain version."""
