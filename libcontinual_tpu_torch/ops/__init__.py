"""Ops: the hand-written CUDA kernels and their plain PyTorch versions."""
