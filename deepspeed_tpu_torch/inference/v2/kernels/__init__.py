"""Attention kernels of the ragged engine: hand-written CUDA for Hopper
(csrc/) behind wrappers that keep a plain PyTorch version beside each."""
