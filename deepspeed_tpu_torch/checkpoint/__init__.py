"""Checkpoint and weight interop of the PyTorch port."""
