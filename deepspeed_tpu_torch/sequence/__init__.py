"""Sequence-dimension attention dispatch of the PyTorch port."""
