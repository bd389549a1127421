"""Inference engines of the PyTorch port."""
