"""Training runtime of the PyTorch port."""
