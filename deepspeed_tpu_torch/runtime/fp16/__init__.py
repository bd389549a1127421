"""fp16 loss scaling of the PyTorch port."""
