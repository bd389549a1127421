"""ZeRO of the PyTorch port: the host-side optimizer offload."""
