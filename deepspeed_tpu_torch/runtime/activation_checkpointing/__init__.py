"""Activation checkpointing of the PyTorch port."""
