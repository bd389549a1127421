"""Builders of the port's hand-written kernels."""
