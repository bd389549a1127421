"""Inference engines of the PyTorch port."""
from .config import DeepSpeedInferenceConfig  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
