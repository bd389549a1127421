"""Model zoo of the PyTorch port (Llama/Mistral path)."""

from .transformer import (TransformerConfig, TransformerLM,  # noqa: F401
                          llama2_7b, mistral_7b, tiny_test)
