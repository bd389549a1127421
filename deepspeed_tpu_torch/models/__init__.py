"""Model zoo of the PyTorch port (Llama/Mistral/Mixtral path)."""

from .transformer import (TransformerConfig, TransformerLM,  # noqa: F401
                          llama2_7b, mistral_7b, mixtral_8x7b,
                          tiny_test)
