"""Model parameter layouts of the port."""
from .gpt2 import GPT2, GPT2Config, from_reference_params  # noqa: F401

__all__ = ["GPT2", "GPT2Config", "from_reference_params"]
