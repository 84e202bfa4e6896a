"""GPT-2 of the port: parameter layouts and the training path."""
from .gpt2 import (GPT2, GPT2Config, build_train_step,  # noqa: F401
                   from_reference_params)

__all__ = ["GPT2", "GPT2Config", "build_train_step", "from_reference_params"]
