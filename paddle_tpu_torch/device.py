"""Device selection for the PyTorch/CUDA port.

Every entry point of the port (`GPT2`, `PagedKVCache`,
`PagedGenerationServer`) takes a `device` argument and resolves it here.
The rule is strict: the default is the first CUDA card, and when no card
is present the caller gets an error naming the fix — the port never
drops quietly to the CPU. The CPU is used only when the caller asks for
it (`device="cpu"`), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on.

    None -> `cuda:0`; raises RuntimeError when CUDA is not available.
    An explicit "cpu" (or any torch.device / device string) is honoured
    as given; an explicit CUDA device is checked like the default."""
    if device is None:
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False here; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


__all__ = ["resolve_device"]
