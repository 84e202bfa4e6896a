"""Device selection for the PyTorch/CUDA port.

Every entry point of the port (`GPT2`, `PagedKVCache`,
`PagedGenerationServer`, `to_tensor`, `Layer.create_parameter`, ...)
takes a `device` (or `place`) argument and resolves it here. The rule is
strict: the default is the first CUDA card, and when no card is present
the caller gets an error naming the fix — the port never drops quietly
to the CPU. The CPU is used only when the caller asks for it
(`device="cpu"`, or `set_device("cpu")` for every later default), as the
tests do.

The Paddle 2.0 device API (`paddle_tpu/core/place.py`,
`paddle_tpu/device.py`): `CPUPlace`, `CUDAPlace(i)`, `CUDAPinnedPlace`
(host memory; a CPUPlace here), `TPUPlace` and `XPUPlace` (accepted as
aliases that name the card, so code written for the reference runs
unchanged), `set_device("cpu" | "gpu" | "gpu:1" | "cuda" | "tpu" |
place)`, `get_device()` ("cpu" or "gpu:<i>") and `device_guard(place)`,
a context under which the default is `place` (the models build their
layers on the CPU this way, then move them).
"""
from __future__ import annotations

import contextlib

import torch


class Place:
    """A device slot: `torch_device()` gives the torch.device it names."""

    _type = "cpu"

    def __init__(self, device_id: int = 0):
        self._device_id = int(device_id)

    def get_device_id(self) -> int:
        return self._device_id

    def torch_device(self) -> torch.device:
        if self._type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self._device_id)

    def __eq__(self, other):
        return isinstance(other, Place) and \
            self.torch_device() == other.torch_device()

    def __hash__(self):
        return hash(str(self.torch_device()))

    def __repr__(self):
        if self._type == "cpu":
            return f"{type(self).__name__}()"
        return f"{type(self).__name__}({self._device_id})"


class CPUPlace(Place):
    def __init__(self):
        super().__init__(0)


class CUDAPlace(Place):
    _type = "cuda"


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a CPU place to the port's ops."""


# the reference's accelerator places name the card here
TPUPlace = CUDAPlace
XPUPlace = CUDAPlace

_ACCELERATORS = ("gpu", "cuda", "tpu", "xpu", "npu")
_current = None  # the torch.device set by set_device / device_guard


def _check_cuda(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default, and "
                "torch.cuda.is_available() is False here; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _parse(device) -> torch.device:
    """A place, torch.device or device string (Paddle's names or
    torch's) as a torch.device, unchecked."""
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, torch.device):
        return device
    name, _, idx = str(device).lower().partition(":")
    if name == "cpu":
        return torch.device("cpu")
    if name in _ACCELERATORS:
        return torch.device("cuda", int(idx) if idx else 0)
    return torch.device(device)


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on.

    None -> the device `set_device` / `device_guard` chose, else
    `cuda:0`; raises RuntimeError when that is a card and CUDA is not
    available. An explicit "cpu" (or any place, torch.device or device
    string) is honoured as given; an explicit CUDA device is checked like
    the default."""
    if device is None:
        dev = _current if _current is not None else torch.device("cuda", 0)
    else:
        dev = _parse(device)
    return _check_cuda(dev)


def set_device(device):
    """paddle.set_device: the default device of every later entry point
    ("cpu", "gpu", "gpu:1", "cuda:0", "tpu" or a place). Raises as
    `resolve_device` does when it names a card and there is none.
    Returns the place."""
    global _current
    _current = _check_cuda(_parse(device))
    return _place_of(_current)


def get_device() -> str:
    """"cpu" or "gpu:<i>": the device a default call lands on (raises
    without a card unless `set_device("cpu")` was called)."""
    dev = resolve_device(None)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def _place_of(dev: torch.device) -> Place:
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)


@contextlib.contextmanager
def device_guard(device):
    """Make `device` the default inside the block, then restore the
    previous default."""
    global _current
    prev = _current
    _current = _parse(device)
    try:
        yield
    finally:
        _current = prev


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def get_cudnn_version():
    """cuDNN's version as an int, or None where torch has none."""
    return torch.backends.cudnn.version() \
        if torch.backends.cudnn.is_available() else None


__all__ = ["resolve_device", "set_device", "get_device", "device_guard",
           "Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "TPUPlace",
           "XPUPlace", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "is_compiled_with_xpu", "is_compiled_with_cinn",
           "is_compiled_with_npu", "is_compiled_with_rocm",
           "get_cudnn_version"]
