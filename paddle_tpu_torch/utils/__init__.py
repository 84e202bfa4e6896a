"""paddle.utils of the port (the reference's `paddle_tpu/utils/`): the
training `watchdog`, the `profiler` over torch.profiler, the
batch-windowed `Profiler`, `run_check`, `download` (a local weights
directory: nothing downloads), `try_import`, `deprecated`,
`require_version`, `dump_config`, `load_op_library`, `unique_name` and
the `install_check` module path. The reference's
`enable_persistent_compilation_cache` configures JAX's compile cache
and has no counterpart here."""
from __future__ import annotations

from ..core import unique_name  # noqa: F401
from . import profiler  # noqa: F401
from . import watchdog  # noqa: F401
from .watchdog import Watchdog  # noqa: F401


def try_import(name):
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError:
        raise ImportError(f"module {name} not available in this environment")


def run_check(device=None):
    """Print the card (or the CPU, when asked for) and take one SGD step
    of a Linear there: the reference's installation check."""
    import torch

    from .. import nn, optimizer, to_tensor
    from ..device import device_guard, resolve_device

    dev = resolve_device(device)
    print("paddle_tpu_torch is installed successfully!")  # cli-print: run_check
    print(f"device: {dev}"  # cli-print
          + (f" ({torch.cuda.get_device_name(dev)})"
             if dev.type == "cuda" else ""))
    with device_guard(dev):
        lin = nn.Linear(4, 2)
        lin(to_tensor([[1.0, 2.0, 3.0, 4.0]])).sum().backward()
        optimizer.SGD(0.1, parameters=lin.parameters()).step()
    print("single-device training check: OK")  # cli-print


def deprecated(since=None, update_to=None, reason=None):
    def deco(fn):
        return fn
    return deco


from . import download  # noqa: E402,F401  (the module, as the reference)
from .download import get_weights_path_from_url  # noqa: E402,F401


def dump_config(config, path=None):
    import json
    s = json.dumps(config, indent=2, default=str)
    if path:
        with open(path, "w") as f:
            f.write(s)
    return s


def require_version(min_version, max_version=None):
    from ..version import full_version

    def _tup(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())
    cur = _tup(full_version)
    if _tup(min_version) > cur:
        raise Exception(
            f"paddle_tpu_torch>={min_version} required, found {full_version}")
    if max_version and _tup(max_version) < cur:
        raise Exception(
            f"paddle_tpu_torch<={max_version} required, found {full_version}")


def load_op_library(lib_path):
    """A native library of custom ops, loaded by ctypes (the port's own
    kernels are built and bound by `ops.kernels`)."""
    import ctypes
    return ctypes.CDLL(lib_path)


class ProfilerOptions:
    """Config dict with defaults (ref: utils/profiler.py:26)."""

    def __init__(self, options=None):
        import sys as _sys
        self.options = {
            "state": "All", "sorted_key": "default",
            "tracer_level": "Default", "batch_range": [0, _sys.maxsize],
            "output_thread_detail": False, "profile_path": "none",
            "timeline_path": "none", "op_summary_path": "none",
        }
        if options is not None:
            for key in self.options:
                if options.get(key) is not None:
                    self.options[key] = options[key]

    def with_state(self, state):
        self.options["state"] = state
        return self

    def __getitem__(self, name):
        if self.options.get(name) is None:
            raise ValueError(
                f"ProfilerOptions does not have an option named {name}.")
        val = self.options[name]
        return None if isinstance(val, str) and val == "none" else val


_current_profiler = None


class Profiler:
    """Batch-windowed profiling context (ref: utils/profiler.py:63):
    starts/stops the profiler when batch_id enters/leaves batch_range;
    reset_once_per_batch drives it from the train loop."""

    def __init__(self, enabled=True, options=None):
        self.profiler_options = options if options is not None \
            else ProfilerOptions()
        self.batch_id = 0
        self.enabled = enabled
        self._running = False

    def __enter__(self):
        global _current_profiler
        self.previous_profiler = _current_profiler
        _current_profiler = self
        if self.enabled and \
                self.profiler_options["batch_range"][0] == 0:
            self.start()
        return self

    def __exit__(self, *exc):
        global _current_profiler
        _current_profiler = self.previous_profiler
        self.stop()

    def start(self):
        if self.enabled and not self._running:
            profiler.start_profiler(
                state=self.profiler_options["state"],
                tracer_option=self.profiler_options["tracer_level"],
                profile_path=self.profiler_options["profile_path"])
            self._running = True

    def stop(self):
        if self.enabled and self._running:
            profiler.stop_profiler(
                sorted_key=self.profiler_options["sorted_key"])
            self._running = False

    def reset(self):
        lo, hi = self.profiler_options["batch_range"]
        if self.batch_id == lo:
            self.start()
        elif self.batch_id == hi:
            self.stop()
        self.batch_id += 1

    # reference name for per-batch driving
    reset_once_per_batch = reset


def get_profiler():
    global _current_profiler
    if _current_profiler is None:
        _current_profiler = Profiler()
    return _current_profiler


class OpLastCheckpointChecker:
    """Op version-checkpoint query (ref: utils/op_version.py:50): the
    port's ops carry no version checkpoints, so every query returns the
    empty update list, as the reference's does."""

    def __init__(self):
        self.checkpoints_map = {}

    def filter_updates(self, op_name, type=None, key=""):  # noqa: A002
        return []


from . import install_check  # noqa: E402,F401
