"""paddle.inference: the Predictor over a deployment artifact, and the
servers; the port of `paddle_tpu/inference/__init__.py` (ref:
paddle/fluid/inference/api/analysis_predictor.cc and the paddle.inference
Python API).

The Predictor. `create_predictor(Config(prefix + ".pdmodel", prefix +
".pdiparams"))` loads what `jit.save` or `static.save_inference_model`
wrote (`jit`'s module docstring has the artifact) in a fresh process
with no model class: the exported program and its weights, resident on
the device. It runs on the card unless `Config.disable_gpu()` is called,
and raises when no card is present. On the card, `run` captures one CUDA
graph for each set of input shapes (`nn.decode_graph.ProgramGraphs`:
static input buffers, the weights read in place, the launches the
capture counted added at every replay) and replays it: the counterpart
of the reference's one AOT XLA computation. On the CPU it runs the
program eagerly. There is no fallback from the card to the CPU.

The handle flow is the reference's: `get_input_names()` (the feed names
of a static program, else `input_0`, `input_1`, ...),
`get_input_handle(name).copy_from_cpu(array)` (or `.reshape`), `run()`,
`get_output_names()`, `get_output_handle(name).copy_to_cpu()`.
`run([arrays])` takes and returns arrays' tensors directly.
`PredictorPool(config, n)` shares one loaded program and one copy of the
weights between n predictors (and their graphs); each keeps its handles.
The enums (`DataType`, `PlaceType`, `PrecisionType`),
`get_num_bytes_of_data_type` and `get_version` are the reference's.

The servers (`PagedGenerationServer`, `GenerationServer`, ...) are the
serving path (`serving.py`); they bind at first use, so a process that
only predicts does not import them.
"""
from __future__ import annotations

import importlib as _importlib
import os

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..device import resolve_device


class Config:
    """paddle.inference.Config (ref: analysis_config.cc):
    Config(prog_file, params_file), or Config(model_dir) with the
    default `inference.pdmodel` names."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = "cuda:0"
        self._memory_optim = True

    # --- file locations ------------------------------------------------
    def set_prog_file(self, path):
        self.model_path = path

    def set_params_file(self, path):
        self.params_path = path

    def prog_file(self):
        return self.model_path

    def params_file(self):
        return self.params_path

    def _prefix(self):
        """The common path prefix of the .pdmodel / .pdiparams pair."""
        p = self.model_path
        if p is None:
            raise ValueError("Config has no model path")
        if os.path.isdir(p):
            p = os.path.join(p, "inference")
        if p.endswith(".pdmodel"):
            p = p[: -len(".pdmodel")]
        return p

    # --- device / engine knobs ----------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self):
        return self._device != "cpu"

    def gpu_device_id(self):
        return 0 if self._device == "cpu" else int(self._device.split(":")[1])

    def switch_ir_optim(self, flag=True):
        pass  # the exported program is what runs; no IR pass pipeline

    def enable_memory_optim(self):
        self._memory_optim = True

    def switch_use_feed_fetch_ops(self, flag):
        pass

    def disable_glog_info(self):
        pass


class _IOHandle:
    """An input or output tensor handle (ref: ZeroCopyTensor):
    copy_from_cpu / copy_to_cpu move host arrays in and out."""

    def __init__(self, name):
        self.name = name
        self._array = None

    def copy_from_cpu(self, arr):
        self._array = np.ascontiguousarray(arr)

    def reshape(self, shape):
        if self._array is not None:
            self._array = self._array.reshape(shape)

    def copy_to_cpu(self):
        return np.asarray(self._array)

    def shape(self):
        return list(self._array.shape) if self._array is not None else None


class Predictor:
    """A runnable inference program (module docstring): from a loaded
    artifact (`jit.TranslatedLayer`, what `create_predictor` gives), or
    from a live layer, run eagerly in eval mode."""

    def __init__(self, model, example_inputs=None):
        from ..jit import TranslatedLayer
        self._translated = model if isinstance(model, TranslatedLayer) \
            else None
        self._layer = None if self._translated is not None else model
        self._in_handles = {}
        self._out_arrays = []
        self._graphs = None
        if self._translated is not None and \
                self._translated.device.type == "cuda":
            from ..nn.decode_graph import ProgramGraphs
            self._graphs = ProgramGraphs()
        elif self._layer is not None and hasattr(self._layer, "eval"):
            self._layer.eval()

    @property
    def device(self):
        if self._translated is not None:
            return self._translated.device
        p = next(iter(self._layer.parameters()), None)
        return p.device if p is not None else resolve_device(None)

    # --- direct call API ----------------------------------------------
    @staticmethod
    def _handle_order(name):
        # input_10 after input_2: by the numeric suffix
        stem, _, idx = name.rpartition("_")
        return (stem, int(idx)) if idx.isdigit() else (name, -1)

    def run(self, inputs=None):
        """run(): the handle flow, returns True. run([arrays]): the
        outputs as CPU tensors (one tensor, or the program's structure)."""
        if inputs is None:
            names = self.get_input_names()
            xs = [self._in_handles[n]._array for n in names]
            out = self._run_raw(xs)
            self._out_arrays = [o.numpy() for o in pytree.tree_leaves(out)]
            return True
        xs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        return self._run_raw(list(xs))

    __call__ = run

    def _run_raw(self, xs):
        from ..sampling.buffers import host_to_device
        dev = self.device
        ts = [x.detach().to(dev) if torch.is_tensor(x)
              else host_to_device(np.asarray(x), dev) for x in xs]
        with torch.no_grad():
            if self._translated is None:
                out = self._layer(*ts)
            elif self._graphs is None:
                out = self._translated(*ts)
            else:
                out = self._replay(ts)
        return pytree.tree_map(
            lambda t: t.detach().cpu() if torch.is_tensor(t) else t, out)

    def _replay(self, ts):
        tl = self._translated
        state = {**{"p:" + k: v for k, v in tl._params.items()},
                 **{"b:" + k: v for k, v in tl._bufs.items()}}
        spec = {}

        def fn(_state, *xs):
            out = tl.run_pure(tl._params, tl._bufs, *xs)
            leaves, spec["tree"] = pytree.tree_flatten(out)
            return tuple(leaves)

        leaves = self._graphs(("predictor", id(tl)), fn, state, tuple(ts))
        tree = spec.get("tree") or self._tree
        self._tree = tree
        return pytree.tree_unflatten(list(leaves), tree)

    # --- handle API (ref: paddle.inference zero-copy flow) -------------
    def get_input_names(self):
        if self._translated is not None:
            meta = self._translated._meta
            if "feed_names" in meta:
                return list(meta["feed_names"])
            return [f"input_{i}" for i in range(len(meta["in_specs"]))]
        return sorted(self._in_handles, key=self._handle_order) \
            or ["input_0"]

    def get_input_handle(self, name):
        return self._in_handles.setdefault(name, _IOHandle(name))

    def get_output_names(self):
        return [f"output_{i}" for i in range(max(1, len(self._out_arrays)))]

    def get_output_handle(self, name):
        idx = int(name.rsplit("_", 1)[-1]) if "_" in name else 0
        h = _IOHandle(name)
        if idx < len(self._out_arrays):
            h._array = self._out_arrays[idx]
        return h

    @property
    def graph_captures(self):
        return 0 if self._graphs is None else self._graphs.captures

    @property
    def graph_replays(self):
        return 0 if self._graphs is None else self._graphs.replays


def _load(config):
    from ..jit import load as jit_load
    return jit_load(config._prefix(), device=resolve_device(config._device))


def create_predictor(config_or_model, example_inputs=None):
    """paddle.inference.create_predictor: from a Config, the predictor of
    the artifact alone (ref: analysis_predictor.cc
    CreatePaddlePredictor); from a layer, a predictor over it."""
    if isinstance(config_or_model, Config):
        return Predictor(_load(config_or_model))
    return Predictor(config_or_model, example_inputs)


class DataType:
    """Element types of the predictor's tensors (ref: paddle_infer
    DataType)."""
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    INT64 = "int64"
    INT32 = "int32"
    UINT8 = "uint8"
    INT8 = "int8"


class PlaceType:
    """Where predictor tensors live; the accelerator names are the card."""
    kHOST = kCPU = "cpu"
    kGPU = kTPU = kXPU = "gpu"


class PrecisionType:
    """The serving precision asked for (ref: AnalysisConfig::Precision):
    Float32 runs as it is; Half is bfloat16 (export the model in it);
    Int8 takes a slim-converted model (`slim`'s save_quantized_model)."""
    Float32 = 0
    Half = 1
    Int8 = 2


def get_num_bytes_of_data_type(dtype):
    from ..core import dtype as dtype_mod
    return torch.empty((), dtype=dtype_mod.convert_dtype(dtype)).element_size()


def get_version():
    from ..version import full_version
    return (f"paddle_tpu_torch {full_version} (exported-program serving, "
            f"torch {torch.__version__})")


class PredictorPool:
    """N predictors over ONE loaded artifact (ref: fluid/inference
    PredictorPool): one program and one copy of the weights; each slot
    keeps its own handles and CUDA graphs."""

    def __init__(self, config, size=1):
        if size < 1:
            raise ValueError("pool size must be >= 1")
        if isinstance(config, Config):
            shared = _load(config)
            self._preds = [Predictor(shared) for _ in range(size)]
        else:
            self._preds = [create_predictor(config) for _ in range(size)]

    def retrive(self, idx):  # the reference's spelling
        return self._preds[idx]

    retrieve = retrive

    def __len__(self):
        return len(self._preds)


# the serving path binds at first use (PEP 562)
_LAZY = {"PagedKVCache": ".kv_cache", "BlockPoolExhausted": ".kv_cache",
         "blocks_for": ".kv_cache", "QuantizedKV": ".kv_quant",
         "kv_encode": ".kv_quant", "GenerationServer": ".serving",
         "PagedGenerationServer": ".serving", "RequestMeta": ".serving",
         "measure_offered_load": ".serving"}


def __getattr__(name):
    if name in _LAZY:
        obj = getattr(_importlib.import_module(_LAZY[name], __name__), name)
        globals()[name] = obj
        return obj
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Config", "Predictor", "create_predictor", "PredictorPool",
           "DataType", "PlaceType", "PrecisionType",
           "get_num_bytes_of_data_type", "get_version",
           "PagedGenerationServer", "GenerationServer", "RequestMeta",
           "measure_offered_load", "PagedKVCache", "BlockPoolExhausted",
           "blocks_for", "QuantizedKV", "kv_encode"]
