"""fluid.dygraph compatibility (ref: python/paddle/fluid/dygraph/; the
port of `paddle_tpu/fluid/dygraph.py`).

Dygraph is the default mode, so `guard(place)` turns static mode off and,
given a place, makes it the default device inside the block (1.x code
names its device this way: `guard(fluid.CUDAPlace(0))`). `amp_guard` is
`amp.auto_cast` and `AmpScaler` is `amp.GradScaler`, which scales the
loss only when built under a float16 `auto_cast` (the reference's rule,
`paddle_tpu/amp/__init__.py:84`).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import device as _device
from ..core import mode
from ..core.tensor import to_tensor
from ..nn import (  # noqa: F401  fluid-era layer aliases
    BatchNorm, Embedding, LayerList, Linear, Sequential,
)
from ..nn.layer.layers import Layer  # noqa: F401
from ..jit import TranslatedLayer  # noqa: F401


@contextlib.contextmanager
def guard(place=None):
    was_static = mode.in_static_mode()
    mode.disable_static()
    try:
        if place is None:
            yield
        else:
            with _device.device_guard(place):
                yield
    finally:
        if was_static:
            mode.enable_static()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """A tensor of `value` on the default device (a tensor is returned as
    it is, as the reference does)."""
    if torch.is_tensor(value):
        return value
    return to_tensor(np.asarray(value), dtype=dtype)


def enabled():
    return mode.in_dygraph_mode()


class Conv2D(Layer):
    """fluid.dygraph.Conv2D (NCHW, act fused — old ctor signature)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__()
        from ..nn import Conv2D as NewConv2D
        self._conv = NewConv2D(num_channels, num_filters, filter_size,
                               stride=stride, padding=padding,
                               dilation=dilation, groups=groups or 1,
                               weight_attr=param_attr, bias_attr=bias_attr)
        self._act = act

    def forward(self, x):
        from .. import ops
        out = self._conv(x)
        return getattr(ops, self._act)(out) if self._act else out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True):
        super().__init__()
        self._cfg = dict(pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling, ceil_mode=ceil_mode,
                         exclusive=exclusive)

    def forward(self, x):
        from ..static.nn import pool2d
        return pool2d(x, **{k: v for k, v in self._cfg.items()
                            if k in ("pool_size", "pool_type", "pool_stride",
                                     "pool_padding", "global_pooling",
                                     "ceil_mode", "exclusive")})


def save_dygraph(state_dict, model_path):
    from ..framework.io import save
    save(state_dict, model_path + ".pdparams")


def load_dygraph(model_path):
    import os

    from ..framework.io import load
    params = load(model_path + ".pdparams") \
        if os.path.exists(model_path + ".pdparams") else None
    opt = load(model_path + ".pdopt") \
        if os.path.exists(model_path + ".pdopt") else None
    return params, opt


from ..autograd import no_grad  # noqa: E402,F401


# ---- 1.x dygraph aliases onto the 2.0 implementations (ref:
# python/paddle/fluid/dygraph/{nn,learning_rate_scheduler,checkpoint}.py;
# the fluid-era ctor quirks live with the aliased classes) ----
from ..nn import (  # noqa: E402,F401
    BilinearTensorProduct, Conv2DTranspose, Conv3D, Conv3DTranspose,
    Dropout, Flatten, GRUCell, GroupNorm, InstanceNorm2D as InstanceNorm,
    LSTMCell, LayerNorm, PReLU as PRelu, ParameterList, SpectralNorm,
)
from ..optimizer.lr import (  # noqa: E402,F401
    CosineAnnealingDecay as CosineDecay, ExponentialDecay,
    InverseTimeDecay, LambdaDecay, LinearWarmup as LinearLrWarmup,
    MultiStepDecay, NaturalExpDecay, NoamDecay, PiecewiseDecay,
    PolynomialDecay, ReduceOnPlateau as ReduceLROnPlateau, StepDecay,
)
from ..amp import GradScaler as AmpScaler, auto_cast as amp_guard  # noqa: E402,F401
from ..distributed.collective import ParallelEnv  # noqa: E402,F401
from ..distributed.parallel import DataParallel  # noqa: E402,F401
from ..jit import (  # noqa: E402,F401
    ProgramTranslator, TracedLayer, declarative, not_to_static,
    set_code_level, set_verbosity, to_static as dygraph_to_static_func,
)
from ..autograd import grad  # noqa: E402,F401
from . import dygraph as _self_mod  # noqa: E402

save = save_dygraph
load = load_dygraph
no_grad_ = no_grad


def disable_dygraph():
    mode.enable_static()


def enable_dygraph(place=None):
    mode.disable_static()


def prepare_context(strategy=None):
    from ..distributed.collective import init_parallel_env
    return init_parallel_env()


class GRUUnit(Layer):
    """fluid.dygraph.GRUUnit (ref: dygraph/nn.py GRUUnit): single-step GRU
    over pre-projected gate inputs [B, 3*hidden]."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__()
        from ..nn import GRUCell as _GRUCell
        self.hidden = size // 3
        self._cell = _GRUCell(self.hidden, self.hidden)

    def forward(self, input, hidden):  # noqa: A002
        h, new = self._cell(input[:, : self.hidden], hidden)
        return new, None, h


class NCE(Layer):
    """fluid.dygraph.NCE (ref: dygraph/nn.py NCE): noise-contrastive
    estimation with uniform negatives from the port's generator of the
    input's device."""

    def __init__(self, num_total_classes, dim, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=5,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False):
        super().__init__()
        from ..core.tensor import make_parameter
        from ..nn import initializer as I
        self.num_total_classes = num_total_classes
        self.num_neg_samples = num_neg_samples
        self.weight = make_parameter(I.XavierUniform()(
            (num_total_classes, dim), "float32"))
        self.bias = make_parameter(I.Constant(0.0)((num_total_classes,),
                                                   "float32"))

    def forward(self, input, label, sample_weight=None):  # noqa: A002
        from ..core import rng as rng_mod
        x = input
        lv = label.reshape(-1).long()
        negs = torch.randint(0, self.num_total_classes,
                             (x.shape[0], self.num_neg_samples),
                             device=x.device,
                             generator=rng_mod.generator(x.device))
        pos = (x * self.weight[lv]).sum(-1) + self.bias[lv]
        neg = torch.einsum("bd,bnd->bn", x, self.weight[negs]) \
            + self.bias[negs]
        return (torch.nn.functional.softplus(-pos)
                + torch.nn.functional.softplus(neg).sum(-1))[:, None]


class TreeConv(Layer):
    """fluid.dygraph.TreeConv (ref: dygraph/nn.py TreeConv): tree-based
    convolution over node features with adjacency-continuity weights.
    Dense rework: nodes [B, N, D], edges adjacency [B, N, N]."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        from ..core.tensor import make_parameter
        from ..nn import initializer as I
        self.max_depth = max_depth
        self.act = act
        self.W = make_parameter(I.XavierUniform()(
            (feature_size, 3, output_size, num_filters), "float32"))
        self.bias = make_parameter(I.Constant(0.0)(
            (num_filters, output_size), "float32"))

    def forward(self, nodes_vector, edge_set):
        from .. import ops as _ops2
        xv = nodes_vector
        # propagate features up to max_depth hops; weights [D, 3, O, F]
        # use the 3 continuity slots as (self, child-mean, depth-mix)
        a = edge_set.to(xv.dtype)
        deg = torch.clamp(a.sum(-1, keepdim=True), min=1.0)
        child = (a @ xv) / deg
        hops = child
        mix = torch.zeros_like(xv)
        for _ in range(self.max_depth - 1):
            hops = (a @ hops) / deg
            mix = mix + hops
        feats = torch.stack([xv, child, mix], dim=2)
        # y: [B, N, O, F]; bias is [F, O] -> transposed to broadcast
        out = torch.einsum("bnsd,dsof->bnof", feats, self.W) \
            + self.bias.T[None, None]
        return getattr(_ops2, self.act)(out) if self.act else out


# ---- submodule attribute surface of the reference package (ref:
# fluid/dygraph/__init__.py binds base/checkpoint/container/... as
# attributes; 1.x user code reaches e.g. fluid.dygraph.base.to_variable
# and fluid.dygraph.learning_rate_scheduler.NoamDecay) ----
import sys as _sys

nn = _sys.modules[__name__]      # dygraph layer classes live right here
layers = _sys.modules[__name__]  # Layer/sublayer defs (dygraph/layers.py)


class base:  # ref: fluid/dygraph/base.py
    from ..core.mode import in_dygraph_mode
    in_dygraph_mode = staticmethod(in_dygraph_mode)
    enabled = staticmethod(enabled)
    to_variable = staticmethod(to_variable)
    guard = staticmethod(guard)

    @staticmethod
    def in_declarative_mode():
        from ..core import mode
        return mode.in_static_mode()


class checkpoint:  # ref: fluid/dygraph/checkpoint.py
    save_dygraph = staticmethod(save_dygraph)
    load_dygraph = staticmethod(load_dygraph)


class container:  # ref: fluid/dygraph/container.py
    @staticmethod
    def _bind():
        pass


class rnn:  # ref: fluid/dygraph/rnn.py
    @staticmethod
    def _bind():
        pass


class learning_rate_scheduler:  # ref: fluid/dygraph/learning_rate_scheduler.py
    @staticmethod
    def _bind():
        pass


class tracer:  # ref: fluid/dygraph/tracer.py
    class Tracer:
        """The C++ imperative tracer is torch's autograd here; this
        shell satisfies isinstance checks and the train/eval flag
        contract."""

        def __init__(self):
            self._train_mode = True

        def train_mode(self):
            self._train_mode = True

        def eval_mode(self):
            self._train_mode = False


class StaticModelRunner:
    """1.x: run a saved static inference model inside dygraph (ref:
    fluid/dygraph/static_runner.py delegating to TranslatedLayer). Load
    the artifact with jit.load and call it like a Layer."""

    def __new__(cls, model_dir, model_filename=None, params_filename=None):
        import os

        from .. import jit as _jit
        stem = (model_filename or "__model__").replace(".pdmodel", "")
        if params_filename is not None:
            pstem = params_filename.replace(".pdiparams", "")
            if pstem != stem:
                raise ValueError(
                    f"artifact pair must share one prefix: model "
                    f"'{stem}' vs params '{pstem}' — jit.save writes "
                    "<prefix>.pdmodel + <prefix>.pdiparams")
        prefix = os.path.join(model_dir, stem)
        if not os.path.exists(prefix + ".pdmodel"):
            raise FileNotFoundError(
                f"no {prefix}.pdmodel; StaticModelRunner loads artifacts "
                "written by paddle.jit.save(prefix) — pass "
                "model_filename to pick a non-default prefix")
        return _jit.load(prefix)


def monkey_patch_math_varbase():
    """The tensor is torch.Tensor, whose operators need no patching;
    kept callable for 1.x code invoking it explicitly."""


def _late_bind():
    # populated after import so the class namespaces can reference
    # modules that import THIS module (container/rnn/lr/amp/parallel/io)
    from .. import amp as _amp
    from .. import jit as _jit
    from ..distributed import parallel as _par
    from ..nn import LayerList, ParameterList, Sequential
    from ..nn import GRUCell, LSTMCell
    from ..optimizer import lr as _lr
    container.LayerList = LayerList
    container.Sequential = Sequential
    container.ParameterList = ParameterList
    rnn.LSTMCell = LSTMCell
    rnn.GRUCell = GRUCell
    for _n in ("NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
               "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
               "CosineAnnealingDecay", "StepDecay", "MultiStepDecay",
               "LambdaDecay", "LinearWarmup", "ReduceOnPlateau",
               "ReduceLROnPlateau"):
        if hasattr(_lr, _n):
            setattr(learning_rate_scheduler, _n, getattr(_lr, _n))
    learning_rate_scheduler.CosineDecay = getattr(
        _lr, "CosineAnnealingDecay", None)
    globals()["amp"] = _amp
    globals()["jit"] = _jit
    globals()["parallel"] = _par
    globals()["io"] = _jit          # TranslatedLayer machinery
    globals()["dygraph_to_static"] = _jit  # ProgramTranslator home
    globals()["static_runner"] = _sys.modules[__name__]


_late_bind()  # fluid.dygraph imports after nn/optimizer, so this is safe
