"""fluid.layer_helper module path (ref: fluid/layer_helper.py; the port of
`paddle_tpu/fluid/layer_helper.py`).

The 1.x LayerHelper was how custom layers created parameters and
appended ops by name into the current Program. Here it
binds the same contract onto this stack's machinery — parameters via
the static Program block (static mode) or live Parameters (dygraph),
ops via the registered functional op library (`ops.<type>`), so simple
third-party 1.x custom layers run unchanged. The append_op protocol
maps op *types* to registry functions; exotic OpDesc-level usage should
move to the functional ops directly.
"""
from __future__ import annotations

from .. import ops as _ops


class LayerHelperBase:
    def __init__(self, name, layer_type=""):
        from ..core import unique_name
        self._layer_type = layer_type or name
        self.name = unique_name.generate(name or layer_type)

    @property
    def main_program(self):
        from ..static import default_main_program
        return default_main_program()

    def create_parameter(self, attr=None, shape=None, dtype="float32",
                         is_bias=False, default_initializer=None):
        # one implementation for both modes already exists — delegate
        # (static: Program-block parameter; dygraph: live Parameter)
        from .layers import create_parameter
        return create_parameter(shape, dtype, attr=attr, is_bias=is_bias,
                                default_initializer=default_initializer)


class LayerHelper(LayerHelperBase):
    def __init__(self, layer_type, **kwargs):
        super().__init__(kwargs.get("name") or layer_type, layer_type)
        self.kwargs = kwargs

    def input(self, input_param_name="input"):
        return self.kwargs[input_param_name]

    def attr(self, name):
        return self.kwargs.get(name)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        """1.x code pre-creates the output var then append_op fills it; on
        this stack ops RETURN their outputs, so this is a placeholder the
        append_op call below will replace."""
        return None

    def append_op(self, type, inputs=None, outputs=None, attrs=None):  # noqa: A002,E501
        """Run the registered op `type` with the 1.x-style inputs/attrs
        and return its result (also stored into `outputs` when the caller
        inspects it as a dict)."""
        fn = getattr(_ops, type, None)
        if fn is None:
            raise NotImplementedError(
                f"LayerHelper.append_op: no registered op named {type!r} —"
                " call the functional op from paddle_tpu_torch.ops directly")
        args = []
        for v in (inputs or {}).values():
            args.append(v[0] if isinstance(v, (list, tuple)) and len(v) == 1
                        else v)
        res = fn(*args, **(attrs or {}))
        if outputs:
            k = next(iter(outputs))
            outputs[k] = [res]
        return res

    def append_activation(self, out, act=None):
        act = act or self.kwargs.get("act")
        if not act:
            return out
        return getattr(_ops, act)(out)


__all__ = ["LayerHelper", "LayerHelperBase"]
