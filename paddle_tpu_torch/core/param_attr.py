"""ParamAttr: the port of `paddle_tpu/core/param_attr.py` (the bundle a
layer's `create_parameter` reads: name, initializer, learning-rate
scale, regularizer, trainable, need_clip)."""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None -> a default ParamAttr, False -> False (no parameter), a
        string -> a ParamAttr of that name, an initializer -> a ParamAttr
        with it."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return False
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        return ParamAttr(initializer=attr)


__all__ = ["ParamAttr"]
