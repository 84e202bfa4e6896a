"""`paddle.tensor` of the port: the functional tensor API (every op of
`ops`, `to_tensor`, `is_tensor`) and the fluid-era names of `compat`
that the reference's `paddle.tensor` re-exports."""
from ..core.tensor import Tensor, is_tensor, to_tensor  # noqa: F401
from ..ops import *  # noqa: F401,F403
from ..ops import abs_, max_, min_, sum_  # noqa: F401
from ..compat import (  # noqa: F401,E402
    ComplexVariable, LoDTensor, LoDTensorArray, VarBase, addcmul,
    broadcast_shape, crop_tensor, elementwise_add, elementwise_div,
    elementwise_floordiv, elementwise_max, elementwise_min, elementwise_mod,
    elementwise_mul, elementwise_pow, elementwise_sub,
    get_tensor_from_selected_rows, has_inf, has_nan, is_empty, multiplex,
    numel, rank, reduce_all, reduce_any, reduce_max, reduce_mean, reduce_min,
    reduce_prod, reduce_sum, reverse, set_printoptions, shape, tensordot,
)
