"""`paddle.tensor` of the port: the functional tensor API (every op of
`ops`, `to_tensor`, `is_tensor`). The fluid-era names the reference
re-exports from its `compat` module are not ported yet (ROADMAP
§A 10 (e2))."""
from ..core.tensor import Tensor, is_tensor, to_tensor  # noqa: F401
from ..ops import *  # noqa: F401,F403
