"""Ops of the port: the Paddle tensor-op library as module functions over
`torch.Tensor` (`creation`, `random`, `math`, `manipulation`, `search`,
`linalg`, `nn_ops`, `loss`: the ports of the reference's same-named
modules, Paddle's signatures and semantics), attention (`attention`: the
dense op of the training path and the paged ops of the serving path),
flash attention with its autograd rule (`flash_attention`), eager
control flow (`control`: `cond`, `while_loop`, `case`, ...), the
vocab-chunked loss (`chunked_xent`) and the CUDA kernels behind them
(`kernels`)."""
from .attention import (fused_feedforward,  # noqa: F401
                        fused_multi_head_attention, paged_decode_attention,
                        ragged_prefill_attention,
                        scaled_dot_product_attention)
from .chunked_xent import chunked_softmax_xent  # noqa: F401
from .control import (case, cond, fori_loop, scan,  # noqa: F401
                      switch_case, while_loop)
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .nn_ops import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from . import (control, creation, linalg, loss,  # noqa: F401
               manipulation, math, nn_ops, random, search)
# names whose op shadows a Python builtin get aliases
from .math import abs as abs_  # noqa: F401
from .math import max as max_  # noqa: F401
from .math import min as min_  # noqa: F401
from .math import sum as sum_  # noqa: F401

__all__ = (["paged_decode_attention", "ragged_prefill_attention",
            "scaled_dot_product_attention", "fused_feedforward",
            "fused_multi_head_attention", "chunked_softmax_xent", "case",
            "cond", "fori_loop", "scan", "switch_case", "while_loop"]
           + creation.__all__ + linalg.__all__ + loss.__all__
           + manipulation.__all__ + math.__all__ + nn_ops.__all__
           + random.__all__ + search.__all__)
