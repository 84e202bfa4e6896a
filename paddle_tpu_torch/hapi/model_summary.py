"""paddle.summary (`hapi.model_summary`): the total and trainable
parameter counts of a network, printed and returned as the reference's
`{"total_params", "trainable_params"}`. `input_size`, `dtypes` and
`input` are accepted as the reference's signature has them; the counts
do not depend on them."""
from __future__ import annotations

__all__ = ["summary"]


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    params = net.parameters()
    total = sum(p.numel() for p in params)
    trainable = sum(p.numel() for p in params
                    if getattr(p, "trainable", p.requires_grad))
    print(f"Total params: {total:,}\n"  # cli-print: summary() report
          f"Trainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
