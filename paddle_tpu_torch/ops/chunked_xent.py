"""Chunked-vocabulary softmax cross-entropy: the language-model loss
without the [N, V] logits (the port of `paddle_tpu/ops/chunked_xent.py`).

`chunked_softmax_xent(x [N, E], w [V, E], labels [N], n_chunks,
ignore_index=-100)` equals `cross_entropy(x @ w.T, labels,
ignore_index=ignore_index)`: the mean over the rows whose label is not
`ignore_index` (at least one row counted) of logsumexp_v(x_i . w_v) -
x_i . w_{labels_i}. The vocabulary is zero-padded to a multiple of
`n_chunks` and scanned chunk by chunk with an online logsumexp in
float32 (the padded columns score -1e30); only one chunk's logits,
[N, ceil(V / n_chunks)], live at a time. `ChunkedSoftmaxXent`'s backward
recomputes each chunk's logits from x and w rather than keeping them:
p = exp(logits - m) / s from the forward's row statistics, d = (p -
one-hot) · g / count on valid rows and 0 on ignored ones, dx += d·w_c,
dw_c = dᵀ·x. dx and dw come back in x's and w's dtypes.

The reference runs it in XLA (a `lax.scan` under a custom VJP), not in a
Pallas kernel; the port runs it as PyTorch products, chunk by chunk. The
GPT-2 loss takes it when `PADDLE_TPU_CHUNKED_CE=<n>` is set with n > 1
and the embeddings are tied (`models/gpt2.py` `lm_loss`), as the
reference's `GPT2.loss` does.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _chunks(w, n_chunks):
    """w [V, E] zero-padded to a multiple of n_chunks rows, as
    [n_chunks, V / n_chunks, E]."""
    v, e = w.shape
    v_pad = -(-v // n_chunks) * n_chunks
    if v_pad != v:
        w = torch.cat([w, w.new_zeros(v_pad - v, e)])
    return w.reshape(n_chunks, v_pad // n_chunks, e)


def _chunk_logits(xf, wc, c, v_true):
    """float32 logits of chunk c, [N, Vc], the padded columns at -1e30."""
    vc = wc.shape[1]
    logits = xf @ wc[c].float().T
    col = c * vc + torch.arange(vc, device=xf.device)
    return torch.where(col[None, :] < v_true, logits, NEG_INF)


def _label_in_chunk(labels, c, vc):
    """(the label's column within chunk c, clamped; whether it is there)."""
    lid = labels - c * vc
    return lid.clamp(0, vc - 1), (lid >= 0) & (lid < vc)


class ChunkedSoftmaxXent(torch.autograd.Function):
    """The reference's custom-VJP `chunked_softmax_xent`: the forward
    keeps x, w, labels and the row statistics (m, s); the backward
    recomputes every chunk's logits."""

    @staticmethod
    def forward(ctx, x, w, labels, n_chunks, ignore_index):
        n = x.shape[0]
        wc = _chunks(w, n_chunks)
        vc = wc.shape[1]
        xf = x.float()
        m = torch.full((n,), NEG_INF, dtype=torch.float32, device=x.device)
        s = torch.zeros(n, dtype=torch.float32, device=x.device)
        tgt = torch.zeros(n, dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            logits = _chunk_logits(xf, wc, c, w.shape[0])
            m_new = torch.maximum(m, logits.max(-1).values)
            s = s * torch.exp(m - m_new) \
                + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            lid, ok = _label_in_chunk(labels, c, vc)
            t = logits.gather(1, lid[:, None])[:, 0]
            tgt = tgt + torch.where(ok, t, 0.0)
        valid = labels != ignore_index
        count = valid.sum().clamp(min=1)
        nll = (torch.log(s) + m - tgt) * valid
        ctx.save_for_backward(x, w, labels, m, s)
        ctx.n_chunks, ctx.ignore_index = n_chunks, ignore_index
        return nll.sum() / count

    @staticmethod
    def backward(ctx, g):
        x, w, labels, m, s = ctx.saved_tensors
        wc = _chunks(w, ctx.n_chunks)
        vc = wc.shape[1]
        xf = x.float()
        valid = labels != ctx.ignore_index
        count = valid.sum().clamp(min=1)
        # ignored rows: no weight in the mean and no softmax gradient
        row_scale = (g / count) * valid.float()
        dx = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
        dws = []
        for c in range(ctx.n_chunks):
            wcf = wc[c].float()
            logits = _chunk_logits(xf, wc, c, w.shape[0])
            p = torch.exp(logits - m[:, None]) / s[:, None]
            lid, ok = _label_in_chunk(labels, c, vc)
            onehot = torch.zeros_like(p).scatter_(1, lid[:, None],
                                                  ok.float()[:, None])
            d = (p - onehot) * row_scale[:, None]
            dx = dx + d @ wcf
            dws.append(d.T @ xf)
        dw = torch.cat(dws)[:w.shape[0]]
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def chunked_softmax_xent(x, w, labels, n_chunks, ignore_index=-100):
    """mean over valid rows i of logsumexp_v(x_i . w_v) - x_i .
    w_{labels_i}, x [N, E], w [V, E] (the tied embedding), labels [N];
    differentiable in x and w."""
    return ChunkedSoftmaxXent.apply(x, w, labels.long(), int(n_chunks),
                                    ignore_index)


__all__ = ["chunked_softmax_xent", "ChunkedSoftmaxXent"]
