"""The fluid-era sequence ops on dense padded tensors: the port of
`paddle_tpu/nn/functional/sequence.py`.

The reference's LoD (ragged) ops take here, as there, a dense `[B, T,
...]` tensor and an optional `seq_len [B]` vector; masking makes the
padded positions inert, and every shape is static. Each op runs on its
input's device and is differentiable through torch's autograd.
"""
from __future__ import annotations

import torch


def _t(x, like=None):
    """x as a tensor (on `like`'s device when it is converted)."""
    if torch.is_tensor(x):
        return x
    dev = like.device if like is not None else None
    return torch.as_tensor(x, device=dev)


def _trail(m, x):
    """m [B, T] broadcast against x's trailing dims."""
    return m.reshape(m.shape + (1,) * (x.dim() - 2))


def _mask(x, seq_len):
    """[B, T] validity mask from lengths (all valid if seq_len is None)."""
    b, t = x.shape[0], x.shape[1]
    if seq_len is None:
        return torch.ones(b, t, dtype=torch.bool, device=x.device)
    lens = _t(seq_len, x).to(x.device).reshape(b, 1)
    return torch.arange(t, device=x.device)[None, :] < lens


def sequence_pad(x, pad_value=0.0, maxlen=None, seq_len=None, name=None):
    """Positions at and after each row's length set to pad_value (and the
    time axis padded to maxlen). Returns (padded, lengths)."""
    m = _trail(_mask(x, seq_len), x)
    out = torch.where(m, x, torch.as_tensor(pad_value, dtype=x.dtype,
                                            device=x.device))
    if maxlen is not None and out.shape[1] < maxlen:
        pad = torch.full((out.shape[0], maxlen - out.shape[1])
                         + tuple(out.shape[2:]), pad_value, dtype=x.dtype,
                         device=x.device)
        out = torch.cat([out, pad], dim=1)
    lens = (_t(seq_len, x) if seq_len is not None
            else torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device))
    return out, lens


def sequence_unpad(x, length, name=None):
    """Positions past each row's length zeroed (the shape stays)."""
    m = _trail(_mask(x, length), x)
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _fill(dtype, low):
    if dtype.is_floating_point:
        return -float("inf") if low else float("inf")
    info = torch.iinfo(dtype)
    return info.min if low else info.max


def sequence_pool(x, pool_type="sum", seq_len=None, pad_value=0.0,
                  name=None):
    """sum / average / sqrt / max / min / first / last over time, the
    padded positions excluded."""
    m = _mask(x, seq_len)
    mf = _trail(m, x)
    pool_type = pool_type.lower()
    if pool_type in ("sum", "average", "sqrt"):
        s = torch.where(mf, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum(dim=1)
        n = m.sum(dim=1).clamp_min(1).reshape(
            (-1,) + (1,) * (x.dim() - 2)).to(x.dtype)
        if pool_type == "average":
            s = s / n
        elif pool_type == "sqrt":
            s = s / torch.sqrt(n)
        return s
    if pool_type in ("max", "min"):
        fill = torch.as_tensor(_fill(x.dtype, pool_type == "max"),
                               dtype=x.dtype, device=x.device)
        v = torch.where(mf, x, fill)
        return v.amax(dim=1) if pool_type == "max" else v.amin(dim=1)
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        if seq_len is None:
            return x[:, -1]
        idx = (_t(seq_len, x).to(x.device) - 1).clamp_min(0).long()
        idx = idx.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
            (x.shape[0], 1) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx)[:, 0]
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_first_step(x, seq_len=None):
    return sequence_pool(x, "first", seq_len)


def sequence_last_step(x, seq_len=None):
    return sequence_pool(x, "last", seq_len)


def sequence_softmax(x, seq_len=None, name=None):
    """Softmax over time in float32, the padded positions excluded (and
    zero)."""
    m = _trail(_mask(x, seq_len), x)
    s = torch.where(m, x, torch.as_tensor(-1e30, dtype=x.dtype,
                                          device=x.device))
    w = torch.softmax(s.float(), dim=1).to(x.dtype)
    return torch.where(m, w, torch.zeros((), dtype=x.dtype, device=x.device))


def _take_time(x, src):
    """x[b, src[b, t], ...] for src [B, T']."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(
        tuple(src.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def sequence_reverse(x, seq_len=None, name=None):
    """Each row's valid prefix reversed; the padding stays in place."""
    if seq_len is None:
        return torch.flip(x, dims=[1])
    b, t = x.shape[0], x.shape[1]
    lens = _t(seq_len, x).to(x.device).reshape(b, 1).long()
    pos = torch.arange(t, device=x.device)[None, :]
    return _take_time(x, torch.where(pos < lens, lens - 1 - pos, pos))


def sequence_concat(inputs, name=None):
    """Concatenation along time."""
    return torch.cat(list(inputs), dim=1)


def sequence_expand(x, y, ref_level=-1, name=None):
    """x's rows tiled to y's time length when x has one step."""
    if x.dim() == y.dim() and x.shape[1] == 1:
        reps = [1] * x.dim()
        reps[1] = y.shape[1]
        return x.repeat(reps)
    return x


def sequence_expand_as(x, y, name=None):
    return sequence_expand(x, y)


def sequence_reshape(x, new_dim, name=None):
    return x.reshape(x.shape[0], -1, new_dim)


def sequence_slice(x, offset, length, name=None):
    """Per-row slice along time (offsets and lengths differ by row); the
    output is padded with zeros to the longest length. The lengths are
    read on the host: they fix the output's shape."""
    off = _t(offset, x).to(x.device).reshape(-1).long()
    ln = _t(length).reshape(-1).cpu()
    out_t = int(ln.max())
    t = x.shape[1]
    pos = torch.arange(out_t, device=x.device)[None, :]
    g = _take_time(x, (off[:, None] + pos).clamp(0, t - 1))
    valid = _trail(pos < ln.to(x.device).long()[:, None], x)
    return torch.where(valid, g, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def sequence_enumerate(x, win_size, pad_value=0, name=None):
    """Sliding windows of ids along time: [B, T] -> [B, T, win_size]."""
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[:, None] + \
        torch.arange(win_size, device=x.device)[None, :]
    valid = idx < t
    out = x[:, idx.clamp(0, t - 1)]
    return torch.where(valid[None], out, torch.as_tensor(
        pad_value, dtype=x.dtype, device=x.device))


def sequence_scatter(x, index, updates, name=None):
    """updates added into x at per-row time indices."""
    idx = _t(index, x).to(x.device).long()
    b = x.shape[0]
    bidx = torch.arange(b, device=x.device).repeat_interleave(idx.shape[1])
    return x.index_put((bidx, idx.reshape(-1)),
                       updates.reshape((-1,) + tuple(updates.shape[2:])),
                       accumulate=True)


def sequence_conv(x, weight, bias=None, context_length=3, context_start=None,
                  padding=True, seq_len=None, name=None):
    """Context-window convolution over time: each step concatenates
    `context_length` neighbouring frames (zeros past the ends), then one
    projection [context_length·C, D]; steps past seq_len are zeros."""
    t = x.shape[1]
    start = -(context_length // 2) if context_start is None \
        else context_start
    cols = []
    for i in range(context_length):
        shift = start + i
        rolled = torch.roll(x, -shift, dims=1)
        pos = torch.arange(t, device=x.device) + shift
        valid = (pos >= 0) & (pos < t)
        cols.append(torch.where(valid[None, :, None], rolled,
                                torch.zeros((), dtype=x.dtype,
                                            device=x.device)))
    out = torch.einsum("btc,cd->btd", torch.cat(cols, dim=-1), weight)
    if bias is not None:
        out = out + bias
    m = _mask(x, seq_len)[:, :, None]
    return torch.where(m, out, torch.zeros((), dtype=out.dtype,
                                           device=out.device))


__all__ = ["sequence_pad", "sequence_unpad", "sequence_pool",
           "sequence_first_step", "sequence_last_step", "sequence_softmax",
           "sequence_reverse", "sequence_concat", "sequence_expand",
           "sequence_expand_as", "sequence_reshape", "sequence_slice",
           "sequence_enumerate", "sequence_scatter", "sequence_conv"]
