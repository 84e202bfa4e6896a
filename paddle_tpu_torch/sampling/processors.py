"""Vectorised logit processors and per-request PRNG streams: the port of
`paddle_tpu.sampling.processors`.

Every processor is a pure `([R, V] logits, per-row parameter tensors) ->
[R, V]` function. The per-row parameters come from the slot buffers
(`sampling.buffers`), so one dispatch serves a batch that mixes greedy
and arbitrarily configured sampled requests.

Randomness is counter-based per request: row r's draw at generation step
s uses `fold_in(PRNGKey(seed_r), s)` (`sampling.prng`, the reference's
threefry2x32 bit for bit). No stream advances because of another slot's
activity, so a fixed seed reproduces a request's tokens whatever the
batch composition or slot placement.

The mode flags (`sampled`, `penalties`) select the variant: the greedy
variant is a bare argmax (ties to the first maximum, as `jnp.argmax`),
with no sort and no PRNG. The sampled path is tensor arithmetic on the
logits' device with no host reads and no branch on tensor values.
"""
from __future__ import annotations

import torch

from ..ops.search import topk_impl
from . import prng

_NEG_INF = float("-inf")


def fold_in_keys(seeds, steps):
    """[R] uint32 request seeds + [R] step counters -> [R, 2] PRNG keys
    (int64 words). Counter-based: key(r, s) depends only on
    (seed_r, s)."""
    return prng.fold_in_keys(seeds, steps)


def apply_penalties(logits, counts, rep, pres, freq):
    """HF-style repetition penalty and OpenAI-style presence/frequency
    penalties, vectorised over rows. `counts` [R, V] int32 holds each
    row's token counts (prompt + generated); rep/pres/freq are [R].
    Defaults (rep 1, pres = freq = 0) are numeric identities."""
    seen = counts > 0
    rep = rep[:, None]
    out = torch.where(seen,
                      torch.where(logits > 0, logits / rep, logits * rep),
                      logits)
    cf = counts.to(torch.float32)
    return out - freq[:, None] * cf - pres[:, None] * seen.to(torch.float32)


def filter_logits(scaled, top_k, top_p, min_p):
    """The top-k / top-p / min-p filters from ONE descending sort
    (`ops.search.topk_impl` with k = V). Per row (0 / 1.0 / 0.0 disable
    a filter):
      * top_k keeps the k highest logits;
      * top_p keeps the smallest prefix of the top-k-filtered,
        renormalised distribution whose exclusive cumulative probability
        stays under top_p (the best token always survives);
      * min_p drops tokens whose probability in that distribution is
        below min_p * the largest probability.
    Ties at a threshold are kept. Returns the logits with the dropped
    entries at -inf."""
    R, V = scaled.shape
    sorted_desc, _ = topk_impl(scaled, V)                    # [R, V]
    pos = torch.arange(V, device=scaled.device)[None, :]
    k_eff = torch.where(top_k > 0, torch.clamp_max(top_k, V),
                        V).long()                            # [R]
    kth = sorted_desc.gather(-1, (k_eff - 1)[:, None])
    keep = scaled >= kth
    # the top-k-filtered distribution IS the sorted array with ranks
    # >= k masked (filtering the k largest keeps the descending order)
    sorted_f = torch.where(pos < k_eff[:, None], sorted_desc, _NEG_INF)
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs                # exclusive
    n_keep = torch.clamp_min(
        (cum < top_p[:, None]).sum(dim=-1, keepdim=True), 1)
    # top_p = 1.0 is OFF exactly (round-off in cum must not clip
    # reachable tail tokens)
    n_keep = torch.where(top_p[:, None] >= 1.0, V, n_keep)
    kth_p = sorted_f.gather(-1, n_keep - 1)
    keep &= scaled >= kth_p
    logz = torch.logsumexp(sorted_f, dim=-1, keepdim=True)
    p_tok = torch.exp(scaled - logz)                         # [R, V]
    keep &= p_tok >= min_p[:, None] * probs[:, :1]
    return torch.where(keep, scaled, _NEG_INF)


def sample_tokens(logits, sp, *, sampled, penalties):
    """The composed per-row sampling pipeline. logits [R, V] float32; sp
    is the slot-buffer dict (`sampling.buffers`); `sampled` and
    `penalties` are the mode flags. Returns [R] int32 tokens.

    Greedy rows take `argmax(logits)`: with both flags off this is the
    whole function, bitwise the greedy path."""
    if penalties:
        counts = sp["counts"]
        if "crows" in sp:  # packed prefill: gather compact plan rows
            counts = counts[sp["crows"].long()]
        logits = apply_penalties(logits, counts, sp["rep"], sp["pres"],
                                 sp["freq"])
    tok_greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampled:
        return tok_greedy
    scaled = logits / torch.clamp_min(sp["temperature"], 1e-6)[:, None]
    filt = filter_logits(scaled, sp["top_k"], sp["top_p"], sp["min_p"])
    gum = prng.gumbel(fold_in_keys(sp["seeds"], sp["steps"]),
                      filt.shape[-1])
    tok_s = torch.argmax(filt + gum, dim=-1).to(torch.int32)
    return torch.where(sp["sample"], tok_s, tok_greedy)


def update_counts(counts, rows, tok, inc):
    """Scatter-add emitted tokens into the [S, V] count buffer:
    counts[rows[r], tok[r]] += inc[r] (returns a new tensor). `inc`
    masks rows that did not really emit (idle decode slots, padding
    rows, plan rows whose prompt is still feeding)."""
    return counts.index_put((rows.long(), tok.long()), inc.to(counts.dtype),
                            accumulate=True)


def check_stops(tok, stop_matrix, active):
    """Device-side stop-token check: [R] tokens against the per-slot
    [R, W] stop-id matrix (-1-padded; generated ids are >= 0, so pad
    never matches). Returns [R] bool."""
    return active & (tok[:, None] == stop_matrix).any(dim=-1)


__all__ = ["fold_in_keys", "apply_penalties", "filter_logits",
           "sample_tokens", "update_counts", "check_stops"]
