"""BERT / ERNIE — the encoder-only pretraining model of
`paddle_tpu/models/bert.py`, built from the port's layer twins.

`Bert` holds the reference's modules under the reference's attribute
names, so `named_parameters()` spells exactly the reference's
`functional_state()` keys (`embeddings.word_embeddings.weight`,
`encoder.layers.{i}.self_attn.q_proj.weight`, ..., `mlm_bias`,
`nsp.weight`; every projection `[in, out]`), and
`from_reference_params` is a name-for-name copy of the reference's numpy
weights. What the reference fixes and the port keeps:

  * post-LN encoder layers with the exact (erf) GELU; the encoder norms
    use LayerNorm's default eps 1e-5, the embedding and MLM norms the
    config's `layer_norm_epsilon` (1e-12);
  * every encoder layer starts with the SAME weights: the encoder
    deep-copies its first layer (the reference's `_clone_layer`);
  * `forward(input_ids, token_type_ids, attention_mask, position_ids)`
    turns a [B, S] 1/0 `attention_mask` into the additive
    `(1 - m) * -1e30` mask [B, 1, 1, S], which attention takes as a
    per-key bias: the flash kernels K4 bias / K9 bias on the card;
  * `mlm_logits` is one rank-2 product over [B*S, E] against the word
    embeddings, plus `mlm_bias`; `pretraining_loss` is the MLM
    cross-entropy (labels -100 ignored) plus, given NSP labels, the NSP
    cross-entropy.

`build_train_step(cfg)` is the reference's functional step (MLM loss, no
mask, no NSP): it returns (loss_fn(params, batch, generator=None),
init_params(), the model), where loss_fn binds any {name: tensor} dict
through `torch.func.functional_call` (`pretraining_loss_with`) — e.g.
bf16 copies of float32 masters for a mixed-precision step. Dropout
draws from an explicit `torch.Generator`.

`Bert(cfg, seed=0, dtype=torch.float32, device=None)` initialises from a
seeded CPU generator (embeddings normal(0, 0.02), projections
Xavier-uniform, biases zero, norms (1, 0)) and moves to `device`: CUDA
unless the caller passes device="cpu".
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import device_guard, resolve_device
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import (TransformerEncoder,
                                    TransformerEncoderLayer,
                                    set_dropout_generator)
from ..ops.loss import cross_entropy


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12

    @classmethod
    def base(cls):
        return cls()

    @classmethod
    def large(cls):
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096)

    @classmethod
    def tiny(cls):
        return cls(vocab_size=1024, hidden_size=128, num_layers=2,
                   num_heads=4, intermediate_size=512, max_position=128)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, init_generator=None):
        super().__init__()
        E, g = cfg.hidden_size, init_generator
        self.word_embeddings = Embedding(cfg.vocab_size, E, std=0.02,
                                         init_generator=g)
        self.position_embeddings = Embedding(cfg.max_position, E, std=0.02,
                                             init_generator=g)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size, E,
                                               std=0.02, init_generator=g)
        self.layer_norm = LayerNorm(E, epsilon=cfg.layer_norm_epsilon)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(x))


class Bert(nn.Module):
    def __init__(self, cfg: BertConfig = None, *, seed=0,
                 dtype=torch.float32, device=None):
        super().__init__()
        cfg = cfg or BertConfig()
        self.cfg = cfg
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(int(seed))
        E = cfg.hidden_size
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        with device_guard("cpu"):  # built on the CPU, then moved
            self.embeddings = BertEmbeddings(cfg, init_generator=g)
            enc_layer = TransformerEncoderLayer(
                E, cfg.num_heads, cfg.intermediate_size,
                dropout=cfg.dropout, activation="gelu", init_generator=g)
            self.encoder = TransformerEncoder(enc_layer, cfg.num_layers)
            self.pooler = Linear(E, E, init_generator=g)
            self.mlm_transform = Linear(E, E, init_generator=g)
            self.mlm_norm = LayerNorm(E, epsilon=cfg.layer_norm_epsilon)
            self.nsp = Linear(E, 2, init_generator=g)
        self.to(device=dev, dtype=dtype)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        """(seq [B, S, E], pooled [B, E])."""
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        mask = None
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            m = attention_mask.float()[:, None, None, :]
            mask = (1.0 - m) * -1e30
        seq = self.encoder(x, mask)
        pooled = torch.tanh(self.pooler(seq[:, 0]))
        return seq, pooled

    def mlm_logits(self, seq):
        """[..., V] logits, the vocab product as one rank-2 GEMM over
        [B*S, E] (the reference's layout choice)."""
        E, V = self.cfg.hidden_size, self.cfg.vocab_size
        h2 = F.gelu(self.mlm_transform(seq.reshape(-1, E)))
        h2 = self.mlm_norm(h2)
        logits2 = torch.addmm(self.mlm_bias, h2,
                              self.embeddings.word_embeddings.weight.T)
        return logits2.reshape(*seq.shape[:-1], V)

    def pretraining_loss(self, input_ids, labels, next_sentence_label=None,
                         token_type_ids=None, attention_mask=None):
        """MLM (+ optional NSP) loss; labels use -100 for unmasked
        tokens."""
        seq, pooled = self(input_ids, token_type_ids, attention_mask)
        V = self.cfg.vocab_size
        mlm = cross_entropy(self.mlm_logits(seq).reshape(-1, V),
                            labels.reshape(-1), ignore_index=-100)
        if next_sentence_label is not None:
            nsp = cross_entropy(self.nsp(pooled),
                                next_sentence_label.reshape(-1))
            return mlm + nsp
        return mlm


@dataclass
class ErnieConfig(BertConfig):
    @classmethod
    def large(cls):
        return cls(vocab_size=18000, hidden_size=1024, num_layers=24,
                   num_heads=16, intermediate_size=4096)


class Ernie(Bert):
    """ERNIE: BERT's architecture (its entity-level masking is data-side,
    `create_mlm_batch(mode="span")`)."""

    def __init__(self, cfg: ErnieConfig = None, **kw):
        super().__init__(cfg or ErnieConfig(), **kw)


class _PretrainingLoss(nn.Module):
    """`model.pretraining_loss` as a forward, so `functional_call` can
    bind parameters to it."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.pretraining_loss(*args, **kwargs)


def pretraining_loss_with(model, params, *args, **kwargs):
    """`model.pretraining_loss(*args, **kwargs)` computed with `params`
    ({name: tensor}, the names of `model.named_parameters()`) in place of
    the model's own parameters, through `torch.func.functional_call`."""
    return torch.func.functional_call(
        _PretrainingLoss(model), {f"model.{n}": p for n, p in params.items()},
        args, kwargs)


def create_mlm_batch(ids, vocab_size, mask_token, mask_prob=0.15,
                     mode="token", span_max=3, seed=None, pad_id=0):
    """Host-side MLM masking, a numpy copy of the reference's (same
    `np.random.RandomState(seed)` draws, so the same arrays): per row,
    max(1, int(valid * mask_prob)) positions among the non-pad tokens
    (`mode="span"`: contiguous spans, ERNIE's entity masking), of which
    80% become `mask_token`, 10% a random id and 10% stay. Returns
    (masked_ids, labels) with labels == -100 where unmasked."""
    rng = np.random.RandomState(seed)
    ids = np.asarray(ids)
    masked = ids.copy()
    labels = np.full_like(ids, -100)
    b, s = ids.shape
    for i in range(b):
        valid = np.flatnonzero(ids[i] != pad_id)
        n_mask = max(1, int(len(valid) * mask_prob))
        if mode == "span":
            chosen = []
            while len(chosen) < n_mask and len(valid):
                start = rng.choice(valid)
                span = rng.randint(1, span_max + 1)
                chosen.extend(range(start, min(start + span, s)))
            chosen = np.unique(np.asarray(chosen[:n_mask], dtype=np.int64))
        else:
            chosen = rng.choice(valid, size=min(n_mask, len(valid)),
                                replace=False)
        labels[i, chosen] = ids[i, chosen]
        roll = rng.rand(len(chosen))
        for j, pos in enumerate(chosen):
            if roll[j] < 0.8:
                masked[i, pos] = mask_token
            elif roll[j] < 0.9:
                masked[i, pos] = rng.randint(0, vocab_size)
    return masked, labels


def param_shapes(cfg):
    """{name: shape} of a `Bert(cfg)` — the reference's
    `functional_state()` keys, projections `[in, out]`."""
    E, Fd, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    shapes = {"mlm_bias": (V,),
              "embeddings.word_embeddings.weight": (V, E),
              "embeddings.position_embeddings.weight": (cfg.max_position, E),
              "embeddings.token_type_embeddings.weight":
                  (cfg.type_vocab_size, E),
              "embeddings.layer_norm.weight": (E,),
              "embeddings.layer_norm.bias": (E,)}
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[p + f"self_attn.{proj}.weight"] = (E, E)
            shapes[p + f"self_attn.{proj}.bias"] = (E,)
        shapes.update({p + "linear1.weight": (E, Fd),
                       p + "linear1.bias": (Fd,),
                       p + "linear2.weight": (Fd, E),
                       p + "linear2.bias": (E,)})
        for norm in ("norm1", "norm2"):
            shapes[p + f"{norm}.weight"] = (E,)
            shapes[p + f"{norm}.bias"] = (E,)
    for lin, out in (("pooler", E), ("mlm_transform", E), ("nsp", 2)):
        shapes[f"{lin}.weight"] = (E, out)
        shapes[f"{lin}.bias"] = (out,)
    shapes["mlm_norm.weight"] = (E,)
    shapes["mlm_norm.bias"] = (E,)
    return shapes


def from_reference_params(cfg, params_np, device=None):
    """The weight bridge: a `Bert(cfg)` holding exactly the reference's
    params (`functional_state()` converted to numpy), name for name and
    in the same layouts. Rejects any missing, unexpected or misshaped
    entry; every tensor is float32."""
    shapes = param_shapes(cfg)
    missing = sorted(set(shapes) - set(params_np))
    extra = sorted(set(params_np) - set(shapes))
    if missing or extra:
        raise ValueError(f"reference params do not match the config: "
                         f"missing {missing[:4]}, unexpected {extra[:4]}")
    model = Bert(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            a = np.asarray(params_np[name], dtype=np.float32)
            if tuple(a.shape) != tuple(shapes[name]):
                raise ValueError(f"{name}: shape {a.shape}, expected "
                                 f"{shapes[name]}")
            p.copy_(torch.from_numpy(a.copy()))
    return model


def build_train_step(cfg: BertConfig, dtype=torch.float32, device=None):
    """The reference's functional BERT step: returns (loss_fn(params,
    batch, generator=None), init_params(), model).

    `init_params()` gives a fresh {name: leaf tensor requiring grad} of
    `model = Bert(cfg, dtype=dtype, device=device)` (seed 0; CUDA unless
    device="cpu"; every encoder layer starts with the same weights, as
    the reference's). `loss_fn` runs the training-mode MLM loss of
    batch {"input_ids": [B, S], "labels": [B, S]} — no attention mask and
    no NSP term, as the reference's — with any such dict bound through
    `torch.func.functional_call`, dropout `cfg.dropout` drawing from
    `generator`. Mixed precision is the caller's: pass bf16 copies of
    float32 masters and cast the loss to float32."""
    model = Bert(cfg, dtype=dtype, device=device)
    model.train()

    def init_params():
        return {n: p.detach().clone().requires_grad_(True)
                for n, p in model.named_parameters()}

    def loss_fn(params, batch, generator=None):
        set_dropout_generator(model, generator)
        return pretraining_loss_with(model, params, batch["input_ids"],
                                     batch["labels"])

    return loss_fn, init_params, model


__all__ = ["BertConfig", "BertEmbeddings", "Bert", "ErnieConfig", "Ernie",
           "create_mlm_batch", "build_train_step", "pretraining_loss_with",
           "param_shapes", "from_reference_params"]
