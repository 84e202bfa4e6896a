"""paddle.metric of the port (the port of `paddle_tpu/metric/__init__.py`):
`Metric`, `Accuracy`, `Precision`, `Recall`, `Auc`, and the functions
`accuracy`, `chunk_eval`, `mean_iou`.

The metric classes count on the host in numpy, as the reference does
(`compute` and `update` take tensors on any device, or arrays), so
their counts equal the reference's on the same inputs. `accuracy` runs
in torch on its input's device; `chunk_eval` and `mean_iou` count on
the host and return tensors on their input's device (numpy input: the
default device).
"""
from __future__ import annotations

import sys as _sys

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _device_of(x):
    if torch.is_tensor(x):
        return x.device
    from ..device import resolve_device
    return resolve_device(None)


class Metric:
    def __init__(self, name=None):
        self._name = name or type(self).__name__.lower()

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self._name

    def compute(self, pred, label, *args):
        return pred, label


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        p, lb = _np(pred), _np(label)
        if lb.ndim == p.ndim and lb.shape[-1] == 1:
            lb = lb[..., 0]
        topk_idx = np.argsort(-p, axis=-1)[..., :self.maxk]
        return topk_idx == lb[..., None]

    def update(self, correct, *args):
        c = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = c[..., :k].sum()
            n = int(np.prod(c.shape[:-1]))
            self.total[i] += float(num)
            self.count[i] += n
            accs.append(float(num) / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res


def _binary(preds, labels):
    p = (_np(preds) > 0.5).astype(int).reshape(-1)
    lb = _np(labels).astype(int).reshape(-1)
    return p, lb


class Precision(Metric):
    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p, lb = _binary(preds, labels)
        self.tp += int(((p == 1) & (lb == 1)).sum())
        self.fp += int(((p == 1) & (lb == 0)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fp, 1)


class Recall(Metric):
    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p, lb = _binary(preds, labels)
        self.tp += int(((p == 1) & (lb == 1)).sum())
        self.fn += int(((p == 0) & (lb == 1)).sum())

    def accumulate(self):
        return self.tp / max(self.tp + self.fn, 1)


class Auc(Metric):
    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lb = _np(labels).astype(int).reshape(-1)
        idx = np.clip((p * self.num_thresholds).astype(int), 0,
                      self.num_thresholds)
        np.add.at(self._stat_pos, idx[lb == 1], 1)
        np.add.at(self._stat_neg, idx[lb == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # from the highest threshold down
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(tpr, fpr))


def accuracy(input, label, k=1):  # noqa: A002
    """Top-k accuracy of a batch, a float32 scalar tensor on `input`'s
    device."""
    p = input if torch.is_tensor(input) else torch.as_tensor(_np(input))
    lb = label if torch.is_tensor(label) else torch.as_tensor(_np(label))
    lb = lb.to(p.device)
    if lb.dim() == p.dim() and lb.shape[-1] == 1:
        lb = lb[..., 0]
    idx = torch.argsort(-p, dim=-1, stable=True)[..., :k]
    correct = (idx == lb[..., None]).any(dim=-1)
    return correct.to(torch.float32).mean()


def _chunks(tags, chunk_scheme, num_chunk_types):
    """The set of (start, end, type) chunks of one tag sequence."""
    chunks = []
    start, ctype = None, None
    for i, t in enumerate(list(tags) + [-1]):
        if chunk_scheme == "plain":
            ty = t if t >= 0 else None
            if ty is not None and (ctype is None or ty != ctype):
                if ctype is not None:
                    chunks.append((start, i - 1, ctype))
                start, ctype = i, ty
            elif ty is None and ctype is not None:
                chunks.append((start, i - 1, ctype))
                ctype = None
            continue
        n_states = {"IOB": 2, "IOE": 2, "IOBES": 4}[chunk_scheme]
        if t < 0 or t >= n_states * num_chunk_types:
            if ctype is not None:
                chunks.append((start, i - 1, ctype))
                ctype = None
            continue
        ty, pos = t // n_states, t % n_states
        begin = pos == 0 if chunk_scheme in ("IOB", "IOBES") else \
            ctype is None
        if chunk_scheme == "IOBES" and pos == 3:  # S: a single-tag chunk
            chunks.append((i, i, ty))
            ctype = None
            continue
        if begin or ctype != ty:
            if ctype is not None:
                chunks.append((start, i - 1, ctype))
            start, ctype = i, ty
        ends = (chunk_scheme == "IOE" and pos == 1) or \
            (chunk_scheme == "IOBES" and pos == 2)
        if ends and ctype is not None:
            chunks.append((start, i, ctype))
            ctype = None
    return set(chunks)


def chunk_eval(input, label, chunk_scheme, num_chunk_types,  # noqa: A002
               excluded_chunk_types=None, seq_length=None):
    """Chunk-level precision, recall and F1 of sequence labels (schemes
    IOB, IOE, IOBES, plain): (precision, recall, f1, n_infer, n_label,
    n_correct), each a one-element tensor."""
    iv, lv = _np(input), _np(label)
    if iv.ndim == 1:
        iv, lv = iv[None], lv[None]
    if seq_length is not None:
        sl = _np(seq_length).reshape(-1)
    else:
        sl = [iv.shape[1]] * iv.shape[0]
    n_infer = n_label = n_correct = 0
    for row in range(iv.shape[0]):
        pred = _chunks(iv[row, :sl[row]], chunk_scheme, num_chunk_types)
        gold = _chunks(lv[row, :sl[row]], chunk_scheme, num_chunk_types)
        if excluded_chunk_types:
            pred = {c for c in pred if c[2] not in excluded_chunk_types}
            gold = {c for c in gold if c[2] not in excluded_chunk_types}
        n_infer += len(pred)
        n_label += len(gold)
        n_correct += len(pred & gold)
    p = n_correct / n_infer if n_infer else 0.0
    r = n_correct / n_label if n_label else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0
    dev = _device_of(input)
    f = [torch.tensor([v], dtype=torch.float32, device=dev)
         for v in (p, r, f1)]
    i = [torch.tensor([v], dtype=torch.int64, device=dev)
         for v in (n_infer, n_label, n_correct)]
    return (*f, *i)


def mean_iou(input, label, num_classes):  # noqa: A002
    """Mean intersection over union across the classes present: (mean
    IoU float32 scalar, per-class wrong counts, per-class correct
    counts)."""
    pv, lv = _np(input), _np(label)
    ious, wrong, correct = [], [], []
    for c in np.arange(num_classes):
        pred_c = pv == c
        lbl_c = lv == c
        inter = np.logical_and(pred_c, lbl_c).sum()
        union = np.logical_or(pred_c, lbl_c).sum()
        if union > 0:
            ious.append(inter / union)
        correct.append(inter)
        wrong.append(np.logical_xor(pred_c, lbl_c).sum())
    miou = float(np.mean(ious)) if ious else 0.0
    dev = _device_of(input)
    return (torch.tensor(miou, dtype=torch.float32, device=dev),
            torch.tensor(np.asarray(wrong, np.int64), device=dev),
            torch.tensor(np.asarray(correct, np.int64), device=dev))


metrics = _sys.modules[__name__]

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy",
           "chunk_eval", "mean_iou"]
