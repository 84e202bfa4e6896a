"""paddle.text of the port (the reference's `paddle_tpu/text/__init__.py`,
Paddle's python/paddle/text/): the dataset classes over the port's
`io.Dataset` — with a published file parsed as the reference parses it,
else the reference's synthetic fallback, drawn bitwise the same — the
`text.datasets.*` module aliases of the 1.x loaders, and
`viterbi_decode`."""
from __future__ import annotations

import numpy as np
import torch

from ..io import Dataset


class Imdb(Dataset):
    """IMDB sentiment (ref: python/paddle/text/datasets/imdb.py). With
    `data_file` it parses the PUBLISHED aclImdb_v1.tar.gz layout —
    aclImdb/<mode>/{pos,neg}/*.txt members, frequency-sorted word dict
    with `cutoff`, <unk> last — else deterministic synthetic docs."""

    def __init__(self, data_file=None, mode="train", cutoff=150):
        import os
        if data_file and os.path.exists(data_file):
            self._load_archive(data_file, mode, cutoff)
            return
        n = 2000 if mode == "train" else 400
        rng = np.random.RandomState(7)
        self.word_idx = {i: i for i in range(5000)}
        self.docs = [rng.randint(1, 5000, rng.randint(20, 200)).astype(np.int64)
                     for _ in range(n)]
        self.labels = rng.randint(0, 2, n).astype(np.int64)

    @staticmethod
    def _tokenize(text):
        import re
        import string
        return re.sub(f"[{re.escape(string.punctuation)}]", "",
                      text.lower()).split()

    def _load_archive(self, data_file, mode, cutoff):
        import re
        import tarfile
        # vocabulary spans BOTH splits (ref imdb.py:95 builds the dict over
        # aclImdb/((train)|(test))), so train/test token ids agree; docs
        # come from the requested mode only. One getmembers() pass —
        # per-name extractfile is a reverse linear scan of the archive.
        dict_pat = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        mode_pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        texts, labels = [], []
        freq = {}
        with tarfile.open(data_file, "r:*") as tf:
            for member in sorted(tf.getmembers(), key=lambda m: m.name):
                if not dict_pat.match(member.name):
                    continue
                toks = self._tokenize(tf.extractfile(member).read()
                                      .decode("utf-8", "replace"))
                for w in toks:
                    freq[w] = freq.get(w, 0) + 1
                m = mode_pat.match(member.name)
                if m:
                    texts.append(toks)
                    labels.append(0 if m.group(1) == "pos" else 1)  # pos=0
        kept = {w: c for w, c in freq.items() if c > cutoff} or freq
        ordered = sorted(kept.items(), key=lambda kv: (-kv[1], kv[0]))
        self.word_idx = {w: i for i, (w, _) in enumerate(ordered)}
        unk = self.word_idx["<unk>"] = len(self.word_idx)
        self.docs = [np.asarray([self.word_idx.get(w, unk) for w in toks],
                                np.int64) for toks in texts]
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class WMT14(Dataset):
    def __init__(self, data_file=None, mode="train", dict_size=30000):
        n = 1000 if mode == "train" else 200
        rng = np.random.RandomState(8)
        self.src = [rng.randint(1, dict_size, rng.randint(5, 50)).astype(np.int64)
                    for _ in range(n)]
        self.tgt = [rng.randint(1, dict_size, rng.randint(5, 50)).astype(np.int64)
                    for _ in range(n)]

    def __getitem__(self, idx):
        return self.src[idx], self.tgt[idx][:-1], self.tgt[idx][1:]

    def __len__(self):
        return len(self.src)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True):
    """CRF Viterbi decode: the reference's pair of `lax.scan`s as a loop of
    torch ops on the caller's device. potentials [B, T, N], transition
    [N, N]; returns (scores [B], path [B, T] int64). As the reference,
    `lengths` and `include_bos_eos_tag` are ignored, and ties go to the
    first maximum (`torch.argmax`'s rule, as `jnp.argmax`'s)."""
    pot = torch.as_tensor(potentials)
    trans = torch.as_tensor(transition_params, device=pot.device)
    alpha = pot[:, 0]
    idxs = []
    for t in range(1, pot.shape[1]):
        scores = alpha[:, :, None] + trans[None]
        idxs.append(torch.argmax(scores, dim=1))
        alpha = torch.amax(scores, dim=1) + pot[:, t]
    last = torch.argmax(alpha, dim=-1)
    path = [last]
    for idx in reversed(idxs):
        path.append(torch.gather(idx, 1, path[-1][:, None])[:, 0])
    return torch.amax(alpha, dim=-1), torch.stack(path[::-1], dim=1)


class Imikolov(Dataset):
    """PTB-style n-gram dataset (ref: python/paddle/text/datasets/imikolov.py);
    a synthetic corpus (nothing downloads)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50):
        n = 5000 if mode == "train" else 500
        rng = np.random.RandomState(11)
        vocab = 2000
        self.window_size = window_size
        corpus = rng.zipf(1.5, n + window_size) % vocab
        self.samples = [corpus[i:i + window_size].astype(np.int64)
                        for i in range(n)]

    def __getitem__(self, idx):
        s = self.samples[idx]
        return tuple(s[:-1]) + (s[-1:],)

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """MovieLens ratings (ref: python/paddle/text/datasets/movielens.py);
    synthetic (user, gender, age, job, movie, category, title, rating)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0):
        rng = np.random.RandomState(rand_seed)
        n = 4000 if mode == "train" else 400
        self.rows = [(
            rng.randint(1, 6041), rng.randint(0, 2), rng.randint(0, 7),
            rng.randint(0, 21), rng.randint(1, 3953),
            rng.randint(0, 19, 3).astype(np.int64),
            rng.randint(1, 5000, 4).astype(np.int64),
            np.float32(rng.randint(1, 6)),
        ) for _ in range(n)]

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)


class UCIHousing(Dataset):
    """Boston housing regression (ref: python/paddle/text/datasets/
    uci_housing.py). With `data_file` it parses the published
    housing.data layout (whitespace rows, 14 columns, feature-range
    normalization, 80/20 train/test split like the reference); else
    synthetic 13-feature rows."""

    def __init__(self, data_file=None, mode="train"):
        import os
        if data_file and os.path.exists(data_file):
            data = np.loadtxt(data_file).astype(np.float32)
            assert data.shape[1] == 14, data.shape
            feats = data[:, :-1]
            mn, mx = feats.min(0), feats.max(0)
            feats = (feats - feats.mean(0)) / np.maximum(mx - mn, 1e-12)
            split = int(data.shape[0] * 0.8)
            sl = slice(0, split) if mode == "train" else slice(split, None)
            self.x = feats[sl]
            self.y = data[sl, -1]
            return
        rng = np.random.RandomState(3)
        n = 404 if mode == "train" else 102
        self.x = rng.randn(n, 13).astype(np.float32)
        w = rng.randn(13).astype(np.float32)
        self.y = (self.x @ w + rng.randn(n) * 0.1).astype(np.float32)

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx:idx + 1]

    def __len__(self):
        return len(self.x)


class Conll05st(Dataset):
    """CoNLL-2005 SRL dataset (ref: python/paddle/text/datasets/conll05.py);
    synthetic (word, predicate, ctx windows, mark, label) id rows."""

    WORD_DICT_LEN = 44068
    LABEL_DICT_LEN = 59
    PRED_DICT_LEN = 3162

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="train"):
        rng = np.random.RandomState(5)
        n = 1000 if mode == "train" else 100
        self.rows = []
        for _ in range(n):
            ln = rng.randint(5, 30)
            words = rng.randint(0, self.WORD_DICT_LEN, ln).astype(np.int64)
            pred = np.full(ln, rng.randint(0, self.PRED_DICT_LEN),
                           np.int64)
            mark = (rng.rand(ln) < 0.1).astype(np.int64)
            label = rng.randint(0, self.LABEL_DICT_LEN, ln).astype(np.int64)
            ctx = [np.roll(words, s) for s in (-2, -1, 0, 1, 2)]
            self.rows.append(tuple([words] + ctx + [pred, mark, label]))

    def __getitem__(self, idx):
        return self.rows[idx]

    def __len__(self):
        return len(self.rows)


class WMT16(WMT14):
    """WMT16 en-de (ref: python/paddle/text/datasets/wmt16.py); same synthetic
    contract as WMT14 with a BPE-sized vocab."""

    def __init__(self, data_file=None, mode="train", src_dict_size=10000,
                 trg_dict_size=10000, lang="en"):
        super().__init__(data_file, mode, dict_size=src_dict_size)


import sys as _sys  # noqa: E402

datasets = _sys.modules[__name__]  # paddle.text.datasets alias

# the reference's text/datasets also binds the 1.x reader modules as
# attributes (ref: text/datasets/__init__.py import list)
from ..dataset import (  # noqa: E402,F401
    conll05, imdb, imikolov, movielens, uci_housing, wmt14, wmt16)

# register the alias and its corpus leaves as IMPORTABLE module paths so
# `import paddle.text.datasets.imdb` (the reference's layout) resolves,
# not just attribute access (r4 module-path parity)
_sys.modules[__name__ + ".datasets"] = datasets
for _n, _m in (("conll05", conll05), ("imdb", imdb),
               ("imikolov", imikolov), ("movielens", movielens),
               ("uci_housing", uci_housing), ("wmt14", wmt14),
               ("wmt16", wmt16)):
    _sys.modules[f"{__name__}.datasets.{_n}"] = _m
