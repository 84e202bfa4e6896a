"""Vision datasets (ref: python/paddle/vision/datasets/): the port of
`paddle_tpu/vision/datasets/__init__.py`.

Nothing is downloaded: given local files (`image_path` / `data_file`,
...) a dataset reads them in the published formats (IDX for (Fashion)
MNIST, the python tar.gz or a single pickle for CIFAR, 102flowers.tgz
with its .mat files); without them it makes the reference's synthetic
data, bit for bit (the same numpy seeds and draws, class prototypes
shared between the train and test splits). The API (mode, transform,
__getitem__) is the reference's; items are numpy arrays.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct

import numpy as np

from ...io import Dataset


class MNIST(Dataset):
    """IDX-format reader (ref: python/paddle/vision/datasets/mnist.py —
    the same >IIII magic/count/rows/cols header + raw uint8 parse)."""

    _SYN_SEEDS = (0, 1)  # (train, test) synthetic-fallback seeds

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), np.uint8).reshape(
                    n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                f.read(8)
                self.labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
        else:
            # synthetic fallback: class-conditional patterns so models can
            # actually fit. The class PROTOTYPES are shared between train
            # and test (only labels/noise differ per mode) — otherwise the
            # test split is a different task and eval accuracy is chance
            n = 6000 if mode == "train" else 1000
            seeds = type(self)._SYN_SEEDS
            # prototypes use their own stream, independent of the
            # per-mode label/noise draws (fixed arithmetic combine: tuple
            # hash() is interpreter-dependent)
            base = np.random.RandomState(
                ((seeds[0] << 16) ^ seeds[1] ^ 0x5EED) % (1 << 31)).rand(
                10, 28, 28) * 255
            rng = np.random.RandomState(
                seeds[0] if mode == "train" else seeds[1])
            self.labels = rng.randint(0, 10, n).astype(np.int64)
            noise = rng.rand(n, 28, 28) * 64
            self.images = np.clip(base[self.labels] * 0.75 + noise, 0,
                                  255).astype(np.uint8)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = np.array([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img[None].astype(np.float32) / 255.0
        return img, label

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    """Fashion-MNIST (ref: python/paddle/vision/datasets — same IDX wire
    format as MNIST, different archive contents). Reads real
    train/t10k-images-idx3-ubyte.gz pairs via the shared IDX parser; the
    synthetic fallback draws from its own seeds so MNIST and FashionMNIST
    produce distinct data in tests."""

    _SYN_SEEDS = (40, 41)


class Cifar10(Dataset):
    """CIFAR-10 from the published cifar-10-python.tar.gz layout (ref:
    python/paddle/vision/datasets/cifar.py:140): walk the archive members,
    unpickle every data_batch_* (train) or test_batch (test), and
    concatenate. A bare single-batch pickle file still loads (legacy)."""

    NUM_CLASSES = 10
    _TRAIN_FLAG = "data_batch"
    _TEST_FLAG = "test_batch"
    _LABEL_KEYS = (b"labels", b"fine_labels")
    _SYN_SEEDS = (2, 3)

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.num_classes = type(self).NUM_CLASSES
        if data_file and os.path.exists(data_file):
            self._load_file(data_file, mode)
        else:
            # shared class prototypes across modes (see MNIST note)
            n = 5000 if mode == "train" else 1000
            seeds = type(self)._SYN_SEEDS
            base = np.random.RandomState(
                ((seeds[0] << 16) ^ seeds[1] ^ 0x5EED) % (1 << 31)).rand(
                self.num_classes, 3, 32, 32) * 255
            rng = np.random.RandomState(
                seeds[0] if mode == "train" else seeds[1])
            self.labels = rng.randint(0, self.num_classes, n).astype(np.int64)
            noise = rng.rand(n, 3, 32, 32) * 64
            self.images = np.clip(base[self.labels] * 0.75 + noise, 0,
                                  255).astype(np.uint8)

    def _pick_labels(self, d):
        for k in type(self)._LABEL_KEYS:
            if k in d:
                return d[k]
        raise KeyError(f"no label key in batch (have {list(d)})")

    def _load_file(self, data_file, mode):
        import tarfile
        flag = type(self)._TRAIN_FLAG if mode == "train" \
            else type(self)._TEST_FLAG
        if tarfile.is_tarfile(data_file):
            imgs, labels = [], []
            with tarfile.open(data_file, mode="r:*") as tf:
                names = sorted(n for n in tf.getnames()
                               if flag in os.path.basename(n))
                if not names:
                    raise ValueError(
                        f"no '{flag}' members in {data_file} for "
                        f"mode={mode!r}")
                for name in names:
                    d = pickle.load(tf.extractfile(name), encoding="bytes")
                    imgs.append(np.asarray(d[b"data"], np.uint8)
                                .reshape(-1, 3, 32, 32))
                    labels.append(np.asarray(self._pick_labels(d), np.int64))
            self.images = np.concatenate(imgs, axis=0)
            self.labels = np.concatenate(labels, axis=0)
        else:  # legacy single-batch pickle
            with open(data_file, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            self.images = np.asarray(d[b"data"], np.uint8) \
                .reshape(-1, 3, 32, 32)
            self.labels = np.asarray(self._pick_labels(d), np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = np.array([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(np.transpose(img, (1, 2, 0)))
        else:
            img = img.astype(np.float32) / 255.0
        return img, label

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    """CIFAR-100: cifar-100-python.tar.gz holds single 'train'/'test'
    members with b'fine_labels' (ref: cifar.py CIFAR100 flags)."""

    NUM_CLASSES = 100
    _TRAIN_FLAG = "train"
    _TEST_FLAG = "test"
    _LABEL_KEYS = (b"fine_labels", b"labels")
    _SYN_SEEDS = (4, 5)


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        self.samples = []
        for dirpath, _, files in os.walk(root):
            for fn in sorted(files):
                if fn.lower().endswith(tuple(extensions)):
                    self.samples.append(os.path.join(dirpath, fn))

    def __getitem__(self, idx):
        path = self.samples[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            img = _load_image(path)
        if self.transform is not None:
            img = self.transform(img)
        return (img,)

    def __len__(self):
        return len(self.samples)


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".png", ".jpg", ".jpeg", ".bmp", ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(tuple(extensions)):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = np.load(path) if path.endswith(".npy") else _load_image(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.samples)


def _load_image(path):
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        raise RuntimeError(f"cannot decode {path}: PIL unavailable; "
                           "use .npy files")


class Flowers(Dataset):
    """Oxford 102 Flowers in the PUBLISHED layout (ref:
    python/paddle/vision/datasets/flowers.py): 102flowers.tgz holding
    jpg/image_%05d.jpg, imagelabels.mat (1-based class per image) and
    setid.mat (trnid/valid/tstid index splits), parsed with scipy.io +
    PIL; jpgs decode lazily per access like the reference's tarfile walk.
    Synthetic fallback when no files are given (zero-egress)."""

    # the reference DELIBERATELY swaps the archive's split names — tstid is
    # the big (6149-image) set and serves as train
    # (ref: vision/datasets/flowers.py:40 MODE_FLAG_MAP)
    MODE_FLAG = {"train": "tstid", "valid": "valid", "test": "trnid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        self.transform = transform
        self._data_file = None
        self._tar = None
        self._members = None
        if data_file or label_file or setid_file:
            missing = [p for p in (data_file, label_file, setid_file)
                       if not (p and os.path.exists(p))]
            if missing:
                raise ValueError(
                    f"Flowers needs data_file+label_file+setid_file; "
                    f"missing/unreadable: {missing} (omit ALL three for "
                    f"the synthetic fallback)")
            import scipy.io
            labels = scipy.io.loadmat(label_file)["labels"][0]
            setid = scipy.io.loadmat(setid_file)
            self.indexes = np.asarray(
                setid[self.MODE_FLAG[mode]][0], np.int64)
            # labels are 1-based per image id; keep 1-based like the ref
            self.labels = np.asarray(labels, np.int64)
            self._data_file = data_file
            self.images = None
        else:
            n = 600 if mode == "train" else 100
            rng = np.random.RandomState(4)
            self.indexes = np.arange(1, n + 1)
            self.labels = rng.randint(1, 103, n + 1).astype(np.int64)
            self.images = (rng.rand(n, 3, 64, 64) * 255).astype(np.uint8)

    def _ensure_tar(self):
        # opened lazily PER PROCESS: an open TarFile neither pickles (the
        # multiprocess DataLoader ships the dataset to workers) nor should
        # hold an fd for the dataset's whole life
        if self._tar is None:
            import tarfile
            self._tar = tarfile.open(self._data_file, "r:*")
            self._members = {os.path.basename(m.name): m
                             for m in self._tar.getmembers()
                             if m.name.endswith(".jpg")}

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_tar"] = None
        d["_members"] = None
        return d

    def _decode(self, image_id):
        from PIL import Image
        self._ensure_tar()
        f = self._tar.extractfile(self._members["image_%05d.jpg" % image_id])
        img = np.asarray(Image.open(f).convert("RGB"))
        return np.transpose(img, (2, 0, 1))  # CHW like the synthetic path

    def __getitem__(self, idx):
        image_id = int(self.indexes[idx])
        if self._data_file is not None:
            img = self._decode(image_id)
            label = int(self.labels[image_id - 1])  # 1-based image ids
        else:
            img = self.images[idx]
            label = int(self.labels[image_id])
        if self.transform is not None:
            img = self.transform(np.transpose(img, (1, 2, 0)))
        else:
            img = img.astype(np.float32) / 255.0
        return img, np.array([label], np.int64)

    def __len__(self):
        return len(self.indexes)


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation (ref: python/paddle/vision/datasets/
    voc2012.py); synthetic image/mask pairs in the zero-egress environment."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 backend=None):
        rng = np.random.RandomState(21)
        n = 200 if mode == "train" else 40
        self.images = rng.randint(0, 256, (n, 3, 32, 32)).astype(np.uint8)
        self.masks = rng.randint(0, 21, (n, 32, 32)).astype(np.int64)
        self.transform = transform

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.masks[idx]

    def __len__(self):
        return len(self.images)


import sys as _sys  # noqa: E402

_self = _sys.modules[__name__]
cifar = _self
flowers = _self
folder = _self
mnist = _self
voc2012 = _self
