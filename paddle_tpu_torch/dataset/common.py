"""ref: python/paddle/dataset/common.py — download/cache helpers.

Zero-egress: download() only serves files already in the cache dir (or
raises with guidance); md5file/split/cluster_files_reader keep their
reference behavior.
"""
from __future__ import annotations

import hashlib
import glob
import os
import pickle

DATA_HOME = os.path.expanduser("~/.cache/paddle/dataset")


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """Serve from the local cache only — this environment has no egress.
    Place the file at ~/.cache/paddle/dataset/<module>/<name> yourself."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(
        dirname, save_name if save_name else url.split("/")[-1])
    if os.path.exists(filename):
        return filename
    raise RuntimeError(
        f"zero-egress environment: cannot download {url}; put the file at "
        f"{filename} (the synthetic fallbacks in paddle.dataset.* need no "
        f"files at all)")


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Split a reader's samples into multiple pickle files
    (ref: common.py split)."""
    indx_f = 0
    batch = []
    out_paths = []

    def flush():
        nonlocal indx_f, batch
        if batch:
            path = suffix % indx_f
            with open(path, "wb") as f:
                dumper(batch, f)
            out_paths.append(path)
            indx_f += 1
            batch = []

    for sample in reader():
        batch.append(sample)
        if len(batch) == line_count:
            flush()
    flush()
    return out_paths


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read this trainer's shard of the split files (ref: common.py)."""

    def reader():
        flist = sorted(glob.glob(files_pattern))
        my = flist[trainer_id::trainer_count]
        for fn in my:
            with open(fn, "rb") as f:
                for sample in loader(f):
                    yield sample

    return reader
