"""MultiSlot dataset feeding: DataFeedDesc, DatasetFactory,
InMemoryDataset, QueueDataset.

Reference: python/paddle/fluid/{data_feed_desc.py,dataset.py} + the C++
MultiSlotDataFeed. The text format is one sample per line, slots in order,
each slot `<n> <v1> ... <vn>` (same bytes the reference's data_generator
emits), so data produced for the reference feeds this implementation
unchanged. The C++ feed/trainer pipeline is replaced by a host-side parser
that yields padded numpy batches, consumed by `Executor.train_from_dataset`
(the port of `paddle_tpu/fluid/dataset_feed.py`, over the port's
`distributed/dataset.py`).
"""
from __future__ import annotations

import random
import re
import subprocess

import numpy as np

__all__ = ["DataFeedDesc", "DatasetFactory", "DatasetBase",
           "InMemoryDataset", "QueueDataset"]


class DataFeedDesc:
    """Parse / edit the proto-text feed description (ref:
    data_feed_desc.py). Only the MultiSlot fields matter here: slot name,
    type, is_dense, is_used, and batch size."""

    def __init__(self, proto_file_or_text):
        try:
            with open(proto_file_or_text) as f:
                text = f.read()
        except (OSError, ValueError):
            text = proto_file_or_text
        self.batch_size = 32
        m = re.search(r"batch_size\s*:\s*(\d+)", text)
        if m:
            self.batch_size = int(m.group(1))
        self.slots = []
        for block in re.finditer(r"slots\s*\{([^}]*)\}", text):
            body = block.group(1)

            def field(key, default=None):
                mm = re.search(rf'{key}\s*:\s*"?([\w.]+)"?', body)
                return mm.group(1) if mm else default

            self.slots.append({
                "name": field("name"),
                "type": field("type", "uint64"),
                "is_dense": field("is_dense", "false") == "true",
                "is_used": field("is_used", "false") == "true",
            })

    def set_batch_size(self, batch_size):
        self.batch_size = batch_size

    def set_dense_slots(self, dense_slots_name):
        for s in self.slots:
            if s["name"] in dense_slots_name:
                s["is_dense"] = True

    def set_use_slots(self, use_slots_name):
        for s in self.slots:
            if s["name"] in use_slots_name:
                s["is_used"] = True

    def desc(self):
        out = [f"batch_size: {self.batch_size}"]
        for s in self.slots:
            out.append(
                "slots {\n"
                f'  name: "{s["name"]}"\n'
                f'  type: "{s["type"]}"\n'
                f'  is_dense: {str(s["is_dense"]).lower()}\n'
                f'  is_used: {str(s["is_used"]).lower()}\n'
                "}")
        return "\n".join(out) + "\n"


from ..distributed.dataset import DatasetBase as _DistDatasetBase


class DatasetBase(_DistDatasetBase):
    """1.x text-contract dataset base: shares the config surface (init,
    set_batch_size/thread/filelist/use_var/pipe_command,
    set_data_generator) with distributed.dataset, and replaces the parse
    path with the MultiSlot TEXT format + use_var-typed padded batching
    the reference's C++ MultiSlotDataFeed implements."""

    def __init__(self):
        super().__init__()
        self.pipe_command = "cat"
        self.fea_eval = False

    def set_hdfs_config(self, fs_name, fs_ugi):
        pass  # no remote FS on this stack; files are local paths

    def set_fea_eval(self, record_candidate_size, fea_eval=True):
        self.fea_eval = fea_eval

    def desc(self):
        names = [getattr(v, "name", str(v)) for v in self.use_vars]
        return (f"batch_size: {self.batch_size}\n"
                + "".join(f'slots {{ name: "{n}" }}\n' for n in names))

    # -- parsing --
    def _slot_meta(self):
        meta = []
        for v in self.use_vars:
            name = getattr(v, "name", str(v))
            dt = str(getattr(v, "dtype", "int64")).replace("paddle.", "")
            is_float = "float" in dt
            # trailing static dim of the target var bounds the pad width
            shape = tuple(getattr(v, "shape", ()) or ())
            fixed = int(shape[-1]) if shape and isinstance(
                shape[-1], int) and shape[-1] > 0 else None
            meta.append((name, np.float32 if is_float else np.int64, fixed))
        return meta

    def _iter_lines(self):
        for path in self.filelist:
            if self.pipe_command and self.pipe_command != "cat":
                # preprocessing pipe, same contract as the reference's
                # pipe_command (a filter from raw file bytes to MultiSlot
                # lines on stdout)
                with open(path, "rb") as f:
                    proc = subprocess.run(
                        self.pipe_command, shell=True, stdin=f,
                        capture_output=True, check=True)
                for line in proc.stdout.decode().splitlines():
                    if line.strip():
                        yield line.rstrip("\n")
            else:
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            # strip the newline BEFORE any parse: string
                            # slots via an attached generator must see the
                            # same bytes distributed.dataset delivers
                            yield line.rstrip("\n")

    def _parse_line(self, line, meta=None):
        if self._generator is not None:
            # attached-generator shortcut inherited from the shared base:
            # the generator parses RAW lines (no MultiSlot text round
            # trip), exactly like distributed.dataset
            return super()._parse_line(line)
        toks = line.split()
        if meta is None:
            meta = self._slot_meta()
        out, i = [], 0
        for name, dtype, _fixed in meta:
            if i >= len(toks):
                raise ValueError(
                    f"line ran out of tokens at slot '{name}': {line!r}")
            n = int(toks[i])
            vals = [dtype(t) for t in toks[i + 1: i + 1 + n]]
            i += 1 + n
            out.append(np.asarray(vals, dtype=dtype))
        return out

    @staticmethod
    def _batch_padded(samples):
        """Generator-parsed samples ([(name, values), ...]) collated with
        ragged slots right-padded — the fluid MultiSlot batching
        contract (the distributed base's _batch assumes equal lengths)."""
        slots = {}
        for sample in samples:
            for name, vals in sample:
                slots.setdefault(name, []).append(vals)
        batch = {}
        for name, rows in slots.items():
            width = max(len(r) for r in rows)
            dtypes = [np.asarray(r).dtype for r in rows]
            if any(d.kind in ("U", "S") for d in dtypes):
                arr = np.full((len(rows), width), "", dtype=object)
            else:
                # promote across rows: [1,2] then [0.5] must not truncate
                arr = np.zeros((len(rows), width),
                               dtype=np.result_type(*dtypes))
            for i, r in enumerate(rows):
                arr[i, : len(r)] = r
            batch[name] = arr if arr.dtype != object \
                else arr.astype(str)
        return batch

    def _batches(self, samples):
        if self._generator is not None:
            buf = []
            for s in samples:
                buf.append(s)
                if len(buf) == self.batch_size:
                    yield self._batch_padded(buf)
                    buf = []
            if buf:
                yield self._batch_padded(buf)
            return
        meta = self._slot_meta()
        buf = []
        for s in samples:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._collate(buf, meta)
                buf = []
        if buf:
            yield self._collate(buf, meta)

    @staticmethod
    def _collate(buf, meta):
        batch = {}
        for j, (name, dtype, fixed) in enumerate(meta):
            width = fixed or max(len(s[j]) for s in buf)
            arr = np.zeros((len(buf), width), dtype=dtype)
            for bi, s in enumerate(buf):
                v = s[j][:width]
                arr[bi, : len(v)] = v
            batch[name] = arr
        return batch


class QueueDataset(DatasetBase):
    """Streaming: parse lazily, single pass, no shuffle (ref: dataset.py
    QueueDataset)."""

    def __iter__(self):
        meta = self._slot_meta()  # once, not per line
        return self._batches(
            self._parse_line(ln, meta) for ln in self._iter_lines())

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for shuffle")

    def global_shuffle(self, fleet=None, thread_num=None):
        raise NotImplementedError(
            "QueueDataset streams; use InMemoryDataset for shuffle")


class InMemoryDataset(DatasetBase):
    """Load-then-iterate with shuffle (ref: dataset.py InMemoryDataset).

    Text loads go through the native C++ MultiSlot parser when available
    (csrc/native_runtime.cpp ms_scan/ms_fill — the reference parses this
    format in C++ too): the whole filelist lands in padded [N, W] slot
    arrays, shuffle permutes one index vector, and batches are row
    slices. Falls back to the per-line Python parser (which also serves
    attached-generator and pipe_command datasets)."""

    def __init__(self):
        super().__init__()
        self._samples = None
        self._native = None   # {name: [N, W] array} fast path
        self._order = None

    def load_into_memory(self):
        self._native = None
        if self._generator is None and self._load_native():
            return
        meta = self._slot_meta()  # once, not per line
        self._samples = [self._parse_line(ln, meta)
                         for ln in self._iter_lines()]

    def _load_native(self):
        if self.pipe_command not in (None, "cat") or not self.use_vars:
            return False
        meta = self._slot_meta()
        if any(fixed is None for _, _, fixed in meta):
            # variable-width slots pad per BATCH on the Python path; the
            # native bulk parse pads globally — keep one shape contract
            # by restricting the fast path to fully-fixed slot widths
            return False
        try:
            from ..io.native_loader import parse_multislot
            buf = bytearray()
            for path in self.filelist:
                with open(path, "rb") as f:
                    buf += f.read()
                buf += b"\n"
            self._native = parse_multislot(buf, meta)
        except Exception:
            return False  # no compiler / malformed: the Python parser
            # runs next and raises with a per-line diagnostic if truly bad
        n = next(iter(self._native.values())).shape[0] \
            if self._native else 0
        self._order = np.arange(n)
        self._samples = True  # loaded marker for the shared guards
        return True

    def preload_into_memory(self, thread_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self):
        if self._samples is None:
            raise RuntimeError("call load_into_memory() first")
        # ONE rng for both paths: shuffle order must not depend on
        # whether the native parser compiled
        perm = np.random.permutation(self.get_memory_data_size())
        if self._native is not None:
            self._order = self._order[perm]
        else:
            self._samples = [self._samples[i] for i in perm]

    def global_shuffle(self, fleet=None, thread_num=None):
        # single-trainer semantics: global == local (multi-trainer sparse
        # PS training shuffles via distributed/ps sharding instead)
        self.local_shuffle()

    def release_memory(self):
        self._samples = None
        self._native = None
        self._order = None

    def get_memory_data_size(self, fleet=None):
        if self._native is not None:
            return int(len(self._order))
        return len(self._samples or [])

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    def __iter__(self):
        if self._samples is None:
            raise RuntimeError("call load_into_memory() first")
        if self._native is not None:
            def gen():
                n = len(self._order)
                for i in range(0, n, self.batch_size):
                    idx = self._order[i: i + self.batch_size]
                    yield {name: arr[idx]
                           for name, arr in self._native.items()}
            return gen()
        return self._batches(iter(self._samples))


class DatasetFactory:
    """ref: dataset.py DatasetFactory.create_dataset("InMemoryDataset")."""

    def create_dataset(self, datafeed_class="QueueDataset"):
        try:
            cls = {"InMemoryDataset": InMemoryDataset,
                   "QueueDataset": QueueDataset}[datafeed_class]
        except KeyError:
            raise ValueError(
                f"unknown dataset type {datafeed_class!r}; expected "
                "'InMemoryDataset' or 'QueueDataset'") from None
        return cls()
