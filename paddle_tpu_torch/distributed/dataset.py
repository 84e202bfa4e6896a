"""Datasets for file-fed (parameter-server style) training: the port of
`paddle_tpu/distributed/dataset.py`.

`InMemoryDataset` loads the whole file list into host memory and
shuffles there; `QueueDataset` streams the files and refuses to shuffle.
Lines are parsed on the host by a fleet `MultiSlot*DataGenerator` (its
`_gen` hook, so its checks and coercions apply) or, without one, as
whitespace-separated floats in one slot "slot_0"; a batch is a dict of
numpy arrays, one per slot, for the caller to move to its device.
"""
from __future__ import annotations

import random

import numpy as np


class DatasetBase:
    def __init__(self):
        self.batch_size = 1
        self.thread_num = 1
        self.use_vars = []
        self.pipe_command = None
        self.filelist = []
        self._generator = None

    # --- reference init/config surface ---------------------------------
    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command=None, input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        self.batch_size = int(batch_size)
        self.thread_num = int(thread_num)
        self.use_vars = list(use_var or [])
        self.pipe_command = pipe_command
        return self

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = int(thread_num)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        self.use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        self.pipe_command = pipe_command

    def set_data_generator(self, generator):
        """Parse lines with a fleet DataGenerator in this process (in
        place of the reference's pipe command)."""
        self._generator = generator

    # --- parsing -------------------------------------------------------
    def _parse_line(self, line):
        if self._generator is not None:
            # go through the generator's _gen hook so MultiSlot numeric
            # validation / string coercion apply, and both callable and
            # plain-generator generate_sample returns are accepted
            return self._generator._gen(line)
        # fallback: whitespace-separated floats, one unnamed slot
        vals = [float(t) for t in line.split()]
        return [("slot_0", vals)]

    def _iter_files(self):
        for path in self.filelist:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if line:
                        yield self._parse_line(line)

    @staticmethod
    def _batch(samples):
        slots = {}
        for sample in samples:
            for name, vals in sample:
                slots.setdefault(name, []).append(vals)
        return {k: np.asarray(v) for k, v in slots.items()}


class InMemoryDataset(DatasetBase):
    """Load the whole file list into host memory, shuffle there, then
    iterate batches."""

    def __init__(self):
        super().__init__()
        self._memory = []

    def load_into_memory(self):
        self._memory = list(self._iter_files())

    def preload_into_memory(self, thread_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def local_shuffle(self):
        random.shuffle(self._memory)

    def global_shuffle(self, fleet=None, thread_num=12):
        # one host: global == local
        self.local_shuffle()

    def release_memory(self):
        self._memory = []

    def get_memory_data_size(self, fleet=None):
        return len(self._memory)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._memory)

    def __iter__(self):
        for i in range(0, len(self._memory), self.batch_size):
            yield self._batch(self._memory[i:i + self.batch_size])


class QueueDataset(DatasetBase):
    """Files are read as the batches are taken; no shuffle."""

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams files; use InMemoryDataset for shuffle "
            "(same contract as the reference)")

    def global_shuffle(self, fleet=None, thread_num=12):
        raise NotImplementedError(
            "QueueDataset streams files; use InMemoryDataset for shuffle")

    def __iter__(self):
        buf = []
        for sample in self._iter_files():
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf:
            yield self._batch(buf)
