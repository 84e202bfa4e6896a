"""User-defined data generators emitting the MultiSlot text format, copied
from the reference's `paddle_tpu/incubate/data_generator.py` (Paddle's
python/paddle/fluid/incubate/data_generator/__init__.py). A
generator's `generate_sample(line)` yields `[(slot_name, [values]), ...]`;
`_gen_str` serializes each sample as `<n> <v1> ... <vn>` per slot — the
exact bytes fluid.dataset_feed's datasets (and the reference's C++
MultiSlotDataFeed) parse. run_from_stdin/run_from_memory drive it as the
`pipe_command` of a Dataset.

Sibling API: distributed.fleet.data_generator carries the 2.x fleet
variant of the same user contract — in-process `run_from_memory(lines)`
returning parsed samples for `Dataset.set_data_generator` (no text round
trip) and a counted protocol line. This module is the 1.x stdout-pipe
protocol, byte-compatible with the reference's feed.
"""
from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 32
        self._proto_info = None
        self._line_limit = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        """Override: return a generator over samples, each
        [(slot_name, [values]), ...]."""
        raise NotImplementedError(
            "generate_sample() must be implemented by the subclass")

    def generate_batch(self, samples):
        """Override for batch-level processing; default passes samples
        through one by one."""
        def local_iter():
            for sample in samples:
                yield sample
        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def run_from_stdin(self):
        """Act as a dataset pipe_command: raw lines in, MultiSlot out."""
        batch_samples = []
        for line in sys.stdin:
            sample_gen = self.generate_sample(line)
            if sample_gen is None:
                continue
            for sample in sample_gen():
                if sample is None:
                    continue
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size_:
                    for s in self.generate_batch(batch_samples)():
                        sys.stdout.write(self._gen_str(s))
                    batch_samples = []
        if batch_samples:
            for s in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(s))

    def run_from_memory(self):
        """Generate without an input file (generate_sample(None))."""
        batch_samples = []
        sample_gen = self.generate_sample(None)
        for sample in sample_gen():
            if sample is None:
                continue
            batch_samples.append(sample)
            if len(batch_samples) == self.batch_size_:
                for s in self.generate_batch(batch_samples)():
                    sys.stdout.write(self._gen_str(s))
                batch_samples = []
        if batch_samples:
            for s in self.generate_batch(batch_samples)():
                sys.stdout.write(self._gen_str(s))


def _check_sample(line):
    if not isinstance(line, (list, tuple)):
        raise ValueError(
            "the output of generate_sample() must be a list or tuple, "
            "e.g. [('words', [1926, 8, 17]), ('label', [1])]")


class MultiSlotDataGenerator(DataGenerator):
    def _gen_str(self, line):
        _check_sample(line)
        if self._proto_info is None:
            self._proto_info = [
                (name, "float" if any(isinstance(e, float) for e in elems)
                 else "uint64") for name, elems in line]
        parts = []
        for name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    def _gen_str(self, line):
        _check_sample(line)
        parts = []
        for _name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(elements)
        return " ".join(parts) + "\n"
