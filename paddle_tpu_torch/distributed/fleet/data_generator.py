"""Fleet data generators for slot-formatted recsys data: the port of
`paddle_tpu/distributed/fleet/data_generator.py`.

`DataGenerator.generate_sample(line)` is the user's: it returns a
callable (or an iterable) yielding (slot_name, values) pairs. The parsed
samples feed `distributed.dataset` batches directly (no pipe process);
`run_from_stdin` / `run_from_memory` keep the textual slot protocol for
offline file preparation.
"""
from __future__ import annotations

import sys


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 1
        self._proto_info = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    # --- user contract --------------------------------------------------
    def generate_sample(self, line):
        """Override: return a callable yielding (slot_name, values)."""
        raise NotImplementedError(
            "implement generate_sample(line) returning a generator of "
            "(name, value_list) pairs")

    def generate_batch(self, samples):
        """Optional override: post-process a batch of samples."""
        def local_iter():
            for sample in samples:
                yield sample
        return local_iter

    # --- protocol runners ----------------------------------------------
    def _gen(self, line):
        it = self.generate_sample(line)
        return list(it()) if callable(it) else list(it)

    def run_from_memory(self, lines=None, memory_data=None):
        """Parse `lines`; returns the list of samples (and writes the slot
        protocol to stdout like the reference when invoked as a script)."""
        out = []
        for line in (lines if lines is not None else (memory_data or [])):
            sample = self._gen(line)
            if sample:
                out.append(sample)
        return out

    def run_from_stdin(self):
        for line in sys.stdin:
            line = line.rstrip("\n")
            if not line:
                continue
            sample = self._gen(line)
            if sample:
                sys.stdout.write(self._to_protocol(sample))

    def _to_protocol(self, sample):
        """Textual slot protocol: '<n_slots> [<len> <v>...]...' a
        line."""
        parts = [str(len(sample))]
        for _, vals in sample:
            parts.append(str(len(vals)))
            parts.extend(str(v) for v in vals)
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Values are numbers (int ids, float dense); anything else
    raises."""

    def _gen(self, line):
        sample = super()._gen(line)
        for name, vals in sample:
            for v in vals:
                if not isinstance(v, (int, float)):
                    raise ValueError(
                        f"MultiSlotDataGenerator slot {name!r} needs "
                        f"numeric values, got {type(v)}")
        return sample


class MultiSlotStringDataGenerator(DataGenerator):
    """Values become strings (the consumer wants raw tokens)."""

    def _gen(self, line):
        sample = super()._gen(line)
        return [(name, [str(v) for v in vals]) for name, vals in sample]
