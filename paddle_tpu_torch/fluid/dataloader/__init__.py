"""fluid.dataloader package path (ref: fluid/dataloader/) — the 1.x
home of Dataset/IterableDataset/samplers, which live in the port's
`io`."""
from ...io import (  # noqa: F401
    BatchSampler, Dataset, IterableDataset, RandomSampler, Sampler,
    SequenceSampler,
)
from ...io import get_worker_info  # noqa: F401

__all__ = ["Dataset", "IterableDataset", "BatchSampler", "Sampler",
           "RandomSampler", "SequenceSampler", "get_worker_info"]
