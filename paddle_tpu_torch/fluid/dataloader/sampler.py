"""fluid.dataloader.sampler module path (ref: fluid/dataloader/sampler.py)."""
from ...io import RandomSampler, Sampler, SequenceSampler  # noqa: F401

__all__ = ["Sampler", "RandomSampler", "SequenceSampler"]
