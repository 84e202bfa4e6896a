"""fluid.dataloader.batch_sampler module path (ref:
fluid/dataloader/batch_sampler.py)."""
from ...io import BatchSampler  # noqa: F401

__all__ = ["BatchSampler"]
