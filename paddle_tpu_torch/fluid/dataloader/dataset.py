"""fluid.dataloader.dataset module path (ref: fluid/dataloader/dataset.py)."""
from ...io import Dataset, IterableDataset  # noqa: F401

__all__ = ["Dataset", "IterableDataset"]
