"""paddle.dataset of the port — the 1.x reader-style dataset loaders,
copied from the reference's `paddle_tpu/dataset/` (Paddle's
python/paddle/dataset/: uci_housing, mnist, cifar, imdb, imikolov,
movielens, conll05, flowers, voc2012, wmt14, wmt16, image, common). Each module exposes `train()`/`test()` factories returning
zero-arg reader callables (the contract paddle.reader decorators expect).

Nothing downloads: Paddle fetches from public mirrors; here each loader first looks for a caller-provided local file (same parsing as
the port's vision.datasets where formats overlap) and otherwise generates
deterministic class-conditional synthetic data with the right shapes and
vocabularies, so reader pipelines and models are fully exercisable.
"""
from . import common  # noqa: F401
from . import uci_housing  # noqa: F401
from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import movielens  # noqa: F401
from . import conll05  # noqa: F401
from . import flowers  # noqa: F401
from . import voc2012  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
from . import image  # noqa: F401

__all__ = []  # matches the reference: no APIs shown under paddle.dataset
