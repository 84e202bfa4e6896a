"""paddle_tpu_torch.utils — the host-side utilities ported so far: the
training `watchdog` (the rest of `paddle_tpu.utils` waits for ROADMAP
§A 14)."""
from .watchdog import Watchdog  # noqa: F401
