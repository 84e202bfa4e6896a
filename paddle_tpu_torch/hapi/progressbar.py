"""paddle.hapi.progressbar: a terminal progress bar."""
import sys
import time


class ProgressBar:
    """A minimal terminal progress bar: update(current_num,
    values=[(name, val), ...]) redraws its line on `file`."""

    def __init__(self, num=None, width=30, verbose=1, start=True,
                 file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self._file = file
        self._start = time.time() if start else None

    def start(self):
        self._start = time.time()

    def update(self, current_num, values=None):
        if self._verbose == 0:
            return
        metrics = " - ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                             else f"{k}: {v}" for k, v in (values or []))
        if self._num:
            frac = min(current_num / self._num, 1.0)
            filled = int(frac * self._width)
            bar = "=" * filled + ">" * (filled < self._width) + \
                "." * (self._width - filled - 1)
            line = f"\r{current_num}/{self._num} [{bar}] {metrics}"
        else:
            line = f"\rstep {current_num} {metrics}"
        self._file.write(line)  # cli-print: the progress bar
        if self._num and current_num >= self._num:
            self._file.write("\n")  # cli-print
        self._file.flush()


__all__ = ["ProgressBar"]
