"""hapi callbacks (the port of `paddle_tpu/hapi/callbacks.py`):
`Callback`, `CallbackList`, `ProgBarLogger`, `ModelCheckpoint`,
`EarlyStopping`, `LRScheduler`, `ReduceLROnPlateau`, `TelemetryCallback`
(into the port's `observability.metrics` and `tracing`) and `VisualDL`
(scalars as JSON lines)."""
from __future__ import annotations

import time

import numpy as np

from ..observability import log as _log
from ..observability import metrics as _metrics
from ..observability import tracing as _tracing

_logger = _log.get_logger(__name__)


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_begin(self, mode, logs=None):
        pass

    def on_end(self, mode, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, mode, step, logs=None):
        pass

    def on_batch_end(self, mode, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)
            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = 0
        self._t0 = time.time()

    def on_batch_end(self, mode, step, logs=None):
        self.steps += 1
        if self.verbose >= 2 and step % self.log_freq == 0:
            loss = logs[0] if isinstance(logs, (list, tuple)) else logs
            if isinstance(loss, tuple):
                loss = loss[0]
            _logger.info("[%s] epoch %s step %s: loss=%s", mode,
                         getattr(self, "epoch", 0), step, loss)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            _logger.info("Epoch %s done in %.1fs: %s", epoch, dt, logs)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.mode = "min" if mode in ("auto", "min") else "max"

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple)):
            cur = cur[0]
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best - self.min_delta)
                  or (self.mode == "max" and cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_batch_end(self, mode, step, logs=None):
        if mode == "train" and self.by_step:
            self._step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            self._step()

    def _step(self):
        opt = getattr(self.model, "_optimizer", None)
        if opt is not None and hasattr(opt._lr, "step"):
            opt._lr.step()


class ReduceLROnPlateau(Callback):
    """Reduce the learning rate when a monitored metric plateaus."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best = None
        self._wait = 0
        self._cool = 0

    def on_epoch_end(self, epoch, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if hasattr(cur, "__len__") else cur)
        better = (self._best is None
                  or (self.mode == "max" and cur > self._best + self.min_delta)
                  or (self.mode != "max" and cur < self._best - self.min_delta))
        if better:
            self._best = cur
            self._wait = 0
            return
        if self._cool > 0:
            self._cool -= 1
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = max(float(opt.get_lr()) * self.factor, self.min_lr)
                opt.set_lr(lr)
                if self.verbose:
                    _logger.info("ReduceLROnPlateau: lr -> %.2e", lr)
            self._wait = 0
            self._cool = self.cooldown


class TelemetryCallback(Callback):
    """Training telemetry into the observability registry: per-step
    wall-time and loss histograms, a step counter and an epoch gauge,
    and one `train_step` span a batch, so a traced training window lines
    up with serving traces in the same JSONL. Model.fit attaches one
    whenever telemetry is on (observability.metrics.enable()); every
    update is a no-op when it is off, so it is always safe to attach."""

    # step-time buckets: 1 ms (a tiny CPU model) .. 30 s (a large model)
    _STEP_BUCKETS = (.001, .005, .01, .025, .05, .1, .25, .5, 1.0, 2.5,
                     5.0, 10.0, 30.0)

    def __init__(self, prefix="train"):
        self.prefix = prefix
        self._h_step = _metrics.histogram(
            f"{prefix}_step_seconds", "wall time of one train step",
            buckets=self._STEP_BUCKETS)
        self._h_loss = _metrics.histogram(
            f"{prefix}_loss", "per-step loss",
            buckets=(.01, .1, .5, 1, 2, 5, 10, 100))
        self._c_steps = _metrics.counter(
            f"{prefix}_steps_total", "train steps completed")
        self._g_epoch = _metrics.gauge(
            f"{prefix}_epoch", "current epoch")
        self._t0 = None
        self._span = None

    def on_epoch_begin(self, epoch, logs=None):
        self._g_epoch.set(epoch)

    def on_batch_begin(self, mode, step, logs=None):
        if mode != "train":
            return
        self._t0 = time.perf_counter()
        if _tracing.enabled():
            self._span = _tracing.span("train_step", step=step)
            self._span.__enter__()

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train":
            return
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
        if self._t0 is not None:
            self._h_step.observe(time.perf_counter() - self._t0)
            self._t0 = None
        self._c_steps.inc()
        loss = logs[0] if isinstance(logs, (list, tuple)) and logs \
            else logs
        if isinstance(loss, tuple):
            loss = loss[0]
        try:
            self._h_loss.observe(float(np.ravel(np.asarray(loss))[0]))
        except (TypeError, ValueError):
            pass  # non-scalar logs (metrics dicts) — step time still lands


class VisualDL(Callback):
    """Scalar logging: the scalars append to `log_dir/scalars.jsonl` (the
    visualdl package is not a dependency)."""

    def __init__(self, log_dir="vdl_log"):
        self.log_dir = log_dir
        self._step = 0

    def _write(self, tag, logs):
        import json
        import os
        os.makedirs(self.log_dir, exist_ok=True)
        rec = {"tag": tag, "step": self._step}
        if not isinstance(logs, dict):
            logs = {"value": logs} if logs is not None else {}
        for k, v in logs.items():
            try:
                rec[k] = float(np.ravel(np.asarray(v, dtype=np.float64))[0])
            except (TypeError, ValueError):
                continue
        with open(os.path.join(self.log_dir, "scalars.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    def on_batch_end(self, mode, step, logs=None):
        if mode != "train":
            return
        self._step += 1
        if self._step % 10 == 0:
            self._write("train", logs)

    def on_end(self, mode, logs=None):
        self._write(mode, logs)
