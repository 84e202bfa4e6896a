"""`paddle.Model`: fit / evaluate / predict / save / load (the port of
`paddle_tpu/hapi/model.py`).

`prepare(optimizer, loss, metrics, amp_configs=None, jit=True)` picks
the training step. Both give the reference's arithmetic:

  * `jit=True` (the default) is the reference's fused step as one
    function: `torch.func.functional_call` of the network over its
    parameters and buffers, `torch.autograd.grad` of the loss for every
    parameter (zeros for one the loss does not reach, as a functional
    gradient gives), the optimizer's global-norm clip (`clip_tree`) and
    the optimizer's `functional_update` (in place) at `get_lr()`, on an
    optimizer state of its own (`functional_init`, as the reference's
    jitted state).
  * `jit=False` is the eager loop: `loss.backward()`, `optimizer.step()`,
    `optimizer.clear_grad()`.

When the fused step cannot compute the gradients (a network, loss or
optimizer it cannot run), `train_batch` warns ONCE with the
exception's type and text and trains eagerly from then on; an error
past the gradients (inside the update, which writes the parameters) is
raised, since a retry would apply part of a step twice. `amp_configs`
is accepted and ignored, as the reference does: `Model` trains in the
network's dtype.

Inputs that are not tensors go to the default device (`to_tensor`);
`fit`, `evaluate` and `predict` batch through `io.DataLoader`, whose
batches land on `get_device()` — the card, unless `set_device("cpu")`.
A batch splits as the reference's: its first field is the network's
input, the rest are the loss's labels.

`save(path)` writes `path.pdparams` (the network's state_dict) and
`path.pdopt` (the optimizer's) with `paddle.save`; `save(path,
training=False)` writes the deployment artifact through `jit.save` with
`Model(inputs=[InputSpec(...)])` as its input_spec.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..io import DataLoader
from . import callbacks as cb_mod


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = list(inputs) if inputs is not None else []
        self._labels = list(labels) if labels is not None else []
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False
        self._use_jit = False
        self._fused_state = None  # the fused step's optimizer state

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit=True):
        self._optimizer = optimizer
        self._loss = loss
        self._use_jit = jit
        if metrics is not None:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]
        return self

    # ---- the fused step --------------------------------------------------
    def _fused_grads(self, inputs, labels):
        """(loss, output, {name: param}, {name: grad}) of one batch."""
        net = self.network
        params = dict(net.named_parameters())
        if self._fused_state is None:
            self._fused_state = self._optimizer.functional_init(
                {n: p.detach() for n, p in params.items()})
        state = dict(params)
        state.update(net.named_buffers())
        live = [p for p in params.values() if p.requires_grad]
        with torch.enable_grad():
            out = torch.func.functional_call(
                net, state, tuple(_as_tensor(i) for i in inputs))
            loss = self._loss(out, *[_as_tensor(lb) for lb in labels])
            loss_t = loss if torch.is_tensor(loss) else loss[0]
            got = iter(torch.autograd.grad(loss_t, live, allow_unused=True))
        grads = {}
        for n, p in params.items():
            g = next(got) if p.requires_grad else None
            grads[n] = torch.zeros_like(p) if g is None else g
        return loss_t.detach(), out, params, grads

    def _fused_train_batch(self, inputs, labels):
        try:
            loss_t, out, params, grads = self._fused_grads(inputs, labels)
        except Exception as e:
            self._use_jit = False  # so this warns once a prepare()
            warnings.warn(
                "Model: the fused train step failed, training eagerly from "
                f"now on: {type(e).__name__}: {e}", RuntimeWarning,
                stacklevel=3)
            return None
        opt = self._optimizer
        clip = opt._grad_clip
        if clip is not None and hasattr(clip, "clip_tree"):
            grads = clip.clip_tree(grads)
        opt.functional_update(params, grads, self._fused_state,
                              lr=float(opt.get_lr()))
        opt._step_count += 1
        return self._logs(loss_t, _detached(out), labels)

    def _logs(self, loss_t, out, labels):
        metrics = self._compute_metrics(out, labels)
        lv = float(loss_t)
        return ([lv], metrics) if metrics else [lv]

    # ---- core steps ------------------------------------------------------
    def train_batch(self, inputs, labels=None):
        self.network.train()
        inputs = _as_list(inputs)
        labels = None if labels is None else _as_list(labels)
        if self._use_jit and labels is not None:
            logs = self._fused_train_batch(inputs, labels)
            if logs is not None:
                return logs
        out = self.network(*[_as_tensor(i) for i in inputs])
        loss = self._loss(out, *[_as_tensor(lb) for lb in labels]) \
            if labels is not None else out
        loss_t = loss if torch.is_tensor(loss) else loss[0]
        loss_t.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        return self._logs(loss_t.detach(), _detached(out), labels)

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = _as_list(inputs)
        labels = None if labels is None else _as_list(labels)
        with torch.no_grad():
            out = self.network(*[_as_tensor(i) for i in inputs])
            loss = self._loss(out, *[_as_tensor(lb) for lb in labels]) \
                if self._loss and labels is not None else None
        if loss is not None:
            return self._logs(loss if torch.is_tensor(loss) else loss[0],
                              out, labels)
        return self._compute_metrics(out, labels)

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            return self.network(*[_as_tensor(i) for i in _as_list(inputs)])

    def _compute_metrics(self, out, labels):
        res = {}
        for m in self._metrics:
            inp = m.compute(out, *(_as_tensor(lb) for lb in labels)) \
                if labels is not None else m.compute(out)
            res[m.name()] = m.update(inp)
        return res or None

    # ---- loops -----------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        cb_list = list(callbacks or
                       [cb_mod.ProgBarLogger(log_freq, verbose)])
        # telemetry on and no TelemetryCallback given: attach one, so fit
        # feeds the step-time and loss histograms
        from ..observability import metrics as _obs_metrics
        if _obs_metrics.enabled() and not any(
                isinstance(c, cb_mod.TelemetryCallback) for c in cb_list):
            cb_list.append(cb_mod.TelemetryCallback())
        cbs = cb_mod.CallbackList(cb_list)
        cbs.set_model(self)
        cbs.on_begin("train")
        history = []
        it_count = 0
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            for m in self._metrics:
                m.reset()
            for step, batch in enumerate(loader):
                cbs.on_batch_begin("train", step, None)
                inputs, labels = _split_batch(batch)
                logs = self.train_batch(inputs, labels)
                cbs.on_batch_end("train", step, logs)
                it_count += 1
                if num_iters is not None and it_count >= num_iters:
                    break
            epoch_logs = {"loss": logs[0] if isinstance(logs, list) else logs}
            history.append(epoch_logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size, verbose=0)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/{epoch}")
            cbs.on_epoch_end(epoch, epoch_logs)
            if self.stop_training or (num_iters is not None
                                      and it_count >= num_iters):
                break
        cbs.on_end("train")
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size,
                       num_workers=num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            inputs, labels = _split_batch(batch)
            logs = self.eval_batch(inputs, labels)
            if isinstance(logs, tuple):
                losses.append(logs[0][0])
            elif isinstance(logs, list):
                losses.append(logs[0])
        result = {}
        if losses:
            result["loss"] = [float(np.mean(losses))]
        for m in self._metrics:
            result[m.name()] = m.accumulate()
        return result

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size,
                       num_workers=num_workers)
        outputs = []
        for batch in loader:
            inputs, _ = _split_batch(batch)
            out = self.predict_batch(inputs)
            outputs.append(_host(out) if torch.is_tensor(out)
                           else [_host(o) for o in out])
        if stack_outputs and outputs and isinstance(outputs[0], np.ndarray):
            return [np.concatenate(outputs)]
        return [outputs]

    # ---- io --------------------------------------------------------------
    def save(self, path, training=True):
        """training=True: `path.pdparams` and `path.pdopt`; False: the
        deployment artifact through `jit.save` (module docstring)."""
        if not training:
            from .. import jit
            if not self._inputs:
                raise ValueError(
                    "Model.save(training=False) needs Model(network, "
                    "inputs=[InputSpec(...)]) to trace the forward")
            jit.save(self.network, path, input_spec=self._inputs)
            return
        from ..framework.io import save as fsave
        fsave(self.network.state_dict(), path + ".pdparams")
        if self._optimizer is not None:
            fsave(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as fload
        self.network.set_state_dict(fload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(fload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .model_summary import summary
        return summary(self.network, input_size)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _as_tensor(x):
    if torch.is_tensor(x):
        return x
    from ..core.tensor import to_tensor
    return to_tensor(np.asarray(x))


def _host(t):
    return t.detach().cpu().numpy()


def _detached(out):
    if torch.is_tensor(out):
        return out.detach()
    if isinstance(out, (list, tuple)):
        return type(out)(_detached(o) for o in out)
    return out


def _split_batch(batch):
    if isinstance(batch, (tuple, list)):
        if len(batch) >= 2:
            return [batch[0]], list(batch[1:])
        return [batch[0]], None
    return [batch], None


__all__ = ["Model"]
