"""CPU twins of the port's `utils` (the profiler and its bridge,
`run_check`, the batch-windowed `Profiler`, `download`), the root
aliases, the small namespaces (`incubate`, `onnx`, `version`,
`sysconfig`) and the names the reference binds (ROADMAP §C 46) against
the reference: `tests/test_misc.py`'s `TestProfiler`, `TestRunCheck`,
`TestUtilsProfilerSurface`, `TestRootAliases`, `TestUtilsDownloadModule`
(its `TestAsyncSave` and `TestParamGroups` have twins in
`test_torch_save_load.py` and `test_torch_optimizer.py`), and
`tests/test_incubate*`-era behaviours of `incubate` on the same inputs.

On the CPU the profiler records the host's ops (their self time); on the
card it records device kernels (chip_smoke.py phase 6q (b))."""
import hashlib
import importlib
import io
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor as RT

import paddle_tpu_torch as ptt
from paddle_tpu_torch import device as pdevice

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_cpu():
    with pdevice.device_guard("cpu"):
        ptt.set_device("cpu")
        yield


# ---- the names the reference binds ------------------------------------------

BINDINGS = [
    ("", n) for n in (
        "DataParallel", "utils", "batch", "dataset", "reader", "text",
        "slim", "incubate", "onnx", "version", "sysconfig", "commit",
        "full_version", "__version__", "fused_feedforward",
        "fused_multi_head_attention", "sync_batch_norm", "nan_to_num_",
        "abs_", "max_", "min_", "sum_")
] + [("framework", n) for n in (
    "DataParallel", "LayerList", "VarBase", "ComplexVariable", "random")
] + [("nn", n) for n in (
    "GradientClipByValue", "GradientClipByNorm", "GradientClipByGlobalNorm",
    "crf_decoding", "clip_by_norm", "set_gradient_clip", "common", "conv",
    "extension", "loss", "norm", "pooling", "rnn", "vision",
    "weight_norm_hook")
] + [("nn.initializer", n) for n in (
    "assign", "constant", "kaiming", "normal", "uniform", "xavier")
] + [("tensor", n) for n in (
    "abs_", "max_", "min_", "sum_", "fused_feedforward",
    "fused_multi_head_attention", "sync_batch_norm", "nan_to_num_")
] + [("utils", n) for n in (
    "profiler", "Profiler", "ProfilerOptions", "get_profiler",
    "OpLastCheckpointChecker", "run_check", "try_import", "deprecated",
    "require_version", "download", "dump_config", "load_op_library",
    "unique_name", "Watchdog")]


@pytest.mark.parametrize("ns,name", BINDINGS,
                         ids=[f"{ns or 'paddle'}.{n}" for ns, n in BINDINGS])
def test_reference_binding_is_bound(ns, name):
    ref = importlib.import_module("paddle_tpu" + (f".{ns}" if ns else ""))
    port = importlib.import_module("paddle_tpu_torch"
                                   + (f".{ns}" if ns else ""))
    assert hasattr(ref, name)
    assert getattr(port, name) is not None


def test_bindings_are_the_ports_objects():
    from paddle_tpu_torch import compat, nn, ops
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.distributed.parallel import DataParallel
    assert ptt.DataParallel is DataParallel
    assert ptt.framework.DataParallel is DataParallel
    assert ptt.framework.LayerList is nn.LayerList
    assert ptt.framework.VarBase is compat.VarBase
    assert ptt.framework.random is rng
    assert nn.GradientClipByNorm is nn.ClipGradByNorm
    assert nn.conv is nn and nn.weight_norm_hook is nn
    assert nn.initializer.xavier is nn.initializer
    assert ptt.tensor.sum_ is ops.sum and ptt.tensor.abs_ is ops.abs
    assert ptt.batch is ptt.reader.batch
    assert ptt.__version__ == ptt.full_version == paddle.__version__
    assert ptt.commit == ptt.version.commit


def test_bound_functions_match_the_reference():
    rs = np.random.RandomState(0)
    x = rs.randn(8, 5).astype(np.float32)
    x[0, 0], x[1, 1], x[2, 2] = np.nan, np.inf, -np.inf
    got = ptt.nan_to_num_(torch.from_numpy(x), nan=1.0)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(paddle.nan_to_num_(RT(jnp.asarray(x)),
                                                   nan=1.0).numpy()))
    assert not got.requires_grad
    y = rs.randn(6).astype(np.float32) * 4
    np.testing.assert_allclose(
        ptt.nn.clip_by_norm(torch.from_numpy(y), 1.5).numpy(),
        np.asarray(paddle.nn.clip_by_norm(RT(jnp.asarray(y)), 1.5).numpy()),
        rtol=1e-6)
    clip = ptt.nn.ClipGradByNorm(1.0)
    ptt.nn.set_gradient_clip(clip)
    assert ptt.nn.clip._default_grad_clip is clip
    emis = rs.randn(2, 7, 4).astype(np.float32)
    path = ptt.nn.crf_decoding(torch.from_numpy(emis))
    assert tuple(path.shape) == (2, 7)


def test_sync_batch_norm_op_name_is_the_layers_function():
    from paddle_tpu_torch.nn.layer import norm
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    rm, rv = torch.zeros(3), torch.ones(3)
    a = ptt.sync_batch_norm(x, rm, rv)
    b = norm.sync_batch_norm(x, rm, rv)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# ---- utils ------------------------------------------------------------------

class TestProfiler:
    def test_record_event_and_summary(self):
        from paddle_tpu_torch.utils import profiler
        profiler.reset()
        with profiler.RecordEvent("matmul"):
            a = ptt.ones([64, 64])
            (a @ a).numpy()
        s = profiler.summary()
        assert "matmul" in s and s["matmul"]["count"] == 1
        assert set(s["matmul"]) == set(
            paddle.utils.profiler.summary().get("matmul", s["matmul"]))

    def test_record_event_decorator_forms(self):
        from paddle_tpu_torch.utils import profiler
        profiler.reset()

        @profiler.record_event
        def step():
            return 1

        @profiler.record_event("named")
        def other():
            return 2

        assert step() + other() + step() == 4
        s = profiler.summary()
        assert s["named"]["count"] == 1
        assert s[step.__wrapped__.__qualname__]["count"] == 2

    def test_top_ops_counts_one_level(self):
        """The CPU's self times: the matmul's own op once per step, no
        envelope counted on top of it."""
        from paddle_tpu_torch.utils import profiler
        a = torch.ones(96, 96)
        rows = profiler.top_ops(lambda: (a @ a).relu(), steps=3, k=10)
        names = {n: (ms, c) for n, ms, c in rows}
        assert "aten::mm" in names and names["aten::mm"][1] == 3
        assert all(ms >= 0 for _, ms, _ in rows)
        assert rows == sorted(rows, key=lambda r: -r[1])

    def test_print_top_ops_and_trace_dir(self, capsys, tmp_path):
        from paddle_tpu_torch.utils import profiler
        a = torch.ones(32, 32)
        rows = profiler.print_top_ops(lambda: a @ a, steps=1, k=3)
        out = capsys.readouterr().out
        assert "op" in out.splitlines()[0] and "covers" in out
        assert 0 < len(rows) <= 3
        profiler.top_ops(lambda: a @ a, steps=1, trace_dir=str(tmp_path))
        assert (tmp_path / "trace.json").stat().st_size > 0

    def test_profiler_context_writes_a_trace(self, tmp_path):
        from paddle_tpu_torch.utils import profiler
        with profiler.profiler(state="CPU", profile_path=str(tmp_path)):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        assert (tmp_path / "trace.json").exists()

    def test_the_card_is_asked_for(self, monkeypatch):
        """Asked for the card (a CUDA device, a "GPU" state, or the
        default device outside a CPU guard) the profiler raises naming
        device='cpu' when there is none."""
        from paddle_tpu_torch.utils import profiler
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiler.top_ops(lambda: None, device="cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiler.start_profiler(state="GPU")


class TestRunCheck:
    def test_run_check(self, capsys):
        ptt.utils.run_check()
        out = capsys.readouterr().out
        assert "OK" in out and "device: cpu" in out

    def test_run_check_needs_the_card_by_default(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ptt.utils.run_check(device="cuda")
        from paddle_tpu_torch.utils import install_check
        assert install_check.run_check is ptt.utils.run_check


class TestUtilsProfilerSurface:
    def test_profiler_batch_window(self, tmp_path):
        opts = ptt.utils.ProfilerOptions({"batch_range": [1, 3],
                                          "profile_path": str(tmp_path)})
        assert ptt.utils.ProfilerOptions()["profile_path"] is None
        assert opts.with_state("CPU")["state"] == "CPU"
        with ptt.utils.Profiler(enabled=True, options=opts) as prof:
            for _ in range(4):
                _ = ptt.to_tensor(np.ones(2)) + 1
                prof.reset()
        assert prof.batch_id == 4
        assert (tmp_path / "trace.json").exists()
        assert ptt.utils.get_profiler() is not None
        assert ptt.utils.OpLastCheckpointChecker().filter_updates(
            "matmul") == []

    def test_small_helpers_match_the_reference(self, tmp_path):
        U, R = ptt.utils, paddle.utils
        cfg = {"a": 1, "b": [1, 2], "c": {"d": "x"}}
        assert U.dump_config(cfg) == R.dump_config(cfg)
        U.dump_config(cfg, str(tmp_path / "c.json"))
        assert (tmp_path / "c.json").read_text() == R.dump_config(cfg)
        U.require_version("0.0.1")
        with pytest.raises(Exception, match="required"):
            U.require_version("99.0")
        with pytest.raises(Exception, match="required"):
            U.require_version("0.0.1", "0.0.2")
        assert U.try_import("json") is sys.modules["json"]
        with pytest.raises(ImportError, match="not available"):
            U.try_import("no_such_module_here")
        f = lambda: 3  # noqa: E731
        assert U.deprecated(since="2.0")(f) is f
        assert U.unique_name.generate("fc") != U.unique_name.generate("fc")


class TestRootAliases:
    def test_root_attribute_surface(self):
        assert ptt.ComplexTensor is torch.Tensor
        assert ptt.in_dynamic_mode() is True
        out = ptt.reverse(ptt.to_tensor(np.array([1, 2, 3])), [0])
        np.testing.assert_array_equal(out.numpy(), [3, 2, 1])
        np.testing.assert_array_equal(out.numpy(), np.asarray(
            paddle.reverse(paddle.to_tensor(np.array([1, 2, 3])),
                           [0]).numpy()))


class TestUtilsDownloadModule:
    def test_local_resolution(self, tmp_path, monkeypatch):
        from paddle_tpu_torch.utils.download import (
            get_path_from_url, get_weights_path_from_url)
        monkeypatch.setenv("PADDLE_TPU_PRETRAINED_DIR", str(tmp_path))
        (tmp_path / "bert.pdparams").write_bytes(b"w")
        p = get_weights_path_from_url(
            "https://host/models/bert.pdparams?download=1")
        assert p == str(tmp_path / "bert.pdparams")
        assert ptt.utils.get_weights_path_from_url is \
            get_weights_path_from_url
        with pytest.raises(FileNotFoundError,
                           match="PADDLE_TPU_PRETRAINED_DIR"):
            get_weights_path_from_url("https://host/m/absent.pdparams")
        md5 = hashlib.md5(b"w").hexdigest()
        assert get_weights_path_from_url("https://h/bert.pdparams",
                                         md5sum=md5) == p
        with pytest.raises(ValueError, match="md5"):
            get_weights_path_from_url("https://h/bert.pdparams",
                                      md5sum="0" * 32)
        sub = tmp_path / "sub"
        sub.mkdir()
        (sub / "m.bin").write_bytes(b"z")
        assert get_path_from_url("https://h/m.bin", root_dir=str(sub)) == \
            str(sub / "m.bin")


# ---- the small namespaces ---------------------------------------------------

def test_softmax_mask_fuse_upper_triangle_matches_reference():
    x = np.random.RandomState(1).randn(2, 3, 6, 6).astype(np.float32)
    got = ptt.incubate.softmax_mask_fuse_upper_triangle(torch.from_numpy(x))
    want = paddle.incubate.softmax_mask_fuse_upper_triangle(
        RT(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-6, atol=1e-7)
    assert float(got[0, 0, 0, 1]) == 0.0


def test_lookahead_matches_reference():
    """LookAhead(SGD, alpha 0.5, k 2) over 6 steps of the same quadratic
    on the same start: the same weights."""
    from paddle_tpu_torch.nn.layer.layers import load_reference_state
    paddle.seed(2)
    ref, port = paddle.nn.Linear(4, 3), ptt.nn.Linear(4, 3)
    load_reference_state(port, {k: np.asarray(v.numpy())
                                for k, v in ref.state_dict().items()})
    xs = np.random.RandomState(2).randn(5, 4).astype(np.float32)
    for pkg, lin, wrap in ((paddle, ref, lambda a: RT(jnp.asarray(a))),
                           (ptt, port, torch.from_numpy)):
        opt = pkg.incubate.LookAhead(pkg.optimizer.SGD(
            0.1, parameters=lin.parameters()), alpha=0.5, k=2)
        for _ in range(6):
            opt.minimize((lin(wrap(xs)) ** 2).mean())
            opt.clear_grad()
    for k, v in ref.state_dict().items():
        np.testing.assert_allclose(port.state_dict()[k].numpy(),
                                   np.asarray(v.numpy()), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_data_generator_bytes_are_the_references(monkeypatch):
    from paddle_tpu.incubate import data_generator as RG
    from paddle_tpu_torch.incubate import data_generator as PG

    def make(mod):
        class Gen(mod.MultiSlotDataGenerator):
            def generate_sample(self, line):
                def it():
                    toks = line.split()
                    yield [("words", [int(t) for t in toks]),
                           ("label", [len(toks) % 2]),
                           ("w", [0.5 * len(toks)])]
                return it
        return Gen()

    outs = []
    for mod in (PG, RG):
        g = make(mod)
        g.set_batch(2)
        monkeypatch.setattr(sys, "stdin", io.StringIO("1 2 3\n4 5\n6\n"))
        buf = io.StringIO()
        monkeypatch.setattr(sys, "stdout", buf)
        g.run_from_stdin()
        monkeypatch.undo()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].startswith("3 1 2 3 1 1 1 1.5")
    assert ptt.incubate.reader is ptt.reader
    assert ptt.incubate.fleet is importlib.import_module(
        "paddle_tpu_torch.distributed.fleet")


def test_onnx_export_raises_by_design():
    from paddle_tpu_torch.onnx.export import export
    with pytest.raises(NotImplementedError, match="not supported"):
        ptt.onnx.export(None, "m")
    assert export is ptt.onnx.export


def test_version_and_sysconfig():
    import os
    v, rv = ptt.version, paddle.version
    for k in ("full_version", "major", "minor", "patch", "rc", "istaged"):
        assert getattr(v, k) == getattr(rv, k), k
    assert isinstance(v.commit, str) and v.commit
    assert os.path.isfile(os.path.join(ptt.sysconfig.get_include(),
                                       "native_runtime.cpp"))
    assert ptt.sysconfig.get_lib().endswith("_build")
