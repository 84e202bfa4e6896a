"""The port stands alone: `paddle_tpu_torch` and `chip_smoke.py` import
neither JAX nor anything of the JAX package `paddle_tpu`, and the port's
entry points run on CUDA by default — raising, not running on the CPU,
when there is no card."""
import ast
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", "_build")]
        out += [os.path.join(dirpath, f) for f in filenames
                if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        if not rel.startswith("paddle_tpu_torch"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[:-len(".__init__")] if mod.endswith("__init__")
                    else mod)
    return mods


def _forbidden(name):
    """Exact top-level match: `paddle_tpu_torch` itself starts with the
    string `paddle_tpu` and is allowed."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def test_port_files_found():
    files = _port_files()
    assert any(f.endswith("chip_smoke.py") for f in files)
    assert len(files) >= 15, files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_reference_out_of_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK', len([m for m in sys.modules\n"
        "                 if m.startswith('paddle_tpu_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_import_vision_and_functional_leaves_jax_out():
    """`import paddle_tpu_torch.vision` (the zoo, ops, transforms,
    datasets) and the fluid-era functional modules import no JAX and
    nothing of the reference."""
    code = ("import sys\n"
            "import paddle_tpu_torch.vision as V\n"
            "import paddle_tpu_torch.nn.functional.detection\n"
            "import paddle_tpu_torch.nn.functional.sequence\n"
            "from paddle_tpu_torch.io.native_loader import parse_multislot\n"
            "V.models.resnet50, V.ops.nms, V.transforms.ToTensor\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', "
            "'paddle_tpu'))\n"
            "assert not bad, bad\n"
            "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "OK"


@pytest.mark.parametrize("entry", ["resolve_device", "GPT2", "PagedKVCache",
                                   "PagedGenerationServer",
                                   "build_train_step", "AdamW", "Bert",
                                   "bert_build_train_step", "jit.load",
                                   "init_hybrid_gpt2_params",
                                   "hybrid_params_from_reference",
                                   "init_moe_params", "fleet.init",
                                   "init_opt_state", "PSEmbedding",
                                   "SyncBatchNorm", "optimizer.step",
                                   "fleet.build_worker_server", "to_tensor",
                                   "zeros", "nn.Linear", "set_device",
                                   "DataLoader", "Model",
                                   "vision.models.resnet50"])
def test_entry_points_default_to_cuda(entry, monkeypatch, tmp_path):
    """With no card (forced here), every entry point called without
    device= raises naming device='cpu'; with device='cpu' it runs."""
    from paddle_tpu_torch import jit, resolve_device
    from paddle_tpu_torch.inference import PagedGenerationServer, PagedKVCache
    from paddle_tpu_torch.models import (GPT2, Bert, BertConfig, GPT2Config,
                                         build_train_step)
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models import gpt2_hybrid as H
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.moe import init_moe_params

    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.fleet.transport import build_worker_server
    from paddle_tpu_torch.distributed.ps import PSEmbedding
    from paddle_tpu_torch.nn import SyncBatchNorm
    from paddle_tpu_torch.optimizer import SGD
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.device import device_guard

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def on(kw, fn):
        """fn() with kw's device (if any) as the default one."""
        if "device" not in kw:
            return fn()
        with device_guard(kw["device"]):
            return fn()

    def set_dev(**kw):
        with device_guard("cpu"):  # the default is restored after
            return ptt.set_device(kw.get("device", "gpu"))
    fleet_step, _ = fleet.build_hybrid_train_step(
        fleet.DistributedStrategy(), lambda p, b, k: p["w"].sum(),
        SGD(0.1, device="cpu"))

    def stateful_step(**kw):
        p = torch.ones(2, requires_grad=True)
        o = SGD(0.1, parameters=[p], **kw)
        p.sum().backward()
        o.step()
        return p

    cfg = GPT2Config(vocab_size=32, hidden_size=32, num_layers=1,
                     num_heads=2, max_position=16)
    bcfg = BertConfig(vocab_size=32, hidden_size=32, num_layers=1,
                      num_heads=2, intermediate_size=64, max_position=16)
    model = GPT2(cfg, device="cpu")
    from paddle_tpu_torch.models.gpt2 import export_generator

    export_generator(model, str(tmp_path / "gen"), prompt_len=4,
                     max_new_tokens=2)

    def gen():
        return torch.Generator().manual_seed(0)

    def hybrid(**kw):
        return H.init_hybrid_gpt2_params(gen(), 32, 32, 2, 2, 1, 16, **kw)

    hybrid_np = {k: v.numpy() for k, v in hybrid(device="cpu").items()}
    import numpy as np

    from paddle_tpu_torch.io import DataLoader, TensorDataset

    ds = TensorDataset([np.ones((4, 2), np.float32)])
    with device_guard("cpu"):
        user_net = ptt.nn.Linear(2, 3)
    calls = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "GPT2": lambda **kw: GPT2(cfg, **kw),
        "PagedKVCache": lambda **kw: PagedKVCache(1, 2, 16, block_size=4,
                                                  num_blocks=4, **kw),
        "PagedGenerationServer": lambda **kw: PagedGenerationServer(
            model, max_slots=1, block_size=4, max_new_tokens=2, **kw),
        "build_train_step": lambda **kw: build_train_step(cfg, **kw),
        "AdamW": lambda **kw: AdamW(1e-4, **kw),
        "Bert": lambda **kw: Bert(bcfg, **kw),
        "bert_build_train_step": lambda **kw: bert.build_train_step(bcfg,
                                                                    **kw),
        "jit.load": lambda **kw: jit.load(str(tmp_path / "gen"), **kw),
        "init_hybrid_gpt2_params": hybrid,
        "hybrid_params_from_reference":
            lambda **kw: H.hybrid_params_from_reference(hybrid_np, **kw),
        "init_moe_params": lambda **kw: init_moe_params(gen(), 8, 16, 2,
                                                        **kw),
        "fleet.init": lambda **kw: fleet.init(is_collective=True, **kw),
        "init_opt_state": lambda **kw: fleet_step.init_opt_state(
            {"w": torch.ones(4, 2)}, **kw),
        "PSEmbedding": lambda **kw: PSEmbedding(10, 4, **kw),
        "SyncBatchNorm": lambda **kw: SyncBatchNorm(3, **kw),
        "optimizer.step": lambda **kw: stateful_step(**kw),
        "fleet.build_worker_server": lambda **kw: build_worker_server(
            dict({"model": {"seed": 0, "config": {
                "vocab_size": 32, "hidden_size": 32, "num_layers": 1,
                "num_heads": 2, "max_position": 16}},
                "server": {"max_slots": 1, "block_size": 4,
                           "max_new_tokens": 2}}, **kw)),
        "to_tensor": lambda **kw: ptt.to_tensor([1.0],
                                                place=kw.get("device")),
        "zeros": lambda **kw: on(kw, lambda: ptt.zeros([2])),
        "nn.Linear": lambda **kw: on(kw, lambda: ptt.nn.Linear(4, 8)),
        "set_device": set_dev,
        "DataLoader": lambda **kw: list(DataLoader(
            ds, batch_size=2, places=kw.get("device"))),
        "Model": lambda **kw: on(kw, lambda: ptt.Model(
            user_net).predict_batch(np.ones((1, 2), np.float32))),
        "vision.models.resnet50": lambda **kw: on(
            kw, lambda: ptt.vision.models.resnet50()),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](device="cuda")
    assert calls[entry](device="cpu") is not None


def test_no_prebuilt_binary_under_csrc():
    """csrc/ holds sources only: the kernels and the native runtime are
    built at first use into _build/ (gitignored)."""
    csrc = os.path.join(PKG, "csrc")
    names = sorted(os.listdir(csrc))
    assert "native_runtime.cpp" in names
    for name in names:
        assert os.path.splitext(name)[1] in (".cu", ".cuh", ".cpp"), name
        with open(os.path.join(csrc, name), "rb") as f:
            head = f.read(4096)
        assert not head.startswith(b"\x7fELF") and b"\0" not in head, name


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; they never compute on the
    CPU themselves (the plain version lives in ops.attention)."""
    from paddle_tpu_torch.ops import kernels

    q = torch.zeros(2, 2, 32)
    pool = torch.zeros(3, 4, 2, 32)
    tab = torch.zeros(2, 1, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.paged_decode(q, pool, pool, tab, lens, 1.0)
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.ragged_stream(q, pool, pool, tab, lens, lens, 1.0)


def test_fleet_package_imports_neither_jax_nor_reference():
    """`paddle_tpu_torch.fleet` (the serving fleet) and its worker module
    alone leave JAX and the JAX package out of sys.modules."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.fleet, paddle_tpu_torch.fleet.transport\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("OK")


def test_spawned_worker_imports_neither_jax_nor_reference(tmp_path):
    """A fleet worker as `RemoteReplica.spawn` starts it (its module run
    as __main__) serves a request, shuts down on /shutdown, and then
    lists its sys.modules: neither JAX nor the JAX package is there."""
    import json

    import numpy as np

    from paddle_tpu_torch.fleet import RemoteReplica
    from paddle_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
               max_position=32, dropout=0.0)
    weights = tmp_path / "w.npz"
    np.savez(weights, **{k: v.numpy() for k, v in GPT2(
        GPT2Config(**cfg), device="cpu").flat_params().items()})
    listing = tmp_path / "modules.json"
    # spawn runs `<python> -m paddle_tpu_torch.fleet.transport --config
    # <file>`; this launcher runs the same module as __main__ with the
    # same --config and writes sys.modules at exit
    launcher = tmp_path / "python_with_exit_listing"
    launcher.write_text(
        "#!/bin/sh\n"
        f"exec {sys.executable} -c 'import atexit, json, runpy, sys\n"
        f"atexit.register(lambda: json.dump(sorted(sys.modules), "
        f"open(\"{listing}\", \"w\")))\n"
        "sys.argv = [\"transport\"] + sys.argv[3:]\n"
        "runpy.run_module(\"paddle_tpu_torch.fleet.transport\", "
        "run_name=\"__main__\")' \"$@\"\n")
    launcher.chmod(0o755)
    rep = RemoteReplica.spawn("iso0", {
        "model": {"kind": "gpt2", "weights": str(weights), "config": cfg},
        "server": {"max_slots": 1, "block_size": 4, "max_prompt_len": 8,
                   "max_new_tokens": 2},
        "device": "cpu"}, python=str(launcher), keep_alive_on_stop=True)
    try:
        out = rep.server.submit(np.array([1, 2, 3], np.int32)).result(
            timeout=120)
        assert out.size == 5
    finally:
        rep.terminate()
    mods = json.loads(listing.read_text())
    assert "paddle_tpu_torch.fleet.transport" in mods
    bad = [m for m in mods if _forbidden(m)]
    assert not bad, bad
