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


@pytest.mark.parametrize("entry", ["resolve_device", "GPT2", "PagedKVCache",
                                   "PagedGenerationServer"])
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """With no card (forced here), every entry point called without
    device= raises naming device='cpu'; with device='cpu' it runs."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import PagedGenerationServer, PagedKVCache
    from paddle_tpu_torch.models import GPT2, GPT2Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPT2Config(vocab_size=32, hidden_size=32, num_layers=1,
                     num_heads=2, max_position=16)
    model = GPT2(cfg, device="cpu")
    calls = {
        "resolve_device": lambda **kw: resolve_device(**kw),
        "GPT2": lambda **kw: GPT2(cfg, **kw),
        "PagedKVCache": lambda **kw: PagedKVCache(1, 2, 16, block_size=4,
                                                  num_blocks=4, **kw),
        "PagedGenerationServer": lambda **kw: PagedGenerationServer(
            model, max_slots=1, block_size=4, max_new_tokens=2, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](device="cuda")
    assert calls[entry](device="cpu") is not None


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
