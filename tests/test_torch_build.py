"""The kernel build covers every source of `paddle_tpu_torch/csrc/`: each
`*.cu` compiles as a unit of the library and every `*.cu` / `*.cuh` enters
the source hash that names the build directory, so a new or changed
source can never reuse a library built under an old hash. Runs on the
CPU: it reads the sources and hashes them, and builds nothing."""
import shutil

import pytest

from paddle_tpu_torch.ops import kernels


def _csrc(*suffixes):
    return sorted(p.name for p in kernels.CSRC.iterdir()
                  if p.suffix in suffixes)


def test_every_unit_is_compiled():
    assert sorted(kernels.UNITS) == _csrc(".cu")


def test_every_source_enters_the_hash():
    assert sorted(kernels.SOURCES) == _csrc(".cu", ".cuh")
    assert len(set(kernels.SOURCES)) == len(kernels.SOURCES)


@pytest.mark.parametrize("name", _csrc(".cu", ".cuh"))
def test_a_changed_source_changes_the_hash(name, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = kernels.source_hash()
    with open(csrc / name, "a", encoding="utf-8") as f:
        f.write("\n// changed\n")
    assert kernels.source_hash() != before


def test_the_compiler_flags_enter_the_hash(monkeypatch):
    before = kernels.source_hash()
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.source_hash() != before
