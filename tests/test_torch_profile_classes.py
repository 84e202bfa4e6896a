"""The training profile's kernel classes know every kernel of the port:
each `__global__` of `paddle_tpu_torch/csrc/*.cu` falls, under the name
torch.profiler gives it, into the class of its Id in
`scripts/torch_train_profile.py` (`classify`): K4 `flash_fwd*`, K6
`flash_delta*`, K7 `flash_bwd_dq*`, K8 `flash_bwd_dkv*`, K9 `flash_bwd*`
and its dq cast `scale_cast*`; the serving kernels (K1, K2) in no flash
class. So a new or renamed kernel cannot slip into "other" unseen. Runs on
the CPU: it reads the sources and imports the script, and launches
nothing."""
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s+)?(\w+)\s*\(")
# the class of a kernel by the start of its name; the first match wins
CLASS_OF = (("flash_fwd", "K4 flash_fwd"),
            ("flash_delta", "K6 flash_delta"),
            ("flash_bwd_dq", "K7 flash_bwd_dq"),
            ("flash_bwd_dkv", "K8 flash_bwd_dkv"),
            ("flash_bwd", "K9 flash_bwd"),
            ("scale_cast", "K9 flash_bwd"))


def _kernels():
    names = set()
    for path in sorted(CSRC.glob("*.cu")):
        names.update(GLOBAL.findall(path.read_text(encoding="utf-8")))
    return sorted(names)


def _classify():
    spec = importlib.util.spec_from_file_location(
        "torch_train_profile", ROOT / "scripts" / "torch_train_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.classify


def test_the_sources_name_every_flash_kernel():
    names = _kernels()
    for name in ("flash_fwd_kernel", "flash_fwd_sm90_kernel",
                 "flash_delta_kernel", "flash_bwd_kernel",
                 "flash_bwd_sm90_kernel", "scale_cast_kernel",
                 "flash_bwd_dq_kernel", "flash_bwd_dq_sm90_kernel",
                 "flash_bwd_dkv_kernel", "flash_bwd_dkv_sm90_kernel",
                 "ragged_stream_kernel", "ragged_stream_sm90_kernel",
                 "paged_decode_split_kernel",
                 "paged_decode_combine_kernel"):
        assert name in names, name


@pytest.mark.parametrize("name", _kernels())
def test_classify_puts_each_kernel_in_its_class(name):
    want = next((cls for prefix, cls in CLASS_OF if name.startswith(prefix)),
                None)
    # the demangled signature torch.profiler reports as the kernel's key
    key = (f"void pt::flash::(anonymous namespace)::{name}<64, false>("
           f"CUtensorMap, float*, float const*, pt::flash::Shape)")
    got = _classify()(key)
    if want is None:  # a serving kernel: in no class of a flash kernel
        assert not got.startswith("K"), (name, got)
    else:
        assert got == want, (name, got)
