"""Twin of tests/test_no_print.py over the port: `scripts/check_no_print.py`'s
`check_file` run on every module of `paddle_tpu_torch/` finds no bare
`print()` (CLI surfaces carry the `# cli-print` pragma), with the
script's own allow-list rule."""
import importlib.util
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


def _script():
    spec = importlib.util.spec_from_file_location(
        "check_no_print", os.path.join(REPO, "scripts", "check_no_print.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_no_bare_print_in_the_port():
    mod = _script()
    bad, seen = [], 0
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__",
                                                        "_build")]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                seen += 1
                bad += mod.check_file(path, os.path.relpath(path, REPO))
    assert seen > 100, seen
    assert not bad, "\n".join(bad)


def test_the_check_sees_a_bare_print(tmp_path):
    """The scan flags a bare print and passes one with the pragma, so
    the test above is not vacuous."""
    mod = _script()
    p = tmp_path / "m.py"
    p.write_text("print('x')\nprint('y')  # cli-print\nlog.print('z')\n")
    assert [b.split(":")[1] for b in mod.check_file(str(p), "m.py")] == \
        ["1"]
