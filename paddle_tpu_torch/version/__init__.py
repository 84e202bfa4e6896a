"""Version info (the reference's `paddle_tpu/version/__init__.py`, Paddle's
generated python/paddle/version.py): the package's version and commit
tag, which `paddle.__version__`, `paddle.full_version` and
`paddle.commit` bind."""
full_version = "0.1.0"
major = "0"
minor = "1"
patch = "0"
rc = "0"
istaged = True
commit = "torch-cuda"


def show():
    print(f"paddle_tpu_torch {full_version} (commit {commit})")  # cli-print
