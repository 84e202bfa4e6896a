"""`python -m paddle_tpu_torch.distributed.fleet.launch`: the fleet's
path to `paddle_tpu_torch.distributed.launch`."""
from ..launch import main  # noqa: F401

if __name__ == "__main__":
    main()
