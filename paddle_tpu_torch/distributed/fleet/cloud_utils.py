"""fleet.cloud_utils: the cluster from PaddleCloud-style environment
variables (`paddle_tpu_torch.distributed.cloud_utils`)."""
from ..cloud_utils import get_cloud_cluster, get_cluster_and_pod  # noqa: F401

__all__ = ["get_cloud_cluster", "get_cluster_and_pod"]
