"""fleet.launch_utils: the launcher's helpers of
`paddle_tpu_torch.distributed.utils`."""
from ..utils import (  # noqa: F401
    Cluster, Pod, Trainer, add_arguments, find_free_ports, get_cluster,
    get_host_name_ip, get_logger, terminate_local_procs,
)

__all__ = ["get_cluster", "get_host_name_ip", "find_free_ports",
           "terminate_local_procs", "get_logger", "add_arguments",
           "Cluster", "Pod", "Trainer"]
