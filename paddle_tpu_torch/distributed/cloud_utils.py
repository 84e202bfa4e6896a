"""The cluster from PaddleCloud-style environment variables
(PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ENDPOINTS, POD_IP, PADDLE_PORT): the
port of `paddle_tpu/distributed/cloud_utils.py`.
"""
from __future__ import annotations

import os

from .utils import get_cluster


def _get_trainers_num():
    return int(os.getenv("PADDLE_TRAINERS_NUM", "1"))


def get_cloud_cluster(args_node_ips=None, args_node_ip=None,
                      args_port=None, selected_devices=None):
    node_ip = os.getenv("POD_IP", args_node_ip or "127.0.0.1")
    eps = os.getenv("PADDLE_TRAINER_ENDPOINTS")
    port = int(os.getenv("PADDLE_PORT", str(args_port or 6170)))
    if eps:
        endpoints = eps.split(",")
        node_ips = []
        for e in endpoints:
            ip = e.split(":")[0]
            if ip not in node_ips:
                node_ips.append(ip)
    else:
        node_ips = args_node_ips if isinstance(args_node_ips, list) \
            else (args_node_ips.split(",") if args_node_ips
                  else [node_ip])
        slots = selected_devices or [0]
        endpoints = [f"{ip}:{port + i}" for ip in node_ips
                     for i in range(len(slots))]
    slots = selected_devices or [0]
    cluster, pod = get_cluster(node_ips, node_ip, endpoints, slots)
    return cluster, pod


def get_cluster_and_pod(args):
    return get_cloud_cluster(
        getattr(args, "cluster_node_ips", None),
        getattr(args, "node_ip", None),
        getattr(args, "started_port", None),
        getattr(args, "selected_devices", None))


__all__ = ["get_cloud_cluster", "get_cluster_and_pod"]
