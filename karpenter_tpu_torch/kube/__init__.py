"""The apiserver bus: `KubeClient` and `KubeCluster`.

Copy of karpenter_tpu/kube/__init__.py, imports rewritten to the port's.
"""
from karpenter_tpu_torch.kube.client import KubeClient, KubeConfig, ApiError, Conflict, NotFound
from karpenter_tpu_torch.kube.cluster import KubeCluster

__all__ = ["KubeClient", "KubeConfig", "KubeCluster", "ApiError", "Conflict", "NotFound"]
