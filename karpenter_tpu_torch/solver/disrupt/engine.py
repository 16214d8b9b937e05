"""Host side of the repack: the class-on-node feasibility matrix.

Copy of `_node_feasibility` from karpenter_tpu/solver/disrupt/engine.py.
The candidate-set consolidation engine (`DisruptEngine`) belongs to the
consolidation slice.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.scheduling import tolerates_all
from karpenter_tpu_torch.solver import encode
from karpenter_tpu_torch.solver.oracle import ExistingNode


def _node_feasibility(
    classes: Sequence[encode.PodClass], nodes: Sequence[ExistingNode],
    class_zone_pins: bool = False,
) -> np.ndarray:
    """[C, N] bool: a pod of class c may land on node n (labels + taints).
    Mirrors the oracle's existing-node compatibility gate. With
    `class_zone_pins`, a SPREAD SUB-CLASS's pinned zone (the split pass
    marks these env_count == 0) additionally gates the node's zone.
    Ordinary classes stay pool-agnostic: a pool-derived zone requirement
    must not block packing onto live capacity the oracle would use."""
    C, N = len(classes), len(nodes)
    out = np.zeros((C, N), dtype=bool)
    for ci, pc in enumerate(classes):
        pod = pc.pods[0]
        zreq = (
            pc.requirements.get(wk.ZONE_LABEL)
            if class_zone_pins and pc.env_count == 0
            else None
        )
        for ni, node in enumerate(nodes):
            if not tolerates_all(pod.tolerations, node.taints):
                continue
            if zreq is not None:
                node_zone = node.labels.get(wk.ZONE_LABEL)
                if node_zone is None or not zreq.matches(node_zone):
                    continue
            out[ci, ni] = any(
                alt.matches_labels(node.labels) for alt in pod.scheduling_requirements()
            )
    return out
