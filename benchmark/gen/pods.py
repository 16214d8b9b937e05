"""Pending pods as plain data: deployment templates and the replica batches
drawn over them.

A frozen copy of the port's seeded pod generator
(karpenter_tpu_torch/workload.py `synth_pods`): ~160 deployment templates,
mostly small web pods, some medium services, a few large; ~20 % pinned to
a zone, ~15 % on-demand only, some pinned to an architecture, ~10 %
tolerating a dedicated taint. Replica counts come from a Dirichlet draw
over the templates, so a few deployments hold most pods.

A batch is a list of (template index, first pod number, count) runs; pod
`i` of a batch is named f"{prefix}-{i}", numbered in template order.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gen.catalog import ARCH_LABEL, CAPACITY_TYPE_LABEL, CPU, MEMORY, ON_DEMAND, ZONE_LABEL

CPU_CHOICES = np.array([100, 100, 250, 250, 500, 500, 1000, 2000, 4000, 8000])
MEM_CHOICES = np.array([128, 256, 512, 512, 1024, 2048, 4096, 8192, 16384, 32768])


def templates(rng: np.random.Generator, zones, n_templates: int) -> List[dict]:
    """`n_templates` deployment specs: requests (base units), node
    selector, tolerations as (key, operator, value, effect), labels."""
    sizes = rng.integers(0, len(CPU_CHOICES), size=n_templates)
    out = []
    for t in range(n_templates):
        selector = {}
        u = rng.random()
        if u < 0.20:
            selector[ZONE_LABEL] = str(zones[int(rng.integers(0, len(zones)))])
        elif u < 0.35:
            selector[CAPACITY_TYPE_LABEL] = ON_DEMAND
        elif u < 0.42:
            selector[ARCH_LABEL] = "arm64" if rng.random() < 0.5 else "amd64"
        tolerations = []
        if rng.random() < 0.1:
            tolerations.append(("dedicated", "Exists", "", ""))
        out.append({
            "requests": {CPU: float(CPU_CHOICES[sizes[t]]),
                         MEMORY: float(MEM_CHOICES[sizes[t]]) * 2**20},
            "selector": selector,
            "tolerations": tolerations,
            "labels": {"app": f"app-{t}"},
        })
    return out


def batch(rng: np.random.Generator, n_templates: int, n_pods: int) -> List[Tuple[int, int, int]]:
    """Replica counts of `n_pods` pods over the templates (the Dirichlet
    draw of `synth_pods`), as (template, first pod number, count) runs."""
    weights = rng.dirichlet(np.ones(n_templates) * 0.5)
    counts = np.maximum(1, (weights * n_pods).astype(np.int64))
    # the rounding remainder goes to the largest deployment (synth_pods
    # gives it to the first, which a small first draw can drive below 1)
    counts[int(np.argmax(counts))] += n_pods - counts.sum()
    runs, first = [], 0
    for t in range(n_templates):
        runs.append((t, first, int(counts[t])))
        first += int(counts[t])
    return runs


def pod_names(prefix: str, runs) -> List[str]:
    return [f"{prefix}-{i}" for _, first, n in runs for i in range(first, first + n)]
