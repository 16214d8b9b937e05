"""The one traffic generator: a mix file (benchmark/traffic/<mix>.json)
and a configuration (benchmark/configs/<config>.json) give the plain
inputs of a run.

What a run does is fixed by the configuration: its deployment templates
and every batch or cluster are drawn from the configuration's
`template_seed`, so every run does the same work. The run's `--seed`
draws the order: which batch or sweep comes first, the order of the
pending pods within a batch, and the pods' names.

Mix kinds:
- "provision": `batches` pending batches of `pods` pods (the
  configuration's `pods` when absent) over the templates, each one call
  of the solver's schedule(); with `standing_pods`, against a standing
  cluster that one tick of that many pods built (the cluster is not
  changed between calls).
- "sweep": one standing cluster, built by one tick of the configuration's
  `pods`, under `clusters` sets of pod and node names; each call judges
  `candidates` nodes' sets (singletons, prefixes to `prefix_max`, pairs)
  with one consolidation sweep.

A standing cluster is the plain reference's own tick, with room left on
every node for the largest daemonset reserve of the configuration's
pools; each node then carries its own pool's reserve (gen/sweep.py). The
seconds that tick takes are returned as `reference_s`: they are the
yardstick's, not the program's set-up.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np

from gen import catalog as gc
from gen import pods as gp
from gen import sweep as gs
from reference import common, ffd

KINDS = ("provision", "sweep")


def load_mix(path: str) -> dict:
    with open(path) as f:
        mix = json.load(f)
    if mix.get("kind") not in KINDS:
        raise ValueError(f"{path}: kind must be one of {KINDS}")
    return mix


def _pods(runs, prefix: str, order: np.ndarray) -> List[tuple]:
    """A batch's pods as (template, name), in the pending order `order` gives."""
    flat = [(t, f"{prefix}-{i}") for t, first, n in runs for i in range(first, first + n)]
    return [flat[int(j)] for j in order]


def classes(templates, pods) -> List[common.PodClass]:
    """The reference's classes of (template, name) pods."""
    return common.group([(name, templates[t]["requests"], templates[t]["selector"],
                          templates[t]["tolerations"]) for t, name in pods])


def standing(catalog: common.Catalog, entries, templates, pods, config: dict,
             prefix: str = "node") -> List[dict]:
    """The nodes one plain tick of (template, name) `pods` opens, each in
    its pool with that pool's reserve (gen/sweep.py `cluster`)."""
    reserve: Dict[str, float] = {}
    for pool in config["pools"]:
        for axis, v in pool["overhead"].items():
            reserve[axis] = max(reserve.get(axis, 0.0), v)
    decision = ffd.tick(catalog, classes(templates, pods), g_max=config["g_max"],
                        objective=config["objective"], pools=[ffd.Pool("standing", reserve=reserve)])
    return gs.cluster(entries, decision, {n: t for t, n in pods}, templates, config["pools"],
                      prefix=prefix)


def build(mix: dict, config: dict, seed: int) -> Dict[str, object]:
    """The plain inputs of one run: catalog entries, templates, and the
    per-call inputs in call order (`calls`), plus the standing cluster and
    the seconds its reference tick took (`reference_s`)."""
    fixed = np.random.default_rng(config["template_seed"])
    run = np.random.default_rng(seed)
    salt = int(run.integers(0, 2**31))
    entries = gc.build_catalog()
    templates = gp.templates(fixed, gc.ZONE_NAMES, config["templates"])
    out: Dict[str, object] = {"entries": entries, "templates": templates, "kind": mix["kind"]}
    catalog = common.Catalog(entries)
    out["catalog"] = catalog
    t0 = time.perf_counter()
    if mix["kind"] == "provision":
        nodes = []
        if mix.get("standing_pods"):
            runs = gp.batch(fixed, len(templates), mix["standing_pods"])
            pods = _pods(runs, "standing", np.arange(mix["standing_pods"]))
            nodes = standing(catalog, entries, templates, pods, config)
        out["reference_s"] = time.perf_counter() - t0
        n_pods = mix.get("pods", config["pods"])
        batches = [gp.batch(fixed, len(templates), n_pods) for _ in range(mix["batches"])]
        calls = []
        for b in run.permutation(len(batches)):
            order = run.permutation(n_pods)
            calls.append({"batch": int(b), "pods": _pods(batches[b], f"p{salt}-{b}", order)})
        out["standing"] = nodes
        out["calls"] = calls
        return out
    # one standing cluster (a steady cluster is judged again and again),
    # relabelled for each sweep: the same work under other pod and node names
    runs = gp.batch(fixed, len(templates), config["pods"])
    base = _pods(runs, "p", np.arange(config["pods"]))
    nodes = standing(catalog, entries, templates, base, config)
    out["reference_s"] = time.perf_counter() - t0
    worlds = []
    for c in range(mix["clusters"]):
        rename = {name: f"c{c}-{j}" for (_, name), j in zip(base, fixed.permutation(len(base)))}
        renamed = [dict(n, name=f"c{c}-{n['name']}", pods=[(t, rename[p]) for t, p in n["pods"]],
                        labels={**n["labels"], gc.HOSTNAME_LABEL: f"c{c}-{n['name']}"})
                   for n in nodes]
        worlds.append(gs.steady(renamed, mix["candidates"]))
    # a cluster smaller than the candidate count offers all its nodes
    n_cand = min(len(w["candidates"]) for w in worlds)
    sets = gs.sweep_sets(n_cand, mix["prefix_max"])
    out["calls"] = [{"batch": int(w), "world": worlds[w], "sets": sets}
                    for w in run.permutation(len(worlds))]
    return out
