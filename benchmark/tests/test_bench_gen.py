"""The frozen generators reproduce from a seed, and still make what the
port's own generators make."""
import json
from pathlib import Path

import numpy as np

from gen import catalog as gc
from gen import pods as gp
from gen import sweep as gs
from gen import traffic

HERE = Path(__file__).resolve().parent
SMALL = json.loads((HERE / "data" / "np1-small.json").read_text())
SMALL_SWEEP = json.loads((HERE / "data" / "spot-od-small.json").read_text())
BURST = traffic.load_mix(str(HERE.parent / "traffic" / "burst.json"))
STEADY = traffic.load_mix(str(HERE.parent / "traffic" / "steady.json"))


def test_catalog_is_the_ports():
    from karpenter_tpu_torch import workload

    items = workload.build_catalog_items()
    entries = gc.build_catalog()
    assert [e["name"] for e in entries] == [it.name for it in items]
    for e, it in zip(entries, items):
        assert gc.allocatable(e) == dict(it.allocatable().items())
        assert [(o.capacity_type, o.zone, o.zone_id, o.price) for o in it.offerings] == e["offerings"]
        labels = it.requirements.labels()
        assert all(labels.get(k) == v for k, v in e["labels"].items())


def test_templates_and_batches():
    """synth_pods' mix: sizes from its choices, a zone, on-demand or arch
    selector on some, the dedicated toleration on some; every deployment
    has a replica; the same seed gives the same draw."""
    tpl = gp.templates(np.random.default_rng(3), gc.ZONE_NAMES, 160)
    assert tpl == gp.templates(np.random.default_rng(3), gc.ZONE_NAMES, 160)
    for t in tpl:
        assert t["requests"]["cpu"] in gp.CPU_CHOICES
        assert t["requests"]["memory"] / 2**20 in gp.MEM_CHOICES
        assert set(t["selector"]) <= {gc.ZONE_LABEL, gc.CAPACITY_TYPE_LABEL, gc.ARCH_LABEL}
        assert t["tolerations"] in ([], [("dedicated", "Exists", "", "")])
    kinds = [tuple(t["selector"]) for t in tpl]
    assert kinds.count(()) > 80 and kinds.count((gc.ZONE_LABEL,)) > 10
    runs = gp.batch(np.random.default_rng(4), 160, 50000)
    assert sum(n for _, _, n in runs) == 50000 and min(n for _, _, n in runs) >= 1
    assert [f for _, f, _ in runs] == list(np.cumsum([0] + [n for _, _, n in runs])[:-1])


def test_build_reproduces_from_the_seed():
    a = traffic.build(BURST, SMALL, 2**31 + 5)
    b = traffic.build(BURST, SMALL, 2**31 + 5)
    assert [c["pods"] for c in a["calls"]] == [c["pods"] for c in b["calls"]]
    c = traffic.build(BURST, SMALL, 11)
    assert [x["pods"] for x in c["calls"]] != [x["pods"] for x in a["calls"]]


def test_every_seed_does_the_same_work():
    """A seed draws the order and the names; the batches are the config's."""
    a = traffic.build(BURST, SMALL, 1)
    b = traffic.build(BURST, SMALL, 2)

    def work(inp):
        return sorted(tuple(sorted(np.bincount([t for t, _ in c["pods"]], minlength=40)))
                      for c in inp["calls"])

    assert work(a) == work(b)
    assert len(a["calls"]) == BURST["batches"]
    assert all(len(c["pods"]) == SMALL["pods"] for c in a["calls"])


def test_sweep_worlds():
    inp = traffic.build(STEADY, SMALL_SWEEP, 9)
    assert len(inp["calls"]) == STEADY["clusters"]
    for call in inp["calls"]:
        w = call["world"]
        assert len(w["candidates"]) == len(w["pods"]) <= STEADY["candidates"]
        names = {n["name"] for n in w["nodes"]}
        assert set(w["candidates"]) <= names
        # steady: every node keeps all its pods, and its used capacity counts them
        for node in w["nodes"]:
            assert node["used"]["pods"] >= 1
    n = min(len(c["world"]["candidates"]) for c in inp["calls"])
    assert all(c["sets"] == gs.sweep_sets(n, STEADY["prefix_max"]) for c in inp["calls"])


def test_sweep_sets_shape():
    sets = gs.sweep_sets(256, 32)
    assert len(sets) == 256 + 31 + 14
    assert (0, 1) not in sets[256 + 31:]
