"""The port's host [C, N] feasibility (`solver/disrupt/engine.py`
`_node_feasibility`, evaluated once per distinct class row and node
signature) against the JAX package's class-by-node loop, element for
element, in both `class_zone_pins` modes; and the span attributes that say
how far the signatures folded the nodes.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain objects

from karpenter_tpu import apis as japis
from karpenter_tpu import scheduling as jsched
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import oracle as joracle
from karpenter_tpu.solver.disrupt import engine as jengine
from karpenter_tpu_torch import apis as tapis
from karpenter_tpu_torch import scheduling as tsched
from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import oracle as toracle
from karpenter_tpu_torch.solver.disrupt import engine as tengine

ZONE = "topology.kubernetes.io/zone"
CAP = "karpenter.sh/capacity-type"
ARCH = "kubernetes.io/arch"
HOST = "kubernetes.io/hostname"
GEN = "example.com/generation"

PACKAGES = {
    "jax": (japis, jsched, jencode, joracle),
    "torch": (tapis, tsched, tencode, toracle),
}


# -- worlds: plain specs, built alike in either package --------------------------
#
# class: dict(selector={k: v}, terms=[[(key, op, values), ...], ...],
#             tolerations=[(key, op, value, effect), ...], pin=[zones] or None)
# node:  (labels, [(key, effect, value), ...])


def build(pkg, classes, nodes):
    apis, sched, encode, oracle = PACKAGES[pkg]
    out_classes = []
    for i, c in enumerate(classes):
        pod = apis.Pod(
            f"p{i}",
            node_selector=c.get("selector"),
            node_affinity_terms=[
                [sched.Requirement(k, op, vals) for k, op, vals in term]
                for term in c.get("terms", ())
            ],
            tolerations=[sched.Toleration(k, op, v, e) for k, op, v, e in c.get("tolerations", ())],
        )
        pin = c.get("pin")
        reqs = sched.Requirements([sched.Requirement(ZONE, "In", pin)] if pin is not None else [])
        out_classes.append(encode.PodClass(
            pods=[pod], requests=np.zeros(encode.R, dtype=np.float32), requirements=reqs,
            key=(f"c{i}",), env_count=0 if pin is not None else -1))
    out_nodes = [
        oracle.ExistingNode(
            f"n{i}", dict(labels), sched.Resources(),
            taints=[sched.Taint(k, e, v) for k, e, v in taints])
        for i, (labels, taints) in enumerate(nodes)
    ]
    return out_classes, out_nodes


def plain(zone, cap="on-demand", arch="amd64", **more):
    labels = {ZONE: zone, CAP: cap, ARCH: arch}
    labels.update(more)
    return labels


def world_taints():
    nodes = [
        (plain("a"), []),
        (plain("a"), [("gpu", "NoSchedule", "true")]),
        (plain("a"), [("gpu", "NoExecute", "true")]),
        (plain("a"), [("gpu", "PreferNoSchedule", "true")]),
        (plain("b"), [("gpu", "NoSchedule", "false")]),
        (plain("b"), [("gpu", "NoSchedule", "true"), ("team", "NoExecute", "x")]),
        (plain("a"), [("gpu", "NoSchedule", "true")]),
    ]
    classes = [
        {},
        {"tolerations": [("gpu", "Equal", "true", "NoSchedule")]},
        {"tolerations": [("gpu", "Equal", "true", "")]},
        {"tolerations": [("gpu", "Exists", "", "NoExecute")]},
        {"tolerations": [("gpu", "Exists", "", ""), ("team", "Equal", "x", "NoExecute")]},
        {"tolerations": [("gpu", "Equal", "false", "NoSchedule")], "selector": {ZONE: "b"}},
    ]
    return classes, nodes


def world_exists_empty_key():
    nodes = [
        (plain("a"), [("x", "NoSchedule", "1")]),
        (plain("a"), [("y", "NoExecute", "")]),
        (plain("a"), [("x", "NoSchedule", "1"), ("y", "NoExecute", "")]),
        (plain("a"), []),
    ]
    classes = [
        {"tolerations": [("", "Exists", "", "")]},
        {"tolerations": [("", "Exists", "", "NoSchedule")]},
        {"tolerations": [("", "Exists", "", "NoExecute")]},
        {"tolerations": [("x", "Exists", "", "")]},
        {},
    ]
    return classes, nodes


def world_operators():
    nodes = [
        (plain("a", **{GEN: "3"}), []),
        (plain("b", **{GEN: "7"}), []),
        (plain("c", cap="spot", **{GEN: "x"}), []),
        (plain("a", arch="arm64"), []),
        (plain("d", cap="spot", **{GEN: "5"}), []),
    ]
    classes = [
        {"terms": [[(ZONE, "In", ["a", "b"])]]},
        {"terms": [[(ZONE, "NotIn", ["a"])]]},
        {"terms": [[(GEN, "Exists", [])]]},
        {"terms": [[(GEN, "DoesNotExist", [])]]},
        {"terms": [[(GEN, "Gt", ["4"])]]},
        {"terms": [[(GEN, "Lt", ["6"])]]},
        {"terms": [[(GEN, "Gt", ["2"]), (GEN, "Lt", ["6"]), (CAP, "NotIn", ["spot"])]]},
        {"selector": {ARCH: "arm64"}},
        {"selector": {CAP: "spot"}, "terms": [[(GEN, "Gt", ["4"])]]},
    ]
    return classes, nodes


def world_missing_label():
    nodes = [
        (plain("a"), []),
        ({ZONE: "a", ARCH: "amd64"}, []),          # no capacity type
        ({CAP: "spot"}, []),                       # no zone, no arch
        ({}, []),
    ]
    classes = [
        {"selector": {CAP: "on-demand"}},
        {"terms": [[(CAP, "NotIn", ["spot"])]]},
        {"terms": [[(CAP, "DoesNotExist", [])]]},
        {"terms": [[(ZONE, "Exists", [])]]},
        {},
    ]
    return classes, nodes


def world_multi_term():
    nodes = [(plain(z, cap=c, arch=a), []) for z in "abc" for c in ("spot", "on-demand")
             for a in ("amd64", "arm64")]
    classes = [
        {"terms": [[(ZONE, "In", ["a"])], [(CAP, "In", ["spot"])]]},
        {"terms": [[(ZONE, "In", ["b"]), (ARCH, "In", ["arm64"])], [(ZONE, "In", ["c"])]]},
        {"selector": {ARCH: "amd64"},
         "terms": [[(ZONE, "NotIn", ["a", "b"])], [(CAP, "In", ["on-demand"])]]},
        {"terms": [[(ZONE, "In", ["a"])], [(ZONE, "In", ["a"])]]},
    ]
    return classes, nodes


def world_zone_pinned():
    nodes = [
        (plain("a"), []),
        (plain("b"), []),
        ({CAP: "on-demand", ARCH: "amd64"}, []),    # no zone label
        (plain("c", cap="spot"), []),
    ]
    classes = [
        {"pin": ["a"]},
        {"pin": ["b", "c"], "selector": {CAP: "spot"}},
        {"pin": ["a"], "tolerations": [("", "Exists", "", "")]},
        {"selector": {CAP: "on-demand"}},
        {},
    ]
    return classes, nodes


def world_hostname():
    nodes = [(plain("ab"[i % 2], **{HOST: f"h{i}"}), []) for i in range(9)]
    classes = [{"selector": {HOST: "h3"}}, {"terms": [[(HOST, "NotIn", ["h0", "h1"])]]}, {}]
    return classes, nodes


def world_empty_classes():
    return [], [(plain("a"), []), (plain("b"), [("gpu", "NoSchedule", "")])]


def world_empty_nodes():
    return world_operators()[0], []


def world_wave(seed=0, n_nodes=120):
    """Many nodes over a few (zone, capacity type, arch) combinations, a
    few taints, and classes that mostly repeat one another."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        taints = [("dedicated", "NoSchedule", "batch")] if rng.random() < 0.1 else []
        nodes.append((plain(rng.choice(list("abcd")), cap=rng.choice(["spot", "on-demand"]),
                            arch=rng.choice(["amd64", "arm64"]), **{HOST: f"h{i}"}), taints))
    shapes = [
        {},
        {"selector": {CAP: "on-demand"}},
        {"selector": {ARCH: "arm64"}},
        {"terms": [[(ZONE, "In", ["a", "b"])]]},
        {"terms": [[(ZONE, "In", ["c"])], [(CAP, "In", ["spot"])]]},
        {"tolerations": [("dedicated", "Equal", "batch", "NoSchedule")]},
        {"pin": ["d"]},
    ]
    classes = [shapes[int(k)] for k in rng.integers(0, len(shapes), 20)]
    return classes, nodes


WORLDS = {
    "taints": world_taints,
    "exists_empty_key": world_exists_empty_key,
    "operators": world_operators,
    "missing_label": world_missing_label,
    "multi_term": world_multi_term,
    "zone_pinned": world_zone_pinned,
    "hostname": world_hostname,
    "empty_classes": world_empty_classes,
    "empty_nodes": world_empty_nodes,
    "wave_0": lambda: world_wave(0),
    "wave_1": lambda: world_wave(1),
}


def both(world, pins):
    classes, nodes = world
    want = jengine._node_feasibility(*build("jax", classes, nodes), class_zone_pins=pins)
    with ttracing.trace("tick", force=True) as root:
        got = tengine._node_feasibility(*build("torch", classes, nodes), class_zone_pins=pins)
    return want, got, root.attributes


class TestParity:
    @pytest.mark.parametrize("pins", [False, True])
    @pytest.mark.parametrize("name", sorted(WORLDS))
    def test_equals_jax(self, name, pins):
        classes, nodes = world = WORLDS[name]()
        want, got, _ = both(world, pins)
        assert got.dtype == np.bool_ and got.shape == (len(classes), len(nodes))
        assert np.array_equal(got, want)

    def test_worlds_decide_both_ways(self):
        """Each non-empty world has feasible and infeasible pairs, so
        parity is not met by an all-True or all-False answer."""
        for name, make in WORLDS.items():
            want, _, _ = both(make(), True)
            if want.size:
                assert want.any() and not want.all(), name

    def test_pins_gate_only_pinned_classes(self):
        classes, nodes = world = world_zone_pinned()
        off, on = both(world, False)[1], both(world, True)[1]
        pinned = np.array([c.get("pin") is not None for c in classes])
        assert np.array_equal(off[~pinned], on[~pinned])
        assert not on[pinned][:, 2].any()            # the node without a zone label
        assert off[0, 1] and not on[0, 1]            # pinned to a, node in b


class TestSignatures:
    def test_nodes_fold_to_signatures(self):
        """120 nodes over 4 zones x 2 capacity types x 2 arches x one taint:
        at most 32 signatures (the hostname label no class reads is not
        part of one), and the classes fold to their 7 shapes."""
        world = world_wave(0)
        _, _, attrs = both(world, True)
        assert attrs["feas_node_rows"] <= 32 < len(world[1])
        assert attrs["feas_pairs"] == 7 * attrs["feas_node_rows"]

    def test_hostname_selector_makes_every_node_its_own_signature(self):
        world = world_hostname()
        _, _, attrs = both(world, False)
        assert attrs["feas_node_rows"] == len(world[1])
        assert attrs["feas_pairs"] == len(world[0]) * len(world[1])

    def test_taints_split_signatures(self):
        classes, nodes = [{}], [(plain("a"), []), (plain("a"), []),
                                (plain("a"), [("x", "NoSchedule", "")])]
        _, got, attrs = both((classes, nodes), False)
        assert attrs["feas_node_rows"] == 2 and attrs["feas_pairs"] == 2
        assert got.tolist() == [[True, True, False]]


class TestPackFeasibilitySpan:
    def test_wave_like_tick(self):
        """A solve against 64 standing nodes over 8 (zone, capacity type)
        pairs: the tick's `pack_feasibility` span carries the folded
        counts, and the decision equals that of the untraced solve."""
        from karpenter_tpu_torch import workload
        from karpenter_tpu_torch.apis import NodePool, Pod
        from karpenter_tpu_torch.scheduling import Resources
        from karpenter_tpu_torch.solver.service import TorchSolver

        items = workload.build_catalog_items()[::4]
        zones = workload.ZONES[:4]
        nodes = [
            toracle.ExistingNode(
                f"n{i}", plain(zones[i % 4], cap=("spot", "on-demand")[i // 4 % 2], **{HOST: f"n{i}"}),
                tsched.Resources({"cpu": "8", "memory": "32Gi", "pods": "110"}),
                used=tsched.Resources({"cpu": "7", "memory": "30Gi", "pods": "20"}))
            for i in range(64)
        ]
        selectors = [{}, {CAP: "on-demand"}, {ZONE: zones[1]}, {ZONE: zones[2], CAP: "spot"}]
        pods = [Pod(f"p{i}", requests=Resources({"cpu": f"{250 * (1 + i % 3)}m", "memory": "256Mi"}),
                    node_selector=selectors[i % 4]) for i in range(48)]
        ts = TorchSolver(device="cpu", g_max=64)
        plain_result = ts.solve(NodePool("default"), items, pods, existing_nodes=nodes)
        with ttracing.trace("tick", force=True) as root:
            traced_result = ts.solve(NodePool("default"), items, pods, existing_nodes=nodes)
        assert traced_result.existing_assignments == plain_result.existing_assignments
        assert plain_result.existing_assignments       # some pods land on the standing nodes
        stack, found = [root], []
        while stack:
            sp = stack.pop()
            found += [sp] if sp.name == "pack_feasibility" else []
            stack.extend(sp.children)
        (span,) = found
        attrs = span.attributes
        assert attrs["nodes"] == 64 and attrs["feas_node_rows"] == 8
        # 12 classes (4 selectors x 3 sizes) fold to their 4 selectors
        assert attrs["classes"] == 12 and attrs["feas_pairs"] == 4 * 8
