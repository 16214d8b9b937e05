"""The plain references on hand-worked cases, the control's precision,
and the frozen roofline counts."""
import numpy as np
import pytest

from gen.catalog import ARCH_LABEL, CAPACITY_TYPE_LABEL, ZONE_LABEL
from reference import common, ffd, sweep
from roofline import counts

Z = "zone-a"


def entry(name, cpu, mem_mib, pods, price, captype="on-demand", arch="amd64"):
    return {"name": name, "labels": {ARCH_LABEL: arch},
            "capacity": {"cpu": float(cpu), "memory": float(mem_mib * 2**20), "pods": float(pods)},
            "overhead": {}, "offerings": [(captype, Z, "z1", price)]}


CATALOG = common.Catalog([entry("small", 2000, 4096, 10, 1.0), entry("big", 4000, 8192, 20, 1.5)])
REQ = {"cpu": 1000.0, "memory": 1024.0 * 2**20}


def classes(n, req=REQ, selector=None):
    return common.group([(f"p{i}", req, selector or {}, []) for i in range(n)])


def test_three_pods_open_one_big_node():
    """3 pods of 1 cpu: small holds 2 (2 nodes, $2.0), big holds 4 (1 node,
    $1.5); both serve at least half the largest fit, so the price envelope
    picks big, and one node holds all three."""
    d = ffd.tick(CATALOG, classes(3), g_max=8)
    assert d["nodes"] == [(("big",), ("p0", "p1", "p2"), frozenset({Z}),
                           frozenset({"reserved", "spot", "on-demand"}))]
    assert d["unschedulable"] == []


def test_fit_objective_keeps_every_type_that_holds():
    d = ffd.tick(CATALOG, classes(3), g_max=8, objective="fit")
    # fit opens with the largest fit (4 a node) and keeps each type that holds 3
    assert [n[0] for n in d["nodes"]] == [("big",)]


def test_unschedulable_when_nothing_fits():
    d = ffd.tick(CATALOG, classes(2, req={"cpu": 8000.0, "memory": 2**30}), g_max=8)
    assert d["nodes"] == [] and d["unschedulable"] == ["p0", "p1"]


def test_selector_on_a_missing_arch():
    d = ffd.tick(CATALOG, classes(1, selector={ARCH_LABEL: "arm64"}), g_max=8)
    assert d["unschedulable"] == ["p0"]


def test_compare_counts_each_difference():
    want = ffd.tick(CATALOG, classes(3), g_max=8)
    got = {"nodes": [(("small",), ("p0", "p1"), frozenset({Z}), frozenset({"on-demand"}))],
           "unschedulable": []}
    out = ffd.compare(CATALOG, got, want, 3)
    assert out["nodes_differ"] == 1 and out["pods_not_once"] == 1
    assert out["price_gap"] == pytest.approx(abs(1.0 - 1.5) / 1.5)
    assert ffd.compare(CATALOG, want, want, 3) == {
        "existing_differ": 0.0, "nodes_differ": 0.0, "pods_not_once": 0.0, "price_gap": 0.0}


def test_pack_existing_first_fit_in_node_order():
    """Two standing nodes with room for 1 and 2 pods: three pods go 1 + 2
    in node order, and no new node opens."""
    alloc = {"cpu": 4000.0, "memory": 8192.0 * 2**20, "pods": 20.0}
    nodes = [{"name": f"n{i}", "labels": {ARCH_LABEL: "amd64"}, "alloc": alloc,
              "used": {"cpu": used, "pods": 1.0}} for i, used in enumerate((3000.0, 2000.0))]
    cls = classes(3)
    where, placed = ffd.pack_existing(cls, nodes)
    assert where == {"p0": "n0", "p1": "n1", "p2": "n1"} and placed.tolist() == [3]
    assert ffd.tick(CATALOG, cls, g_max=8, placed=placed)["nodes"] == []


# two weighted pools over types offered on-demand and spot: spot first
# (weight 100) with a 500-millicore daemonset reserve, on-demand after
def entry2(name, cpu, price_od, price_spot):
    e = entry(name, cpu, 8192, 20, price_od)
    e["offerings"].append(("spot", Z, "z1", price_spot))
    return e


CATALOG2 = common.Catalog([entry2("small", 2000, 1.0, 0.4), entry2("big", 4000, 1.5, 0.6)])
SPOT = {"name": "spot", "weight": 100, "captype": "spot", "overhead": {"cpu": 500.0}}
OD = {"name": "on-demand", "weight": 10, "captype": "on-demand", "overhead": {}}
OD_SEL = {CAPACITY_TYPE_LABEL: "on-demand"}


def pods(prefix, n, cpu, selector=None, tolerations=()):
    return [(f"{prefix}{i}", {"cpu": cpu, "memory": 1024.0 * 2**20}, selector or {},
             list(tolerations)) for i in range(n)]


def test_weighted_pools_open_join_and_record_the_pool():
    """P (1 cpu, pinned on-demand) opens in the lighter pool: small holds 2
    at $1.0. U (0.5 cpu, either capacity type) comes later: two pods join
    P's on-demand node, the third opens in the heavier spot pool, where
    small holds 3 under the reserve at $0.4."""
    cls = common.group(pods("p", 1, 1000.0, OD_SEL) + pods("u", 3, 500.0))
    pools = ffd.pools({"pools": [OD, SPOT]})
    assert [q.name for q in pools] == ["spot", "on-demand"]
    d = ffd.tick(CATALOG2, cls, g_max=8, pools=pools)
    assert d["nodes"] == [
        (("small",), ("p0", "u0", "u1"), frozenset({Z}), frozenset({"on-demand"})),
        (("small",), ("u2",), frozenset({Z}), frozenset({"spot"})),
    ]
    assert d["pools"] == ["on-demand", "spot"] and d["unschedulable"] == []
    assert d["columns"] == 4
    # the same nodes in swapped pools both differ; a node is priced in its pool
    assert ffd.compare(CATALOG2, dict(d, pools=["spot", "on-demand"]), d, 4, pools)[
        "nodes_differ"] == 2
    assert ffd.compare(CATALOG2, d, d, 4, pools)["nodes_differ"] == 0
    either = (("small",), ("u2",), frozenset({Z}), frozenset({"spot", "on-demand"}))
    assert [ffd.node_price(CATALOG2, either, ct) for ct in ("", "spot", "on-demand")] == [
        0.4, 0.4, 1.0]


def test_a_pools_reserve_changes_the_type_a_node_keeps():
    """2 pods of 1 cpu: without a reserve small holds both ($0.4, one
    node); the spot pool's 0.5 cpu reserve leaves small room for one, so
    big (3 a node, $0.6) serves them cheaper and is the type kept."""
    cls = common.group(pods("v", 2, 1000.0))
    bare = ffd.tick(CATALOG2, cls, g_max=8, pools=ffd.pools({"pools": [dict(SPOT, overhead={})]}))
    reserved = ffd.tick(CATALOG2, cls, g_max=8, pools=ffd.pools({"pools": [SPOT]}))
    assert [n[0] for n in bare["nodes"]] == [("small",)]
    assert [n[0] for n in reserved["nodes"]] == [("big",)]
    assert bare["pools"] == reserved["pools"] == ["spot"]


def test_a_tainted_pool_opens_only_for_classes_that_tolerate_it():
    tainted = dict(SPOT, taints=[["dedicated", "", "NoSchedule"]])
    pools = ffd.pools({"pools": [tainted, OD]})
    toleration = ("dedicated", "Exists", "", "")
    cls = common.group(pods("a", 1, 1000.0, tolerations=[toleration]) + pods("b", 1, 900.0))
    d = ffd.tick(CATALOG2, cls, g_max=8, pools=pools)
    assert d["pools"] == ["spot", "on-demand"]
    assert [n[1] for n in d["nodes"]] == [("a0",), ("b0",)]
    assert not ffd.tolerates([], [("dedicated", "", "NoSchedule")])
    assert ffd.tolerates([], [("dedicated", "", "PreferNoSchedule")])


def world(used_n1_cpu):
    alloc = {"cpu": 4000.0, "memory": 8192.0 * 2**20, "pods": 20.0}
    node = lambda name, cpu: {  # noqa: E731
        "name": name, "labels": {ARCH_LABEL: "amd64", ZONE_LABEL: Z, CAPACITY_TYPE_LABEL: "on-demand"},
        "alloc": alloc, "used": {"cpu": cpu, "memory": 1024.0 * 2**20, "pods": 1.0}}
    return {"nodes": [node("n0", 1000.0), node("n1", used_n1_cpu), node("n2", 4000.0)],
            "candidates": ["n0"], "pods": [[(0, "p0")]]}


TEMPLATES = [{"requests": REQ, "selector": {}, "tolerations": [], "labels": {}}]
POOLS = [("od", "on-demand", 10, {}), ("spot", "spot", 100, {})]


def test_sweep_deletes_when_the_pod_fits_a_survivor():
    v = sweep.sweep(CATALOG, TEMPLATES, world(2000.0), [(0,)], POOLS)
    assert v == [(True, 0, float("inf"), float("inf"), None, None)]


def test_sweep_replaces_with_the_cheapest_type_that_holds_the_leftover():
    """n1 and n2 are full: the pod is left over. The spot pool (weight 100)
    comes first but the catalog offers no spot; the on-demand pool's
    cheapest type holding 1 cpu is small at $1.0."""
    v = sweep.sweep(CATALOG, TEMPLATES, world(4000.0), [(0,)], POOLS)
    assert v == [(False, 1, 1.0, 1.0, "small", "od")]


def test_bfloat16_rounds_to_eight_bits_of_mantissa():
    p = common.Precision("bfloat16")
    assert p.q(np.float32(3850.0)) == np.float32(3856.0)
    assert p.q(np.float32(257.0)) == np.float32(256.0)
    assert p.q(np.float32(np.inf)) == np.inf
    assert common.Precision().q(np.float32(3850.0)) == np.float32(3850.0)


def test_ffd_scan_counts_by_hand():
    # one class with a type, no open nodes: 6 ops per column; K pads 100 -> 128
    ms = counts.ffd_scan_ms([(0, 0, True)], 1, 100, 9, 8)
    bytes_in = 4 * (9 + 3 * 4 + 2 * 128 + 3) + 15 * 4 * (2 * 4 + 1) + 4 * (128 * 9 + 128)
    bytes_out = 4 * (16 * 8 + 16 + 1 + 8 * 4 + 8)
    assert ms == pytest.approx(max((bytes_in + bytes_out) / 3.35e12, 768 / 67e12) * 1e3)


def test_repack_counts_by_hand():
    walked = np.array([[3, 0], [1, 0]])
    member = np.array([[2, 0], [1, 0]])
    ms = counts.disrupt_repack_ms(walked, member, 5, 2, 2, 9, stepping=walked > 0)
    n_ops = 4 * (3 * 9 + 4)
    bytes_ = 4 * 16 * 9 + 4 * 8 * 9 + 4 * 8 * 8 + 1 * 16 + 2 * 16 + 4 * 8 * 8
    assert ms == pytest.approx(max(bytes_ / 3.35e12, n_ops / 67e12) * 1e3)
