"""The port's merged multi-pool catalog and masks against the JAX package's.

Both packages build the same pools (tests/test_torch_oracle.py specs) over
their own catalogs: `build_merged` must give the same columns (names,
requirements, capacity, overhead with each pool's daemonset reserve,
offerings) and the same column -> pool map; `first_compat_pool`,
`admitted_pools`, `open_allowed_mask` and `join_allowed_mask` must agree
on the same classes. Tolerance: exact.

`TestOpenMemo` runs one `TorchSolver` over merged ticks of recurring and
new classes: the opening pool it memoises per class row must equal a fresh
`open_allowed_mask` and the JAX package's on every tick, hit or miss.
"""
import copy
from unittest import mock

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import multipool as jmulti
from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import multipool as tmulti
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_oracle import (  # noqa: F401
    CAPTYPE, MV_POOLS, SPOT_OD_POOLS, TAINTED_POOLS, build, fuzz_spec, small_items,
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

POOL_SETS = {"spot-od": SPOT_OD_POOLS, "tainted": TAINTED_POOLS, "arch": MV_POOLS}


def merged(which, spec, items, overhead):
    mod = jmulti if which == "jax" else tmulti
    w = build(which, spec, items)
    overheads = [w.overhead[p.name] for p in w.pools] if overhead else ()
    return w, mod.build_merged(w.pools, w.catalogs, overheads=overheads)


def columns(items_list):
    return [
        (it.name, it.requirements.stable_hash(), it.capacity.to_vector(),
         it.overhead.to_vector(),
         [(o.capacity_type, o.zone, o.price, o.available) for o in it.offerings])
        for it in items_list
    ]


def open_masks(enc, mod, classes, catalog, pools, col_pools, c_pad):
    """(admitted pools, open mask, opening pools) of `classes`, computed from nothing."""
    cs = enc.encode_classes(classes, catalog, c_pad=c_pad)
    compat = enc.compat_matrix(catalog, cs)[: len(classes)]
    fits_one = np.all(catalog.cap[None, :, :] >= cs.req[: len(classes), None, :], axis=-1)
    admitted = [mod.admitted_pools(pc, pools) for pc in classes]
    open_mask, open_pool = mod.open_allowed_mask(
        classes, admitted, col_pools, compat, fits_one, c_pad, catalog.k_pad)
    return admitted, open_mask, open_pool


def masks(which, spec, items):
    enc, mod = (jencode, jmulti) if which == "jax" else (tencode, tmulti)
    w, (items_m, _, col_pools) = merged(which, spec, items, overhead=False)
    classes = enc.group_pods(w.pods)
    catalog = enc.encode_catalog(items_m)
    c_pad = enc.bucket(len(classes), 16)
    admitted, open_mask, open_pool = open_masks(enc, mod, classes, catalog, w.pools, col_pools,
                                                c_pad)
    join_mask = mod.join_allowed_mask(classes, w.pools, col_pools, c_pad, catalog.k_pad)
    first = [mod.first_compat_pool(pc, w.pools) for pc in classes]
    return admitted, open_mask.tobytes(), open_pool, join_mask.tobytes(), first


class TestBuildMerged:
    @pytest.mark.parametrize("overhead", [False, True])
    @pytest.mark.parametrize("pools", list(POOL_SETS))
    def test_columns_equal(self, small_items, pools, overhead):
        spec = fuzz_spec(0, pools=POOL_SETS[pools], overhead=True)
        _, (jm, jo, jc) = merged("jax", spec, small_items, overhead)
        _, (tm, to, tc) = merged("torch", spec, small_items, overhead)
        assert columns(tm) == columns(jm)
        assert [it.name for it in to] == [it.name for it in jo]
        assert tc.dtype == jc.dtype and tc.tobytes() == jc.tobytes()
        assert len(set(tc.tolist())) == len(POOL_SETS[pools])

    def test_partial_overheads_refused(self, small_items):
        spec = fuzz_spec(0, pools=SPOT_OD_POOLS, overhead=True)
        w = build("torch", spec, small_items)
        with pytest.raises(ValueError, match="overheads"):
            tmulti.build_merged(w.pools, w.catalogs, overheads=[w.overhead["spot"]])


class TestMasks:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("pools", list(POOL_SETS))
    def test_masks_equal(self, small_items, pools, seed):
        spec = fuzz_spec(300 + seed, pools=POOL_SETS[pools], n_templates=8)
        want = masks("jax", spec, small_items)
        assert masks("torch", spec, small_items) == want
        assert any(want[0]), "no class was admitted anywhere"


# -- the merged route's opening-pool memo --------------------------------------

_BASE = {"labels": {"app": "twin"}, "req": {"cpu": 500.0, "memory": 512.0 * 2**20}, "count": 2}
# twins, each pair differing only in tolerations or only in requests, and
# a class every pool admits
TWINS = [
    dict(_BASE, name="tol-yes", selector={CAPTYPE: "on-demand"}, tol=True),
    dict(_BASE, name="tol-no", selector={CAPTYPE: "on-demand"}, tol=False),
    dict(_BASE, name="req-small", selector={}, tol=False),
    dict(_BASE, name="req-huge", selector={}, tol=False,
         req={"cpu": 1.0e9, "memory": 512.0 * 2**20}),
    dict(_BASE, name="tol-any", selector={}, tol=True),
]
# template indices a tick's pods come from: all new; all recurring; new
# beside recurring, with each twin after its pair's first; all recurring
TICKS = [[0, 1, 2, 3, 8, 10, 12], [0, 1, 2, 3, 8, 10, 12], [2, 3, 4, 5, 6, 7, 9, 11],
         list(range(13))]


def memo_spec(pools):
    spec = fuzz_spec(41, pools=POOL_SETS[pools], spread=0.0, nodes=0, n_templates=8,
                     overhead=True)
    spec["templates"] += copy.deepcopy(TWINS)
    return spec


def tick_pods(world, templates):
    names = {world.spec["templates"][t]["name"] for t in templates}
    return [p for p in world.pods if p.metadata.name.rsplit("-", 1)[0] in names]


def fresh_open(entry, classes, c_pad):
    """The open mask and opening pools of a tick's classes, computed from nothing."""
    _, mask, pools = open_masks(tencode, tmulti, classes, entry.tensors, entry.pools,
                                entry.col_pools, c_pad)
    return mask, pools


def jax_open(spec, items):
    """pod name -> (opening pool, open mask over the real columns) in the JAX package."""
    w, (items_m, _, col_pools) = merged("jax", spec, items, overhead=bool(spec["overhead"]))
    classes = jencode.group_pods(w.pods)
    _, mask, pools = open_masks(jencode, jmulti, classes, jencode.encode_catalog(items_m),
                                w.pools, col_pools, jencode.bucket(len(classes), 16))
    k_real = col_pools.shape[0]
    return {p.metadata.name: (pools[c], mask[c, :k_real].tobytes())
            for c, pc in enumerate(classes) for p in pc.pods}


def run_ticks(solver, world, ticks):
    """One traced schedule() a tick; per tick what `_merge_masks` saw and gave."""
    seen = []
    orig = TorchSolver._merge_masks

    def spy(entry, classes, class_set, overhead_vec, sp):
        pools = orig(entry, classes, class_set, overhead_vec, sp)
        seen.append(dict(entry=entry, classes=list(classes), c_pad=class_set.c_pad,
                         open=class_set.open_allowed.copy(), pools=list(pools),
                         keys=list(class_set.row_keys), attrs=dict(sp.attributes)))
        return pools

    with mock.patch.object(TorchSolver, "_merge_masks", staticmethod(spy)):
        for templates in ticks:
            with ttracing.trace("tick", force=True):
                solver.schedule(world.scheduler("price"), tick_pods(world, templates))
            assert solver.last_route["path"] == "merged"
    assert len(seen) == len(ticks)
    return seen


def assert_fresh(tick, want_jax=None):
    mask, pools = fresh_open(tick["entry"], tick["classes"], tick["c_pad"])
    assert tick["pools"] == pools
    assert tick["open"].dtype == bool and tick["open"].tobytes() == mask.tobytes()
    if want_jax is not None:
        k_real = tick["entry"].col_pools.shape[0]
        for c, pc in enumerate(tick["classes"]):
            got = (tick["pools"][c], tick["open"][c, :k_real].tobytes())
            assert all(want_jax[p.metadata.name] == got for p in pc.pods)


def pools_by_pod(tick):
    return {p.metadata.name: tick["pools"][c]
            for c, pc in enumerate(tick["classes"]) for p in pc.pods}


class TestOpenMemo:
    @pytest.mark.parametrize("pools", ["spot-od", "tainted"])
    def test_ticks_equal_fresh_and_jax(self, small_items, pools):
        """Over ticks of recurring and new classes the memoised opening
        pools and open masks equal a fresh computation and the JAX
        package's; the span counts a first tick's rows all missed and a
        repeated tick's all hit; twins get rows of their own."""
        spec = memo_spec(pools)
        world = build("torch", spec, small_items)
        want = jax_open(spec, small_items)
        ticks = run_ticks(TorchSolver(device="cpu", g_max=64), world, TICKS)
        for tick in ticks:
            assert_fresh(tick, want)
            assert tick["attrs"]["rows"] == len(tick["classes"])
        assert [t["attrs"]["rows_hit"] for t in ticks[:2]] == [0, len(ticks[1]["classes"])]
        assert 0 < ticks[2]["attrs"]["rows_hit"] < len(ticks[2]["classes"])
        assert ticks[3]["attrs"]["rows_hit"] == len(ticks[3]["classes"])
        assert len({id(t["entry"].open_memo) for t in ticks}) == 1
        # each twin its own row, key and memo entry
        last = ticks[3]
        row = {pc.pods[0].metadata.name.rsplit("-", 1)[0]: c
               for c, pc in enumerate(last["classes"])}
        for a, b in (("tol-yes", "tol-no"), ("req-small", "req-huge")):
            assert row[a] != row[b]
            assert last["keys"][row[a]] != last["keys"][row[b]]
        opened = {name: last["pools"][c] for name, c in row.items()}
        assert opened["req-huge"] == -1 and opened["req-small"] == 0
        assert (opened["tol-yes"], opened["tol-no"]) == ((1, -1) if pools == "tainted" else (1, 1))
        assert len(last["entry"].open_memo) >= len(last["classes"])

    @pytest.mark.parametrize("pools", ["spot-od", "tainted"])
    def test_other_overheads_own_entry(self, small_items, pools):
        """A second scheduler whose spot pool reserves more than any type
        holds gets an entry and memo of its own: its first tick misses
        every row and opens no class in spot, where the first scheduler
        opened some."""
        spec = memo_spec(pools)
        spec2 = dict(spec, overhead=dict(spec["overhead"], spot={"cpu": 1.0e6, "memory": 0.0}))
        solver = TorchSolver(device="cpu", g_max=64)
        first = run_ticks(solver, build("torch", spec, small_items), TICKS[:2])
        second = run_ticks(solver, build("torch", spec2, small_items), TICKS[:2])
        assert second[0]["entry"] is not first[0]["entry"]
        assert second[0]["entry"].open_memo is not first[0]["entry"].open_memo
        assert second[0]["attrs"]["rows_hit"] == 0
        want = jax_open(spec2, small_items)
        for tick in second:
            assert_fresh(tick, want)
        before, after = pools_by_pod(first[1]), pools_by_pod(second[1])
        assert 0 in before.values() and 0 not in after.values()
        if pools == "spot-od":
            assert all(after[n] == 1 for n in before if before[n] == 0)

    @pytest.mark.parametrize("pools", ["spot-od", "tainted"])
    def test_pools_reversed_engages(self, small_items, pools):
        """With `open_allowed_mask` wrapped to try the lightest pool first
        the memo keeps the wrapped answer: every tick, hits included,
        opens as the wrapped mask does and not as the program does."""
        spec = memo_spec(pools)
        world = build("torch", spec, small_items)
        orig = tmulti.open_allowed_mask

        def reversed_mask(classes, admitted_all, *a, **kw):
            return orig(classes, [list(reversed(adm)) for adm in admitted_all], *a, **kw)

        with mock.patch.object(tmulti, "open_allowed_mask", reversed_mask):
            ticks = run_ticks(TorchSolver(device="cpu", g_max=64), world, TICKS[:2])
            for tick in ticks:
                assert_fresh(tick)
        assert ticks[1]["attrs"]["rows_hit"] == len(ticks[1]["classes"])
        for tick in ticks:
            _, straight = fresh_open(tick["entry"], tick["classes"], tick["c_pad"])
            assert any(p == 1 and q == 0 for p, q in zip(tick["pools"], straight))
