"""The per-entry table (obs/jitstats.py) and the warm-up half of TorchSolver
against the JAX package's (karpenter_tpu/obs/jitstats.py, TPUSolver.warm),
on the CPU.

- probes installed in both packages: over the same ticks (tick 1, tick 2
  over existing nodes, a convex tick, a consolidation sweep) the dispatch
  counts per entry are equal wherever both packages register the entry
  and dispatch it from the host (the JAX `ffd_solve_fused` calls
  `ffd_solve_compact` inside its trace, so the JAX probe counts that one
  per trace);
- `table()` has the JAX columns; the `aot` columns move only under the
  warm-up ladder; armed dispatches bypass the probes, as the JAX AOT
  executables do;
- `warm()` and `auto_warm` cover `WARM_C_PADS` (the JAX tuple), and the
  unwarmed-bucket log fires once per new key, as TPUSolver's does.
"""
import threading

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain objects
import torch

from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.apis import Pod as JPod
from karpenter_tpu.obs import jitstats as jjitstats
from karpenter_tpu.solver.disrupt import DisruptEngine as JEngine
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics, workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.apis import Pod as TPod
from karpenter_tpu_torch.obs import jitstats
from karpenter_tpu_torch.solver import encode, ffd
from karpenter_tpu_torch.solver.disrupt import DisruptEngine as TEngine
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import (  # noqa: F401
    jax_nodes, node_specs, port_items, port_nodes,
)
from tests.test_torch_quality import both_pods

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
# registered in both packages, dispatched from the host in both
NESTED_IN_JAX = {"solver.ffd.ffd_solve_compact"}


def below_package(entry: str) -> str:
    return entry.split(".", 1)[1]


def shared_entries():
    from karpenter_tpu.analysis.checkers.jax_discipline import JIT_ENTRY_FUNCTIONS as jentries

    def names(reg, pkg):
        return {f"{mod[len(pkg) + 1:]}.{fn}" for mod, fns in reg.items() for fn in fns}

    return (names(jentries, "karpenter_tpu")
            & names(jitstats.JIT_ENTRY_FUNCTIONS, "karpenter_tpu_torch")) - NESTED_IN_JAX


@pytest.fixture
def probes():
    """Probes in both packages for the test, then the port's removed
    again if it was not installed before (the JAX package keeps its own,
    as its Operator does)."""
    was = jitstats.installed()
    jitstats.install()
    jjitstats.install()
    jitstats.reset()
    jjitstats.reset()
    yield
    if not was:
        jitstats.uninstall()


def dispatches(table):
    return {below_package(e): row["dispatches"] for e, row in table.items()
            if "." in e and row["dispatches"]}


class TestTable:
    def test_registry_is_the_jax_one_plus_the_kernel_wrappers(self):
        shared = shared_entries()
        assert {"solver.ffd.ffd_solve_fused", "solver.ffd.ffd_solve",
                "solver.disrupt.kernel.disrupt_repack", "solver.disrupt.kernel.disrupt_replace",
                "solver.bound.fractional_price_bound", "solver.convex.relax.convex_relax"} == shared
        port = {f"{m}.{f}" for m, fs in jitstats.JIT_ENTRY_FUNCTIONS.items() for f in fs}
        assert "karpenter_tpu_torch.solver.kernels.ffd_scan.fused_scan" in port
        assert "karpenter_tpu_torch.solver.kernels.disrupt_repack.disrupt_repack" in port

    def test_dispatch_counts_equal_per_shared_entry(self, probes, catalog_items, port_items):  # noqa: F811
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        jcx, tcx = TPUSolver(g_max=G, tier="convex"), TorchSolver(device="cpu", g_max=G,
                                                                   tier="convex")
        jp, tp = both_pods(1)
        js.solve(JNodePool("default"), catalog_items, jp)
        tick1 = ts.solve(TNodePool("default"), port_items, tp)
        specs = node_specs(workload.nodes_from_result(tick1))
        for _name, _labels, _alloc, used, _taints in specs[:6]:
            for k in used:
                used[k] *= 0.5
        jp2 = [JPod(f"w{p.metadata.name}", requests=p.requests) for p in jp]
        tp2 = [TPod(f"w{p.metadata.name}", requests=p.requests) for p in tp]
        js.solve(JNodePool("default"), catalog_items, jp2, existing_nodes=jax_nodes(specs))
        ts.solve(TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs))
        jcx.solve(JNodePool("default"), catalog_items, jp)
        tcx.solve(TNodePool("default"), port_items, tp)
        spec = workload.rampdown_sweep_spec(tick1, np.random.default_rng(1), n_cand=6)
        nodes, sets = workload.sweep_world(spec)
        pools, ovh = workload.sweep_pools("spot-od")
        TEngine(solver=ts).evaluate(nodes, sets, pools=pools,
                                    catalogs={p.name: port_items for p in pools},
                                    daemon_overhead=ovh)
        jspec_nodes, jsets = workload_jax_sweep(spec)
        jpools, jovh = jax_sweep_pools()
        JEngine(solver=js).evaluate(jspec_nodes, jsets, pools=jpools,
                                    catalogs={p.name: catalog_items for p in jpools},
                                    daemon_overhead=jovh)
        shared = shared_entries()
        got = {e: n for e, n in dispatches(jitstats.table()).items() if e in shared}
        want = {e: n for e, n in dispatches(jjitstats.table()).items() if e in shared}
        assert got == want
        assert got["solver.ffd.ffd_solve_fused"] == 3 and got["solver.convex.relax.convex_relax"] == 1
        assert got["solver.disrupt.kernel.disrupt_repack"] >= 2
        # the port's kernel wrappers: one launch (a plain run here) per call
        port = dispatches(jitstats.table())
        assert port["solver.kernels.ffd_scan.fused_scan"] == 3
        assert port["solver.kernels.disrupt_repack.disrupt_repack"] == got[
            "solver.disrupt.kernel.disrupt_repack"]

    def test_table_has_the_jax_columns(self, probes, port_items):  # noqa: F811
        _, tp = both_pods(2)
        TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, tp)
        jjitstats.note_aot("test_entry_family", 0.25)
        jitstats.note_aot("test_entry_family", 0.25)
        want_cols = set(jjitstats.table()["test_entry_family"])
        row = jitstats.table()["test_entry_family"]
        assert set(row) == want_cols
        assert row["aot_compiles"] == 1 and row["aot_compile_ms"] == 250.0 and row["compiles"] == 0
        fused = jitstats.table()["karpenter_tpu_torch.solver.ffd.ffd_solve_fused"]
        assert {"dispatches", "dispatch_ms", "compiles", "compile_ms", "cache_size"} <= set(fused)
        assert fused["dispatches"] == 1 and fused["dispatch_ms"] > 0.0
        # no library loads on the CPU: nothing to attribute
        assert fused["compiles"] == 0
        assert set(jitstats.cache_stats()) == set(jjitstats.cache_stats()) == {
            "hits", "misses", "bytes"}

    def test_aot_columns_move_only_under_the_ladder(self, probes, port_items):  # noqa: F811
        ts = TorchSolver(device="cpu", g_max=G)
        _, tp = both_pods(3)
        ts.solve(TNodePool("default"), port_items, tp)
        assert not any("aot_compiles" in row for row in jitstats.table().values())
        mgr = ts.enable_aot(None, duty=1.0, pads=(32,))
        entry = ts._catalog(port_items)
        mgr.run_plan(entry, throttle=False)
        assert mgr.drain(300)
        table = jitstats.table()
        aot_rows = {e: row["aot_compiles"] for e, row in table.items() if "aot_compiles" in row}
        assert set(aot_rows) == {"ffd_solve_fused", "fractional_price_bound", "disrupt_repack",
                                 "disrupt_replace"}
        fused_before = table["karpenter_tpu_torch.solver.ffd.ffd_solve_fused"]["dispatches"]
        ts.solve(TNodePool("default"), port_items, tp)
        after = jitstats.table()
        assert {e: row["aot_compiles"] for e, row in after.items()
                if "aot_compiles" in row} == aot_rows
        # the armed fused solve is not a probed dispatch (as a JAX AOT executable)
        assert after["karpenter_tpu_torch.solver.ffd.ffd_solve_fused"]["dispatches"] == fused_before
        assert after["karpenter_tpu_torch.solver.ffd.ffd_solve_fused"]["cache_size"] >= 1

    def test_install_is_idempotent_and_uninstall_restores(self):
        from karpenter_tpu_torch.solver import ffd as tffd

        was = jitstats.installed()
        jitstats.uninstall()
        real = tffd.ffd_solve_fused
        # every registered entry, and the entries booked on a registered row
        registered = {(m, f) for m, fs in jitstats.JIT_ENTRY_FUNCTIONS.items() for f in fs}
        assert jitstats.install() == len(registered | set(jitstats.BOOKED_AS))
        assert jitstats.install() == 0 and jitstats.installed()
        assert tffd.ffd_solve_fused is not real and tffd.ffd_solve_fused.__wrapped__ is real
        assert jitstats.original("karpenter_tpu_torch.solver.ffd", "ffd_solve_fused") is real
        jitstats.uninstall()
        assert tffd.ffd_solve_fused is real and not jitstats.installed()
        if was:
            jitstats.install()

    def test_describe_wire_carries_the_table(self, probes, port_items):  # noqa: F811
        ts = TorchSolver(device="cpu", g_max=G)
        _, tp = both_pods(4)
        ts.solve(TNodePool("default"), port_items, tp)
        doc = ts.describe_wire()
        assert doc["jit_entries"]["karpenter_tpu_torch.solver.ffd.ffd_solve_fused"][
            "dispatches"] == 1


def workload_jax_sweep(spec):
    """The port's sweep spec as the JAX package's nodes and sets."""
    from tests.test_torch_consolidate import jax_sweep

    return jax_sweep(spec)


def jax_sweep_pools():
    from tests.test_torch_consolidate import sweep_pools

    return sweep_pools("jax", "spot-od")


# -- warm-up --------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.lines = []

    def info(self, msg, **kw):
        self.lines.append((msg, kw))

    def warning(self, msg, **kw):
        self.lines.append((msg, kw))

    def unwarmed(self):
        return [kw["c_pad"] for msg, kw in self.lines if "class-count bucket" in msg]


class TestWarm:
    def test_warm_c_pads_are_the_jax_buckets(self):
        assert TorchSolver.WARM_C_PADS == TPUSolver.WARM_C_PADS == (16, 32, 64, 128, 256, 512, 1024)

    def test_warm_covers_every_bucket(self, port_items):  # noqa: F811
        items = port_items[::4]
        ts = TorchSolver(device="cpu", g_max=16)
        d0 = metrics.SOLVER_KERNEL_DISPATCHES.value(entry="ffd_solve_fused", impl="plain")
        ts.warm(items)
        entry = ts._catalog(items)
        assert ts._warmed_pads == {TorchSolver._warm_key(cp, entry)
                                   for cp in TorchSolver.WARM_C_PADS}
        assert metrics.SOLVER_KERNEL_DISPATCHES.value(
            entry="ffd_solve_fused", impl="plain") - d0 == len(TorchSolver.WARM_C_PADS)

    def test_auto_warm_runs_on_each_staged_catalog(self, port_items):  # noqa: F811
        items = port_items[::4]
        ts = TorchSolver(device="cpu", g_max=16, auto_warm=True)
        before = set(threading.enumerate())
        entry = ts._catalog(items)
        warmers = [t for t in threading.enumerate()
                   if t not in before and t.name == "torchsolver-warm"]
        assert len(warmers) == 1
        warmers[0].join(300)
        assert ts._warmed_pads == {TorchSolver._warm_key(cp, entry)
                                   for cp in TorchSolver.WARM_C_PADS}
        # a catalog already staged does not warm again
        ts._catalog(items)
        assert not [t for t in threading.enumerate() if t.name == "torchsolver-warm"
                    and t not in before and t is not warmers[0]]
        # nor does a solver on the wire
        wire = TorchSolver(device="cpu", g_max=16, auto_warm=True, client=object(), breaker=False)
        wire.warm(items)
        assert not wire._warmed_pads

    def test_unwarmed_bucket_logs_once_per_new_key(self, catalog_items, port_items):  # noqa: F811
        """Warm c_pad 16 only; ticks at c_pad 32 log once, again not; a
        new catalog geometry logs again -- in both packages alike."""
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        js.warm(catalog_items, c_pads=(16,))
        ts.warm(port_items, c_pads=(16,))
        jrec, trec = _Recorder(), _Recorder()
        js.log, ts.log = jrec, trec
        for seed in (1, 2):
            jp, tp = both_pods(seed)            # 28 classes: c_pad 32
            js.solve(JNodePool("default"), catalog_items, jp)
            ts.solve(TNodePool("default"), port_items, tp)
        jp, tp = both_pods(3, n=12)             # 12 classes: c_pad 16, warmed
        js.solve(JNodePool("default"), catalog_items, jp)
        ts.solve(TNodePool("default"), port_items, tp)
        assert trec.unwarmed() == jrec.unwarmed() == [32]
        # another catalog geometry: its c_pad 16 was never warmed
        jp, tp = both_pods(4, n=12)
        js.solve(JNodePool("default"), catalog_items[::4], jp)
        ts.solve(TNodePool("default"), port_items[::4], tp)
        assert trec.unwarmed() == jrec.unwarmed() == [32, 16]

    def test_warm_entry_keys_by_geometry(self, port_items):  # noqa: F811
        ts = TorchSolver(device="cpu", g_max=16)
        a, b = ts._catalog(port_items), ts._catalog(port_items[::4])
        assert TorchSolver._warm_key(16, a) != TorchSolver._warm_key(16, b)
        assert TorchSolver._warm_key(16, a) == (16, a.tensors.k_pad, a.offsets, a.words)
        cs = encode.encode_classes([], a.tensors, c_pad=16)
        assert ffd.make_inputs_staged(a.staged, cs, packed_masks=True).req.shape == (16, encode.R)
