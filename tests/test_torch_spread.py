"""The port's zone-spread split pass against the JAX package's.

Both packages group the same world (tests/test_torch_oracle.py
`fuzz_spec`), encode it against their own catalog and run
`split_zone_spread` with and without seeded zone counts; the sub-classes
(their pods, requirements, zone pins, keys and envelope counts) and the
unschedulable map must be equal. Tolerance: exact.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import spread as jspread
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import spread as tspread
from karpenter_tpu_torch.solver import service as tservice
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_oracle import ZONE, build, fuzz_spec, small_items  # noqa: F401

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)


def split(which, spec, items, seeds, overhead=None):
    """(sub-class rows, unschedulable) of one package's split pass."""
    enc, spr = (jencode, jspread) if which == "jax" else (tencode, tspread)
    w = build(which, spec, items)
    pool = w.pools[0]
    classes = enc.group_pods(w.pods, extra_requirements=pool.requirements())
    catalog = enc.encode_catalog(w.catalogs[pool.name])
    cs = enc.encode_classes(classes, catalog, c_pad=enc.bucket(len(classes), 16))
    compat = enc.compat_matrix(catalog, cs)[: len(classes)]
    cap = catalog.cap
    if overhead is not None:
        cap = np.maximum(cap - overhead[None, :], np.float32(0.0))
    fits_one = np.all(cap[None, :, :] >= cs.req[: len(classes), None, :], axis=-1)
    out = spr.split_zone_spread(classes, catalog, spec["zones"], compat, fits_one,
                                seed_counts=seeds, node_overhead=overhead)
    rows = []
    for pc in out.classes:
        zreq = pc.requirements.get(ZONE)
        pin = tuple(sorted(zreq.values)) if zreq is not None and not zreq.complement else None
        rows.append(([p.metadata.name for p in pc.pods], pin, pc.requirements.stable_hash(),
                     pc.key, pc.env_count, pc.requests.tobytes()))
    return rows, dict(out.unschedulable)


class TestSplitZoneSpread:
    @pytest.mark.parametrize("seeded", [False, True])
    @pytest.mark.parametrize("seed", range(6))
    def test_sub_classes_equal(self, small_items, seed, seeded):
        spec = fuzz_spec(200 + seed, spread=0.8, nodes=3, bound_spread=True)
        seeds = None
        if seeded:
            seeds = tservice.TorchSolver._spread_seeds(build("torch", spec, small_items).scheduler())
        want = split("jax", spec, small_items, seeds)
        got = split("torch", spec, small_items, seeds)
        assert got == want
        assert any(row[1] for row in want[0]), "no class was zone-pinned"

    def test_overhead_and_an_unreachable_zone(self, small_items):
        """Daemonset overhead shrinks the fresh fits; a class pinned to a
        zone its selector excludes has no domain, so a hard spread class
        comes back unschedulable and a soft one passes through."""
        spec = fuzz_spec(3, spread=1.0)
        spec["zones"] = spec["zones"] + ["us-central-1z"]
        for t in spec["templates"][:2]:
            t["selector"] = {"kubernetes.io/arch": "arm64",
                             "node.kubernetes.io/instance-type": "no-such-type"}
            t["spread"] = [(1, ZONE, w, {"app": t["labels"]["app"]})
                           for w in (("DoNotSchedule",) if t is spec["templates"][0]
                                     else ("ScheduleAnyway",))]
        ovh = np.zeros((tencode.R,), dtype=np.float32)
        ovh[0], ovh[1] = 300.0, 256.0
        want = split("jax", spec, small_items, None, ovh)
        assert split("torch", spec, small_items, None, ovh) == want
        assert want[1], "the unreachable hard class was scheduled"

    def test_eligibility_and_tsc_helpers(self, small_items):
        spec = fuzz_spec(4, spread=1.0, hostname_spread=True)
        j, t = build("jax", spec, small_items), build("torch", spec, small_items)
        assert tspread.spread_eligible(t.pods) == jspread.spread_eligible(j.pods) is False
        rest = [p for p in t.pods if not p.metadata.name.startswith("f4-0-")]
        jrest = [p for p in j.pods if not p.metadata.name.startswith("f4-0-")]
        assert tspread.spread_eligible(rest) == jspread.spread_eligible(jrest) is True
        assert [tspread.hard_zone_tsc(p) is None for p in rest] == \
            [jspread.hard_zone_tsc(p) is None for p in jrest]
        assert [tspread.soft_zone_tsc(p) is None for p in rest] == \
            [jspread.soft_zone_tsc(p) is None for p in jrest]
        assert tspread.soft_zone_tsc is tencode.soft_zone_tsc
