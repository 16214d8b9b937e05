"""The port's merged multi-pool catalog and masks against the JAX package's.

Both packages build the same pools (tests/test_torch_oracle.py specs) over
their own catalogs: `build_merged` must give the same columns (names,
requirements, capacity, overhead with each pool's daemonset reserve,
offerings) and the same column -> pool map; `first_compat_pool`,
`admitted_pools`, `open_allowed_mask` and `join_allowed_mask` must agree
on the same classes. Tolerance: exact.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import multipool as jmulti
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import multipool as tmulti
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_oracle import (  # noqa: F401
    MV_POOLS, SPOT_OD_POOLS, TAINTED_POOLS, build, fuzz_spec, small_items,
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


def masks(which, spec, items):
    enc, mod = (jencode, jmulti) if which == "jax" else (tencode, tmulti)
    w, (items_m, _, col_pools) = merged(which, spec, items, overhead=False)
    classes = enc.group_pods(w.pods)
    catalog = enc.encode_catalog(items_m)
    cs = enc.encode_classes(classes, catalog, c_pad=enc.bucket(len(classes), 16))
    compat = enc.compat_matrix(catalog, cs)[: len(classes)]
    fits_one = np.all(catalog.cap[None, :, :] >= cs.req[: len(classes), None, :], axis=-1)
    admitted = [mod.admitted_pools(pc, w.pools) for pc in classes]
    open_mask, open_pool = mod.open_allowed_mask(
        classes, admitted, col_pools, compat, fits_one, cs.c_pad, catalog.k_pad)
    join_mask = mod.join_allowed_mask(classes, w.pools, col_pools, cs.c_pad, catalog.k_pad)
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
