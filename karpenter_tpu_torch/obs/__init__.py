"""Observability of the port's solves (mirrors karpenter_tpu/obs).

- ``quality``  -- the optimality gap and waste attribution of each device
  solve, and the ``karpenter_quality_*`` gauges;
- ``hbm``      -- the card's allocator ledger polled into the
  ``karpenter_device_hbm_*`` gauges, staged bytes by owner, and the
  headroom signal behind the catalog LRU's pressure eviction;
- ``profiler`` -- an on-demand ``torch.profiler`` capture bracketing the
  next N ticks, exported as a Chrome trace;
- ``flight``   -- the always-on ring of per-tick records and its JSONL
  black box.

The JAX package's fourth layer, ``jitstats`` (per-jit-entry compile and
dispatch cost), has no counterpart yet: the port compiles nothing per
shape, and a table of its kernel builds and launches comes with the
cold-start work.
"""
