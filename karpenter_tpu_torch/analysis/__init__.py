"""Invariant linter suite and runtime witnesses over the port's tree.

Copy of karpenter_tpu/analysis/ for karpenter_tpu_torch/. The checkers
walk the port's AST and fail the moment a violation is WRITTEN:

- ``determinism``   -- bare ``uuid.uuid4()`` / ``random.*()`` /
  ``time.time()`` / ``datetime.now()`` calls, draws from torch's global
  generator (``torch.rand*`` / ``torch.manual_seed``), and iteration-order
  hazards outside the seeding.py-derived streams and the named clock
  seams (checkers/determinism.py).
- ``locks``         -- the static lock-acquisition graph across every
  ``threading.Lock/RLock``-holding class: lock-order cycles are rejected,
  and attributes written both under and outside their class's lock are
  flagged (checkers/locks.py).
- ``zerocopy``      -- copying constructs on the solver/rpc.py and
  solver/shm.py framing hot path (checkers/zerocopy.py).
- ``registry``      -- every failpoint site, metric family and RPC feature
  flag appears in the JAX package's docs tables (read-only), the families
  the port leaves out are an explicit list, and obs/jitstats.py's
  ``JIT_ENTRY_FUNCTIONS`` equals the entries that really dispatch
  (checkers/registry_drift.py).
- ``torchjit``      -- graph-capture and kernel-entry hazards: statics of
  an armed graph's ``exec_key`` outside the bucket manifest, a ctypes
  kernel entry without its plain twin or case builder, an ``except``
  around a launch that calls the plain version, a captured function
  reading live state, a Python branch on a device tensor, tensor creation
  without ``device=`` and ``dtype=`` (checkers/torch_discipline.py).
- ``torchhost``     -- host-sync discipline over the encode -> dispatch ->
  decode manifest: ``.item()``, scalar casts of device values,
  ``.cpu()``/``.numpy()``/``.tolist()``/``np.asarray`` outside
  ``SANCTIONED_FETCH``, and explicit ``synchronize()`` calls
  (checkers/torch_discipline.py).
- ``errflow``       -- exception-flow soundness over the ``LADDER_SEAMS``
  manifest (checkers/errflow.py).
- ``reslife``       -- resource lifecycle, the port's ctypes libraries and
  CUDA graphs included (checkers/reslife.py).

Intentional exceptions live in ``analysis/lint_baseline.json``, each with
a justification; the suite fails if the baseline grows stale:

    python -m karpenter_tpu_torch.analysis

The runtime witnesses are the dynamic halves: witness.py (lock order),
errwitness.py (ladder-class exceptions swallowed), torch_witness.py
(library builds or loads and graph captures after warm-up, with
sync_witness.py's host syncs). pytest_plugin.py installs all three over a
test session (``-p karpenter_tpu_torch.analysis.pytest_plugin``).
"""
from karpenter_tpu_torch.analysis.base import (  # noqa: F401
    Violation,
    load_baseline,
    run_suite,
    write_baseline,
)
