"""The batched consolidation evaluator under its historical name.

Copy of karpenter_tpu/solver/consolidate.py: ``ConsolidationEvaluator``
is ``DisruptEngine`` (solver/disrupt/engine.py) -- same constructor, same
``evaluate`` contract.
"""
from karpenter_tpu_torch.solver.disrupt.engine import (  # noqa: F401
    DisruptEngine,
    SetVerdict,
    _node_feasibility,
    _with_pool_requirements,
    device_eligible,
)

ConsolidationEvaluator = DisruptEngine
