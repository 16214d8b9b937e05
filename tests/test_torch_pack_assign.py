"""`TorchSolver._pack_existing`'s walk from kernel B's [C, N] takes to pod
assignments, against the dense class-by-node walk it replaced (kept below
as the yardstick): the same `existing_assignments` in the same insertion
order, the same per-class `placed`, and the `pack_assign` span's `placed`
and `pairs`. Kernel B is stubbed out: each case hands the walk a takes
array of its own, padded as the solver pads it. Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch.apis import Pod
from karpenter_tpu_torch.scheduling import Requirements, Resources
from karpenter_tpu_torch.solver import encode, service
from karpenter_tpu_torch.solver.oracle import ExistingNode, SchedulingResult
from karpenter_tpu_torch.solver.service import TorchSolver


def dense_walk(takes, classes, nodes):
    """The yardstick: every real (class, node) pair in order, each class's
    pods handed out from a cursor that the slice clips."""
    assignments = {}
    placed = np.zeros((len(classes),), dtype=np.int64)
    for c, pc in enumerate(classes):
        cursor = 0
        for ni, node in enumerate(nodes):
            n = int(takes[c, ni])
            for p in pc.pods[cursor: cursor + n]:
                assignments[p.metadata.name] = node.name
            cursor += n
        placed[c] = cursor
    return assignments, placed


def world(rng, n_classes, n_nodes):
    classes = [
        encode.PodClass(
            pods=[Pod(f"c{c}-p{i}") for i in range(int(rng.integers(1, 13)))],
            requests=np.zeros(encode.R, dtype=np.float32), requirements=Requirements([]),
            key=(f"c{c}",))
        for c in range(n_classes)
    ]
    nodes = [ExistingNode(f"n{i}", {}, Resources({"cpu": "4"})) for i in range(n_nodes)]
    shape = (service._bucket(n_classes, service._C_PAD_MIN), service._bucket(n_nodes, 16))
    return classes, nodes, np.zeros(shape, dtype=np.int32)


def sparse_fill(rng, takes, classes, nodes):
    """First-fit-like rows: each class takes a few nodes, never past its pods."""
    for c, pc in enumerate(classes):
        left = len(pc.pods)
        for ni in sorted(rng.choice(len(nodes), size=min(3, len(nodes)), replace=False)):
            n = int(rng.integers(0, left + 1))
            takes[c, ni], left = n, left - n


def case_sparse(rng, takes, classes, nodes):
    sparse_fill(rng, takes, classes, nodes)


def case_dense(rng, takes, classes, nodes):
    takes[: len(classes), : len(nodes)] = rng.integers(1, 4, size=(len(classes), len(nodes)))


def case_clipped(rng, takes, classes, nodes):
    sparse_fill(rng, takes, classes, nodes)
    c = int(rng.integers(0, len(classes)))
    takes[c, rng.integers(0, len(nodes))] += len(classes[c].pods) + 2   # the row's sum passes its pods


def case_padding_strays(rng, takes, classes, nodes):
    sparse_fill(rng, takes, classes, nodes)
    takes[len(classes):, :] = rng.integers(0, 3, size=takes[len(classes):, :].shape)
    takes[:, len(nodes):] = rng.integers(0, 3, size=takes[:, len(nodes):].shape)


def case_zeros(rng, takes, classes, nodes):
    pass


CASES = {f.__name__[5:]: f for f in
         (case_sparse, case_dense, case_clipped, case_padding_strays, case_zeros)}


@pytest.fixture(scope="module")
def solver():
    return TorchSolver(device="cpu", g_max=64)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("case", list(CASES))
def test_walk_equals_dense_walk(solver, monkeypatch, case, seed):
    rng = np.random.default_rng(2200 + seed)
    classes, nodes, takes = world(rng, int(rng.integers(3, 20)), int(rng.integers(5, 40)))
    CASES[case](rng, takes, classes, nodes)
    want, want_placed = dense_walk(takes, classes, nodes)

    C, N = takes.shape
    operands = (np.zeros((N, encode.R), np.float32), np.zeros((C, N), bool),
                np.zeros((C, encode.R), np.float32), np.zeros((1, C), np.int32),
                np.zeros((1, N), bool))
    monkeypatch.setattr(solver, "_repack_operands", lambda cl, nd: operands)
    monkeypatch.setattr(solver, "_dispatch_disrupt_repack",
                        lambda *ops: (None, torch.from_numpy(takes[None].copy())))
    result = SchedulingResult()
    with ttracing.trace("tick", force=True) as root:
        placed = solver._pack_existing(classes, nodes, result)

    assert list(result.existing_assignments.items()) == list(want.items())
    assert placed.dtype == np.int64 and placed.tolist() == want_placed.tolist()
    (span,) = [sp for sp in root.children if sp.name == "pack_assign"]
    pairs = int(np.count_nonzero(takes[: len(classes), : len(nodes)]))
    assert span.attributes["placed"] == int(want_placed.sum())
    assert span.attributes["pairs"] == pairs
    if case == "zeros":
        assert pairs == 0 and not result.existing_assignments
    if case == "dense":
        assert pairs == len(classes) * len(nodes)
