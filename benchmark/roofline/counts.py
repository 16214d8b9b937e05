"""The least time the card could take for one launch of each kernel: the
operations and bytes its inputs need, over the card's published peaks.

Frozen counts (they were chip_smoke.py's `scan_bound` and `repack_bound`
when this benchmark was written), computed from the benchmark's own plain
reference of the same inputs, never from the program's operands: the
reference's scan and repack report the work each step joins or walks.
The shapes are the ones the program launches the kernels at: classes,
nodes and sets padded to powers of two, the catalog to a multiple of 128
columns, every value 4 bytes but the boolean masks.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores (data sheet)


def bound_ms(bytes_moved: float, ops: float) -> float:
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def catalog_pad(k_real: int) -> int:
    return max(128, ((k_real + 127) // 128) * 128)


def ffd_scan_ms(steps, n_classes: int, k_real: int, r: int, g_max: int) -> float:
    """Kernel A (csrc/ffd_scan.cu), one launch. `steps` is one
    (joined pairs, nodes open before the step, class has a type) per
    class of the scan, in order. Operations: 6 per (class, type) for
    the fresh-node choice, one word op per open node and 32 types, and R
    subtractions and R divides per (open node, type) pair the step joins.
    Bytes: each real class row's inputs, the no-op rows' masks and
    count, the catalog columns, and every output."""
    K = catalog_pad(k_real)
    KW = K // 32
    C = bucket(n_classes, 16)
    real = [s for s in steps if s[2]]
    ops = len(real) * K * 6 + sum(s[1] for s in real) * KW + sum(s[0] for s in real) * 2 * r
    row = 4 * (r + 3 * KW + 2 * K + 3)
    noop_row = 4 * (2 * KW + 1)
    bytes_in = len(real) * row + (C - len(real)) * noop_row + 4 * (K * r + K)
    bytes_out = 4 * (C * g_max + C + 1 + g_max * KW + g_max)
    return bound_ms(bytes_in + bytes_out, ops)


def disrupt_repack_ms(walked, member, n_nodes: int, n_classes: int, n_sets: int, r: int,
                      stepping, takes: bool = False) -> float:
    """Kernel B (csrc/disrupt_repack.cu), one launch: the leftover-only
    entry over a sweep's sets, or with `takes` the full entry of the
    provisioning pre-pass (one set, its [S, C, N] takes written too).
    `walked` [S, C] are the nodes each (set, class) pair looks at,
    `stepping` [S, C] the pairs that take a step. Operations: 3R + 4 per
    node walked. Bytes: the headroom, requests and members, the
    feasibility rows of the classes and the exclusion rows of the sets
    that step, and the outputs written."""
    N = bucket(n_nodes, 16)
    if takes:
        C = bucket(n_classes, 16)
        S = 1
    else:
        C = bucket(n_classes, 8)
        S = bucket(n_sets, 8)
    ops = int(walked.sum()) * (3 * r + 4)
    bytes_in = (4 * N * r + 4 * C * r + 4 * S * C
                + int(stepping.any(axis=0).sum()) * N + int(stepping.any(axis=1).sum()) * N)
    bytes_out = 4 * S * C + (4 * S * C * N if takes else 0)
    return bound_ms(bytes_in + bytes_out, ops)
