"""The readers of the merged route's spans and of the sparse take's
counters against span trees built with an injected clock: each reads its
number where its spans or counters exist, and None where they do not (a
one-pool tick for the masks, the program before the spans existed)."""
import pytest

import harness
from test_bench_readers import PARENT, trace_of


def merged_tick(pairs, budget=4160):
    """One merged-route tick; a take over its budget refetches densely."""
    device = [("device", 3.0, {"take_pairs": pairs, "take_budget": budget}, [])]
    if pairs > budget:
        device.append(("device", 20.0, {"take_pairs": pairs, "take_budget": budget,
                                        "refetch": "dense"}, []))
    return [
        ("group", 2.0, {}, []),
        ("route", 0.25, {"path": "merged"}, []),
        ("prepare", 0.5, {}, []),
        ("encode", 1.0, {}, [
            ("merge_masks", 6.0, {"pools": 2, "columns": 1243, "classes": 160}, []),
            ("envelopes", 4.0, {}, []),
        ]),
        ("dispatch_device", 0.5, {}, []),
        *device,
        ("decode", 2.0, {}, []),
    ]


# a one-pool tick of the change: envelopes and counters, no masks
ONE_POOL = [("encode", 1.0, {}, [("envelopes", 1.5, {}, [])]),
            ("device", 3.0, {"take_pairs": 900, "take_budget": 4160}, []),
            ("decode", 2.0, {}, [])]


def test_merge_masks_and_envelopes_read_their_spans():
    # two calls at scale 1 and 3: each mean is twice the scale-1 time
    tr = trace_of(merged_tick(4000), [1.0, 3.0])
    assert harness.reader("merge_masks_ms.tick")(tr) == pytest.approx(12.0)
    assert harness.reader("envelopes_ms.tick")(tr) == pytest.approx(8.0)
    # encode's self time leaves its two children out
    assert harness.reader("encode_ms.tick")(tr) == pytest.approx(2.0)


def test_one_pool_reads_envelopes_and_no_masks():
    tr = trace_of(ONE_POOL, [1.0])
    assert harness.reader("merge_masks_ms.tick")(tr) is None
    assert harness.reader("envelopes_ms.tick")(tr) == pytest.approx(1.5)
    assert harness.reader("dense_refetch.tick")(tr) == 0.0


@pytest.mark.parametrize("pairs, want", [([4000], 0.0), ([4194], 100.0),
                                         ([4194, 3665, 4000, 4160], 25.0)])
def test_dense_refetch_counts_the_calls_over_budget(pairs, want):
    calls = [trace_of(merged_tick(p), [1.0]).calls[0] for p in pairs]
    tr = harness.Trace(calls, [], 0.0, 1.0, [{} for _ in calls])
    assert harness.reader("dense_refetch.tick")(tr) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["merge_masks_ms.tick", "envelopes_ms.tick",
                                    "dense_refetch.tick"])
def test_none_without_spans_or_counters(metric):
    """No traced call, or the parent's tree (no `merge_masks`, no
    `envelopes`, no counters on `device`): nothing to read."""
    assert harness.reader(metric)(trace_of(PARENT, [])) is None
    assert harness.reader(metric)(trace_of(PARENT, [1.0, 2.0])) is None
