"""The per-layer readers of the tick's host stages against span trees built
with an injected clock: each reads its number, and None from a trace that
holds none of its spans (the program before those spans existed)."""
import pytest

import harness
from karpenter_tpu_torch import tracing

NEW = ("group_ms.tick", "route_ms.tick", "pack_feasibility_ms.tick", "pack_headroom_ms.tick",
       "pack_device_ms.tick", "pack_assign_ms.tick", "pack_existing_total_ms.tick",
       "quality_ms.tick", "untraced_ms.tick", "armed_miss.tick")


def tick(tracer, t, scale, stages):
    """One bench.call root: `stages` is a list of (name, ms, attrs,
    children) or ("gap", ms) for time outside every span; ms are scaled."""
    def walk(items):
        for item in items:
            if item[0] == "gap":
                t[0] += item[1] * scale / 1e3
                continue
            name, ms, attrs, children = item
            with tracer.span(name, **attrs):
                t[0] += ms * scale / 1e3
                walk(children)

    with tracer.trace("bench.call", force=True) as root:
        walk(stages)
    return {"wall_s": root.end - root.start, "root": root, "index": 0}


PORT = [
    ("gap", 0.5),
    ("group", 2.0, {}, []),
    ("route", 0.25, {}, []),
    ("prepare", 0.5, {}, []),
    ("pack_existing", 1.0, {}, [
        ("pack_feasibility", 5.0, {}, []),
        ("pack_headroom", 1.0, {}, []),
        ("pack_device", 2.0, {"dispatch": {"disrupt_repack": "cuda"}}, []),
        ("pack_assign", 1.5, {"placed": 6}, []),
    ]),
    ("route", 0.25, {}, []),
    ("encode", 1.0, {}, []),
    ("dispatch_device", 0.5, {"dispatch": {"ffd_solve_fused": "aot"}}, []),
    ("device", 3.0, {}, []),
    ("gap", 0.25),
    ("bound", 0.2, {"dispatch": {"fractional_price_bound": "aot"}}, []),
    ("decode", 2.0, {}, []),
    ("quality", 0.3, {}, []),
    ("gap", 0.25),
]
# the parent's tree: none of the port-only spans, no dispatch attributes
PARENT = [("pack_existing", 9.0, {}, []), ("encode", 1.0, {}, []),
          ("dispatch_device", 0.5, {}, []), ("device", 3.0, {}, []), ("decode", 2.0, {}, []),
          ("gap", 1.0)]


def trace_of(stages, scales):
    t = [0.0]
    tracer = tracing.Tracer(enabled=True, clock=lambda: t[0])
    calls = [tick(tracer, t, s, stages) for s in scales]
    return harness.Trace(calls, [], 0.0, 1.0, [{} for _ in calls])


# one call at scale 1, one at 3: every mean is twice the scale-1 reading
WANT = {"group_ms.tick": 4.0, "route_ms.tick": 2.0, "pack_feasibility_ms.tick": 10.0,
        "pack_headroom_ms.tick": 2.0, "pack_device_ms.tick": 4.0, "pack_assign_ms.tick": 3.0,
        "pack_existing_total_ms.tick": 21.0, "quality_ms.tick": 1.0, "untraced_ms.tick": 2.0,
        "armed_miss.tick": 100.0 / 3}


@pytest.mark.parametrize("metric", NEW)
def test_reads_its_spans(metric):
    got = harness.reader(metric)(trace_of(PORT, [1.0, 3.0]))
    assert got == pytest.approx(WANT[metric], rel=1e-9)


def test_children_and_remainder():
    tr = trace_of(PORT, [1.0, 3.0])
    kids = sum(harness.reader(m)(tr) for m in NEW if m.startswith("pack_") and "total" not in m)
    total = harness.reader("pack_existing_total_ms.tick")(tr)
    assert harness.reader("pack_existing_ms.tick")(tr) == pytest.approx(total - kids)


@pytest.mark.parametrize("metric", NEW)
def test_none_without_its_spans(metric):
    assert harness.reader(metric)(trace_of(PORT, [])) is None
    got = harness.reader(metric)(trace_of(PARENT, [1.0]))
    # the parent has the root and the whole pack_existing span: those two
    # read there, the same quantities
    assert got == {"untraced_ms.tick": pytest.approx(1.0),
                   "pack_existing_total_ms.tick": pytest.approx(9.0)}.get(metric)


def test_kernel_a_roofline_counts_each_launch_of_a_tick():
    """Tick 0 launches kernel A once, tick 1 twice (the dense refetch): the
    least time counts once per launch, against the launches' time."""
    marks = [(0.0, 100.0), (200.0, 300.0)]
    kernels = [("ffd_scan_kernel", 10.0, 2.0), ("other", 20.0, 5.0),
               ("ffd_scan_kernel", 210.0, 3.0), ("ffd_scan_kernel", 250.0, 3.0)]
    bounds = [{"ffd_scan": 0.001}, {"ffd_scan": 0.002}]
    read = harness.reader("ffd_scan_roofline.tick")
    tr = harness.Trace([{}, {}], kernels, 13.0, 300.0, bounds, marks)
    assert read(tr) == pytest.approx(100.0 * (0.001 + 2 * 0.002) / (8.0 / 1e3))
    # a tick without a launch in the trace, or markers that do not match the ticks
    assert read(harness.Trace([{}, {}], kernels[:2], 7.0, 300.0, bounds, marks)) is None
    assert read(harness.Trace([{}, {}], kernels, 13.0, 300.0, bounds, None)) is None


def test_pack_existing_reads_nothing_without_standing_nodes():
    """A burst tick on an empty cluster opens no `pack_existing` span."""
    read = harness.reader("pack_existing_ms.tick")
    assert read(trace_of([("encode", 1.0, {}, []), ("decode", 2.0, {}, [])], [1.0])) is None
    assert read(trace_of(PARENT, [1.0])) == pytest.approx(9.0)
