"""The dedicated-spot-od deployment at a test size: a whole run on the CPU
comes out correct on the merged route of three pools, the first tainted;
and the reader of the taint gate's span reads it where it exists and
nothing where it does not (an untainted merged tick, the parent's tree)."""
import copy
import io
import json

import pytest

import harness
from small import manifest
from test_bench_merged_readers import merged_tick
from test_bench_readers import PARENT, trace_of

DOC = copy.deepcopy(manifest())
DOC["configs"].append({"name": "dedicated-spot-od-small", "source": "test", "reduced": [],
                       "why": "test", "file": "benchmark/tests/data/dedicated-spot-od-small.json"})
DOC["workloads"].append({"name": "dedicated-spot-od-small.burst", "config": "dedicated-spot-od-small",
                         "traffic": "burst", "chips": 1, "why": "test"})


def test_the_cut_config_keeps_the_deployment():
    """The test size differs from the cell's configuration only by scale."""
    _, small, _ = harness.cell_files(DOC, "dedicated-spot-od-small.burst")
    _, full, _ = harness.cell_files(DOC, "dedicated-spot-od-50k.burst")
    assert small["pools"] == full["pools"]
    assert [p["weight"] for p in full["pools"]] == [100, 50, 10]
    assert full["pools"][0]["taints"] == [["dedicated", "batch", "NoSchedule"]]
    assert set(small["reduced"]) == {k for k in full if small.get(k) != full[k]} - {
        "name", "source", "deployment", "chips", "reduced", "assumed"}


def test_a_dedicated_run_takes_the_merged_route_and_is_correct():
    log = io.StringIO()
    doc = harness.run("dedicated-spot-od-small.burst", 2**31 + 53, 1.0, False, device="cpu",
                      doc=DOC, out=log)
    assert doc["correct"], doc["checks"]
    assert all(v["value"] == 0 for v in doc["checks"].values())
    assert f"routes: {json.dumps({'merged': doc['attempted']})}" in log.getvalue()


def tainted_tick(pairs=4000):
    """A merged-route tick whose masks hold the taint gate."""
    out = copy.deepcopy(merged_tick(pairs))
    encode = next(s for s in out if s[0] == "encode")
    masks = encode[3][0]
    masks[3].append(("join_masks", 0.75, {"tainted_pools": 1, "classes": 57, "gated_rows": 50},
                     []))
    return out


def test_join_masks_reads_its_span():
    # two calls at scale 1 and 3: the mean is twice the scale-1 time
    tr = trace_of(tainted_tick(), [1.0, 3.0])
    assert harness.reader("join_masks_ms.tick")(tr) == pytest.approx(1.5)
    # the gate sits inside `merge_masks`, which keeps its meaning
    assert harness.reader("merge_masks_ms.tick")(tr) == pytest.approx(2 * (6.0 + 0.75))


@pytest.mark.parametrize("stages", [merged_tick(4000), PARENT], ids=["untainted", "parent"])
def test_join_masks_reads_nothing_without_its_span(stages):
    assert harness.reader("join_masks_ms.tick")(trace_of(stages, [1.0, 2.0])) is None
    assert harness.reader("join_masks_ms.tick")(trace_of(tainted_tick(), [])) is None
