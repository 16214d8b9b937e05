"""The port's apiserver bus (`karpenter_tpu_torch.kube`) against the JAX
package's, on the CPU.

Each package runs against its own in-process fake apiserver
(tests/fake_apiserver.py, the real wire protocol over HTTP) and the two
must agree exactly; there is no tolerance anywhere.

- conversion: for every kind of `convert.REGISTRY` the same object, built
  in each package from one spec, serialises to the same manifest, and
  `from_manifest` of that manifest re-serialises alike in both;
- the bus: the JAX suite's KubeCluster cases (tests/test_kube_cluster.py:
  CRUD, 409 Conflict, finalizer-gated delete, /status, /binding, the
  field index, watch dispatch, eviction on unbind, field-scoped patches,
  cross-namespace lists, label removal) give the same results in both;
- the operator over the bus: the JAX `Operator` with `TPUSolver` and its
  `DisruptEngine`, and the port's with `TorchSolver(device="cpu")` and its
  `DisruptEngine`, each over its own apiserver under one FakeClock script
  (synth_pods templates, a wave onto the live nodes, 3 of 4 pods deleted,
  ramp-down ticks): pending pods, NodeClaims, bindings and nodes equal tick
  by tick, and the kernel-dispatch family moves alike per entry. The bus
  is not decision-invisible: the apiserver stamps creationTimestamp from
  its own clock, so node ages over it do not follow the operator's
  FakeClock (a clock behind the stamps never consolidates; the worlds here
  start after them). The repair, impairment and stateful (PVC/CSINode)
  flows of the JAX suite run alike in both packages;
- the metrics controller's error branch: a NodePool PUT answered 500 logs
  one warning per failing update, the tick goes on;
- election: two electors over two KubeClusters on one apiserver, one
  leads and the standby takes over after expiry.

Every server and cluster stops in a `finally`: watch threads must not
outlive their test.
"""
import importlib
import json
import logging
import threading
import time
import types

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain specs
import numpy as np
import pytest
import torch

import bench
from fake_apiserver import FakeApiServer
from karpenter_tpu_torch import workload

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)


def _pkg(root):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, apis=mod("apis"), sched=mod("scheduling"), res=mod("scheduling.resources"),
        wk=mod("apis.labels"), pod=mod("apis.pod"), nodepool=mod("apis.nodepool"),
        storage=mod("apis.storage"), objects=mod("apis.objects"),
        convert=mod("kube.convert"), kube=mod("kube"), kwok=mod("kwok.cluster"), ttl=mod("cache.ttl"), seeding=mod("seeding"),
        metrics=mod("metrics"), operator=mod("operator"), election=mod("operator.election"),
        disruption=mod("controllers.disruption"))


PKG = {"jax": _pkg("karpenter_tpu"), "torch": _pkg("karpenter_tpu_torch")}
BOTH = ("jax", "torch")


def dumps(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=repr)


# stamped from the wall clock (the fake apiserver's creationTimestamp, a
# condition's transition time without a clock) or drawn at random (uid)
UNSTABLE = ("creationTimestamp", "lastTransitionTime", "uid")


def scrub(doc):
    if isinstance(doc, dict):
        return {k: scrub(v) for k, v in doc.items() if k not in UNSTABLE}
    if isinstance(doc, (list, tuple)):
        return [scrub(v) for v in doc]
    return doc


def kube_cluster(k, srv, **kw):
    return k.kube.KubeCluster(k.kube.KubeClient(k.kube.KubeConfig(server=srv.url)), **kw)


# -- conversion: every kind's manifest ----------------------------------------------------


def specimens(k):
    """kind name -> objects built alike in either package: the full
    scheduling surface of each kind the bus carries."""
    a, s, wk = k.apis, k.sched, k.wk
    Op, R = s.Operator, s.Requirement

    pool = a.NodePool(
        "flex",
        requirements=[R(wk.ARCH_LABEL, Op.IN, ["arm64"]),
                      R(wk.LABEL_INSTANCE_FAMILY, Op.EXISTS, min_values=3),
                      R(wk.LABEL_INSTANCE_CPU, Op.GT, ["4"])],
        limits=s.Resources({"cpu": "100", "memory": "200Gi"}), weight=7)
    pool.template.labels["team"] = "ml"
    pool.template.taints = [s.Taint(key="dedicated", effect="NoSchedule", value="ml")]
    pool.template.expire_after = 2_592_000.0
    pool.disruption.consolidate_after = 0.5
    pool.disruption.budgets = [k.nodepool.Budget(nodes="20%", reasons=["Drifted"],
                                                  schedule="0 9 * * *", duration=3600.0)]
    pool.status_resources = s.Resources({"cpu": "12", "memory": "24Gi"})

    claim = a.NodeClaim(
        "c-1", requirements=[R(wk.ZONE_LABEL, Op.IN, ["us-central-1a"])],
        resources_requested=s.Resources({"cpu": "3500m", "memory": "7Gi"}),
        taints=[s.Taint(key="t", effect="NoExecute")], expire_after=7200.0)
    claim.metadata.labels[wk.NODEPOOL_LABEL] = "default"
    claim.metadata.finalizers.append("karpenter.sh/termination")
    claim.metadata.creation_timestamp = 100_000.0
    claim.provider_id = "fake://i-123"
    claim.status_conditions.set_true("Launched")

    nc = a.TPUNodeClass("default")
    nc.user_data = "#!/bin/bash\necho hi"
    nc.tags = {"team": "ml"}
    nc.kubelet.max_pods = 58

    pod = a.Pod(
        "p", requests=s.Resources({"cpu": "250m", "memory": "512Mi"}),
        node_selector={wk.ZONE_LABEL: "us-central-1a"},
        node_affinity_terms=[[R(wk.ARCH_LABEL, Op.IN, ["amd64"])]],
        preferred_node_affinity_terms=[(10, [R(wk.ZONE_LABEL, Op.IN, ["us-central-1b"])])],
        tolerations=[s.Toleration(key="dedicated", operator="Exists")],
        topology_spread=[k.pod.TopologySpreadConstraint(
            max_skew=1, topology_key=wk.ZONE_LABEL, label_selector={"app": "w"},
            when_unsatisfiable="ScheduleAnyway")],
        affinity_terms=[k.pod.PodAffinityTerm(label_selector={"app": "db"},
                                              topology_key=wk.ZONE_LABEL)],
        preferred_affinity_terms=[(5, k.pod.PodAffinityTerm(
            label_selector={"app": "w"}, topology_key=wk.ZONE_LABEL, anti=True))],
        labels={"app": "w"}, annotations={"karpenter.sh/do-not-disrupt": "true"},
        priority=100, volume_claims=("data-0",))
    bound = a.Pod("bound", namespace="app", requests=s.Resources({"cpu": "1"}),
                  owner_kind="StatefulSet", scheduling_gates=("example.com/gate",))
    bound.node_name, bound.phase = "n1", "Running"
    bound.metadata.owner_references.append("uid-owner")

    node = a.Node(
        "n1", labels={wk.ZONE_LABEL: "us-central-1a"},
        capacity=s.Resources({"cpu": "8", "memory": "16Gi", "pods": 110}),
        allocatable=s.Resources({"cpu": "7500m", "memory": "15Gi", "pods": 110}),
        taints=[s.Taint(key="startup", effect="NoSchedule")], provider_id="fake://i-9")
    node.ready = True
    node.unschedulable = True
    node.status_conditions.set_false("AcceleratedHardwareReady", "InstanceImpaired")

    pvc = k.storage.PersistentVolumeClaim(
        "data-0", storage_class_name="standard", bound_zone="us-central-1b",
        volume_name="pv-1", access_modes=("ReadWriteOnce", "ReadOnlyMany"),
        storage_request="20Gi")
    out = {
        "NodePool": [pool, a.NodePool("default")],
        "NodeClaim": [claim],
        "TPUNodeClass": [nc],
        "Pod": [pod, bound],
        "Node": [node],
        "PodDisruptionBudget": [a.PodDisruptionBudget("pdb", selector={"app": "w"},
                                                      max_unavailable=1),
                                a.PodDisruptionBudget("pdb-min", selector={"app": "db"},
                                                      min_available="50%")],
        "DaemonSet": [a.DaemonSet("cni", requests=s.Resources({"cpu": "100m"}),
                                  node_selector={wk.ARCH_LABEL: "amd64"},
                                  tolerations=[s.Toleration(operator="Exists")])],
        "PersistentVolumeClaim": [pvc, k.storage.PersistentVolumeClaim("scratch")],
        "StorageClass": [k.storage.StorageClass("standard"),
                         k.storage.StorageClass("fast", binding_mode="Immediate",
                                                provisioner="csi.example/ssd")],
        "CSINode": [k.storage.CSINode("n1", drivers=[("csi.storage.dev/disk", 25),
                                                     ("csi.example/ssd", None)])],
        "Lease": [k.objects.Lease("karpenter-leader", holder="replica-a",
                                  renew_deadline=100_015.0, epoch=3)],
        "ProvisioningIntent": [k.objects.ProvisioningIntent(
            "intent-1", claim_name="c-1", token="tok", epoch=2, provider_id="fake://i-123")],
    }
    for objs in out.values():
        for o in objs:  # a random uid per object otherwise
            o.metadata.uid = f"uid-{o.metadata.name}"
    return out


KINDS = sorted(cls.__name__ for cls in PKG["jax"].convert.REGISTRY)


def test_registry_kinds_alike():
    assert sorted(cls.__name__ for cls in PKG["torch"].convert.REGISTRY) == KINDS
    assert sorted(specimens(PKG["torch"])) == KINDS
    for kind in KINDS:
        j = next(i for c, i in PKG["jax"].convert.REGISTRY.items() if c.__name__ == kind)
        t = next(i for c, i in PKG["torch"].convert.REGISTRY.items() if c.__name__ == kind)
        assert (t.api_version, t.plural, t.namespaced, t.status_subresource,
                t.base_path("app"), t.list_path()) == (
            j.api_version, j.plural, j.namespaced, j.status_subresource,
            j.base_path("app"), j.list_path())


@pytest.mark.parametrize("kind", KINDS)
def test_manifest_equal(kind):
    jobjs, tobjs = specimens(PKG["jax"])[kind], specimens(PKG["torch"])[kind]
    for jo, to in zip(jobjs, tobjs):
        jinfo = PKG["jax"].convert.REGISTRY[type(jo)]
        tinfo = PKG["torch"].convert.REGISTRY[type(to)]
        jm, tm = jinfo.to_manifest(jo), tinfo.to_manifest(to)
        assert dumps(tm) == dumps(jm)
        # the same manifest read back by each package re-serialises alike
        assert dumps(tinfo.to_manifest(tinfo.from_manifest(jm))) == dumps(
            jinfo.to_manifest(jinfo.from_manifest(jm)))


def test_pod_scheduling_identity_survives_the_wire():
    k = PKG["torch"]
    pod = specimens(k)["Pod"][0]
    info = k.convert.REGISTRY[type(pod)]
    back = info.from_manifest(info.to_manifest(pod))
    assert back.grouping_signature() == pod.grouping_signature()
    assert back.preferred_affinity_terms[0][0] == 5 and back.preferred_affinity_terms[0][1].anti


@pytest.mark.parametrize("value", [0.5, 2_592_000.0, 3600.0, 90.0])
def test_durations_alike(value):
    j, t = PKG["jax"].convert, PKG["torch"].convert
    assert t.format_duration(value) == j.format_duration(value)
    assert t.parse_duration(t.format_duration(value)) == j.parse_duration(j.format_duration(value))
    assert "e+" not in t.format_duration(value)


def test_times_alike():
    j, t = PKG["jax"].convert, PKG["torch"].convert
    for epoch in (0.0, 100_000.0, 1_792_214_808.0, 4_000_000_000.0):
        assert t.format_time(epoch) == j.format_time(epoch)
        assert t.parse_time(t.format_time(epoch)) == j.parse_time(j.format_time(epoch))
    assert t.parse_time("2026-10-17T05:24:43.123456Z") == j.parse_time("2026-10-17T05:24:43.123456Z")


# -- the bus: the JAX suite's KubeCluster cases -------------------------------------------


def c_create_get_list_delete(k, cl):
    a = k.apis
    cl.create(a.NodePool("a", weight=3))
    cl.create(a.NodePool("b"))
    names = sorted(p.metadata.name for p in cl.list(a.NodePool))
    assert names == ["a", "b"] and cl.get(a.NodePool, "a").weight == 3
    with pytest.raises(k.kwok.AlreadyExists):
        cl.create(a.NodePool("a"))
    cl.delete(a.NodePool, "b")
    assert cl.try_get(a.NodePool, "b") is None
    with pytest.raises(k.kwok.NotFound):
        cl.get(a.NodePool, "b")
    return names


def c_optimistic_concurrency_conflict(k, cl):
    pool = cl.create(k.apis.NodePool("p"))
    stale = cl.get(k.apis.NodePool, "p")
    pool.weight = 5
    cl.update(pool)
    stale.weight = 9
    with pytest.raises(k.kwok.Conflict):
        cl.update(stale)
    back = cl.get(k.apis.NodePool, "p")
    return [back.weight, back.metadata.resource_version]


def c_finalizer_gated_deletion(k, cl):
    claim = k.apis.NodeClaim("c")
    claim.metadata.finalizers.append("karpenter.sh/termination")
    cl.create(claim)
    still = cl.delete(k.apis.NodeClaim, "c")
    assert still is not None and still.deleting
    cl.remove_finalizer(still, "karpenter.sh/termination")
    assert cl.try_get(k.apis.NodeClaim, "c") is None
    return still.metadata.finalizers


def c_status_travels_via_subresource(k, cl):
    claim = k.apis.NodeClaim("c2")
    claim.provider_id = "fake://i-7"
    claim.status_conditions.set_true("Launched")
    cl.create(claim)
    back = cl.get(k.apis.NodeClaim, "c2")
    assert back.provider_id == "fake://i-7" and back.status_conditions.is_true("Launched")
    return k.convert.nodeclaim_to_manifest(back)


def c_pod_binding_subresource(k, cl):
    a, s, wk = k.apis, k.sched, k.wk
    cl.create(a.Node("n1", labels={wk.ZONE_LABEL: "us-central-1a"},
                     capacity=s.Resources({"cpu": "8"})))
    pod = cl.create(a.Pod("w", requests=s.Resources({"cpu": "1"})))
    cl.bind_pod(pod, cl.get(a.Node, "n1"))
    back = [p for p in cl.list(a.Pod) if p.metadata.name == "w"][0]
    assert back.node_name == "n1" and back.phase == "Running" and not back.schedulable()
    usage = cl.node_usage("n1").get("cpu")
    assert usage == 1000.0
    return [back.node_name, back.phase, usage, [p.metadata.name for p in cl.pods_on_node("n1")]]


def c_field_index_shim(k, cl):
    cl.add_field_index(k.apis.NodeClaim, "providerID", lambda c: c.provider_id or None)
    x = k.apis.NodeClaim("x")
    x.provider_id = "fake://i-1"
    cl.create(x)
    cl._put_status(x)
    hits = [c.metadata.name for c in cl.by_index(k.apis.NodeClaim, "providerID", "fake://i-1")]
    assert hits == ["x"] and cl.has_index(k.apis.NodeClaim, "providerID")
    return hits


def c_watch_dispatches_events(k, cl):
    seen = []
    done = threading.Event()

    def handler(ev, obj):
        seen.append((ev, type(obj).__name__, obj.metadata.name))
        if ev == "DELETED":
            done.set()

    cl.on_event(handler)
    cl.watch_events([k.apis.NodePool])
    time.sleep(0.3)  # let the watch register
    cl.create(k.apis.NodePool("watched"))
    cl.delete(k.apis.NodePool, "watched")
    assert done.wait(5.0), "watch events must arrive"
    return seen


def c_pod_unbind_update_is_eviction(k, cl):
    a, s = k.apis, k.sched
    cl.create(a.Node("n1", capacity=s.Resources({"cpu": "8"})))
    pod = cl.create(a.Pod("w", requests=s.Resources({"cpu": "1"})))
    cl.bind_pod(pod, cl.get(a.Node, "n1"))
    pod.node_name, pod.phase = "", "Pending"
    cl.update(pod)
    back = cl.get(a.Pod, "w")
    assert back.node_name == "" and back.schedulable()
    return k.convert.pod_to_manifest(back)["spec"]


def c_pod_metadata_update_is_field_scoped(k, cl):
    a, s = k.apis, k.sched
    cl.create(a.Node("n1", capacity=s.Resources({"cpu": "8"})))
    pod = cl.create(a.Pod("w2", requests=s.Resources({"cpu": "1"})))
    cl.bind_pod(pod, cl.get(a.Node, "n1"))
    pod.metadata.annotations["seen"] = "true"
    cl.update(pod)
    back = cl.get(a.Pod, "w2")
    assert back.node_name == "n1" and back.metadata.annotations.get("seen") == "true"
    return [back.node_name, back.phase, dict(back.metadata.annotations)]


def c_node_cordon_is_field_scoped(k, cl):
    node = cl.create(k.apis.Node("n2", capacity=k.sched.Resources({"cpu": "8"})))
    node.unschedulable = True
    cl.update(node)
    back = cl.get(k.apis.Node, "n2")
    assert back.unschedulable and back.capacity.get("cpu") == 8000.0
    return k.convert.node_to_manifest(back)


def c_lists_span_namespaces(k, cl):
    a, s = k.apis, k.sched
    cl.create(a.Pod("w-default", requests=s.Resources({"cpu": "1"})))
    cl.create(a.Pod("w-app", namespace="app", requests=s.Resources({"cpu": "1"})))
    names = sorted((p.metadata.namespace, p.metadata.name) for p in cl.list(a.Pod))
    assert [n for _, n in names] == ["w-app", "w-default"]
    return names


def c_label_removal_reaches_the_server(k, cl):
    node = cl.create(k.apis.Node("n3", labels={"keep": "1", "lapsed": "1"},
                                 capacity=k.sched.Resources({"cpu": "8"})))
    node.metadata.labels.pop("lapsed")
    cl.update(node)
    back = cl.get(k.apis.Node, "n3")
    assert "lapsed" not in back.metadata.labels and back.metadata.labels.get("keep") == "1"
    return dict(back.metadata.labels)


def c_cross_namespace_pod_eviction(k, cl):
    a, s = k.apis, k.sched
    cl.create(a.Node("n1", capacity=s.Resources({"cpu": "8"})))
    pod = cl.create(a.Pod("w-app", namespace="app", requests=s.Resources({"cpu": "1"})))
    cl.bind_pod(pod, cl.get(a.Node, "n1"))
    pod.node_name, pod.phase = "", "Pending"
    cl.update(pod)
    back = cl.get(a.Pod, "w-app")
    assert back.metadata.namespace == "app" and back.schedulable()
    return [back.metadata.namespace, back.node_name, back.phase]


def c_unbind_pods_on_node_loss(k, cl):
    """A node goes away: its pods come back pending. Pods converted from
    a manifest carry no owner uid, so every pod counts as bare and is
    deleted and re-created pending, in both packages."""
    a, s = k.apis, k.sched
    cl.create(a.Node("n1", capacity=s.Resources({"cpu": "8"})))
    for name in ("web-0", "web-1"):
        pod = cl.create(a.Pod(name, requests=s.Resources({"cpu": "1"})))
        cl.bind_pod(pod, cl.get(a.Node, "n1"))
    out = sorted(p.metadata.name for p in cl.unbind_pods("n1"))
    left = sorted((p.metadata.name, p.node_name, p.phase) for p in cl.list(a.Pod))
    assert out == ["web-0", "web-1"]
    assert left == [("web-0", "", "Pending"), ("web-1", "", "Pending")]
    return [out, left]


def c_csinode_limit_overlay(k, cl):
    """A CSINode's smallest driver count replaces the conversion default on
    the attachable-volumes axis, in lists and in gets."""
    a, s = k.apis, k.sched
    cl.create(a.Node("n1", capacity=s.Resources({"cpu": "8"})))
    cl.create(a.Node("n2", capacity=s.Resources({"cpu": "8"})))
    before = cl.get(a.Node, "n1").allocatable.get(k.res.ATTACHABLE_VOLUMES)
    cl.create(k.storage.CSINode("n1", drivers=[("csi.a", 25), ("csi.b", 7)]))
    listed = {n.metadata.name: n.allocatable.get(k.res.ATTACHABLE_VOLUMES)
              for n in cl.list(a.Node)}
    got = cl.get(a.Node, "n1").allocatable.get(k.res.ATTACHABLE_VOLUMES)
    assert listed["n1"] == 7.0 and got == 7.0
    return [before, listed, got]


BUS_CASES = {name[2:]: fn for name, fn in sorted(globals().items()) if name.startswith("c_")}


def stop_servers(servers):
    """Stop the servers at once: each shutdown waits out its serve loop's
    half-second poll."""
    threads = [threading.Thread(target=srv.stop) for srv in servers]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


@pytest.mark.parametrize("case", sorted(BUS_CASES))
def test_bus_case(case):
    got = {}
    servers = {which: FakeApiServer().start() for which in BOTH}
    try:
        for which in BOTH:
            k = PKG[which]
            cl = kube_cluster(k, servers[which])
            try:
                got[which] = dumps(scrub(BUS_CASES[case](k, cl)))
            finally:
                cl.stop()
    finally:
        stop_servers(servers.values())
    assert got["torch"] == got["jax"]


# -- the operator over the bus ------------------------------------------------------------

SEED = 20_260_101
STEP = 3.0
G = 64
# the FakeClock's start: after every creationTimestamp the fake apiserver
# stamps from the wall clock, so node ages are positive and the
# disruption sweep can act (a clock before them never consolidates)
T0 = 4_000_000_000.0


def synth(k, seed, n, salt, templates):
    rng = np.random.default_rng(seed)
    if k.root == "karpenter_tpu":
        return bench.synth_pods(rng, list(workload.ZONES), n, salt, templates)[:n]
    return workload.synth_pods(rng, workload.ZONES, n, salt, templates)[:n]


def solvers(k):
    if k.root == "karpenter_tpu":
        from karpenter_tpu.solver.disrupt import DisruptEngine
        from karpenter_tpu.solver.service import TPUSolver

        solver = TPUSolver(g_max=G)
    else:
        from karpenter_tpu_torch.solver.disrupt import DisruptEngine
        from karpenter_tpu_torch.solver.service import TorchSolver

        solver = TorchSolver(g_max=G, device="cpu")
    return solver, DisruptEngine(solver=solver)


def state(k, op):
    wk = k.wk

    def labels(obj):
        m = obj.metadata.labels
        return (m.get(wk.NODEPOOL_LABEL, ""), m.get(wk.INSTANCE_TYPE_LABEL, ""),
                m.get(wk.ZONE_LABEL, ""), m.get(wk.CAPACITY_TYPE_LABEL, ""))

    return {
        "pending": sorted(p.metadata.name for p in op.cluster.pending_pods()),
        "claims": sorted((c.metadata.name, *labels(c), c.deleting)
                         for c in op.cluster.list(k.apis.NodeClaim)),
        "nodes": sorted(n.metadata.name for n in op.cluster.list(k.apis.Node)),
        "bindings": sorted((p.metadata.name, p.node_name or "")
                           for p in op.cluster.list(k.apis.Pod)),
    }


def kernel_dispatches(k):
    """karpenter_solver_kernel_dispatches_total per entry (its impl label
    names pallas/xla in one package and cuda/plain in the other)."""
    out = {}
    for (entry, _impl), v in k.metrics.SOLVER_KERNEL_DISPATCHES._values.items():
        out[entry] = out.get(entry, 0.0) + v
    return out


def bus_world(which, script, kube=True, t0=T0):
    """Tick `script` in one package, over a fake apiserver (kube) or the
    in-memory store; per-tick states, and the kernel-dispatch family's
    and the engine's local dispatches' moves over the world."""
    k = PKG[which]
    saved = k.seeding.snapshot()
    clock = k.ttl.FakeClock(t0)
    srv = cl = None
    if kube:
        srv = FakeApiServer().start()
        cl = kube_cluster(k, srv, clock=clock)
    solver, engine = solvers(k)
    before = kernel_dispatches(k)
    local0 = k.metrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local")
    ticks = []
    try:
        op = k.operator.Operator(clock=clock, cluster=cl, solver=solver,
                                 consolidation_evaluator=engine,
                                 options=k.operator.Options(seed=SEED, tracing=False))
        op.cluster.create(k.apis.TPUNodeClass("default"))
        op.cluster.create(k.apis.NodePool("default"))
        for n_ticks in script(k, op):
            for _ in range(n_ticks):
                op.tick()
                ticks.append(state(k, op))
                op.clock.step(STEP)
    finally:
        k.seeding.restore(saved)
        if cl is not None:
            cl.stop()
            srv.stop()
    after = kernel_dispatches(k)
    moved = {e: v - before.get(e, 0.0) for e, v in after.items() if v != before.get(e, 0.0)}
    moved["engine local"] = k.metrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local") - local0
    return ticks, moved


def w_synth(n, wave, templates, ramp):
    def script(k, op):
        for p in synth(k, SEED, n, 1, templates):
            op.cluster.create(p)
        yield 5
        # a wave onto the live nodes: the existing-node pass, then new nodes
        for p in synth(k, SEED + 1, wave, 2, templates):
            op.cluster.create(p)
        yield 4
        names = sorted(p.metadata.name for p in op.cluster.list(k.apis.Pod))
        for i, name in enumerate(names):
            if i % 4:
                op.cluster.delete(k.apis.Pod, name)
        op.clock.step(k.disruption.MIN_NODE_LIFETIME + 60)
        yield ramp
    return script


def assert_ticks_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            assert g[key] == w[key], f"tick {i}: {key} differ"


def retired(ticks):
    return sum(len(set(a["nodes"]) - set(b["nodes"])) for a, b in zip(ticks, ticks[1:]))


@pytest.mark.parametrize("size", [
    pytest.param((60, 16, 12, 4), id="60-pods"),
    pytest.param((240, 60, 160, 4), id="240-pods", marks=pytest.mark.slow),
])
def test_operator_over_the_bus(size):
    script = w_synth(*size)
    want, jmoved = bus_world("jax", script)
    got, tmoved = bus_world("torch", script)
    assert_ticks_equal(got, want)
    assert sum(1 for _, node in got[-1]["bindings"] if node) > 0 and got[-1]["claims"]
    # the sweep retired nodes after the deletions, alike
    assert retired(got) == retired(want) > 0
    # the kernel-dispatch family moved alike per entry, nothing taken off;
    # the engine judged sets on its local route (kernel B's plain version)
    assert tmoved == jmoved
    assert tmoved["ffd_solve_fused"] > 0 and tmoved["engine local"] > 0


# slow: three bus worlds (~9 s); tier-1 keeps the operator over the bus
@pytest.mark.slow
def test_bus_is_decision_visible():
    """The finding the chip phase's reference rests on: the JAX package's
    bus is not decision-invisible. The apiserver stamps creationTimestamp
    from its own (wall) clock, so node age over the bus does not follow the
    operator's clock: with a FakeClock behind those stamps no node is ever
    old enough to consolidate, and the ramp-down that retires nodes on the
    in-memory store retires none over the bus (with the clock after them,
    every node is old enough at once). The port's bus does the same."""
    script = w_synth(30, 8, 8, 4)
    mem, _ = bus_world("jax", script, kube=False, t0=100_000.0)
    kube, _ = bus_world("jax", script, t0=100_000.0)
    port, _ = bus_world("torch", script, t0=100_000.0)
    assert retired(mem) > 0 and retired(kube) == 0
    assert_ticks_equal(port, kube)


# -- the JAX suite's repair, impairment and stateful flows, in both packages --------------


def oracle_operator(k, srv):
    clock = k.ttl.FakeClock(100_000.0)
    cl = kube_cluster(k, srv, clock=clock)
    return cl, k.operator.Operator(cluster=cl, clock=clock,
                                   options=k.operator.Options(seed=SEED, tracing=False))


def f_provision_bind_and_consolidate(k, srv):
    cl, op = oracle_operator(k, srv)
    try:
        op.cluster.create(k.apis.TPUNodeClass("default"))
        op.cluster.create(k.apis.NodePool("default"))
        for i in range(8):
            op.cluster.create(k.apis.Pod(f"w{i}", requests=k.sched.Resources(
                {"cpu": "500m", "memory": "1Gi"})))
        ticks = op.settle(max_ticks=40)
        assert not op.cluster.pending_pods()
        assert all(p.node_name for p in op.cluster.list(k.apis.Pod))
        return [ticks, state(k, op)]
    finally:
        cl.stop()


def f_impairment_conditions_survive_the_wire(k, srv):
    clock = k.ttl.FakeClock(100_000.0)
    cl = kube_cluster(k, srv, clock=clock)
    try:
        n = k.apis.Node("sick", capacity=k.sched.Resources({"cpu": "4", "memory": "8Gi"}))
        n.ready = True
        cl.create(n)
        got = cl.get(k.apis.Node, "sick")
        got.ready = False
        got.status_conditions.set_false("AcceleratedHardwareReady", "InstanceImpaired")
        cl.update(got)
        back = cl.get(k.apis.Node, "sick")
        cond = back.status_conditions.get("AcceleratedHardwareReady")
        assert cond is not None and cond.status == "False" and cond.reason == "InstanceImpaired"
        assert not back.ready
        return k.convert.node_to_manifest(back)["status"]
    finally:
        cl.stop()


def f_auto_repair_over_the_wire(k, srv):
    cl, op = oracle_operator(k, srv)
    try:
        op.cluster.create(k.apis.TPUNodeClass("default"))
        op.cluster.create(k.apis.NodePool("default"))
        op.cluster.create(k.apis.Pod("p0", requests=k.sched.Resources(
            {"cpu": "500m", "memory": "1Gi"})))
        op.settle(max_ticks=40)
        inst = [i for i in op.cloud.describe_instances() if i.state == "running"][0]
        victim = next(c.metadata.name for c in op.cluster.list(k.apis.NodeClaim)
                      if c.provider_id == inst.provider_id)
        op.cloud.degrade_instance(inst.id)
        op.tick()
        node = next(n for n in op.cluster.list(k.apis.Node)
                    if n.provider_id == inst.provider_id)
        assert any(c.status == "False" for c in node.status_conditions.all())
        op.tick()
        op.clock.step(31 * 60.0)
        states = []
        for _ in range(12):
            op.tick()
            states.append(state(k, op))
            op.clock.step(5.0)
        live = {c.metadata.name: c.deleting for c in op.cluster.list(k.apis.NodeClaim)}
        assert victim not in live or live[victim]
        return [victim, states]
    finally:
        cl.stop()


def f_stateful_flow_over_the_wire(k, srv):
    cl, op = oracle_operator(k, srv)
    try:
        op.cluster.create(k.apis.TPUNodeClass("default"))
        op.cluster.create(k.apis.NodePool("default"))
        op.cluster.create(k.storage.StorageClass("standard"))
        op.cluster.create(k.storage.PersistentVolumeClaim("data-0", storage_class_name="standard"))
        op.cluster.create(k.apis.Pod("web-0", requests=k.sched.Resources(
            {"cpu": "500m", "memory": "1Gi"}), volume_claims=("data-0",)))
        op.settle(max_ticks=40)
        bound = op.cluster.get(k.apis.Pod, "web-0")
        assert bound.node_name
        node = next(n for n in op.cluster.list(k.apis.Node)
                    if n.metadata.name == bound.node_name)
        claim = op.cluster.get(k.storage.PersistentVolumeClaim, "data-0")
        assert claim.bound_zone == node.zone
        raw = cl.client.get("/api/v1/namespaces/default/persistentvolumeclaims/data-0")
        assert raw["spec"]["accessModes"]
        assert raw["metadata"]["annotations"]["storage.karpenter.tpu/bound-zone"] == node.zone
        # the node's CSINode (the kwok lifecycle publishes one) overlays its
        # attach limit; a smaller driver count shows at once
        csi = cl.get(k.storage.CSINode, node.metadata.name)
        published = list(csi.drivers)
        csi.drivers = (("csi.storage.dev/disk", 3),)
        cl.update(csi)
        limit = cl.get(k.apis.Node, node.metadata.name).allocatable.get(k.res.ATTACHABLE_VOLUMES)
        usage = op.cluster.node_usage(bound.node_name).get(k.res.ATTACHABLE_VOLUMES)
        assert usage == 1.0 and limit == 3.0
        return [bound.node_name, claim.bound_zone, raw["spec"], published, usage, limit,
                state(k, op)]
    finally:
        cl.stop()


FLOWS = {name[2:]: fn for name, fn in sorted(globals().items()) if name.startswith("f_")}


# slow: each flow settles an operator over two apiservers (~2-4 s a flow)
@pytest.mark.slow
@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_flow_alike(flow):
    got = {}
    servers = {which: FakeApiServer().start() for which in BOTH}
    try:
        for which in BOTH:
            k = PKG[which]
            saved = k.seeding.snapshot()
            try:
                got[which] = dumps(scrub(FLOWS[flow](k, servers[which])))
            finally:
                k.seeding.restore(saved)
    finally:
        stop_servers(servers.values())
    assert got["torch"] == got["jax"]


# -- the metrics controller's error branch ------------------------------------------------


class Warnings(logging.Handler):
    def __init__(self, msg):
        super().__init__()
        self.msg, self.count = msg, 0

    def emit(self, record):
        self.count += record.getMessage() == self.msg


def failing_pool_put(srv):
    """Answer every NodePool PUT (not its /status) with a 500."""
    base = srv._server.RequestHandlerClass

    class Handler(base):
        def do_PUT(self):
            path = self.path.split("?")[0]
            if "/nodepools/" in path and not path.endswith("/status"):
                self._body()
                return self._send(500, {"message": "injected: nodepool update refused"})
            return base.do_PUT(self)

    srv._server.RequestHandlerClass = Handler


def pool_put_refused(k, srv):
    """The operator over `srv`, whose NodePool PUTs fail, for six ticks:
    the warnings each tick logged and the state after."""
    failing_pool_put(srv)
    warn = Warnings("pool status update failed")
    root = logging.getLogger("karpenter")
    root.addHandler(warn)
    saved = k.seeding.snapshot()
    cl = None
    try:
        cl, op = oracle_operator(k, srv)
        op.cluster.create(k.apis.TPUNodeClass("default"))
        op.cluster.create(k.apis.NodePool("default"))
        op.cluster.create(k.apis.Pod("w", requests=k.sched.Resources({"cpu": "1"})))
        per_tick = []
        for _ in range(6):
            before = warn.count
            op.tick()
            per_tick.append(warn.count - before)
            op.clock.step(STEP)
        # the ticks went on: the pod was bound through the failing PUTs
        assert all(p.node_name for p in op.cluster.list(k.apis.Pod))
        return per_tick, state(k, op)
    finally:
        root.removeHandler(warn)
        if cl is not None:
            cl.stop()
        k.seeding.restore(saved)


def test_pool_status_update_error_branch():
    servers = {which: FakeApiServer().start() for which in BOTH}
    try:
        got = {which: pool_put_refused(PKG[which], servers[which]) for which in BOTH}
    finally:
        stop_servers(servers.values())
    assert got["torch"] == got["jax"]
    per_tick = got["torch"][0]
    # one warning for each tick whose pool-status update failed
    assert sum(per_tick) >= 1 and max(per_tick) == 1


# -- election over two clients on one apiserver -------------------------------------------


def test_election_over_two_clients():
    got = {}
    for which in BOTH:
        k = PKG[which]
        srv = FakeApiServer().start()
        clock = k.ttl.FakeClock(1_000.0)
        clusters = [kube_cluster(k, srv, clock=clock, list_cache_ttl=0.0) for _ in range(2)]
        try:
            a = k.election.LeaderElector(clusters[0], "replica-a")
            b = k.election.LeaderElector(clusters[1], "replica-b")
            seq = [a.tick(), b.tick()]
            clock.step(5.0)
            seq += [a.tick(), b.tick()]
            clock.step(20.0)
            seq += [b.tick(), a.tick()]
            lease = clusters[0].list(k.objects.Lease)[0]
            got[which] = (seq, lease.holder, lease.epoch)
        finally:
            for c in clusters:
                c.stop()
            srv.stop()
    # exactly one leads; the standby takes over after expiry; the old
    # leader observes the loss
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [True, False, True, False, True, False]
    assert got["torch"][1] == "replica-b"
