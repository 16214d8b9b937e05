"""Fleet replay: N clusters' replay engines sharing ONE solver sidecar.

The ``multi-tenant == isolated`` differential, at the sim layer: each
tenant replays its own variant of the ``multi-cluster-storm`` scenario
(per-tenant seed -> staggered storm start, distinct pod mix) through a
SHARED coalescing sidecar -- one server holding every tenant's staged
catalogs and class epochs, every solve routed through the
DispatchCoalescer -- and its decision digest must equal (a) an isolated
replay of the same trace against a private plain sidecar and (b) the
golden pinned in ``tests/golden/scenarios/multi-cluster-storm.digests.json``.

Tenants replay SEQUENTIALLY here: the replay engine's determinism root
(seeded name/token RNGs) is process-global by design, so concurrent
engines would interleave RNG draws and the digests would stop being a
pure function of each tenant's trace. Sequential replay still drives the
shared-staging isolation surface end to end (N tenants' seqnums and
epoch chains interleaved on one server, every dispatch through the
coalescer); TRUE concurrent dispatch bit-identity is asserted at the
solver layer, where decisions carry no process-global RNG
(tests/test_torch_fleet.py, chip_smoke.py phase `fleet`).

Copy of karpenter_tpu/sim/fleet.py over the port: every engine, the
shared sidecar and each isolated one run on ``device`` (None = the card;
the tests pass "cpu"). ``mesh=True`` shards the shared sidecar over 8
shards of that device.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.sim.replay import ReplayResult, _Engine, replay
from karpenter_tpu_torch.sim.scenario import DEFAULT_SEED, build_scenario

# per-tenant seed spread: distinct storms (the builder derives its
# stagger and pod mix from the seed), deterministic per tenant index
TENANT_SEED_STRIDE = 97


def tenant_seed(base_seed: int, tenant_i: int) -> int:
    return base_seed + TENANT_SEED_STRIDE * tenant_i


def tenant_trace(tenant_i: int, base_seed: int = DEFAULT_SEED) -> List[dict]:
    """Tenant ``i``'s slice of the multi-cluster storm (see
    sim/scenario._scenario_multi_cluster_storm)."""
    return build_scenario("multi-cluster-storm", seed=tenant_seed(base_seed, tenant_i))


@dataclass
class FleetReplayResult:
    shared: Dict[str, ReplayResult] = field(default_factory=dict)
    isolated: Dict[str, ReplayResult] = field(default_factory=dict)
    divergences: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.divergences

    @property
    def digests(self) -> Dict[str, str]:
        return {t: r.digest for t, r in sorted(self.shared.items())}


def replay_fleet(
    n_tenants: int = 3, base_seed: int = DEFAULT_SEED, *,
    compare_isolated: bool = True, mesh: bool = False,
    tmpdir: Optional[str] = None, device=None,
) -> FleetReplayResult:
    """Replay N tenants through one shared coalescing sidecar on
    `device`; optionally re-replay each tenant isolated (its own plain
    sidecar) and record any digest divergence. ``mesh=True``
    additionally shards the shared sidecar's solves over 8 shards of
    `device` (sharded == unsharded rides the same differential)."""
    from karpenter_tpu_torch.fleet.service import build_fleet_server

    out = FleetReplayResult()
    own_tmp = None
    if tmpdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="karpenter-fleet-")
        tmpdir = own_tmp.name
    sock = os.path.join(tmpdir, "fleet-solver.sock")
    # mesh=False must stay single-device regardless of the environment:
    # a $KARPENTER_TPU_MESH leaking into the replay would be a hidden
    # input to a digest-pinned gate
    mesh_obj = None
    if mesh:
        from karpenter_tpu_torch.parallel.mesh import make_mesh
        from karpenter_tpu_torch.solver.service import resolve_device

        mesh_obj = make_mesh(8, devices=[resolve_device(device)] * 8)
    server = build_fleet_server(
        path=sock, mesh=mesh_obj if mesh else False, coalesce=True,
        device=None if mesh else device,
    )
    try:
        for i in range(n_tenants):
            tenant = f"cluster-{i}"
            events = tenant_trace(i, base_seed)
            seed = tenant_seed(base_seed, i)
            engine = _Engine(
                "wire", seed, tmpdir, device=device,
                server_path=sock, tenant=tenant,
            )
            try:
                engine.build()
                out.shared[tenant] = engine.run(events)
            finally:
                engine.close()
        if compare_isolated:
            for i in range(n_tenants):
                tenant = f"cluster-{i}"
                events = tenant_trace(i, base_seed)
                out.isolated[tenant] = replay(
                    events, backend="wire", seed=tenant_seed(base_seed, i),
                    device=device,
                )
                a = out.shared[tenant].digest
                b = out.isolated[tenant].digest
                if a != b:
                    out.divergences.append(
                        f"{tenant}: shared-sidecar digest {a[:12]} != "
                        f"isolated digest {b[:12]}"
                    )
    finally:
        server.stop()
        if own_tmp is not None:
            own_tmp.cleanup()
    return out
