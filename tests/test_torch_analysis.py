"""The port's static checkers (karpenter_tpu_torch/analysis/) against the JAX package's.

- every rule that carries over fires on tests/test_analysis.py's source
  snippets (tests/fixtures/lint/) with the same rule ids and counts,
  through both packages' checkers -- the port's under its own paths;
- each torch_discipline rule has a firing case and a clean case;
- the port's tree is clean against its baseline, every entry justified;
- `python -m karpenter_tpu_torch.analysis` exits 0 in a subprocess and
  imports neither torch, numpy nor jax;
- the registry checker leaves every file under docs/ byte-identical.
"""
import ast
import hashlib
import pathlib
import subprocess
import sys

import pytest

from karpenter_tpu.analysis import base as jbase
from karpenter_tpu.analysis.checkers import (determinism as jdeterminism, errflow as jerrflow,
                                             locks as jlocks, registry_drift as jregistry,
                                             reslife as jreslife, zerocopy as jzerocopy)
from karpenter_tpu_torch.analysis import base as tbase
from karpenter_tpu_torch.analysis.checkers import (determinism as tdeterminism,
                                                   errflow as terrflow, locks as tlocks,
                                                   registry_drift as tregistry,
                                                   reslife as treslife,
                                                   torch_discipline as td,
                                                   zerocopy as tzerocopy)

REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "lint"

PKG = {
    "jax": dict(base=jbase, determinism=jdeterminism, errflow=jerrflow, locks=jlocks,
                registry=jregistry, reslife=jreslife, zerocopy=jzerocopy,
                root="karpenter_tpu", solver="TPUSolver"),
    "torch": dict(base=tbase, determinism=tdeterminism, errflow=terrflow, locks=tlocks,
                  registry=tregistry, reslife=treslife, zerocopy=tzerocopy,
                  root="karpenter_tpu_torch", solver="TorchSolver"),
}
both = pytest.mark.parametrize("pkg", ["jax", "torch"])


def forged(p, name, rel, rename=True):
    """One fixture parsed under a forged path of package `p` (the scopes
    key off the real framing and service paths); the solver class is
    renamed to the package's own."""
    source = (FIXTURES / name).read_text()
    if rename:
        source = source.replace("TPUSolver", p["solver"])
    return p["base"].Module(path=FIXTURES / name, rel=f"{p['root']}/{rel}", source=source,
                            tree=ast.parse(source), lines=source.splitlines())


def snippet(p, src, rel):
    return p["base"].Module(path=pathlib.Path("t.py"), rel=rel, source=src,
                            tree=ast.parse(src), lines=src.splitlines())


def by_rule(violations, suffix=""):
    out = {}
    for v in violations:
        if v.path.endswith(suffix):
            out[v.rule] = out.get(v.rule, 0) + 1
    return out


# -- the rules that carry over, on the JAX suite's fixtures --------------------------------


@both
@pytest.mark.parametrize("family, bad, ok, want", [
    ("determinism", "det_bad.py", "det_ok.py",
     {"determinism/uuid4": 2, "determinism/random": 3, "determinism/wallclock": 4,
      "determinism/iter-order": 4}),
    ("locks", "locks_bad.py", "locks_ok.py", None),
    ("errflow", "errflow_bad.py", "errflow_ok.py",
     {"errflow/swallow-crash": 2, "errflow/broad-swallow": 1, "errflow/return-in-finally": 1}),
    ("reslife", "reslife_bad.py", "reslife_ok.py",
     {"reslife/unreleased": 1, "reslife/leak-on-error": 2, "reslife/unjoined-thread": 1,
      "reslife/self-unreleased": 1}),
])
def test_fixture_rules_fire_and_stay_quiet(pkg, family, bad, ok, want):
    p = PKG[pkg]
    check = p[family].check
    out = check(p["base"].iter_modules(FIXTURES))
    got = by_rule(out, bad)
    if want is None:   # locks: the JAX suite pins the rule set
        assert set(got) == {"locks/order-cycle", "locks/self-deadlock", "locks/mixed-guard"}
    else:
        assert got == want
    assert by_rule(out, ok) == {}


def test_fixture_findings_are_the_same_in_both_packages():
    for family in ("determinism", "locks", "errflow", "reslife"):
        j = PKG["jax"][family].check(jbase.iter_modules(FIXTURES))
        t = PKG["torch"][family].check(tbase.iter_modules(FIXTURES))
        assert sorted((v.rule, v.path, v.line) for v in j) == \
            sorted((v.rule, v.path, v.line) for v in t), family


@both
def test_lock_graph_edges_on_fixture(pkg):
    g = PKG[pkg]["locks"].lock_graph(PKG[pkg]["base"].iter_modules(FIXTURES))
    ids = {lid.rsplit(".", 1)[-1]: lid for lid in g.locks}
    pairs = g.edge_set()
    assert (ids["ALPHA"], ids["BETA"]) in pairs and (ids["BETA"], ids["ALPHA"]) in pairs
    assert (ids["GAMMA"], ids["GAMMA"]) in pairs
    assert (ids["DELTA"], ids["EPSILON"]) in pairs and (ids["EPSILON"], ids["DELTA"]) in pairs


@both
def test_zerocopy_fires_on_framing_functions(pkg):
    p = PKG[pkg]
    out = p["zerocopy"].check([forged(p, "zerocopy_bad.py", "solver/rpc.py")])
    assert len(out) == 3 and {v.rule for v in out} == {"zerocopy/copy-construct"}
    out = p["zerocopy"].check([forged(p, "zerocopy_bad.py", "solver/shm.py")])
    assert {v.message.split(":")[0] for v in out} == {"RingEndpoint.sendmsg",
                                                      "RingEndpoint.recv_into"}


@both
def test_seam_rules_fire_on_forged_trees(pkg):
    p = PKG[pkg]
    fired = {v.rule for v in p["errflow"].check([forged(p, "errflow_seam_bad.py",
                                                        "solver/service.py")])}
    assert fired == {"errflow/seam-ladder-escape", "errflow/seam-missing"}
    out = p["errflow"].check([forged(p, "errflow_undeclared_bad.py", "solver/rpc.py")])
    assert {v.rule for v in out} == {"errflow/seam-undeclared-escape"}
    assert any("RuntimeError" in v.message for v in out)


@both
def test_registry_fires_on_undocumented_names(pkg):
    p = PKG[pkg]
    mod = forged(p, "registry_bad.py", "solver/rpc.py")
    fired = {v.rule for v in p["registry"].check([mod])}
    assert {"registry/metric-undocumented", "registry/failpoint-undocumented",
            "registry/feature-undocumented", "registry/seam-unfailpointed"} <= fired


@both
@pytest.mark.parametrize("case", ["handlers", "orelse-finally", "transitive", "failpoints",
                                  "unresolvable", "recursion"])
def test_escape_sets(pkg, case):
    p = PKG[pkg]
    srcs = {
        "handlers": ("def inner():\n    raise ConnectionError('x')\n"
                     "def absorbed():\n    try:\n        inner()\n    except OSError:\n        pass\n"
                     "def rethrown():\n    try:\n        inner()\n    except ConnectionError:\n"
                     "        raise\n"),
        "orelse-finally": ("def f():\n    try:\n        pass\n    except ValueError:\n        pass\n"
                           "    else:\n        raise ValueError('else')\n"),
        "transitive": "def deep():\n    raise KeyError('k')\ndef mid():\n    deep()\n"
                      "def top():\n    mid()\n",
        "failpoints": ("from x import failpoints\ndef wire_seam():\n"
                       "    failpoints.eval('rpc.fake.site')\n"),
        "unresolvable": ("import thirdparty\ndef f():\n    try:\n        raise ConnectionError('x')\n"
                         "    except thirdparty.WeirdError:\n        pass\n"),
        "recursion": ("def a():\n    try:\n        b()\n    except KeyError:\n        pass\n"
                      "    raise ValueError('own')\ndef b():\n    a()\n    raise KeyError('k')\n"),
    }
    want = {"handlers": ("rethrown", {"ConnectionError"}), "orelse-finally": ("f", {"ValueError"}),
            "transitive": ("top", {"KeyError"}),
            "failpoints": ("wire_seam", {"ConnectionError", "OperatorCrashed"}),
            "unresolvable": ("f", {"ConnectionError"}), "recursion": ("b", {"KeyError", "ValueError"})}
    rel = f"{p['root']}/solver/x.py"
    mod = snippet(p, srcs[case], rel)
    an = p["errflow"].ExcAnalyzer([mod])
    fn, names = want[case]
    assert names <= an.escapes(p["errflow"]._modname(rel), "", fn)
    if case == "handlers":
        assert an.escapes(p["errflow"]._modname(rel), "", "absorbed") == frozenset()


# -- the port's own: the torch rules of determinism ----------------------------------------


@pytest.mark.parametrize("src, fires", [
    ("import torch\nx = torch.rand(3)\n", True),
    ("import torch\nx = torch.randn(3, generator=g)\n", False),
    ("import torch\ntorch.manual_seed(1)\n", True),
    ("import torch\ntorch.cuda.manual_seed_all(1)\n", True),
    ("import torch\ng = torch.Generator().manual_seed(1)\n", False),
    ("def f(t):\n    t.uniform_()\n", True),
    ("def f(t, g):\n    t.normal_(generator=g)\n", False),
    ("import torch\nx = torch.randperm(5)\n", True),
])
def test_determinism_torch_generators(src, fires):
    out = tdeterminism.check([snippet(PKG["torch"], src, "karpenter_tpu_torch/x.py")])
    assert ({v.rule for v in out} == {"determinism/random"}) is fires, out


def test_seeding_module_is_exempt():
    mods = tbase.iter_modules()
    assert tdeterminism.EXEMPT_MODULES == ("karpenter_tpu_torch/seeding.py",)
    assert not any(v.path == "karpenter_tpu_torch/seeding.py" for v in tdeterminism.check(mods))


# -- torch_discipline: a firing and a clean case for every rule --------------------------

SVC = "karpenter_tpu_torch/solver/service.py"
FFD = "karpenter_tpu_torch/solver/ffd.py"
AOT = "karpenter_tpu_torch/solver/aot.py"
KSCAN = "karpenter_tpu_torch/solver/kernels/ffd_scan.py"
CASES = "karpenter_tpu_torch/solver/kernels/cases.py"

KERNEL_OK = ("launches = 0\n"
             "def fused_scan(x, *, g_max, objective):\n"
             "    if x.device.type == 'cpu':\n"
             "        return fused_scan_reference(x, g_max=g_max, objective=objective)\n"
             "    return _launch(x)\n"
             "def _launch(x):\n"
             "    global launches\n"
             "    launches += 1\n"
             "def fused_scan_reference(x, *, g_max, objective):\n"
             "    return x\n")
CASES_OK = "def padded_between(cs):\n    pass\ndef zero_request(cs, c):\n    pass\n"

RULE_CASES = {
    "torchjit/unbounded-static": (
        [(SVC, "class S:\n    def d(self, inp):\n        st = dict(g_max=1, pod_count=len(inp))\n"
               "        self._aot.try_call('ffd_solve_fused', (inp,), st)\n")],
        [(SVC, "class S:\n    def d(self, inp, offsets):\n"
               "        st = dict(word_offsets=offsets, words=2)\n"
               "        self._aot.try_call('fractional_price_bound', (inp,), dict(g_max=1, **st))\n")]),
    "torchjit/kernel-twin": (
        [(KSCAN, KERNEL_OK.replace("fused_scan_reference", "plain_scan")
          .replace("return plain_scan(x", "return fused_scan_reference(x")), (CASES, CASES_OK)],
        [(KSCAN, KERNEL_OK), (CASES, CASES_OK)]),
    "torchjit/closure-state": (
        [(AOT, "class M:\n    def plan(self):\n"
               "        self._lower_task(0, 'e', 'karpenter_tpu_torch.solver.ffd', 'entry', (), {}, 'x')\n"),
         (FFD, "cache = {}\ndef entry(inp, *, g_max):\n    return inp + cache['k']\n")],
        [(AOT, "class M:\n    def plan(self):\n"
               "        self._lower_task(0, 'e', 'karpenter_tpu_torch.solver.ffd', 'entry', (), {}, 'x')\n"),
         (FFD, "SCALE = 2\ndef entry(inp, *, g_max):\n    return inp * SCALE\n")]),
    "torchjit/traced-branch": (
        [(FFD, "import torch\ndef ffd_solve_fused(inp, *, g_max):\n    n = torch.sum(inp)\n"
               "    if n > 0:\n        return n\n    return inp\n")],
        [(FFD, "import torch\ndef ffd_solve_fused(inp, *, g_max):\n    n = torch.sum(inp)\n"
               "    if n is None:\n        return inp\n"
               "    if inp.shape[0] > 0:\n        return torch.where(n > 0, n, 0)\n    return inp\n")]),
    "torchjit/weak-dtype": (
        [(FFD, "import torch\ndef ffd_solve_fused(inp, *, g_max):\n"
               "    return torch.zeros(g_max, device=inp.device)\n")],
        [(FFD, "import torch\ndef ffd_solve_fused(inp, *, g_max):\n"
               "    return torch.zeros(g_max, dtype=torch.int32, device=inp.device)\n")]),
    "torchhost/item": (
        [(SVC, "class TorchSolver:\n    def solve_finish(self, p):\n        return p.buf.item()\n")],
        [(SVC, "class TorchSolver:\n    def solve_finish(self, p):\n        return p.buf\n")]),
    "torchhost/scalar-cast": (
        [(SVC, "import torch\nclass TorchSolver:\n    def solve_finish(self, p):\n"
               "        n = torch.sum(p.buf)\n        return int(n)\n")],
        [(SVC, "import torch\nclass TorchSolver:\n    def solve_finish(self, p):\n"
               "        n = torch.sum(p.buf)\n        n = ffd.fetch_fused(n)\n        return int(n[0])\n")]),
    "torchhost/np-on-device": (
        [(SVC, "class TorchSolver:\n    def solve_finish(self, p):\n        return p.buf.cpu()\n")],
        [(FFD, "def fetch_fused(buf):\n    return buf.cpu().numpy()\n")]),
    "torchhost/synchronize": (
        [(SVC, "import torch\nclass TorchSolver:\n    def _pack_existing(self, c, n, r):\n"
               "        torch.cuda.synchronize()\n")],
        [(SVC, "import torch\nclass TorchSolver:\n    def _pack_existing(self, c, n, r):\n"
               "        return torch.cuda.current_stream()\n")]),
}


def run_td(files):
    mods = [snippet(PKG["torch"], src, rel) for rel, src in files]
    return td.check_retrace(mods) + td.check_hostsync(mods)


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_torch_discipline_rule_fires(rule):
    bad, _ = RULE_CASES[rule]
    assert rule in {v.rule for v in run_td(bad)}


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_torch_discipline_rule_clean(rule):
    _, ok = RULE_CASES[rule]
    assert [v.render() for v in run_td(ok) if v.rule == rule] == []


def test_no_fallback_in_a_handler_around_a_launch():
    src = ("def dispatch(x):\n    try:\n        return ffd_scan.fused_scan(x, g_max=1, objective='p')\n"
           "    except RuntimeError:\n        return ffd_scan.fused_scan_reference(x, g_max=1, objective='p')\n")
    out = run_td([(SVC, src)])
    assert [v.rule for v in out] == ["torchjit/kernel-twin"]
    assert "never falls back" in out[0].message


def test_real_tree_kernel_entries_and_captures():
    mods = tbase.iter_modules()
    assert sorted(td.kernel_entries(mods)) == sorted(td.KERNEL_TWINS)
    captured = td.captured_entries(mods)
    assert ("karpenter_tpu_torch/solver/ffd.py", "ffd_solve_fused") in captured
    assert ("karpenter_tpu_torch/solver/bound.py", "fractional_price_bound") in captured


def test_hot_path_and_sanctioned_fetch_manifests_exist():
    by_rel = {m.rel: m for m in tbase.iter_modules()}
    names = {}
    for rel, (funcs, classes) in td.DEVICE_HOT_PATH.items():
        tree = by_rel[rel].tree
        top = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
        assert set(funcs) <= top, rel
        cls = {n.name: {i.name for i in n.body if isinstance(i, ast.FunctionDef)}
               for n in tree.body if isinstance(n, ast.ClassDef)}
        for c, methods in classes.items():
            assert set(methods) <= cls[c], (rel, c)
        names[rel] = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    for rel, fn in td.SANCTIONED_FETCH:
        assert fn in names.get(rel, ()), f"sanctioned {rel}:{fn} is not in DEVICE_HOT_PATH"


def test_static_bucket_manifest_entries_justified():
    for name, why in td.STATIC_ARG_BUCKETS.items():
        assert len(why) > 20, name


# -- the port's tree -------------------------------------------------------------------


def test_real_tree_clean_under_the_baseline():
    fresh, matched, stale = tbase.apply_baseline(tbase.run_suite(), tbase.load_baseline())
    assert fresh == [], "\n".join(v.render() for v in fresh)
    assert stale == []


def test_baseline_is_small_and_justified():
    entries = tbase.load_baseline()
    assert tbase.BASELINE_PATH == REPO / "karpenter_tpu_torch" / "analysis" / "lint_baseline.json"
    assert 0 < len(entries) <= 20
    for e in entries:
        assert e["path"].startswith("karpenter_tpu_torch/")
        assert len(e["justification"]) > 40, e


def test_real_tree_lock_graph_is_cycle_free():
    g = tlocks.lock_graph(tbase.iter_modules())
    assert g.cycles() == []
    assert len(g.locks) >= 15 and g.edges
    # the cold-start layer's sites are in the graph
    sites = {ld.site.rsplit(":", 1)[0] for ld in g.locks.values()}
    assert {"karpenter_tpu_torch/solver/aot.py", "karpenter_tpu_torch/solver/service.py",
            "karpenter_tpu_torch/obs/jitstats.py",
            "karpenter_tpu_torch/solver/kernels/build.py"} <= sites


def test_real_tree_seams_exist_and_terminal_rungs_hold():
    mods = tbase.iter_modules()
    by_rel = {m.rel: m for m in mods}
    for seam in terrflow.LADDER_SEAMS:
        names = {n.name for n in ast.walk(by_rel[seam.rel].tree)
                 if isinstance(n, ast.FunctionDef)}
        assert seam.func in names, seam.key
        assert seam.failpoint and len(seam.why) > 20
    g = terrflow.exception_graph(mods)
    for key in ("karpenter_tpu_torch/solver/disrupt/engine.py:DisruptEngine.evaluate",
                "karpenter_tpu_torch/solver/service.py:TorchSolver._probe_sidecar"):
        assert g["seams"][key]["ladder_escapes"] in ([], ["OperatorCrashed"]), key
    # the fleet's seams: the coalescer's tenant dispatch, then the mesh's
    # degrade ladder (the JAX manifest's three)
    fleet = [s.key for s in terrflow.LADDER_SEAMS
             if s.rel.startswith(("karpenter_tpu_torch/fleet/", "karpenter_tpu_torch/parallel/"))]
    assert fleet == ["karpenter_tpu_torch/fleet/coalesce.py:DispatchCoalescer._run_one",
                     "karpenter_tpu_torch/fleet/shard.py:MeshSolveEngine._dispatch",
                     "karpenter_tpu_torch/fleet/shard.py:MeshSolveEngine._reshard",
                     "karpenter_tpu_torch/fleet/straggler.py:ShardStragglerWatchdog.check_now"]
    for key in (fleet[0], fleet[2], fleet[3]):
        assert g["seams"][key]["ladder_escapes"] in ([], ["OperatorCrashed"]), key
    for table in (terrflow.SANCTIONED_CRASH_SWALLOWS, terrflow.SANCTIONED_ESCAPE_SITES):
        for (rel, func), why in table.items():
            assert rel.startswith("karpenter_tpu_torch/") and len(why) > 40


def test_jit_entry_registry_equals_the_dispatched_entries(monkeypatch):
    mods = tbase.iter_modules()
    registry = tregistry.jit_entry_registry(mods)
    dispatched = tregistry.jit_entries_dispatched(mods)
    assert registry == set(dispatched)
    assert ("karpenter_tpu_torch.solver.kernels.ffd_scan", "fused_scan") in registry
    # drift fires both ways: a stale name and an entry missing from the registry
    jmod = next(m for m in mods if m.rel == tregistry.JITSTATS_REL)
    src = jmod.source.replace('"fused_scan",', '"fused_scan", "gone_entry",').replace(
        '("fractional_price_bound",)', "()")
    forged_mod = snippet(PKG["torch"], src, tregistry.JITSTATS_REL)
    rules = by_rule([v for v in tregistry.check([m if m.rel != tregistry.JITSTATS_REL else forged_mod
                                                 for m in mods])
                     if v.rule.startswith("registry/jit-entry")])
    assert rules == {"registry/jit-entry-stale": 1, "registry/jit-entry-unregistered": 1}


def test_omitted_families_are_explicit(monkeypatch):
    # the ten karpenter_mesh_* families are registered now: the one
    # omission left is the fallback counter the port never moves
    assert set(tregistry.OMITTED_FAMILIES) == {"karpenter_solver_kernel_fallbacks_total"}
    for why in tregistry.OMITTED_FAMILIES.values():
        assert len(why) > 40
    mods = tbase.iter_modules()
    assert [v for v in tregistry.check(mods) if v.rule == "registry/metric-unported"] == []
    from karpenter_tpu_torch import metrics as tmetrics

    assert len([n for n in tmetrics.REGISTRY._metrics if n.startswith("karpenter_mesh_")]) == 10
    monkeypatch.delitem(tregistry.OMITTED_FAMILIES, "karpenter_solver_kernel_fallbacks_total")
    out = [v for v in tregistry.check(mods) if v.rule == "registry/metric-unported"]
    assert out and all("karpenter_solver_kernel_fallbacks_total" in v.message for v in out)


def _docs_digest():
    h = hashlib.sha256()
    for p in sorted((REPO / "docs").rglob("*")):
        if p.is_file():
            h.update(str(p.relative_to(REPO)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_registry_checker_leaves_docs_untouched():
    before = _docs_digest()
    tregistry.check(tbase.iter_modules())
    from karpenter_tpu_torch.analysis.__main__ import main

    assert main(["--rules", "registry"]) == 0
    assert _docs_digest() == before


def test_cli_exits_0_and_imports_nothing_heavy():
    code = ("import sys\n"
            "from karpenter_tpu_torch.analysis.__main__ import main\n"
            "rc = main([])\n"
            "bad = [m for m in ('torch', 'numpy', 'jax', 'karpenter_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n"
            "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: clean" in r.stdout
    r = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.analysis"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cli_graph_dumps(capsys):
    import json

    from karpenter_tpu_torch.analysis.__main__ import main

    assert main(["--graph"]) == 0
    assert json.loads(capsys.readouterr().out)["cycles"] == []
    assert main(["--graph", "--family", "errflow", "--seam", "TorchSolver"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["seams"] and all("TorchSolver" in k for k in payload["seams"])


def test_stale_entry_fails_the_cli(tmp_path, capsys):
    from karpenter_tpu_torch.analysis.__main__ import main

    bogus = tmp_path / "baseline.json"
    bogus.write_text('{"entries": [{"rule": "determinism/uuid4", "path": '
                     '"karpenter_tpu_torch/nope.py", "line": 1, "line_text": "x = uuid.uuid4()", '
                     '"justification": "long gone"}]}')
    assert main(["--baseline", str(bogus), "--rules", "determinism"]) == 1
    assert "stale entry" in capsys.readouterr().err
