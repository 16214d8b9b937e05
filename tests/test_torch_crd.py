"""The port's CRD copy and CEL admission against the JAX package's, on the CPU.

- karpenter_tpu_torch/apis/crds/*.yaml are byte copies of the JAX
  package's karpenter_tpu/apis/crds/*.yaml;
- `celcheck.validate_manifest` returns the same failures, message and
  path, in both packages on every fixture of tests/test_crd_parity.py's
  corpus (the NodePool, NodeClaim and TPUNodeClass mutations and the
  manifest-only shapes), once on create (no `old`) and once as an update
  of the valid object (transition rules run);
- `celmini.evaluate` gives the same value, or raises alike, on the rule
  probes: every shipped rule against the fixtures' subtrees it guards,
  and the corpus's direct Gt/Lt probe.
"""
import copy
import glob
import os

import pytest
import yaml

import test_crd_parity as parity
from karpenter_tpu.apis import celcheck as jcelcheck
from karpenter_tpu.apis import celmini as jcelmini
from karpenter_tpu.kube import convert
from karpenter_tpu_torch.apis import celcheck as tcelcheck
from karpenter_tpu_torch.apis import celmini as tcelmini

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CRDS = os.path.join(REPO, "karpenter_tpu", "apis", "crds")
PORT_CRDS = os.path.join(REPO, "karpenter_tpu_torch", "apis", "crds")


def load(crd_dir):
    out = {}
    for f in sorted(glob.glob(os.path.join(crd_dir, "*.yaml"))):
        with open(f) as fh:
            crd = yaml.safe_load(fh)
        out[crd["spec"]["names"]["kind"]] = crd
    return out


JCRDS, TCRDS = load(JAX_CRDS), load(PORT_CRDS)


def test_crds_are_byte_copies():
    names = sorted(os.listdir(JAX_CRDS))
    assert sorted(os.listdir(PORT_CRDS)) == names and len(names) == 3
    for name in names:
        with open(os.path.join(JAX_CRDS, name), "rb") as a, open(os.path.join(PORT_CRDS, name),
                                                                 "rb") as b:
            assert a.read() == b.read(), name


# -- the corpus: (kind, manifest, the valid manifest it mutates) --------------------------


def pool_fixture(mutate):
    pool = parity.valid_pool()
    mutate(pool)
    return "NodePool", convert.nodepool_to_manifest(pool)


def nodeclass_fixture(mutate):
    m = convert.nodeclass_to_manifest(parity.valid_nodeclass())
    mutate(m)
    return "TPUNodeClass", m


def claim_fixtures():
    from karpenter_tpu.scheduling import Operator as Op, Requirement, Taint

    out = {"valid": parity.valid_claim()}
    c = parity.valid_claim()
    c.requirements.add(Requirement("karpenter.sh/nodepool", Op.IN, ["default"]))
    out["nodepool key allowed"] = c
    c = parity.valid_claim()
    c.requirements.add(Requirement("bad key!", Op.IN, ["x"]))
    out["bad requirement key"] = c
    c = parity.valid_claim()
    c.taints = [Taint(key="dedicated", value="bad value", effect="NoSchedule")]
    out["bad taint value"] = c
    docs = {name: ("NodeClaim", convert.nodeclaim_to_manifest(c)) for name, c in out.items()}
    m = convert.nodeclaim_to_manifest(parity.valid_claim())
    m["spec"]["expireAfter"] = "12h"
    docs["spec changed"] = ("NodeClaim", m)
    return docs


def corpus():
    out = {}
    for name, mutate, _ in parity.POOL_MUTATIONS:
        out[f"NodePool/{name}"] = pool_fixture(mutate)
    for name, mutate, _ in parity.NODECLASS_MANIFEST_MUTATIONS:
        out[f"TPUNodeClass/{name}"] = nodeclass_fixture(mutate)
    for name, doc in claim_fixtures().items():
        out[f"NodeClaim/{name}"] = doc
    m = convert.nodepool_to_manifest(parity.valid_pool())
    m["spec"]["weight"] = 0
    out["NodePool/explicit zero weight"] = ("NodePool", m)
    m = convert.nodeclass_to_manifest(parity.valid_nodeclass())
    m["spec"]["imageSelectorTerms"] = [{"alias": 5}]
    out["TPUNodeClass/type mismatch"] = ("TPUNodeClass", m)
    return out


CORPUS = corpus()
VALID = {
    "NodePool": convert.nodepool_to_manifest(parity.valid_pool()),
    "NodeClaim": convert.nodeclaim_to_manifest(parity.valid_claim()),
    "TPUNodeClass": convert.nodeclass_to_manifest(parity.valid_nodeclass()),
}


@pytest.mark.parametrize("fixture", sorted(CORPUS))
def test_failures_equal(fixture):
    kind, manifest = CORPUS[fixture]
    for old in (None, VALID[kind]):
        want = jcelcheck.validate_manifest(JCRDS[kind], copy.deepcopy(manifest),
                                           copy.deepcopy(old))
        got = tcelcheck.validate_manifest(TCRDS[kind], copy.deepcopy(manifest),
                                          copy.deepcopy(old))
        assert got == want


def test_corpus_rejects_as_the_jax_suite_expects():
    """Teeth: the corpus's expected verdicts hold through the port's
    checker (a fixture meant to reject yields failures)."""
    for name, _, reject in parity.POOL_MUTATIONS:
        kind, m = CORPUS[f"NodePool/{name}"]
        assert bool(tcelcheck.validate_manifest(TCRDS[kind], m)) == reject, name
    for name, _, reject in parity.NODECLASS_MANIFEST_MUTATIONS:
        kind, m = CORPUS[f"TPUNodeClass/{name}"]
        assert bool(tcelcheck.validate_manifest(TCRDS[kind], m)) == reject, name
    kind, m = CORPUS["NodeClaim/spec changed"]
    fails = tcelcheck.validate_manifest(TCRDS[kind], m, VALID[kind])
    assert any("immutable" in msg for _, msg in fails)


# -- celmini on the rule probes -----------------------------------------------------------


def rules_with_subtrees():
    """(rule, value) pairs: each shipped rule against every fixture value
    at a schema node that carries it (walked as celcheck walks)."""
    pairs = []

    def walk(schema, value):
        if value is None:
            return
        for r in schema.get("x-kubernetes-validations", []) or []:
            pairs.append((r["rule"], value))
        t = schema.get("type")
        if t == "object" and isinstance(value, dict):
            props = schema.get("properties", {})
            for key, sub in props.items():
                if key in value:
                    walk(sub, value[key])
            ap = schema.get("additionalProperties")
            if isinstance(ap, dict):
                for key, v in value.items():
                    if key not in props:
                        walk(ap, v)
        elif t == "array" and isinstance(schema.get("items"), dict) and isinstance(value, list):
            for v in value:
                walk(schema["items"], v)

    for kind, manifest in CORPUS.values():
        walk(JCRDS[kind]["spec"]["versions"][0]["schema"]["openAPIV3Schema"], manifest)
    return pairs


def outcome(mod, rule, *args):
    try:
        return ("value", mod.evaluate(rule, *args))
    except mod.CelError as e:
        return ("error", str(e))


def test_rule_probes_alike():
    pairs = rules_with_subtrees()
    assert len({r for r, _ in pairs}) > 20
    for rule, value in pairs:
        if jcelmini.references_old_self(rule):
            args = (value, value)
        else:
            args = (value,)
        assert tcelmini.references_old_self(rule) == jcelmini.references_old_self(rule)
        assert outcome(tcelmini, rule, *args) == outcome(jcelmini, rule, *args), rule


@pytest.mark.parametrize("expr,value", [
    ("self.operator in ['Gt', 'Lt'] ? (has(self.values) && self.values.size() == 1) : true",
     {"operator": "Gt", "values": ["1", "2"]}),
    ("self.all(k, k.startsWith('a') || k.endsWith('z'))", {"ab": 1, "yz": 2, "q": 3}),
    ("self.exists(x, x.contains('mid'))", ["amidst", "b"]),
    ("self.matches('^[a-z]+@v[0-9]+$') && self.split('@').size() == 2", "standard@v1"),
    ("int(self.split('%')[0]) <= 100", "150%"),
    ("self.lowerAscii() == 'abc' && !(self != 'ABC')", "ABC"),
    ("self.size() > 1 || self[0] >= 5", [3]),
    ("has(self.missing) ? self.missing : self.present", {"present": True}),
    ("self.nope == 1", {}),
    ("self == oldSelf", "x"),
])
def test_expression_probes_alike(expr, value):
    args = (value, value) if jcelmini.references_old_self(expr) else (value,)
    assert outcome(tcelmini, expr, *args) == outcome(jcelmini, expr, *args)
