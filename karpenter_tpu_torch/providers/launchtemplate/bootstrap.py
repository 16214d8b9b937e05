"""Node bootstrap userdata rendering.

Rebuilds the per-image-family bootstrappers of
pkg/providers/amifamily/bootstrap/ (eksbootstrap script, nodeadm YAML,
bottlerocket TOML, windows powershell, MIME multipart merging
bootstrap/mime/mime.go): each family renders the cluster join config plus
kubelet flags, merging any user-supplied custom userdata.

Copy of karpenter_tpu/providers/launchtemplate/bootstrap.py, imports rewritten to the port's.
"""
from __future__ import annotations

import textwrap
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis.nodeclass import KubeletConfiguration, TPUNodeClass

MIME_BOUNDARY = "BOUNDARY"


def _kubelet_args(kubelet: KubeletConfiguration, max_pods: Optional[int]) -> List[str]:
    args = []
    if max_pods is not None:
        args.append(f"--max-pods={max_pods}")
    if kubelet.pods_per_core:
        args.append(f"--pods-per-core={kubelet.pods_per_core}")
    if kubelet.kube_reserved:
        args.append("--kube-reserved=" + ",".join(f"{k}={v}" for k, v in sorted(kubelet.kube_reserved.items())))
    if kubelet.system_reserved:
        args.append("--system-reserved=" + ",".join(f"{k}={v}" for k, v in sorted(kubelet.system_reserved.items())))
    if kubelet.eviction_hard:
        args.append("--eviction-hard=" + ",".join(f"{k}<{v}" for k, v in sorted(kubelet.eviction_hard.items())))
    if kubelet.eviction_soft:
        args.append("--eviction-soft=" + ",".join(f"{k}<{v}" for k, v in sorted(kubelet.eviction_soft.items())))
        # kubelet REQUIRES a grace period per soft signal (admission
        # enforces the pairing, apis/validation.py)
        args.append(
            "--eviction-soft-grace-period="
            + ",".join(f"{k}={v}" for k, v in sorted(kubelet.eviction_soft_grace_period.items()))
        )
    if kubelet.cluster_dns:
        args.append("--cluster-dns=" + ",".join(kubelet.cluster_dns))
    return args


def render_standard(
    cluster_name: str,
    endpoint: str,
    ca_bundle: str,
    nodeclass: TPUNodeClass,
    labels: Dict[str, str],
    taints: List,
    max_pods: Optional[int],
) -> str:
    """Shell bootstrap (the eksbootstrap.sh analogue), MIME-merged with any
    custom userdata (custom part first, like the reference's merge order)."""
    label_str = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    taint_str = ",".join(f"{t.key}={t.value}:{t.effect}" for t in taints)
    script = textwrap.dedent(
        f"""\
        #!/bin/bash
        set -euo pipefail
        /usr/local/bin/bootstrap-node \\
          --cluster {cluster_name} \\
          --endpoint {endpoint} \\
          --ca-bundle {ca_bundle} \\
          --node-labels '{label_str}' \\
          --taints '{taint_str}' \\
          {" ".join(_kubelet_args(nodeclass.kubelet, max_pods))}
        """
    )
    parts: List[tuple] = []
    if nodeclass.user_data:
        mime_parts = _unpack_mime(nodeclass.user_data)
        if mime_parts is not None:
            # the user supplied a MIME archive of their own: LIFT its
            # parts into the merged archive -- ALL part headers ride
            # along (Content-Transfer-Encoding etc.; dropping them would
            # corrupt base64-encoded parts) -- instead of nesting the
            # whole document as one opaque shell part. The reference's
            # mime merge does the same (bootstrap/mime/mime.go: parts
            # concatenate, custom first).
            parts.extend(mime_parts)
        else:
            parts.append((_SHELL_HEADERS, nodeclass.user_data))
    parts.append((_SHELL_HEADERS, script))
    if len(parts) == 1:
        return parts[0][1]
    # RFC 2046: parts delimited by "--" + boundary, terminated by
    # "--" + boundary + "--" (reference merges userdata the same way,
    # bootstrap/mime/mime.go:121)
    body = [f'MIME-Version: 1.0\nContent-Type: multipart/mixed; boundary="{MIME_BOUNDARY}"\n']
    for headers, p in parts:
        body.append(f"--{MIME_BOUNDARY}\n{headers}\n\n{p}")
    body.append(f"--{MIME_BOUNDARY}--")
    return "\n".join(body)


_SHELL_HEADERS = 'Content-Type: text/x-shellscript; charset="us-ascii"'


def _unpack_mime(user_data: str):
    """If `user_data` is itself a multipart MIME document, return its
    [(header block, body)] parts in order; otherwise None. Detection is
    header-based (a multipart content type before the first blank line),
    so a shell script mentioning MIME in a comment stays opaque. The
    header block carries EVERY part header verbatim (a part lacking
    Content-Type gets MIME's text/plain default, never an executable
    type); the body stays in its original transfer encoding, which the
    preserved headers describe."""
    import email

    head = user_data.split("\n\n", 1)[0].lower()
    if "content-type:" not in head or "multipart/" not in head:
        return None
    msg = email.message_from_string(user_data)
    if not msg.is_multipart():
        return None
    out = []
    for part in msg.walk():
        if part.is_multipart():
            continue
        items = list(part.items())
        if not any(k.lower() == "content-type" for k, _ in items):
            items.insert(0, ("Content-Type", "text/plain"))
        headers = "\n".join(f"{k}: {v}" for k, v in items)
        out.append((headers, part.get_payload()))
    return out


def render_declarative(
    cluster_name: str,
    endpoint: str,
    ca_bundle: str,
    nodeclass: TPUNodeClass,
    labels: Dict[str, str],
    taints: List,
    max_pods: Optional[int],
) -> str:
    """Config-file bootstrap (the nodeadm-YAML / bottlerocket-TOML analogue):
    structured config the node agent consumes, user config merged under it."""
    lines = [
        "node-config:",
        f"  cluster: {cluster_name}",
        f"  endpoint: {endpoint}",
        f"  ca-bundle: {ca_bundle}",
        "  labels:",
    ]
    for k, v in sorted(labels.items()):
        lines.append(f"    {k}: {v!r}")
    if taints:
        lines.append("  taints:")
        for t in taints:
            lines.append(f"    - {t.key}={t.value}:{t.effect}")
    if max_pods is not None:
        lines.append(f"  max-pods: {max_pods}")
    if nodeclass.user_data:
        lines.append("  user-config: |")
        for l in nodeclass.user_data.splitlines():
            lines.append(f"    {l}")
    return "\n".join(lines) + "\n"


_TOML_ESCAPES = {
    "\\": "\\\\", '"': '\\"', "\n": "\\n", "\t": "\\t", "\r": "\\r",
    "\b": "\\b", "\f": "\\f",
}


def _toml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, list):
        return "[" + ", ".join(_toml_scalar(x) for x in v) + "]"
    s = str(v)
    out = []
    for ch in s:
        esc = _TOML_ESCAPES.get(ch)
        if esc is not None:
            out.append(esc)
        elif ord(ch) < 0x20:
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


def _toml_key(k: str) -> str:
    return k if k.replace("-", "").replace("_", "").isalnum() else f'"{k}"'


def _toml_dump(
    tree: Dict, prefix: str = "", lines: Optional[List[str]] = None,
    _array_elem: bool = False,
) -> str:
    """Serialize a nested dict as TOML: scalars of each table first, then
    sub-tables depth-first with dotted [a.b] headers, then arrays of tables
    as [[a.b]] blocks (sub-tables inside an element use dotted headers,
    which TOML attaches to the most recent [[a.b]]). Keys are quoted when
    needed (label names contain dots/slashes). Round-trips everything
    tomllib can parse."""
    if lines is None:
        lines = []

    def is_aot(v):  # array of tables
        return isinstance(v, list) and v and all(isinstance(x, dict) for x in v)

    scalars = {k: v for k, v in tree.items() if not isinstance(v, dict) and not is_aot(v)}
    subs = {k: v for k, v in tree.items() if isinstance(v, dict)}
    aots = {k: v for k, v in tree.items() if is_aot(v)}
    if prefix:
        if _array_elem:
            lines.append(f"[[{prefix}]]")
        elif scalars or not (subs or aots):
            lines.append(f"[{prefix}]")
    for k, v in scalars.items():
        lines.append(f"{_toml_key(k)} = {_toml_scalar(v)}")
    for k, v in subs.items():
        _toml_dump(v, f"{prefix}.{_toml_key(k)}" if prefix else _toml_key(k), lines)
    for k, elems in aots.items():
        header = f"{prefix}.{_toml_key(k)}" if prefix else _toml_key(k)
        for elem in elems:
            _toml_dump(elem, header, lines, _array_elem=True)
    return "\n".join(lines) + "\n"


def _deep_merge(base: Dict, override: Dict) -> Dict:
    """Merge `override` onto `base`, recursing into shared sub-tables;
    override's leaves win on conflict."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def render_toml(
    cluster_name: str,
    endpoint: str,
    ca_bundle: str,
    nodeclass: TPUNodeClass,
    labels: Dict[str, str],
    taints: List,
    max_pods: Optional[int],
) -> str:
    """Immutable-OS TOML bootstrap (the Bottlerocket analogue): settings
    tree only, no scripts. User TOML is parsed and merged STRUCTURALLY with
    the generated settings tree -- generated values win on key conflict
    (the reference merges Bottlerocket userdata the same way,
    pkg/providers/amifamily/bootstrap/bottlerocket.go; a textual prepend
    would make duplicate tables a TOML parse error, ADVICE round 1)."""
    try:
        import tomllib
    except ModuleNotFoundError:  # py3.10: tomllib landed in 3.11
        import tomli as tomllib  # same API -- tomllib was vendored from tomli

    user_tree: Dict = {}
    if nodeclass.user_data:
        try:
            user_tree = tomllib.loads(nodeclass.user_data)
        except tomllib.TOMLDecodeError as e:
            raise ValueError(f"nodeclass user_data is not valid TOML: {e}") from e

    kube: Dict = {
        "cluster-name": cluster_name,
        "api-server": endpoint,
        "cluster-certificate": ca_bundle,
    }
    if max_pods is not None:
        kube["max-pods"] = max_pods
    if labels:
        kube["node-labels"] = {k: v for k, v in sorted(labels.items())}
    if taints:
        # aggregate by key: multiple taints may share a key with different
        # effects (legal in k8s); a dict comprehension would drop all but one
        node_taints: Dict[str, List[str]] = {}
        for t in taints:
            node_taints.setdefault(t.key, []).append(f"{t.value}:{t.effect}")
        kube["node-taints"] = node_taints
    generated = {"settings": {"kubernetes": kube}}
    return _toml_dump(_deep_merge(user_tree, generated))


def render_powershell(
    cluster_name: str,
    endpoint: str,
    ca_bundle: str,
    nodeclass: TPUNodeClass,
    labels: Dict[str, str],
    taints: List,
    max_pods: Optional[int],
) -> str:
    """Windows powershell bootstrap analogue: custom userdata runs first
    inside the same <powershell> block (the reference appends its bootstrap
    call after user content)."""
    label_str = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    taint_str = ",".join(f"{t.key}={t.value}:{t.effect}" for t in taints)
    kubelet_args = " ".join(_kubelet_args(nodeclass.kubelet, max_pods))
    body = []
    if nodeclass.user_data:
        body.append(nodeclass.user_data.rstrip())
    body.append(
        f"& Bootstrap-Node -Cluster '{cluster_name}' -Endpoint '{endpoint}' "
        f"-CaBundle '{ca_bundle}' -NodeLabels '{label_str}' -Taints '{taint_str}' "
        f"-KubeletExtraArgs '{kubelet_args}'"
    )
    return "<powershell>\n" + "\n".join(body) + "\n</powershell>"


RENDERERS = {
    "Standard": render_standard,
    "Minimal": render_standard,
    "Declarative": render_declarative,
    "Immutable": render_toml,
    "Windows": render_powershell,
    "Custom": lambda cluster_name, endpoint, ca_bundle, nodeclass, labels, taints, max_pods: nodeclass.user_data,
}


def render(image_family: str, **kw) -> str:
    renderer = RENDERERS.get(image_family, render_standard)
    return renderer(**kw)
