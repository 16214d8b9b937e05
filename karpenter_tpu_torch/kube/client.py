"""A dependency-free Kubernetes API client (stdlib HTTP + JSON).

The reference's coordination bus IS the kube apiserver
(`pkg/operator/operator.go:284-305`,
`cmd/controller/main.go:30-84` build everything on controller-runtime's
client); this module is the port's equivalent seam, written against
the apiserver's REST surface directly because the image ships no
`kubernetes` package. Scope: exactly what the controllers need -- CRUD +
list with selectors + watch streams + subresource status updates, with
bearer-token / client-cert auth and CA verification.

Auth resolution:
- `KubeConfig.in_cluster()`: the pod serviceaccount mount
  (/var/run/secrets/kubernetes.io/serviceaccount).
- `KubeConfig.from_kubeconfig(path)`: standard kubeconfig (current-context;
  token, client cert/key, or insecure-skip-tls-verify).
- explicit `KubeConfig(server=..., token=...)`.

Copy of karpenter_tpu/kube/client.py, imports rewritten to the port's; it
cuts nothing. `from_kubeconfig` reads YAML with PyYAML, as the JAX
package does.
"""
from __future__ import annotations

import base64
import http.client
import json
import os
import ssl
import tempfile
import urllib.parse
from typing import Dict, Iterator, Optional, Tuple

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"apiserver {status}: {message}")
        self.status = status
        self.message = message


class NotFound(ApiError):
    pass


class Conflict(ApiError):
    """409: resourceVersion conflict (the optimistic-concurrency signal the
    in-memory store raises as its own Conflict)."""


class KubeConfig:
    def __init__(
        self,
        server: str,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        client_cert_file: Optional[str] = None,
        client_key_file: Optional[str] = None,
        verify: bool = True,
    ):
        self.server = server.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.client_cert_file = client_cert_file
        self.client_key_file = client_key_file
        self.verify = verify

    @staticmethod
    def in_cluster() -> "KubeConfig":
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError("not running in a cluster (no KUBERNETES_SERVICE_HOST)")
        with open(os.path.join(SA_DIR, "token")) as f:
            token = f.read().strip()
        return KubeConfig(
            server=f"https://{host}:{port}",
            token=token,
            ca_file=os.path.join(SA_DIR, "ca.crt"),
        )

    @staticmethod
    def from_kubeconfig(path: Optional[str] = None, context: Optional[str] = None) -> "KubeConfig":
        import yaml

        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser("~/.kube/config")
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context")
        ctx = next(c["context"] for c in cfg["contexts"] if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg["clusters"] if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in cfg["users"] if u["name"] == ctx["user"])

        def materialize(data_key: str, file_key: str) -> Optional[str]:
            """Inline base64 data -> temp file; else the referenced path."""
            source = user if data_key.startswith("client") else cluster
            data = source.get(f"{data_key}-data")
            if data:
                fd, p = tempfile.mkstemp(prefix="kubeconfig-", suffix=".pem")
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(data))
                return p
            return source.get(file_key)

        return KubeConfig(
            server=cluster["server"],
            token=user.get("token"),
            ca_file=materialize("certificate-authority", "certificate-authority"),
            client_cert_file=materialize("client-certificate", "client-certificate"),
            client_key_file=materialize("client-key", "client-key"),
            verify=not cluster.get("insecure-skip-tls-verify", False),
        )


class KubeClient:
    """Thin REST client. One connection per call path (watch holds its own
    connection open); no retries here -- controllers are level-triggered
    and re-reconcile, the reference's posture."""

    def __init__(self, config: KubeConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        u = urllib.parse.urlparse(config.server)
        self._https = u.scheme == "https"
        self._host = u.hostname
        self._port = u.port or (443 if self._https else 80)
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self._https:
            ctx = ssl.create_default_context(cafile=config.ca_file)
            if not config.verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if config.client_cert_file:
                ctx.load_cert_chain(config.client_cert_file, config.client_key_file)
            self._ssl_ctx = ctx

    # -- plumbing -----------------------------------------------------------
    def _connect(self, timeout: Optional[float] = None) -> http.client.HTTPConnection:
        t = self.timeout if timeout is None else timeout
        if self._https:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=t, context=self._ssl_ctx
            )
        return http.client.HTTPConnection(self._host, self._port, timeout=t)

    def _headers(self) -> Dict[str, str]:
        h = {"Accept": "application/json", "Content-Type": "application/json"}
        if self.config.token:
            h["Authorization"] = f"Bearer {self.config.token}"
        return h

    def request(
        self, method: str, path: str, body: Optional[dict] = None,
        params: Optional[Dict[str, str]] = None,
        content_type: Optional[str] = None,
    ) -> dict:
        if params:
            path = f"{path}?{urllib.parse.urlencode(params)}"
        conn = self._connect()
        try:
            headers = self._headers()
            if content_type:
                headers["Content-Type"] = content_type
            conn.request(
                method, path,
                body=json.dumps(body) if body is not None else None,
                headers=headers,
            )
            resp = conn.getresponse()
            raw = resp.read()
            if resp.status == 404:
                raise NotFound(404, raw.decode(errors="replace")[:500])
            if resp.status == 409:
                raise Conflict(409, raw.decode(errors="replace")[:500])
            if resp.status >= 400:
                raise ApiError(resp.status, raw.decode(errors="replace")[:500])
            return json.loads(raw) if raw else {}
        finally:
            conn.close()

    # -- verbs --------------------------------------------------------------
    def get(self, path: str) -> dict:
        return self.request("GET", path)

    def list(self, path: str, params: Optional[Dict[str, str]] = None) -> dict:
        return self.request("GET", path, params=params)

    def create(self, path: str, manifest: dict) -> dict:
        return self.request("POST", path, body=manifest)

    def update(self, path: str, manifest: dict) -> dict:
        return self.request("PUT", path, body=manifest)

    def patch(self, path: str, patch: dict) -> dict:
        """application/merge-patch+json: update only the named fields --
        the write verb for kinds whose objects carry server/kubelet-owned
        fields a whole-object PUT would clobber (pods, nodes)."""
        return self.request(
            "PATCH", path, body=patch, content_type="application/merge-patch+json"
        )

    def patch_status(self, path: str, manifest: dict) -> dict:
        return self.request("PUT", f"{path}/status", body=manifest)

    def delete(self, path: str) -> dict:
        return self.request("DELETE", path)

    def server_version(self) -> dict:
        return self.request("GET", "/version")

    def watch(
        self, path: str, resource_version: Optional[str] = None,
        timeout_seconds: int = 300,
    ) -> Iterator[Tuple[str, dict]]:
        """Stream (event_type, object) from a watch. The connection is held
        open; the apiserver chunk-streams one JSON object per line. Ends
        when the server closes (timeoutSeconds) -- callers loop, resuming
        from the last seen resourceVersion (bookmarks requested)."""
        params = {
            "watch": "true",
            "timeoutSeconds": str(timeout_seconds),
            "allowWatchBookmarks": "true",
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        qpath = f"{path}?{urllib.parse.urlencode(params)}"
        conn = self._connect(timeout=timeout_seconds + 15)
        try:
            conn.request("GET", qpath, headers=self._headers())
            resp = conn.getresponse()
            if resp.status >= 400:
                raw = resp.read()
                raise ApiError(resp.status, raw.decode(errors="replace")[:500])
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    return
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    ev = json.loads(line)
                    yield ev.get("type", ""), ev.get("object", {})
        finally:
            conn.close()
