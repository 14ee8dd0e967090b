"""KubeClient interface + stdlib HTTP implementation.

Covers exactly the API surface the reference agents use (SURVEY.md §3.5):
node read/watch/patch, pod list/delete, eviction — nothing more. The HTTP
implementation speaks to a real API server (in-cluster service account or
kubeconfig) or to :mod:`tpu_cc_manager.k8s.apiserver` in tests.
"""

from __future__ import annotations

import abc
import base64
import datetime
import json
import logging
import os
import socket
import ssl
import subprocess
import tempfile
import threading
import time
import urllib.parse
from http.client import (
    BadStatusLine,
    HTTPConnection,
    HTTPException,
    HTTPSConnection,
)
from typing import Dict, Iterator, List, Optional, Tuple

log = logging.getLogger("tpu-cc-manager.k8s")


class ApiException(Exception):
    """HTTP-level API failure (status carries the k8s semantics: 404 absent,
    409 conflict, 410 watch-history expired, 429 PDB-blocked eviction)."""

    def __init__(self, status: int, reason: str = ""):
        super().__init__(f"k8s API error {status}: {reason}")
        self.status = status
        self.reason = reason


class ConflictError(ApiException):
    def __init__(self, reason: str = "resourceVersion conflict"):
        super().__init__(409, reason)


class KubeClient(abc.ABC):
    """The minimal clientset both agents are written against."""

    @abc.abstractmethod
    def get_node(self, name: str) -> dict: ...

    @abc.abstractmethod
    def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]: ...

    @abc.abstractmethod
    def patch_node(self, name: str, patch: dict) -> dict:
        """JSON merge patch (labels/annotations/spec)."""

    @abc.abstractmethod
    def replace_node(self, name: str, node: dict) -> dict:
        """Optimistic-concurrency replace: raises ConflictError when
        node['metadata']['resourceVersion'] is stale. Used for slice
        leader election CAS."""

    @abc.abstractmethod
    def list_pods(
        self,
        namespace: str,
        label_selector: Optional[str] = None,
        field_selector: Optional[str] = None,
    ) -> List[dict]: ...

    @abc.abstractmethod
    def delete_pod(self, namespace: str, name: str) -> None: ...

    @abc.abstractmethod
    def evict_pod(self, namespace: str, name: str) -> None:
        """Eviction API (respects PDBs -> ApiException(429) when blocked)."""

    @abc.abstractmethod
    def watch_nodes(
        self,
        name: Optional[str] = None,
        resource_version: Optional[str] = None,
        timeout_s: int = 300,
    ) -> Iterator[Tuple[str, dict]]:
        """Yield (event_type, node) until server-side timeout. Raises
        ApiException(410) when resource_version fell out of history —
        callers re-list and resume (reference main.py:675-687)."""

    def create_event(self, namespace: str, event: dict) -> dict:
        """Create a core/v1 Event (observability only — reconcile
        outcomes surface in ``kubectl describe node``). Non-abstract so
        minimal clientsets/test doubles keep working; callers treat
        emission as best-effort."""
        raise ApiException(501, "events not supported by this client")

    def list_events(self, namespace: str) -> List[dict]:
        """List the namespace's core/v1 Events (kubectl-describe analog
        for smokes/tests)."""
        raise ApiException(501, "events not supported by this client")

    # -- cluster-scoped custom resources (CRDs) -------------------------
    # Non-abstract with a 501 default, like the events surface: only the
    # policy controller needs CRs, and minimal clientsets/test doubles
    # must keep working unchanged.
    def list_cluster_custom(
        self, group: str, version: str, plural: str
    ) -> List[dict]:
        """List a cluster-scoped custom resource collection
        (``GET /apis/{group}/{version}/{plural}``)."""
        raise ApiException(501, "custom resources not supported by this client")

    def get_cluster_custom(
        self, group: str, version: str, plural: str, name: str
    ) -> dict:
        raise ApiException(501, "custom resources not supported by this client")

    def patch_cluster_custom(
        self,
        group: str,
        version: str,
        plural: str,
        name: str,
        patch: dict,
        subresource: Optional[str] = None,
    ) -> dict:
        """JSON merge patch on a cluster-scoped custom resource;
        ``subresource="status"`` patches the status subresource (which,
        like the real API server, never bumps ``metadata.generation``)."""
        raise ApiException(501, "custom resources not supported by this client")

    def watch_cluster_custom(
        self,
        group: str,
        version: str,
        plural: str,
        resource_version: Optional[str] = None,
        timeout_s: int = 300,
    ) -> Iterator[Tuple[str, dict]]:
        """Watch a cluster-scoped CR collection; yields (event_type,
        object) until the server-side timeout, like watch_nodes."""
        raise ApiException(501, "custom resources not supported by this client")

    # leases (coordination.k8s.io/v1) -----------------------------------
    # the leader-election primitive (tpu_cc_manager.leader): namespaced
    # Lease objects with optimistic-concurrency replace — exactly the
    # trio client-go's resourcelock.LeaseLock uses
    def get_lease(self, namespace: str, name: str) -> dict:
        raise ApiException(501, "leases not supported by this client")

    def create_lease(self, namespace: str, lease: dict) -> dict:
        """POST; raises ApiException(409) if it already exists."""
        raise ApiException(501, "leases not supported by this client")

    def replace_lease(self, namespace: str, name: str,
                      lease: dict) -> dict:
        """PUT with the object's metadata.resourceVersion; raises
        ConflictError when the server's moved on (someone else renewed
        or took the lease first — the CAS that makes election safe)."""
        raise ApiException(501, "leases not supported by this client")

    # convenience built on the primitives -------------------------------
    def set_node_labels(self, name: str, labels: Dict[str, Optional[str]]) -> dict:
        return self.patch_node(name, {"metadata": {"labels": labels}})

    def set_node_annotations(self, name: str, ann: Dict[str, Optional[str]]) -> dict:
        return self.patch_node(name, {"metadata": {"annotations": ann}})


# --------------------------------------------------------------------------
# configuration loading
# --------------------------------------------------------------------------

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ExecCredentialError(Exception):
    """A kubeconfig users[].exec credential plugin failed or returned an
    unusable ExecCredential."""


class ExecCredentialPlugin:
    """Runs a kubeconfig ``users[].exec`` credential plugin and caches the
    resulting bearer token until its ``expirationTimestamp``.

    This is GKE's actual auth path: real GKE kubeconfigs carry no static
    token — they name ``gke-gcloud-auth-plugin``, which prints an
    ExecCredential JSON on stdout. The reference gets this for free from
    client-go (reference cmd/main.go:120, clientcmd.BuildConfigFromFlags)
    and the kubernetes Python client (reference main.py:105-114); this is
    the stdlib equivalent for the operator-side tools (rollout,
    fleet-controller, plan) running from a workstation.

    Implements the client-go contract:
    - spawn ``command args...`` with ``env`` entries merged over os.environ;
    - when ``provideClusterInfo`` is set, pass the target cluster through
      the ``KUBERNETES_EXEC_INFO`` env var;
    - parse the ExecCredential status: ``token`` (primary; GKE) and the
      ``clientCertificateData``/``clientKeyData`` pair (some plugins);
    - cache until ``expirationTimestamp`` minus a refresh skew; a
      credential with no expiry is cached for the process lifetime.
    """

    REFRESH_SKEW_S = 60

    def __init__(self, spec: dict, cluster: Optional[dict] = None):
        self.command = spec["command"]
        self.args = list(spec.get("args") or [])
        self.env = list(spec.get("env") or [])  # [{"name":..., "value":...}]
        self.api_version = spec.get(
            "apiVersion", "client.authentication.k8s.io/v1beta1"
        )
        self.provide_cluster_info = bool(spec.get("provideClusterInfo"))
        self.cluster = cluster or {}
        self.timeout_s = 60.0
        self._lock = threading.Lock()
        self._token: Optional[str] = None
        self._cert_files: Optional[Tuple[str, str]] = None
        self._expiry: Optional[datetime.datetime] = None
        self._fetched = False

    # -- cache ----------------------------------------------------------
    def _fresh(self, now: datetime.datetime) -> bool:
        if not self._fetched:
            return False
        if self._expiry is None:
            return True  # no expiry: valid for process lifetime (client-go)
        return now < self._expiry - datetime.timedelta(seconds=self.REFRESH_SKEW_S)

    def token(self) -> Optional[str]:
        with self._lock:
            # ccaudit: allow-blocking-under-lock(single-flight credential fetch: the lock exists so N threads with an expired token exec the plugin once, not N times)
            self._ensure(datetime.datetime.now(datetime.timezone.utc))
            return self._token

    def client_cert_pair(self) -> Optional[Tuple[str, str]]:
        """(cert_file, key_file) when the plugin returned TLS credentials."""
        with self._lock:
            # ccaudit: allow-blocking-under-lock(single-flight credential fetch, same contract as token() above)
            self._ensure(datetime.datetime.now(datetime.timezone.utc))
            return self._cert_files

    def invalidate(self) -> None:
        """Drop the cached credential (e.g. after a 401) so the next
        request re-runs the plugin."""
        with self._lock:
            self._fetched = False

    # -- plugin invocation ----------------------------------------------
    def _ensure(self, now: datetime.datetime) -> None:
        if self._fresh(now):
            return
        status = self._invoke()
        self._token = status.get("token")
        self._expiry = _parse_rfc3339(status.get("expirationTimestamp"))
        cert, key = status.get("clientCertificateData"), status.get("clientKeyData")
        if cert and key:
            # reuse the same two paths across refreshes: a short-expiry
            # plugin in a long-running controller must not grow /tmp (and
            # must not leave a trail of stale private keys). Swap contents
            # atomically — another thread may be load_cert_chain()ing the
            # previous credential off these paths right now.
            if self._cert_files is None:
                self._cert_files = (_write_temp(b""), _write_temp(b""))
            for path, data in zip(self._cert_files, (cert, key)):
                os.replace(_write_temp(data.encode()), path)
        elif self._cert_files is not None:
            for path in self._cert_files:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            self._cert_files = None
        if not self._token and not self._cert_files:
            raise ExecCredentialError(
                f"{self.command}: ExecCredential carries neither token nor "
                "client certificate"
            )
        self._fetched = True

    def _invoke(self) -> dict:
        env = dict(os.environ)
        for e in self.env:
            env[e["name"]] = e["value"]
        if self.provide_cluster_info:
            # client-go ExecCredential input contract (KUBERNETES_EXEC_INFO)
            env["KUBERNETES_EXEC_INFO"] = json.dumps({
                "apiVersion": self.api_version,
                "kind": "ExecCredential",
                "spec": {
                    "interactive": False,
                    "cluster": {
                        "server": self.cluster.get("server", ""),
                        "certificate-authority-data":
                            self.cluster.get("certificate-authority-data", ""),
                    },
                },
            })
        try:
            proc = subprocess.run(
                [self.command, *self.args],
                env=env,
                capture_output=True,
                text=True,
                timeout=self.timeout_s,
            )
        except FileNotFoundError:
            raise ExecCredentialError(
                f"credential plugin not found: {self.command}"
            ) from None
        except subprocess.TimeoutExpired:
            raise ExecCredentialError(
                f"credential plugin timed out after {self.timeout_s}s: "
                f"{self.command}"
            ) from None
        if proc.returncode != 0:
            raise ExecCredentialError(
                f"credential plugin failed (rc={proc.returncode}): "
                f"{self.command}: {proc.stderr.strip()[:200]}"
            )
        try:
            cred = json.loads(proc.stdout)
        except json.JSONDecodeError as e:
            raise ExecCredentialError(
                f"credential plugin printed invalid JSON: {self.command}: {e}"
            ) from None
        if cred.get("kind") not in (None, "ExecCredential"):
            raise ExecCredentialError(
                f"credential plugin returned kind={cred.get('kind')!r}, "
                "expected ExecCredential"
            )
        return cred.get("status") or {}


def _parse_rfc3339(ts: Optional[str]) -> Optional[datetime.datetime]:
    if not ts:
        return None
    try:
        dt = datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))
    except ValueError:
        return None  # unparseable expiry: treat as non-expiring
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt


def _write_temp(data: bytes, prefix: str = "kubecfg-") -> str:
    fd, p = tempfile.mkstemp(prefix=prefix)
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return p


class KubeConfig:
    def __init__(
        self,
        host: str,
        port: int,
        *,
        use_tls: bool = True,
        token: Optional[str] = None,
        ca_file: Optional[str] = None,
        client_cert: Optional[str] = None,
        client_key: Optional[str] = None,
        insecure_skip_verify: bool = False,
        exec_plugin: Optional[ExecCredentialPlugin] = None,
    ):
        self.host = host
        self.port = port
        self.use_tls = use_tls
        self.token = token
        self.ca_file = ca_file
        self.client_cert = client_cert
        self.client_key = client_key
        self.insecure_skip_verify = insecure_skip_verify
        self.exec_plugin = exec_plugin

    def bearer_token(self) -> Optional[str]:
        """The token for the next request: static when the kubeconfig
        carries one, otherwise freshly resolved (and cached) through the
        exec credential plugin."""
        if self.token:
            return self.token
        if self.exec_plugin:
            return self.exec_plugin.token()
        return None

    def client_cert_pair(self) -> Optional[Tuple[str, str]]:
        if self.client_cert:
            return (self.client_cert, self.client_key)
        if self.exec_plugin:
            return self.exec_plugin.client_cert_pair()
        return None

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        """Service-account config, the DaemonSet path (reference
        main.py:105-110 uses load_incluster_config)."""
        host = os.environ["KUBERNETES_SERVICE_HOST"]
        port = int(os.environ.get("KUBERNETES_SERVICE_PORT", "443"))
        token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
        ca_path = os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
        with open(token_path) as f:
            token = f.read().strip()
        return cls(host, port, token=token,
                   ca_file=ca_path if os.path.exists(ca_path) else None)

    @classmethod
    def from_kubeconfig(cls, path: str, context: Optional[str] = None) -> "KubeConfig":
        """Parse a kubeconfig file (reference main.py:111-114 falls back to
        load_kube_config when not in-cluster). Supports static tokens,
        inline/file client certificates, and ``users[].exec`` credential
        plugins — the gke-gcloud-auth-plugin path every real GKE
        kubeconfig uses."""
        import yaml

        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = context or cfg.get("current-context")
        try:
            ctx = next(c for c in cfg["contexts"] if c["name"] == ctx_name)["context"]
        except StopIteration:
            raise ValueError(f"kubeconfig {path}: context {ctx_name!r} not found") from None
        try:
            cluster = next(
                c for c in cfg["clusters"] if c["name"] == ctx["cluster"]
            )["cluster"]
        except StopIteration:
            raise ValueError(f"kubeconfig {path}: cluster {ctx['cluster']!r} not found") from None
        try:
            user = next(u for u in cfg["users"] if u["name"] == ctx["user"])["user"]
        except StopIteration:
            raise ValueError(f"kubeconfig {path}: user {ctx['user']!r} not found") from None

        url = urllib.parse.urlparse(cluster["server"])
        use_tls = url.scheme == "https"
        port = url.port or (443 if use_tls else 80)

        def _inline(data_key: str, file_key: str, blob: dict) -> Optional[str]:
            if blob.get(file_key):
                return blob[file_key]
            if blob.get(data_key):
                return _write_temp(base64.b64decode(blob[data_key]))
            return None

        exec_plugin = None
        if user.get("exec"):
            exec_plugin = ExecCredentialPlugin(user["exec"], cluster=cluster)

        return cls(
            url.hostname or "localhost",
            port,
            use_tls=use_tls,
            token=user.get("token"),
            ca_file=_inline("certificate-authority-data", "certificate-authority", cluster),
            client_cert=_inline("client-certificate-data", "client-certificate", user),
            client_key=_inline("client-key-data", "client-key", user),
            insecure_skip_verify=bool(cluster.get("insecure-skip-tls-verify")),
            exec_plugin=exec_plugin,
        )

    @classmethod
    def load(cls, kubeconfig: Optional[str] = None) -> "KubeConfig":
        """In-cluster first, kubeconfig fallback — the same resolution
        order as the reference (main.py:105-114)."""
        if kubeconfig:
            return cls.from_kubeconfig(kubeconfig)
        if "KUBERNETES_SERVICE_HOST" in os.environ:
            return cls.in_cluster()
        default = os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config")
        )
        return cls.from_kubeconfig(default)


# --------------------------------------------------------------------------
# HTTP implementation
# --------------------------------------------------------------------------


class _TokenBucket:
    """client-go-style client-side flow control (QPS + burst,
    vendor/k8s.io/client-go rest.Config's QPS/Burst): a shared bucket
    refilled at ``qps`` tokens/second, holding at most ``burst``.
    ``acquire`` blocks until a token is available — requests are
    delayed, never dropped, so a controller storm degrades to a steady
    trickle instead of hammering a contended API server. Thread-safe;
    one bucket serves every thread of a client instance."""

    def __init__(self, qps: float, burst: int):
        self.qps = float(qps)
        self.burst = max(1, int(burst))
        self._tokens = float(self.burst)
        self._updated = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> float:
        """Take one token, blocking as needed; returns the seconds this
        caller spent waiting — the number that turns "is the limiter
        actually throttling us?" from a guess into a metric."""
        waited = 0.0
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    float(self.burst),
                    self._tokens + (now - self._updated) * self.qps,
                )
                self._updated = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return waited
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)
            waited += wait


class HttpKubeClient(KubeClient):
    #: items per page for list requests; the server may return fewer and a
    #: ``metadata.continue`` token, which list_nodes/list_pods follow —
    #: required at fleet scale (client-go informers paginate the same way)
    LIST_PAGE_LIMIT = 500

    #: default ceiling on pooled idle keep-alive connections
    #: (``TPU_CC_KUBE_CONNS`` overrides): enough to overlap the flip
    #: executor's default worker count plus the agent's recorder/watch
    #: side traffic without hoarding sockets per client instance
    POOL_MAXSIZE = 8

    def __init__(self, config: KubeConfig,
                 list_page_limit: Optional[int] = None,
                 qps: Optional[float] = None,
                 burst: Optional[int] = None,
                 pool_maxsize: Optional[int] = None):
        self.config = config
        self.list_page_limit = list_page_limit or self.LIST_PAGE_LIMIT
        # a small SHARED pool of persistent keep-alive connections: the
        # historical one-connection-per-thread (threading.local) model
        # meant every short-lived thread — the flip executor's workers,
        # per-reconcile helpers — dialed TCP(+TLS) fresh and leaked the
        # socket when the thread died. The shared pool survives thread
        # churn: any thread checks a connection out for one request and
        # returns it, so TPU_CC_FLIP_CONCURRENCY workers reuse the same
        # few warm sockets instead of serializing on connection setup
        # (r1 VERDICT weak #3; ISSUE 6 flip-path I/O)
        if pool_maxsize is None:
            try:
                pool_maxsize = int(
                    os.environ.get("TPU_CC_KUBE_CONNS", "") or 0
                ) or None
            except ValueError:
                pool_maxsize = None
        self.pool_maxsize = pool_maxsize or self.POOL_MAXSIZE
        self._conns: List[HTTPConnection] = []  # idle, LIFO (warmest last)
        self._conn_lock = threading.Lock()
        self._pool_closed = False  # close() stops re-pooling at release
        # client-side flow control (TPU_CC_KUBE_QPS / TPU_CC_KUBE_BURST,
        # ctor args win): OFF by default — a per-node agent makes a
        # handful of writes per reconcile and must not trade flip
        # latency for politeness. The shipped controller manifests set
        # a QPS: one fleet/policy controller scanning thousands of
        # nodes is where client-go reaches for rest.Config.QPS/Burst,
        # and the reference's ecosystem gets that limiter for free
        # (vendor/k8s.io/client-go in the reference tree)
        if qps is None:
            try:
                qps = float(os.environ.get("TPU_CC_KUBE_QPS", "") or 0)
            except ValueError:
                qps = 0
        self._bucket: Optional[_TokenBucket] = None
        if qps and qps > 0:
            if burst is None:
                try:
                    burst = int(
                        os.environ.get("TPU_CC_KUBE_BURST", "") or 0
                    ) or None
                except ValueError:
                    burst = None
            # client-go's default Burst is 2x QPS-ish (5/10); same ratio
            self._bucket = _TokenBucket(qps, burst or int(2 * qps))
        # throttle visibility (client-go's
        # rest_client_rate_limiter_duration_seconds analog): plain
        # best-effort totals here (metrics, not bookkeeping — an
        # unsynchronized += across threads can at worst lose a sample),
        # plus an optional observer the owning controller wires to its
        # own Histogram so /metrics carries the distribution.
        self.throttle_waits = 0
        self.throttle_wait_s_total = 0.0
        self._throttle_observers: list = []

    def add_throttle_observer(self, fn) -> None:
        """Wire a callable(seconds) observed on EVERY flow-controlled
        request (zero when no wait): the controllers pass their
        ``tpu_cc_kube_throttle_wait_seconds`` histogram's observe. A
        LIST, not a slot — two controllers sharing one client must
        both see the waits, not whoever registered last."""
        self._throttle_observers.append(fn)

    def set_qps(self, qps: float, burst: Optional[int] = None) -> None:
        """Retune client-side flow control at runtime (simlab's
        throttle-squeeze fault; ops tooling reacting to API-server
        pressure). ``qps <= 0`` removes the limiter. In-flight waiters
        finish against the bucket they started on — only new requests
        see the new rate."""
        if qps and qps > 0:
            self._bucket = _TokenBucket(qps, burst or int(2 * qps))
        else:
            self._bucket = None

    def _acquire_token(self) -> None:
        bucket = self._bucket  # one read: set_qps may swap it mid-call
        if bucket is None:
            return
        waited = bucket.acquire()
        if waited > 0:
            self.throttle_waits += 1
            self.throttle_wait_s_total += waited
        for fn in self._throttle_observers:
            try:
                fn(waited)
            except Exception:
                # observability must never sink a request
                log.debug("throttle observer failed", exc_info=True)

    # -- plumbing -------------------------------------------------------
    def _acquire_conn(
        self, read_timeout: Optional[float]
    ) -> Tuple[HTTPConnection, bool]:
        """Check a connection out of the shared pool — (connection,
        is_fresh). A checked-out connection is owned by the calling
        thread until ``_release_conn``/``_discard_conn``; dead pooled
        sockets are dropped and replaced by a fresh dial."""
        while True:
            with self._conn_lock:
                conn = self._conns.pop() if self._conns else None
            if conn is None:
                return self._connect(read_timeout), True
            if conn.sock is None:
                # server sent Connection: close on its previous response
                conn.close()
                continue
            if read_timeout is not None:
                try:
                    conn.sock.settimeout(read_timeout)
                except OSError:
                    # socket died while idle: drop, try the next one
                    self._discard_conn(conn)
                    continue
            return conn, False

    def _release_conn(self, conn: HTTPConnection) -> None:
        """Return a healthy connection to the pool (or close it when the
        pool is full, the client was close()d, or the server asked to
        close)."""
        if conn.sock is None:
            conn.close()
            return
        with self._conn_lock:
            if not self._pool_closed and len(self._conns) < self.pool_maxsize:
                self._conns.append(conn)
                return
        conn.close()

    def _discard_conn(self, conn: Optional[HTTPConnection]) -> None:
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close every idle pooled connection and stop accepting
        returns: a connection in flight during close() is closed by its
        owning thread at release instead of being re-pooled. The client
        remains usable (new requests dial fresh) — close() reclaims
        sockets, it does not poison the instance."""
        with self._conn_lock:
            conns, self._conns = self._conns, []
            self._pool_closed = True
        for conn in conns:
            self._discard_conn(conn)

    def _connect(self, read_timeout: Optional[float]) -> HTTPConnection:
        c = self.config
        if c.use_tls:
            ctx = ssl.create_default_context(cafile=c.ca_file)
            if c.insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            pair = c.client_cert_pair()
            if pair:
                ctx.load_cert_chain(pair[0], pair[1])
            return HTTPSConnection(c.host, c.port, context=ctx, timeout=read_timeout)
        return HTTPConnection(c.host, c.port, timeout=read_timeout)

    def _headers(self, content_type: Optional[str] = None) -> dict:
        h = {"Accept": "application/json"}
        token = self.config.bearer_token()
        if token:
            h["Authorization"] = f"Bearer {token}"
        if content_type:
            h["Content-Type"] = content_type
        return h

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
        read_timeout: Optional[float] = 30.0,
        _auth_retry: bool = True,
    ) -> dict:
        self._acquire_token()
        resp = data = None
        conn: Optional[HTTPConnection] = None
        for attempt in (0, 1):
            try:
                if attempt == 0:
                    conn, fresh = self._acquire_conn(read_timeout)
                else:
                    # replay attempt: dial FRESH, bypassing the pool —
                    # after a server restart several idle pooled conns
                    # may all be stale, and popping another one here
                    # would turn a replayable race into a terminal
                    # error (the one-conn-per-thread model always
                    # replayed on a fresh dial; keep that guarantee)
                    conn, fresh = self._connect(read_timeout), True
            except ExecCredentialError as e:
                # surface credential-plugin failures through the module's
                # error contract so callers' except-ApiException
                # retry/rollback paths (rollout, agent watch loop) handle
                # them like any transport failure instead of crashing on a
                # foreign exception type
                raise ApiException(0, f"exec credential failure: {e}") from e
            try:
                conn.request(
                    method,
                    path,
                    body=json.dumps(body) if body is not None else None,
                    headers=self._headers(content_type if body is not None else None),
                )
                resp = conn.getresponse()
                data = resp.read()  # drain fully so the conn is reusable
                break
            except ExecCredentialError as e:
                self._discard_conn(conn)
                raise ApiException(0, f"exec credential failure: {e}") from e
            except (OSError, HTTPException) as e:
                # Replay ONLY the stale keep-alive race: a reused
                # connection the server closed before sending any response
                # bytes (RemoteDisconnected/BadStatusLine — Go's net/http
                # retries exactly this on reused connections). Anything
                # else — a timeout or reset mid-response, any failure on a
                # fresh connection — may have already executed server-side,
                # so replaying a non-idempotent PATCH/DELETE would double-
                # apply it; surface as an API error (status 0) and let the
                # caller's retry/backoff own the decision. EXACTLY-ONCE
                # under the shared pool: the replay dials fresh (never
                # another possibly-stale pooled conn), and a failure on
                # that fresh dial is terminal (not replayable).
                self._discard_conn(conn)
                replayable = isinstance(e, BadStatusLine) and not fresh
                if not replayable or attempt == 1:
                    raise ApiException(0, f"transport error: {e}") from e
        if resp.status == 401 and _auth_retry and self.config.exec_plugin:
            # cached exec credential revoked server-side: refresh once
            # (client-go invalidate-and-retry contract). Drop this
            # connection too — a refreshed exec client *certificate* only
            # takes effect on a new TLS handshake, so retrying over the
            # old session would 401 forever. The same goes for every
            # idle pooled connection (their sessions were handshaken
            # with the revoked cert): drain the pool so the retry —
            # and every later request — dials fresh instead of checking
            # out another stale session and failing terminally.
            self.config.exec_plugin.invalidate()
            self._discard_conn(conn)
            with self._conn_lock:
                stale, self._conns = self._conns, []
            for c in stale:
                self._discard_conn(c)
            return self._request(
                method, path, body=body, content_type=content_type,
                read_timeout=read_timeout, _auth_retry=False,
            )
        self._release_conn(conn)
        if resp.status >= 400:
            if resp.status == 409:
                raise ConflictError(data.decode("utf-8", "replace")[:200])
            raise ApiException(resp.status, data.decode("utf-8", "replace")[:200])
        return json.loads(data) if data else {}

    # -- nodes ----------------------------------------------------------
    def get_node(self, name: str) -> dict:
        return self._request("GET", f"/api/v1/nodes/{name}")

    def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]:
        params: Dict[str, str] = {}
        if label_selector:
            params["labelSelector"] = label_selector
        return self._paged_list("/api/v1/nodes", params)

    def patch_node(self, name: str, patch: dict) -> dict:
        return self._request(
            "PATCH",
            f"/api/v1/nodes/{name}",
            body=patch,
            content_type="application/merge-patch+json",
        )

    def replace_node(self, name: str, node: dict) -> dict:
        return self._request("PUT", f"/api/v1/nodes/{name}", body=node)

    # -- pods -----------------------------------------------------------
    def list_pods(
        self,
        namespace: str,
        label_selector: Optional[str] = None,
        field_selector: Optional[str] = None,
    ) -> List[dict]:
        params: Dict[str, str] = {}
        if label_selector:
            params["labelSelector"] = label_selector
        if field_selector:
            params["fieldSelector"] = field_selector
        return self._paged_list(f"/api/v1/namespaces/{namespace}/pods", params)

    def _paged_list(self, path: str, params: Dict[str, str]) -> List[dict]:
        """Chunked LIST following ``metadata.continue`` tokens, so a
        thousands-of-nodes fleet scan doesn't ask the API server for one
        giant response (client-go informer behavior; reference
        cmd/main.go:185-209 gets this from the ListWatch machinery)."""
        items: List[dict] = []
        cont: Optional[str] = None
        while True:
            page = dict(params, limit=str(self.list_page_limit))
            if cont:
                page["continue"] = cont
            resp = self._request("GET", path + "?" + urllib.parse.urlencode(page))
            items.extend(resp.get("items", []))
            cont = resp.get("metadata", {}).get("continue")
            if not cont:
                return items

    def delete_pod(self, namespace: str, name: str) -> None:
        self._request("DELETE", f"/api/v1/namespaces/{namespace}/pods/{name}")

    def evict_pod(self, namespace: str, name: str) -> None:
        self._request(
            "POST",
            f"/api/v1/namespaces/{namespace}/pods/{name}/eviction",
            body={
                "apiVersion": "policy/v1",
                "kind": "Eviction",
                "metadata": {"name": name, "namespace": namespace},
            },
        )

    def create_event(self, namespace: str, event: dict) -> dict:
        return self._request(
            "POST", f"/api/v1/namespaces/{namespace}/events", body=event
        )

    # -- custom resources ------------------------------------------------
    def list_cluster_custom(
        self, group: str, version: str, plural: str
    ) -> List[dict]:
        return self._paged_list(f"/apis/{group}/{version}/{plural}", {})

    def get_cluster_custom(
        self, group: str, version: str, plural: str, name: str
    ) -> dict:
        return self._request("GET", f"/apis/{group}/{version}/{plural}/{name}")

    def patch_cluster_custom(
        self,
        group: str,
        version: str,
        plural: str,
        name: str,
        patch: dict,
        subresource: Optional[str] = None,
    ) -> dict:
        path = f"/apis/{group}/{version}/{plural}/{name}"
        if subresource:
            path += f"/{subresource}"
        return self._request(
            "PATCH", path, body=patch,
            content_type="application/merge-patch+json",
        )

    def list_events(self, namespace: str) -> List[dict]:
        resp = self._request(
            "GET", f"/api/v1/namespaces/{namespace}/events"
        )
        return resp.get("items", [])

    # -- leases (coordination.k8s.io/v1) ---------------------------------
    _LEASE_BASE = "/apis/coordination.k8s.io/v1/namespaces"

    def get_lease(self, namespace: str, name: str) -> dict:
        return self._request(
            "GET", f"{self._LEASE_BASE}/{namespace}/leases/{name}"
        )

    def create_lease(self, namespace: str, lease: dict) -> dict:
        return self._request(
            "POST", f"{self._LEASE_BASE}/{namespace}/leases", body=lease
        )

    def replace_lease(self, namespace: str, name: str,
                      lease: dict) -> dict:
        # PUT carries metadata.resourceVersion; the server 409s when it
        # moved — surfaced as ConflictError by _request
        return self._request(
            "PUT", f"{self._LEASE_BASE}/{namespace}/leases/{name}",
            body=lease,
        )

    # -- watch ----------------------------------------------------------
    def watch_nodes(
        self,
        name: Optional[str] = None,
        resource_version: Optional[str] = None,
        timeout_s: int = 300,
        _auth_retry: bool = True,
    ) -> Iterator[Tuple[str, dict]]:
        # bookmarks keep our resourceVersion current through other-object
        # churn, avoiding needless 410 re-lists at cluster scale
        params = {
            "watch": "true",
            "timeoutSeconds": str(timeout_s),
            "allowWatchBookmarks": "true",
        }
        if name:
            # node-scoped watch, exactly like the Go informer's fieldSelector
            # metadata.name=<node> (reference cmd/main.go:185-190)
            params["fieldSelector"] = f"metadata.name={name}"
        if resource_version is not None:
            params["resourceVersion"] = str(resource_version)
        path = "/api/v1/nodes?" + urllib.parse.urlencode(params)

        yield from self._stream_watch(
            path, timeout_s,
            retry=(
                (lambda: self.watch_nodes(
                    name=name, resource_version=resource_version,
                    timeout_s=timeout_s, _auth_retry=False,
                )) if _auth_retry else None
            ),
        )

    def watch_cluster_custom(
        self,
        group: str,
        version: str,
        plural: str,
        resource_version: Optional[str] = None,
        timeout_s: int = 300,
        _auth_retry: bool = True,
    ) -> Iterator[Tuple[str, dict]]:
        params = {"watch": "true", "timeoutSeconds": str(timeout_s)}
        if resource_version is not None:
            params["resourceVersion"] = str(resource_version)
        path = (f"/apis/{group}/{version}/{plural}?"
                + urllib.parse.urlencode(params))
        yield from self._stream_watch(
            path, timeout_s,
            retry=(
                (lambda: self.watch_cluster_custom(
                    group, version, plural,
                    resource_version=resource_version,
                    timeout_s=timeout_s, _auth_retry=False,
                )) if _auth_retry else None
            ),
        )

    def _stream_watch(self, path: str, timeout_s: int,
                      retry=None) -> Iterator[Tuple[str, dict]]:
        """Shared NDJSON watch transport: dial, 401 invalidate-and-retry
        (via ``retry``, which re-invokes the caller once), stream until
        the server-side timeout closes the connection. Watch STARTS
        count against the flow-control bucket (client-go does the
        same) — a hot relist loop is exactly a request storm; the
        long-lived stream itself is free."""
        self._acquire_token()
        try:
            conn = self._connect(read_timeout=timeout_s + 30)
        except ExecCredentialError as e:
            raise ApiException(0, f"exec credential failure: {e}") from e
        try:
            try:
                conn.request("GET", path, headers=self._headers())
                resp = conn.getresponse()
            except ExecCredentialError as e:
                raise ApiException(0, f"exec credential failure: {e}") from e
            except OSError as e:
                raise ApiException(0, f"transport error: {e}") from e
            if (resp.status == 401 and retry is not None
                    and self.config.exec_plugin):
                # same invalidate-and-retry as _request: a revoked cached
                # exec credential must not burn the watcher's consecutive-
                # error budget when one plugin re-run fixes it
                self.config.exec_plugin.invalidate()
                resp.read()
                yield from retry()
                return
            if resp.status >= 400:
                raise ApiException(resp.status, resp.read().decode("utf-8", "replace")[:200])
            # newline-delimited JSON event stream
            buf = b""
            while True:
                try:
                    chunk = resp.read1(65536)
                except (socket.timeout, ssl.SSLError) as e:
                    raise ApiException(0, f"watch read timeout: {e}")
                if not chunk:
                    return  # server closed (watch timeout elapsed)
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    evt = json.loads(line)
                    if evt.get("type") == "ERROR":
                        status = evt.get("object", {})
                        raise ApiException(
                            int(status.get("code", 500)),
                            status.get("message", "watch error"),
                        )
                    yield evt["type"], evt["object"]
        finally:
            conn.close()
