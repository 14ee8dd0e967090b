"""A real HTTP API server fronting a FakeKube store.

Speaks enough of the Kubernetes REST wire protocol for every client in
this repo — the Python HttpKubeClient, the C++ native agent, the bash
engine (via curl) — to run end-to-end without a cluster. This is the
kind-cluster stand-in for BASELINE config 1 and the integration-test /
bench substrate (SURVEY.md §4's "fake k8s API" requirement).

Endpoints:

- ``GET    /api/v1/nodes``               (list; labelSelector; watch=true)
- ``GET    /api/v1/nodes/{name}``
- ``PATCH  /api/v1/nodes/{name}``        (application/merge-patch+json)
- ``PUT    /api/v1/nodes/{name}``        (optimistic replace -> 409)
- ``GET    /api/v1/namespaces/{ns}/pods``
- ``DELETE /api/v1/namespaces/{ns}/pods/{name}``
- ``POST   /api/v1/namespaces/{ns}/pods/{name}/eviction``
- ``POST   /api/v1/namespaces/{ns}/events``
- ``GET    /api/v1/namespaces/{ns}/events``
- ``GET    /apis/{group}/{ver}/{plural}``          (cluster-scoped CRs; watch=true)
- ``GET    /apis/{group}/{ver}/{plural}/{name}``
- ``PATCH  /apis/{group}/{ver}/{plural}/{name}[/status]``
- ``GET    /apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}``
- ``POST   /apis/coordination.k8s.io/v1/namespaces/{ns}/leases``
- ``PUT    /apis/coordination.k8s.io/v1/namespaces/{ns}/leases/{name}``  (CAS -> 409)

Watch responses are newline-delimited JSON event streams, ending when the
``timeoutSeconds`` window elapses (clean EOF), or a single ERROR event for
410, exactly as a real API server behaves.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpu_cc_manager_torch.k8s.client import ApiException
from tpu_cc_manager_torch.k8s.fake import FakeKube

log = logging.getLogger("tpu-cc-manager.fake-apiserver")


def _list_obj(kind: str, items: list, cont: Optional[str]) -> dict:
    # A real apiserver omits TypeMeta (kind/apiVersion) from list items —
    # only the List object itself carries it. Serve the same shape so
    # clients that grep or parse items are tested against real wire
    # format (a grep for '"kind":"Pod"' must count 0 here, as it would
    # in production).
    items = [{k: v for k, v in it.items() if k not in ("kind", "apiVersion")}
             for it in items]
    out = {"kind": kind, "apiVersion": "v1", "items": items, "metadata": {}}
    if cont:
        out["metadata"]["continue"] = cont
    return out


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    store: FakeKube  # set by server factory
    required_token: Optional[str] = None  # when set, reject non-bearers 401

    # silence default stderr access logging
    def log_message(self, fmt, *args):  # pragma: no cover
        pass

    def _authorized(self) -> bool:
        """Bearer-token gate, enabled by FakeApiServer(required_token=...).
        Lets tests prove the exec-credential/kubeconfig auth path
        end-to-end over the wire."""
        if self.required_token is None:
            return True
        if self.headers.get("Authorization") == f"Bearer {self.required_token}":
            return True
        self._send_error_status(ApiException(401, "Unauthorized"))
        return False

    # ---------------------------------------------------------- plumbing
    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_status(self, e: ApiException) -> None:
        self._send_json(
            e.status,
            {
                "kind": "Status",
                "apiVersion": "v1",
                "status": "Failure",
                "message": e.reason,
                "code": e.status,
            },
        )

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if not length:
            return {}
        return json.loads(self.rfile.read(length))

    def _parts(self):
        parsed = urllib.parse.urlparse(self.path)
        return parsed.path.strip("/").split("/"), dict(
            urllib.parse.parse_qsl(parsed.query)
        )

    # ------------------------------------------------------------- verbs
    def do_GET(self):
        if not self._authorized():
            return
        parts, q = self._parts()
        try:
            if parts[:3] == ["api", "v1", "nodes"]:
                if len(parts) == 4:
                    return self._send_json(200, self.store.get_node(parts[3]))
                if q.get("watch") == "true":
                    return self._stream_watch(q)
                items, cont = self.store.list_nodes_page(
                    q.get("labelSelector"),
                    limit=int(q["limit"]) if q.get("limit") else None,
                    cont=q.get("continue"),
                )
                return self._send_json(200, _list_obj("NodeList", items, cont))
            if (
                len(parts) >= 5
                and parts[:3] == ["api", "v1", "namespaces"]
                and parts[4] == "pods"
            ):
                ns = parts[3]
                if len(parts) == 5:
                    items, cont = self.store.list_pods_page(
                        ns,
                        q.get("labelSelector"),
                        q.get("fieldSelector"),
                        limit=int(q["limit"]) if q.get("limit") else None,
                        cont=q.get("continue"),
                    )
                    return self._send_json(200, _list_obj("PodList", items, cont))
            if (
                len(parts) == 5
                and parts[:3] == ["api", "v1", "namespaces"]
                and parts[4] == "events"
            ):
                return self._send_json(
                    200,
                    _list_obj("EventList",
                              self.store.list_events(parts[3]), None),
                )
            if (
                len(parts) == 7
                and parts[1] == "coordination.k8s.io"
                and parts[3] == "namespaces"
                and parts[5] == "leases"
            ):
                return self._send_json(
                    200, self.store.get_lease(parts[4], parts[6])
                )
            if parts[0] == "apis" and len(parts) == 4:
                group, ver, plural = parts[1], parts[2], parts[3]
                if q.get("watch") == "true":
                    return self._stream_custom_watch(group, ver, plural, q)
                items = self.store.list_cluster_custom(group, ver, plural)
                return self._send_json(200, _list_obj("List", items, None))
            if parts[0] == "apis" and len(parts) == 5:
                return self._send_json(
                    200,
                    self.store.get_cluster_custom(
                        parts[1], parts[2], parts[3], parts[4]
                    ),
                )
            return self._send_error_status(ApiException(404, f"no route {self.path}"))
        except ApiException as e:
            return self._send_error_status(e)

    def do_PATCH(self):
        if not self._authorized():
            return
        parts, _ = self._parts()
        try:
            if len(parts) == 4 and parts[:3] == ["api", "v1", "nodes"]:
                return self._send_json(
                    200, self.store.patch_node(parts[3], self._read_body())
                )
            if parts[0] == "apis" and len(parts) in (5, 6):
                sub = parts[5] if len(parts) == 6 else None
                return self._send_json(
                    200,
                    self.store.patch_cluster_custom(
                        parts[1], parts[2], parts[3], parts[4],
                        self._read_body(), subresource=sub,
                    ),
                )
            return self._send_error_status(ApiException(404, f"no route {self.path}"))
        except ApiException as e:
            return self._send_error_status(e)

    def do_PUT(self):
        if not self._authorized():
            return
        parts, _ = self._parts()
        try:
            if len(parts) == 4 and parts[:3] == ["api", "v1", "nodes"]:
                return self._send_json(
                    200, self.store.replace_node(parts[3], self._read_body())
                )
            if (
                len(parts) == 7
                and parts[1] == "coordination.k8s.io"
                and parts[3] == "namespaces"
                and parts[5] == "leases"
            ):
                return self._send_json(
                    200,
                    self.store.replace_lease(
                        parts[4], parts[6], self._read_body()
                    ),
                )
            return self._send_error_status(ApiException(404, f"no route {self.path}"))
        except ApiException as e:
            return self._send_error_status(e)

    def do_DELETE(self):
        if not self._authorized():
            return
        parts, _ = self._parts()
        try:
            if (
                len(parts) == 6
                and parts[:3] == ["api", "v1", "namespaces"]
                and parts[4] == "pods"
            ):
                self.store.delete_pod(parts[3], parts[5])
                return self._send_json(200, {"kind": "Status", "status": "Success"})
            return self._send_error_status(ApiException(404, f"no route {self.path}"))
        except ApiException as e:
            return self._send_error_status(e)

    def do_POST(self):
        if not self._authorized():
            return
        parts, _ = self._parts()
        try:
            if (
                len(parts) == 7
                and parts[:3] == ["api", "v1", "namespaces"]
                and parts[4] == "pods"
                and parts[6] == "eviction"
            ):
                self._read_body()
                self.store.evict_pod(parts[3], parts[5])
                return self._send_json(201, {"kind": "Status", "status": "Success"})
            if (
                len(parts) == 5
                and parts[:3] == ["api", "v1", "namespaces"]
                and parts[4] == "events"
            ):
                return self._send_json(
                    201, self.store.create_event(parts[3], self._read_body())
                )
            if (
                len(parts) == 6
                and parts[1] == "coordination.k8s.io"
                and parts[3] == "namespaces"
                and parts[5] == "leases"
            ):
                return self._send_json(
                    201,
                    self.store.create_lease(parts[4], self._read_body()),
                )
            return self._send_error_status(ApiException(404, f"no route {self.path}"))
        except ApiException as e:
            return self._send_error_status(e)

    # ------------------------------------------------------------- watch
    def _stream_custom_watch(self, group: str, ver: str, plural: str,
                             q: dict) -> None:
        self._stream_events(
            lambda: self.store.watch_cluster_custom(
                group, ver, plural,
                resource_version=q.get("resourceVersion"),
                timeout_s=float(q.get("timeoutSeconds", "300")),
            )
        )

    def _stream_watch(self, q: dict) -> None:
        name: Optional[str] = None
        fs = q.get("fieldSelector", "")
        if fs.startswith("metadata.name="):
            name = fs.split("=", 1)[1]
        # node watches ride the store's pre-encoded fan-out path: each
        # event is serialized once fleet-wide (_WatchEvent.wire), not
        # once per watcher — the O(history x watchers) encode cost was
        # the fake apiserver's wall at four-digit replica counts
        self._stream_events(
            lambda: self.store.watch_nodes_wire(
                name=name,
                resource_version=q.get("resourceVersion"),
                timeout_s=float(q.get("timeoutSeconds", "300")),
                allow_bookmarks=q.get("allowWatchBookmarks") == "true",
            ),
            wire=True,
        )

    def _stream_events(self, iter_factory, wire: bool = False) -> None:
        """Serve one watch stream (chunked NDJSON, ERROR event on
        ApiException, clean EOF at timeout) from any event iterator.
        ``wire=True`` means the iterator already yields encoded NDJSON
        lines (the shared-encode fan-out path)."""
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def _chunk(data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        try:
            try:
                if wire:
                    for line in iter_factory():
                        _chunk(line)
                else:
                    for etype, obj in iter_factory():
                        _chunk(
                            json.dumps({"type": etype, "object": obj}).encode()
                            + b"\n"
                        )
            except ApiException as e:
                err = {
                    "type": "ERROR",
                    "object": {
                        "kind": "Status",
                        "code": e.status,
                        "reason": "Expired" if e.status == 410
                        else "InternalError",
                        "message": e.reason,
                    },
                }
                _chunk(json.dumps(err).encode() + b"\n")
            _chunk(b"")  # terminating chunk
        except (BrokenPipeError, ConnectionResetError):  # client went away
            return


class _ApiHTTPServer(ThreadingHTTPServer):
    # a 32-node pool opening watch streams at once overflows the
    # default listen(5) backlog -> connection resets
    request_queue_size = 256

    def handle_error(self, request, client_address):
        """Client-gone at the accept/readline layer (before or between
        requests) must not print socketserver's full traceback into a
        green smoke log — the in-handler suppression in _stream_events
        only covers disconnects DURING a response. Anything else still
        gets one loud line."""
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return  # benign: a client hung up mid-handshake/idle
        log.warning("request from %s failed: %s: %s", client_address,
                    type(exc).__name__, exc)


class FakeApiServer:
    """Owns a ThreadingHTTPServer bound to 127.0.0.1:<port> over a FakeKube."""

    def __init__(
        self,
        store: Optional[FakeKube] = None,
        port: int = 0,
        required_token: Optional[str] = None,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
    ):
        self.store = store or FakeKube()
        handler = type(
            "BoundHandler",
            (_Handler,),
            {"store": self.store, "required_token": required_token},
        )
        self.httpd = _ApiHTTPServer(("127.0.0.1", port), handler)
        self.tls = bool(tls_cert)
        if tls_cert:
            # serve real HTTPS (the native agent's direct-TLS path is
            # integration-tested against this)
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key or tls_cert)
            self.httpd.socket = ctx.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://127.0.0.1:{self.port}"

    def start(self) -> "FakeApiServer":
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="fake-apiserver", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "FakeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
