"""Admission webhook — scheduler-level CC-mode enforcement.

The node-side enforcement chain (device-node gating, flip taint, pause
labels) keeps workloads off a node *while it flips*. This webhook closes
the remaining scheduling gap: nothing so far guarantees that a workload
which NEEDS confidential compute only lands on nodes whose mode is
verifiedly ``on``. A pod opts in with the
``tpu.google.com/requires-cc-mode`` label and the webhook enforces it at
admission time:

- **Mutating** (``POST /mutate``): inject
  ``spec.nodeSelector["tpu.google.com/cc.mode.state"] = <required mode>``
  — keyed on the OBSERVED state label the agents publish (and back with
  attestation evidence), not the desired label an operator may have just
  patched. The scheduler then simply cannot place the pod on an
  unconverged node.
- **Validating** (``POST /validate``): reject specs that contradict the
  requirement — an explicit nodeSelector pinning a DIFFERENT mode, a
  toleration of the flip taint (which would let the pod land mid-flip,
  exactly when the device gate is locked), a direct ``spec.nodeName``
  bind (which bypasses the scheduler and therefore the nodeSelector
  guarantee entirely), or a nonsense required mode.

Both endpoints speak the ``admission.k8s.io/v1`` AdmissionReview wire
protocol over HTTPS (the API server refuses plaintext webhooks);
``deployments/manifests/webhook.yaml`` scopes them with an
``objectSelector`` on the requires-cc label so the webhook can never
stall pods that don't opt in, and sets ``failurePolicy: Fail`` —
confidential placement fails closed.

The reference has no admission-time story at all: its CC mode only
matters to workloads via out-of-band convention (SURVEY.md §2.3 — the
pause-label choreography assumes a cooperating operator).
"""

from __future__ import annotations

import base64
import json
import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.modes import VALID_MODES

log = logging.getLogger("tpu-cc-manager.webhook")


def _escape(ptr: str) -> str:
    """RFC 6901 JSON-pointer token escaping (label keys contain '/')."""
    return ptr.replace("~", "~0").replace("/", "~1")


def required_mode(pod: dict) -> Optional[str]:
    """The mode the pod's requires-cc label asks for; None when the pod
    doesn't opt in. Raises ValueError on an invalid value — admission
    must reject it loudly, not guess."""
    value = (pod.get("metadata", {}).get("labels") or {}).get(
        L.REQUIRES_CC_LABEL
    )
    if value is None:
        return None
    if value not in VALID_MODES:
        raise ValueError(
            f"label {L.REQUIRES_CC_LABEL}={value!r}: must be one of "
            f"{', '.join(VALID_MODES)}"
        )
    return value


def _doctor_mode() -> str:
    """TPU_CC_WEBHOOK_REQUIRE_DOCTOR — ``off`` | ``warn`` |
    ``enforce``: also pin opted-in pods to nodes whose published
    doctor verdict is healthy (``cc.doctor.ok=true``).

    OFF by default: nodes that have never published a verdict (agents
    predating the doctor, doctor interval disabled) lack the label
    entirely, and a nodeSelector cannot express 'true-or-absent' — so
    requiring it on a mixed fleet would strand confidential pods.

    ``warn`` is the enablement rehearsal: admission is unchanged, but
    every response carries AdmissionReview ``warnings`` describing
    what enforce mode would have done (kubectl surfaces them to the
    submitter). Run warn until the warnings — and the fleet report's
    ``doctor.unreported`` list — are quiet, then set ``true``."""
    import os

    raw = os.environ.get("TPU_CC_WEBHOOK_REQUIRE_DOCTOR", "")
    value = raw.strip().lower()
    if value == "warn":
        return "warn"
    if value in ("1", "true", "yes", "on", "enforce"):
        return "enforce"
    if value not in ("", "0", "false", "no", "off"):
        # a typo ('warm', 'ture') must not silently disable a security
        # knob the operator believes is on — warn once per value. The
        # lock makes the check-then-add atomic: admission reviews run
        # on per-request threads (ccaudit race-lockset)
        with _warned_doctor_lock:
            first = value not in _warned_doctor_values
            _warned_doctor_values.add(value)
        if first:
            log.warning(
                "TPU_CC_WEBHOOK_REQUIRE_DOCTOR=%r not recognised "
                "(off|warn|true/enforce); treating as OFF", raw,
            )
    return "off"


#: unrecognised TPU_CC_WEBHOOK_REQUIRE_DOCTOR values already warned
#: about (once per process, not per admission review)
_warned_doctor_values: set = set()
_warned_doctor_lock = threading.Lock()


def _require_doctor() -> bool:
    return _doctor_mode() == "enforce"


def mutate_pod(pod: dict) -> List[dict]:
    """JSON-patch ops steering an opted-in pod onto nodes whose observed
    mode matches. Empty list = no change (not opted in, the selector is
    already right, or the selector CONTRADICTS the requirement — the
    mutating phase runs before validation, so rewriting a contradictory
    pin here would silently admit a spec the validating webhook is
    documented to reject; leave it for validate_pod to deny)."""
    mode = required_mode(pod)  # ValueError propagates; caller denies
    if mode is None:
        return []
    selector = (pod.get("spec") or {}).get("nodeSelector")
    ops: List[dict] = []
    need_mode_pin = selector is None or L.CC_MODE_STATE_LABEL not in selector
    # trust-surface steering: the mode label is a CLAIM; the doctor
    # verdict is the node's own cross-check of its gate perms,
    # statefiles, and evidence. With the knob on, confidential pods
    # only land where both agree — including pods that brought their
    # OWN matching mode pin (a self-pinned pod must not dodge the
    # doctor requirement).
    need_doctor_pin = _require_doctor() and (
        selector is None or L.DOCTOR_OK_LABEL not in selector
    )
    if not (need_mode_pin or need_doctor_pin):
        return []
    if selector is None:
        ops.append({
            "op": "add", "path": "/spec/nodeSelector", "value": {},
        })
    if need_mode_pin:
        ops.append({
            "op": "add",
            "path": f"/spec/nodeSelector/{_escape(L.CC_MODE_STATE_LABEL)}",
            "value": mode,
        })
    if need_doctor_pin:
        ops.append({
            "op": "add",
            "path": f"/spec/nodeSelector/{_escape(L.DOCTOR_OK_LABEL)}",
            "value": "true",
        })
    return ops


def doctor_warnings(pod: dict) -> List[str]:
    """Warn-mode preview (``TPU_CC_WEBHOOK_REQUIRE_DOCTOR=warn``):
    what WOULD enforce mode have done to this pod? Returned as
    AdmissionReview ``warnings`` — admission itself is unchanged, the
    submitter just sees the rehearsal output in kubectl. Empty unless
    warn mode is on and the pod opts in."""
    if _doctor_mode() != "warn":
        return []
    try:
        mode = required_mode(pod)
    except ValueError:
        return []  # invalid opt-in is denied regardless; no preview
    if mode is None:
        return []
    selector = (pod.get("spec") or {}).get("nodeSelector") or {}
    pin = selector.get(L.DOCTOR_OK_LABEL)
    if pin is None:
        # two short warnings, each under Kubernetes' 256-char
        # per-warning cap (the API server truncates longer ones —
        # which would cut exactly the actionable tail)
        return [
            f"TPU_CC_WEBHOOK_REQUIRE_DOCTOR=warn: enforce would pin "
            f"this pod to {L.DOCTOR_OK_LABEL}=true "
            "(doctor-healthy nodes only)",
            "preflight: enforce only when the fleet report's "
            "doctor.unreported list is empty — unverdicted nodes "
            "lack the label and would strand this pod",
        ]
    if pin != "true":
        return [
            f"TPU_CC_WEBHOOK_REQUIRE_DOCTOR=warn: this pod pins "
            f"{L.DOCTOR_OK_LABEL}={pin!r}; enforce mode would REJECT "
            "it (the pin contradicts the doctor-health requirement)"
        ]
    return []


def _tolerates_flip_taint(pod: dict) -> bool:
    """Does any toleration match the flip taint (key-wildcard Exists,
    key match with Exists, or key+value Equal)? Mirrors the scheduler's
    toleration-matching rules for the fields the flip taint uses."""
    for tol in (pod.get("spec") or {}).get("tolerations") or []:
        effect = tol.get("effect") or ""
        if effect and effect != L.FLIP_TAINT_EFFECT:
            continue
        key = tol.get("key") or ""
        op = tol.get("operator") or ("Exists" if not key else "Equal")
        if not key:
            # empty key with Exists tolerates everything
            if op == "Exists":
                return True
            continue
        if key != L.FLIP_TAINT_KEY:
            continue
        if op == "Exists":
            return True
        if tol.get("value") == L.FLIP_TAINT_VALUE:
            return True
    return False


def validate_pod(pod: dict) -> Tuple[bool, str]:
    """(allowed, reason). Only opted-in pods are ever denied."""
    try:
        mode = required_mode(pod)
    except ValueError as e:
        return False, str(e)
    if mode is None:
        return True, ""
    if (pod.get("spec") or {}).get("nodeName"):
        # spec.nodeName bypasses the scheduler entirely: the injected
        # nodeSelector is never evaluated and the pod lands on the named
        # node regardless of its mode — the one placement path the
        # nodeSelector guarantee cannot cover, so it is refused outright
        return False, (
            f"pod requires cc mode {mode!r} but sets spec.nodeName, "
            "which bypasses the scheduler (and therefore the "
            "requires-cc placement guarantee); remove nodeName and let "
            "the injected nodeSelector place it"
        )
    selector = (pod.get("spec") or {}).get("nodeSelector") or {}
    pinned = selector.get(L.CC_MODE_STATE_LABEL)
    if pinned is not None and pinned != mode:
        return False, (
            f"pod requires cc mode {mode!r} but its nodeSelector pins "
            f"{L.CC_MODE_STATE_LABEL}={pinned!r}"
        )
    if _require_doctor():
        doctor_pin = selector.get(L.DOCTOR_OK_LABEL)
        if doctor_pin is not None and doctor_pin != "true":
            # same reject-contradiction treatment the mode pin gets: a
            # pod explicitly pinning itself onto doctor-UNHEALTHY nodes
            # would defeat the knob's guarantee from inside the spec
            return False, (
                f"pod requires cc mode {mode!r} but its nodeSelector "
                f"pins {L.DOCTOR_OK_LABEL}={doctor_pin!r} while "
                "TPU_CC_WEBHOOK_REQUIRE_DOCTOR demands 'true'"
            )
    if _tolerates_flip_taint(pod):
        return False, (
            f"pod requires cc mode {mode!r} but tolerates the flip "
            f"taint {L.FLIP_TAINT_KEY}={L.FLIP_TAINT_VALUE}:"
            f"{L.FLIP_TAINT_EFFECT}; it could be scheduled onto a node "
            "mid-flip, when the device is gated"
        )
    return True, ""


def review_response(review: dict, kind: str) -> dict:
    """Process one AdmissionReview request dict; returns the response
    AdmissionReview. ``kind`` is 'mutate' or 'validate'. Malformed
    reviews raise ValueError (the server answers 400)."""
    req = review.get("request")
    if not isinstance(req, dict) or "uid" not in req:
        raise ValueError("not an AdmissionReview: request.uid missing")
    pod = req.get("object") or {}
    resp = {"uid": req["uid"], "allowed": True}
    try:
        required_mode(pod)
    except ValueError as e:
        # invalid requires-cc value: deny on BOTH endpoints with the
        # same 400 (a mutate that silently ignored it would admit a pod
        # whose confidential requirement is unenforceable)
        resp["allowed"] = False
        resp["status"] = {"message": str(e), "code": 400}
    else:
        if kind == "mutate":
            ops = mutate_pod(pod)
            if ops:
                resp["patchType"] = "JSONPatch"
                resp["patch"] = base64.b64encode(
                    json.dumps(ops).encode()
                ).decode()
        else:
            allowed, reason = validate_pod(pod)
            resp["allowed"] = allowed
            if not allowed:
                resp["status"] = {"message": reason, "code": 403}
        warns = doctor_warnings(pod)
        if warns:
            resp["warnings"] = warns
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": resp,
    }


class AdmissionServer:
    """HTTPS server for the two admission endpoints + /healthz.
    TLS is mandatory in production (the API server refuses plaintext
    webhooks); tests may pass ``tls=False`` to probe the handler."""

    def __init__(
        self,
        port: int = 8443,
        *,
        cert_file: Optional[str] = None,
        key_file: Optional[str] = None,
        tls: bool = True,
        reload_check_s: float = 60.0,
    ):
        if tls and not cert_file:
            raise ValueError(
                "TLS requires --cert/--key (the Kubernetes API server "
                "refuses plaintext webhooks)"
            )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # pragma: no cover
                pass

            def _send(self, code: int, body: bytes,
                      ctype: str = "application/json") -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    return self._send(200, b"ok", "text/plain")
                if self.path == "/metrics":
                    with outer._stats_lock:
                        reviews = outer.reviews
                        malformed = outer.rejected_malformed
                        warned = outer.warned
                    body = (
                        "# HELP tpu_cc_webhook_reviews_total Admission "
                        "reviews served\n"
                        "# TYPE tpu_cc_webhook_reviews_total counter\n"
                        f"tpu_cc_webhook_reviews_total {reviews}\n"
                        "# HELP tpu_cc_webhook_malformed_total Malformed "
                        "review bodies rejected with 400\n"
                        "# TYPE tpu_cc_webhook_malformed_total counter\n"
                        f"tpu_cc_webhook_malformed_total "
                        f"{malformed}\n"
                        "# HELP tpu_cc_webhook_warned_total Review "
                        "responses carrying warnings (REQUIRE_DOCTOR "
                        "warn-mode rehearsal activity; enforce when "
                        "this stays flat)\n"
                        "# TYPE tpu_cc_webhook_warned_total counter\n"
                        f"tpu_cc_webhook_warned_total {warned}\n"
                    ).encode()
                    return self._send(
                        200, body, "text/plain; version=0.0.4"
                    )
                return self._send(404, b"not found", "text/plain")

            def do_POST(self):
                kind = self.path.strip("/")
                if kind not in ("mutate", "validate"):
                    return self._send(404, b"not found", "text/plain")
                try:
                    length = int(self.headers.get("Content-Length", 0) or 0)
                    review = json.loads(self.rfile.read(length))
                    out = review_response(review, kind)
                except (ValueError, json.JSONDecodeError) as e:
                    # per-request threads: an unguarded += here loses
                    # counts under concurrent reviews (ccaudit
                    # race-lockset — the lost-update shape)
                    with outer._stats_lock:
                        outer.rejected_malformed += 1
                    return self._send(
                        400, json.dumps({"error": str(e)}).encode()
                    )
                with outer._stats_lock:
                    outer.reviews += 1
                    if out.get("response", {}).get("warnings"):
                        outer.warned += 1
                return self._send(200, json.dumps(out).encode())

        server_cls = type(
            "WebhookHTTPServer", (ThreadingHTTPServer,),
            {"request_queue_size": 64},
        )
        self.httpd = server_cls(("0.0.0.0", port), Handler)
        self._ctx: Optional[ssl.SSLContext] = None
        self._cert_file = cert_file
        self._key_file = key_file or cert_file
        self._cert_sig = None
        self.reload_check_s = reload_check_s
        if tls:
            self._ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ctx.load_cert_chain(self._cert_file, self._key_file)
            self._cert_sig = self._cert_signature()
            self.httpd.socket = self._ctx.wrap_socket(
                self.httpd.socket, server_side=True
            )
        self.httpd.daemon_threads = True
        self.reviews = 0
        self.rejected_malformed = 0
        #: responses that carried warnings — the warn-mode rehearsal's
        #: fleet-visible signal: enforce once this stops moving
        self.warned = 0
        #: guards the three review counters: ThreadingHTTPServer runs
        #: each review on its own thread, and `outer.reviews += 1` from
        #: two of them loses counts (found by ccaudit race-lockset)
        self._stats_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._reload_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -------------------------------------------------- cert hot-reload
    def _cert_signature(self):
        import os

        sig = []
        for path in (self._cert_file, self._key_file):
            try:
                st = os.stat(path)
                sig.append((st.st_mtime_ns, st.st_size, st.st_ino))
            except OSError:
                sig.append(None)
        return tuple(sig)

    def reload_certs_if_changed(self) -> bool:
        """Re-load the serving cert/key when the files changed on disk —
        cert-manager (and the gen-webhook-certs flow) rotate the Secret
        under a running pod, and kubelet updates the mounted files in
        place. New TLS handshakes pick up the reloaded chain; a torn
        mid-rotation read keeps serving the previous cert and retries
        next check. True when a reload happened."""
        if self._ctx is None:
            return False
        sig = self._cert_signature()
        if sig == self._cert_sig or None in sig:
            return False
        # load_cert_chain on the live context is not atomic: a
        # mid-rotation cert/key mismatch would leave it torn and break
        # ALL handshakes, old cert included. And the live context cannot
        # simply be replaced (the listening SSLSocket is bound to it).
        # So: snapshot the files to private temps, PROVE the snapshot
        # valid on a throwaway context, then load the same proven bytes
        # into the live context — which therefore cannot fail.
        import os
        import tempfile

        tmps = []
        try:
            try:
                for src in (self._cert_file, self._key_file):
                    with open(src, "rb") as f:
                        data = f.read()
                    fd, p = tempfile.mkstemp(prefix=".certreload-")
                    tmps.append(p)
                    with os.fdopen(fd, "wb") as f:
                        f.write(data)
                probe = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                probe.load_cert_chain(tmps[0], tmps[1])
            except (ssl.SSLError, OSError) as e:
                log.warning(
                    "serving-cert reload failed (keeping previous): %s", e
                )
                return False
            self._ctx.load_cert_chain(tmps[0], tmps[1])
        finally:
            for p in tmps:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        self._cert_sig = sig
        log.info("serving certificate reloaded")
        return True

    def _reload_loop(self) -> None:
        while not self._stop.wait(self.reload_check_s):
            self.reload_certs_if_changed()

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def _start_reloader(self) -> None:
        if self._ctx is None or self.reload_check_s <= 0:
            return
        self._reload_thread = threading.Thread(
            target=self._reload_loop, name="webhook-cert-reload",
            daemon=True,
        )
        self._reload_thread.start()

    def start(self) -> "AdmissionServer":
        self._start_reloader()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="webhook-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def serve_forever(self) -> int:
        log.info("admission webhook serving on :%d", self.port)
        self._start_reloader()
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:  # pragma: no cover - operator stop
            pass
        return 0

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
        if self._reload_thread:
            self._reload_thread.join(timeout=5)

    def __enter__(self) -> "AdmissionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
