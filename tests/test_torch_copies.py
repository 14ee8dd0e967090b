"""The port's copies of the JAX-free modules stay equal to the reference.

Each module below is the reference's source with only the package name
rewritten in its import statements (``tpu_cc_manager`` →
``tpu_cc_manager_torch``). Any other difference is a named exception:
a block of the reference's text and the block the port has in its place.
Each exception must occur exactly once; after the rewrite and the
exceptions the two sources must be equal, byte for byte.

The analyzer's modules (``analysis/``) take a second rewrite after the
first: every ``tpu_cc_manager`` followed by ``/`` or ``.`` names the port,
in string literals and docstrings too. That directory alone gets it
because the analyzer keys its rules on its own package's paths and dotted
names in string literals (the label-exempt directory, the labels module's
prefixes, the path-scoped rules' module sets, the simlab exemptions, the
hot-root scope, the baseline's path): with only the import rewrite the
port's analyzer would scan the port with the reference's keys. Every
other module's literals name the reference on purpose or not at all.
"""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"^(\s*)(from|import)\s+tpu_cc_manager\b")
_PATH = re.compile(r"\btpu_cc_manager(?=[./])")

#: the directory whose copies take the path rewrite too
PATH_REWRITTEN = "analysis/"

COPIES = (
    "device/base.py", "device/statefile.py", "device/native.py",
    "device/gate.py", "device/holders.py", "device/fake.py",
    "device/__init__.py", "trace.py", "flightrec.py", "k8s/client.py",
    "k8s/aio.py", "k8s/aio_bridge.py", "flipexec.py", "attest.py",
    "identity.py", "engine.py", "config.py", "modes.py",
    "k8s/objects.py", "k8s/fake.py", "k8s/apiserver.py", "k8s/__init__.py",
    "obs.py", "tsring.py", "watch.py", "watchdog.py", "profiler.py",
    "evidence.py", "leader.py", "fleet.py", "labels.py", "k8s/batch.py",
    "drain.py", "slice_coord.py", "doctor.py", "agent.py", "webhook.py",
    "rollout.py", "policy.py", "fleetobs.py", "shard.py",
    "federation.py", "simlab/scenario.py", "simlab/report.py",
    "simlab/pump.py", "simlab/replica.py", "simlab/faults.py",
    "simlab/invariants.py", "simlab/runner.py", "simlab/federation.py",
    "simlab/propgen.py", "simlab/__init__.py",
    # the analyzer, in import order
    "analysis/core.py", "analysis/baseline.py", "analysis/rules.py",
    "analysis/callgraph.py", "analysis/threads.py", "analysis/lockset.py",
    "analysis/lockgraph.py", "analysis/dataflow.py",
    "analysis/asyncflow.py", "analysis/jitflow.py",
    "analysis/resourceflow.py", "analysis/manifests.py", "analysis/slo.py",
    "analysis/sarif.py", "analysis/__init__.py", "analysis/__main__.py",
)

#: module -> [(name, reference block, port block)]
EXCEPTIONS = {
    "device/base.py": [
        ("registry: cuda replaces jax and stays the default, because the "
         "port's entry points and its probe kernel ride the CUDA backend's "
         "flips; sysfs builds the PCI counterpart (device.gpu)", '''\
    - ``sysfs`` (default) — host accel sysfs tree scan (device.tpu);
    - ``jax``             — live PJRT/libtpu enumeration (device.jaxdev),
      the path that touches the real chip;
    - ``fake``            — in-memory fake (device.fake), for kind-style
      dry runs where the DaemonSet has no device plumbing at all.
    """
    name = os.environ.get("TPU_CC_DEVICE_BACKEND", "sysfs").strip().lower()
    if name == "jax":
        from tpu_cc_manager_torch.device.jaxdev import JaxTpuBackend

        return JaxTpuBackend()
    if name == "fake":
        from tpu_cc_manager_torch.device.fake import fake_backend

        return fake_backend()
    if name != "sysfs":
        raise DeviceError(
            f"unknown TPU_CC_DEVICE_BACKEND {name!r}: "
            "expected sysfs | jax | fake"
        )
    from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend

    return SysfsTpuBackend()
''', '''\
    - ``cuda`` (default) — live CUDA enumeration through torch
      (device.cudadev), the path that touches the real card;
    - ``sysfs``          — host PCI sysfs scan for the NVIDIA functions
      (device.gpu), the reference's default backend;
    - ``fake``           — in-memory fake (device.fake), for kind-style
      dry runs where the DaemonSet has no device plumbing at all.

    The default is ``cuda``, not the reference's ``sysfs``: the port's
    entry points and its probe kernel ride the CUDA backend's flips.
    """
    name = os.environ.get("TPU_CC_DEVICE_BACKEND", "cuda").strip().lower()
    if name == "cuda":
        from tpu_cc_manager_torch.device.cudadev import CudaBackend

        return CudaBackend()
    if name == "fake":
        from tpu_cc_manager_torch.device.fake import fake_backend

        return fake_backend()
    if name != "sysfs":
        raise DeviceError(
            f"unknown TPU_CC_DEVICE_BACKEND {name!r}: "
            "expected cuda | sysfs | fake"
        )
    from tpu_cc_manager_torch.device.gpu import SysfsGpuBackend

    return SysfsGpuBackend()
'''),
        ("registry: get_backend's default is cuda, for the same reason", '''\
    (sysfs unless overridden)."""''', '''\
    (cuda unless overridden)."""'''),
    ],
    "config.py": [
        ("probe-devices --backend takes cuda | sysfs | fake; the default "
         "is cuda, the live card, as jax is the reference's live chip", '''\
             "Default backend: jax — the live TPU runtime, i.e. hardware "
             "truth; pass --backend sysfs to inspect the surface a "
             "sysfs-backend agent actually manages.",
    )
    probe.add_argument(
        "--backend",
        choices=("jax", "sysfs", "fake"),
        default=os.environ.get("TPU_CC_DEVICE_BACKEND", "jax"),
        help="device backend to probe (env TPU_CC_DEVICE_BACKEND; "
             "default jax)",''', '''\
             "Default backend: cuda — the live CUDA devices, i.e. hardware "
             "truth; pass --backend sysfs to inspect the surface a "
             "sysfs-backend agent actually manages.",
    )
    probe.add_argument(
        "--backend",
        choices=("cuda", "sysfs", "fake"),
        default=os.environ.get("TPU_CC_DEVICE_BACKEND", "cuda"),
        help="device backend to probe (env TPU_CC_DEVICE_BACKEND; "
             "default cuda)",'''),
    ],
    "analysis/core.py": [
        ("the default surface is the port's package: scripts, bench.py "
         "and __graft_entry__.py belong to the reference, and chip_smoke.py "
         "is a measurement harness", '''\
DEFAULT_TARGETS = ("tpu_cc_manager", "scripts", "bench.py", "__graft_entry__.py")
''', '''\
DEFAULT_TARGETS = ("tpu_cc_manager_torch",)
'''),
        ("the kernel-launch pass runs beside jitflow: its import", '''\
        jitflow,
        lockgraph,
''', '''\
        jitflow,
        launchflow,
        lockgraph,
'''),
        ("the kernel-launch pass runs beside jitflow, over the same audits, "
         "call graph and thread roots", '''\
    findings.extend(jitflow.jitflow_findings(audits, graph, roots))
''', '''\
    findings.extend(jitflow.jitflow_findings(audits, graph, roots))
    findings.extend(launchflow.launchflow_findings(audits, graph, roots))
'''),
    ],
    "trace.py": [
        ("a span keeps its monotonic start beside the wall clock's, so a "
         "span lies on the clock a device trace is tied to: its slot", """\
        "start_ts", "dur_s", "status", "error", "attrs",
""", """\
        "start_ts", "t0", "dur_s", "status", "error", "attrs",
"""),
        ("the monotonic start's initial value", """\
        self.start_ts = time.time()
""", """\
        self.start_ts = time.time()
        #: monotonic start, set as the span opens (Tracer.span)
        self.t0 = 0.0
"""),
        ("Tracer.span keeps the monotonic start it already takes on the "
         "span", """\
        t0 = time.monotonic()
        stack.append(s)
""", """\
        # the span keeps its monotonic start (to_dict leaves it out):
        # [t0, t0 + dur_s] lies on the clock a device trace is tied to
        t0 = s.t0 = time.monotonic()
        stack.append(s)
"""),
    ],
    "rollout.py": [
        ("the preflight's root span, with the listing's span inside it "
         "and the planner's (plan.analyze_fleet) under it", """\
    def run(self) -> RolloutReport:
        nodes = self.discover()
        preflight = analyze_fleet(nodes)
""", """\
    def run(self) -> RolloutReport:
        # the preflight's spans: the listing and the planner here, the
        # group plan below re-seated under the same root (its trace id)
        # — the root closes before any desired-mode write, so each
        # group's desired_write stays the root of its own trace
        with get_tracer().span("preflight", mode=self.mode,
                               dry_run=self.dry_run) as preflight_span:
            with get_tracer().span("discover") as span:
                nodes = self.discover()
                span.attrs["nodes"] = len(nodes)
            preflight = analyze_fleet(nodes)
"""),
        ("the group plan's span, re-seated under the preflight root, with "
         "the evidence check's calls, documents and time counted around "
         "each _evidence_suspects call (the loop re-indented under it), "
         "and the RS256 pre-pass before the loop: one batch of every "
         "signature the check will verify, seen by the judges until the "
         "loop ends, its counts and seconds on the span",
         """\
            planned_count = 0
            for gname, members in self.plan_groups(nodes):
                converged = all(
                    self._converged(by_name[m]) for m in members
                )
                if converged and self.verify_evidence:
                    # a node lying BEFORE the rollout starts must not
                    # slip through as 'skipped': route it through the
                    # judged path, where the contradiction surfaces.
                    # Read-only, so dry-run uses it too — the preview
                    # must classify groups the way the real run would
                    converged = not self._evidence_suspects(
                        members, by_name
                    )
                if converged:
                    results.append(
                        GroupResult(gname, members, "skipped",
                                    f"already at {self.mode}")
                    )
                elif self.dry_run:
                    # the preview marks which groups would canary (the
                    # first N to-run groups, matching the live run's
                    # pending order)
                    detail = ("canary: serial, must succeed"
                              if planned_count < self.canary else "")
                    planned_count += 1
                    results.append(
                        GroupResult(gname, members, "planned", detail)
                    )
                else:
                    pending.append((gname, members))
""", """\
            planned_count = 0
            evidence_calls = evidence_docs = 0
            evidence_s = 0.0
            from tpu_cc_manager_torch import identity as _identity
            from tpu_cc_manager_torch import rs256 as _rs256

            jwks_loads = _identity.jwks_loads
            self._judge_stats = {"identity_s": 0.0, "attestation_s": 0.0}
            self._judge_stats.update(
                (f"{axis}_{v}", 0) for axis in ("id", "att")
                for v in ("ok", "missing", "expired", "mismatch",
                          "invalid", "unverifiable")
            )
            with get_tracer().adopt(preflight_span), \\
                    get_tracer().span("groups") as span:
                groups = self.plan_groups(nodes)
                at_target = [
                    all(self._converged(by_name[m]) for m in members)
                    for _, members in groups
                ]
                # the RS256 pre-pass: every signature the evidence check
                # will verify, in one launch of K6; the judges answer
                # from the batch (identity.rs256_batch) until the loop
                # ends, and no verdict outlives this group plan
                batch = None
                if self.verify_evidence:
                    batch, self._parsed = _rs256.prepare(
                        (m, (by_name[m]["metadata"].get("annotations")
                             or {}).get(L.EVIDENCE_ANNOTATION))
                        for (_, members), conv in zip(groups, at_target)
                        if conv for m in members
                    )
                rs256_batch_s = batch.seconds if batch is not None else 0.0
                evidence_s += rs256_batch_s
                rs256_scope = _identity.rs256_batch.set(batch)
                try:
                    for (gname, members), converged in zip(groups,
                                                           at_target):
                        if converged and self.verify_evidence:
                            # a node lying BEFORE the rollout starts must
                            # not slip through as 'skipped': route it
                            # through the judged path, where the
                            # contradiction surfaces. Read-only, so
                            # dry-run uses it too — the preview must
                            # classify groups the way the real run would
                            t_ev = time.monotonic()
                            converged = not self._evidence_suspects(
                                members, by_name
                            )
                            evidence_s += time.monotonic() - t_ev
                            evidence_calls += 1
                            evidence_docs += sum(
                                1 for m in members
                                if (by_name[m]["metadata"].get(
                                    "annotations") or {}).get(
                                        L.EVIDENCE_ANNOTATION)
                            )
                        if converged:
                            results.append(
                                GroupResult(gname, members, "skipped",
                                            f"already at {self.mode}")
                            )
                        elif self.dry_run:
                            # the preview marks which groups would canary
                            # (the first N to-run groups, matching the
                            # live run's pending order)
                            detail = ("canary: serial, must succeed"
                                      if planned_count < self.canary
                                      else "")
                            planned_count += 1
                            results.append(GroupResult(
                                gname, members, "planned", detail))
                        else:
                            pending.append((gname, members))
                finally:
                    _identity.rs256_batch.reset(rs256_scope)
                    self._parsed = {}
                planned = planned_count + len(pending)
                span.attrs.update(
                    groups=len(results) + len(pending),
                    skipped=len(results) + len(pending) - planned,
                    planned=planned, evidence_calls=evidence_calls,
                    evidence_docs=evidence_docs, evidence_s=evidence_s,
                    jwks_loads=_identity.jwks_loads - jwks_loads,
                    rsa_batched=batch.batched if batch is not None else 0,
                    rsa_host=batch.host if batch is not None else 0,
                    rsa_batch_s=rs256_batch_s,
                    **self._judge_stats,
                )
"""),
        ("the identity and attestation judges' seconds and verdict "
         "counts, kept on the rollout for the group plan's span, and the "
         "documents the group plan's RS256 pre-pass parsed",
         """\
        self._suspect_reasons: Dict[str, str] = {}
""", """\
        self._suspect_reasons: Dict[str, str] = {}
        #: the evidence check's identity and attestation judges: seconds
        #: in each (identity_s, attestation_s) and each verdict's count
        #: (id_<verdict>, att_<verdict>); the group plan's span reports
        #: them for its checks
        self._judge_stats: Dict[str, float] = {}
        #: the group plan's evidence documents as its RS256 pre-pass
        #: parsed them, node -> (annotation, document); empty elsewhere
        self._parsed: Dict[str, Tuple[str, dict]] = {}
"""),
        ("the evidence check takes a document the group plan's RS256 "
         "pre-pass parsed from the same annotation, and parses it "
         "otherwise",
         """\
            try:
                doc = json.loads(raw)
""", """\
            parsed = self._parsed.get(m)
            try:
                doc = (parsed[1] if parsed is not None and parsed[0] is raw
                       else json.loads(raw))
"""),
        ("the helper that counts one judgement",
         """\
    def _evidence_suspects(self, members: List[str],
""", """\
    def _count_judge(self, axis: str, verdict: str, seconds: float) -> None:
        \"\"\"One identity (``id``) or attestation (``att``) judgement.\"\"\"
        st = self._judge_stats
        key = "identity_s" if axis == "id" else "attestation_s"
        st[key] = st.get(key, 0.0) + seconds
        st[f"{axis}_{verdict}"] = st.get(f"{axis}_{verdict}", 0) + 1

    def _evidence_suspects(self, members: List[str],
"""),
        ("the identity judge timed and counted: two monotonic reads",
         """\
            try:
                iverdict, idetail = judge_identity(doc, m)
            except Exception as e:
                iverdict, idetail = "invalid", f"identity judge failed: {e}"
""", """\
            t_judge = time.monotonic()
            try:
                iverdict, idetail = judge_identity(doc, m)
            except Exception as e:
                iverdict, idetail = "invalid", f"identity judge failed: {e}"
            self._count_judge("id", iverdict, time.monotonic() - t_judge)
"""),
        ("the attestation judge timed and counted: two monotonic reads",
         """\
            try:
                averdict, adetail = judge_attestation(doc, m)
            except Exception as e:
                averdict, adetail = (
                    "invalid", f"attestation judge failed: {e}"
                )
""", """\
            t_judge = time.monotonic()
            try:
                averdict, adetail = judge_attestation(doc, m)
            except Exception as e:
                averdict, adetail = (
                    "invalid", f"attestation judge failed: {e}"
                )
            self._count_judge("att", averdict, time.monotonic() - t_judge)
"""),
    ],
    "identity.py": [
        ("the context variable the group plan's RS256 batch is set in",
         """\
import time
from typing import Optional, Tuple
""", """\
import time
from contextvars import ContextVar
from typing import Optional, Tuple
"""),
        ("the RS256 check answers from the group plan's batch (kernel K6) "
         "when it holds the exact inputs, and takes the digest first for "
         "that lookup",
         """\
def _rsa_pkcs1_sha256_verify(n: int, e: int, signing_input: bytes,
                             sig: bytes) -> bool:
    \"\"\"RSASSA-PKCS1-v1_5 / SHA-256 verification from the public
    numbers, pure stdlib: s^e mod n must equal the EMSA-PKCS1-v1_5
    encoding of the hash. That encoding is fully deterministic, so
    verification is an exact compare — no parsing of attacker-shaped
    ASN.1 (the class of bug behind historic BER-laxity forgeries).\"\"\"
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    digest = hashlib.sha256(signing_input).digest()
""", """\
#: the group plan's batch of RS256 verdicts (``rs256.Rs256Batch``): set by
#: ``Rollout.run`` around one group plan's evidence checks, None elsewhere
rs256_batch: ContextVar = ContextVar("rs256_batch", default=None)


def _rsa_pkcs1_sha256_verify(n: int, e: int, signing_input: bytes,
                             sig: bytes) -> bool:
    \"\"\"RSASSA-PKCS1-v1_5 / SHA-256 verification from the public
    numbers, pure stdlib: s^e mod n must equal the EMSA-PKCS1-v1_5
    encoding of the hash. That encoding is fully deterministic, so
    verification is an exact compare — no parsing of attacker-shaped
    ASN.1 (the class of bug behind historic BER-laxity forgeries).
    Inside a group plan the verdict comes from its batch (kernel K6)
    when the batch holds these exact inputs.\"\"\"
    digest = hashlib.sha256(signing_input).digest()
    batch = rs256_batch.get()
    if batch is not None:
        ok = batch.verdict(n, e, digest, sig)
        if ok is not None:
            return ok
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
"""),
        ("a count of the JWKS files read, which the group plan's span "
         "reports: the attestation judge reads its file for every "
         "document", """\
_jwks_cache: dict = {}
""", """\
_jwks_cache: dict = {}

#: JWKS files :func:`load_jwks` has read in this process
jwks_loads = 0
"""),
        ("load_jwks counts each read", """\
    import json as _json

    with open(path) as f:
""", """\
    import json as _json

    global jwks_loads
    jwks_loads += 1
    with open(path) as f:
"""),
        ("the RS256 checks' one reading of a JWT's signing input and "
         "signature, and the group plan's RS256 pre-pass's decode of a "
         "token, as the judges decode it and raising nothing",
         """\
def claimed_node(payload: dict) -> Optional[str]:
""", """\
def _signed_parts(token: str) -> Tuple[bytes, bytes]:
    \"\"\"The signing input and the signature of a three-part JWT, as every
    RS256 check reads them; raises where the signature does not
    decode.\"\"\"
    signing_input, _, sig_b64 = token.rpartition(".")
    return signing_input.encode(), _b64url_decode(sig_b64)


def rs256_inputs(token: object, keys: dict, alg: Optional[str] = "RS256",
                 headers: Optional[dict] = None
                 ) -> Optional[Tuple[int, int, bytes, bytes]]:
    \"\"\"``(n, e, signing input, signature)`` of the RS256 check a judge
    makes of ``token`` under ``keys`` ({kid: (n, e)}), decoded as the
    judges decode it: the header's ``kid`` names the key where its
    ``alg`` is ``alg`` (any, for None), and :func:`_signed_parts` reads
    the rest. None where the judge checks no signature under ``keys``.
    Raises nothing: a token the judges reject as undecodable is None
    here, and one they reject for its payload, which is left to them,
    is a check they never ask for. ``headers`` keeps each header
    segment's key across calls (a fleet's tokens share a few).\"\"\"
    try:
        header_b64, _, _ = token.split(".")
        pub = headers.get(header_b64, ()) if headers is not None else ()
        if pub == ():
            header = json.loads(_b64url_decode(header_b64))
            pub = keys.get(header.get("kid")) if (
                alg is None or header.get("alg") == alg) else None
            if headers is not None:
                headers[header_b64] = pub
        if pub is None:
            return None
        signing_input, sig = _signed_parts(token)
        return pub[0], pub[1], signing_input, sig
    except Exception:
        # the judge meets the same token and says what is wrong with it
        log.debug("RS256 token left to the judges", exc_info=True)
        return None


def claimed_node(payload: dict) -> Optional[str]:
"""),
        ("verify_token reads the signing input and the signature through "
         "_signed_parts", """\
            signing_input, _, sig_b64 = token.rpartition(".")
            try:
                sig = _b64url_decode(sig_b64)
            except Exception as e:
                return "invalid", f"malformed RS256 signature: {e}"
            if not _rsa_pkcs1_sha256_verify(
                    pub[0], pub[1], signing_input.encode(), sig):
""", """\
            try:
                signing_input, sig = _signed_parts(token)
            except Exception as e:
                return "invalid", f"malformed RS256 signature: {e}"
            if not _rsa_pkcs1_sha256_verify(
                    pub[0], pub[1], signing_input, sig):
"""),
    ],
    "attest.py": [
        ("the Confidential Space judge reads the signing input and the "
         "signature through identity._signed_parts, as the identity "
         "judge and the group plan's RS256 pre-pass do", """\
        _b64url_decode, _rsa_pkcs1_sha256_verify, load_jwks,
    )
""", """\
        _b64url_decode, _rsa_pkcs1_sha256_verify, _signed_parts, load_jwks,
    )
"""),
        ("the same, at the signature check", """\
    n, e = keys[kid]
    signing_input = f"{header_b64}.{payload_b64}".encode()
    try:
        sig = _b64url_decode(sig_b64)
        if not _rsa_pkcs1_sha256_verify(n, e, signing_input, sig):
""", """\
    n, e = keys[kid]
    try:
        signing_input, sig = _signed_parts(token)
        if not _rsa_pkcs1_sha256_verify(n, e, signing_input, sig):
"""),
    ],
    "analysis/rules.py": [
        ("the metric-name pattern matches the port's package name as it "
         "matches the reference's, and neither is a metric", '''\
_METRIC_IGNORE = {"tpu_cc_manager"}
''', '''\
_METRIC_IGNORE = {"tpu_cc_manager", "tpu_cc_manager_torch"}
'''),
    ],
}


def rewrite_imports(text: str) -> str:
    """The reference source as the port imports it: ``tpu_cc_manager``
    becomes ``tpu_cc_manager_torch`` in import statements only."""
    out = []
    for line in text.splitlines(keepends=True):
        m = _IMPORT.match(line)
        if m:
            line = line[:m.end()] + "_torch" + line[m.end():]
        out.append(line)
    return "".join(out)


def rewrite_paths(text: str) -> str:
    """``text`` with every ``tpu_cc_manager`` followed by ``/`` or ``.``
    naming the port: paths and dotted names, in code and literals."""
    return _PATH.sub("tpu_cc_manager_torch", text)


def reference_as_port(module: str) -> str:
    """The reference's ``module`` rewritten as its copy's rule says."""
    text = rewrite_imports((ROOT / "tpu_cc_manager" / module).read_text())
    return rewrite_paths(text) if module.startswith(PATH_REWRITTEN) else text


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_its_reference(module):
    want = reference_as_port(module)
    for name, ref_block, port_block in EXCEPTIONS.get(module, ()):
        assert want.count(ref_block) == 1, (
            f"{module}: exception {name!r} no longer matches the reference")
        want = want.replace(ref_block, port_block)
    got = (ROOT / "tpu_cc_manager_torch" / module).read_text()
    if got != want:
        import difflib

        diff = "".join(difflib.unified_diff(
            want.splitlines(keepends=True), got.splitlines(keepends=True),
            f"reference/{module} (rewritten)", f"port/{module}", n=1))
        pytest.fail(f"{module} drifted from its reference:\n{diff[:4000]}")


def test_the_rewrite_touches_import_statements_only():
    src = ('"""see tpu_cc_manager.engine"""\n'
           "from tpu_cc_manager import device as devlayer\n"
           "    from tpu_cc_manager.device.base import DeviceError\n"
           "import tpu_cc_manager.trace\n"
           "x = 'python -m tpu_cc_manager'\n"
           "from tpu_cc_manager_torch import plan\n")
    assert rewrite_imports(src) == (
        '"""see tpu_cc_manager.engine"""\n'
        "from tpu_cc_manager_torch import device as devlayer\n"
        "    from tpu_cc_manager_torch.device.base import DeviceError\n"
        "import tpu_cc_manager_torch.trace\n"
        "x = 'python -m tpu_cc_manager'\n"
        "from tpu_cc_manager_torch import plan\n")


def test_the_path_rewrite_names_the_port_in_paths_and_dotted_names():
    src = ('''"""python -m tpu_cc_manager.analysis"""\n'''
           "from tpu_cc_manager import labels\n"
           'X = ("tpu_cc_manager/simlab/", "tpu_cc_manager.labels.")\n'
           'T = ("tpu_cc_manager", "tpu_cc_manager_torch/plan.py")\n')
    assert rewrite_paths(rewrite_imports(src)) == (
        '''"""python -m tpu_cc_manager_torch.analysis"""\n'''
        "from tpu_cc_manager_torch import labels\n"
        'X = ("tpu_cc_manager_torch/simlab/", '
        '"tpu_cc_manager_torch.labels.")\n'
        'T = ("tpu_cc_manager", "tpu_cc_manager_torch/plan.py")\n')
