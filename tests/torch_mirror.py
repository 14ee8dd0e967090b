"""Re-run a reference test module against the port, case by case.

``port_twin("test_agent")`` loads ``tests/test_agent.py`` a second time,
with its import statements rewritten from ``tpu_cc_manager`` to
``tpu_cc_manager_torch`` (the rewrite ``tests/test_torch_copies.py``
holds the copies to) and any named edits applied. ``both(...)`` then runs
one case on the reference module and on its twin: each side over its own
package's ``FakeKube``, fake backend and registries, so every assertion
of the reference case holds on both. What the case leaves behind is
recorded on each side and must be equal:

- for every ``FakeKube`` the case built: each node's labels, annotations
  (JSON ones parsed), taints and ``spec.unschedulable``, the pods still
  bound, and the core/v1 Events posted;
- for each node and each label or annotation key, the values the write
  batcher (``NodePatchBatcher``) published, in order (how it grouped
  keys into writes depends on when its flush window closed);
- every admission response (``mutate_pod``, ``validate_pod``,
  ``review_response``);
- every doctor report (``run_doctor``), ordered by node (agents on
  several nodes run their doctors as their threads run);
- for every sharded control plane (``ShardManager``), as it stood when
  the case stopped it (or at the case's end, if it never did): its
  ``stats()`` (the ring's partition, the live hosts, the coverage, the
  failover log), the pools each live shard's controllers hold, and the
  holder and transition count of each shard lease in its ``FakeKube``;
- for every federation (``FederationManager``), likewise: its
  ``stats()``, its ``attestation_summary()`` and each region's
  ``node_read_requests``;
- for every SLO observer (``FleetObserver``): its alert log and the
  problems of its last merged exposition (``aggregation_problems``).

A mirror may ask for more (``both``'s ``calls``): the calls of the named
functions the case makes from its own thread, each with what it
returned (or the exception it raised) and, for a method of an object
with a tracer (``ModeEngine.set_mode``), the names of the spans that
tracer finished during the call; and every statefile
(``<state_dir>/<device-key>/{cc,ici}.{staged,effective}``) under the
case's scratch directory.

Before the snapshot, every agent the case built (``CCManagerAgent``)
delivers what it has queued (``flush_events``): its Events are posted by
a worker thread that may still hold them when the case's last assertion
passes.

Masked before the comparison, and nothing else: timestamps (ISO-8601
strings, the ``firstTimestamp``/``lastTimestamp``/``timestamp``/``at``
fields, the slice heartbeat's clock reading, the rollout record's
``started`` and ``heartbeat`` clock readings, the ``in 0.12s``
durations an Event message carries, an SLO alert's ``at``, a failover's
``handoff_s`` and an evacuation's ``cordon_s``, both seconds on the host
clock, and a lease's ``acquireTime`` and ``renewTime``), uuids, the random suffixes of
one-shot, maintenance and policy Event names and the random ``id`` and ``owner`` of
a document that holds a clock reading (a rollout record), trace ids
(``traceparent`` values), and the evidence digests computed over a
document that holds a timestamp (each side's digest is checked against
its own document by the case's own evidence assertions).
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import inspect
import itertools
import json
import os
import pathlib
import re
import socket
import sys
import threading
import time
import types

import pytest

from test_torch_copies import rewrite_imports, rewrite_paths

TESTS = pathlib.Path(__file__).resolve().parent

_ISO = re.compile(
    r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2}(?:\.\d+)?(?:Z|[+-]\d{2}:?\d{2})?")
_UUID = re.compile(
    r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
#: a traceparent: W3C ids, or this build's counter-style ids (a random
#: per-tracer prefix and a counter, ``trace.Tracer._next_id``)
_TRACEPARENT = re.compile(r"\b00-[0-9a-f]{9,32}-[0-9a-f]{9,16}-[0-9a-f]{2}\b")
_DURATION = re.compile(r"\bin \d+\.\d+s\b")
_ONESHOT = re.compile(r"(\.cc-(?:oneshot|reconcile|maint)\.|\.ccpolicy\.)[0-9a-f]+")
_TS_KEYS = frozenset({"firstTimestamp", "lastTimestamp", "timestamp", "at",
                      "eventTime", "creationTimestamp",
                      # the rollout record's clock readings (epoch seconds)
                      "started", "heartbeat",
                      # seconds a shard failover and a region's cordon
                      # took, on the host clock
                      "handoff_s", "cordon_s",
                      # a lease's stamps
                      "acquireTime", "renewTime"})
_DIGEST_KEYS = frozenset({"digest"})
#: the random ids a rollout record carries (its id, its owner's fencing
#: token), masked in a document that holds a clock reading
_RANDOM_ID_KEYS = frozenset({"id", "owner"})


def _mask_str(s: str) -> str:
    s = _ISO.sub("<ts>", s)
    s = _UUID.sub("<uuid>", s)
    s = _TRACEPARENT.sub("<traceparent>", s)
    s = _DURATION.sub("in <dur>s", s)
    return _ONESHOT.sub(r"\1<id>", s)


def mask(value, key=None):
    """``value`` with its timestamps, uuids and trace ids masked."""
    if key in _TS_KEYS and value is not None:
        return "<ts>"
    if isinstance(value, dict):
        holds_time = any(k in _TS_KEYS for k in value)
        return {k: ("<digest>" if holds_time and k in _DIGEST_KEYS
                    else "<id>" if holds_time and k in _RANDOM_ID_KEYS
                    else mask(v, k)) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [mask(v) for v in value]
    if isinstance(value, str):
        return _mask_str(value)
    return value


class Side(types.SimpleNamespace):
    """One package under test: ``pkg`` is ``tpu_cc_manager`` or
    ``tpu_cc_manager_torch``."""

    def module(self, name: str):
        return importlib.import_module(f"{self.pkg}.{name}")

    def reset(self) -> None:
        """The process-wide state a case may leave behind: the device
        registry and the identity caches (conftest resets only the
        reference's, between tests)."""
        self.module("device.base").set_backend(None)
        identity = self.module("identity")
        identity._auto_cache = None
        identity._explicit_cache.clear()


REF = Side(name="reference", pkg="tpu_cc_manager")
PORT = Side(name="port", pkg="tpu_cc_manager_torch")


def port_twin(name: str, edits=(), paths: bool = False):
    """The reference test module ``name`` as the port runs it. ``edits``
    are ``(why, old, new)`` text replacements, each matching once, or
    ``(why, old, new, count)``, matching ``count`` times. With ``paths``
    the module takes the analyzer copies' second rewrite too
    (``tests/test_torch_copies.py::rewrite_paths``), before the edits:
    its fixtures' relpaths and dotted names then name the port."""
    path = TESTS / f"{name}.py"
    src = rewrite_imports(path.read_text())
    if paths:
        src = rewrite_paths(src)
    for why, old, new, *count in edits:
        want = count[0] if count else 1
        assert src.count(old) == want, (
            f"{name}: edit {why!r} no longer matches {want} time(s)")
        src = src.replace(old, new)
    mod = types.ModuleType(f"{name}__port")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def cases(mod):
    """``pytest.param(test_name, params)`` for every case of ``mod``,
    parametrized tests expanded as pytest expands them."""
    out = []
    for name, fn in vars(mod).items():
        if not name.startswith("test_") or not inspect.isfunction(fn):
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append(pytest.param(name, {}, id=name))
            continue
        axes = []
        for m in marks:
            argnames = m.args[0]
            if isinstance(argnames, str):
                argnames = [a.strip() for a in argnames.split(",")]
            rows = []
            for i, vals in enumerate(m.args[1]):
                if len(argnames) == 1:
                    vals = (vals,)
                rows.append((f"{argnames[0]}{i}", dict(zip(argnames, vals))))
            axes.append(rows)
        for combo in itertools.product(*axes):
            params = {}
            for _, p in combo:
                params.update(p)
            cid = "-".join(i for i, _ in combo)
            out.append(pytest.param(name, params, id=f"{name}[{cid}]"))
    return out


#: a statefile of the mode store (``device/statefile.py``)
_STATEFILE = re.compile(r"^(?:cc|ici)\.(?:staged|effective)$")


def _statefiles(tmp: str):
    """Every statefile under ``tmp``: its path under ``tmp`` (the
    device key's copy of ``tmp`` named ``<tmp>``) -> its contents."""
    out = {}
    key_tmp = tmp.replace("/", "_")
    for root, _dirs, files in os.walk(tmp):
        for f in files:
            if _STATEFILE.match(f):
                path = os.path.join(root, f)
                rel = os.path.relpath(path, tmp).replace(key_tmp, "<tmp>")
                with open(path) as fh:
                    out[rel] = fh.read()
    return dict(sorted(out.items()))


class _Recorder:
    def __init__(self):
        #: the calls recorded for ``both``'s ``calls``, or None
        self.calls = None
        self.kubes = []
        self.batcher_writes = []
        self.admission = []
        self.doctor_reports = []
        self.agents = []
        #: [object, its view when the case stopped it, or None]
        self.shard_managers = []
        self.federations = []
        self.observers = []

    def snapshot(self, tmp: str):
        for agent in self.agents:
            assert agent.flush_events(), "an agent's Events never drained"
        reports = sorted(self.doctor_reports, key=lambda r: json.dumps(
            r["out"].get("node") if isinstance(r["out"], dict) else None))
        extra = {} if self.calls is None else {
            "calls": mask(self.calls), "statefiles": _statefiles(tmp)}
        return _untmp({
            **extra,
            "kubes": [_kube_view(k) for k in self.kubes],
            "batcher_writes": _publish_history(self.batcher_writes),
            "admission": mask(self.admission),
            "doctor_reports": mask(reports),
            "shard_managers": [view if view is not None
                               else _shard_view(mgr)
                               for mgr, view in self.shard_managers],
            "federations": [view if view is not None else _federation_view(f)
                            for f, view in self.federations],
            "observers": [_observer_view(o) for o in self.observers],
        }, tmp)


def _leases(kube):
    """shard lease name -> its holder and transition count, for a
    ``FakeKube`` (None for any other client)."""
    if not hasattr(kube, "_leases"):
        return None
    with kube._lock:
        leases = copy.deepcopy(kube._leases)
    return {f"{ns}/{name}": {
        "holder": (lease.get("spec") or {}).get("holderIdentity"),
        "transitions": (lease.get("spec") or {}).get("leaseTransitions")}
        for (ns, name), lease in sorted(leases.items())}


def _shard_view(mgr):
    return mask({
        "stats": mgr.stats(),
        "pools": {b.shard_id: sorted(b.pools) for b in mgr.bundles()},
        "leases": _leases(mgr.client_factory()),
    })


def _federation_view(fed):
    return mask({
        "stats": fed.stats(),
        "attestation": fed.attestation_summary(),
        "node_read_requests": {
            region: getattr(fed.specs[region].client_factory(),
                            "node_read_requests", None)
            for region in fed.regions},
    })


def _observer_view(observer):
    return mask({"alerts": list(observer.alerts),
                 "aggregation_problems": list(
                     observer.aggregation_problems)})


def _record_stops(mp: pytest.MonkeyPatch, cls, into, view) -> None:
    """Record every ``cls`` built in ``into`` as ``[obj, None]``; its
    first ``stop()`` fills in ``view(obj)`` as it stood just before."""
    init, stop = cls.__init__, cls.stop

    def record_init(self, *a, **kw):
        init(self, *a, **kw)
        into.append([self, None])

    def record_stop(self, *a, **kw):
        for entry in into:
            if entry[0] is self and entry[1] is None:
                entry[1] = view(self)
        return stop(self, *a, **kw)

    mp.setattr(cls, "__init__", record_init)
    mp.setattr(cls, "stop", record_stop)


def _untmp(value, tmp: str):
    """``value`` with the side's own scratch directory named ``<tmp>``."""
    if isinstance(value, dict):
        return {k: _untmp(v, tmp) for k, v in value.items()}
    if isinstance(value, list):
        return [_untmp(v, tmp) for v in value]
    if isinstance(value, str):
        return value.replace(tmp, "<tmp>")
    return value


def _publish_history(writes):
    """node -> key -> the values the batcher published for that key, in
    order, repeats collapsed. How the batcher groups keys into one write
    depends on when its flush window closes, and agents on several nodes
    interleave as threads run; what each key went through does not."""
    out = {}
    for w in writes:
        node = out.setdefault(w["node"], {})
        for kind in ("labels", "annotations"):
            for k, v in w[kind].items():
                v = _annotation_view(v) if kind == "annotations" else mask(v)
                hist = node.setdefault(f"{kind}:{k}", [])
                if not hist or hist[-1] != v:
                    hist.append(v)
    return out


def _annotation_view(value):
    try:
        parsed = json.loads(value)
    except (TypeError, ValueError):
        return mask(value)
    return mask(parsed) if isinstance(parsed, (dict, list)) else mask(value)


def _kube_view(kube):
    from tpu_cc_manager import labels as L

    with kube._lock:
        nodes = copy.deepcopy(kube._nodes)
        pods = sorted(kube._pods)
        events = copy.deepcopy(kube.cluster_events)
    view = {}
    for name in sorted(nodes):
        meta = nodes[name]["metadata"]
        spec = nodes[name].get("spec") or {}
        ann = {}
        for k, v in sorted((meta.get("annotations") or {}).items()):
            ann[k] = ("<ts>" if k == L.SLICE_HB_ANNOTATION
                      else _annotation_view(v))
        view[name] = {
            "labels": mask(dict(sorted((meta.get("labels") or {}).items()))),
            "annotations": ann,
            "taints": mask(spec.get("taints") or []),
            "unschedulable": bool(spec.get("unschedulable")),
        }
    for e in events:
        e["metadata"].pop("resourceVersion", None)
    # agents on several nodes post as their threads run: order by node
    events.sort(key=lambda e: e.get("involvedObject", {}).get("name", ""))
    return {"nodes": view, "pods": [list(p) for p in pods],
            "events": mask(events)}


def settled(snapshot):
    """What a case whose threads race its own end leaves for certain:
    each node's labels, taints and ``spec.unschedulable``. The doctor's
    ok label is left out: it rides the idle tick's self-check, which
    lands or not before the case stops its agents."""
    from tpu_cc_manager import labels as L

    return [{name: {"labels": {k: v for k, v in n["labels"].items()
                               if k != L.DOCTOR_OK_LABEL},
                    "taints": n["taints"],
                    "unschedulable": n["unschedulable"]}
             for name, n in kube["nodes"].items()}
            for kube in snapshot["kubes"]]


#: the stats of a sharded control plane that do not move with its
#: leases: the region, the ring's shape and partition, the host count
_RING_STATS = ("region", "shards", "hosts", "partition")
#: a federation's stats that do not move with its regions' leases
_POSTURE_STATS = ("regions", "ring_members", "posture", "evacuated",
                  "partitioned", "evacuations")


def without_live_leases(snapshot):
    """The snapshot without what moves with the shard leases when a case
    makes them lapse (a region's API server blacked out): each shard
    manager's coverage, live hosts, failover log, live shards' pools and
    lease holders, and each federation's managers' stats, attestation
    summary (read from the live shards' reports) and node reads (the
    informers' relists after the outage)."""
    out = copy.deepcopy(snapshot)
    out["shard_managers"] = [
        {"stats": {k: m["stats"][k] for k in _RING_STATS}}
        for m in out["shard_managers"]]
    out["federations"] = [
        {"stats": {k: f["stats"][k] for k in _POSTURE_STATS}}
        for f in out["federations"]]
    return out


def without_doctor(snapshot):
    """The snapshot without the idle tick's doctor self-check: its
    verdict label and annotation, on the nodes and in the batcher's
    history, and its reports. Each agent runs it on a timer that fires
    or not before the case stops its agents."""
    from tpu_cc_manager import labels as L

    out = copy.deepcopy(snapshot)
    for kube in out["kubes"]:
        for node in kube["nodes"].values():
            node["labels"].pop(L.DOCTOR_OK_LABEL, None)
            node["annotations"].pop(L.DOCTOR_ANNOTATION, None)
    for hist in out["batcher_writes"].values():
        hist.pop(f"labels:{L.DOCTOR_OK_LABEL}", None)
        hist.pop(f"annotations:{L.DOCTOR_ANNOTATION}", None)
    out["doctor_reports"] = []
    return out


def _record_calls(side: Side, mp: pytest.MonkeyPatch, testmod, calls,
                  into: list) -> None:
    """Wrap each ``"module:function"`` or ``"module:Class.method"`` of
    ``calls`` on ``side`` (and the test module's own name for a
    function, if it imported one) to record, in ``into``, the calls made
    from this thread."""
    case_thread = threading.current_thread()
    for spec in calls:
        modname, _, attr = spec.partition(":")
        module = side.module(modname)
        owner_name, _, fname = attr.rpartition(".")
        owner = getattr(module, owner_name) if owner_name else module
        real = getattr(owner, fname)

        def wrapped(*a, _real=real, _spec=spec, **kw):
            if threading.current_thread() is not case_thread:
                return _real(*a, **kw)
            entry = {"fn": _spec}
            into.append(entry)
            tracer = getattr(a[0], "_tracer", None) if a else None
            spans = []
            sink = (lambda span: spans.append(span.name))
            if tracer is not None:
                tracer.add_sink(sink)
            try:
                out = _real(*a, **kw)
            except BaseException as e:
                entry["raised"] = type(e).__name__
                raise
            finally:
                if tracer is not None:
                    tracer.remove_sink(sink)
                    # flips of several devices finish their spans as
                    # their threads run
                    entry["spans"] = sorted(spans)
            entry["out"] = copy.deepcopy(out)
            return out

        mp.setattr(owner, fname, wrapped)
        if not owner_name and testmod.__dict__.get(fname) is real:
            mp.setattr(testmod, fname, wrapped)


@contextlib.contextmanager
def recording(side: Side, mp: pytest.MonkeyPatch, testmod, calls=None):
    """Record, on ``side``, what the case leaves behind (see the module
    docstring)."""
    rec = _Recorder()
    if calls is not None:
        rec.calls = []
        _record_calls(side, mp, testmod, calls, rec.calls)
    fake = side.module("k8s.fake")
    batch = side.module("k8s.batch")
    webhook = side.module("webhook")

    init = fake.FakeKube.__init__

    def kube_init(self, *a, **kw):
        init(self, *a, **kw)
        rec.kubes.append(self)

    mp.setattr(fake.FakeKube, "__init__", kube_init)

    write = batch.NodePatchBatcher._write_split

    def batch_write(self, labels, ann):
        rec.batcher_writes.append({"node": self.node_name,
                                   "labels": copy.deepcopy(labels),
                                   "annotations": copy.deepcopy(ann)})
        return write(self, labels, ann)

    mp.setattr(batch.NodePatchBatcher, "_write_split", batch_write)

    agent_cls = side.module("agent").CCManagerAgent
    agent_init = agent_cls.__init__

    def record_agent(self, *a, **kw):
        agent_init(self, *a, **kw)
        rec.agents.append(self)

    mp.setattr(agent_cls, "__init__", record_agent)

    _record_stops(mp, side.module("shard").ShardManager,
                  rec.shard_managers, _shard_view)
    _record_stops(mp, side.module("federation").FederationManager,
                  rec.federations, _federation_view)
    observer_cls = side.module("fleetobs").FleetObserver
    observer_init = observer_cls.__init__

    def record_observer(self, *a, **kw):
        observer_init(self, *a, **kw)
        rec.observers.append(self)

    mp.setattr(observer_cls, "__init__", record_observer)

    doctor = side.module("doctor")
    for module, fname, into in (
            (webhook, "mutate_pod", rec.admission),
            (webhook, "validate_pod", rec.admission),
            (webhook, "review_response", rec.admission),
            (doctor, "run_doctor", rec.doctor_reports)):
        real = getattr(module, fname)

        def wrapped(*a, _real=real, _name=fname, _into=into, **kw):
            out = _real(*a, **kw)
            _into.append({"fn": _name, "out": copy.deepcopy(out)})
            return out

        mp.setattr(module, fname, wrapped)
        if testmod.__dict__.get(fname) is real:
            mp.setattr(testmod, fname, wrapped)
    yield rec


def run_case(side: Side, testmod, name: str, params: dict, request,
             tmp_path: pathlib.Path, calls=None):
    """Run ``testmod.<name>`` on ``side`` with the fixtures it asks for;
    return what it left behind (with ``calls``, the calls and statefiles
    too)."""
    fn = getattr(testmod, name)
    side_tmp = tmp_path / side.name
    side_tmp.mkdir()
    side.reset()
    try:
        with pytest.MonkeyPatch.context() as mp, \
                recording(side, mp, testmod, calls) as rec, \
                contextlib.ExitStack() as teardowns:
            made = {}

            def resolve(arg):
                if arg in params:
                    return params[arg]
                if arg == "tmp_path":
                    return side_tmp
                if arg == "monkeypatch":
                    return mp
                fixture = getattr(testmod, arg, None)
                if not hasattr(fixture, "_get_wrapped_function"):
                    return request.getfixturevalue(arg)
                # a fixture of the test module itself: each side builds
                # its own, with the fixtures it asks for, and tears it
                # down (the code after its yield) before the side's
                # monkeypatch is undone
                if arg not in made:
                    build = fixture._get_wrapped_function()
                    value = build(**{a: resolve(a) for a in
                                     inspect.signature(build).parameters})
                    if inspect.isgenerator(value):
                        gen, value = value, next(value)
                        teardowns.callback(next, gen, None)
                    made[arg] = value
                return made[arg]

            kwargs = {arg: resolve(arg)
                      for arg in inspect.signature(fn).parameters}
            for fixture in ("capsys", "capfd"):
                if fixture in kwargs:
                    # what the other side printed and its case left
                    # unread is not this side's output
                    kwargs[fixture].readouterr()
            fn(**kwargs)
            return rec.snapshot(str(side_tmp))
    finally:
        side.reset()


def _first_difference(want, got, path="$"):
    if type(want) is not type(got):
        return f"{path}: {want!r} != {got!r}"
    if isinstance(want, dict):
        for k in sorted(set(want) | set(got), key=str):
            if k not in want or k not in got:
                return f"{path}.{k}: only on the " + (
                    "port" if k in got else "reference")
            d = _first_difference(want[k], got[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(want, list):
        for i, (w, g) in enumerate(zip(want, got)):
            d = _first_difference(w, g, f"{path}[{i}]")
            if d:
                return d
        if len(want) != len(got):
            return f"{path}: {len(want)} items on the reference, " \
                   f"{len(got)} on the port"
        return None
    return None if want == got else f"{path}: {want!r} != {got!r}"


def both(testmods, name: str, params: dict, request, tmp_path, versions,
         racy=None, view=None, calls=None):
    """Run case ``name`` on the reference module and on its port twin;
    what the two leave behind must be equal, as ``view(name, side,
    snapshot)`` shows it when a view is given. ``racy`` maps a case whose
    threads race its own end to ``(part, why)``: only ``part(snapshot)``
    is compared there (``settled`` or ``without_doctor``). ``calls``
    names the calls to record too (see the module docstring). Returns
    the port's."""
    ref_mod, port_mod = testmods
    want = run_case(REF, ref_mod, name, params, request, tmp_path, calls)
    got = run_case(PORT, port_mod, name, params, request, tmp_path, calls)
    if view is not None:
        want, got = view(name, REF, want), view(name, PORT, got)
    if racy and name in racy:
        part = racy[name][0]
        want, got = part(want), part(got)
    assert got == want, (f"port and reference differ ({versions}): "
                         f"{_first_difference(want, got)}")
    return got


def sharded(params, planner):
    """``params`` (from :func:`cases`) with a planner shard count: every
    case at one shard, and the cases named in ``planner`` (those that
    reach the planner) at 8 shards too (``TPU_CC_PLANNER_MESH``)."""
    out = []
    for p in params:
        name, kw = p.values
        out.append(pytest.param(name, kw, 1, id=f"{p.id}-mesh1"))
        if name in planner:
            out.append(pytest.param(name, kw, 8, id=f"{p.id}-mesh8"))
    return out


@contextlib.contextmanager
def planner_calls(mp: pytest.MonkeyPatch, entry_points):
    """Count the calls of each ``(module, name)`` planner entry point the
    controllers bound at import; yields the list of names called."""
    calls = []
    for module, fname in entry_points:
        real = getattr(module, fname)

        def counted(*a, _real=real, _name=fname, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        mp.setattr(module, fname, counted)
    yield calls


def at_shards(params, shards, only=None):
    """``params`` (from :func:`cases`) at one planner shard count
    (``TPU_CC_PLANNER_MESH``); with ``only``, just the cases it names."""
    return [pytest.param(*p.values, shards, id=f"{p.id}-mesh{shards}")
            for p in params if only is None or p.values[0] in only]


#: the default ports of the fleet controller, the policy controller, the
#: agent's health server and the webhook
FIXED_PORTS = frozenset({8090, 8091, 8089, 8443})


def no_fixed_ports(mp: pytest.MonkeyPatch):
    """Refuse, for the case's duration, any bind to one of
    ``FIXED_PORTS``: the reference's own test file may run on another
    worker at the same time. Returns the list of ports the case bound,
    which the caller checks too (a bind refused in a controller's thread
    may be swallowed there)."""
    real = socket.socket.bind
    bound = []

    def bind(self, address):
        if isinstance(address, tuple) and len(address) >= 2:
            bound.append(address[1])
            if address[1] in FIXED_PORTS:
                raise OSError(f"a mirrored case bound fixed port "
                              f"{address[1]}")
        return real(self, address)

    mp.setattr(socket.socket, "bind", bind)
    return bound


#: threads a case may leave running: the informers' watches and a fleet
#: controller's private watch (``fleet-watch``; they feed encodings on
#: the host and never reach the planner, and stay blocked in their
#: watch until its next event or its timeout, 300 s for the fleet's
#: watch of a stopped API server), the fake API server's request
#: handlers and the process's one asyncio bridge
#: (``k8s/aio_bridge.py``)
IDLE_THREADS = re.compile(
    r"node-informer-|fleet-watch$|cc-aio-loop$|asyncio_"
    r"|.*\(process_request_thread\)$")


@contextlib.contextmanager
def threads_ended(timeout_s: float = 60.0):
    """At the block's end, wait up to ``timeout_s`` for every thread the
    block started to end, but for ``IDLE_THREADS``; yields the list that
    then holds the names of those still running. A controller thread
    that outlives its ``stop()`` (``ControllerShard.stop`` joins for
    5 s) may still be planning when the case's monkeypatch restores
    ``TPU_CC_PLANNER_MESH``; the reference's planner keys a compiled
    function by the device count it read before the restore and builds
    it over the devices it reads after, and a later test at that count
    gets a function for other devices."""
    before = set(threading.enumerate())
    left = []
    try:
        yield left
    finally:
        deadline = time.monotonic() + timeout_s
        while True:
            left[:] = sorted(t.name for t in set(threading.enumerate())
                             - before
                             if t.is_alive() and not IDLE_THREADS.match(t.name))
            if not left or time.monotonic() > deadline:
                break
            time.sleep(0.05)
