"""The throwaway block's one-pass build held to the per-node loop.

``FleetEncoding._throwaway(nodes)`` (what ``analyze_fleet`` and
``encode_fleet`` build) must leave the rows, columns, slice ids, slice
refcounts and members, doctor details and ``rows_written`` that one
``FleetEncoding.apply`` per node leaves, over fleets of both shapes and
over hostile node shapes; a list that repeats a name takes the loop
itself. A later ``apply``, ``remove`` or ``sync`` on a block built either
way gives the same block. ``_parse_ts``'s exact-shape path is held to
the JAX package's ``time.strptime`` reading, with the counters that say
which way each string went.
"""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

FMT = "%Y-%m-%dT%H:%M:%SZ"
FLIP = {"key": L.FLIP_TAINT_KEY, "effect": "NoSchedule"}


def _node(name, labels=None, ann=None, taints=None, **meta):
    node = {"metadata": {"name": name, **meta}, "spec": {}}
    if labels is not None:
        node["metadata"]["labels"] = labels
    if ann is not None:
        node["metadata"]["annotations"] = ann
    if taints is not None:
        node["spec"]["taints"] = taints
    return node


def _stamp(epoch):
    return time.strftime(FMT, time.gmtime(epoch))


def _shaped(shape, seed=7):
    """Slices of 18 or solo nodes with the whole mix: every mode, flip
    taints, doctor verdicts, and evidence fresh, stale, garbled or
    absent."""
    rng = np.random.default_rng(seed)
    modes = ["on", "off", "devtools", "ici", "failed", None, "garbage"]
    doctors = [None, json.dumps({"ok": True, "at": "2026-10-01T00:00:00Z"}),
               json.dumps({"ok": False, "fail": ["iommu"], "at": None}),
               "{not json"]
    size, groups = (18, 6) if shape == "slices" else (1, 120)
    now = int(time.time())
    nodes = []
    for g in range(groups):
        for i in range(size):
            labels = {}
            for key in (L.CC_MODE_LABEL, L.CC_MODE_STATE_LABEL):
                mode = modes[rng.integers(len(modes))]
                if mode:
                    labels[key] = mode
            if size > 1:
                labels[L.TPU_SLICE_LABEL] = f"nvl-{g:03d}"
            ann = {}
            doctor = doctors[rng.integers(len(doctors))]
            if doctor:
                ann[L.DOCTOR_ANNOTATION] = doctor
            ev = rng.integers(4)
            if ev < 2:
                # an hour clear of the staleness threshold: two ticks a
                # second apart read the same buckets
                age = int(rng.integers(0, 1800)) + 5400 * int(ev)
                ann[L.EVIDENCE_ANNOTATION] = json.dumps(
                    {"version": 1, "timestamp": _stamp(now - age)})
            elif ev == 2:
                ann[L.EVIDENCE_ANNOTATION] = "{garbled"
            taints = [FLIP] if rng.random() < 0.1 else None
            nodes.append(_node(f"{shape}-{g:03d}-{i:02d}", labels, ann,
                               taints))
    return nodes


def _bare():
    """Nodes missing labels, annotations or spec, or with None there."""
    return [
        _node("no-labels"),
        {"metadata": {"name": "none-meta-maps", "labels": None,
                      "annotations": None}, "spec": None},
        {"metadata": {"name": "no-spec", "labels": {L.CC_MODE_LABEL: "on"}}},
        _node("empty-maps", {}, {}, []),
        _node("empty-slice", {L.TPU_SLICE_LABEL: ""}),
        _node("none-slice", {L.TPU_SLICE_LABEL: None}),
        _node("with-slice", {L.TPU_SLICE_LABEL: "s"}),
    ]


def _doctors():
    raws = [None, "", json.dumps({"ok": True}), json.dumps({"ok": 1}),
            json.dumps({"ok": False, "fail": ["iommu"], "at": "x"}),
            json.dumps({"ok": False}), json.dumps({"fail": ["nvlink"]}),
            "{malformed", "[1, 2]", '"ok"', "3", "null", "true"]
    return [_node(f"doctor-{i:02d}", {L.CC_MODE_LABEL: "on"},
                  {L.DOCTOR_ANNOTATION: raw} if raw is not None else {})
            for i, raw in enumerate(raws)]


#: evidence annotations, each with the way its timestamp is read:
#: ``fast``, ``fallback`` (a string ``time.strptime`` reads) or None
EVIDENCE = [
    (None, None), ("", None), ("{malformed", None), ("[1, 2]", None),
    ('"2024-01-01T00:00:00Z"', None), ("{}", None),
    (json.dumps({"timestamp": None}), None),
    (json.dumps({"timestamp": 1704067200}), None),
    (json.dumps({"timestamp": ["2024-01-01T00:00:00Z"]}), None),
    (json.dumps({"timestamp": "2024-01-01T00:00:00Z"}), "fast"),
    (json.dumps({"timestamp": "2024-01-01T00:00:60Z"}), "fallback"),
    (json.dumps({"timestamp": "2024-01-01t00:00:00z"}), "fallback"),
    (json.dumps({"timestamp": "yesterday"}), "fallback"),
]


def _evidence():
    return [_node(f"ev-{i:02d}", {L.CC_MODE_LABEL: "on"},
                  {L.EVIDENCE_ANNOTATION: raw} if raw is not None else {})
            for i, (raw, _) in enumerate(EVIDENCE)]


def _taints():
    return [_node("t-mixed", taints=["x", None, 3, ["k"], FLIP]),
            _node("t-other", taints=[{"key": "other"}, "x"]),
            _node("t-none", taints=[None]),
            _node("t-flip", taints=[FLIP]),
            {"metadata": {"name": "t-spec-none"}, "spec": {"taints": None}}]


def _repeated():
    """A name listed twice, with another slice, mode and verdict: the
    fallback must keep apply's last write and slice release."""
    nodes = _shaped("slices")[:40] + _bare()
    twin = _node("slices-000-03", {L.CC_MODE_LABEL: "off",
                                   L.TPU_SLICE_LABEL: "nvl-001"},
                 {L.DOCTOR_ANNOTATION: "{bad"})
    solo = _node("no-labels", {L.TPU_SLICE_LABEL: "nvl-000"})
    return nodes + [twin, solo, _node("late")]


CASES = {
    "slices": lambda: _shaped("slices"),
    "solo": lambda: _shaped("solo"),
    "bare": _bare,
    "doctor": _doctors,
    "evidence": _evidence,
    "taints": _taints,
    "repeated": _repeated,
    "empty": list,
    "all": lambda: (_shaped("slices", 3) + _bare() + _doctors()
                    + _evidence() + _taints() + _shaped("solo", 5)),
}


def _looped(nodes):
    enc = tplan.FleetEncoding()
    for node in nodes:
        enc.apply(node)
    return enc


def _block(enc):
    """Everything a tick or a later update reads of the block."""
    snap = enc.snapshot()
    return {
        "columns": {k: v.tolist() for k, v in snap.columns.items()},
        "bucket": snap.bucket,
        "names": snap.names,
        "slice_index": snap.slice_index,
        "doctor_details": snap.doctor_details,
        "row": enc._row,
        "slice_key_of": enc._slice_key_of,
        "slice_refs": enc._slice_refs,
        "slice_rows": enc._slice_rows,
        "next_slice": enc._next_slice,
    }


def _counts(enc):
    return {k: enc.stats[k] for k in ("rows_written", "ts_fast",
                                      "ts_fallback")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_pass_equals_the_loop(case):
    nodes = CASES[case]()
    got = tplan.FleetEncoding._throwaway(nodes)
    want = _looped(nodes)
    assert _block(got) == _block(want)
    assert _counts(got) == _counts(want)
    assert got._dirty_all
    if case == "repeated":
        assert got._fp == want._fp
        assert got.stats["grows"] == want.stats["grows"]
    else:
        assert got._fp == {}
        assert got.stats["grows"] == (1 if nodes else 0)
        assert got.stats["rows_written"] == len(nodes)


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_fleet_equals_the_loop(case):
    nodes = CASES[case]()
    want = _looped(nodes).snapshot()
    n = want.n_nodes
    got = tplan.encode_fleet(nodes)
    for g, key in zip(got[:3], ("desired", "observed", "slice_ids")):
        assert g.dtype == np.int32
        assert g.tolist() == want.columns[key][:n].tolist()
    assert got[3:] == (want.names, want.slice_index)


@pytest.mark.parametrize("where", [0, 5, -1])
@pytest.mark.parametrize("nameless", [
    {"metadata": {"labels": {}}}, {"metadata": {"name": ""}},
    {"metadata": None}, {}])
def test_a_nameless_node_raises_key_error(where, nameless):
    nodes = _shaped("solo")[:10]
    nodes.insert(where if where >= 0 else len(nodes), nameless)
    with pytest.raises(KeyError):
        _looped(nodes)
    with pytest.raises(KeyError):
        tplan.FleetEncoding._throwaway(nodes)
    with pytest.raises(KeyError):
        tplan.FleetEncoding._throwaway(_repeated() + nodes)


def _relisted(nodes):
    """The next list: every fifth node gone, every third flipped, every
    seventh moved to another slice (solo nodes into one), three new."""
    out = []
    for i, node in enumerate(nodes):
        if i % 5 == 4:
            continue
        node = json.loads(json.dumps(node))
        labels = node["metadata"].setdefault("labels", {}) or {}
        node["metadata"]["labels"] = labels
        if i % 3 == 0:
            labels[L.CC_MODE_STATE_LABEL] = "off"
        if i % 7 == 0:
            labels[L.TPU_SLICE_LABEL] = f"moved-{i % 2}"
        out.append(node)
    return out + [_node(f"new-{i}", {L.CC_MODE_LABEL: "on"})
                  for i in range(3)]


UPDATES = {
    "apply-same": lambda enc, nodes: [enc.apply(n) for n in nodes[::4]],
    "apply-changed": lambda enc, nodes: [
        enc.apply(n) for n in _relisted(nodes)[::3]],
    "apply-new": lambda enc, nodes: enc.apply(_node(
        "brand-new", {L.TPU_SLICE_LABEL: "nvl-000"})),
    "remove": lambda enc, nodes: [enc.remove(n["metadata"]["name"])
                                  for n in nodes[1::3]],
    "deleted-event": lambda enc, nodes: enc.apply_event("DELETED",
                                                        nodes[0]),
    "sync": lambda enc, nodes: enc.sync(_relisted(nodes)),
    "sync-same": lambda enc, nodes: enc.sync(nodes),
    "sync-empty": lambda enc, nodes: enc.sync([]),
}


@pytest.mark.parametrize("update", sorted(UPDATES))
@pytest.mark.parametrize("case", ["slices", "solo", "all"])
def test_a_later_update_sees_the_same_block(case, update):
    nodes = CASES[case]()
    got = tplan.FleetEncoding._throwaway(nodes)
    want = _looped(nodes)
    UPDATES[update](got, nodes)
    UPDATES[update](want, nodes)
    assert _block(got) == _block(want)
    # and the tick reads the same from it after one more round
    for enc in (got, want):
        enc.sync(_relisted(nodes))
    assert _block(got) == _block(want)


def test_counters_say_which_way_each_evidence_timestamp_went():
    enc = tplan.FleetEncoding._throwaway(_evidence())
    ways = [way for _, way in EVIDENCE]
    assert enc.stats["ts_fast"] == ways.count("fast")
    assert enc.stats["ts_fallback"] == ways.count("fallback")
    want = [jplan._encode_evidence_ts(raw) for raw, _ in EVIDENCE]
    assert enc.snapshot().columns["ev_ts"][:len(want)].tolist() == want


@pytest.mark.parametrize("shape", ["slices", "solo"])
def test_analyze_fleet_reports_what_the_loop_reports(shape):
    nodes = _shaped(shape)
    want = tplan.analyze_encoding(_looped(nodes), device="cpu")
    assert tplan.analyze_fleet(nodes, device="cpu") == want


# ------------------------------------------------------------ _parse_ts

#: each string with the way ``_parse_ts`` must read it
STAMPS = [
    ("2024-02-29T12:00:00Z", "fast"),  # leap year
    ("2000-02-29T00:00:00Z", "fast"),
    ("2023-02-29T12:00:00Z", "fallback"),  # not a leap year
    ("1900-02-29T00:00:00Z", "fallback"),
    ("2024-02-30T00:00:00Z", "fallback"),
    ("2024-04-31T00:00:00Z", "fallback"),
    ("2024-01-01T24:00:00Z", "fallback"),
    ("2024-12-31T23:59:60Z", "fallback"),  # strptime takes a leap second
    ("2024-12-31T23:59:61Z", "fallback"),
    ("2024-12-31T23:60:00Z", "fallback"),
    ("2024-13-01T00:00:00Z", "fallback"),
    ("2024-00-10T00:00:00Z", "fallback"),
    ("0000-01-01T00:00:00Z", "fallback"),
    ("2024-1-1T0:0:0Z", "fallback"),
    ("2024-01-01T0:00:00Z", "fallback"),
    ("２０２４-０１-０１T"
     "００:００:００Z", "fallback"),  # full-width
    ("٢٠٢٤-٠١-٠١T"
     "٠٠:٠٠:٠٠Z", "fallback"),  # Arabic-Indic
    ("2024-01-01T00:00:00Z ", "fallback"),
    (" 2024-01-01T00:00:00Z", "fallback"),
    ("2024-01-01T00:00:00Z\n", "fallback"),
    ("2024-01-01T00:00:00z", "fallback"),
    ("2024-01-01t00:00:00Z", "fallback"),
    ("2024-01-01T00:00:00+00:00", "fallback"),
    ("2024-01-01T00:00:00.5Z", "fallback"),
    ("2024-01-01 00:00:00Z", "fallback"),
    ("20240101T000000Z", "fallback"),
    ("", "fallback"),
    ("1970-01-01T00:00:00Z", "fast"),
    ("1969-12-31T23:59:59Z", "fast"),
    ("2038-01-19T03:14:07Z", "fast"),
    ("9999-12-31T23:59:59Z", "fast"),
    ("0001-01-01T00:00:00Z", "fast"),
    (None, None),
    (1704067200, None),
    (1.5, None),
    (b"2024-01-01T00:00:00Z", None),
    (["2024-01-01T00:00:00Z"], None),
    ({"timestamp": "2024-01-01T00:00:00Z"}, None),
]


def _parsed(stamps):
    stats = {"ts_fast": 0, "ts_fallback": 0}
    return [tplan._parse_ts(s, stats) for s in stamps], stats


@pytest.mark.parametrize("stamp,way", STAMPS, ids=[repr(s) for s, _ in STAMPS])
def test_parse_ts_reads_what_strptime_reads(stamp, way):
    (got,), stats = _parsed([stamp])
    assert type(got) is int
    assert got == jplan._parse_ts(stamp)
    assert stats == {"ts_fast": int(way == "fast"),
                     "ts_fallback": int(way == "fallback")}


@pytest.mark.parametrize("seed", range(4))
def test_parse_ts_on_random_epochs(seed):
    epochs = np.random.default_rng(seed).integers(0, 2**31, 5000).tolist()
    stamps = [_stamp(e) for e in epochs]
    got, stats = _parsed(stamps)
    assert got == epochs
    assert got == [jplan._parse_ts(s) for s in stamps]
    assert stats == {"ts_fast": len(stamps), "ts_fallback": 0}
