"""The plain reference's fleet report, and the comparison that decides
``correct``.

A report the program produced is judged node by node. Which version of a
node it may show is bounded by two resourceVersions of the stand-in: the
lower one (``lo``) is one the program's inputs had certainly reached
(see the drivers for each), the upper one (``hi``) the stand-in's when
the call returned. A node that no write touched between them has one
version, and the report must say exactly what that version says. A node
written in between may show any of its versions in the bounds; the
report must say what one of them says, and the aggregates (mode counts,
slice verdicts, doctor details) must follow from the versions chosen.
The evidence-staleness flag is judged at any whole second in the span
the program read its clock in. Everything is plain NumPy in the
precision the configuration states (int32); the control passes a lower
one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.reference.history import History
from portbench.reference.model import (
    AUDIT_BUCKETS, AUDIT_CODE, DOCTOR_FAILING, FAILED, MODE_NAMES,
    UNREPORTED,
)

#: audit buckets the configuration's fleet can never fill (one pool key,
#: no identity, no attestation): each entry in them is a mismatch
EMPTY_AUDIT = ("unverifiable", "stale_key", "identity_missing",
               "identity_mismatch", "attestation_missing",
               "attestation_mismatch", "attestation_unverifiable",
               "attestation_outage")


def narrow(x, dtype) -> np.ndarray:
    """``x`` held in ``dtype``, values outside its range saturated."""
    info = np.iinfo(dtype)
    return np.clip(np.asarray(x, np.int64), info.min, info.max).astype(dtype)


def stale_mask(ev_ts: np.ndarray, now_s: int, stale_s: int,
               dtype=np.int32) -> np.ndarray:
    """Evidence older than ``stale_s`` at ``now_s``, computed in
    ``dtype`` (-1 marks a node without evidence)."""
    e = narrow(ev_ts, dtype)
    now = narrow(now_s, dtype)
    return (e >= 0) & ((now - e) > narrow(stale_s, dtype))


def predict(A: Dict[str, np.ndarray], vids: np.ndarray, clock: Tuple[int, int],
            stale_s: int, dtype=np.int32) -> Dict[str, np.ndarray]:
    """Each node list's membership for the versions ``vids``; staleness
    at the two ends of ``clock``."""
    d = A["desired"][vids]
    o = A["observed"][vids]
    doc = A["doctor"][vids]
    ev = A["ev_ts"][vids]
    return {
        "needs_flip": (d != o) & (d != 0),
        "failed": o == FAILED,
        "flipping": A["taint"][vids],
        "doctor_failing": doc == DOCTOR_FAILING,
        "doctor_unreported": doc == UNREPORTED,
        "stale_lo": stale_mask(ev, clock[0], stale_s, dtype),
        "stale_hi": stale_mask(ev, clock[1], stale_s, dtype),
    }


LISTS = ("needs_flip", "failed", "flipping", "doctor_failing",
         "doctor_unreported")


class Tally:
    """Mismatches found, with the first few described."""

    def __init__(self) -> None:
        self.count = 0
        self.notes: List[str] = []

    def add(self, k: int, what: str) -> None:
        if k:
            self.count += k
            if len(self.notes) < 8:
                self.notes.append(f"{what} ({k})")


def _mask(names, index: Dict[str, int], n: int, what: str,
          t: Tally) -> np.ndarray:
    m = np.zeros(n, bool)
    unknown = dup = 0
    for name in names:
        i = index.get(name)
        if i is None:
            unknown += 1
        elif m[i]:
            dup += 1
        else:
            m[i] = True
    t.add(unknown, f"{what}: names not in the fleet")
    t.add(dup, f"{what}: names listed twice")
    return m


def report_masks(report: dict, index: Dict[str, int], n: int,
                 t: Tally) -> Dict[str, np.ndarray]:
    doctor = report.get("doctor") or {}
    return {
        "needs_flip": _mask(report["needs_flip"], index, n, "needs_flip", t),
        "failed": _mask(report["failed"], index, n, "failed", t),
        "flipping": _mask(report["flipping"], index, n, "flipping", t),
        "stale": _mask(report["stale_evidence"], index, n,
                       "stale_evidence", t),
        "doctor_failing": _mask([d["node"] for d in doctor["failing"]],
                                index, n, "doctor.failing", t),
        "doctor_unreported": _mask(doctor["unreported"], index, n,
                                   "doctor.unreported", t),
    }


def _agree(R: Dict[str, np.ndarray], P: Dict[str, np.ndarray],
           sel=slice(None)) -> np.ndarray:
    ok = (R["stale"][sel] == P["stale_lo"]) | (R["stale"][sel] == P["stale_hi"])
    for key in LISTS:
        ok &= R[key][sel] == P[key]
    return ok


def check_plan(report: dict, hist: History, lo: int, hi: int,
               clock: Tuple[int, int], stale_s: int, t: Tally,
               dtype=np.int32, floor: Optional[np.ndarray] = None
               ) -> np.ndarray:
    """Judge a fleet report (the planner's lists, mode counts, slice
    verdicts and doctor details). ``floor``, when given, is each node's
    earliest version an earlier report of the same program can have
    shown: a report may not show a node older than that. Returns each
    node's earliest version that fits this report, the next report's
    floor."""
    n = hist.n
    A = hist.arrays()
    at_lo = hist.vids_at(lo)
    if floor is not None:
        # version ids grow with commit order, node by node
        at_lo = np.maximum(at_lo, floor)
    cands = hist.candidates(lo, hi, at_lo)
    R = report_masks(report, hist.index, n, t)
    t.add(int(report.get("nodes", -1) != n), f"nodes {report.get('nodes')} != {n}")
    ok = _agree(R, predict(A, at_lo, clock, stale_s, dtype))
    amb = np.zeros(n, bool)
    amb[list(cands)] = True
    t.add(int((~ok & ~amb).sum()), "node lists disagree with the node")
    latest = at_lo.copy()
    earliest = at_lo.copy()
    consistent: Dict[int, List[int]] = {}
    for node, vids in cands.items():
        v = np.asarray(vids)
        good = _agree(R, predict(A, v, clock, stale_s, dtype),
                      np.full(len(v), node))
        fits = [int(x) for x, g in zip(v, good) if g]
        if not fits:
            t.add(1, "node lists match none of the node's versions")
            continue
        consistent[node] = fits
        latest[node] = fits[-1]
        earliest[node] = fits[0]
    # mode counts: each chosen node counts once; a node whose fitting
    # versions observe different modes may count under any of them
    obs = A["observed"]
    fixed = np.bincount(obs[latest], minlength=len(MODE_NAMES))
    spread_lo = fixed.copy()
    spread_hi = fixed.copy()
    for node, fits in consistent.items():
        modes = {int(obs[v]) for v in fits}
        if len(modes) > 1:
            spread_lo[obs[latest[node]]] -= 1
            for m in modes:
                spread_hi[m] += 1 if m != obs[latest[node]] else 0
    counts = report.get("mode_counts") or {}
    t.add(len(set(counts) - set(MODE_NAMES)), "mode_counts: unknown modes")
    for m, name in enumerate(MODE_NAMES):
        c = int(counts.get(name, 0))
        t.add(int(not spread_lo[m] <= c <= spread_hi[m]),
              f"mode_counts[{name}] {c} not in [{spread_lo[m]}, {spread_hi[m]}]")
    _check_slices(report, hist, A, latest, earliest, t)
    doctor = report["doctor"]
    t.add(int(doctor["reported"] != n - len(doctor["unreported"])),
          "doctor.reported")
    for entry in doctor["failing"]:
        i = hist.index.get(entry["node"])
        if i is None:
            continue
        fits = consistent.get(i, [int(latest[i])])
        if not any(list(hist.versions[v].fail) == list(entry["fail"])
                   for v in fits):
            t.add(1, "doctor.failing: fail list")
        if entry.get("at") not in hist.doctor_ats(i, hi):
            t.add(1, "doctor.failing: at")
    return earliest


def slice_verdicts(A: Dict[str, np.ndarray], vids: np.ndarray, n_slices: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per slice: has members, coherent, half-flipped."""
    sl = A["slice"][vids]
    real = sl >= 0
    seg = sl[real]
    d = A["desired"][vids][real]
    o = A["observed"][vids][real]
    at = ((o == d) & (d != 0)).astype(np.int64)
    big, small = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    red = {}
    for key, x, fill, fn in (("dmn", d, big, np.minimum),
                             ("dmx", d, small, np.maximum),
                             ("omn", o, big, np.minimum),
                             ("omx", o, small, np.maximum),
                             ("amn", at, 1, np.minimum),
                             ("amx", at, 0, np.maximum)):
        red[key] = np.full(n_slices, fill, np.int64)
        fn.at(red[key], seg, x)
    live = np.bincount(seg, minlength=n_slices) > 0
    agree = red["dmn"] == red["dmx"]
    coherent = agree & (red["omn"] == red["omx"])
    half = agree & (red["amn"] == 0) & (red["amx"] == 1)
    return live, coherent, half


def _check_slices(report: dict, hist: History, A, latest, earliest,
                  t: Tally) -> None:
    keys = hist.slice_keys
    sid = {k: i for i, k in enumerate(keys)}
    inc = np.zeros(len(keys), bool)
    half = np.zeros(len(keys), bool)
    for name in report["incoherent_slices"]:
        if name not in sid:
            t.add(1, "incoherent_slices: unknown slice")
        else:
            inc[sid[name]] = True
    for name in report["half_flipped_slices"]:
        if name not in sid:
            t.add(1, "half_flipped_slices: unknown slice")
        else:
            half[sid[name]] = True
    live_a, coh_a, half_a = slice_verdicts(A, latest, len(keys))
    live_b, coh_b, half_b = slice_verdicts(A, earliest, len(keys))
    fit_a = (inc == (live_a & ~coh_a)) & (half == (live_a & half_a))
    fit_b = (inc == (live_b & ~coh_b)) & (half == (live_b & half_b))
    t.add(int((~fit_a & ~fit_b).sum()), "slice verdicts")


def check_audit(audit: dict, prev_raw: Optional[set], hist: History,
                lo: int, hi: int, t: Tally) -> set:
    """Judge the evidence audit of one scan; returns its raw
    label/device mismatch set (both halves of the program's debounce)."""
    n = hist.n
    A = hist.arrays()
    at_lo = hist.vids_at(lo)
    cands = hist.candidates(lo, hi, at_lo)
    raw = set(audit["label_device_mismatch"]) | set(
        audit["label_device_mismatch_transient"])
    got = np.zeros(n, np.int64)
    for bucket in AUDIT_BUCKETS:
        names = raw if bucket == "label_device_mismatch" else audit[bucket]
        m = _mask(names, hist.index, n, f"evidence_audit.{bucket}", t)
        t.add(int((m & (got != 0)).sum()), "node in two audit buckets")
        got[m] = AUDIT_CODE[bucket]
    want = A["audit"][at_lo]
    bad = got != want
    for node, vids in cands.items():
        bad[node] = not any(A["audit"][v] == got[node] for v in vids)
    t.add(int(bad.sum()), "evidence audit disagrees with the node")
    for bucket in EMPTY_AUDIT:
        t.add(len(audit.get(bucket) or []), f"evidence_audit.{bucket}")
    if prev_raw is not None:
        t.add(len(set(audit["label_device_mismatch"]) ^ (raw & prev_raw)),
              "label_device_mismatch debounce")
    return raw


def expected_groups(hist: History, vids: np.ndarray, mode: str
                    ) -> Dict[str, Tuple[List[str], str, str]]:
    """The rollout's plan: one group per slice, a group per unsliced
    node; a group is skipped when every member is at ``mode`` with
    evidence that does not contradict it, else planned."""
    members: Dict[str, List[int]] = {}
    for i in range(hist.n):
        v = hist.versions[int(vids[i])]
        g = f"slice/{v.slice}" if v.slice else f"node/{hist.names[i]}"
        members.setdefault(g, []).append(i)
    out = {}
    for g, idx in members.items():
        vs = [hist.versions[int(vids[i])] for i in idx]
        converged = all(v.desired_label == mode and v.state == mode
                        for v in vs)
        suspect = any(
            v.ev_present and (v.ev_verdict != "ok" or (
                v.ev_attested is not None and v.ev_attested != mode))
            for v in vs)
        skipped = converged and not suspect
        out[g] = (sorted(hist.names[i] for i in idx),
                  "skipped" if skipped else "planned",
                  f"already at {mode}" if skipped else "")
    return out


def check_groups(groups: List[dict], hist: History, lo: int, hi: int,
                 mode: str, t: Tally) -> None:
    a = expected_groups(hist, hist.vids_at(lo), mode)
    b = expected_groups(hist, hist.vids_at(hi), mode)
    names = [g["name"] for g in groups]
    t.add(int(names != sorted(a)), "groups: names or order")
    for g in groups:
        want = [w for w in (a.get(g["name"]), b.get(g["name"])) if w]
        got = (list(g["nodes"]), g["outcome"], g.get("detail", ""))
        t.add(int(not any(got == (w[0], w[1], w[2]) for w in want)),
              "groups: members or outcome")


def control_report(hist: History, vids: np.ndarray, now_s: int,
                   stale_s: int, dtype) -> dict:
    """The reference's own report for ``vids`` at ``now_s``, computed in
    ``dtype``: the control put in the program's place."""
    A = hist.arrays()
    P = predict(A, vids, (now_s, now_s), stale_s, dtype)
    names = np.array(hist.names)
    live, coherent, half = slice_verdicts(A, vids, len(hist.slice_keys))
    keys = np.array(hist.slice_keys)
    counts = np.bincount(A["observed"][vids], minlength=len(MODE_NAMES))
    return {
        "nodes": hist.n,
        "needs_flip": names[P["needs_flip"]].tolist(),
        "failed": names[P["failed"]].tolist(),
        "flipping": names[P["flipping"]].tolist(),
        "stale_evidence": names[P["stale_hi"]].tolist(),
        "mode_counts": {MODE_NAMES[m]: int(c) for m, c in enumerate(counts)
                        if c},
        "incoherent_slices": keys[live & ~coherent].tolist(),
        "half_flipped_slices": keys[live & half].tolist(),
        "doctor": {
            "reported": int((~P["doctor_unreported"]).sum()),
            "unreported": names[P["doctor_unreported"]].tolist(),
            "failing": [{"node": hist.names[i],
                         "fail": list(hist.versions[int(vids[i])].fail),
                         "at": hist.versions[int(vids[i])].at}
                        for i in np.nonzero(P["doctor_failing"])[0]],
        },
    }
