"""Fleet planner on PyTorch and CUDA — the port of ``tpu_cc_manager.plan``.

The reference is control-plane-only and has no compute (SURVEY.md §0).
This module serves the *operator side*: a fleet controller that ingests
the labels of an entire TPU fleet and computes, in one pass over the
fleet's int32 columns on the GPU instead of a Python loop over nodes,
which nodes diverge, which slices are incoherent or half-flipped, the
per-pool convergence, skew and rollout-eligibility counts, the doctor
and evidence buckets, and the fleet's mode histograms.

The host side — the feature block, snapshots, the incremental session's
bookkeeping, the reports and the CLI — is the JAX package's, copied.
The device side is rewritten:

- **One kernel** (:func:`fleet_tick`): the hand-written CUDA kernel K1
  (``kernels/fleet_tick.py``, ``csrc/fleet_tick.cu``) answers the fleet
  AND policy questions per tick. ``fleet_plan``, the legacy subset, has
  its own one-CTA kernel (K3, ``csrc/fleet_plan.cu``).
- **Resident block**: :class:`TickSession` keeps the eight columns as
  ``int32[8, nb]`` tensors on the device and writes changed rows into
  them in place with K2 (``kernels/delta_scatter.py``), one launch per
  card.
- **Mesh** (:func:`_planner_mesh`): the rows split into S shards, the
  counterpart of the reference's ``shard_map`` mesh. One process drives
  every shard: each runs K1's partial form, and the hand-written kernel
  K4 (``kernels/mesh_combine.py``) combines the partials on shard 0's
  card where the reference's ``psum``/``pmin``/``pmax`` do. S = 1
  (``TPU_CC_PLANNER_MESH`` unset) is the unsharded K1.
- **Device** (:func:`_planner_device`): ``cuda:0`` unless the caller asks
  for the CPU (``device=`` on the entry points, or ``TPU_CC_TORCH_DEVICE``),
  where the kernels' plain PyTorch versions run. With no CUDA device and
  no such request the planner raises; it never falls back by itself.
- **Shape buckets**: node counts pad to power-of-two buckets
  (:func:`bucket_nodes`); each (node bucket, pool bucket) geometry builds
  its dispatch callable once and reuses it.
- **Kernel build**: the CUDA library compiles at first use from the
  package's sources, keyed by their hash (``kernels/_build.py``);
  :func:`warmup` builds it and launches every geometry of the bucket
  ladder once at controller start.
"""

from __future__ import annotations

import calendar
import json
import logging
import os
import re
import sys
import threading
import time
import zlib
from datetime import datetime
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.kernels import _build
from tpu_cc_manager_torch.kernels.delta_scatter import delta_scatter_shards
from tpu_cc_manager_torch.kernels.fleet_tick import (  # noqa: F401
    check_pool_slots,
    counts_len,
    fleet_plan,  # K3, exported here as the reference's plan module does
    fleet_tick_block,
    fleet_tick_partial,
)
from tpu_cc_manager_torch.kernels.mesh_combine import mesh_combine
from tpu_cc_manager_torch.trace import get_tracer

#: Mode → code, derived from the canonical vocabulary in modes.py so the
#: planner cannot drift when modes are added. UNKNOWN covers absent or
#: invalid label values; FAILED is the observed-state failure marker.
from tpu_cc_manager_torch.modes import STATE_FAILED, VALID_MODES

#: the row fingerprint and the watch wake filter must agree on what the
#: "stable" part of a doctor verdict is — one shared reduction
from tpu_cc_manager_torch.watch import stable_doctor_digest

log = logging.getLogger("tpu-cc-manager-torch.plan")

MODE_CODES: Dict[str, int] = {"unknown": 0}
for _m in VALID_MODES:
    MODE_CODES[_m] = len(MODE_CODES)
MODE_CODES[STATE_FAILED] = len(MODE_CODES)
CODE_MODES = {v: k for k, v in MODE_CODES.items()}
N_MODES = len(MODE_CODES)

#: the spans a rollout preflight opens on the process tracer, root
#: first: ``Rollout.run`` opens preflight, discover and groups (groups
#: re-seated under the closed preflight root), :func:`analyze_fleet`
#: opens analyze_fleet and encode, :func:`analyze_encoding` snapshot
#: (the legacy path's), tick and report. None is opened per node or
#: per group.
PLANNER_SPANS = ("preflight", "discover", "analyze_fleet", "encode",
                 "snapshot", "tick", "report", "groups")

#: doctor verdict codes (FleetEncoding feature column)
DOCTOR_UNREPORTED = 0
DOCTOR_OK = 1
DOCTOR_FAILING = 2

#: smallest node bucket: fleets from 1 to 64 nodes share one geometry
BUCKET_MIN_NODES = 64
#: smallest pool-slot bucket: up to 7 pools + the padding slot
BUCKET_MIN_POOLS = 8
#: smallest delta-scatter block (incremental tick): delta counts from
#: 1 to 64 rows share one scatter geometry
BUCKET_MIN_DELTAS = 64

#: evidence older than this (seconds) is reported stale; the planner
#: flags, the evidence audit judges (fleet.py)
EVIDENCE_STALE_S_DEFAULT = 3600.0


def bucket_nodes(n: int) -> int:
    """Power-of-two node bucket holding ``n`` rows AND ``n + 1`` slice
    slots (every node may be a solo slice; +1 reserves the padding
    slot). Geometry drift inside a bucket never builds anew."""
    need = max(n + 1, BUCKET_MIN_NODES)
    return 1 << (need - 1).bit_length()


def bucket_pools(p: int) -> int:
    """Power-of-two pool-slot bucket holding ``p`` pools + padding."""
    need = max(p + 1, BUCKET_MIN_POOLS)
    return 1 << (need - 1).bit_length()


def bucket_deltas(k: int) -> int:
    """Power-of-two delta-block bucket for the incremental tick's
    scatter operands: distinct delta counts inside a bucket share one
    scatter geometry — the same ladder as :func:`bucket_nodes`."""
    need = max(k, BUCKET_MIN_DELTAS)
    return 1 << (need - 1).bit_length()


def encode_mode(value: Optional[str]) -> int:
    return MODE_CODES.get(value or "unknown", MODE_CODES["unknown"])


#: the timestamp's exact shape: ASCII digits, the hour, minute and
#: second in range. Only such strings reach ``datetime.fromisoformat``,
#: so its reading never rests on where it and ``time.strptime`` differ
#: (an hour 24, a second 60)
_TS_SHAPE = re.compile(
    r"[0-9]{4}-[0-9]{2}-[0-9]{2}T(?:[01][0-9]|2[0-3]):[0-5][0-9]:[0-5][0-9]Z")


def _parse_ts(stamp: Any, stats: Dict[str, int]) -> int:
    """'%Y-%m-%dT%H:%M:%SZ' → epoch seconds, -1 when absent/unparseable.

    The exact shape is read by ``datetime.fromisoformat``; any other
    string (second 60, single-digit fields, other digits, a date that
    does not exist) by ``time.strptime``, as before. ``stats`` counts the
    strings each way took: ``ts_fast`` and ``ts_fallback``.

    int32-safe until 2038; the kernel only ever subtracts it from now."""
    if not isinstance(stamp, str):
        return -1
    if _TS_SHAPE.fullmatch(stamp) is not None:
        try:
            ts = int(datetime.fromisoformat(stamp).timestamp())
        except ValueError:
            pass
        else:
            stats["ts_fast"] += 1
            return ts
    stats["ts_fallback"] += 1
    try:
        return int(calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ")))
    except ValueError:
        return -1


def _encode_doctor(raw: Optional[str]) -> Tuple[int, Optional[dict]]:
    """Doctor annotation → (code, details-for-failing). Malformed counts
    as failing — a node that can't publish a parseable verdict deserves
    a look, not silence."""
    if not raw:
        return DOCTOR_UNREPORTED, None
    try:
        verdict = json.loads(raw)
        if isinstance(verdict, dict) and verdict.get("ok"):
            return DOCTOR_OK, None
        fail = verdict.get("fail", []) if isinstance(verdict, dict) else []
        at = verdict.get("at") if isinstance(verdict, dict) else None
        return DOCTOR_FAILING, {"fail": fail, "at": at}
    except ValueError:
        return DOCTOR_FAILING, {"fail": ["unparseable"], "at": None}


def _encode_evidence_ts(raw: Optional[str], stats: Dict[str, int]) -> int:
    """Evidence annotation → document timestamp (epoch s), -1 if none.
    The whole document is parsed: a malformed one reads -1."""
    if not raw:
        return -1
    try:
        doc = json.loads(raw)
    except ValueError:
        return -1
    if not isinstance(doc, dict):
        return -1
    return _parse_ts(doc.get("timestamp"), stats)


def _has_flip_taint(node: dict) -> bool:
    for taint in (node.get("spec") or {}).get("taints") or []:
        if isinstance(taint, dict) and taint.get("key") == L.FLIP_TAINT_KEY:
            return True
    return False


class FleetEncoding:
    """The planner's per-node feature block: columnar int32 arrays kept
    *incrementally* up to date from watch deltas (:meth:`apply_event`)
    and fingerprint-diffed list syncs (:meth:`sync`) — the encode cost
    per scan is proportional to what changed, not to fleet size.

    Columns (row i = node i): desired, observed, slice id (dense),
    flip-taint flag, doctor verdict code, evidence timestamp. Slice ids
    are refcounted and compacted when dead slots outnumber live ones.
    Thread-safe: the watch thread applies deltas while the scan thread
    snapshots.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._names: List[str] = []
        self._row: Dict[str, int] = {}
        self._fp: Dict[str, tuple] = {}
        self._cap = 0
        self._desired = np.zeros(0, np.int32)
        self._observed = np.zeros(0, np.int32)
        self._slice = np.zeros(0, np.int32)
        self._taint = np.zeros(0, np.int32)
        self._doctor = np.zeros(0, np.int32)
        self._ev_ts = np.zeros(0, np.int32)
        self._slice_index: Dict[str, int] = {}
        #: reverse of _slice_index — release must be O(1), not a scan
        self._slice_key_of: Dict[int, str] = {}
        self._slice_refs: Dict[int, int] = {}
        self._next_slice = 0
        self._doctor_details: Dict[str, dict] = {}
        #: incremental-tick dirty state (docs/planner.md "incremental
        #: tick contract"): positional row indices whose contents
        #: changed since the last begin_tick drain, slice slot ids
        #: whose membership or member values changed, and the
        #: everything-moved latch (growth, slice-id compaction — the
        #: compactor rewrites the whole slice column, so no per-row
        #: delta can describe it)
        self._dirty_rows: set = set()
        self._dirty_slices: set = set()
        self._dirty_all = True
        #: slice slot id → member row indices, kept in lock-step with
        #: _slice/_slice_refs so an incremental tick can re-evaluate
        #: exactly the dirty slices' member rows
        self._slice_rows: Dict[int, set] = {}
        #: apply_event drops malformed watch events instead of throwing
        #: in a watch thread; this makes the drops observable
        #: (fleet.FleetMetrics mirrors it onto /metrics as
        #: tpu_cc_planner_events_dropped_total)
        self.events_dropped = 0
        #: encode accounting (the encode span's attrs): reallocating
        #: grows of the columns, rows written, evidence timestamps read
        #: by the exact-shape path and by ``time.strptime``
        self.stats: Dict[str, int] = {"grows": 0, "rows_written": 0,
                                      "ts_fast": 0, "ts_fallback": 0}

    # ------------------------------------------------------------ internals
    def _grow(self, need: int) -> None:
        if need <= self._cap:
            return
        cap = bucket_nodes(need)
        self.stats["grows"] += 1
        for attr, fill in (
            ("_desired", 0), ("_observed", 0), ("_slice", 0),
            ("_taint", 0), ("_doctor", 0), ("_ev_ts", -1),
        ):
            old = getattr(self, attr)
            arr = np.full(cap, fill, np.int32)
            arr[: len(old)] = old
            setattr(self, attr, arr)
        self._cap = cap
        # a capacity crossing is also a bucket crossing — the session
        # rebuilds on bucket change anyway, but latch it explicitly so
        # the invariant doesn't depend on that coincidence
        self._dirty_all = True

    def _slice_id(self, key: str) -> int:
        sid = self._slice_index.get(key)
        if sid is None:
            sid = self._next_slice
            self._next_slice += 1
            self._slice_index[key] = sid
            self._slice_key_of[sid] = key
        self._slice_refs[sid] = self._slice_refs.get(sid, 0) + 1
        return sid

    def _release_slice(self, sid: int, row: int) -> None:
        rows = self._slice_rows.get(sid)
        if rows is not None:
            rows.discard(row)
            if not rows:
                self._slice_rows.pop(sid, None)
        n = self._slice_refs.get(sid, 0) - 1
        if n <= 0:
            self._slice_refs.pop(sid, None)
            key = self._slice_key_of.pop(sid, None)
            if key is not None:
                self._slice_index.pop(key, None)
        else:
            self._slice_refs[sid] = n
        # compact when dead slots dominate: dense ids keep the slice
        # slot space (and thus the bucket) tracking LIVE slices, so a
        # churn of ephemeral solo slices cannot grow it without bound
        if (self._next_slice > 2 * len(self._slice_index)
                and self._next_slice - len(self._slice_index) > 16):
            self._compact_slices()

    def _compact_slices(self) -> None:
        """Renumber live slice ids dense from 0 (callers hold _lock)."""
        remap = {}
        for key in sorted(self._slice_index,
                          key=lambda k: self._slice_index[k]):
            remap[self._slice_index[key]] = len(remap)
        n_rows = len(self._names)
        if n_rows:
            lut = np.zeros(self._next_slice, np.int32)
            for old, new in remap.items():
                lut[old] = new
            self._slice[:n_rows] = lut[self._slice[:n_rows]]
        self._slice_index = {
            k: remap[v] for k, v in self._slice_index.items()
        }
        self._slice_key_of = {
            v: k for k, v in self._slice_index.items()
        }
        self._slice_refs = {
            remap[s]: c for s, c in self._slice_refs.items()
        }
        self._slice_rows = {
            remap[s]: r for s, r in self._slice_rows.items()
            if s in remap
        }
        self._next_slice = len(self._slice_index)
        self._dirty_all = True

    @staticmethod
    def _fingerprint(node: dict) -> tuple:
        """Comparable digest of exactly the row-relevant node state.
        The doctor element is the STABLE {ok, fail} reduction, not the
        raw annotation — a periodic republish that only moves the
        verdict timestamp must not re-encode the row (the same
        deliberate omission as watch.node_report_fingerprint's)."""
        meta = node.get("metadata") or {}
        labels = meta.get("labels") or {}
        ann = meta.get("annotations") or {}
        return (
            labels.get(L.CC_MODE_LABEL),
            labels.get(L.CC_MODE_STATE_LABEL),
            labels.get(L.TPU_SLICE_LABEL),
            _has_flip_taint(node),
            stable_doctor_digest(ann.get(L.DOCTOR_ANNOTATION)),
            ann.get(L.EVIDENCE_ANNOTATION),
        )

    def _write_row(self, i: int, name: str, fp: tuple,
                   doctor_raw: Optional[str],
                   slice_key: Optional[str]) -> None:
        """Encode one row. ``slice_key=None`` keeps the row's current
        slice id (caller determined the key didn't change — no
        release/re-acquire churn). ``doctor_raw`` is the full
        annotation: details (incl. the ``at`` timestamp) come from it,
        so a report's ``at`` reflects when the verdict CONTENT last
        changed — consistent with the fingerprint's stable reduction."""
        desired, observed, _slice_raw, tainted, _doctor_stable, ev_raw = fp
        self.stats["rows_written"] += 1
        self._desired[i] = encode_mode(desired)
        self._observed[i] = encode_mode(observed)
        if slice_key is not None:
            sid = self._slice_id(slice_key)
            self._slice[i] = sid
            self._slice_rows.setdefault(sid, set()).add(i)
        self._taint[i] = 1 if tainted else 0
        code, details = _encode_doctor(doctor_raw)
        self._doctor[i] = code
        if details is not None:
            self._doctor_details[name] = details
        else:
            self._doctor_details.pop(name, None)
        self._ev_ts[i] = _encode_evidence_ts(ev_raw, self.stats)

    # -------------------------------------------------------------- updates
    def apply(self, node: dict) -> bool:
        """Insert or update one node; returns True when anything
        report-relevant actually changed (fingerprint-diffed)."""
        meta = node.get("metadata") or {}
        name = meta.get("name")
        if not name:
            raise KeyError("node without metadata.name")
        fp = self._fingerprint(node)
        doctor_raw = (meta.get("annotations") or {}).get(
            L.DOCTOR_ANNOTATION)
        with self._lock:
            old_fp = self._fp.get(name)
            if old_fp == fp:
                return False
            i = self._row.get(name)
            slice_key = fp[2] if fp[2] else f"__solo__/{name}"
            if i is None:
                i = len(self._names)
                self._grow(i + 1)
                self._names.append(name)
                self._row[name] = i
            elif self._slice_key_of.get(int(self._slice[i])) == slice_key:
                # unchanged slice membership keeps its id — mode/taint/
                # doctor updates must not churn the slice slot space
                # (read from the row, which a block built by
                # _throwaway has without a fingerprint)
                slice_key = None  # type: ignore[assignment]
            else:
                old_sid = int(self._slice[i])
                self._dirty_slices.add(old_sid)
                self._release_slice(old_sid, i)
            self._fp[name] = fp
            self._write_row(i, name, fp, doctor_raw, slice_key)
            self._dirty_rows.add(i)
            self._dirty_slices.add(int(self._slice[i]))
            return True

    def remove(self, name: str) -> bool:
        """Drop a node (swap-with-last keeps the block dense)."""
        with self._lock:
            i = self._row.pop(name, None)
            if i is None:
                return False
            self._fp.pop(name, None)
            self._doctor_details.pop(name, None)
            sid = int(self._slice[i])
            self._dirty_slices.add(sid)
            self._release_slice(sid, i)
            last = len(self._names) - 1
            if i != last:
                moved = self._names[last]
                self._names[i] = moved
                self._row[moved] = i
                for arr in (self._desired, self._observed, self._slice,
                            self._taint, self._doctor, self._ev_ts):
                    arr[i] = arr[last]
                # the moved node changed position, not value: its slice
                # membership follows the row, the slot aggregates don't
                # move
                moved_rows = self._slice_rows.get(int(self._slice[i]))
                if moved_rows is not None:
                    moved_rows.discard(last)
                    moved_rows.add(i)
            self._names.pop()
            for arr, fill in ((self._desired, 0), (self._observed, 0),
                              (self._slice, 0), (self._taint, 0),
                              (self._doctor, 0), (self._ev_ts, -1)):
                arr[last] = fill
            self._dirty_rows.add(i)
            self._dirty_rows.add(last)
            return True

    def apply_event(self, etype: str, node: dict) -> None:
        """Node-watch delta feed (watch.run_node_watch ``on_event``):
        keeps the block fresh between list syncs. Total over hostile
        shapes — a malformed event is dropped, never thrown in a watch
        thread."""
        try:
            if etype == "DELETED":
                name = (node.get("metadata") or {}).get("name")
                if name:
                    self.remove(name)
            elif etype in ("ADDED", "MODIFIED"):
                self.apply(node)
        except Exception:
            with self._lock:
                self.events_dropped += 1
            log.debug("unappliable node event dropped", exc_info=True)

    def sync(self, nodes: List[dict]) -> int:
        """Reconcile against full list truth: apply every listed node
        (fingerprint skip makes unchanged ones O(compare)), drop the
        vanished. Returns how many rows actually changed."""
        changed = 0
        seen = set()
        for node in nodes:
            seen.add(node["metadata"]["name"])
            if self.apply(node):
                changed += 1
        with self._lock:
            gone = [n for n in self._names if n not in seen]
        for name in gone:
            if self.remove(name):
                changed += 1
        return changed

    @classmethod
    def _throwaway(cls, nodes: Sequence[dict]) -> "FleetEncoding":
        """A block built once from a full list and never diffed
        (:func:`analyze_fleet`, :func:`encode_fleet`), in one pass: the
        rows, slice ids and doctor details one :meth:`apply` per node
        leaves, with one lock, one grow, each annotation parsed once and
        no fingerprints. A later :meth:`apply` then rewrites every row
        it is given, which is only more work. A list that repeats a
        name (an API server's never does) takes :meth:`apply` per node,
        whose last write and slice release it keeps exactly."""
        enc = cls()
        stats = enc.stats
        names: List[str] = []
        rows: Dict[str, int] = {}
        cols: Tuple[List[int], ...] = ([], [], [], [], [], [])
        desired, observed, sids, taint, doctor, ev_ts = cols
        slice_index: Dict[str, int] = {}
        members: List[List[int]] = []
        details: Dict[str, dict] = {}
        for node in nodes:
            meta = node.get("metadata") or {}
            name = meta.get("name")
            if not name:
                raise KeyError("node without metadata.name")
            if name in rows:
                enc = cls()
                for each in nodes:
                    enc.apply(each)
                return enc
            i = rows[name] = len(names)
            names.append(name)
            labels = meta.get("labels") or {}
            ann = meta.get("annotations") or {}
            desired.append(encode_mode(labels.get(L.CC_MODE_LABEL)))
            observed.append(encode_mode(labels.get(L.CC_MODE_STATE_LABEL)))
            key = labels.get(L.TPU_SLICE_LABEL) or f"__solo__/{name}"
            sid = slice_index.get(key)
            if sid is None:
                sid = slice_index[key] = len(members)
                members.append([])
            members[sid].append(i)
            sids.append(sid)
            taint.append(1 if _has_flip_taint(node) else 0)
            code, det = _encode_doctor(ann.get(L.DOCTOR_ANNOTATION))
            doctor.append(code)
            if det is not None:
                details[name] = det
            ev_ts.append(_encode_evidence_ts(
                ann.get(L.EVIDENCE_ANNOTATION), stats))
        n = len(names)
        with enc._lock:
            enc._grow(n)
            for arr, col in zip((enc._desired, enc._observed, enc._slice,
                                 enc._taint, enc._doctor, enc._ev_ts), cols):
                arr[:n] = col
            enc._names = names
            enc._row = rows
            enc._slice_index = slice_index
            enc._slice_key_of = {sid: key for key, sid in slice_index.items()}
            enc._slice_refs = {sid: len(m) for sid, m in enumerate(members)}
            enc._slice_rows = {sid: set(m) for sid, m in enumerate(members)}
            enc._next_slice = len(members)
            enc._doctor_details = details
            stats["rows_written"] += n
        return enc

    # ------------------------------------------------------------ snapshots
    def __len__(self) -> int:
        with self._lock:
            return len(self._names)

    def snapshot(self) -> "FleetSnapshot":
        """Bucket-padded copies for one tick (padding rows: unknown
        modes, the reserved last slice slot, pool slot 0)."""
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> "FleetSnapshot":
        n = len(self._names)
        nb = bucket_nodes(n)
        # the bucket reserves n+1 slice slots (live slices ≤ rows,
        # plus the padding slot), but id ASSIGNMENT is monotonic and
        # the release-side compaction is amortized — a relabel churn
        # can push live ids past nb before its threshold trips. The
        # kernel scatters by slot id, so every live id must be < nb:
        # compact now if any isn't (cheap, and rare by construction)
        if self._next_slice >= nb:
            self._compact_slices()
        cols = {}
        for key, arr, pad in (
            ("desired", self._desired, 0),
            ("observed", self._observed, 0),
            ("slice_ids", self._slice, nb - 1),
            ("taint", self._taint, 0),
            ("doctor", self._doctor, 0),
            ("ev_ts", self._ev_ts, -1),
        ):
            out = np.full(nb, pad, np.int32)
            out[:n] = arr[:n]
            cols[key] = out
        valid = np.zeros(nb, np.int32)
        valid[:n] = 1
        cols["valid"] = valid
        cols["pool_ids"] = np.zeros(nb, np.int32)
        return FleetSnapshot(
            names=list(self._names),
            slice_index=dict(self._slice_index),
            doctor_details=dict(self._doctor_details),
            columns=cols,
            pool_names=[],
            bucket=nb,
        )

    def tracked_names(self) -> List[str]:
        with self._lock:
            return list(self._names)

    def row_map(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._row)

    def begin_tick(self, *, session_bucket: Optional[int],
                   with_meta: bool = False) -> "TickDelta":
        """Atomically drain the dirty state for one incremental tick.

        Returns a full rebuild package (``snapshot`` set — the session
        must re-upload the block: geometry changed vs
        ``session_bucket``, slice ids were compacted, or the delta
        covers a large fraction of the rows) or a delta package: dirty
        row indices with their current column values (snapshot padding
        semantics for rows that shrank away), plus the member rows of
        every dirty slice slot. Dirty state clears in the same critical
        section — deltas applied after this call land in the NEXT
        tick."""
        with self._lock:
            n = len(self._names)
            nb = bucket_nodes(n)
            if self._next_slice >= nb:
                self._compact_slices()
            k = len(self._dirty_rows)
            rebuild = (
                self._dirty_all or session_bucket != nb
                # a delta touching a quarter of the block is cheaper
                # re-uploaded whole than scattered row by row
                or (k > 256 and 4 * k >= n)
            )
            meta = (
                (list(self._names), dict(self._slice_index),
                 dict(self._doctor_details))
                if with_meta else None
            )
            if rebuild:
                self._dirty_rows.clear()
                self._dirty_slices.clear()
                self._dirty_all = False
                return TickDelta(n=n, bucket=nb,
                                 snapshot=self._snapshot_locked(),
                                 meta=meta)
            rows = np.fromiter(self._dirty_rows, np.int64, count=k)
            rows.sort()
            live = rows < n
            rl = rows[live]
            vals: Dict[str, np.ndarray] = {}
            for key, arr, pad in (
                ("desired", self._desired, 0),
                ("observed", self._observed, 0),
                ("slice_ids", self._slice, nb - 1),
                ("taint", self._taint, 0),
                ("doctor", self._doctor, 0),
                ("ev_ts", self._ev_ts, -1),
            ):
                v = np.full(k, pad, np.int32)
                v[live] = arr[rl]
                vals[key] = v
            vals["valid"] = live.astype(np.int32)
            slices = [
                (sid, np.fromiter(self._slice_rows.get(sid, ()),
                                  np.int64))
                for sid in sorted(self._dirty_slices) if sid < nb
            ]
            self._dirty_rows.clear()
            self._dirty_slices.clear()
            return TickDelta(n=n, bucket=nb, rows=rows, vals=vals,
                             slices=slices, meta=meta)


class FleetSnapshot:
    """Immutable bucket-padded view of one encoding instant.

    ``bucket`` is the node bucket the columns were padded to — THE
    sanctioned geometry for dispatching the tick on this snapshot.
    Kernel call sites must size ``_tick_fn`` from it, never from
    ``len(columns[...])``: the length happens to equal the bucket
    today, but geometry taken from data shape would build a dispatch
    callable (and launch a kernel over a slot width) per distinct
    length instead of per bucket."""

    def __init__(self, names: List[str], slice_index: Dict[str, int],
                 doctor_details: Dict[str, dict],
                 columns: Dict[str, np.ndarray],
                 pool_names: List[str],
                 bucket: Optional[int] = None) -> None:
        self.names = names
        self.slice_index = slice_index
        self.doctor_details = doctor_details
        self.columns = columns
        self.pool_names = pool_names
        self.bucket = (
            bucket if bucket is not None else bucket_nodes(len(names))
        )

    @property
    def n_nodes(self) -> int:
        return len(self.names)


class TickDelta:
    """One drained increment of FleetEncoding dirty state
    (:meth:`FleetEncoding.begin_tick`). Either ``snapshot`` is set
    (full rebuild — re-upload the block) or ``rows``/``vals``/
    ``slices`` are (scatter the delta into the resident block).

    ``rows`` are sorted positional row indices; ``vals`` maps the
    seven encoding columns to per-row values at those indices with
    snapshot padding semantics for rows ≥ ``n``; ``slices`` pairs each
    dirty slice slot id with its member row indices (empty for slots
    that died)."""

    __slots__ = ("n", "bucket", "snapshot", "rows", "vals", "slices",
                 "meta")

    def __init__(self, n: int, bucket: int,
                 snapshot: Optional["FleetSnapshot"] = None,
                 rows: Optional[np.ndarray] = None,
                 vals: Optional[Dict[str, np.ndarray]] = None,
                 slices: Optional[List[Tuple[int, np.ndarray]]] = None,
                 meta: Optional[tuple] = None) -> None:
        self.n = n
        self.bucket = bucket
        self.snapshot = snapshot
        self.rows = rows
        self.vals = vals
        self.slices = slices
        self.meta = meta


def encode_fleet(nodes: List[dict]) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray, List[str], Dict[str, int]]:
    """Legacy tuple encoding (desired, observed, slice_ids, names,
    slice_index) — unpadded. Kept for direct kernel users
    (__graft_entry__, tests); controllers use :class:`FleetEncoding`."""
    snap = FleetEncoding._throwaway(nodes).snapshot()
    n = snap.n_nodes
    return (
        snap.columns["desired"][:n].copy(),
        snap.columns["observed"][:n].copy(),
        snap.columns["slice_ids"][:n].copy(),
        snap.names,
        snap.slice_index,
    )


# ----------------------------------------------------------------- kernel


def fleet_tick(
    desired: torch.Tensor,
    observed: torch.Tensor,
    slice_ids: torch.Tensor,
    pool_ids: torch.Tensor,
    taint: torch.Tensor,
    doctor: torch.Tensor,
    ev_ts: torch.Tensor,
    valid: torch.Tensor,
    pool_target: torch.Tensor,
    now_s: Union[int, torch.Tensor],
    stale_after_s: Union[int, torch.Tensor],
    *,
    num_pools: int,
    num_slices: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """THE batched planner tick on tensors: one pass answering the fleet
    controller's audit questions AND the policy controller's per-pool
    convergence/skew/eligibility questions. Slice slots == the row count
    unless ``num_slices`` says otherwise (bucket_nodes reserves the
    padding slot); ``valid`` masks padding rows out of every aggregate
    except the slice slots' min/max, as in the reference. Launches K1 for
    CUDA tensors and runs its plain PyTorch version for CPU tensors; the
    outputs stay on the input device."""
    block = torch.stack([desired, observed, slice_ids, pool_ids, taint,
                         doctor, ev_ts, valid])
    # ccaudit: allow-unserialized-dispatch(the public tensor-level tick over the caller's own tensors, the counterpart of the reference's fleet_tick, a non-collective jit its dispatch contract does not cover: it touches no resident block, and the package's planner paths dispatch under the lock through _eval_fn instead)
    return fleet_tick_block(
        block, pool_target, int(now_s), int(stale_after_s),
        num_pools=num_pools,
        num_slots=block.shape[1] if num_slices is None else num_slices,
    )


#: geometry-cache constructions per kernel — the port's counterpart of
#: the reference's retrace counts: each (bucket, device) geometry builds
#: its dispatch callable once, so tests can pin "node-count drift within
#: a bucket builds exactly once" on this counter
TRACE_COUNTS: Dict[str, int] = {}


def _count_trace(name: str) -> None:
    TRACE_COUNTS[name] = TRACE_COUNTS.get(name, 0) + 1


def compile_stats() -> Dict[str, Any]:
    """The planner's build economics as plain data, in the reference's
    shape: geometry-cache constructions per kernel since process start,
    and kernel-library loads that found a finished build of these
    sources (``cache_hits``) or compiled one (``cache_misses``)."""
    return {
        "retraces": dict(TRACE_COUNTS),
        "cache_hits": int(_build.BUILD_STATS["hits"]),
        "cache_misses": int(_build.BUILD_STATS["misses"]),
    }


# ----------------------------------------------------------------- device

#: names the planner's device when a caller passes none: "cpu" runs the
#: kernels' plain PyTorch versions, "cuda:N" a given card
DEVICE_ENV = "TPU_CC_TORCH_DEVICE"


def _planner_device(device: Union[None, str, torch.device] = None
                    ) -> torch.device:
    """The planner's device: ``device`` when given, else
    ``$TPU_CC_TORCH_DEVICE`` when set, else ``cuda:0``. With no CUDA
    device and neither request this raises: the planner never moves to
    the CPU by itself."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or None
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the fleet planner runs on a CUDA device and none is "
                f"available; pass device='cpu' or set {DEVICE_ENV}=cpu "
                "to run its plain PyTorch version on the CPU")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


#: the number of shards the planner splits a block into; unset (or 0),
#: one. Unlike the reference's variable of the same name, which caps the
#: planner platform's device list, this sets the shard count itself
MESH_ENV = "TPU_CC_PLANNER_MESH"


def _planner_mesh(device: Union[None, str, torch.device] = None
                  ) -> Tuple[torch.device, ...]:
    """The planner's mesh: one device per shard, the counterpart of the
    reference's ``_planner_devices`` (its 1-D ``pool`` mesh). The shard
    count S is ``$TPU_CC_PLANNER_MESH`` when set, else 1: the mesh is
    opt-in, as the reference's is (its planner platform defaults to the
    host CPU, one device), and on one card or several a sharded tick
    costs more device time than the unsharded K1. S is rounded down to a
    power of two, so it divides every power-of-two node bucket, and
    clamped to ``BUCKET_MIN_NODES``, so the smallest bucket still gives
    each shard a row. Shard 0 sits on the planner's device
    (:func:`_planner_device`) and shard i on card ``(index + i) %
    cards``: shards beyond the card count share cards, as the
    reference's tests share one host CPU among 8 virtual devices. With no
    variable, S = 1 and the tick is the unsharded K1."""
    dev = _planner_device(device)
    try:
        want = int(os.environ.get(MESH_ENV, "0"))
    except ValueError:
        want = 0
    shards = min(1 << (max(want, 1).bit_length() - 1), BUCKET_MIN_NODES)
    return _shard_devices(dev, shards)


def _shard_devices(dev: torch.device, shards: int
                   ) -> Tuple[torch.device, ...]:
    """``shards`` shard devices from ``dev``: shard i on card
    ``(dev.index + i) % cards`` for a card, every shard on the CPU for
    the CPU."""
    if dev.type != "cuda" or shards == 1:
        return (dev,) * shards
    cards = torch.cuda.device_count()
    return tuple(torch.device("cuda", (dev.index + i) % cards)
                 for i in range(shards))


_TICK_LOCK = threading.Lock()

#: ONE planner dispatch in flight at a time, process-wide — the
#: reference's scope, kept: a dispatch uploads, launches and reads its
#: outputs back before the next one may touch a resident block, and a
#: sharded tick's partials, peer copies and combine must not interleave
#: with another thread's. Ticks are ms-scale whole-fleet batch ops;
#: serializing them costs nothing.
_DISPATCH_LOCK = threading.Lock()


#: the fleet_tick outputs that are per-row; the rest are aggregates
_NODE_OUT_KEYS = ("needs_flip", "failed", "flipping", "doctor_failing",
                  "doctor_unreported", "stale_evidence", "eligible")

#: device-resident column order — the block's row order; the
#: TickSession block, the scatter operands, and the host mirror all
#: index by it
COLS_ORDER = ("desired", "observed", "slice_ids", "pool_ids", "taint",
              "doctor", "ev_ts", "valid")


def columns_to_block(columns: Dict[str, np.ndarray],
                     device: Union[str, torch.device]) -> torch.Tensor:
    """Snapshot columns (a ``FleetSnapshot.columns``-shaped dict of
    numpy arrays — the reference's as well as this module's) → the
    ``int32[8, nb]`` block in ``COLS_ORDER`` on ``device``: one upload."""
    return columns_to_shards(columns, (torch.device(device),))[0]


def columns_to_shards(columns: Dict[str, np.ndarray],
                      mesh: Sequence[torch.device]) -> List[torch.Tensor]:
    """Snapshot columns → one contiguous ``int32[8, nb / S]`` block per
    shard of ``mesh``, shard i holding the global rows ``[i * nb / S,
    (i + 1) * nb / S)`` on ``mesh[i]``: one upload per shard."""
    host = np.stack([np.asarray(columns[key], np.int32)
                     for key in COLS_ORDER])
    rows = host.shape[1] // len(mesh)
    return [torch.from_numpy(np.ascontiguousarray(
        host[:, i * rows:(i + 1) * rows])).to(dev)
        for i, dev in enumerate(mesh)]


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {key: val.cpu().numpy() for key, val in out.items()}


#: when set, ``_mesh_tick`` calls ``MESH_MARK(stage, cards)`` at its
#: stage boundaries ("start", "partials", "copies", "combine") with the
#: cards its shards sit on, so a caller can time the path's own parts
#: (CUDA events on each card's stream); None on the path users run
MESH_MARK: Optional[Callable[[str, Tuple[torch.device, ...]], None]] = None


def _mesh_tick(shards: Sequence[torch.Tensor], pool_target: torch.Tensor,
               now_s: int, stale_s: int, nb: int,
               pb: int) -> Dict[str, np.ndarray]:
    """The sharded tick over S > 1 shard blocks (caller holds
    ``_DISPATCH_LOCK``): K1's partial form on every shard, into its row
    of the partial buffers on shard 0's card or, for a shard on another
    card, into buffers on that card; then the peer copies of those into
    their rows; then one K4 there and the host fetch. Every shard
    scatters into full-width slots with global ids, as the reference's
    shard does.

    The order is by events: a cross-card ``copy_`` runs on the source
    card's stream after an event from the root card's stream, and the
    root's stream waits on an event recorded after the copy, so K4 reads
    only partials that have landed. Every partial is launched before any
    copy: a copy between two partials would hold the root card's later
    partials behind it."""
    root = shards[0].device
    cards = tuple(dict.fromkeys(block.device for block in shards))
    # the upload waits for the card; the marks time the device work after
    targets = {dev: pool_target.to(dev) for dev in cards}
    mark = MESH_MARK
    if mark is not None:
        mark("start", cards)
    n_shards = len(shards)
    counts = torch.empty((n_shards, counts_len(pb)), dtype=torch.int32,
                         device=root)
    slots = torch.empty((n_shards, 6, nb), dtype=torch.int32, device=root)
    masks, peers = [], []
    for i, block in enumerate(shards):
        dev = block.device
        if dev == root:
            c_i, s_i = counts[i], slots[i]
        else:
            c_i = torch.empty(counts_len(pb), dtype=torch.int32, device=dev)
            s_i = torch.empty((6, nb), dtype=torch.int32, device=dev)
            peers.append((i, c_i, s_i))
        masks.append(fleet_tick_partial(
            block, targets[dev], now_s, stale_s, num_pools=pb,
            num_slots=nb, counts=c_i, slots=s_i))
    if mark is not None:
        mark("partials", cards)
    for i, c_i, s_i in peers:
        counts[i].copy_(c_i)
        slots[i].copy_(s_i)
    if mark is not None:
        mark("copies", cards)
    combined = mesh_combine(counts, slots, num_pools=pb)
    if mark is not None:
        mark("combine", cards)
    out = _to_host(combined)
    host_masks = np.concatenate([m.cpu().numpy() for m in masks], axis=1)
    for j, key in enumerate(_NODE_OUT_KEYS):
        out[key] = host_masks[j]
    return out


_EVAL_CACHE: Dict[Tuple[int, int, Tuple[torch.device, ...]],
                  Callable[..., Any]] = {}
_SCATTER_CACHE: Dict[Tuple[int, int, Tuple[torch.device, ...]],
                     Callable[..., Any]] = {}


def _eval_fn(nb: int, pb: int, mesh: Sequence[torch.device]
             ) -> Callable[..., Dict[str, np.ndarray]]:
    """The tick for one (node-bucket, pool-bucket) geometry on ``mesh``
    (:func:`_planner_mesh`) over shard blocks already in place: K1 over
    all ``nb`` rows with ``nb`` slice slots and ``pb`` pool slots —
    unsharded for one shard, K1's partials and K4 for more — outputs
    fetched to the host. Built once per geometry and cached; a pool
    bucket the kernel's shared memory cannot hold raises here, before
    any launch."""
    mesh = tuple(mesh)
    key = (nb, pb, mesh)
    with _TICK_LOCK:
        fn = _EVAL_CACHE.get(key)
        if fn is not None:
            return fn
        check_pool_slots(pb)
        _count_trace("fleet_tick")

        def run(shards: Sequence[torch.Tensor], pool_target: np.ndarray,
                now_s: int, stale_s: int) -> Dict[str, np.ndarray]:
            if len(shards) != len(mesh):
                raise ValueError(
                    f"tick over {len(shards)} shard block(s) on a "
                    f"{len(mesh)}-shard mesh")
            # host-side prep BEFORE the lock: _DISPATCH_LOCK is held for
            # dispatch only
            pt_host = torch.from_numpy(
                np.array(pool_target, np.int32, copy=True))
            with _DISPATCH_LOCK:
                if len(shards) == 1:
                    block = shards[0]
                    return _to_host(fleet_tick_block(
                        block, pt_host.to(block.device), int(now_s),
                        int(stale_s), num_pools=pb, num_slots=nb))
                return _mesh_tick(shards, pt_host, int(now_s),
                                  int(stale_s), nb, pb)

        _EVAL_CACHE[key] = run
        return run


def _tick_fn(nb: int, pb: int, mesh: Sequence[torch.device]
             ) -> Callable[..., Dict[str, np.ndarray]]:
    """The upload-per-call tick (the legacy path): host columns in,
    host outputs out, over :func:`_eval_fn`'s geometry and mesh."""
    evalf = _eval_fn(nb, pb, mesh)

    def run(columns: Dict[str, np.ndarray],
            pool_target: np.ndarray) -> Dict[str, np.ndarray]:
        now_s = int(time.time())
        stale_s = int(_stale_after_s())
        with _DISPATCH_LOCK:
            shards = columns_to_shards(columns, mesh)
        return evalf(shards, pool_target, now_s, stale_s)

    return run


def _by_device(devices: Sequence[torch.device]
               ) -> Dict[torch.device, List[int]]:
    """The shard numbers on each device, in shard order, devices in the
    order of their first shard."""
    groups: Dict[torch.device, List[int]] = {}
    for i, dev in enumerate(devices):
        groups.setdefault(dev, []).append(i)
    return groups


def _scatter_fn(nb: int, kb: int,
                mesh: Sequence[torch.device]) -> Callable[..., None]:
    """The delta scatter for one (node-bucket, delta-bucket) geometry on
    ``mesh``: uploads the ``kb``-sized operands once per card and writes
    up to ``kb`` updated rows into the resident shard blocks in place,
    one K2 launch per card over the shards there, each index going to the
    shard that holds its row. Padding entries carry index ``nb`` and
    change nothing. Built once per geometry and cached, like
    :func:`_eval_fn`."""
    mesh = tuple(mesh)
    key = (nb, kb, mesh)
    with _TICK_LOCK:
        fn = _SCATTER_CACHE.get(key)
        if fn is not None:
            return fn
        _count_trace("delta_scatter")

        def run(shards: Sequence[torch.Tensor], idx: np.ndarray,
                vals: np.ndarray) -> None:
            if len(shards) != len(mesh):
                raise ValueError(
                    f"scatter into {len(shards)} shard block(s) on a "
                    f"{len(mesh)}-shard mesh")
            idx_host = torch.from_numpy(np.array(idx, np.int32, copy=True))
            vals_host = torch.from_numpy(
                np.array(vals, np.int32, copy=True))
            with _DISPATCH_LOCK:
                for dev, ids in _by_device(
                        [block.device for block in shards]).items():
                    delta_scatter_shards(
                        [shards[i] for i in ids], idx_host.to(dev),
                        vals_host.to(dev), nb, shard_ids=ids)

        _SCATTER_CACHE[key] = run
        return run


def _stale_after_s() -> float:
    try:
        return float(os.environ.get(
            "TPU_CC_EVIDENCE_STALE_S", EVIDENCE_STALE_S_DEFAULT))
    except ValueError:
        return EVIDENCE_STALE_S_DEFAULT


# --------------------------------------------- incremental tick session


class IncrementalDriftError(RuntimeError):
    """The incremental tick state diverged from a full kernel
    evaluation — the dirty-mask bookkeeping missed a delta. Hard
    failure by design (docs/planner.md): a planner that silently
    drifts is worse than one that crashes and rebuilds. The raising
    session invalidates itself, so its next tick rebuilds from host
    truth."""


def _outputs_checksum(out: Dict[str, np.ndarray]) -> int:
    """Order-stable CRC over every output array. The incremental ==
    full pin compares the arrays themselves; the checksum is the
    loggable/assertable digest of the same state."""
    crc = 0
    for key in sorted(out):
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(out[key]).tobytes(), crc)
    return crc


def _row_outputs(vals: Dict[str, np.ndarray], pool: np.ndarray,
                 pool_target: np.ndarray, now_s: int,
                 stale_s: int) -> Dict[str, np.ndarray]:
    """fleet_tick's per-row booleans, host-side, for an arbitrary row
    subset. MUST mirror the kernel exactly — the forced full tick
    cross-checks every output array, so a divergence here is an
    IncrementalDriftError crash, not a silent skew."""
    valid = vals["valid"]
    is_valid = valid > 0
    desired = vals["desired"]
    observed = vals["observed"]
    known = (desired != MODE_CODES["unknown"]) & is_valid
    target = pool_target[pool]
    converged = (observed == target) & (desired == target) & known
    flipping = (vals["taint"] > 0) & is_valid
    doctor_failing = (vals["doctor"] == DOCTOR_FAILING) & is_valid
    ev = vals["ev_ts"]
    return {
        "needs_flip": (desired != observed) & known,
        "failed": (observed == MODE_CODES["failed"]) & is_valid,
        "flipping": flipping,
        "doctor_failing": doctor_failing,
        "doctor_unreported": (
            (vals["doctor"] == DOCTOR_UNREPORTED) & is_valid),
        "stale_evidence": (
            (ev >= 0)
            & ((np.int32(now_s) - ev) > np.int32(stale_s))
            & is_valid),
        "eligible": (
            ~converged & is_valid & ~flipping & ~doctor_failing),
        "converged": converged,
    }


class TickResult:
    """One TickSession tick: the host outputs (the fleet_tick dict,
    bucket-padded) plus report-formatting metadata when requested.
    ``checksum`` is the digest from the most recent full (verified)
    tick — incremental ticks carry it forward."""

    __slots__ = ("n", "bucket", "kind", "outputs", "checksum", "names",
                 "slice_index", "doctor_details", "rows")

    def __init__(self, n: int, bucket: Optional[int], kind: str,
                 outputs: Optional[Dict[str, np.ndarray]],
                 checksum: Optional[int],
                 meta: Optional[tuple] = None, rows: int = 0) -> None:
        self.n = n
        self.bucket = bucket
        self.kind = kind
        #: rows the tick wrote: the fleet's on a rebuild, the delta's
        #: on an incremental or full tick, none when cached
        self.rows = rows
        self.outputs = outputs
        self.checksum = checksum
        self.names, self.slice_index, self.doctor_details = (
            meta if meta is not None else (None, None, None))


class TickSession:
    """Delta-driven, device-resident planner tick state
    (docs/planner.md "incremental tick contract").

    Owns the device-resident block (the eight fleet_tick columns, as one
    ``int32[8, nb / S]`` tensor per shard of the planner's mesh,
    :func:`_planner_mesh`) plus a host mirror and incrementally
    maintained outputs. Per tick:

    - drain the encoding's dirty state
      (:meth:`FleetEncoding.begin_tick`),
    - scatter the changed rows into the shard blocks in place
      (:func:`_scatter_fn`, kernel K2 — the columns never round-trip
      host↔device between ticks),
    - fold the changed rows' old→new contributions into the cached
      aggregates and re-evaluate exactly the dirty slice slots against
      the host mirror,
    - every ``full_every`` ticks (and on ``force_full``) ALSO run the
      full device tick (:func:`_eval_fn`: K1, or K1's partials and K4
      on a mesh) over the resident shards and compare every output
      array against the incremental state — any divergence raises
      :class:`IncrementalDriftError`.

    ``now`` is frozen between full ticks so unchanged rows'
    stale_evidence masks stay consistent with changed rows'; each full
    tick refreshes the clock and recomputes the mask. Rebuild
    triggers: bucket change, slice-id compaction, a delta covering a
    quarter of the block, a dispatch error, an empty fleet.

    ``device`` places shard 0 (:func:`_planner_device`: ``cuda:0``
    unless the caller or ``TPU_CC_TORCH_DEVICE`` asks for another); the
    mesh, read once when the session is made, places the others."""

    def __init__(self, *, full_every: Optional[int] = None,
                 device: Union[None, str, torch.device] = None) -> None:
        if full_every is None:
            try:
                full_every = int(os.environ.get(
                    "TPU_CC_PLANNER_FULL_TICK_EVERY", "16"))
            except ValueError:
                full_every = 16
        #: verify cadence: every Nth tick is a checksummed full tick
        #: (≤ 0 disables the cadence; force_full still verifies)
        self.full_every = full_every
        self._lock = threading.Lock()
        #: session geometry
        self.node_bucket: Optional[int] = None
        self.pool_bucket = BUCKET_MIN_POOLS
        #: where the resident block's shard 0 lives
        self.device = _planner_device(device)
        #: one device per shard (:func:`_planner_mesh`), fixed for the
        #: session's life
        self.mesh = _planner_mesh(self.device)
        #: the resident block, one int32[8, node_bucket / S] tensor per
        #: shard of the mesh, in COLS_ORDER, in row order
        self._shards: Optional[List[torch.Tensor]] = None
        self._mirror: Optional[Dict[str, np.ndarray]] = None
        self._state: Optional[Dict[str, np.ndarray]] = None
        self._pool_hist: Optional[np.ndarray] = None
        self._n = 0
        self._now_s = 0
        self._stale_s = 0
        self._ticks_since_full = 0
        self._pool_rows = np.zeros(0, np.int32)
        self._pool_target = np.zeros(BUCKET_MIN_POOLS, np.int32)
        self._pool_target_applied = np.zeros(BUCKET_MIN_POOLS, np.int32)
        self._pools_assigned = False
        self._pool_dirty: set = set()
        self.last_checksum: Optional[int] = None
        #: transfer/tick accounting, pinned by tests: column_puts only
        #: moves on rebuild — steady-state incremental ticks move
        #: delta_puts (the kb-sized scatter operands) and nothing else
        self.stats: Dict[str, int] = {
            "rebuilds": 0, "incr_ticks": 0, "full_ticks": 0,
            "cached_ticks": 0, "column_puts": 0, "delta_puts": 0,
            "delta_rows": 0, "verifies": 0,
        }

    # -------------------------------------------------------- lifecycle
    def invalidate(self) -> None:
        """Drop the device shards; the next tick rebuilds from truth."""
        with self._lock:
            self._invalidate_locked()

    def _invalidate_locked(self) -> None:
        self._shards = None
        self._mirror = None
        self._state = None
        self._pool_hist = None
        self._ticks_since_full = 0

    # ------------------------------------------------- pool assignment
    def assign_pools(self, pool_rows: np.ndarray,
                     pool_target: np.ndarray) -> None:
        """Set the per-row pool assignment ``[n]`` and bucket-padded
        pool targets ``[pool_bucket]`` for subsequent ticks
        (analyze_pools' scratch path; the fleet path leaves everything
        zero, matching the legacy snapshot). Rows whose assignment —
        or whose old/new pool's target — changed are marked dirty for
        the next tick; a pool-bucket change is kernel geometry and
        invalidates the block."""
        pool_rows = np.asarray(pool_rows, np.int32)
        pool_target = np.asarray(pool_target, np.int32)
        with self._lock:
            pb = int(pool_target.shape[0])
            if pb != self.pool_bucket:
                self.pool_bucket = pb
                self._invalidate_locked()
            elif self._shards is not None:
                old_rows = self._pool_rows
                m = min(old_rows.size, pool_rows.size)
                if m:
                    moved = np.nonzero(old_rows[:m] != pool_rows[:m])[0]
                    self._pool_dirty.update(moved.tolist())
                # rows beyond the shorter array are add/remove churn —
                # the encoding already marked those rows dirty
                changed_pids = np.nonzero(
                    self._pool_target != pool_target)[0]
                if changed_pids.size:
                    hit = np.isin(pool_rows, changed_pids)
                    if m:
                        hit[:m] |= np.isin(old_rows[:m], changed_pids)
                    self._pool_dirty.update(np.nonzero(hit)[0].tolist())
            self._pool_rows = pool_rows
            self._pool_target = pool_target
            self._pools_assigned = True

    def _pool_padded(self, nb: int, n: int) -> np.ndarray:
        """The pool_ids column for the current assignment (zeros and
        zero padding on the fleet path — byte-identical to the legacy
        snapshot; assignment + last-slot padding on the policy path)."""
        pad = (self.pool_bucket - 1) if self._pools_assigned else 0
        out = np.full(nb, pad, np.int32)
        if self._pools_assigned:
            m = min(n, self._pool_rows.size)
            out[:m] = self._pool_rows[:m]
            out[m:n] = 0
        else:
            out[:n] = 0
        return out

    # ------------------------------------------------------------ tick
    def tick(self, enc: FleetEncoding, *, force_full: bool = False,
             with_meta: bool = False) -> TickResult:
        """One planner tick over ``enc``'s current state. Thread-safe:
        one tick per session at a time (dispatch itself additionally
        serializes process-wide under _DISPATCH_LOCK)."""
        with self._lock:
            return self._tick_locked(enc, force_full, with_meta)

    def _tick_locked(self, enc: FleetEncoding, force_full: bool,
                     with_meta: bool) -> TickResult:
        delta = enc.begin_tick(
            session_bucket=(self.node_bucket
                            if self._shards is not None else None),
            with_meta=with_meta,
        )
        meta = delta.meta
        if delta.n == 0:
            # empty fleets skip the kernel entirely (analyze_encoding
            # returns the empty report); drop the block so a regrown
            # fleet rebuilds from truth
            self._invalidate_locked()
            self._pool_dirty.clear()
            return TickResult(0, delta.bucket, "empty", None, None,
                              meta)
        if delta.snapshot is not None:
            return self._rebuild_locked(delta, meta)
        want_full = force_full or (
            self.full_every > 0
            and self._ticks_since_full + 1 >= self.full_every
        )
        rows = delta.rows
        extra = self._pool_dirty
        self._pool_dirty = set()
        if extra:
            extra_rows = np.fromiter(
                (r for r in extra if r < delta.n), np.int64)
            rows = np.union1d(rows, extra_rows)
        k = int(rows.size)
        if k == 0 and not delta.slices and not want_full:
            self.stats["cached_ticks"] += 1
            return self._result_locked("cached", meta)
        if k:
            self._apply_delta_locked(rows, delta)
        self._refresh_slices_locked(delta.slices)
        self._n = delta.n
        if want_full:
            self._verify_locked()
            self.stats["full_ticks"] += 1
            self._ticks_since_full = 0
        else:
            self.stats["incr_ticks"] += 1
            self._ticks_since_full += 1
        return self._result_locked(
            "full" if want_full else "incremental", meta, k)

    def _result_locked(self, kind: str, meta: Optional[tuple],
                       rows: int = 0) -> TickResult:
        return TickResult(self._n, self.node_bucket, kind, self._state,
                          self.last_checksum, meta, rows)

    # --------------------------------------------------- rebuild (slow)
    def _rebuild_locked(self, delta: TickDelta,
                        meta: Optional[tuple]) -> TickResult:
        snap = delta.snapshot
        nb = snap.bucket
        pb = self.pool_bucket
        n = delta.n
        cols_host = {key: snap.columns[key] for key in COLS_ORDER}
        cols_host["pool_ids"] = self._pool_padded(nb, n)
        evalf = _eval_fn(nb, pb, self.mesh)
        now_s = int(time.time())
        stale_s = int(_stale_after_s())
        with _DISPATCH_LOCK:
            shards = columns_to_shards(cols_host, self.mesh)
        self.stats["column_puts"] += len(COLS_ORDER)
        try:
            out = evalf(shards, self._pool_target, now_s, stale_s)
        except Exception:
            self._invalidate_locked()
            raise
        self._shards = shards
        self.node_bucket = nb
        self._n = n
        self._now_s = now_s
        self._stale_s = stale_s
        self._mirror = cols_host
        self._state = {key: np.array(v) for key, v in out.items()}
        self._pool_hist = self._hist_from_mirror_locked()
        self.last_checksum = _outputs_checksum(self._state)
        self._pool_target_applied = self._pool_target.copy()
        self._pool_dirty.clear()
        self._ticks_since_full = 0
        self.stats["rebuilds"] += 1
        return self._result_locked("rebuild", meta, n)

    def _hist_from_mirror_locked(self) -> np.ndarray:
        pool = self._mirror["pool_ids"].astype(np.int64)
        obs = self._mirror["observed"].astype(np.int64)
        live = self._mirror["valid"] > 0
        flat = np.bincount((pool * N_MODES + obs)[live],
                           minlength=self.pool_bucket * N_MODES)
        return flat.reshape(self.pool_bucket, N_MODES).astype(np.int32)

    # ------------------------------------------------ incremental (hot)
    def _apply_delta_locked(self, rows: np.ndarray,
                            delta: TickDelta) -> None:
        mirror = self._mirror
        state = self._state
        k = int(rows.size)
        old_vals = {key: mirror[key][rows] for key in COLS_ORDER}
        new_vals: Dict[str, np.ndarray] = {}
        pos = np.searchsorted(rows, delta.rows)
        for key in ("desired", "observed", "slice_ids", "taint",
                    "doctor", "ev_ts", "valid"):
            v = old_vals[key].copy()
            v[pos] = delta.vals[key]
            new_vals[key] = v
        pad_pool = (self.pool_bucket - 1) if self._pools_assigned else 0
        new_pool = np.full(k, pad_pool, np.int32)
        live = rows < delta.n
        if self._pools_assigned:
            m = min(delta.n, self._pool_rows.size)
            in_assign = rows < m
            new_pool[in_assign] = self._pool_rows[rows[in_assign]]
            new_pool[live & ~in_assign] = 0
        else:
            new_pool[live] = 0
        new_vals["pool_ids"] = new_pool

        old_out = _row_outputs(old_vals, old_vals["pool_ids"],
                               self._pool_target_applied, self._now_s,
                               self._stale_s)
        new_out = _row_outputs(new_vals, new_vals["pool_ids"],
                               self._pool_target, self._now_s,
                               self._stale_s)
        ovi = old_vals["valid"]
        nvi = new_vals["valid"]
        op = old_vals["pool_ids"]
        npid = new_vals["pool_ids"]
        np.add.at(state["mode_counts"], old_vals["observed"], -ovi)
        np.add.at(state["mode_counts"], new_vals["observed"], nvi)
        np.add.at(state["desired_counts"], old_vals["desired"], -ovi)
        np.add.at(state["desired_counts"], new_vals["desired"], nvi)
        np.add.at(state["pool_nodes"], op, -ovi)
        np.add.at(state["pool_nodes"], npid, nvi)
        for skey, okey in (("pool_converged", "converged"),
                           ("pool_failed", "failed"),
                           ("pool_eligible", "eligible")):
            np.add.at(state[skey], op, -old_out[okey].astype(np.int32))
            np.add.at(state[skey], npid,
                      new_out[okey].astype(np.int32))
        np.add.at(self._pool_hist, (op, old_vals["observed"]), -ovi)
        np.add.at(self._pool_hist, (npid, new_vals["observed"]), nvi)
        for key in _NODE_OUT_KEYS:
            state[key][rows] = new_out[key]
        for key in COLS_ORDER:
            mirror[key][rows] = new_vals[key]
        state["pool_skew"] = (
            state["pool_nodes"] - self._pool_hist.max(axis=1))
        state["pool_divergent"] = (
            state["pool_nodes"] - state["pool_converged"])
        self._pool_target_applied = self._pool_target.copy()

        nb = self.node_bucket
        kb = bucket_deltas(k)
        idx = np.full(kb, nb, np.int32)
        idx[:k] = rows
        vals8 = np.zeros((8, kb), np.int32)
        for j, key in enumerate(COLS_ORDER):
            vals8[j, :k] = new_vals[key]
        scatter = _scatter_fn(nb, kb, self.mesh)
        # K2 writes the rows into the resident shards in place: the
        # reference donates the block to its scatter program
        # (donate_argnums) for the same end, no second copy of it
        try:
            scatter(self._shards, idx, vals8)
        except Exception:
            self._invalidate_locked()
            raise
        self.stats["delta_puts"] += 2
        self.stats["delta_rows"] += k

    def _refresh_slices_locked(
            self, slices: Optional[List[Tuple[int, np.ndarray]]]
    ) -> None:
        if not slices:
            return
        state = self._state
        mirror = self._mirror
        nsl = len(slices)
        imax = np.iinfo(np.int32).max
        imin = np.iinfo(np.int32).min
        d_mn = np.full(nsl, imax, np.int32)
        d_mx = np.full(nsl, imin, np.int32)
        o_mn = np.full(nsl, imax, np.int32)
        o_mx = np.full(nsl, imin, np.int32)
        at_mn = np.ones(nsl, np.int32)
        at_mx = np.zeros(nsl, np.int32)
        sids = np.fromiter((s for s, _ in slices), np.int64, count=nsl)
        counts = [r.size for _, r in slices]
        if any(counts):
            members = np.concatenate([r for _, r in slices])
            seg = np.repeat(np.arange(nsl), counts)
            d = mirror["desired"][members]
            o = mirror["observed"][members]
            valid_m = mirror["valid"][members] > 0
            known = (d != MODE_CODES["unknown"]) & valid_m
            at = ((o == d) & known).astype(np.int32)
            np.minimum.at(d_mn, seg, d)
            np.maximum.at(d_mx, seg, d)
            np.minimum.at(o_mn, seg, o)
            np.maximum.at(o_mx, seg, o)
            np.minimum.at(at_mn, seg, at)
            np.maximum.at(at_mx, seg, at)
        # dead slots land on the init values — coherent False, half
        # False — exactly the kernel's empty-slot semantics
        state["slice_coherent"][sids] = (d_mn == d_mx) & (o_mn == o_mx)
        state["slice_half_flipped"][sids] = (
            (d_mn == d_mx) & (at_mn == 0) & (at_mx == 1))

    # ----------------------------------------------- full tick (verify)
    def _verify_locked(self) -> None:
        nb = self.node_bucket
        pb = self.pool_bucket
        evalf = _eval_fn(nb, pb, self.mesh)
        try:
            out = evalf(self._shards, self._pool_target,
                        self._now_s, self._stale_s)
        except Exception:
            self._invalidate_locked()
            raise
        self.stats["verifies"] += 1
        bad = [
            key for key in sorted(out)
            if not np.array_equal(np.asarray(out[key]),
                                  self._state[key])
        ]
        if bad:
            incr_crc = _outputs_checksum(self._state)
            full_crc = _outputs_checksum(
                {key: np.asarray(v) for key, v in out.items()})
            self._invalidate_locked()
            raise IncrementalDriftError(
                "incremental tick diverged from full kernel "
                f"evaluation on {bad} (incremental checksum "
                f"{incr_crc:#010x} != full {full_crc:#010x}); session "
                "invalidated — next tick rebuilds from host truth")
        # the pin held: refresh the frozen clock and advance the
        # stale_evidence mask (it moves at full-tick cadence)
        now_s = int(time.time())
        stale_s = int(_stale_after_s())
        self._now_s = now_s
        self._stale_s = stale_s
        ev = self._mirror["ev_ts"]
        self._state["stale_evidence"] = (
            (ev >= 0)
            & ((np.int32(now_s) - ev) > np.int32(stale_s))
            & (self._mirror["valid"] > 0))
        self.last_checksum = _outputs_checksum(self._state)


class PoolScanScratch:
    """PolicyController's persistent analyze_pools state: one
    FleetEncoding + one TickSession reused across scans, so a repeat
    scan re-encodes only churn and re-uploads nothing (the satellite
    pin: ``session.stats["column_puts"]`` is flat across unchanged
    scans)."""

    def __init__(self, *,
                 device: Union[None, str, torch.device] = None) -> None:
        self.encoding = FleetEncoding()
        self.session = TickSession(device=device)


# ------------------------------------------------- kernel build + warmup


def configure_cache(cache_dir: Optional[str] = None) -> Optional[str]:
    """Kept for the reference's callers; does nothing and returns None.
    The reference points JAX's persistent compilation cache at a
    directory here. The port has no JIT cache to point anywhere: its
    kernels compile once per source hash into the package's build
    directory (``kernels/_build.py``), and a restarted process loads that
    library instead of compiling (``compile_stats()["cache_hits"]``)."""
    return None


def maybe_warmup(logger: logging.Logger) -> None:
    """Controller-start warmup policy, shared by the fleet AND policy
    controllers: with ``TPU_CC_PLANNER_WARMUP`` truthy, build the kernel
    library and launch every geometry of the bucket ladder BEFORE the
    first scan, so the first scan pays neither the build nor a first
    launch. Opt-in by env so in-process embedders (tests) don't pay the
    ladder; the controller entrypoints set the default for production."""
    if os.environ.get("TPU_CC_PLANNER_WARMUP", "") in ("", "0", "false"):
        return
    configure_cache()
    t0 = time.monotonic()
    timings = warmup()
    logger.info(
        "planner warmup: %d bucket(s) in %.3fs (%s)",
        len(timings), time.monotonic() - t0,
        ", ".join(f"{k}={v}s" for k, v in sorted(timings.items())),
    )


def warmup(max_nodes: Optional[int] = None,
           pool_buckets: Optional[Sequence[int]] = None, *,
           device: Union[None, str, torch.device] = None
           ) -> Dict[str, float]:
    """Build the kernel library and launch the tick once for the whole
    bucket ladder up to ``max_nodes`` (TPU_CC_WARMUP_NODES, default 1024)
    × the pool-bucket ladder up to ``TPU_CC_WARMUP_POOLS`` pools (default
    8). The first geometry's time includes the library build when this
    process has not loaded it yet. Returns per-bucket seconds."""
    if max_nodes is None:
        try:
            max_nodes = int(os.environ.get("TPU_CC_WARMUP_NODES", "1024"))
        except ValueError:
            max_nodes = 1024
    if pool_buckets is None:
        try:
            max_pools = int(os.environ.get("TPU_CC_WARMUP_POOLS", "8"))
        except ValueError:
            max_pools = 8
        ladder = [BUCKET_MIN_POOLS]
        while ladder[-1] < bucket_pools(max_pools):
            ladder.append(ladder[-1] * 2)
        pool_buckets = ladder
    dev = _planner_device(device)
    mesh = _planner_mesh(dev)
    configure_cache()
    timings: Dict[str, float] = {}
    nb = BUCKET_MIN_NODES
    while True:
        for pb in pool_buckets:
            t0 = time.monotonic()
            evalf = _eval_fn(nb, pb, mesh)
            zeros = {key: np.zeros(nb, np.int32) for key in COLS_ORDER}
            with _DISPATCH_LOCK:
                shards = columns_to_shards(zeros, mesh)
            evalf(shards, np.zeros(pb, np.int32), 0, 0)
            timings[f"n{nb}p{pb}"] = round(time.monotonic() - t0, 4)
        if nb >= bucket_nodes(max_nodes):
            break
        nb *= 2
    return timings


# ------------------------------------------------------------- host API


def _mask_names(names: List[str], mask: np.ndarray) -> List[str]:
    return [n for n, flag in zip(names, mask) if flag]


def _empty_report() -> dict:
    return {
        "nodes": 0,
        "needs_flip": [],
        "failed": [],
        "flipping": [],
        "stale_evidence": [],
        "mode_counts": {},
        "incoherent_slices": [],
        "half_flipped_slices": [],
        "doctor": {"reported": 0, "unreported": [], "failing": []},
    }


def _format_report(n: int, names: List[str],
                   slice_index: Dict[str, int],
                   doctor_details: Dict[str, dict],
                   out: Dict[str, np.ndarray]) -> dict:
    """fleet_tick outputs → the JSON-ready fleet report. Shared by the
    legacy upload-per-call path and the incremental session path, so
    the two can never drift in shape."""
    slice_names = {v: k for k, v in slice_index.items()}
    real_slice = {
        v: not k.startswith("__solo__/")
        for k, v in slice_index.items()
    }
    unreported = sorted(_mask_names(names, out["doctor_unreported"]))
    failing_names = _mask_names(names, out["doctor_failing"])
    failing = sorted(
        (
            {
                "node": name,
                "fail": doctor_details.get(name, {}).get(
                    "fail", ["unparseable"]),
                "at": doctor_details.get(name, {}).get("at"),
            }
            for name in failing_names
        ),
        key=lambda d: d["node"],
    )
    return {
        "nodes": n,
        "needs_flip": _mask_names(names, out["needs_flip"]),
        "failed": _mask_names(names, out["failed"]),
        "flipping": _mask_names(names, out["flipping"]),
        "stale_evidence": _mask_names(names, out["stale_evidence"]),
        "mode_counts": {
            CODE_MODES[i]: int(c)
            for i, c in enumerate(out["mode_counts"])
            if c
        },
        "incoherent_slices": [
            slice_names[i]
            for i in sorted(slice_names)
            if real_slice[i] and not out["slice_coherent"][i]
        ],
        "half_flipped_slices": [
            slice_names[i]
            for i in sorted(slice_names)
            if real_slice[i] and out["slice_half_flipped"][i]
        ],
        "doctor": {
            "reported": n - len(unreported),
            "unreported": unreported,
            "failing": failing,
        },
    }


def analyze_encoding(enc: FleetEncoding,
                     session: Optional[TickSession] = None,
                     *, force_full: bool = False,
                     device: Union[None, str, torch.device] = None) -> dict:
    """One planner tick over a live feature block → JSON-ready report
    (the fleet controller's scan body). With a ``session``, the tick
    is delta-driven and device-resident (docs/planner.md
    incremental-tick contract); without one, every call snapshots and
    uploads — the legacy path, on ``device`` (:func:`_planner_device`).
    Same report either way.

    Opens the spans ``snapshot`` (the legacy path's), ``tick`` and
    ``report`` on the process tracer, each counted from host arrays
    alone."""
    tracer = get_tracer()
    if session is not None:
        with tracer.span("tick") as span:
            res = session.tick(enc, force_full=force_full, with_meta=True)
            span.attrs.update(path=res.kind, rows=res.rows)
        if res.n == 0:
            return _empty_report()
        with tracer.span("report", n=res.n):
            return _format_report(res.n, res.names, res.slice_index,
                                  res.doctor_details, res.outputs)
    dev = _planner_device(device)
    with tracer.span("snapshot") as span:
        snap = enc.snapshot()
        span.attrs.update(
            n=snap.n_nodes, bucket=snap.bucket,
            bytes=sum(int(c.nbytes) for c in snap.columns.values()))
    n = snap.n_nodes
    if n == 0:
        return _empty_report()
    nb = snap.bucket
    tick = _tick_fn(nb, BUCKET_MIN_POOLS, _planner_mesh(dev))
    pool_target = np.zeros(BUCKET_MIN_POOLS, np.int32)
    bytes_up = int(pool_target.nbytes) + sum(
        int(snap.columns[key].nbytes) for key in COLS_ORDER)
    with tracer.span("tick", path="legacy", nb=nb, pb=BUCKET_MIN_POOLS,
                     bytes_up=bytes_up) as span:
        out = tick(snap.columns, pool_target)
        span.attrs["bytes_down"] = sum(int(v.nbytes) for v in out.values())
    with tracer.span("report", n=n):
        return _format_report(n, snap.names, snap.slice_index,
                              snap.doctor_details, out)


def analyze_fleet(nodes: List[dict], *,
                  device: Union[None, str, torch.device] = None) -> dict:
    """End-to-end host API: node objects in, JSON-ready report out.
    Builds a throwaway feature block; long-lived controllers keep a
    :class:`FleetEncoding` and call :func:`analyze_encoding` so the
    encode cost tracks deltas, not fleet size. Opens the spans
    ``analyze_fleet`` and ``encode`` around :func:`analyze_encoding`'s
    own."""
    dev = _planner_device(device)
    tracer = get_tracer()
    with tracer.span("analyze_fleet") as span:
        with tracer.span("encode", nodes=len(nodes)) as enc_span:
            enc = FleetEncoding._throwaway(nodes)
            enc_span.attrs.update(enc.stats)
        n = len(enc)
        span.attrs.update(n=n, bucket=bucket_nodes(n))
        return analyze_encoding(enc, device=dev)


def _pool_result(pools: Sequence[Tuple[str, str, List[dict]]],
                 out: Dict[str, np.ndarray]) -> Dict[str, Dict[str, int]]:
    result: Dict[str, Dict[str, int]] = {}
    for pid, (pname, _, _) in enumerate(pools):
        result[pname] = {
            "nodes": int(out["pool_nodes"][pid]),
            "converged": int(out["pool_converged"][pid]),
            "failed": int(out["pool_failed"][pid]),
            "divergent": int(out["pool_divergent"][pid]),
            "skew": int(out["pool_skew"][pid]),
            "eligible": int(out["pool_eligible"][pid]),
        }
    return result


def _pool_empty(
        pools: Sequence[Tuple[str, str, List[dict]]],
) -> Dict[str, Dict[str, int]]:
    return {
        pname: {"nodes": 0, "converged": 0, "failed": 0,
                "divergent": 0, "skew": 0, "eligible": 0}
        for pname, _, _ in pools
    }


def analyze_pools(
    pools: Sequence[Tuple[str, str, List[dict]]],
    *, scratch: Optional[PoolScanScratch] = None,
    device: Union[None, str, torch.device] = None,
) -> Dict[str, Dict[str, int]]:
    """The policy controller's batched question: for each
    ``(pool_name, target_mode, nodes)``, per-pool convergence, failure,
    divergence, skew, and rollout-eligibility counts — one kernel call
    for every policy in the scan, replacing the per-node Python loops
    ``_derive_status`` used to run.

    With ``scratch`` (PolicyController keeps one per controller), the
    encoding and the device-resident tick session persist across
    scans: a repeat scan re-encodes only churn, scatters only deltas,
    and allocates no new device buffers — the same deltas-not-size
    contract the fleet side has. ``device`` places the throwaway path's
    tick (:func:`_planner_device`); a scratch's session has its own."""
    if scratch is not None:
        return _analyze_pools_session(pools, scratch)
    dev = _planner_device(device)
    enc = FleetEncoding()
    pool_of: Dict[str, int] = {}
    targets: List[int] = []
    for pid, (pname, mode, nodes) in enumerate(pools):
        targets.append(encode_mode(mode))
        for node in nodes:
            # pool membership is positional: a node listed under two
            # pools belongs to the FIRST (the claims pass already
            # resolves overlap before calling here)
            name = node["metadata"]["name"]
            if name not in pool_of:
                pool_of[name] = pid
            enc.apply(node)
    snap = enc.snapshot()
    n = snap.n_nodes
    pb = bucket_pools(len(pools))
    if n == 0:
        return _pool_empty(pools)
    pool_ids = snap.columns["pool_ids"]
    for i, name in enumerate(snap.names):
        pool_ids[i] = pool_of[name]
    pool_ids[n:] = pb - 1
    pool_target = np.zeros(pb, np.int32)
    pool_target[: len(targets)] = targets
    nb = snap.bucket
    out = _tick_fn(nb, pb, _planner_mesh(dev))(snap.columns, pool_target)
    return _pool_result(pools, out)


def _analyze_pools_session(
    pools: Sequence[Tuple[str, str, List[dict]]],
    scratch: PoolScanScratch,
) -> Dict[str, Dict[str, int]]:
    """analyze_pools over persistent scratch: sync the scan's pool
    membership into the long-lived encoding (apply + remove-vanished,
    like the fleet side's sync), diff the pool assignment/targets into
    the session, tick."""
    enc = scratch.encoding
    session = scratch.session
    pool_of: Dict[str, int] = {}
    targets: List[int] = []
    for pid, (pname, mode, nodes) in enumerate(pools):
        targets.append(encode_mode(mode))
        for node in nodes:
            name = node["metadata"]["name"]
            if name not in pool_of:
                pool_of[name] = pid
            enc.apply(node)
    for name in enc.tracked_names():
        if name not in pool_of:
            enc.remove(name)
    n = len(enc)
    if n == 0:
        return _pool_empty(pools)
    pb = bucket_pools(len(pools))
    rows = enc.row_map()
    pool_rows = np.zeros(n, np.int32)
    for name, pid in pool_of.items():
        r = rows.get(name)
        if r is not None:
            pool_rows[r] = pid
    pool_target = np.zeros(pb, np.int32)
    pool_target[: len(targets)] = targets
    session.assign_pools(pool_rows, pool_target)
    return _pool_result(pools, session.tick(enc).outputs)


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: ``python -m tpu_cc_manager_torch.plan`` — fleet report from a
    live API server (or --from-file for an offline node dump), planned on
    the GPU (``TPU_CC_TORCH_DEVICE=cpu`` plans on the CPU)."""
    import argparse

    ap = argparse.ArgumentParser(prog="tpu-cc-fleet-plan")
    ap.add_argument("--kubeconfig", default=None)
    ap.add_argument("--from-file", default=None,
                    help="JSON file with a NodeList (offline analysis)")
    ap.add_argument("--selector", default=L.TPU_ACCELERATOR_LABEL,
                    help="label selector for TPU nodes")
    args = ap.parse_args(argv)
    if args.from_file:
        with open(args.from_file) as f:
            nodes = json.load(f).get("items", [])
    else:
        from tpu_cc_manager_torch.k8s.client import HttpKubeClient, KubeConfig

        kube = HttpKubeClient(KubeConfig.load(args.kubeconfig))
        nodes = kube.list_nodes(args.selector)
    print(json.dumps(analyze_fleet(nodes), indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
