"""Every version each node of the stand-in had, in resourceVersion order,
rebuilt from the fleet the benchmark made and the writes it sent."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.reference.model import (
    AUDIT_CODE, Version, merge_patch, parse_version,
)


class History:
    """``fleet`` as the stand-in held it before any write; :meth:`add`
    takes each write in the order the stand-in committed it."""

    def __init__(self, fleet: List[dict], key: bytes) -> None:
        self.key = key
        self.names = [n["metadata"]["name"] for n in fleet]
        self.index = {name: i for i, name in enumerate(self.names)}
        self._cache: Dict[Tuple[str, str], Tuple] = {}
        self._cur = list(fleet)
        self.versions: List[Version] = [
            parse_version(n, key, self._cache) for n in fleet]
        self.base_vid = np.arange(len(fleet), dtype=np.int64)
        self._cur_vid = list(range(len(fleet)))
        #: per node: (rv, vid) of each later version, in rv order
        self.node_versions: List[List[Tuple[int, int]]] = [
            [] for _ in fleet]
        #: every version-changing write: rv, node, vid (rv ascending)
        self.w_rv: List[int] = []
        self.w_node: List[int] = []
        self.w_vid: List[int] = []
        self._arrays: Optional[Dict[str, np.ndarray]] = None

    @property
    def n(self) -> int:
        return len(self.names)

    def add(self, rv: int, node: int, patch: dict) -> None:
        cur = merge_patch(self._cur[node], patch)
        self._cur[node] = cur
        v = parse_version(cur, self.key, self._cache)
        if v == self.versions[self._cur_vid[node]]:
            return
        vid = len(self.versions)
        self.versions.append(v)
        self._cur_vid[node] = vid
        self.node_versions[node].append((rv, vid))
        if self.w_rv and rv < self.w_rv[-1]:
            raise ValueError("writes must be added in commit order")
        self.w_rv.append(rv)
        self.w_node.append(node)
        self.w_vid.append(vid)
        self._arrays = None

    def arrays(self) -> Dict[str, np.ndarray]:
        """Each field of every version, as an array over version ids."""
        if self._arrays is None:
            vs = self.versions
            slices = sorted({v.slice for v in vs if v.slice})
            self.slice_keys = slices
            sid = {k: i for i, k in enumerate(slices)}
            self._arrays = {
                "desired": np.array([v.desired for v in vs], np.int64),
                "observed": np.array([v.observed for v in vs], np.int64),
                "taint": np.array([v.taint for v in vs], bool),
                "doctor": np.array([v.doctor for v in vs], np.int64),
                "ev_ts": np.array([v.ev_ts for v in vs], np.int64),
                "audit": np.array([AUDIT_CODE[v.audit] for v in vs],
                                  np.int64),
                "slice": np.array([sid[v.slice] if v.slice else -1
                                   for v in vs], np.int64),
            }
        return self._arrays

    def vids_at(self, rv: int) -> np.ndarray:
        """Each node's version current at ``rv``."""
        out = self.base_vid.copy()
        k = bisect.bisect_right(self.w_rv, rv)
        if k:
            # version ids grow with commit order: a node's newest is its max
            np.maximum.at(out, np.asarray(self.w_node[:k]),
                          np.asarray(self.w_vid[:k]))
        return out

    def candidates(self, lo: int, hi: int, at_lo: np.ndarray
                   ) -> Dict[int, List[int]]:
        """Nodes with a version newer than ``at_lo`` written in ``(lo,
        hi]``: each one's versions from ``at_lo`` on that were current
        anywhere in ``[lo, hi]``, oldest first. ``at_lo`` may be later
        than the version current at ``lo`` (a floor from an earlier
        report); versions before it are not candidates."""
        a = bisect.bisect_right(self.w_rv, lo)
        b = bisect.bisect_right(self.w_rv, hi)
        out: Dict[int, List[int]] = {}
        for j in range(a, b):
            node = self.w_node[j]
            if self.w_vid[j] > at_lo[node]:
                out.setdefault(node, [int(at_lo[node])]).append(
                    self.w_vid[j])
        return out

    def doctor_ats(self, node: int, hi: int) -> set:
        """Every doctor ``at`` the node's versions up to ``hi`` carried."""
        ats = {self.versions[node].at}
        for rv, vid in self.node_versions[node]:
            if rv > hi:
                break
            ats.add(self.versions[vid].at)
        return ats
