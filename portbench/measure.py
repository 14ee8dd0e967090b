"""The end-to-end arithmetic: means over the calls begun in the window,
and each rolling write's plan lag from the kept reports and the write
log, worked out after the window has closed."""

from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from portbench.traffic import DESIRED, DONE, DONE_FAILED, TAINT

#: the node lists each rolling write puts its node in:
#: (needs_flip, flipping, failed)
SIGNATURE = {DESIRED: (True, False, False), TAINT: (True, True, False),
             DONE: (False, False, False), DONE_FAILED: (True, False, True)}


class Call(NamedTuple):
    """One timed call of the system under test (a scan or a preflight)."""
    begin: float          # monotonic
    end: float
    wall_begin: float
    wall_end: float
    lo_rv: int            # see the driver
    hi_rv: int
    result: Optional[dict]
    error: Optional[str]
    extra: dict


def in_window(calls: Sequence[Call], lo: float, hi: float) -> List[Call]:
    return [c for c in calls if lo <= c.begin < hi]


def mean_s(calls: Sequence[Call]) -> Optional[float]:
    if not calls:
        return None
    return float(np.mean([c.end - c.begin for c in calls]))


def p95(values: Sequence[float]) -> Optional[float]:
    """95th percentile, linear between order statistics (numpy's
    default)."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, float), 95))


def _sig(sets: Tuple[set, set, set], name: str) -> Tuple[bool, bool, bool]:
    return (name in sets[0], name in sets[1], name in sets[2])


def plan_lags(scans: Sequence[Call], writes, names: List[str], lo: float,
              hi: float) -> Tuple[List[float], int]:
    """Each rolling write due in ``[lo, hi)``: seconds from its due time
    to the end of the first scan that ended after the stand-in returned
    it and whose report puts the node in the lists this write, or a later
    write of the same flip already returned by then, puts it in. Returns
    the lags and the count of writes no scan showed."""
    done = [s for s in scans if s.result is not None]
    done.sort(key=lambda s: s.end)
    ends = [s.end for s in done]
    sets = [(set(s.result["needs_flip"]), set(s.result["flipping"]),
             set(s.result["failed"])) for s in done]
    flips: Dict[int, list] = {}
    for w in writes:
        if w.kind in SIGNATURE:
            flips.setdefault(w.node, []).append(w)
    lags: List[float] = []
    unseen = 0
    for node, ws in flips.items():
        name = names[node]
        for k, w in enumerate(ws):
            if not lo <= w.due < hi:
                continue
            j = bisect.bisect_right(ends, w.end)
            shown = None
            while j < len(done):
                ok = {SIGNATURE[x.kind] for x in ws[k:] if x.end < ends[j]}
                if _sig(sets[j], name) in ok:
                    shown = ends[j]
                    break
                j += 1
            if shown is None:
                unseen += 1
            else:
                lags.append(shown - w.due)
    return lags, unseen
