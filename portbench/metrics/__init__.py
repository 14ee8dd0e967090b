"""Per-layer metric readers: one file per metric, named as the metric is
in ``BENCHMARK.json`` (``list_ms.scan.py`` reads ``list_ms.scan``), each
with ``read(trace) -> float | None``. A reader that finds nothing to read
returns None and the harness leaves the metric out of the line.

``trace`` is the driver's :class:`TraceData`; the helpers below are the
arithmetic the readers share.
"""

from __future__ import annotations

from typing import Dict, List, Optional


class TraceData:
    """What a traced run kept: ``calls`` of ``kind`` begun in the window,
    each a dict of layer -> host ms spent in it during the call;
    ``roofline`` (kernel -> % or None); the device's busy and window
    seconds (None off the card); ``delivery_ms``."""

    def __init__(self, kind: str, calls: List[Dict[str, float]],
                 roofline: Dict[str, Optional[float]],
                 busy_s: Optional[float], window_s: Optional[float],
                 delivery_ms: Optional[List[float]] = None) -> None:
        self.kind = kind
        self.calls = calls
        self.roofline = roofline
        self.busy_s = busy_s
        self.window_s = window_s
        self.delivery_ms = delivery_ms or []


def layer_mean_ms(tr: TraceData, kind: str, layer: str) -> Optional[float]:
    """Mean host ms per call of ``kind`` spent in ``layer`` (a call that
    did not enter the layer counts 0)."""
    if tr.kind != kind or not tr.calls:
        return None
    return sum(c.get(layer, 0.0) for c in tr.calls) / len(tr.calls)


def idle_pct(tr: TraceData, kind: str) -> Optional[float]:
    if tr.kind != kind or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(tr: TraceData, kind: str, kernel: str) -> Optional[float]:
    if tr.kind != kind:
        return None
    return tr.roofline.get(kernel)
