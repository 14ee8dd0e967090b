"""The part of the node-watch layer the planner needs.

Only :func:`stable_doctor_digest` lives here for now: the planner's row
fingerprint (:meth:`tpu_cc_manager_torch.plan.FleetEncoding._fingerprint`)
reduces the doctor annotation with it. The watch loop itself, its
coalescing mailbox and its report fingerprint come with the controller
slice of the port.
"""

from __future__ import annotations

import json
from typing import Optional


def stable_doctor_digest(raw: Optional[str]) -> Optional[str]:
    """Volatile-timestamp-free reduction of the doctor annotation: the
    ``{ok, fail}`` digest only, so a periodic republish that merely
    moves the verdict timestamp compares equal. Shared by the watch
    wake filter and the planner's row fingerprint
    (plan.FleetEncoding) — the two MUST agree or watch wake-ups and
    encoding re-encodes diverge. Total over hostile node-writable
    annotations: malformed or non-dict shapes reduce to a stable value
    (the raw text) instead of throwing in a watch thread."""
    if not raw:
        return None
    try:
        d = json.loads(raw)
    except ValueError:
        return raw
    if not isinstance(d, dict):
        return raw
    return json.dumps({"ok": d.get("ok"), "fail": d.get("fail")},
                      sort_keys=True)
