"""95th percentile ms from the stand-in returning a write to the fleet
controller's informer callback receiving it, over the writes due in the
window."""

from portbench.measure import p95


def read(tr):
    if tr.kind != "scan" or not tr.delivery_ms:
        return None
    return p95(tr.delivery_ms)
