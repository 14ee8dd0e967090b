"""K1's share of its roofline over the traced window, in %."""

from portbench.metrics import roofline_pct


def read(tr):
    return roofline_pct(tr, "scan", "k1")
