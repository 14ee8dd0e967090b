"""The card's idle share of the traced window, in %."""

from portbench.metrics import idle_pct


def read(tr):
    return idle_pct(tr, "scan")
