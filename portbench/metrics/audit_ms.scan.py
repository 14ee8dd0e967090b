"""Mean host ms per fleet scan in the audit layer (see BENCHMARK.json)."""

from portbench.metrics import layer_mean_ms


def read(tr):
    return layer_mean_ms(tr, "scan", "audit")
