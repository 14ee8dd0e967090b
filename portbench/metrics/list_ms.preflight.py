"""Mean host ms per rollout preflight in the discovery layer (see BENCHMARK.json)."""

from portbench.metrics import layer_mean_ms


def read(tr):
    return layer_mean_ms(tr, "preflight", "list")
