"""Mean host ms per rollout preflight that no program span covers, over
the closed loop's period (see BENCHMARK.json)."""

from portbench.program_spans import collect, unspanned_ms


def read(tr):
    return unspanned_ms(collect(tr))
