"""Mean host ms per rollout preflight in the program's ``groups`` span,
the group plan with its evidence check (see BENCHMARK.json)."""

from portbench.program_spans import collect, span_ms


def read(tr):
    return span_ms(collect(tr), "groups")
