"""Mean host ms per rollout preflight in the program's ``snapshot`` span,
the planner's bucket-padded copy of the feature block (see
BENCHMARK.json)."""

from portbench.program_spans import collect, span_ms


def read(tr):
    return span_ms(collect(tr), "snapshot")
