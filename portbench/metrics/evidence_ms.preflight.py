"""Mean host ms per rollout preflight in the group plan's evidence
checks, the ``groups`` span's ``evidence_s`` (see BENCHMARK.json)."""

from portbench.program_spans import collect, evidence_ms


def read(tr):
    return evidence_ms(collect(tr))
