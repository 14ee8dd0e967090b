"""Mean host ms per rollout preflight in the attestation judge
(``attest.judge_attestation``), the ``groups`` span's ``attestation_s``
(see BENCHMARK.json)."""

from portbench.program_spans import attr_mean, collect


def read(tr):
    s = attr_mean(collect(tr), "groups", "attestation_s")
    return None if s is None else 1e3 * s
