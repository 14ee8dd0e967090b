"""Mean host ms per rollout preflight in the identity judge
(``identity.judge_identity``), the ``groups`` span's ``identity_s`` (see
BENCHMARK.json)."""

from portbench.program_spans import attr_mean, collect


def read(tr):
    s = attr_mean(collect(tr), "groups", "identity_s")
    return None if s is None else 1e3 * s
