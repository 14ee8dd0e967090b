"""Mean host ms per rollout preflight in the group plan's RS256 batch: the
pre-pass over the evidence documents, kernel K6 and its one read-back, the
``groups`` span's ``rsa_batch_s`` (see BENCHMARK.json). None where the
program's span has no such attribute."""

from portbench.program_spans import attr_mean, collect


def read(tr):
    s = attr_mean(collect(tr), "groups", "rsa_batch_s")
    return None if s is None else 1e3 * s
