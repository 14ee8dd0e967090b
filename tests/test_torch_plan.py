"""The PyTorch port's planner held to the JAX planner on the CPU.

The same numpy-seeded node dicts go through ``tpu_cc_manager.plan`` and
``tpu_cc_manager_torch.plan`` (``device="cpu"``, where the kernels' plain
versions run): reports, output arrays and ``_outputs_checksum`` must be
equal across node counts that cross three buckets. The cases of
tests/test_plan.py and tests/test_plan_cache.py that touch no JAX
internals are mirrored against the port.
"""

import contextlib
import io
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager.k8s.objects import make_node  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.graft_entry import entry  # noqa: E402
from tpu_cc_manager_torch.kernels import fleet_tick as KF  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
CPU = "cpu"


def _same_arrays(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want), VERSIONS)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype, VERSIONS)
        assert np.array_equal(g, w), (
            f"{key} differs at {np.nonzero(g != w)[0][:10]} ({VERSIONS})")


def _same(got, want):
    assert got == want, f"port and reference differ ({VERSIONS})"


def _fleet(n, seed):
    """Seeded node dicts with the whole mix: every desired mode plus
    unset and invalid ones, every observed state, multi-host and solo
    slices, flip taints, doctor verdicts (ok, failing, malformed,
    absent) and evidence (fresh, stale, garbled, absent). Evidence ages
    stay an hour clear of the staleness threshold, so the two packages'
    tick clocks cannot disagree on it."""
    rng = np.random.default_rng(seed)
    desired = ["on", "off", "devtools", "ici", None, "garbage"]
    observed = ["on", "off", "devtools", "ici", "failed", None]
    now = int(time.time())
    nodes = []
    for i in range(n):
        labels = {}
        d = desired[rng.integers(len(desired))]
        o = observed[rng.integers(len(observed))]
        if d:
            labels[L.CC_MODE_LABEL] = d
        if o:
            labels[L.CC_MODE_STATE_LABEL] = o
        if rng.random() < 0.6:
            labels[L.TPU_SLICE_LABEL] = f"s{rng.integers(max(1, n // 4))}"
        ann = {}
        doc = rng.integers(4)
        if doc == 1:
            ann[L.DOCTOR_ANNOTATION] = json.dumps({"ok": True})
        elif doc == 2:
            ann[L.DOCTOR_ANNOTATION] = json.dumps(
                {"ok": False, "fail": ["iommu"], "at": "2026-10-01T00:00:00Z"})
        elif doc == 3:
            ann[L.DOCTOR_ANNOTATION] = "{not json"
        ev = rng.integers(4)
        if ev in (1, 2):
            age = int(rng.integers(0, 1800)) if ev == 1 else int(
                rng.integers(5400, 7200))
            ann[L.EVIDENCE_ANNOTATION] = json.dumps({"timestamp": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime(now - age))})
        elif ev == 3:
            ann[L.EVIDENCE_ANNOTATION] = "{garbled"
        node = make_node(f"node-{i:05d}", labels=labels, annotations=ann)
        if rng.random() < 0.1:
            node["spec"]["taints"] = [
                {"key": L.FLIP_TAINT_KEY, "effect": "NoSchedule"}]
        nodes.append(node)
    return nodes


def _pools(nodes, n_pools):
    modes = ["on", "off", "devtools", "ici"]
    pools = [(f"pool-{p}", modes[p % 4], nodes[p::n_pools])
             for p in range(n_pools)]
    if nodes:
        # a node listed under two pools belongs to the first
        pools[-1] = (pools[-1][0], pools[-1][1],
                     pools[-1][2] + nodes[:1])
    return pools


# --------------------------------------------------------------- parity


@pytest.mark.parametrize("n", [1, 63, 64, 65, 3000])
def test_analyze_fleet_matches_reference(n):
    nodes = _fleet(n, seed=n)
    _same(tplan.analyze_fleet(nodes, device=CPU), jplan.analyze_fleet(nodes))


@pytest.mark.parametrize("n", [1, 64, 3000])
def test_tick_outputs_checksum_and_report_match_reference(n):
    """The legacy tick over one snapshot: every output array equal, the
    same CRC from _outputs_checksum, the same report — and the port's
    encoder produces the reference's snapshot byte for byte."""
    nodes = _fleet(n, seed=100 + n)
    jenc, tenc = jplan.FleetEncoding(), tplan.FleetEncoding()
    jenc.sync(nodes)
    tenc.sync(nodes)
    jsnap, tsnap = jenc.snapshot(), tenc.snapshot()
    assert tsnap.bucket == jsnap.bucket == jplan.bucket_nodes(n)
    assert tsnap.names == jsnap.names
    assert tsnap.slice_index == jsnap.slice_index
    assert tsnap.doctor_details == jsnap.doctor_details
    _same_arrays(tsnap.columns, jsnap.columns)
    nb, pb = jsnap.bucket, jplan.BUCKET_MIN_POOLS
    target = np.zeros(pb, np.int32)
    want = jplan._tick_fn(nb, pb)(jsnap.columns, target)
    got = tplan._tick_fn(nb, pb, (torch.device(CPU),))(jsnap.columns,
                                                        target)
    _same_arrays(got, want)
    assert tplan._outputs_checksum(got) == jplan._outputs_checksum(want)
    _same(tplan._format_report(n, tsnap.names, tsnap.slice_index,
                               tsnap.doctor_details, got),
          jplan._format_report(n, jsnap.names, jsnap.slice_index,
                               jsnap.doctor_details, want))


@pytest.mark.parametrize("n", [63, 65, 3000])
def test_analyze_pools_matches_reference(n):
    nodes = _fleet(n, seed=200 + n)
    for n_pools in (3, 8):
        pools = _pools(nodes, n_pools)
        want = jplan.analyze_pools(pools)
        _same(tplan.analyze_pools(pools, device=CPU), want)
        scratch = tplan.PoolScanScratch(device=CPU)
        _same(tplan.analyze_pools(pools, scratch=scratch), want)
        _same(tplan.analyze_pools(pools, scratch=scratch), want)


def test_columns_to_block_feeds_a_jax_snapshot_to_the_port_tick():
    """Carrying state across: the reference's snapshot columns, pool
    assignment included, become the port's block and tick to the
    reference's outputs."""
    nodes = _fleet(300, seed=7)
    enc = jplan.FleetEncoding()
    enc.sync(nodes)
    snap = enc.snapshot()
    nb, n, pb = snap.bucket, snap.n_nodes, 8
    snap.columns["pool_ids"][:n] = np.arange(n) % 5
    snap.columns["pool_ids"][n:] = pb - 1
    target = np.array([1, 2, 3, 4, 1, 0, 0, 0], np.int32)
    now, stale = int(time.time()), 3600
    want = jax.jit(lambda *a: jplan.fleet_tick(
        *a, num_pools=pb, num_slices=nb))(
        *[jnp.asarray(snap.columns[k]) for k in jplan.COLS_ORDER],
        jnp.asarray(target), jnp.int32(now), jnp.int32(stale))
    block = tplan.columns_to_block(snap.columns, CPU)
    assert block.shape == (8, nb) and block.dtype == torch.int32
    got = KF.fleet_tick_block(block, torch.from_numpy(target), now, stale,
                              num_pools=pb, num_slots=nb)
    _same_arrays({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()})


def test_cli_from_file_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tplan.DEVICE_ENV, CPU)
    path = tmp_path / "nodes.json"
    path.write_text(json.dumps({"kind": "NodeList",
                                "items": _fleet(80, seed=3)}))
    assert tplan.main(["--from-file", str(path)]) == 0
    got = capsys.readouterr().out
    assert jplan.main(["--from-file", str(path)]) == 0
    assert got == capsys.readouterr().out


def test_env_selects_the_cpu_when_no_device_is_passed(monkeypatch):
    monkeypatch.setenv(tplan.DEVICE_ENV, CPU)
    assert tplan._planner_device() == torch.device(CPU)
    assert tplan.TickSession().device == torch.device(CPU)
    nodes = _fleet(10, seed=1)
    _same(tplan.analyze_fleet(nodes), jplan.analyze_fleet(nodes))
    assert tplan._planner_device("cuda") == torch.device("cuda", 0)


# ----------------------------------------- mirrors of tests/test_plan.py


def _node(name, desired=None, observed=None, slice_id=None):
    labels = {}
    if desired:
        labels[L.CC_MODE_LABEL] = desired
    if observed:
        labels[L.CC_MODE_STATE_LABEL] = observed
    if slice_id:
        labels[L.TPU_SLICE_LABEL] = slice_id
    return make_node(name, labels=labels)


def test_encode_mode():
    for value in ("on", None, "garbage", "failed", "ici"):
        assert tplan.encode_mode(value) == jplan.encode_mode(value)
    assert tplan.encode_mode("garbage") == tplan.MODE_CODES["unknown"]


def test_encode_fleet_dense_slice_ids():
    nodes = [_node("a", slice_id="s1"), _node("b", slice_id="s2"),
             _node("c", slice_id="s1"), _node("d")]
    got = tplan.encode_fleet(nodes)
    want = jplan.encode_fleet(nodes)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[3:] == want[3:]
    assert got[2][0] == got[2][2] != got[2][1]


def test_analyze_fleet_divergence_and_failures():
    nodes = [_node("ok", desired="on", observed="on"),
             _node("lagging", desired="on", observed="off"),
             _node("broken", desired="on", observed="failed"),
             _node("unlabeled")]
    report = tplan.analyze_fleet(nodes, device=CPU)
    _same(report, jplan.analyze_fleet(nodes))
    assert set(report["needs_flip"]) == {"lagging", "broken"}
    assert report["failed"] == ["broken"]


def test_analyze_fleet_slice_coherence():
    nodes = [
        _node("a0", desired="on", observed="on", slice_id="sa"),
        _node("a1", desired="on", observed="on", slice_id="sa"),
        _node("b0", desired="on", observed="on", slice_id="sb"),
        _node("b1", desired="on", observed="off", slice_id="sb"),
        _node("c0", desired="on", observed="off", slice_id="sc"),
        _node("c1", desired="off", observed="off", slice_id="sc"),
    ]
    report = tplan.analyze_fleet(nodes, device=CPU)
    _same(report, jplan.analyze_fleet(nodes))
    assert set(report["incoherent_slices"]) == {"sb", "sc"}
    assert report["half_flipped_slices"] == ["sb"]


def test_analyze_fleet_empty():
    _same(tplan.analyze_fleet([], device=CPU), jplan.analyze_fleet([]))
    _same(tplan.analyze_pools([("p", "on", [])], device=CPU),
          jplan.analyze_pools([("p", "on", [])]))


def test_graft_entry_single_device():
    """entry() on the port equals the reference's entry() output for
    output, from the same seeded example fleet."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graft_entry", "__graft_entry__.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jfn, jargs = ref.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = entry(device=CPU)
    assert all(a.device == torch.device(CPU) for a in args)
    got = fn(*args)
    _same_arrays({k: v.numpy() for k, v in got.items()},
                 {k: np.asarray(v) for k, v in want.items()})
    assert int(got["mode_counts"].sum()) == 256


def test_slice_relabel_churn_never_overflows_bucket():
    jenc, tenc = jplan.FleetEncoding(), tplan.FleetEncoding()
    for i in range(50):
        nd = _node(f"base-{i}", desired="on", observed="on")
        jenc.apply(nd)
        tenc.apply(nd)
    for round_ in range(60):
        nd = make_node("churn-node", labels={
            L.CC_MODE_LABEL: "on", L.CC_MODE_STATE_LABEL: "off",
            L.TPU_SLICE_LABEL: f"ephemeral-{round_}"})
        jenc.apply(nd)
        tenc.apply(nd)
        report = tplan.analyze_encoding(tenc, device=CPU)
        assert report["needs_flip"] == ["churn-node"]
        if round_ % 20 == 0:
            _same(report, jplan.analyze_encoding(jenc))
    snap = tenc.snapshot()
    assert all(v < tplan.bucket_nodes(snap.n_nodes)
               for v in snap.slice_index.values())


def test_analyze_pools_counts_and_failed_stays_eligible():
    def taint_node(name):
        n = _node(name, desired="on", observed="off")
        n["spec"]["taints"] = [{"key": L.FLIP_TAINT_KEY,
                                "effect": "NoSchedule"}]
        return n

    def doctor_node(name):
        n = _node(name, desired="on", observed="off")
        n["metadata"]["annotations"][L.DOCTOR_ANNOTATION] = json.dumps(
            {"ok": False, "fail": ["iommu"], "at": None})
        return n

    pools = [
        ("mixed", "on", [
            _node("m-conv", desired="on", observed="on"),
            _node("m-div", desired="off", observed="off"),
            taint_node("m-flip"), doctor_node("m-doc")]),
        ("all-failed", "on", [_node(f"f-{i}", desired="off",
                                    observed="failed") for i in range(3)]),
    ]
    stats = tplan.analyze_pools(pools, device=CPU)
    _same(stats, jplan.analyze_pools(pools))
    assert stats["mixed"] == {"nodes": 4, "converged": 1, "failed": 0,
                              "divergent": 3, "skew": 1, "eligible": 1}
    assert stats["all-failed"]["eligible"] == 3


def test_doctor_timestamp_only_republish_does_not_reencode():
    def doctored(ok, fail, at):
        n = _node("doc-n", desired="on", observed="on")
        n["metadata"]["annotations"][L.DOCTOR_ANNOTATION] = json.dumps(
            {"ok": ok, "fail": fail, "at": at})
        return n

    enc = tplan.FleetEncoding()
    assert enc.apply(doctored(True, [], "2026-08-03T00:00:00Z"))
    assert not enc.apply(doctored(True, [], "2026-08-03T00:01:00Z"))
    assert enc.apply(doctored(False, ["iommu"], "2026-08-03T00:02:00Z"))
    assert not enc.apply(doctored(False, ["iommu"], "2026-08-03T00:03:00Z"))


def test_unchanged_slice_membership_keeps_its_id():
    enc = tplan.FleetEncoding()
    enc.apply(_node("churn", desired="on", observed="off",
                    slice_id="s-stable"))
    sid_before = dict(enc._slice_index)["s-stable"]
    next_before = enc._next_slice
    for observed in ("on", "off", "on"):
        enc.apply(_node("churn", desired="on", observed=observed,
                        slice_id="s-stable"))
    assert dict(enc._slice_index)["s-stable"] == sid_before
    assert enc._next_slice == next_before


# ----------------------------------- mirrors of tests/test_plan_cache.py


def _cnode(name, slice_id=None):
    labels = {L.CC_MODE_LABEL: "on", L.CC_MODE_STATE_LABEL: "off"}
    if slice_id:
        labels[L.TPU_SLICE_LABEL] = slice_id
    return {"metadata": {"name": name, "labels": labels}}


def test_buckets_match_reference():
    for n in (0, 1, 5, 63, 64, 65, 100, 1000, 100_000, 1_000_000):
        assert tplan.bucket_nodes(n) == jplan.bucket_nodes(n)
        assert tplan.bucket_pools(n) == jplan.bucket_pools(n)
        assert tplan.bucket_deltas(n) == jplan.bucket_deltas(n)
    assert tplan.bucket_nodes(64) == 128
    assert tplan.bucket_pools(8) == 16


def test_node_count_drift_within_bucket_never_rebuilds():
    tplan.analyze_fleet([_cnode("seed-0")], device=CPU)
    base = tplan.TRACE_COUNTS.get("fleet_tick", 0)
    for n in (1, 2, 17, 40, 63):
        report = tplan.analyze_fleet([_cnode(f"d{n}-{i}") for i in range(n)],
                                     device=CPU)
        assert report["nodes"] == n
    assert tplan.TRACE_COUNTS.get("fleet_tick", 0) == base


def test_bucket_step_builds_exactly_once():
    tplan.analyze_fleet([_cnode("seed-1")], device=CPU)
    base = tplan.TRACE_COUNTS.get("fleet_tick", 0)
    for n in (100, 80, 127):
        tplan.analyze_fleet([_cnode(f"s{n}-{i}") for i in range(n)],
                            device=CPU)
    assert tplan.TRACE_COUNTS.get("fleet_tick", 0) - base <= 1


def test_pool_batch_shares_the_bucketed_kernel():
    pools = [(f"pool-{p}", "on", [_cnode(f"p{p}-{i}") for i in range(4)])
             for p in range(7)]
    tplan.analyze_pools(pools[:1], device=CPU)
    base = tplan.TRACE_COUNTS.get("fleet_tick", 0)
    for n_pools in (1, 2, 3, 5, 7):
        assert len(tplan.analyze_pools(pools[:n_pools], device=CPU)) == n_pools
    assert tplan.TRACE_COUNTS.get("fleet_tick", 0) == base


def test_warmup_launches_every_geometry_of_the_ladder():
    timings = tplan.warmup(max_nodes=200, device=CPU)
    assert sorted(timings) == sorted(
        f"n{nb}p{pb}" for nb in (64, 128, 256) for pb in (8, 16))
    assert all(t >= 0 for t in timings.values())
    # every geometry is cached now: the same ladder builds nothing
    before = dict(tplan.TRACE_COUNTS)
    tplan.warmup(max_nodes=200, device=CPU)
    assert tplan.TRACE_COUNTS == before


def test_configure_cache_is_a_noop_and_compile_stats_keep_their_shape(
        monkeypatch, tmp_path):
    monkeypatch.delenv("TPU_CC_COMPILE_CACHE_DIR", raising=False)
    assert tplan.configure_cache() is None
    assert tplan.configure_cache(str(tmp_path / "c")) is None
    assert not (tmp_path / "c").exists()
    stats = tplan.compile_stats()
    assert set(stats) == set(jplan.compile_stats())
    assert isinstance(stats["retraces"], dict)


def test_maybe_warmup_is_opt_in(monkeypatch, caplog):
    import logging

    monkeypatch.setenv(tplan.DEVICE_ENV, CPU)
    monkeypatch.setenv("TPU_CC_WARMUP_NODES", "63")
    monkeypatch.setenv("TPU_CC_PLANNER_WARMUP", "0")
    logger = logging.getLogger("test-torch-warmup")
    with caplog.at_level(logging.INFO, logger="test-torch-warmup"):
        tplan.maybe_warmup(logger)
        assert "planner warmup" not in caplog.text
        monkeypatch.setenv("TPU_CC_PLANNER_WARMUP", "1")
        tplan.maybe_warmup(logger)
    assert "planner warmup: 2 bucket(s)" in caplog.text


def test_cli_output_is_json(tmp_path, monkeypatch):
    monkeypatch.setenv(tplan.DEVICE_ENV, CPU)
    path = tmp_path / "nodes.json"
    path.write_text(json.dumps({"items": [
        _node("x", desired="on", observed="off")]}))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tplan.main(["--from-file", str(path)]) == 0
    assert json.loads(buf.getvalue())["needs_flip"] == ["x"]


def test_concurrent_scans_build_each_geometry_once_and_agree():
    """Threads racing scans through fresh geometries: the cache builds
    each at most once and every scan returns the reference's answer."""
    import sys
    import threading

    nodes = _fleet(300, seed=11)
    pools = _pools(nodes, 9) + [(f"x{j}", "on", []) for j in range(7)]
    assert tplan.bucket_pools(len(pools)) == 32  # no other case uses it
    want = (jplan.analyze_fleet(nodes), jplan.analyze_pools(pools))
    before = tplan.TRACE_COUNTS.get("fleet_tick", 0)
    results, errors = [], []

    def scan(i):
        try:
            got = (tplan.analyze_fleet(nodes, device=CPU) if i % 2 else
                   tplan.analyze_pools(pools, device=CPU))
            results.append(got == want[i % 2 == 0])
        except Exception as e:  # collected and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=scan, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(results) == 16 and all(results)
    # at most the fleet geometry and the 32-pool geometry were new
    assert tplan.TRACE_COUNTS.get("fleet_tick", 0) - before <= 2
