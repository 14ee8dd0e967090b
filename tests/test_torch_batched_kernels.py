"""The batched forms of K3 and K2 held to the JAX planner, exactly, on the CPU.

K3 ``fleet_plan_shards`` plans a batch of shards in one launch (one CTA
per shard) and K2 ``delta_scatter_shards`` writes a delta into every
shard block of one card in one launch. On the CPU their plain versions
run: every output must equal the JAX package's ``fleet_plan_jit`` shard
by shard and its ``_scatter_fn`` on a one-device mesh (where no shard
edge is clipped), dtype included, hostile codes, slice ids and indices
included. The planner and the dry run must make one
batched call per device. The CUDA kernels run only on a card;
``chip_smoke.py --k2k3`` holds them against these plain versions there.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager_torch import graft_entry as tgraft  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.kernels import LAUNCHES, _build  # noqa: E402
from tpu_cc_manager_torch.kernels import delta_scatter as KD  # noqa: E402
from tpu_cc_manager_torch.kernels import fleet_tick as KF  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
CPU = torch.device("cpu")
META = torch.device("meta")
I32_MAX, I32_MIN = 2 ** 31 - 1, -(2 ** 31)


def _assert_same(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want), VERSIONS)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype, VERSIONS)
        assert g.shape == w.shape, (key, g.shape, w.shape, VERSIONS)
        assert np.array_equal(g, w), (
            f"{key} differs at {np.nonzero(g != w)[0][:10]} ({VERSIONS})")


# ------------------------------------------------------------------ K3


def _hostile_shard(n, s, rng):
    """Codes in range and out (-7, -1, N_MODES, 99), slice ids in range,
    negative and past ``s`` (the int32 extremes among them)."""
    codes = np.array([-7, -1, jplan.N_MODES, 99] + list(range(jplan.N_MODES)),
                     np.int32)
    desired = rng.choice(codes, n).astype(np.int32)
    observed = rng.choice(codes, n).astype(np.int32)
    slice_ids = rng.integers(-2 * s - 1, 2 * s + 1, n).astype(np.int32)
    slice_ids[:4] = [I32_MIN, I32_MAX, -1, s][:n]
    return desired, observed, slice_ids


@pytest.mark.parametrize("s", [1, 2, 16])
@pytest.mark.parametrize("n", [1, 8, 257])
@pytest.mark.parametrize("shards", [1, 2, 8])
def test_fleet_plan_shards_matches_jax_shard_by_shard(shards, n, s):
    rng = np.random.default_rng(1000 * shards + 10 * n + s)
    host = [_hostile_shard(n, s, rng) for _ in range(shards)]
    cols = [tuple(torch.from_numpy(a) for a in shard) for shard in host]
    partial = torch.full((shards, jplan.N_MODES), -1, dtype=torch.int32)
    plain = KF.fleet_plan_shards_reference(cols, num_slices=s)
    got = KF.fleet_plan_shards(cols, num_slices=s, mode_counts=partial)
    assert len(plain) == len(got) == shards
    for i, (d, o, sl) in enumerate(host):
        want = jplan.fleet_plan_jit(jnp.asarray(d), jnp.asarray(o),
                                    jnp.asarray(sl), num_slices=s)
        want = {k: np.asarray(v) for k, v in want.items()}
        _assert_same({k: v.numpy() for k, v in plain[i].items()}, want)
        _assert_same({k: v.numpy() for k, v in got[i].items()}, want)
        assert np.array_equal(partial[i].numpy(), want["mode_counts"])


def test_fleet_plan_shards_fills_the_callers_partial_rows_in_place():
    """The mode histograms land in the rows of the caller's buffer (what
    K4's ``mesh_sum`` reads), and the outputs are those rows."""
    rng = np.random.default_rng(7)
    cols = [tuple(torch.from_numpy(a) for a in _hostile_shard(8, 2, rng))
            for _ in range(3)]
    partial = torch.zeros((3, jplan.N_MODES), dtype=torch.int32)
    out = KF.fleet_plan_shards(cols, num_slices=2, mode_counts=partial)
    for i, plan_i in enumerate(out):
        assert plan_i["mode_counts"].data_ptr() == partial[i].data_ptr()
        assert torch.equal(plan_i["mode_counts"], KF.fleet_plan_reference(
            *cols[i], num_slices=2)["mode_counts"])


def test_fleet_plan_is_the_batch_of_one():
    rng = np.random.default_rng(8)
    cols = tuple(torch.from_numpy(a) for a in _hostile_shard(100, 7, rng))
    before = dict(LAUNCHES)
    got = KF.fleet_plan(*cols, num_slices=7)
    _assert_same({k: v.numpy() for k, v in got.items()},
                 {k: v.numpy() for k, v in KF.fleet_plan_shards(
                     [cols], num_slices=7)[0].items()})
    assert LAUNCHES == before  # the plain version counts nothing


@pytest.mark.parametrize("n,s,route", [
    (1, 1, "cta"),
    (256, 16, "cta"),
    (KF.MAX_PLAN_ROWS, 16, "cta"),
    (KF.MAX_PLAN_ROWS + 1, 16, "k1"),
    (256, KF.MAX_PLAN_SLOTS, "cta"),
    (256, KF.MAX_PLAN_SLOTS + 1, "k1"),
    (KF.MAX_PLAN_ROWS, KF.MAX_PLAN_SLOTS, "cta"),
    (KF.MAX_PLAN_ROWS + 1, KF.MAX_PLAN_SLOTS + 1, "k1"),
])
def test_plan_route_at_and_past_both_limits(n, s, route):
    assert KF._plan_route(n, s) == route


def test_plan_limits_match_the_kernel():
    """The one-CTA kernel keeps 6 int32 per slot and 12 more in shared
    memory, which must fit the CTA's 232,448 bytes at MAX_PLAN_SLOTS and
    not one slot more; its parameter table and shard cap are the
    wrapper's."""
    def smem(s):
        return 4 * (6 * s + 2 * KF.N_MODES)

    assert smem(KF.MAX_PLAN_SLOTS) <= KF.SMEM_LIMIT_BYTES
    assert smem(KF.MAX_PLAN_SLOTS + 1) > KF.SMEM_LIMIT_BYTES
    src = (_build.CSRC_DIR / "fleet_plan.cu").read_text()
    assert f"kMaxShards = {KF.MAX_PLAN_SHARDS};" in src
    assert f"kTableFields = {KF.PLAN_TABLE_FIELDS};" in src
    for line in ("kModes = 6;", "kUnknown = 0;", "kFailed = 5;"):
        assert line in src
    assert KF.MAX_PLAN_SHARDS == tplan.BUCKET_MIN_NODES
    assert "fleet_plan.cu" in _build.SOURCES


# ------------------------------------------------------------------ K2


def _shard_delta(nb, shards, kb, seed):
    """Indices that hit every shard's first and last row, a few random
    rows, indices no shard owns (negatives, the int32 extremes, past
    nb) and the padding index nb; values drawn from a seed."""
    rng = np.random.default_rng(seed)
    rows = nb // shards
    edges = np.array(sorted({r for i in range(shards)
                             for r in (i * rows, (i + 1) * rows - 1)}),
                     np.int32)
    rest = np.setdiff1d(np.arange(nb, dtype=np.int32), edges)
    live = np.concatenate([edges, rng.choice(rest, 5, replace=False)])
    idx = np.full(kb, nb, np.int32)
    idx[:live.size] = rng.permutation(live)
    idx[live.size:live.size + 5] = [-1, -nb, I32_MIN, I32_MAX, nb + 3]
    vals = rng.integers(-50, 50, (8, kb)).astype(np.int32)
    base = rng.integers(-50, 50, (8, nb)).astype(np.int32)
    return base, idx, vals, live


def _split(base, shards):
    rows = base.shape[1] // shards
    return [torch.from_numpy(base[:, i * rows:(i + 1) * rows].copy())
            for i in range(shards)]


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_delta_scatter_shards_matches_the_loop_and_jax(monkeypatch, shards):
    nb, kb = 64, 64
    base, idx, vals, live = _shard_delta(nb, shards, kb, seed=shards)
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)

    plain = _split(base, shards)
    KD.delta_scatter_shards_reference(plain, t_idx, t_vals, nb)
    loop = _split(base, shards)
    for i, block in enumerate(loop):
        KD.delta_scatter_reference(block, t_idx, t_vals,
                                   row0=i * (nb // shards))
    got = _split(base, shards)
    KD.delta_scatter_shards(got, t_idx, t_vals, nb)
    for a, b, c in zip(plain, loop, got):
        assert torch.equal(a, b) and torch.equal(a, c)

    whole = torch.cat(got, dim=1).numpy()
    expect = base.copy()
    order = {int(r): j for j, r in enumerate(idx[:live.size])}
    for r in live:
        expect[:, r] = vals[:, order[int(r)]]
    assert np.array_equal(whole, expect)

    # the reference on a one-device mesh, where no shard edge is clipped;
    # its one shard still clips a negative index onto row 0 and the
    # padding onto row nb - 1 (rewriting their old values over a real
    # update), so those two rows are left out of the delta it is held to
    jidx = np.where(np.isin(idx, [0, nb - 1]), nb, idx).astype(np.int32)
    monkeypatch.setenv(tplan.MESH_ENV, "1")
    monkeypatch.setattr(jplan, "_SCATTER_CACHE", {})
    shard = jplan._mesh_env()[5]
    cols = tuple(jax.device_put(base[j].copy(), shard) for j in range(8))
    want = np.stack([np.asarray(c) for c in
                     jplan._scatter_fn(nb, kb)(cols, jidx, vals)])
    port = _split(base, shards)
    KD.delta_scatter_shards(port, torch.from_numpy(jidx), t_vals, nb)
    assert np.array_equal(torch.cat(port, dim=1).numpy(), want), VERSIONS
    assert not np.array_equal(want, base)


def test_delta_scatter_shards_takes_the_shards_it_is_given():
    """A launch over some of the shards (those on one card) writes only
    their rows; the rows of shards elsewhere are left to their card."""
    nb, shards, kb = 64, 8, 64
    base, idx, vals, _ = _shard_delta(nb, shards, kb, seed=3)
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    whole = _split(base, shards)
    KD.delta_scatter_shards(whole, t_idx, t_vals, nb)
    ids = [1, 3, 6]
    some = [_split(base, shards)[i] for i in ids]
    KD.delta_scatter_shards(some, t_idx, t_vals, nb, shard_ids=ids)
    for block, i in zip(some, ids):
        assert torch.equal(block, whole[i])


def test_one_block_delta_scatter_is_the_table_of_one():
    nb, kb = 64, 64
    base, idx, vals, _ = _shard_delta(nb, 4, kb, seed=4)
    t_idx, t_vals = torch.from_numpy(idx), torch.from_numpy(vals)
    want = _split(base, 4)
    KD.delta_scatter_shards(want, t_idx, t_vals, nb)
    for i in range(4):
        block = _split(base, 4)[i]
        KD.delta_scatter(block, t_idx, t_vals, row0=16 * i)
        assert torch.equal(block, want[i])


# ----------------------------------------------- one call per device


def _spy(monkeypatch, module, name, calls, run_on_cpu=True):
    real = getattr(module, name)

    def spy(*args, **kw):
        devices = {t.device for t in _tensors(args)}
        calls.append((devices, kw))
        if run_on_cpu and devices == {CPU}:
            return real(*args, **kw)
        return None

    monkeypatch.setattr(module, name, spy)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from _tensors(item)


@pytest.mark.parametrize("devices", [
    (CPU,), (CPU,) * 8, (CPU, META) * 2, (CPU, META) * 4,
], ids=["1_shard", "8_shards_one_device", "2_shards_per_device",
        "4_shards_per_device"])
def test_scatter_fn_makes_one_batched_call_per_device(monkeypatch, devices):
    shards = len(devices)
    nb, kb = 64, 64
    base, idx, vals, _ = _shard_delta(nb, shards, kb, seed=10 + shards)
    blocks = [b.to(dev) for b, dev in zip(_split(base, shards), devices)]
    calls = []
    _spy(monkeypatch, tplan, "delta_scatter_shards", calls)
    monkeypatch.setattr(tplan, "_SCATTER_CACHE", {})
    tplan._scatter_fn(nb, kb, devices)(blocks, idx, vals)
    assert [d for d, _ in calls] == [{dev} for dev in dict.fromkeys(devices)]
    assert [kw["shard_ids"] for _, kw in calls] == [
        [i for i, d in enumerate(devices) if d == dev]
        for dev in dict.fromkeys(devices)]
    want = _split(base, shards)
    KD.delta_scatter_shards_reference(want, torch.from_numpy(idx),
                                      torch.from_numpy(vals), nb)
    for block, w, dev in zip(blocks, want, devices):
        if dev == CPU:
            assert torch.equal(block, w)


def test_by_device_groups_shards_in_order():
    assert tplan._by_device([CPU, META, CPU, META, CPU]) == {
        CPU: [0, 2, 4], META: [1, 3]}
    assert list(tplan._by_device([META, CPU])) == [META, CPU]


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_plans_one_batch_per_device(monkeypatch, n):
    batches, singles = [], []
    _spy(monkeypatch, tgraft, "fleet_plan_shards", batches)
    _spy(monkeypatch, tgraft, "fleet_plan", singles)
    needs_flip, mode_counts, coherent = tgraft.dryrun_multichip(n, "cpu")
    assert len(batches) == 1 and len(singles) == 1
    assert "mode_counts" in batches[0][1]  # written into the partial rows
    d, o, _ = (np.asarray(t) for t in tgraft._example_fleet(
        8 * n, 1, seed=1, device=CPU))
    local = np.repeat(np.arange(2, dtype=np.int32), 4)
    ids = np.concatenate([local + 2 * i for i in range(n)])
    ref = jplan.fleet_plan_jit(jnp.asarray(d), jnp.asarray(o),
                               jnp.asarray(ids), num_slices=2 * n)
    assert np.array_equal(needs_flip, np.asarray(ref["needs_flip"]))
    assert np.array_equal(mode_counts, np.asarray(ref["mode_counts"]))
    shard_coherent = np.concatenate([np.asarray(jplan.fleet_plan_jit(
        jnp.asarray(d[8 * i:8 * i + 8]), jnp.asarray(o[8 * i:8 * i + 8]),
        jnp.asarray(local), num_slices=2)["slice_coherent"])
        for i in range(n)])
    assert np.array_equal(coherent, shard_coherent), VERSIONS


def test_dryrun_multichip_takes_the_meshs_shard_counts():
    with pytest.raises(ValueError, match="1 to 64"):
        tgraft.dryrun_multichip(65, "cpu")
    with pytest.raises(ValueError, match="1 to 64"):
        tgraft.dryrun_multichip(0, "cpu")


# -------------------------------------------- what the wrappers refuse


def _k3_cols(n=8):
    return tuple(torch.zeros(n, dtype=torch.int32) for _ in range(3))


def _k3_case(name):
    d, o, s = _k3_cols()
    cases = {
        "too_many_shards": (([(d, o, s)] * 65,), {}, "1 to 64"),
        "no_shards": (([],), {}, "1 to 64"),
        "int64_column": (([(d.long(), o, s)],), {}, "int32"),
        "two_dimensional": (([(d.view(2, 4), o, s)],), {}, "int32"),
        "strided_column": (([(torch.zeros(16, dtype=torch.int32)[::2], o,
                              s)],), {}, "contiguous"),
        "unequal_lengths": (([(d, o[:4], s)],), {}, "int32"),
        "columns_on_two_devices": (([(d, o.to(META), s)],), {}, "meta"),
        "shards_on_two_devices": (
            ([(d, o, s), tuple(t.to(META) for t in (d, o, s))],), {},
            "meta"),
        "mode_counts_shape": (
            ([(d, o, s)],), {"mode_counts": torch.zeros(
                (2, KF.N_MODES), dtype=torch.int32)}, "mode_counts"),
        "mode_counts_dtype": (
            ([(d, o, s)],), {"mode_counts": torch.zeros(
                (1, KF.N_MODES), dtype=torch.int64)}, "mode_counts"),
        "no_slots": (([(d, o, s)],), {"num_slices": 0}, "num_slices"),
        "no_kernel_for_meta": (
            ([tuple(t.to(META) for t in (d, o, s))],), {}, "no kernel"),
    }
    return cases[name]


@pytest.mark.parametrize("name", [
    "too_many_shards", "no_shards", "int64_column", "two_dimensional",
    "strided_column", "unequal_lengths", "columns_on_two_devices",
    "shards_on_two_devices", "mode_counts_shape", "mode_counts_dtype",
    "no_slots", "no_kernel_for_meta"])
def test_fleet_plan_shards_rejects_what_the_kernel_does_not_take(name):
    args, kw, match = _k3_case(name)
    kw = {"num_slices": 2, **kw}
    with pytest.raises(ValueError, match=re.escape(match)):
        KF.fleet_plan_shards(*args, **kw)


def _k2_case(name):
    blocks = [torch.zeros((8, 16), dtype=torch.int32) for _ in range(4)]
    idx = torch.zeros(4, dtype=torch.int32)
    vals = torch.zeros((8, 4), dtype=torch.int32)
    nb = 64
    cases = {
        "unequal_widths": ((blocks[:3] + [torch.zeros(
            (8, 8), dtype=torch.int32)], idx, vals, nb), {}, "unequal width"),
        "blocks_on_two_devices": ((blocks[:3] + [blocks[3].to(META)], idx,
                                   vals, nb), {}, "one launch serves one"),
        "operands_elsewhere": ((blocks, idx.to(META), vals, nb), {},
                               "idx on meta"),
        "too_many_shards": (([torch.zeros((8, 1), dtype=torch.int32)] * 65,
                             idx, vals, 65), {}, "1 to 64 shards"),
        "no_blocks": (([], idx, vals, nb), {}, "1 to 64 shards"),
        "strided_block": (([torch.zeros((16, 8), dtype=torch.int32).t()],
                           idx, vals, 16), {}, "contiguous"),
        "int64_block": (([b.long() for b in blocks], idx, vals, nb), {},
                        "int32"),
        "int64_idx": ((blocks, idx.long(), vals, nb), {}, "idx"),
        "vals_shape": ((blocks, idx, vals[:, :3].contiguous(), nb), {},
                       "vals"),
        "nb_not_whole_shards": ((blocks, idx, vals, 60), {}, "nb=60"),
        "nb_past_64_shards": ((blocks, idx, vals, 16 * 65), {}, "nb=1040"),
        "repeated_shard": ((blocks, idx, vals, nb), {
            "shard_ids": [0, 1, 1, 2]}, "shard_ids"),
        "shard_past_nb": ((blocks, idx, vals, nb), {
            "shard_ids": [0, 1, 2, 4]}, "shard_ids"),
        "no_kernel_for_meta": (([b.to(META) for b in blocks], idx.to(META),
                                vals.to(META), nb), {}, "no kernel"),
    }
    return cases[name]


@pytest.mark.parametrize("name", [
    "unequal_widths", "blocks_on_two_devices", "operands_elsewhere",
    "too_many_shards", "no_blocks", "strided_block", "int64_block",
    "int64_idx", "vals_shape", "nb_not_whole_shards", "nb_past_64_shards",
    "repeated_shard", "shard_past_nb", "no_kernel_for_meta"])
def test_delta_scatter_shards_rejects_what_the_kernel_does_not_take(name):
    args, kw, match = _k2_case(name)
    with pytest.raises(ValueError, match=re.escape(match)):
        KD.delta_scatter_shards(*args, **kw)


# ---------------------------------------------------------------- build


def test_build_digest_covers_the_included_header(monkeypatch, tmp_path):
    """fleet_tick.cu and fleet_plan.cu include warp_runs.cuh: an edit of
    the header alone must build afresh."""
    for name in _build.SOURCES + _build.HEADERS:
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = _build.source_digest()
    with open(tmp_path / "warp_runs.cuh", "a") as f:
        f.write("\n")
    assert _build.source_digest() != before
    for name in ("fleet_tick.cu", "fleet_plan.cu"):
        assert '#include "warp_runs.cuh"' in (
            _build.CSRC_DIR / name).read_text()
