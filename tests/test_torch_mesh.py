"""The port's sharded planner and K4 held to the JAX planner's mesh, exactly.

The reference shards every tick over its 8-device virtual CPU mesh
(``shard_map`` with ``psum``/``pmin``/``pmax``). The port splits the rows
into S shards (``TPU_CC_PLANNER_MESH``), runs K1's partial form on each
and combines the partials with K4; on the CPU the kernels' plain
versions run. Every output array must equal the reference's bit for bit,
padding slots included, at S = 1, 2, 4 and 8. The CUDA kernels run only
on a card; ``chip_smoke.py`` holds them against these plain versions
there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as jgraft  # noqa: E402
from test_torch_kernels import NOW, _columns, _hostile_columns  # noqa: E402
from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager_torch import graft_entry as tgraft  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.kernels import LAUNCHES  # noqa: E402
from tpu_cc_manager_torch.kernels import fleet_tick as KF  # noqa: E402
from tpu_cc_manager_torch.kernels import mesh_combine as KM  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
CPU = torch.device("cpu")
I32_MAX, I32_MIN = 2 ** 31 - 1, -(2 ** 31)


def _assert_same(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want), VERSIONS)
    for key in want:
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype, VERSIONS)
        assert g.shape == w.shape, (key, g.shape, w.shape, VERSIONS)
        assert np.array_equal(g, w), (
            f"{key} differs at {np.nonzero(g != w)[0][:10]} ({VERSIONS})")


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages read the tick clock with time.time(): one value for
    both, so stale_evidence compares exactly on hostile timestamps."""
    monkeypatch.setattr("time.time", lambda: float(NOW))


def _reference_tick(monkeypatch, cols, target, nb, pb):
    """The reference's sharded tick on its 8-device CPU mesh."""
    monkeypatch.setenv(tplan.MESH_ENV, "8")
    assert len(jplan._planner_devices()) == 8
    return jplan._tick_fn(nb, pb)(cols, target)


def _port_tick(monkeypatch, cols, target, nb, pb, shards):
    monkeypatch.setenv(tplan.MESH_ENV, str(shards))
    mesh = tplan._planner_mesh(CPU)
    assert len(mesh) == shards
    return tplan._tick_fn(nb, pb, mesh)(cols, target)


# ------------------------------------------------------- the sharded tick


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("nb,pb", [(64, 8), (1024, 16)])
def test_sharded_tick_matches_the_reference_mesh(monkeypatch, frozen_clock,
                                                 shards, nb, pb):
    cols = _columns(nb, pb, seed=nb + shards)
    target = np.random.default_rng(pb).integers(
        0, jplan.N_MODES, pb).astype(np.int32)
    want = _reference_tick(monkeypatch, cols, target, nb, pb)
    got = _port_tick(monkeypatch, cols, target, nb, pb, shards)
    assert len(want) == 17
    _assert_same(got, want)
    # the padding slot folds every padding row in (they all sit in the
    # last shard) and reads coherent; an empty slot keeps the identities
    assert got["slice_coherent"][nb - 1] and not got["slice_coherent"][1]


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("nb,pb", [(64, 8), (1024, 16)])
def test_sharded_tick_keeps_jax_index_rules_per_shard(monkeypatch,
                                                      frozen_clock, shards,
                                                      nb, pb):
    """Negative ids wrap against the GLOBAL widths, out-of-range ones drop
    from the scatters, the pool gather clamps — in every shard as in the
    unsharded tick."""
    cols = _hostile_columns(nb, pb, seed=nb + 7 * shards)
    target = np.random.default_rng(shards).integers(
        -3, 9, pb).astype(np.int32)
    _assert_same(_port_tick(monkeypatch, cols, target, nb, pb, shards),
                 _reference_tick(monkeypatch, cols, target, nb, pb))


def test_a_mesh_tick_runs_partials_and_one_combine_never_the_full_tick(
        monkeypatch):
    """With S > 1 no code takes the unsharded path: S partial launches,
    one combine, no full K1."""
    calls = []
    for name in ("fleet_tick_partial", "mesh_combine", "fleet_tick_block"):
        real = getattr(tplan, name)
        monkeypatch.setattr(
            tplan, name,
            lambda *a, _real=real, _name=name, **kw: (
                calls.append(_name), _real(*a, **kw))[1])
    cols = _columns(128, 8, seed=3)
    _port_tick(monkeypatch, cols, np.zeros(8, np.int32), 128, 8, 4)
    assert calls == ["fleet_tick_partial"] * 4 + ["mesh_combine"]
    calls.clear()
    _port_tick(monkeypatch, cols, np.zeros(8, np.int32), 128, 8, 1)
    assert calls == ["fleet_tick_block"]


def test_a_mesh_tick_launches_every_partial_before_the_copies(monkeypatch):
    """The stage marks a timer hangs on the sharded tick come in the
    path's order: every shard's partial, then the copies, then K4."""
    assert tplan.MESH_MARK is None
    calls = []
    for name in ("fleet_tick_partial", "mesh_combine"):
        real = getattr(tplan, name)
        monkeypatch.setattr(
            tplan, name,
            lambda *a, _real=real, _name=name, **kw: (
                calls.append(_name), _real(*a, **kw))[1])
    monkeypatch.setattr(tplan, "MESH_MARK", lambda stage, cards: calls.append(
        (stage, cards)))
    _port_tick(monkeypatch, _columns(128, 8, seed=4), np.zeros(8, np.int32),
               128, 8, 4)
    assert calls == ([("start", (CPU,))] + ["fleet_tick_partial"] * 4
                     + [("partials", (CPU,)), ("copies", (CPU,)),
                        "mesh_combine", ("combine", (CPU,))])


def test_planner_mesh_counts_rounds_clamps_and_places_shards(monkeypatch):
    monkeypatch.delenv(tplan.MESH_ENV, raising=False)
    assert tplan._planner_mesh(CPU) == (CPU,)
    for env, want in (("1", 1), ("3", 2), ("8", 8), ("100", 64),
                      ("0", 1), ("junk", 1)):
        monkeypatch.setenv(tplan.MESH_ENV, env)
        assert tplan._planner_mesh(CPU) == (CPU,) * want, env
    # on cards: shard i on card (index + i) % cards, sharing past the count
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setenv(tplan.MESH_ENV, "8")
    assert [d.index for d in tplan._planner_mesh("cuda:0")] == [
        0, 1, 2, 0, 1, 2, 0, 1]
    assert [d.index for d in tplan._planner_mesh("cuda:2")][:3] == [2, 0, 1]
    monkeypatch.setenv(tplan.MESH_ENV, "3")
    assert [d.index for d in tplan._planner_mesh("cuda:1")] == [1, 2]
    # the mesh is opt-in: unset, one shard however many cards are visible
    monkeypatch.delenv(tplan.MESH_ENV)
    assert tplan._planner_mesh("cuda:0") == (torch.device("cuda", 0),)


def test_columns_to_shards_splits_rows_in_order():
    cols = _columns(64, 8, seed=1)
    shards = tplan.columns_to_shards(cols, (CPU,) * 4)
    assert [tuple(b.shape) for b in shards] == [(8, 16)] * 4
    assert all(b.is_contiguous() for b in shards)
    whole = tplan.columns_to_block(cols, CPU)
    assert torch.equal(torch.cat(shards, dim=1), whole)


# ------------------------------------------------------------------ K4


def _partials(shards, pb, ns, seed):
    """Partials as S shards leave them: counts near the int32 edges (the
    sums wrap), and slot rows where every shard, some shards or no shard
    touched a slot (untouched = the identities)."""
    rng = np.random.default_rng(seed)
    m = KF.counts_len(pb)
    counts = rng.integers(-1000, 1000, (shards, m)).astype(np.int32)
    counts[:, 0] = I32_MAX - 3
    slots = np.empty((shards, 6, ns), np.int32)
    slots[:, 0] = rng.integers(-4, 8, (shards, ns))
    slots[:, 1] = slots[:, 0] + rng.integers(0, 2, (shards, ns))
    slots[:, 2] = rng.integers(-4, 8, (shards, ns))
    slots[:, 3] = slots[:, 2] + rng.integers(0, 2, (shards, ns))
    slots[:, 4] = rng.integers(0, 2, (shards, ns))
    slots[:, 5] = np.maximum(slots[:, 4], rng.integers(0, 2, (shards, ns)))
    untouched = rng.random((shards, ns)) < 0.4
    untouched[:, : ns // 8] = True  # slots no shard touched
    for row, ident in enumerate((I32_MAX, I32_MIN, I32_MAX, I32_MIN, 1, 0)):
        slots[:, row][untouched] = ident
    return counts, slots


def _numpy_combine(counts, slots, pb):
    summed = counts.astype(np.int64).sum(axis=0).astype(np.int32)
    mn, mx = slots.min(axis=0), slots.max(axis=0)
    h = 2 * jplan.N_MODES
    nodes = summed[h:h + pb]
    conv = summed[h + pb:h + 2 * pb]
    hist = summed[h + 4 * pb:h + 10 * pb].reshape(pb, jplan.N_MODES)
    agree = mn[0] == mx[1]
    return {
        "mode_counts": summed[:6], "desired_counts": summed[6:12],
        "pool_nodes": nodes, "pool_converged": conv,
        "pool_failed": summed[h + 2 * pb:h + 3 * pb],
        "pool_eligible": summed[h + 3 * pb:h + 4 * pb],
        "pool_skew": (nodes - hist.max(axis=1)).astype(np.int32),
        "pool_divergent": (nodes - conv).astype(np.int32),
        "slice_coherent": agree & (mn[2] == mx[3]),
        "slice_half_flipped": agree & (mn[4] == 0) & (mx[5] == 1),
    }


@pytest.mark.parametrize("shards,pb,ns", [(1, 8, 64), (2, 8, 64),
                                          (8, 8, 1024), (8, 16, 128)])
def test_mesh_combine_plain_version_matches_numpy(shards, pb, ns):
    counts, slots = _partials(shards, pb, ns, seed=shards * ns + pb)
    want = _numpy_combine(counts, slots, pb)
    before = dict(LAUNCHES)
    got = KM.mesh_combine(torch.from_numpy(counts), torch.from_numpy(slots),
                          num_pools=pb)
    _assert_same({k: v.numpy() for k, v in got.items()}, want)
    _assert_same({k: v.numpy() for k, v in KM.mesh_combine_reference(
        torch.from_numpy(counts), torch.from_numpy(slots),
        num_pools=pb).items()}, want)
    assert want["mode_counts"][0] == np.int32(
        (shards * (I32_MAX - 3) + 2 ** 31) % 2 ** 32 - 2 ** 31)
    assert not want["slice_coherent"][: ns // 8].any()  # untouched slots
    sums = KM.mesh_sum(torch.from_numpy(counts)).numpy()
    assert np.array_equal(sums, counts.astype(np.int64).sum(0).astype(
        np.int32))
    assert LAUNCHES == before  # the plain versions count nothing


def test_partials_combine_to_the_unsharded_tick():
    """K1's partial form over S row ranges, combined, equals K1 over the
    whole block: the identity every mesh path rests on."""
    nb, pb = 256, 8
    cols = _hostile_columns(nb, pb, seed=11)
    block = tplan.columns_to_block(cols, CPU)
    target = torch.from_numpy(np.arange(pb, dtype=np.int32) - 2)
    want = KF.fleet_tick_reference(block, target, NOW, 3600, num_pools=pb,
                                   num_slots=nb)
    shards = 4
    counts = torch.empty((shards, KF.counts_len(pb)), dtype=torch.int32)
    slots = torch.empty((shards, 6, nb), dtype=torch.int32)
    masks = [KF.fleet_tick_partial(
        b.contiguous(), target, NOW, 3600, num_pools=pb, num_slots=nb,
        counts=counts[i], slots=slots[i])
        for i, b in enumerate(block.split(nb // shards, dim=1))]
    got = KM.mesh_combine(counts, slots, num_pools=pb)
    mask = torch.cat(masks, dim=1)
    got.update({key: mask[j] for j, key in enumerate(KF.MASK_KEYS)})
    _assert_same({k: v.numpy() for k, v in got.items()},
                 {k: v.numpy() for k, v in want.items()})


def test_mesh_combine_rejects_what_the_kernel_does_not_take():
    counts = torch.zeros((2, KF.counts_len(8)), dtype=torch.int32)
    slots = torch.zeros((2, 6, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="counts"):
        KM.mesh_combine(counts[:, :-1].contiguous(), slots, num_pools=8)
    with pytest.raises(ValueError, match="slots"):
        KM.mesh_combine(counts, slots.long(), num_pools=8)
    with pytest.raises(ValueError, match="S >= 1"):
        KM.mesh_combine(counts[:1], slots, num_pools=8)
    with pytest.raises(ValueError, match="no kernel"):
        KM.mesh_combine(counts.to("meta"), slots.to("meta"), num_pools=8)
    with pytest.raises(ValueError, match="no kernel"):
        KM.mesh_sum(counts.to("meta"))
    with pytest.raises(ValueError, match="partials"):
        KM.mesh_sum(counts[0])
    with pytest.raises(ValueError, match="counts"):
        KF.fleet_tick_partial(
            torch.zeros((8, 32), dtype=torch.int32),
            torch.zeros(8, dtype=torch.int32), 0, 0, num_pools=8,
            num_slots=64, counts=counts[0, :-1], slots=slots[0])


# ------------------------------------------------- the mesh scatter


def _edge_delta(nb, shards, seed):
    """A padded delta block hitting the last row of every shard: at
    nb = 64 and S = 8, rows 7, 15, ..., 63."""
    rows_local = nb // shards
    edge = np.arange(rows_local - 1, nb, rows_local, dtype=np.int32)
    kb = jplan.bucket_deltas(edge.size)
    idx = np.full(kb, nb, np.int32)
    idx[:edge.size] = edge
    vals = np.random.default_rng(seed).integers(
        0, jplan.N_MODES, (8, kb)).astype(np.int32)
    vals[7] = 1  # the changed rows stay live
    return edge, idx, vals


def test_mesh_scatter_keeps_the_rows_the_reference_clip_drops(monkeypatch,
                                                               frozen_clock):
    nb, pb, shards = 64, 8, 8
    cols = _columns(nb, pb, seed=21)
    target = np.zeros(pb, np.int32)
    edge, idx, vals = _edge_delta(nb, shards, seed=22)
    assert edge.tolist() == [7, 15, 23, 31, 39, 47, 55, 63]
    vals[0, :edge.size] = (cols["desired"][edge] + 1) % jplan.N_MODES
    final = {k: v.copy() for k, v in cols.items()}
    for j, key in enumerate(jplan.COLS_ORDER):
        final[key][edge] = vals[j, :edge.size]

    # the reference's 8-device scatter leaves every edge row as it was
    monkeypatch.setenv(tplan.MESH_ENV, "8")
    jcols = tuple(jax.device_put(cols[k].copy(), jplan._mesh_env()[5])
                  for k in jplan.COLS_ORDER)
    # over the devices the columns sit on, not a cached earlier mesh
    monkeypatch.setattr(jplan, "_SCATTER_CACHE", {})
    dropped = jplan._scatter_fn(nb, idx.size)(jcols, idx, vals)
    assert np.array_equal(np.asarray(dropped[0])[edge], cols["desired"][edge])
    assert not np.array_equal(final["desired"][edge], cols["desired"][edge])
    want = _reference_tick(monkeypatch, final, target, nb, pb)

    outs = {}
    for s in (1, shards):
        monkeypatch.setenv(tplan.MESH_ENV, str(s))
        mesh = tplan._planner_mesh(CPU)
        blocks = tplan.columns_to_shards(cols, mesh)
        tplan._scatter_fn(nb, idx.size, mesh)(blocks, idx, vals)
        assert torch.equal(torch.cat(blocks, dim=1),
                           tplan.columns_to_block(final, CPU))
        outs[s] = tplan._eval_fn(nb, pb, mesh)(blocks, target, NOW, 3600)
    _assert_same(outs[shards], outs[1])
    _assert_same(outs[shards], want)


def _session_run(monkeypatch, shards, steps):
    """A port session at ``shards`` shards over a 63-node fleet, fed the
    same changes each run; the outputs after every tick."""
    monkeypatch.setenv(tplan.MESH_ENV, str(shards))
    enc = tplan.FleetEncoding()
    sess = tplan.TickSession(full_every=0, device=CPU)

    def node(i, state):
        return {"metadata": {"name": f"n{i:02d}", "labels": {
            L.CC_MODE_LABEL: "on", L.CC_MODE_STATE_LABEL: state,
            L.TPU_SLICE_LABEL: f"s{i // 4}"}}}

    nodes = {i: node(i, "on" if i % 3 else "off") for i in range(63)}
    for nd in nodes.values():
        enc.apply(nd)
    outs = []
    for rows, state, full in steps:
        for i in rows:
            nodes[i] = node(i, state)
            enc.apply(nodes[i])
        res = sess.tick(enc, force_full=full)
        outs.append((res.kind, {k: np.array(v)
                                for k, v in res.outputs.items()}))
    return outs, sess, enc, list(nodes.values())


def test_mesh_session_equals_the_unsharded_session(monkeypatch):
    """Deltas on every shard's last row (row 62 is the last live row;
    row 63 is padding), verified by forced full ticks: the 8-shard
    session's K1 partials and K4 agree with its incremental state and
    with the 1-shard session at every step."""
    edges = [7, 15, 23, 31, 39, 47, 55, 62]
    steps = [((), None, False), (edges, "failed", False),
             (edges[::2], "on", True), ((0, 8, 62), "off", False),
             ((), None, True)]
    sharded, sess8, enc, nodes = _session_run(monkeypatch, 8, steps)
    plain, sess1, _, _ = _session_run(monkeypatch, 1, steps)
    assert [k for k, _ in sharded] == ["rebuild", "incremental", "full",
                                       "incremental", "full"]
    for (k8, o8), (k1, o1) in zip(sharded, plain):
        assert k8 == k1
        _assert_same(o8, o1)
    assert sess8.stats == sess1.stats
    assert len(sess8._shards) == 8 and len(sess1._shards) == 1
    assert sess8.last_checksum == sess1.last_checksum
    # and the reference's sharded full tick over the final fleet agrees
    monkeypatch.setenv(tplan.MESH_ENV, "8")
    assert tplan.analyze_encoding(enc, sess8) == jplan.analyze_fleet(
        nodes), VERSIONS


# ---------------------------------------------------------- the dry run


@pytest.mark.parametrize("n", [1, 2, 8])
def test_dryrun_multichip_matches_the_reference(n):
    needs_flip, mode_counts, coherent = tgraft.dryrun_multichip(n, "cpu")
    # the reference's own dry run passes on its mesh
    if n <= len(jax.devices()):
        assert jgraft.dryrun_multichip(n) is None
    # the same fleet, planned by the reference unsharded (what its dry run
    # checks against) and shard by shard for the local slice verdicts
    desired, observed, _ = jgraft._example_fleet(8 * n, 1, seed=1)
    local = np.repeat(np.arange(2, dtype=np.int32), 4)
    ids = np.concatenate([local + 2 * i for i in range(n)])
    ref = jplan.fleet_plan_jit(desired, observed, jnp.asarray(ids),
                               num_slices=2 * n)
    assert np.array_equal(needs_flip, np.asarray(ref["needs_flip"]))
    assert np.array_equal(mode_counts, np.asarray(ref["mode_counts"]))
    shard_coherent = np.concatenate([np.asarray(jplan.fleet_plan_jit(
        desired[8 * i:8 * i + 8], observed[8 * i:8 * i + 8],
        jnp.asarray(local), num_slices=2)["slice_coherent"])
        for i in range(n)])
    assert np.array_equal(coherent, shard_coherent), VERSIONS
    assert int(mode_counts.sum()) == 8 * n
