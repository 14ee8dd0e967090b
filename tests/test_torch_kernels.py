"""The PyTorch port's kernels held to the JAX planner, exactly, on the CPU.

Each kernel's plain PyTorch version (what the wrapper runs for a CPU
tensor) gets the same numpy-seeded inputs as its JAX counterpart and must
return every output array equal, dtype included: K1 ``fleet_tick``
against ``plan.fleet_tick`` jitted on the CPU, K2 ``delta_scatter``
against ``plan._scatter_fn`` on the 8-device virtual CPU mesh, K3
``fleet_plan`` against ``plan.fleet_plan``. The CUDA kernels themselves
run only on a card; ``chip_smoke.py`` holds them against these plain
versions there.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.kernels import LAUNCHES, _build  # noqa: E402
from tpu_cc_manager_torch.kernels import delta_scatter as KD  # noqa: E402
from tpu_cc_manager_torch.kernels import fleet_tick as KF  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
NOW = 1_700_000_000
STALE = 3600


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want), VERSIONS)
    for key in want:
        g, w = _np(got[key]), _np(want[key])
        assert g.dtype == w.dtype, (key, g.dtype, w.dtype, VERSIONS)
        assert g.shape == w.shape, (key, g.shape, w.shape, VERSIONS)
        assert np.array_equal(g, w), (
            f"{key} differs at {np.nonzero(g != w)[0][:10]} ({VERSIONS})")


def _columns(nb, pb, seed):
    """A padded fleet: live rows with every mode code, all-unknown rows,
    empty slice slots (only even ids used), taints, the three doctor
    codes, absent, fresh and stale evidence; padding rows as
    FleetEncoding.snapshot pads them (pool slot pb - 1 as the policy
    path pads)."""
    rng = np.random.default_rng(seed)
    n = nb * 3 // 4
    cols = {key: np.zeros(nb, np.int32) for key in jplan.COLS_ORDER}
    cols["desired"][:n] = rng.integers(0, jplan.N_MODES, n)
    cols["observed"][:n] = rng.integers(0, jplan.N_MODES, n)
    unknown = rng.random(n) < 0.1
    cols["desired"][:n][unknown] = 0
    cols["observed"][:n][unknown] = 0
    cols["slice_ids"][:] = nb - 1
    cols["slice_ids"][:n] = 2 * rng.integers(0, max(1, n // 6), n)
    cols["pool_ids"][:] = pb - 1
    cols["pool_ids"][:n] = rng.integers(0, pb - 1, n)
    cols["taint"][:n] = rng.random(n) < 0.1
    cols["doctor"][:n] = rng.integers(0, 3, n)
    cols["ev_ts"][:] = -1
    ages = rng.integers(0, 7200, n)
    cols["ev_ts"][:n] = np.where(rng.random(n) < 0.2, -1, NOW - ages)
    cols["valid"][:n] = 1
    return cols


def _hostile_columns(nb, pb, seed):
    """Codes and indices past their ranges, negatives included: the
    plain version must keep JAX's index rules (scatter drops, gather
    clamps, a negative index counts once from the end)."""
    rng = np.random.default_rng(seed)
    cols = {
        "desired": rng.integers(-8, 9, nb),
        "observed": rng.integers(-8, 9, nb),
        "slice_ids": rng.integers(-2 * nb, 2 * nb, nb),
        "pool_ids": rng.integers(-2 * pb, 2 * pb, nb),
        "taint": rng.integers(-2, 3, nb),
        "doctor": rng.integers(-1, 4, nb),
        "ev_ts": rng.integers(-5, NOW + 10_000, nb),
        "valid": rng.integers(-2, 4, nb),
    }
    cols = {k: v.astype(np.int32) for k, v in cols.items()}
    cols["slice_ids"][:4] = [-(2 ** 31), 2 ** 31 - 1, -1, nb]
    return cols


@functools.lru_cache(maxsize=None)
def _jax_tick_fn(pb, nb):
    return jax.jit(functools.partial(jplan.fleet_tick, num_pools=pb,
                                     num_slices=nb))


def _jax_tick(cols, pool_target, pb, nb):
    out = _jax_tick_fn(pb, nb)(
        *[jnp.asarray(cols[k]) for k in jplan.COLS_ORDER],
        jnp.asarray(pool_target), jnp.int32(NOW), jnp.int32(STALE))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_tick(cols, pool_target, pb, nb):
    return KF.fleet_tick_reference(
        tplan.columns_to_block(cols, "cpu"), torch.from_numpy(pool_target),
        NOW, STALE, num_pools=pb, num_slots=nb)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("nb", [64, 128, 1024])
@pytest.mark.parametrize("pb", [8, 16])
def test_fleet_tick_plain_version_matches_jax(nb, pb):
    cols = _columns(nb, pb, seed=nb + pb)
    target = np.random.default_rng(pb).integers(0, jplan.N_MODES, pb)
    target = target.astype(np.int32)
    want = _jax_tick(cols, target, pb, nb)
    _assert_same(_port_tick(cols, target, pb, nb), want)
    # the padding slot nb - 1 folds the padding rows in, as JAX does,
    # and reads coherent; an empty (odd) slot keeps the init values
    assert want["slice_coherent"][nb - 1]
    assert not want["slice_coherent"][1]
    assert not want["slice_half_flipped"][1]


@pytest.mark.parametrize("nb,pb", [(64, 8), (1024, 16)])
def test_fleet_tick_plain_version_keeps_jax_index_rules(nb, pb):
    cols = _hostile_columns(nb, pb, seed=nb)
    target = np.random.default_rng(3).integers(-3, 9, pb).astype(np.int32)
    _assert_same(_port_tick(cols, target, pb, nb),
                 _jax_tick(cols, target, pb, nb))


def test_fleet_tick_per_column_api_matches_block_api():
    """plan.fleet_tick (one tensor per column, the reference's
    signature) is the block wrapper over the stacked columns."""
    nb, pb = 128, 8
    cols = _columns(nb, pb, seed=5)
    target = np.full(pb, 1, np.int32)
    got = tplan.fleet_tick(
        *[torch.from_numpy(cols[k]) for k in tplan.COLS_ORDER],
        torch.from_numpy(target), torch.tensor(NOW), STALE, num_pools=pb)
    _assert_same(got, _jax_tick(cols, target, pb, nb))


def test_wrappers_run_the_plain_version_on_cpu_and_count_nothing():
    nb, pb = 64, 8
    cols = _columns(nb, pb, seed=9)
    target = np.zeros(pb, np.int32)
    before = dict(LAUNCHES)
    got = KF.fleet_tick_block(tplan.columns_to_block(cols, "cpu"),
                              torch.from_numpy(target), NOW, STALE,
                              num_pools=pb, num_slots=nb)
    _assert_same(got, _port_tick(cols, target, pb, nb))
    block = tplan.columns_to_block(cols, "cpu")
    KD.delta_scatter(block, torch.tensor([3, nb], dtype=torch.int32),
                     torch.ones((8, 2), dtype=torch.int32))
    assert LAUNCHES == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    block = torch.zeros((8, 64), dtype=torch.int32)
    target = torch.zeros(8, dtype=torch.int32)
    kw = {"num_pools": 8, "num_slots": 64}
    with pytest.raises(ValueError, match="int32"):
        KF.fleet_tick_block(block.long(), target, 0, 0, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        KF.fleet_tick_block(block.t().contiguous().t(), target, 0, 0, **kw)
    with pytest.raises(ValueError, match="pool_target"):
        KF.fleet_tick_block(block, target[:4], 0, 0, **kw)
    with pytest.raises(ValueError, match="int32"):
        KF.fleet_tick_block(block, target, 2 ** 31, 0, **kw)
    big = KF.MAX_POOL_SLOTS + 1
    with pytest.raises(ValueError, match="shared memory"):
        KF.fleet_tick_block(block, torch.zeros(big, dtype=torch.int32), 0,
                            0, num_pools=big, num_slots=64)
    with pytest.raises(ValueError, match="shared memory"):
        tplan._eval_fn(64, big, (torch.device("cpu"),))
    # a device with no kernel raises instead of running the plain version
    with pytest.raises(ValueError, match="no kernel"):
        KF.fleet_tick_block(block.to("meta"), target.to("meta"), 0, 0, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        KD.delta_scatter(block.to("meta"),
                         torch.zeros(1, dtype=torch.int32, device="meta"),
                         torch.zeros((8, 1), dtype=torch.int32,
                                     device="meta"))
    with pytest.raises(ValueError, match="vals"):
        KD.delta_scatter(block, torch.zeros(2, dtype=torch.int32),
                         torch.zeros((8, 3), dtype=torch.int32))


def test_kernel_codes_match_the_planner():
    """csrc/fleet_tick.cu compiles the mode and doctor codes in; they
    must be the planner's (and the reference's)."""
    assert KF.N_MODES == tplan.N_MODES == jplan.N_MODES
    assert KF.MODE_UNKNOWN == tplan.MODE_CODES["unknown"]
    assert KF.MODE_FAILED == tplan.MODE_CODES["failed"]
    assert KF.DOCTOR_UNREPORTED == tplan.DOCTOR_UNREPORTED
    assert KF.DOCTOR_FAILING == tplan.DOCTOR_FAILING
    assert tplan.MODE_CODES == jplan.MODE_CODES
    assert tplan.COLS_ORDER == jplan.COLS_ORDER
    assert KF.MASK_KEYS == tplan._NODE_OUT_KEYS == jplan._NODE_OUT_KEYS
    src = (_build.CSRC_DIR / "fleet_tick.cu").read_text()
    for line in ("kModes = 6;", "kUnknown = 0;", "kFailed = 5;",
                 "kDoctorUnreported = 0;", "kDoctorFailing = 2;"):
        assert line in src


# ------------------------------------------------------------------ K2


def _node_sharding():
    return jplan._mesh_env()[5]


@pytest.mark.parametrize("nb,k", [(64, 1), (64, 64), (1024, 100)])
def test_delta_scatter_plain_version_matches_jax_scatter(monkeypatch, nb, k):
    """The single-device in-place scatter equals the JAX donated scatter
    on the 8-device mesh, gathered, with the padding index nb — on rows
    where the reference is well-defined: each shard clips an index it
    does not own onto its LAST row and scatters that row's old value
    there, which overwrites a real update of that row (see
    test_delta_scatter_writes_the_rows_the_mesh_scatter_drops)."""
    kb = jplan.bucket_deltas(k)
    rng = np.random.default_rng(nb + k)
    base = rng.integers(-50, 50, (8, nb)).astype(np.int32)
    rows_local = nb // len(jplan._planner_devices())
    safe_rows = np.array([r for r in range(nb)
                          if r % rows_local != rows_local - 1])
    k = min(k, safe_rows.size)
    idx = np.full(kb, nb, np.int32)
    idx[:k] = np.sort(rng.choice(safe_rows, k, replace=False))
    vals = rng.integers(-50, 50, (8, kb)).astype(np.int32)

    shard = _node_sharding()
    cols = tuple(jax.device_put(base[j].copy(), shard) for j in range(8))
    # a scatter an earlier test cached may hold a mesh from before a
    # runtime teardown; build it over the devices the columns sit on
    monkeypatch.setattr(jplan, "_SCATTER_CACHE", {})
    out = jplan._scatter_fn(nb, kb)(cols, idx, vals)
    want = np.stack([np.asarray(c) for c in out])

    block = torch.from_numpy(base.copy())
    KD.delta_scatter(block, torch.from_numpy(idx), torch.from_numpy(vals))
    assert block.dtype == torch.int32
    assert np.array_equal(block.numpy(), want), VERSIONS
    assert not np.array_equal(want, base)


def test_delta_scatter_writes_the_rows_the_mesh_scatter_drops():
    """The reference's sharded scatter loses a delta on the last row of
    a shard whenever the block carries padding (a fault of the JAX
    package, ROADMAP Queue 3); the port's scatter writes every row."""
    nb, kb = 64, 64
    rows_local = nb // len(jplan._planner_devices())
    edge = [rows_local - 1, nb - 1]
    block = torch.zeros((8, nb), dtype=torch.int32)
    idx = np.full(kb, nb, np.int32)
    idx[:2] = edge
    KD.delta_scatter(block, torch.from_numpy(idx),
                     torch.full((8, kb), 5, dtype=torch.int32))
    assert (block[:, edge] == 5).all()
    assert int((block != 0).sum()) == 8 * len(edge)


def test_delta_scatter_drops_every_index_outside_the_block():
    nb = 64
    base = torch.arange(8 * nb, dtype=torch.int32).view(8, nb)
    block = base.clone()
    idx = torch.tensor([-1, nb, nb + 3, -(2 ** 31), 7], dtype=torch.int32)
    vals = torch.full((8, 5), -9, dtype=torch.int32)
    KD.delta_scatter(block, idx, vals)
    want = base.clone()
    want[:, 7] = -9
    assert torch.equal(block, want)


def test_scatter_fn_updates_the_resident_block_in_place():
    nb, kb = 64, 64
    block = torch.zeros((8, nb), dtype=torch.int32)
    idx = np.full(kb, nb, np.int32)
    idx[:2] = [5, 9]
    vals = np.zeros((8, kb), np.int32)
    vals[:, :2] = 7
    tplan._scatter_fn(nb, kb, (torch.device("cpu"),))([block], idx,
                                                       vals)
    assert block[:, 5].tolist() == [7] * 8 and block[:, 9].tolist() == [7] * 8
    assert int(block.sum()) == 7 * 16


# ------------------------------------------------------------------ K3


@pytest.mark.parametrize("n,s", [(256, 16), (100, 7), (64, 64)])
def test_fleet_plan_matches_jax(n, s):
    rng = np.random.default_rng(n + s)
    desired = rng.integers(0, jplan.N_MODES, n).astype(np.int32)
    observed = rng.integers(0, jplan.N_MODES, n).astype(np.int32)
    slice_ids = rng.integers(0, s, n).astype(np.int32)
    if s == 7:  # out-of-range slice ids: JAX drops them, so must K3
        slice_ids[:6] = [-1, -7, -8, 7, 100, -(2 ** 31)]
    want = jplan.fleet_plan_jit(jnp.asarray(desired), jnp.asarray(observed),
                                jnp.asarray(slice_ids), num_slices=s)
    got = tplan.fleet_plan(torch.from_numpy(desired),
                           torch.from_numpy(observed),
                           torch.from_numpy(slice_ids), num_slices=s)
    _assert_same(got, {k: np.asarray(v) for k, v in want.items()})
    _assert_same(KF.fleet_plan_reference(
        torch.from_numpy(desired), torch.from_numpy(observed),
        torch.from_numpy(slice_ids), num_slices=s), got)


# ---------------------------------------------------------------- build


def test_build_is_keyed_by_the_sources_and_stays_in_the_package():
    path = _build.library_path()
    assert path.parent.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parent.name == "tpu_cc_manager_torch"
    assert path.parent.name == _build.source_digest()
    assert all((_build.CSRC_DIR / name).is_file() for name in _build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.COMPILE_FLAGS
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "tpu_cc_manager_torch/_build/" in f.read().split()


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has the CUDA toolkit installed")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
