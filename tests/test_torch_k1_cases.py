"""K1's plain versions held to the JAX planner on the inputs the kernel's
row pass splits on, exactly, on the CPU.

The CUDA row pass aggregates what rows add to a slot, a pool or a pool x
mode bin per thread and per run of warp lanes before any atomic, and
takes 4 rows per thread with 16-byte loads only when the row count is a
multiple of 4 and the block is aligned. So its hardest inputs are the
ones where everything lands on one key (every row in one slot, every
row in one pool, a snapshot's padding on slot nb - 1) and row counts or
block offsets that leave the vector path. Here the plain versions of K1,
of its partial form (combined over shards) and of K3 get those inputs,
made from a seed with numpy, and must return every array equal to the
JAX package's ``fleet_tick`` / ``fleet_plan`` (jitted on the CPU), dtype
included. ``chip_smoke.py`` holds the kernel against these plain
versions on the card on the same kinds of input.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_kernels import (  # noqa: E402
    NOW, STALE, VERSIONS, _assert_same, _columns, _jax_tick, _port_tick)
from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.kernels import LAUNCHES  # noqa: E402
from tpu_cc_manager_torch.kernels import fleet_tick as KF  # noqa: E402
from tpu_cc_manager_torch.kernels import mesh_combine as KM  # noqa: E402

CASES = ("one_slot", "one_pool", "snapshot_padding")


def _snapshot_padded(nb, pb, seed):
    """A fleet padded as ``FleetEncoding.snapshot`` pads it: past the
    live three quarters, unknown modes, slice slot nb - 1, pool 0, no
    taint, doctor 0, no evidence, valid 0 (the 100k fleet's bucket pads
    24 % of its rows)."""
    cols = _columns(nb, pb, seed)
    cols["pool_ids"][nb * 3 // 4:] = 0
    return cols


def _case_columns(case, nb, pb, seed):
    if case == "snapshot_padding":
        return _snapshot_padded(nb, pb, seed)
    cols = _columns(nb, pb, seed)
    if case == "one_slot":
        cols["slice_ids"][:] = 0  # padding rows included
    else:  # one_pool: every row, padding included, in one pool slot
        cols["pool_ids"][:] = pb // 2
    return cols


def _targets(pb, seed):
    return np.random.default_rng(seed).integers(
        0, jplan.N_MODES, pb).astype(np.int32)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("nb,pb", [(64, 8), (1024, 8), (1024, 16)])
def test_fleet_tick_plain_version_matches_jax_where_rows_share_a_key(
        case, nb, pb):
    cols = _case_columns(case, nb, pb, seed=nb + pb)
    target = _targets(pb, seed=pb)
    want = _jax_tick(cols, target, pb, nb)
    _assert_same(_port_tick(cols, target, pb, nb), want)
    if case == "one_slot":
        # one slot holds every row; every other slot keeps its identities
        assert not want["slice_coherent"][1:].any(), VERSIONS
    if case == "snapshot_padding":
        # the padding slot folds every padding row in and reads coherent
        assert want["slice_coherent"][nb - 1], VERSIONS
        assert not np.asarray(want["needs_flip"])[nb * 3 // 4:].any(), (
            VERSIONS)


def _combined_partials(cols, target, pb, nb, shards):
    """K1's partial form (plain) over ``shards`` row ranges, combined
    with K4's plain version, with the shards' masks side by side."""
    block = tplan.columns_to_block(cols, "cpu")
    counts = torch.empty((shards, KF.counts_len(pb)), dtype=torch.int32)
    slots = torch.empty((shards, 6, nb), dtype=torch.int32)
    masks = [KF.fleet_tick_partial(
        part.contiguous(), torch.from_numpy(target), NOW, STALE,
        num_pools=pb, num_slots=nb, counts=counts[i], slots=slots[i])
        for i, part in enumerate(block.split(nb // shards, dim=1))]
    out = KM.mesh_combine(counts, slots, num_pools=pb)
    mask = torch.cat(masks, dim=1)
    out.update({key: mask[j] for j, key in enumerate(KF.MASK_KEYS)})
    return {key: value.numpy() for key, value in out.items()}


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shards", [2, 8])
def test_partial_form_combines_to_jax_where_rows_share_a_key(case, shards):
    """The padding sits in the last shard only, as on the mesh."""
    nb, pb = 1024, 8
    cols = _case_columns(case, nb, pb, seed=shards)
    target = _targets(pb, seed=shards + 1)
    before = dict(LAUNCHES)
    got = _combined_partials(cols, target, pb, nb, shards)
    # the plain versions count nothing
    assert LAUNCHES == before, VERSIONS
    _assert_same(got, _jax_tick(cols, target, pb, nb))


@pytest.mark.parametrize("nb", [61, 62, 63, 1021])
def test_fleet_tick_plain_version_matches_jax_on_row_counts_off_4(nb):
    """Row counts 1, 2 and 3 past a multiple of 4: the kernel's scalar
    path, and the tail of its last thread."""
    pb = 8
    cols = _snapshot_padded(nb, pb, seed=nb)
    target = _targets(pb, seed=nb)
    _assert_same(_port_tick(cols, target, pb, nb),
                 _jax_tick(cols, target, pb, nb))


def test_wrapper_takes_a_block_at_a_storage_offset():
    """A contiguous block that starts 4 bytes into its storage (only
    4-byte aligned, as the kernel's scalar path takes it) gives the same
    outputs as the block itself."""
    nb, pb = 256, 8
    cols = _snapshot_padded(nb, pb, seed=3)
    target = _targets(pb, seed=3)
    block = tplan.columns_to_block(cols, "cpu")
    storage = torch.empty(block.numel() + 1, dtype=torch.int32)
    shifted = storage[1:].view(block.shape)
    shifted.copy_(block)
    assert shifted.is_contiguous() and shifted.storage_offset() == 1, (
        VERSIONS)
    got = KF.fleet_tick_block(shifted, torch.from_numpy(target), NOW,
                              STALE, num_pools=pb, num_slots=nb)
    _assert_same(got, _jax_tick(cols, target, pb, nb))


@pytest.mark.parametrize("n", [253, 254, 255, 257, 258, 259])
def test_fleet_plan_matches_jax_on_row_counts_off_4(n):
    rng = np.random.default_rng(n)
    s = 16
    desired = rng.integers(0, jplan.N_MODES, n).astype(np.int32)
    observed = desired.copy()
    lag = rng.random(n) < 0.2
    observed[lag] = rng.integers(0, jplan.N_MODES, int(lag.sum()))
    slice_ids = (np.arange(n) % s).astype(np.int32)
    want = jplan.fleet_plan_jit(jnp.asarray(desired), jnp.asarray(observed),
                                jnp.asarray(slice_ids), num_slices=s)
    got = KF.fleet_plan(torch.from_numpy(desired),
                        torch.from_numpy(observed),
                        torch.from_numpy(slice_ids), num_slices=s)
    _assert_same(got, {k: np.asarray(v) for k, v in want.items()})
