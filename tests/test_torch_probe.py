"""K5, the readiness probe: its plain version held to the JAX probe.

``probe_add_one_reference`` (what ``probe_add_one`` runs for a CPU
tensor) gets the same numpy-seeded float32 inputs as the JAX probe's
arithmetic (``jaxdev.py:275-276``: ``x + jnp.float32(1.0)`` on the
device) and must return the same bits. The CUDA kernel runs only on a
card; ``chip_smoke.py`` holds it against this plain version there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_cc_manager_torch.kernels import LAUNCHES  # noqa: E402
from tpu_cc_manager_torch.kernels import probe as KP  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"


def _inputs(n, seed):
    """Seeded float32 values over many magnitudes and signs, plus the
    probe's own 1.0 and the values where rounding and IEEE rules bite."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 38, n))
    special = [1.0, 0.0, -0.0, -1.0, -2.0, 2.0 ** -24, -1.0 + 2.0 ** -24,
               1e-45, -1e-45, 1.17e-38, 3.4e38, -3.4e38, 2.0 ** 24,
               2.0 ** 24 + 2, np.inf, -np.inf, np.nan]
    return np.concatenate([np.array(special), x]).astype(np.float32)


def _jax_probe(x):
    cpu = jax.devices("cpu")[0]
    return np.asarray(jax.device_put(jnp.asarray(x), cpu) + jnp.float32(1.0))


@pytest.mark.parametrize("n,seed", [(0, 1), (1, 2), (255, 3), (4097, 4)])
def test_plain_version_matches_the_jax_probe_bit_for_bit(n, seed):
    x = _inputs(n, seed)
    want = _jax_probe(x)
    got = KP.probe_add_one_reference(torch.from_numpy(x.copy())).numpy()
    assert got.dtype == want.dtype == np.float32, VERSIONS
    assert got.shape == want.shape, VERSIONS
    assert np.array_equal(got, want, equal_nan=True), (
        x[got != want][:5], VERSIONS)
    nan = np.isnan(want)
    assert np.array_equal(got.view(np.uint32)[~nan],
                          want.view(np.uint32)[~nan]), VERSIONS


def test_the_probe_value_itself():
    x = np.float32(1.0)
    assert float(_jax_probe(x)) == 2.0
    y = KP.probe_add_one(torch.tensor(1.0, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == () and float(y) == 2.0


def test_the_wrapper_runs_the_plain_version_for_cpu_tensors_uncounted():
    before = dict(LAUNCHES)
    x = torch.from_numpy(_inputs(64, 5))
    got = KP.probe_add_one(x)
    assert np.array_equal(got.numpy(), KP.probe_add_one_reference(x).numpy(),
                          equal_nan=True)
    assert got.data_ptr() != x.data_ptr()  # out of place, as in JAX
    assert LAUNCHES == before


@pytest.mark.parametrize("bad,match", [
    (lambda: torch.ones(3, dtype=torch.float64), "float32"),
    (lambda: torch.ones(3, dtype=torch.int32), "float32"),
    (lambda: torch.ones(4, 2, dtype=torch.float32).t(), "contiguous"),
    (lambda: torch.ones(3, dtype=torch.float32, device="meta"),
     "no kernel"),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match=match):
        KP.probe_add_one(bad())
    assert LAUNCHES == before
