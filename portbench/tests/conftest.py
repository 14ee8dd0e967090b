"""The benchmark's own tests: ``python -m pytest portbench/tests``.

They run on the CPU at tiny sizes with the kernels' plain versions
(``TPU_CC_TORCH_DEVICE=cpu``). A test that needs the card carries the
``card`` marker and asks for the ``card`` fixture, which decides inside
the test whether there is one and skips here with a reason."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch sees none here")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_planner(monkeypatch):
    """Run the port's planner on the CPU (its kernels' plain versions)."""
    monkeypatch.setenv("TPU_CC_TORCH_DEVICE", "cpu")
    for key in ("TPU_CC_IDENTITY", "TPU_CC_ATTESTATION"):
        monkeypatch.setenv(key, "none")


@pytest.fixture
def sync_repaired(monkeypatch):
    """The program's ``FleetEncoding.apply`` refusing a node object older
    than the one its row holds. The program's own ``sync`` writes a
    listed node over a newer delta (PERF.md, Open questions), a race
    that can make a sound rolling run come out not correct; the held
    rolling cells' tests that need a sound run repair it here, so that
    they judge the harness and not the race."""
    import threading

    from tpu_cc_manager_torch import plan

    orig = plan.FleetEncoding.apply
    guard = threading.Lock()
    newest = {}

    def apply(self, node):
        meta = node.get("metadata") or {}
        key = (id(self), meta.get("name"))
        rv = int(meta.get("resourceVersion") or 0)
        with guard:
            if rv < newest.get(key, -1):
                return False
            newest[key] = rv
            return orig(self, node)

    monkeypatch.setattr(plan.FleetEncoding, "apply", apply)
