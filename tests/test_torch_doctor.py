"""The port's doctor (``doctor.py``) held to the reference's.

The 15 cases of tests/test_doctor.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and the
doctor reports each side produced must be equal, each device path
replaced by its index.

The reference runs on its ``SysfsTpuBackend`` over a scratch sysfs tree.
The sysfs backend is not ported (ROADMAP Queue 1 item 7), so the port
runs on ``CudaBackend(device="cpu", cpu_chips=n)``, through named edits
of the reference's text:

- ``_backend`` builds the port's backend, and the two cases that stage a
  device in the store name the CPU chip's path (``torch:cpu:0``);
- a ``CudaBackend`` path has no devfs node, so the gate check skips it
  (``doctor.py``, "no devfs node"). The three cases that judge devfs gate
  permissions (``gating="chmod"``) run on the port's ``FakeBackend``
  instead, whose chips are the same scratch files the reference's sysfs
  tree holds. That backend keeps no statefile store, so for them only the
  ``gate-perms`` checks and the verdict are compared.
"""

import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_doctor  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

_BACKEND = '''    return SysfsTpuBackend(
        sysfs_root=str(sysfs), dev_root=str(dev),
        state_dir=str(tmp_path / "state"),
    )'''

MODS = (test_doctor, port_twin("test_doctor", edits=[
    ("the port's device layers in place of the sysfs backend",
     "from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend\n",
     "from tpu_cc_manager_torch.device.cudadev import CudaBackend\n"
     "from tpu_cc_manager_torch.device.fake import FakeBackend, FakeChip\n"),
    ("CPU chips, or fake chips on the scratch device files when the case "
     "judges gate permissions", _BACKEND,
     '''    if gating == "chmod":
        return FakeBackend(chips=[FakeChip(path=str(dev / f"accel{i}"))
                                  for i in range(n)])
    return CudaBackend(state_dir=str(tmp_path / "state"), device="cpu",
                       cpu_chips=n)'''),
    ("the CPU chip's path in the interrupted flip",
     'backend.store.stage(f"{tmp_path}/dev/accel0", "cc", "off")',
     'backend.store.stage("torch:cpu:0", "cc", "off")'),
    ("the CPU chip's path in the tampered statefile",
     '''    dev0 = f"{tmp_path}/dev/accel0"
    backend.store.stage(dev0, "cc", "off")''',
     '''    dev0 = "torch:cpu:0"
    backend.store.stage(dev0, "cc", "off")'''),
    ("a store for the fake backend, which keeps none",
     "backend.store = BrokenStore(backend.store.state_dir)",
     'backend.store = BrokenStore(str(tmp_path / "state"))'),
]))

#: the cases that judge devfs gate permissions (see the module docstring)
GATE_CASES = ("test_gate_drift_detected", "test_flip_lock_is_warn_not_fail",
              "test_unknown_effective_mode_skips_gate_check")

#: each backend names its devices in its evidence (ids, platform, kind)
#: and digests those names: the doctor's verdict on the document is
#: compared, the document is not
EVIDENCE = "tpu.google.com/cc.evidence"
_DEVICE = re.compile(r"<tmp>/dev/accel(\d+)|torch:cpu:(\d+)")


def _by_index(value):
    if isinstance(value, dict):
        return {_by_index(k): _by_index(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_by_index(v) for v in value]
    if isinstance(value, str):
        return _DEVICE.sub(lambda m: f"<device {m.group(1) or m.group(2)}>",
                           value)
    return value


def _drop_evidence(kube):
    for node in kube["nodes"].values():
        node["annotations"].pop(EVIDENCE, None)
    return kube


def _reports(name, side, snapshot):
    reports = [r["out"] for r in snapshot["doctor_reports"]]
    if name in GATE_CASES:
        reports = [{"ok": r["ok"], "checks": [
            c for c in r["checks"] if c["name"] == "gate-perms"]}
            for r in reports]
    snapshot = dict(snapshot, doctor_reports=reports,
                    kubes=[_drop_evidence(k) for k in snapshot["kubes"]])
    return _by_index(snapshot)


@pytest.mark.parametrize("name,params", cases(test_doctor))
def test_doctor_case_on_both_packages(name, params, request, tmp_path):
    got = both(MODS, name, params, request, tmp_path, VERSIONS,
               view=_reports)
    assert got["doctor_reports"], "the case ran no doctor"
