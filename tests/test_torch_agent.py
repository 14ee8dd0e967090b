"""The port's node agent (``agent.py``, ``CCManagerAgent``) held to the
reference's.

The 26 cases of tests/test_agent.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and the
labels, annotations, taints and ``spec.unschedulable`` each node ends
with, the Events posted and every value the write batcher published must
be equal on the two sides, but for the part the case in ``RACY``
leaves to timing.

Two named edits adapt the reference's text to the port: the SIGTERM case
builds the PCI twin of its accel tree (``tests/torch_pci_tree.py``) and
starts the port's entry point (``python -m tpu_cc_manager_torch``) over
the port's sysfs backend (``TPU_CC_DEVICE_BACKEND=sysfs``,
``device/gpu.py``). Its evidence names each side's own device,
``<tmp>/dev/accel0`` or ``<tmp>/dev/nvidia0``, which differ by name only,
so there a device's path, name and ``device_id`` are compared by index,
and the statefile digest, a hash over the device paths, is compared
within each side (``torch_pci_tree.by_index``).

Beyond those cases, the port's agent runs its reconcile cases over
``CudaBackend(device="cpu", cpu_chips=8)``, where K5's plain version
probes every chip in ``wait_ready``, against the reference's agent over
an 8-chip ``fake_backend``: the node each side ends with must be equal
with each device path replaced by its index. With no card and no request
for the CPU, the port's agent fails its reconcile and flips nothing.
"""

import copy
import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_agent  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import (  # noqa: E402
    PORT, REF, both, cases, mask, port_twin, without_doctor,
)

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
MODS = (test_agent, port_twin("test_agent", edits=[
    ("the PCI twin in place of the accel tree",
     '''    sysfs = tmp_path / "sysfs" / "accel0" / "device"
    sysfs.mkdir(parents=True)
    (sysfs / "vendor").write_text("0x1ae0\\n")
    (sysfs / "device").write_text("0x0063\\n")
    (tmp_path / "dev").mkdir()
    (tmp_path / "dev" / "accel0").write_text("")
''', '''    from torch_pci_tree import make_pci_tree, nvidia_proc_root

    sysfs, _dev = make_pci_tree(tmp_path, n=1)
'''),
    ("the port's entry point over its sysfs backend",
     '''            HEALTH_PORT="0",
        )
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_cc_manager"], env=env, cwd=repo,''',
     '''            HEALTH_PORT="0",
            TPU_CC_DEVICE_BACKEND="sysfs",
            TPU_NVIDIA_PROC_ROOT=nvidia_proc_root(sysfs),
        )
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_cc_manager_torch"], env=env, cwd=repo,'''),
]))
SIGTERM = "test_sigterm_is_a_clean_shutdown"


def without_events(snapshot):
    """The snapshot without the Events posted."""
    out = copy.deepcopy(snapshot)
    for kube in out["kubes"]:
        kube["events"] = []
    return out


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run (``tests/torch_mirror_selfcheck.py``
#: records how often): case -> (the part compared, why)
RACY = {
    "test_agent_self_repair_heals_failed_reconcile": (
        without_events,
        "the repair loop may fail again before the case clears the "
        "injected fault, and the case shuts the agent down as soon as "
        "the label reads on: which Events were posted by then depends "
        "on timing"),
    SIGTERM: (
        without_doctor,
        "the agent's idle-tick doctor verdict lands or not before "
        "SIGTERM"),
}


def _devices_by_index(evidence: dict) -> dict:
    """The evidence document with each device named by its index: the
    reference's chips are fake chips, the port's CPU chips
    ``torch:cpu:<i>``."""
    return {"node": evidence["node"], "version": evidence["version"],
            "devices": [{"index": i, "cc": d.get("cc"), "ici": d.get("ici")}
                        for i, d in enumerate(evidence["devices"])]}


def _view(name, side, snapshot):
    return pci.by_index(snapshot) if name == SIGTERM else snapshot


@pytest.mark.parametrize("name,params", cases(test_agent))
def test_agent_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY, view=_view)


# ------------------------------------- the port's agent over CudaBackend


DP_LABEL = "tpu.google.com/pool.deploy.device-plugin"
N_CHIPS = 8
N_PODS = 8

#: case -> (the node's labels at start, the desired modes written after
#: each reconcile, drain strategy); the node drains hold N_PODS pods on
#: the node (rescheduled before every flip) and N_PODS on another node
AGENT_CASES = {
    "initial_reconcile_from_label": ({"cc": "devtools"}, [], "none"),
    "default_when_label_absent": ({}, [], "none"),
    "invalid_label_value": ({"cc": "bogus"}, [], "none"),
    "components_drained_around_flip": (
        {"cc": "on", DP_LABEL: "true"}, [], "components"),
    "node_drain_follows_label_changes": (
        {"cc": "on"}, ["off", "devtools"], "node"),
}


def _node_view(side, kube):
    L = side.module("labels")
    node = kube.get_node("n1")
    meta = node["metadata"]
    ann = meta.get("annotations") or {}
    return {
        "labels": {k: v for k, v in meta["labels"].items()
                   if k != L.DOCTOR_OK_LABEL},
        "evidence": (_devices_by_index(json.loads(
                        ann[L.EVIDENCE_ANNOTATION]))
                     if L.EVIDENCE_ANNOTATION in ann else None),
        "taints": mask((node.get("spec") or {}).get("taints") or []),
        "unschedulable": bool((node.get("spec") or {}).get("unschedulable")),
        "pods": sorted(p["metadata"]["name"]
                       for p in kube.list_pods("default")),
    }


def _agent_case(side, backend, tmp_path, case):
    """Run one reconcile case on ``side``'s agent over ``backend``:
    the node view after every reconcile, and the Events posted."""
    initial, later, drain = AGENT_CASES[case]
    L = side.module("labels")
    objects = side.module("k8s.objects")
    kube = side.module("k8s.fake").FakeKube()
    labels = {(L.CC_MODE_LABEL if k == "cc" else k): v
              for k, v in initial.items()}
    kube.add_node(objects.make_node("n1", labels=labels))
    kube.add_node(objects.make_node("other"))

    def reschedule(step):
        if drain == "node":
            for i in range(N_PODS):
                kube.add_pod(objects.make_pod(f"job-{step}-{i}", "default",
                                              node_name="n1"))

    for i in range(N_PODS if drain == "node" else 0):
        kube.add_pod(objects.make_pod(f"keep-{i}", "default",
                                      node_name="other"))
    reschedule(0)
    cfg = side.module("config").AgentConfig(
        node_name="n1", default_mode="on", health_port=0,
        readiness_file=str(tmp_path / f"ready-{side.name}"),
        drain_strategy=drain)
    agent = side.module("agent").CCManagerAgent(kube, cfg, backend=backend)
    agent.watcher.watch_timeout_s = 1
    agent.watcher.backoff_s = 0.05
    rcs = []
    t = threading.Thread(
        target=lambda: rcs.append(agent.run(max_reconciles=1 + len(later))))
    t.start()
    views = []
    try:
        for step, mode in enumerate([None] + later):
            deadline = time.monotonic() + 20
            while agent.reconcile_count < step + 1 and t.is_alive() \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            assert agent.reconcile_count >= step + 1, (side.name, case)
            view = _node_view(side, kube)
            # evidence rides the next write or idle tick after a flip
            # (the batcher's deferral); it is compared once it settled
            view.pop("evidence")
            views.append(view)
            if step < len(later):
                reschedule(step + 1)
                kube.set_node_labels("n1", {L.CC_MODE_LABEL: later[step]})
        t.join(timeout=20)
        assert not t.is_alive()
    finally:
        agent.shutdown()
        t.join(timeout=5)
    views.append(_node_view(side, kube))  # after the final flush
    events = sorted((e["reason"], mask(e["message"]))
                    for e in kube.list_events("default"))
    return {"rc": rcs, "views": views, "events": events}


@pytest.mark.parametrize("case", sorted(AGENT_CASES))
def test_agent_reconciles_over_the_cuda_backend_on_cpu(case, tmp_path):
    """The port's agent over ``CudaBackend(device="cpu", cpu_chips=8)``
    against the reference's over an 8-chip fake: the same node, step by
    step, and K5's plain version probing every chip of every flip."""
    from tpu_cc_manager.device.fake import fake_backend
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.kernels import LAUNCHES

    want = _agent_case(REF, fake_backend(n_chips=N_CHIPS), tmp_path, case)
    backend = CudaBackend(state_dir=str(tmp_path / "state"), device="cpu",
                          cpu_chips=N_CHIPS)
    probes = []
    real_probe = backend.probe_device
    backend.probe_device = lambda i: (probes.append(i), real_probe(i))[1]
    launches = dict(LAUNCHES)
    PORT.reset()
    try:
        got = _agent_case(PORT, backend, tmp_path, case)
    finally:
        PORT.reset()
    assert got == want, f"port and reference differ ({VERSIONS})"
    flips = sum(1 for v in got["views"][:-1] if v["labels"].get(
        "tpu.google.com/cc.mode.state") not in (None, "failed"))
    # every chip answered its probe once per flip, on K5's plain version
    assert sorted(set(probes)) == (list(range(N_CHIPS)) if flips else [])
    assert len(probes) >= N_CHIPS * flips
    assert LAUNCHES == launches
    if case == "node_drain_follows_label_changes":
        states = [v["labels"]["tpu.google.com/cc.mode.state"]
                  for v in got["views"]]
        assert states == ["on", "off", "devtools", "devtools"]
        assert {d["cc"] for d in got["views"][-1]["evidence"][
            "devices"]} == {"devtools"}
        assert backend.runtime_gen == 3
        for v in got["views"]:
            assert not v["unschedulable"] and v["taints"] == []
            assert v["pods"] == [f"keep-{i}" for i in range(N_PODS)]


def test_agent_without_a_card_fails_its_reconcile(tmp_path, monkeypatch):
    """No CUDA device and no request for the CPU: the agent's device
    layer (the registry's default, ``cuda``) enumerates nothing, so the
    reconcile fails and publishes ``failed``; no mode is stored and
    nothing moves to the CPU."""
    from tpu_cc_manager_torch import labels as L
    from tpu_cc_manager_torch import plan as tplan
    from tpu_cc_manager_torch.agent import CCManagerAgent
    from tpu_cc_manager_torch.config import AgentConfig
    from tpu_cc_manager_torch.device.base import get_backend
    from tpu_cc_manager_torch.device.cudadev import CudaBackend
    from tpu_cc_manager_torch.k8s.fake import FakeKube
    from tpu_cc_manager_torch.k8s.objects import make_node

    monkeypatch.delenv(tplan.DEVICE_ENV, raising=False)
    monkeypatch.delenv("TPU_CC_DEVICE_BACKEND", raising=False)
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / "state"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    PORT.reset()
    try:
        kube = FakeKube()
        kube.add_node(make_node("n1", labels={L.CC_MODE_LABEL: "on"}))
        agent = CCManagerAgent(kube, AgentConfig(
            node_name="n1", health_port=0, drain_strategy="none",
            readiness_file=str(tmp_path / "ready")))
        try:
            assert agent.reconcile("on") is False
        finally:
            agent.shutdown()
        assert isinstance(get_backend(), CudaBackend)
    finally:
        PORT.reset()
    labels = kube.get_node("n1")["metadata"]["labels"]
    assert labels[L.CC_MODE_STATE_LABEL] == "failed"
    assert not (tmp_path / "state").exists()
