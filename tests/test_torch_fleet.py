"""The port's fleet controller held to the reference's, case by case.

The 16 cases of tests/test_fleet.py run twice, once on the reference's
``FleetController`` and once on the port's (``TPU_CC_TORCH_DEVICE=cpu``,
where the planner's kernels run their plain versions), each over its own
package's ``FakeKube`` holding the same nodes. Every assertion of the
reference case holds on both sides, and the reports, metrics and exit
codes the two sides produce must be equal. Each case runs on a one-shard
mesh and on an 8-shard one (``TPU_CC_PLANNER_MESH``, which the reference
reads too).
"""

import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tpu_cc_manager.__main__ as jcli  # noqa: E402
import tpu_cc_manager_torch.__main__ as tcli  # noqa: E402
from tpu_cc_manager import doctor as jdoctor  # noqa: E402
from tpu_cc_manager import fleet as jfleet  # noqa: E402
from tpu_cc_manager import labels as JL  # noqa: E402
from tpu_cc_manager.k8s import client as jclient  # noqa: E402
from tpu_cc_manager.k8s import fake as jfake  # noqa: E402
from tpu_cc_manager.k8s import objects as jobjects  # noqa: E402
from tpu_cc_manager_torch import doctor as tdoctor  # noqa: E402
from tpu_cc_manager_torch import fleet as tfleet  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.k8s import client as tclient  # noqa: E402
from tpu_cc_manager_torch.k8s import fake as tfake  # noqa: E402
from tpu_cc_manager_torch.k8s import objects as tobjects  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

REF = types.SimpleNamespace(name="reference", fleet=jfleet, fake=jfake,
                            objects=jobjects, client=jclient, cli=jcli,
                            labels=JL, doctor=jdoctor)
PORT = types.SimpleNamespace(name="port", fleet=tfleet, fake=tfake,
                             objects=tobjects, client=tclient, cli=tcli,
                             labels=L, doctor=tdoctor)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True, params=[1, 8], ids=["mesh1", "mesh8"])
def _planner(request, monkeypatch):
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.setenv(tplan.MESH_ENV, str(request.param))


def both(case):
    """Run ``case(side)`` on the reference and on the port; the two
    results must be equal. Returns the port's."""
    want = case(REF)
    got = case(PORT)
    assert got == want, f"port and reference differ ({VERSIONS})"
    return got


def _node(side, name, desired=None, state=None, slice_id=None):
    labels = {L.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice"}
    if desired:
        labels[L.CC_MODE_LABEL] = desired
    if state:
        labels[L.CC_MODE_STATE_LABEL] = state
    if slice_id:
        labels[L.TPU_SLICE_LABEL] = slice_id
    return side.objects.make_node(name, labels=labels)


def _mixed_fleet(side):
    kube = side.fake.FakeKube()
    # 2 converged, 1 divergent, 1 failed, one half-flipped 2-node slice
    for args in (("ok-1", "on", "on"), ("ok-2", "off", "off"),
                 ("lag-1", "on", "off"), ("bad-1", "on", "failed"),
                 ("s1-a", "on", "on", "s1"), ("s1-b", "on", "off", "s1")):
        kube.add_node(_node(side, *args))
    return kube


def test_scan_once_updates_metrics_and_report():
    def case(side):
        ctrl = side.fleet.FleetController(_mixed_fleet(side))
        report = ctrl.scan_once()
        assert report["nodes"] == 6
        assert set(report["needs_flip"]) == {"lag-1", "bad-1", "s1-b"}
        assert report["failed"] == ["bad-1"]
        assert report["half_flipped_slices"] == ["s1"]
        m = ctrl.metrics
        assert m.nodes.value() == 6
        assert m.needs_flip.value() == 3
        assert m.failed.value() == 1
        assert m.half_flipped_slices.value() == 1
        assert m.nodes_by_mode.value("on") == 2
        assert m.scans_total.value("success") == 1
        # the rendered set also holds scan times and build counters,
        # which differ by nature; the audit gauges must not
        return report, [m.nodes_by_mode.value(mode) for mode in (
            "on", "off", "failed", "devtools", "ici", "unknown")]

    both(case)


def test_metrics_zero_out_vanished_modes():
    def case(side):
        kube = side.fake.FakeKube()
        kube.add_node(_node(side, "n", desired="on", state="on"))
        ctrl = side.fleet.FleetController(kube)
        first = ctrl.scan_once()
        assert ctrl.metrics.nodes_by_mode.value("on") == 1
        kube.set_node_labels("n", {L.CC_MODE_STATE_LABEL: "off"})
        second = ctrl.scan_once()
        assert ctrl.metrics.nodes_by_mode.value("on") == 0
        assert ctrl.metrics.nodes_by_mode.value("off") == 1
        return first, second

    both(case)


def test_http_endpoints_and_run_loop():
    def case(side):
        ctrl = side.fleet.FleetController(_mixed_fleet(side),
                                          interval_s=0.05, port=0)
        t = threading.Thread(target=ctrl.run, daemon=True)
        t.start()
        try:
            deadline = time.monotonic() + 10
            while ctrl.last_report is None and time.monotonic() < deadline:
                time.sleep(0.02)
            assert ctrl.last_report is not None
            base = f"http://127.0.0.1:{ctrl.port}"
            with urllib.request.urlopen(f"{base}/healthz") as r:
                assert r.read() == b"ok"
            with urllib.request.urlopen(f"{base}/report") as r:
                report = json.load(r)
            assert report["nodes"] == 6
            with urllib.request.urlopen(f"{base}/metrics") as r:
                text = r.read().decode()
            assert "tpu_cc_fleet_nodes 6" in text
            assert 'tpu_cc_fleet_nodes_by_mode{mode="failed"} 1' in text
            assert "tpu_cc_fleet_half_flipped_slices 1" in text
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{base}/metrics/bogus")
            assert e.value.code == 404
            return report
        finally:
            ctrl.stop()
            t.join(timeout=5)
            assert not t.is_alive()

    both(case)


def test_persistent_api_failure_exits_unhealthy():
    def case(side):
        kube = side.fake.FakeKube()
        kube.add_node(_node(side, "n"))
        calls = {"n": 0}

        def flaky(selector=None):
            calls["n"] += 1
            raise side.client.ApiException(500, "injected outage")

        kube.list_nodes = flaky
        ctrl = side.fleet.FleetController(
            kube, interval_s=0.01, port=0, max_consecutive_errors=3)
        rc = ctrl.run()
        assert rc == 1 and calls["n"] == 3 and not ctrl.healthy
        return rc, calls["n"], ctrl.metrics.scans_total.value("error")

    both(case)


def test_rejects_nonpositive_interval():
    def case(side):
        with pytest.raises(ValueError, match="interval") as e:
            side.fleet.FleetController(side.fake.FakeKube(), interval_s=0)
        return str(e.value)

    both(case)


def test_report_503_before_first_scan():
    def case(side):
        ctrl = side.fleet.FleetController(side.fake.FakeKube(), port=0)
        ctrl._server.start()
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{ctrl.port}/report")
            return e.value.code
        finally:
            ctrl.stop()

    assert both(case) == 503


def test_scan_loop_survives_non_api_exceptions():
    class BrokenKube:
        def list_nodes(self, selector=None):
            return [{"spec": {}}]  # no metadata -> KeyError in analyze

    def case(side):
        ctrl = side.fleet.FleetController(BrokenKube(), interval_s=30.0,
                                          port=0, max_consecutive_errors=2)
        errors = []
        for _ in range(2):
            with pytest.raises(Exception) as e:
                ctrl.scan_once()
            errors.append(type(e.value).__name__)
        assert ctrl.consecutive_errors == 2 and not ctrl.healthy
        assert ctrl.metrics.scans_total.value("error") == 2
        return errors

    both(case)


def test_doctor_aggregation_and_policy_summaries():
    def case(side):
        kube = side.fake.FakeKube()
        for name in ("n-ok", "n-bad", "n-silent", "n-garbled"):
            kube.add_node(_node(side, name, desired="on", state="on"))
        kube.set_node_annotations("n-ok", {L.DOCTOR_ANNOTATION: json.dumps(
            {"ok": True, "fail": [], "warn": [],
             "at": "2026-07-30T00:00:00Z"})})
        kube.set_node_annotations("n-bad", {L.DOCTOR_ANNOTATION: json.dumps(
            {"ok": False, "fail": ["state-label"], "warn": [],
             "at": "2026-07-30T00:00:00Z"})})
        kube.set_node_annotations("n-garbled", {L.DOCTOR_ANNOTATION: "{nope"})
        kube.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
            "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
            "kind": L.POLICY_KIND,
            "metadata": {"name": "prod"},
            "spec": {"mode": "on", "nodeSelector": L.TPU_ACCELERATOR_LABEL},
            "status": {"phase": "Converged", "nodes": 4, "converged": 4,
                       "message": "all good"},
        })
        ctrl = side.fleet.FleetController(kube, port=0)
        report = ctrl.scan_once()
        doctor = report["doctor"]
        assert doctor["reported"] == 3
        assert [d["node"] for d in doctor["failing"]] == ["n-bad",
                                                          "n-garbled"]
        assert doctor["failing"][0]["fail"] == ["state-label"]
        assert report["policies"] == [{
            "name": "prod", "mode": "on", "phase": "Converged",
            "nodes": 4, "converged": 4, "message": "all good",
        }]
        assert doctor["unreported"] == ["n-silent"]
        rendered = ctrl.metrics.render().splitlines()
        assert "tpu_cc_fleet_doctor_failing_nodes 2" in rendered
        assert "tpu_cc_fleet_doctor_unreported_nodes 1" in rendered
        return report

    both(case)


def test_doctor_publish_round_trip(tmp_path, monkeypatch):
    """doctor --publish -> fleet aggregation through the annotation
    channel, each package's own doctor publishing onto its own FakeKube:
    the reference's over its sysfs backend on an accel tree, the port's
    over its sysfs backend on the PCI twin of that tree
    (``tests/torch_pci_tree.py``). The fleet reports name nodes, not
    devices, so they are compared whole."""
    from test_doctor import _backend, _flip
    from torch_pci_tree import make_pci_tree, twin_backend

    from tpu_cc_manager_torch.engine import ModeEngine

    def case(side):
        if side is REF:
            backend = _backend(tmp_path, monkeypatch)
            _flip(backend, "on")
        else:
            sysfs, dev = make_pci_tree(tmp_path / "port", n=1)
            backend = twin_backend(sysfs, dev, str(tmp_path / "port-state"))
            ModeEngine(set_state_label=lambda v: None, backend=backend,
                       evict_components=False).set_mode("on")
        kube = side.fake.FakeKube()
        kube.add_node(_node(side, "pub-node", desired="on", state="off"))
        report = side.doctor.run_doctor(kube=kube, node_name="pub-node",
                                        backend=backend)
        assert report["ok"] is False
        assert side.doctor.publish_report(kube, "pub-node", report)
        fleet = side.fleet.FleetController(kube, port=0).scan_once()
        assert [d["node"] for d in fleet["doctor"]["failing"]] == [
            "pub-node"]
        assert "state-label" in fleet["doctor"]["failing"][0]["fail"]
        assert kube.get_node("pub-node")["metadata"]["labels"][
            L.DOCTOR_OK_LABEL] == "false"
        assert kube.list_nodes(f"{L.DOCTOR_OK_LABEL}=false")
        # the verdict's "at" is its publication time to the second: it
        # must reach the fleet unchanged, but each side publishes at its
        # own moment (seconds apart on a loaded host), so it is held to
        # the side's own annotation and not compared across the sides
        published = json.loads(kube.get_node("pub-node")["metadata"][
            "annotations"][L.DOCTOR_ANNOTATION])
        assert fleet["doctor"]["failing"][0]["at"] == published["at"]
        fleet["doctor"]["failing"][0]["at"] = "<published>"
        return fleet

    both(case)


def test_fleet_problems_classification():
    clean = {
        "failed": [], "needs_flip": ["n1"],
        "evidence_audit": {"missing": [], "invalid": [],
                           "label_device_mismatch": []},
        "doctor": {"reported": 1, "failing": []},
        "half_flipped_slices": [], "incoherent_slices": [],
    }
    dirty = {
        "failed": ["n2"],
        "evidence_audit": {"missing": ["n9"], "invalid": ["n3"],
                           "label_device_mismatch": ["n4"]},
        "doctor": {"failing": [{"node": "n5", "fail": ["gate-perms"]}]},
        "half_flipped_slices": ["s1"], "incoherent_slices": ["s2"],
    }

    def case(side):
        problems = side.fleet.fleet_problems
        assert problems(clean) == []
        assert problems(dict(clean, evidence_audit={
            "missing": ["n9"], "invalid": [], "label_device_mismatch": [],
        })) == ["evidence missing: ['n9']"]
        assert problems(dict(clean, incoherent_slices=["s2"])) == [
            "incoherent slices: ['s2']"]
        out = problems(dirty)
        assert len(out) == 7
        assert any("n2" in p for p in out) and any("s1" in p for p in out)
        return out

    both(case)


def test_cli_fleet_controller_once(monkeypatch, capsys):
    def case(side):
        kube = side.fake.FakeKube()
        kube.add_node(_node(side, "n1"))
        monkeypatch.setattr(side.cli, "_kube_client", lambda cfg: kube)
        results = []
        rc = side.cli.main(["fleet-controller", "--once"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 0 and out["nodes"] == 1
        results.append((rc, out))
        # a success claim without evidence fails the audit
        kube.add_node(_node(side, "n2", desired="on", state="on"))
        rc = side.cli.main(["fleet-controller", "--once"])
        out = json.loads(capsys.readouterr().out)
        assert rc == 1 and out["evidence_audit"]["missing"] == ["n2"]
        results.append((rc, out))
        kube.add_node(_node(side, "n3", desired="on", state="failed"))
        rc = side.cli.main(["fleet-controller", "--once"])
        assert rc == 1
        results.append((rc, json.loads(capsys.readouterr().out)))
        return results

    both(case)


def test_report_carries_election_state(monkeypatch):
    def case(side):
        kube = side.fake.FakeKube()
        kube.add_node(_node(side, "n1", desired="on", state="on"))
        kube.create_lease("tpu-system", {
            "metadata": {"name": "tpu-cc-policy-controller"},
            "spec": {"holderIdentity": "replica-a",
                     "renewTime": "2026-07-30T00:00:00.000000Z",
                     "leaseTransitions": 3},
        })
        monkeypatch.setenv("TPU_CC_LEADER_ELECT", "true")
        c = side.fleet.FleetController(kube, interval_s=30, port=0)
        elections = c.scan_once()["leader_elections"]
        assert elections["tpu-cc-policy-controller"]["holder"] == "replica-a"
        assert elections["tpu-cc-policy-controller"]["transitions"] == 3
        assert "tpu-cc-fleet-controller" not in elections
        monkeypatch.delenv("TPU_CC_LEADER_ELECT")
        calls = []
        orig = kube.get_lease
        kube.get_lease = lambda *a: (calls.append(a), orig(*a))[1]
        c2 = side.fleet.FleetController(kube, interval_s=30, port=0)
        assert c2.scan_once()["leader_elections"] == {}
        assert calls == []
        return elections

    both(case)


def test_node_fingerprint_ignores_doctor_timestamp():
    def node(state="on", doctor_at="t1", ok=True, evidence="e1"):
        return {"metadata": {
            "name": "n1",
            "labels": {L.TPU_ACCELERATOR_LABEL: "v5p",
                       L.CC_MODE_STATE_LABEL: state, "unrelated": "x"},
            "annotations": {
                L.DOCTOR_ANNOTATION: json.dumps(
                    {"ok": ok, "fail": [], "at": doctor_at}),
                L.EVIDENCE_ANNOTATION: evidence,
            },
        }}

    def case(side):
        fp = side.fleet.FleetController._node_fingerprint
        base = fp(node())
        assert fp(node(doctor_at="t2")) == base
        assert fp(node(state="off")) != base
        assert fp(node(ok=False)) != base
        assert fp(node(evidence="e2")) != base
        n = node()
        n["metadata"]["labels"]["unrelated"] = "y"
        assert fp(n) == base
        hostile = []
        for raw in ('{"ok": true, "fail": 5}', "null", "5", "{nope"):
            h = node()
            h["metadata"]["annotations"][L.DOCTOR_ANNOTATION] = raw
            assert fp(h) == fp(h)
            hostile.append(fp(h))
        return base, hostile

    both(case)


def test_watch_triggered_scan_beats_the_interval():
    def case(side):
        kube = side.fake.FakeKube()
        kube.add_node(_node(side, "n1", desired="on", state="on"))
        ctrl = side.fleet.FleetController(kube, interval_s=300.0, port=0)
        ctrl.min_scan_gap_s = 0.2
        t = threading.Thread(target=ctrl.run, daemon=True)
        t.start()
        try:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                r = ctrl.last_report
                if r and r.get("nodes") == 1:
                    break
                time.sleep(0.1)
            assert ctrl.last_report and ctrl.last_report["nodes"] == 1
            kube.set_node_labels("n1", {L.CC_MODE_LABEL: "off"})
            deadline = time.monotonic() + 15
            seen = None
            while time.monotonic() < deadline:
                r = ctrl.last_report
                if r and r.get("needs_flip"):
                    seen = r["needs_flip"]
                    break
                time.sleep(0.1)
            assert seen == ["n1"], ctrl.last_report
            return seen
        finally:
            ctrl.stop()
            t.join(timeout=10)
            assert not t.is_alive()

    both(case)


def test_watchless_client_degrades_to_polling():
    def case(side):
        class Minimal(side.fake.FakeKube):
            def watch_nodes(self, *a, **kw):
                raise side.client.ApiException(501, "no watch here")

        ctrl = side.fleet.FleetController(Minimal(), port=0)
        ctrl._watch_loop()  # returns promptly instead of raising/looping
        return ctrl._delta_feed_active

    assert both(case) is False


def test_watch_feed_filters_foreign_nodes():
    def case(side):
        ctrl = side.fleet.FleetController(_mixed_fleet(side))
        foreign = side.objects.make_node("pet-vm", labels={
            L.CC_MODE_LABEL: "on", L.CC_MODE_STATE_LABEL: "failed"})
        ctrl._on_watch_event("ADDED", foreign)
        sizes = [len(ctrl._encoding)]
        member = side.objects.make_node("tpu-1", labels={
            L.TPU_ACCELERATOR_LABEL: "v5p", L.CC_MODE_LABEL: "on",
            L.CC_MODE_STATE_LABEL: "on"})
        ctrl._on_watch_event("ADDED", member)
        sizes.append(len(ctrl._encoding))
        ctrl._on_watch_event("DELETED", member)
        sizes.append(len(ctrl._encoding))
        assert sizes == [0, 1, 0]
        return sizes

    both(case)


def test_the_port_scans_on_its_mesh(monkeypatch):
    """The controller's session takes the planner's mesh: S shard blocks
    on the port's side, and the same report at every S."""
    reports = []
    for shards in (1, 2, 8):
        monkeypatch.setenv(tplan.MESH_ENV, str(shards))
        ctrl = tfleet.FleetController(_mixed_fleet(PORT))
        reports.append(ctrl.scan_once())
        assert len(ctrl._tick_session._shards) == shards
    assert reports[0] == reports[1] == reports[2]


def _kubeconfig(path, port):
    path.write_text(
        "apiVersion: v1\nkind: Config\ncurrent-context: t\n"
        "contexts: [{name: t, context: {cluster: c, user: u}}]\n"
        f"clusters: [{{name: c, cluster: {{server: "
        f"\"http://127.0.0.1:{port}\"}}}}]\n"
        "users: [{name: u, user: {}}]\n")
    return str(path)


def test_fleet_controller_once_against_an_api_server(tmp_path, monkeypatch,
                                                     capsys):
    """Both CLIs over the wire against one FakeApiServer: the same report
    on stdout and the same exit code, at either mesh."""
    from tpu_cc_manager_torch.k8s.apiserver import FakeApiServer

    srv = FakeApiServer(port=0).start()
    try:
        for i in range(24):
            srv.store.add_node(_node(
                PORT, f"n{i:02d}", desired="on",
                state=("on", "off", "failed")[i % 3], slice_id=f"s{i // 4}"))
        monkeypatch.setenv("KUBECONFIG",
                           _kubeconfig(tmp_path / "kc.yaml", srv.port))

        def case(side):
            rc = side.cli.main(["fleet-controller", "--once"])
            return rc, json.loads(capsys.readouterr().out)

        rc, report = both(case)
    finally:
        srv.stop()
    assert rc == 1 and report["nodes"] == 24 and report["failed"]


def test_fleet_controller_without_a_card_or_a_cpu_request_raises(
        monkeypatch):
    monkeypatch.delenv(tplan.DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tcli, "_kube_client", lambda cfg: tfake.FakeKube())
    with pytest.raises(RuntimeError, match=tplan.DEVICE_ENV):
        tcli.main(["fleet-controller", "--once"])
