"""The port's node-facing and controller entry points held to the
reference's.

``set-cc-mode`` (success with a node drain, an invalid mode, a slice
abort, an enumeration error), ``doctor`` (``--offline``, ``--publish``)
and ``webhook`` (a certificate that does not exist) run through each
package's own ``main()``, each over its own package's ``FakeKube`` and
fake device backend. ``rollout`` (a dry run, a bad mode, ``--resume``
with a mode) and ``policy-controller --once`` (a healthy fleet, an
unhealthy one, a cluster without the TPUCCPolicy CRD) run the same way
against each package's own ``FakeApiServer`` over HTTP, through a
kubeconfig, the port planning on the CPU (``TPU_CC_TORCH_DEVICE=cpu``);
the rejected rollouts must send the server no request. The return
codes, the node each side ends with, the Events posted and what each
side printed must be equal, timestamps, durations and the random
suffixes of Event names masked (``tests/torch_mirror.py``).

Beyond the parity cases: with no CUDA device and no request for the CPU,
the port's ``set-cc-mode`` fails, publishes ``cc.mode.state=failed`` and
writes nothing to the mode store.
"""

import json
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from torch_mirror import PORT, REF, mask  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
NODE = "cli-node"
N_PODS = 8


@pytest.fixture(autouse=True)
def _reset_both_registries():
    """conftest resets the reference's registry; the port's is reset
    here too."""
    PORT.reset()
    REF.reset()
    yield
    PORT.reset()
    REF.reset()


def _kube(side, slice_id=None):
    objects = side.module("k8s.objects")
    kube = side.module("k8s.fake").FakeKube()
    labels = {L.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice"}
    if slice_id:
        labels[L.TPU_SLICE_LABEL] = slice_id
    kube.add_node(objects.make_node(NODE, labels=labels))
    kube.add_node(objects.make_node("other", labels=dict(labels)))
    for i in range(N_PODS):
        kube.add_pod(objects.make_pod(f"job-{i}", "default", node_name=NODE))
        kube.add_pod(objects.make_pod(f"keep-{i}", "default",
                                      node_name="other"))
    return kube


def _outcome(kube, rc, out):
    """What a CLI run leaves behind, masked for the comparison."""
    nodes = {}
    for node in kube.list_nodes():
        meta = node["metadata"]
        ann = {}
        for k, v in (meta.get("annotations") or {}).items():
            if k == L.SLICE_HB_ANNOTATION:
                ann[k] = "<ts>"  # the heartbeat is a clock reading
                continue
            try:
                ann[k] = mask(json.loads(v))
            except ValueError:
                ann[k] = mask(v)
        nodes[meta["name"]] = {
            "labels": meta.get("labels") or {}, "annotations": ann,
            "taints": (node.get("spec") or {}).get("taints") or [],
            "unschedulable": bool((node.get("spec") or {}).get(
                "unschedulable")),
        }
    events = [{"reason": e["reason"], "type": e["type"],
               "message": mask(e["message"]),
               "name": mask(e["metadata"]["name"])}
              for e in kube.list_events("default")]
    try:
        printed = mask(json.loads(out)) if out.strip() else ""
    except ValueError:
        printed = mask(out)
    return {"rc": rc, "nodes": nodes, "events": events,
            "pods": sorted(p["metadata"]["name"]
                           for p in kube.list_pods("default")),
            "printed": printed}


def _env(monkeypatch, tmp_path, side, **extra):
    monkeypatch.setenv("NODE_NAME", NODE)
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / side.name))
    monkeypatch.setenv("TPU_CC_DEVICE_GATING", "none")
    monkeypatch.setenv("TPU_CC_HOLDER_CHECK", "none")
    monkeypatch.setenv("DRAIN_STRATEGY", "none")
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def _run(side, argv, kube, monkeypatch, capsys):
    cli = side.module("__main__")
    monkeypatch.setattr(cli, "_kube_client", lambda cfg: kube)
    # doctor builds its own client from the kubeconfig
    client = side.module("k8s.client")
    monkeypatch.setattr(client.KubeConfig, "load",
                        staticmethod(lambda path=None: None))
    monkeypatch.setattr(client, "HttpKubeClient", lambda config: kube)
    rc = cli.main(argv)
    return _outcome(kube, rc, capsys.readouterr().out)


def both_cli(case, monkeypatch, capsys, tmp_path):
    """Run ``case(side, mp)`` on each package under its own monkeypatch
    and return both outcomes, which must be equal."""
    outs = []
    for side in (REF, PORT):
        with monkeypatch.context() as mp:
            outs.append(case(side, mp))
        side.reset()
    want, got = outs
    assert got == want, f"port and reference differ ({VERSIONS})"
    return got


def _fake(side, n=2):
    backend = side.module("device.fake").fake_backend(n_chips=n)
    side.module("device.base").set_backend(backend)
    return backend


def test_set_cc_mode_drains_flips_and_publishes(monkeypatch, capsys,
                                                tmp_path):
    def case(side, mp):
        _env(mp, tmp_path, side, DRAIN_STRATEGY="node")
        backend = _fake(side)
        kube = _kube(side)
        out = _run(side, ["set-cc-mode", "-m", "on"], kube, mp, capsys)
        assert all(c.query_cc_mode() == "on" for c in backend.chips)
        return out

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 0
    assert got["nodes"][NODE]["labels"][L.CC_MODE_STATE_LABEL] == "on"
    assert got["pods"] == [f"keep-{i}" for i in range(N_PODS)]
    assert not got["nodes"][NODE]["unschedulable"]
    assert got["nodes"][NODE]["taints"] == []
    assert got["nodes"][NODE]["annotations"][L.EVIDENCE_ANNOTATION][
        "devices"][0]["cc"] == "on"
    assert [e["reason"] for e in got["events"]] == ["CCModeApplied"]


def test_set_cc_mode_invalid_mode_publishes_failed(monkeypatch, capsys,
                                                   tmp_path):
    def case(side, mp):
        _env(mp, tmp_path, side)
        backend = _fake(side)
        out = _run(side, ["set-cc-mode", "-m", "bogus"], _kube(side), mp,
                   capsys)
        assert all(c.query_cc_mode() == "off" for c in backend.chips)
        return out

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 1
    assert got["nodes"][NODE]["labels"][L.CC_MODE_STATE_LABEL] == "failed"
    assert [e["reason"] for e in got["events"]] == ["CCModeInvalid"]


def test_set_cc_mode_slice_abort_publishes_failed(monkeypatch, capsys,
                                                  tmp_path):
    def case(side, mp):
        _env(mp, tmp_path, side, SLICE_COORDINATION="true",
             TPU_CC_SLICE_COMMIT_TIMEOUT_S="0.3")
        backend = _fake(side)
        kube = _kube(side, slice_id="s0")
        # a live member that never acks: the quorum cannot form
        kube.set_node_annotations("other", {
            L.SLICE_HB_ANNOTATION: str(time.time() + 1000)})
        out = _run(side, ["set-cc-mode", "-m", "on"], kube, mp, capsys)
        assert all(c.query_cc_mode() == "off" for c in backend.chips)
        return out

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 1
    assert got["nodes"][NODE]["labels"][L.CC_MODE_STATE_LABEL] == "failed"
    assert [e["reason"] for e in got["events"]] == ["CCSliceAborted"]


def test_set_cc_mode_enumeration_error_publishes_failed(monkeypatch, capsys,
                                                        tmp_path):
    """The reference's fake reports an enumeration error; the port's
    device layer is the real one with no CUDA device and no CPU request.
    Both fail the flip the same way."""
    def case(side, mp):
        _env(mp, tmp_path, side)
        if side is REF:
            fake = side.module("device.fake")

            class Unenumerable(fake.FakeBackend):
                def find_tpus(self):
                    return [], "no device"

            side.module("device.base").set_backend(Unenumerable(chips=[]))
        else:
            mp.delenv(tplan.DEVICE_ENV, raising=False)
            mp.setattr(torch.cuda, "is_available", lambda: False)
        return _run(side, ["set-cc-mode", "-m", "on"], _kube(side), mp,
                    capsys)

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 1
    assert got["nodes"][NODE]["labels"][L.CC_MODE_STATE_LABEL] == "failed"
    assert [e["reason"] for e in got["events"]] == ["CCModeFailed"]


def test_set_cc_mode_without_a_card_fails_and_writes_no_state(
        monkeypatch, capsys, tmp_path):
    """No CUDA device and no CPU request: the real device layer (the
    registry's default, ``cuda``) enumerates nothing, the one-shot fails
    with rc 1, publishes ``failed``, and the mode store stays unwritten.
    Nothing falls back to the CPU by itself."""
    _env(monkeypatch, tmp_path, PORT)
    monkeypatch.delenv(tplan.DEVICE_ENV, raising=False)
    monkeypatch.delenv("TPU_CC_DEVICE_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kube = _kube(PORT)
    out = _run(PORT, ["set-cc-mode", "-m", "on"], kube, monkeypatch, capsys)
    assert out["rc"] == 1
    assert out["nodes"][NODE]["labels"][L.CC_MODE_STATE_LABEL] == "failed"
    assert L.EVIDENCE_ANNOTATION not in out["nodes"][NODE]["annotations"]
    assert not (tmp_path / PORT.name).exists()
    from tpu_cc_manager_torch.device.base import get_backend
    from tpu_cc_manager_torch.device.cudadev import CudaBackend

    assert isinstance(get_backend(), CudaBackend)


def test_doctor_offline(monkeypatch, capsys, tmp_path):
    def case(side, mp):
        _env(mp, tmp_path, side)
        backend = _fake(side)
        side.module("engine").ModeEngine(
            set_state_label=lambda v: None, backend=backend,
            evict_components=False).set_mode("on")
        return _run(side, ["doctor", "--offline"], _kube(side), mp, capsys)

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 0 and got["printed"]["ok"] is True
    assert L.DOCTOR_ANNOTATION not in got["nodes"][NODE]["annotations"]


def test_doctor_publish(monkeypatch, capsys, tmp_path):
    def case(side, mp):
        _env(mp, tmp_path, side, KUBECONFIG=str(tmp_path / "kubeconfig"))
        backend = _fake(side)
        kube = _kube(side)
        side.module("engine").ModeEngine(
            set_state_label=lambda v: kube.set_node_labels(
                NODE, {L.CC_MODE_STATE_LABEL: v}),
            backend=backend, evict_components=False).set_mode("on")
        side.module("evidence").publish_evidence(kube, NODE, backend=backend)
        return _run(side, ["doctor", "--publish"], kube, mp, capsys)

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 0 and got["printed"]["ok"] is True
    published = got["nodes"][NODE]["annotations"][L.DOCTOR_ANNOTATION]
    assert published["ok"] is True
    assert got["nodes"][NODE]["labels"][L.DOCTOR_OK_LABEL] == "true"


def test_webhook_refuses_a_missing_certificate(monkeypatch, capsys,
                                               tmp_path):
    def case(side, mp):
        _env(mp, tmp_path, side)
        return _run(side, ["webhook", "--port", "0",
                           "--cert", str(tmp_path / "missing.pem"),
                           "--key", str(tmp_path / "missing.key")],
                    _kube(side), mp, capsys)

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 1 and got["printed"] == ""


# ------------------------------------ rollout and policy-controller


def _serve(side, tmp_path, store=None, unhealthy=False):
    """Each side's own ``FakeApiServer`` over three nodes (a 2-node slice
    and a solo node, at ``off``; with ``unhealthy``, the solo node
    failed) and a ``TPUCCPolicy`` targeting ``off``, counting the
    requests it serves; returns the server, the request paths and a
    kubeconfig naming it."""
    apiserver = side.module("k8s.apiserver")
    objects = side.module("k8s.objects")
    srv = apiserver.FakeApiServer(store=store)
    paths = []
    base = srv.httpd.RequestHandlerClass

    class Counting(base):
        def parse_request(self):
            ok = super().parse_request()
            paths.append(self.path)
            return ok

    srv.httpd.RequestHandlerClass = Counting
    for name, slice_id in (("s-a", "s"), ("s-b", "s"), ("solo", None)):
        labels = {L.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice",
                  L.CC_MODE_LABEL: "off", L.CC_MODE_STATE_LABEL: "off"}
        if slice_id:
            labels[L.TPU_SLICE_LABEL] = slice_id
        if unhealthy and name == "solo":
            labels[L.CC_MODE_STATE_LABEL] = "failed"
        srv.store.add_node(objects.make_node(name, labels=labels))
    srv.store.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
        "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
        "kind": L.POLICY_KIND, "metadata": {"name": "pool"},
        "spec": {"mode": "off",
                 "nodeSelector": L.TPU_ACCELERATOR_LABEL}})
    kubeconfig = tmp_path / f"kubeconfig-{side.name}.yaml"
    kubeconfig.write_text(
        "apiVersion: v1\nkind: Config\ncurrent-context: t\n"
        "contexts: [{name: t, context: {cluster: c, user: u}}]\n"
        f"clusters: [{{name: c, cluster: {{server: \"{srv.url}\"}}}}]\n"
        "users: [{name: u, user: {}}]\n")
    return srv, paths, str(kubeconfig)


def _api_cli(side, mp, capsys, tmp_path, argv, store=None,
             unhealthy=False):
    """Run ``argv`` through ``side``'s ``main()`` against its own
    ``FakeApiServer``; what it leaves behind, and the requests served."""
    mp.setenv(tplan.DEVICE_ENV, "cpu")
    mp.setenv("TPU_CC_PLANNER_WARMUP", "0")
    if store is not None:
        store = store(side)
    srv, paths, kubeconfig = _serve(side, tmp_path, store, unhealthy)
    with srv:
        rc = side.module("__main__").main(["--kubeconfig", kubeconfig,
                                           *argv])
        out = _outcome(srv.store, rc, capsys.readouterr().out)
    out["policy_status"] = mask(srv.store.list_cluster_custom(
        L.POLICY_GROUP, L.POLICY_VERSION, L.POLICY_PLURAL)) \
        if store is None else None
    return out, paths


def test_rollout_dry_run_prints_the_plan(monkeypatch, capsys, tmp_path):
    def case(side, mp):
        return _api_cli(side, mp, capsys, tmp_path,
                        ["rollout", "-m", "on", "--dry-run"])[0]

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 0
    groups = got["printed"]["groups"]
    assert [(g["name"], g["nodes"]) for g in groups] == [
        ("node/solo", ["solo"]), ("slice/s", ["s-a", "s-b"])]
    assert {g["outcome"] for g in groups} == {"planned"}
    assert got["printed"]["preflight"]["nodes"] == 3
    # a dry run patches nothing
    assert {n["labels"][L.CC_MODE_LABEL] for n in got["nodes"].values()} \
        == {"off"}


@pytest.mark.parametrize("argv", [
    ["rollout", "-m", "bogus"],
    ["rollout", "--resume", "-m", "on"],
], ids=["bad-mode", "resume-with-mode"])
def test_rollout_refuses_bad_arguments_before_any_request(
        argv, monkeypatch, capsys, tmp_path):
    def case(side, mp):
        out, paths = _api_cli(side, mp, capsys, tmp_path, argv)
        return out, paths

    got, paths = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == 1 and got["printed"] == ""
    assert paths == []


def _no_crd(side):
    class NoCrdKube(side.module("k8s.fake").FakeKube):
        def list_cluster_custom(self, *a, **k):
            raise side.module("k8s.client").ApiException(404, "not found")

    return NoCrdKube()


@pytest.mark.parametrize("unhealthy,store,rc", [
    (False, None, 0), (True, None, 1), (False, _no_crd, 1),
], ids=["healthy", "unhealthy", "crd-missing"])
def test_policy_controller_once(unhealthy, store, rc, monkeypatch, capsys,
                                tmp_path):
    def case(side, mp):
        return _api_cli(side, mp, capsys, tmp_path,
                        ["policy-controller", "--once"], store=store,
                        unhealthy=unhealthy)[0]

    got = both_cli(case, monkeypatch, capsys, tmp_path)
    assert got["rc"] == rc
    report = got["printed"]
    if store is _no_crd:
        assert report["crd_missing"] is True
    elif unhealthy:
        assert report["unhealthy_policies"] == ["pool"]
        assert report["policies"]["pool"]["phase"] == "Degraded"
        assert report["policies"]["pool"]["failed"] == 1
    else:
        assert report["unhealthy_policies"] == []
        assert report["policies"]["pool"]["phase"] == "Converged"
        assert report["policies"]["pool"]["converged"] == 3


# -------------------------------------------------------------- simlab

SCENARIOS = sorted(str(p) for p in (
    __import__("pathlib").Path(__file__).resolve().parent.parent
    / "scenarios").glob("*.json"))


def _simlab_cli(side, argv, capsys):
    rc = side.module("__main__").main(argv)
    captured = capsys.readouterr()
    return {"rc": rc, "out": captured.out,
            "err": [line for line in captured.err.splitlines()
                    if "INVALID" in line]}


def test_simlab_validate_every_committed_scenario(capsys):
    """``simlab validate scenarios/*.json`` on both CLIs: rc 0, one
    ``ok (<nodes> nodes, <actions> actions)`` line per file, the same
    lines on both."""
    want, got = (_simlab_cli(side, ["simlab", "validate"] + SCENARIOS,
                             capsys) for side in (REF, PORT))
    assert got == want, f"port and reference differ ({VERSIONS})"
    assert got["rc"] == 0 and got["err"] == []
    lines = got["out"].splitlines()
    assert len(lines) == len(SCENARIOS) >= 16
    scenario = PORT.module("simlab.scenario")
    for path, line in zip(SCENARIOS, lines):
        sc = scenario.load_scenario(path)
        assert line == (f"{path}: ok ({sc.nodes} nodes, "
                        f"{len(sc.actions)} actions)")


def test_simlab_validate_an_invalid_document(capsys, tmp_path):
    """A scenario with an unknown key: rc 1 on both CLIs, the same
    ``INVALID`` line naming the file and the key, nothing on stdout."""
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({
        "version": 1, "name": "bad", "nodes": 4, "bogus": 1,
        "actions": [{"at": 0.0, "action": "set_mode", "mode": "on"}],
        "converge": {"mode": "on", "timeout_s": 30}}))
    want, got = (_simlab_cli(side, ["simlab", "validate", str(path)],
                             capsys) for side in (REF, PORT))
    assert got == want, f"port and reference differ ({VERSIONS})"
    assert got["rc"] == 1 and got["out"] == ""
    (line,) = got["err"]
    assert line.startswith(f"{path}: INVALID: ") and "bogus" in line
