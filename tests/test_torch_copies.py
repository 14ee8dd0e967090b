"""The port's copies of the JAX-free modules stay equal to the reference.

Each module below is the reference's source with only the package name
rewritten in its import statements (``tpu_cc_manager`` →
``tpu_cc_manager_torch``). Any other difference is a named exception:
a block of the reference's text and the block the port has in its place.
Each exception must occur exactly once; after the rewrite and the
exceptions the two sources must be equal, byte for byte.

The analyzer's modules (``analysis/``) take a second rewrite after the
first: every ``tpu_cc_manager`` followed by ``/`` or ``.`` names the port,
in string literals and docstrings too. That directory alone gets it
because the analyzer keys its rules on its own package's paths and dotted
names in string literals (the label-exempt directory, the labels module's
prefixes, the path-scoped rules' module sets, the simlab exemptions, the
hot-root scope, the baseline's path): with only the import rewrite the
port's analyzer would scan the port with the reference's keys. Every
other module's literals name the reference on purpose or not at all.
"""

import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_IMPORT = re.compile(r"^(\s*)(from|import)\s+tpu_cc_manager\b")
_PATH = re.compile(r"\btpu_cc_manager(?=[./])")

#: the directory whose copies take the path rewrite too
PATH_REWRITTEN = "analysis/"

COPIES = (
    "device/base.py", "device/statefile.py", "device/native.py",
    "device/gate.py", "device/holders.py", "device/fake.py",
    "device/__init__.py", "trace.py", "flightrec.py", "k8s/client.py",
    "k8s/aio.py", "k8s/aio_bridge.py", "flipexec.py", "attest.py",
    "identity.py", "engine.py", "config.py", "modes.py",
    "k8s/objects.py", "k8s/fake.py", "k8s/apiserver.py", "k8s/__init__.py",
    "obs.py", "tsring.py", "watch.py", "watchdog.py", "profiler.py",
    "evidence.py", "leader.py", "fleet.py", "labels.py", "k8s/batch.py",
    "drain.py", "slice_coord.py", "doctor.py", "agent.py", "webhook.py",
    "rollout.py", "policy.py", "fleetobs.py", "shard.py",
    "federation.py", "simlab/scenario.py", "simlab/report.py",
    "simlab/pump.py", "simlab/replica.py", "simlab/faults.py",
    "simlab/invariants.py", "simlab/runner.py", "simlab/federation.py",
    "simlab/propgen.py", "simlab/__init__.py",
    # the analyzer, in import order
    "analysis/core.py", "analysis/baseline.py", "analysis/rules.py",
    "analysis/callgraph.py", "analysis/threads.py", "analysis/lockset.py",
    "analysis/lockgraph.py", "analysis/dataflow.py",
    "analysis/asyncflow.py", "analysis/jitflow.py",
    "analysis/resourceflow.py", "analysis/manifests.py", "analysis/slo.py",
    "analysis/sarif.py", "analysis/__init__.py", "analysis/__main__.py",
)

#: module -> [(name, reference block, port block)]
EXCEPTIONS = {
    "device/base.py": [
        ("registry: cuda replaces jax and stays the default, because the "
         "port's entry points and its probe kernel ride the CUDA backend's "
         "flips; sysfs builds the PCI counterpart (device.gpu)", '''\
    - ``sysfs`` (default) — host accel sysfs tree scan (device.tpu);
    - ``jax``             — live PJRT/libtpu enumeration (device.jaxdev),
      the path that touches the real chip;
    - ``fake``            — in-memory fake (device.fake), for kind-style
      dry runs where the DaemonSet has no device plumbing at all.
    """
    name = os.environ.get("TPU_CC_DEVICE_BACKEND", "sysfs").strip().lower()
    if name == "jax":
        from tpu_cc_manager_torch.device.jaxdev import JaxTpuBackend

        return JaxTpuBackend()
    if name == "fake":
        from tpu_cc_manager_torch.device.fake import fake_backend

        return fake_backend()
    if name != "sysfs":
        raise DeviceError(
            f"unknown TPU_CC_DEVICE_BACKEND {name!r}: "
            "expected sysfs | jax | fake"
        )
    from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend

    return SysfsTpuBackend()
''', '''\
    - ``cuda`` (default) — live CUDA enumeration through torch
      (device.cudadev), the path that touches the real card;
    - ``sysfs``          — host PCI sysfs scan for the NVIDIA functions
      (device.gpu), the reference's default backend;
    - ``fake``           — in-memory fake (device.fake), for kind-style
      dry runs where the DaemonSet has no device plumbing at all.

    The default is ``cuda``, not the reference's ``sysfs``: the port's
    entry points and its probe kernel ride the CUDA backend's flips.
    """
    name = os.environ.get("TPU_CC_DEVICE_BACKEND", "cuda").strip().lower()
    if name == "cuda":
        from tpu_cc_manager_torch.device.cudadev import CudaBackend

        return CudaBackend()
    if name == "fake":
        from tpu_cc_manager_torch.device.fake import fake_backend

        return fake_backend()
    if name != "sysfs":
        raise DeviceError(
            f"unknown TPU_CC_DEVICE_BACKEND {name!r}: "
            "expected cuda | sysfs | fake"
        )
    from tpu_cc_manager_torch.device.gpu import SysfsGpuBackend

    return SysfsGpuBackend()
'''),
        ("registry: get_backend's default is cuda, for the same reason", '''\
    (sysfs unless overridden)."""''', '''\
    (cuda unless overridden)."""'''),
    ],
    "config.py": [
        ("probe-devices --backend takes cuda | sysfs | fake; the default "
         "is cuda, the live card, as jax is the reference's live chip", '''\
             "Default backend: jax — the live TPU runtime, i.e. hardware "
             "truth; pass --backend sysfs to inspect the surface a "
             "sysfs-backend agent actually manages.",
    )
    probe.add_argument(
        "--backend",
        choices=("jax", "sysfs", "fake"),
        default=os.environ.get("TPU_CC_DEVICE_BACKEND", "jax"),
        help="device backend to probe (env TPU_CC_DEVICE_BACKEND; "
             "default jax)",''', '''\
             "Default backend: cuda — the live CUDA devices, i.e. hardware "
             "truth; pass --backend sysfs to inspect the surface a "
             "sysfs-backend agent actually manages.",
    )
    probe.add_argument(
        "--backend",
        choices=("cuda", "sysfs", "fake"),
        default=os.environ.get("TPU_CC_DEVICE_BACKEND", "cuda"),
        help="device backend to probe (env TPU_CC_DEVICE_BACKEND; "
             "default cuda)",'''),
    ],
    "analysis/core.py": [
        ("the default surface is the port's package: scripts, bench.py "
         "and __graft_entry__.py belong to the reference, and chip_smoke.py "
         "is a measurement harness", '''\
DEFAULT_TARGETS = ("tpu_cc_manager", "scripts", "bench.py", "__graft_entry__.py")
''', '''\
DEFAULT_TARGETS = ("tpu_cc_manager_torch",)
'''),
        ("the kernel-launch pass runs beside jitflow: its import", '''\
        jitflow,
        lockgraph,
''', '''\
        jitflow,
        launchflow,
        lockgraph,
'''),
        ("the kernel-launch pass runs beside jitflow, over the same audits, "
         "call graph and thread roots", '''\
    findings.extend(jitflow.jitflow_findings(audits, graph, roots))
''', '''\
    findings.extend(jitflow.jitflow_findings(audits, graph, roots))
    findings.extend(launchflow.launchflow_findings(audits, graph, roots))
'''),
    ],
    "analysis/rules.py": [
        ("the metric-name pattern matches the port's package name as it "
         "matches the reference's, and neither is a metric", '''\
_METRIC_IGNORE = {"tpu_cc_manager"}
''', '''\
_METRIC_IGNORE = {"tpu_cc_manager", "tpu_cc_manager_torch"}
'''),
    ],
}


def rewrite_imports(text: str) -> str:
    """The reference source as the port imports it: ``tpu_cc_manager``
    becomes ``tpu_cc_manager_torch`` in import statements only."""
    out = []
    for line in text.splitlines(keepends=True):
        m = _IMPORT.match(line)
        if m:
            line = line[:m.end()] + "_torch" + line[m.end():]
        out.append(line)
    return "".join(out)


def rewrite_paths(text: str) -> str:
    """``text`` with every ``tpu_cc_manager`` followed by ``/`` or ``.``
    naming the port: paths and dotted names, in code and literals."""
    return _PATH.sub("tpu_cc_manager_torch", text)


def reference_as_port(module: str) -> str:
    """The reference's ``module`` rewritten as its copy's rule says."""
    text = rewrite_imports((ROOT / "tpu_cc_manager" / module).read_text())
    return rewrite_paths(text) if module.startswith(PATH_REWRITTEN) else text


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_its_reference(module):
    want = reference_as_port(module)
    for name, ref_block, port_block in EXCEPTIONS.get(module, ()):
        assert want.count(ref_block) == 1, (
            f"{module}: exception {name!r} no longer matches the reference")
        want = want.replace(ref_block, port_block)
    got = (ROOT / "tpu_cc_manager_torch" / module).read_text()
    if got != want:
        import difflib

        diff = "".join(difflib.unified_diff(
            want.splitlines(keepends=True), got.splitlines(keepends=True),
            f"reference/{module} (rewritten)", f"port/{module}", n=1))
        pytest.fail(f"{module} drifted from its reference:\n{diff[:4000]}")


def test_the_rewrite_touches_import_statements_only():
    src = ('"""see tpu_cc_manager.engine"""\n'
           "from tpu_cc_manager import device as devlayer\n"
           "    from tpu_cc_manager.device.base import DeviceError\n"
           "import tpu_cc_manager.trace\n"
           "x = 'python -m tpu_cc_manager'\n"
           "from tpu_cc_manager_torch import plan\n")
    assert rewrite_imports(src) == (
        '"""see tpu_cc_manager.engine"""\n'
        "from tpu_cc_manager_torch import device as devlayer\n"
        "    from tpu_cc_manager_torch.device.base import DeviceError\n"
        "import tpu_cc_manager_torch.trace\n"
        "x = 'python -m tpu_cc_manager'\n"
        "from tpu_cc_manager_torch import plan\n")


def test_the_path_rewrite_names_the_port_in_paths_and_dotted_names():
    src = ('''"""python -m tpu_cc_manager.analysis"""\n'''
           "from tpu_cc_manager import labels\n"
           'X = ("tpu_cc_manager/simlab/", "tpu_cc_manager.labels.")\n'
           'T = ("tpu_cc_manager", "tpu_cc_manager_torch/plan.py")\n')
    assert rewrite_paths(rewrite_imports(src)) == (
        '''"""python -m tpu_cc_manager_torch.analysis"""\n'''
        "from tpu_cc_manager_torch import labels\n"
        'X = ("tpu_cc_manager_torch/simlab/", '
        '"tpu_cc_manager_torch.labels.")\n'
        'T = ("tpu_cc_manager", "tpu_cc_manager_torch/plan.py")\n')
