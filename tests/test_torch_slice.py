"""The port's slice coordination (``slice_coord.py``, the quorum protocol; on an H100 host a slice is the NVLink/NVSwitch domain) held to the reference's.

The 20 cases of tests/test_slice.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and
the labels and annotations every member's node ends with, and the
Events posted must be equal on the two sides, but for the parts the case
in ``RACY`` leaves to timing.
"""

import copy
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_slice  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
MODS = (test_slice, port_twin("test_slice"))


#: the annotations that carry a commit epoch: the highest member
#: ``resourceVersion`` a leader observed
EPOCH_ANNOTATIONS = ("tpu.google.com/cc.slice.commit",
                     "tpu.google.com/cc.slice.epoch",
                     "tpu.google.com/cc.slice.done",
                     "tpu.google.com/cc.slice.ack")
_EPOCH = re.compile(r"\d+$")


def epochs_masked(snapshot):
    """The snapshot with each commit epoch read as ``<epoch>``."""
    out = copy.deepcopy(snapshot)
    for kube in out["kubes"]:
        for node in kube["nodes"].values():
            for key in EPOCH_ANNOTATIONS:
                if key in node["annotations"]:
                    node["annotations"][key] = _EPOCH.sub(
                        "<epoch>", str(node["annotations"][key]))
    return out


#: cases whose threads race the case's own end, so that the reference
#: may differ from itself run to run (``tests/torch_mirror_selfcheck.py``
#: records how often): case -> (the part compared, why)
RACY = {
    "test_per_slice_policy_divergence": (
        epochs_masked,
        "two slices commit at once into one API server, whose "
        "resourceVersion each commit epoch reads: the epochs depend on "
        "how the two slices' writes interleave"),
}


@pytest.mark.parametrize("name,params", cases(test_slice))
def test_slice_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY)
