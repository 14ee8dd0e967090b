"""First-party Kubernetes API access.

The reference leans on two heavyweight dependencies for this: ~45 MB of
vendored client-go for the Go agent (reference go.mod:7-13, vendor/) and
the ``kubernetes`` Python client for the Python agent (reference
requirements.txt:2). This build replaces both with one small stdlib
client speaking the REST API directly — node get/list/patch/replace, pod
list/delete/evict, and the watch protocol (streamed JSON events with
resourceVersion resume and 410 handling), which is the *entire* API
surface the agents use (SURVEY.md §3.5).

- :class:`~tpu_cc_manager.k8s.client.KubeClient` — the interface.
- :class:`~tpu_cc_manager.k8s.client.HttpKubeClient` — stdlib
  http.client + ssl impl; in-cluster service-account config or kubeconfig.
- :class:`~tpu_cc_manager.k8s.fake.FakeKube` — in-memory clientset with a
  real watch implementation (rv history, 410 compaction, error
  injection) for the test pyramid.
- :mod:`~tpu_cc_manager.k8s.apiserver` — an HTTP server exposing a
  FakeKube over the real wire protocol, for integration tests of the
  C++ agent / bash engine / HttpKubeClient, and for the bench.
"""

from tpu_cc_manager_torch.k8s.client import (
    ApiException,
    ConflictError,
    HttpKubeClient,
    KubeClient,
)
from tpu_cc_manager_torch.k8s.fake import FakeKube

__all__ = [
    "ApiException",
    "ConflictError",
    "HttpKubeClient",
    "KubeClient",
    "FakeKube",
]
