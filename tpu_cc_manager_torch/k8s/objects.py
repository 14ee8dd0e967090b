"""Tiny object helpers shared by the fake store, the API server, and tests."""

from __future__ import annotations

import copy
from typing import Dict, Optional


def make_node(name: str, labels: Optional[Dict[str, str]] = None,
              annotations: Optional[Dict[str, str]] = None) -> dict:
    return {
        "kind": "Node",
        "apiVersion": "v1",
        "metadata": {
            "name": name,
            "labels": dict(labels or {}),
            "annotations": dict(annotations or {}),
            "resourceVersion": "0",
        },
        "spec": {},
        "status": {},
    }


def make_pod(name: str, namespace: str = "default",
             labels: Optional[Dict[str, str]] = None,
             node_name: Optional[str] = None) -> dict:
    return {
        "kind": "Pod",
        "apiVersion": "v1",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": dict(labels or {}),
            "resourceVersion": "0",
        },
        "spec": {"nodeName": node_name},
        "status": {"phase": "Running"},
    }


def merge_patch(target: dict, patch: dict) -> dict:
    """RFC 7386 JSON merge patch: dicts merge recursively, null deletes.

    This is the patch flavor both agents use for labels (the reference
    patches ``{"metadata": {"labels": {...}}}``,
    gpu_operator_eviction.py:165-171).
    """
    out = copy.deepcopy(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_patch(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def match_selector(labels: Dict[str, str], selector: Optional[str]) -> bool:
    """Subset of k8s label-selector syntax used by the agents:
    ``k=v``, ``k==v``, ``k!=v``, bare ``k`` (exists), comma-joined."""
    if not selector:
        return True
    for term in selector.split(","):
        term = term.strip()
        if not term:
            continue
        if "!=" in term:
            k, v = term.split("!=", 1)
            if labels.get(k.strip()) == v.strip():
                return False
        elif "==" in term:
            k, v = term.split("==", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        elif "=" in term:
            k, v = term.split("=", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        else:
            if term not in labels:
                return False
    return True
