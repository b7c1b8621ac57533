"""Serving: the LM stack's prefill/decode engine, the DDC facade's query
tier and fault-injection plan, and the streaming DDC engine
(``cluster_service``: host-mirror control plane + data plane on the
device; ``journal``: its write-ahead recovery log).

The stream engine's re-exports are lazy (PEP 562), so importing the LM
engine does not pull in the clustering stack.
"""
from . import engine, faults, query_tier  # noqa: F401

_CLUSTER_EXPORTS = ("ClusterService", "ShardControlPlane", "StreamConfig")
_JOURNAL_EXPORTS = ("Journal",)


def __getattr__(name):
    if name in _CLUSTER_EXPORTS:
        from repro_torch.serve import cluster_service
        return getattr(cluster_service, name)
    if name in _JOURNAL_EXPORTS:
        from repro_torch.serve import journal
        return getattr(journal, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
