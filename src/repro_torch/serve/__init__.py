"""Serving: the LM stack's prefill/decode engine, the DDC facade's query
tier and fault-injection plan, and the streaming DDC engine
(``cluster_service``: host-mirror control plane + data plane on the
device; ``dist_service``: the same control plane over one lane a shard,
each on its own CUDA stream on a card, with measured exchange bytes;
``journal``: the write-ahead recovery log; ``hierarchy``: the
tree of aggregators that replaces the flat one when ``agg_degree`` is
set; ``tracking``: stable track IDs, lifecycle events and motion
analytics over the refresh generations).

The stream engine's re-exports are lazy (PEP 562), so importing the LM
engine does not pull in the clustering stack.
"""
from . import engine, faults, query_tier  # noqa: F401

_CLUSTER_EXPORTS = ("ClusterService", "ShardControlPlane", "StreamConfig")
_DIST_EXPORTS = ("DistClusterService",)
_JOURNAL_EXPORTS = ("Journal",)
_HIERARCHY_EXPORTS = ("AggregatorTree",)
_TRACKING_EXPORTS = ("ClusterTracker", "TrackSnapshot", "TrackView", "TrackEvent")


def __getattr__(name):
    if name in _CLUSTER_EXPORTS:
        from repro_torch.serve import cluster_service
        return getattr(cluster_service, name)
    if name in _DIST_EXPORTS:
        from repro_torch.serve import dist_service
        return getattr(dist_service, name)
    if name in _JOURNAL_EXPORTS:
        from repro_torch.serve import journal
        return getattr(journal, name)
    if name in _HIERARCHY_EXPORTS:
        from repro_torch.serve import hierarchy
        return getattr(hierarchy, name)
    if name in _TRACKING_EXPORTS:
        from repro_torch.serve import tracking
        return getattr(tracking, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
