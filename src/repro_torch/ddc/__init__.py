"""Public DDC API of the port: one estimator facade, pluggable backends.

    from repro_torch.ddc import DDC, DDCConfig
    model = DDC(DDCConfig(backend="jit", shards=8)).fit(points)

Counterpart of the reference package's ``repro.ddc``.  The implementation
primitives stay importable where they live — ``repro_torch.core.ddc``
(ddc_host, make_ddc_fn, merge_many, …) and ``repro_torch.serve``
(the query tier) — and the facade delegates to them; they are re-exported
here for discoverability.
"""
from repro_torch.core.ddc import (
    ClusterSet,
    CommMeter,
    ddc_host,
    make_ddc_fn,
    same_clustering,
)
from repro_torch.ddc.api import DDC, SNAPSHOT_FORMAT, SnapshotError
from repro_torch.ddc.backends import BACKENDS, Backend, register_backend
from repro_torch.ddc.config import ConfigError, DDCConfig
from repro_torch.serve.query_tier import (
    QueryResult,
    QueryTier,
    QueueFull,
    ServiceCounters,
    ServiceGauges,
    ServiceStats,
    Snapshot,
)

__all__ = [
    "DDC", "DDCConfig", "ConfigError", "SNAPSHOT_FORMAT", "SnapshotError",
    "BACKENDS", "Backend", "register_backend",
    "ClusterSet", "CommMeter", "ddc_host", "make_ddc_fn",
    "same_clustering",
    "QueryResult", "QueryTier", "QueueFull", "Snapshot",
    "ServiceStats", "ServiceCounters", "ServiceGauges",
]
