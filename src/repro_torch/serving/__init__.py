"""Serving on the port: continuous batching over the LM decode path,
wave-granular SpMM serving over a hot-swappable handle, and the
multi-tenant fleet."""
from .fleet import ReshardSpec, SpmmFleet, rebalance_threshold
from .scheduler import (
    ContinuousBatcher, Request, ServeStats, SpmmRequest, SpmmWaveServer,
    SpmmWaveStats,
)

__all__ = ["ContinuousBatcher", "Request", "ServeStats", "SpmmRequest",
           "SpmmWaveServer", "SpmmWaveStats", "SpmmFleet", "ReshardSpec",
           "rebalance_threshold"]
