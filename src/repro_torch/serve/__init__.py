"""Persistent collaborative-sampling serve runtime (cross-wave prefix
cache + shape-stable wave scheduler + runtime loop) layered on the
planner/executor engine.  See serve/runtime.py for the architecture
notes."""
from repro_torch.serve.prefix_cache import CacheStats, PrefixCache
from repro_torch.serve.runtime import RequestTicket, ServeConfig, ServeRuntime
from repro_torch.serve.scheduler import Wave, WaveBucket, WaveScheduler, tier

__all__ = ["CacheStats", "PrefixCache", "RequestTicket", "ServeConfig",
           "ServeRuntime", "Wave", "WaveBucket", "WaveScheduler", "tier"]
