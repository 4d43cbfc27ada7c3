"""Host utilities: timers and tracing, the device-memory budget and the host
allocator."""
from .platform import device_memory_stats, free_hbm_bytes
from .timers import PhaseTimers, maybe_trace
