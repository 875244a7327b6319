"""Core runtime: flags, errors, places, the mesh, the profiler scopes and
the numeric guard.

Port of ``paddle_tpu.core``: the package exports what the JAX package's
exports from its flags, mesh, nan_inf, places and profiler modules. The
error types and ``enforce*`` helpers are imported from ``core.enforce``,
the host arena from ``core.allocator``, ``resolve_device`` from
``core.device``.
"""

from .flags import define_flag, flag, get_flags, set_flags
from .mesh import (HYBRID_AXES, current_mesh, make_hybrid_mesh, make_mesh, mesh_axis_size,
                   named_sharding, replicated, use_mesh)
from .nan_inf import check_numerics, count_nonfinite, nan_inf_enabled
from .places import (CPUPlace, CUDAPlace, Place, TPUPlace, device_count, get_device,
                     is_compiled_with_tpu, set_device)
from .profiler import (CostTimer, RecordEvent, host_event_stats, record_event,
                       reset_host_events, start_profiler, stop_profiler)

__all__ = ["CPUPlace", "CUDAPlace", "CostTimer", "HYBRID_AXES", "Place", "RecordEvent",
           "TPUPlace", "check_numerics", "count_nonfinite", "current_mesh", "define_flag",
           "device_count", "flag", "get_device", "get_flags", "host_event_stats",
           "is_compiled_with_tpu", "make_hybrid_mesh", "make_mesh", "mesh_axis_size",
           "nan_inf_enabled", "named_sharding", "record_event", "replicated",
           "reset_host_events", "set_device", "set_flags", "start_profiler", "stop_profiler",
           "use_mesh"]
