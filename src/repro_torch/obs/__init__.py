"""Observability of the port: typed metrics, the tick-clocked tracer, the
Chrome-trace export and flight recorder (``export``), per-request
attribution (``attrib``), the SLO health monitor (``health``) and the
device-time profiler (``profile``)."""

from repro_torch.obs.profile import (  # noqa: F401
    DeviceProfiler,
    device_events_available,
    measure,
)
