"""Observability of the port: typed metrics, the tick-clocked tracer, the
Chrome-trace export and flight recorder (``export``), per-request
attribution (``attrib``) and the SLO health monitor (``health``)."""
