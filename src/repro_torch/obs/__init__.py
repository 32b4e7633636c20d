"""Observability of the port: typed metrics and the tick-clocked tracer."""
