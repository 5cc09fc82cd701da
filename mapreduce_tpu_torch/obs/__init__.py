"""Observability of the port: phase spans on the profiler timeline."""
