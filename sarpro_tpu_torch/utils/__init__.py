"""Utilities: structured logging/tracing and device profiling."""
