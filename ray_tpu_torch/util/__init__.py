"""Utilities of the runtime: metrics, tracing, export events, usage."""
