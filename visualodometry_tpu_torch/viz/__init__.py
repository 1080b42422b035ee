"""Visualization sinks (host-side, optional)."""
