"""Observability: the flight recorder's span and device ticket rings
and their Chrome-trace export (recorder.py)."""

from .recorder import FlightRecorder

__all__ = ["FlightRecorder"]
