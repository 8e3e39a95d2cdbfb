"""Utilities of the port: step timers (``profiling``)."""
