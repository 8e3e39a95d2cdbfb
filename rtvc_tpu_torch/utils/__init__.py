"""Utilities of the port: step timers (``profiling``) and run logging
(``logging``)."""
