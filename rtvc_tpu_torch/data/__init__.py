"""Data plumbing of the port: checkpoint I/O (``io``)."""
