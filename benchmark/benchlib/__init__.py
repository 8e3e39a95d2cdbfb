"""The benchmark's own library: the run's records, the seeded weights and
traffic, the operation counts and peaks, the profiler's trace, and the
comparisons that decide ``correct``. It imports the program under test
only in :mod:`benchlib.program`."""
