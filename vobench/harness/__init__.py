"""The benchmark's harness: traffic generation, the runs of the program's
entries, the readings of the trace and the comparison that decides
``correct``. ``python3 vobench/run.py`` is its command."""
