"""Measurement (``profiling/instrument.py::Profiler``): host time of the
Profiler's ``on_step`` hook a step, as the benchmark's span around it
measures it."""
UNIT = "us"


def read(rec):
    s = rec["spans"].get("measure")
    return sum(s) / len(s) * 1e6 if s else None
