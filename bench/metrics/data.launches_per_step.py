"""Kernels a profiled step launched inside the program's span ``data.batch``
(the data pipeline's batch call)."""
from bench import spans


def read(rec):
    return spans.launches(rec, lambda name: name == "data.batch")
