"""Host milliseconds of the batch call a step, each closed by a synchronize
(the benchmark's own span around the data pipeline)."""


def read(rec):
    spans = rec["data_s"]
    return 1e3 * sum(spans) / len(spans) if spans else None
