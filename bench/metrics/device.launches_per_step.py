"""Device kernels a profiled step, in the profiler's trace."""


def read(rec):
    prof = rec["profile"]
    return prof["launches"] / prof["steps"] if prof else None
