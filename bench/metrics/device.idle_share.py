"""The share of a step in which no operation ran on the device, in %: the
device's busy seconds a profiled step (the profiler's trace) over the mean
step of the same run's window, which runs without the profiler (its host
clock would stretch the steps it traces)."""


def read(rec):
    prof = rec["profile"]
    if not prof or not rec["step_s"]:
        return None
    step_s = sum(rec["step_s"]) / len(rec["step_s"])
    return 100.0 * (1.0 - prof["busy_s"] / prof["steps"] / step_s)
