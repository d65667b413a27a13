"""The least time of the step's wire kernels (the bytes they must move at
the card's memory bandwidth, or their float32 operations at its peak,
whichever is longer), over their device time a profiled step, in %."""


def read(rec):
    prof = rec["profile"]
    if not prof or not prof["wire_s"] or not rec["wire_bound_s"]:
        return None
    return 100.0 * rec["wire_bound_s"] / (prof["wire_s"] / prof["steps"])
