"""Device milliseconds of the program's wire kernels a profiled step."""


def read(rec):
    prof = rec["profile"]
    if not prof or not prof["wire_s"]:
        return None
    return 1e3 * prof["wire_s"] / prof["steps"]
