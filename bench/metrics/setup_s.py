"""Process start to the first timed step."""


def read(rec):
    return rec["setup_s"]
