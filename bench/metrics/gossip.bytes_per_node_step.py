"""Bytes the program's transport was handed in the window (its own
TransportStats, every label), a step and a node."""


def read(rec):
    return rec["sent_bytes"] / rec["steps"] / rec["nodes"] if rec["sent_bytes"] else None
