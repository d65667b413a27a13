"""Tokens of every node's batches in the window's steps, over its seconds."""


def read(rec):
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
