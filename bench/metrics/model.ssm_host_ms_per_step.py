"""Self host milliseconds a step of the program's span ``model.ssm`` over the
traced window: the Mamba2 mixers' forward dispatch, most of it the SSD's
eager chunk loop."""
from bench import spans


def read(rec):
    return spans.host_ms(rec, lambda name: name == "model.ssm")
