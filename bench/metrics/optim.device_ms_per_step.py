"""Device milliseconds a profiled step of the operations launched inside the
program's span ``optim.update`` (the optimizer's update of every leaf)."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, lambda name: name == "optim.update")
