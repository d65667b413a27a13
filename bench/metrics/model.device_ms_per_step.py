"""Device milliseconds a profiled step of the operations launched inside the
program's spans ``model.forward`` and ``model.backward`` (the backward's
launches from the autograd thread included)."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, lambda name: name.startswith("model."))
