"""Self host milliseconds a step of the model's forward and backward (the
program's spans ``model.forward`` and ``model.backward``) over the traced
window."""
from bench import spans


def read(rec):
    return spans.host_ms(rec, lambda name: name.startswith("model."))
