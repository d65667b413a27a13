"""Device milliseconds a profiled step of the operations launched inside the
program's span ``model.mla`` (latent attention's forward, every node and
layer; its backward's launches fall in ``model.backward``)."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, lambda name: name == "model.mla")
