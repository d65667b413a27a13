"""Device milliseconds a profiled step of the operations launched inside the
program's span ``model.ssm`` (each Mamba2 mixer's forward: projections,
conv, the SSD chunk loop, the gated norm and the out projection, every node
and layer; its backward's launches fall in ``model.backward``)."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, lambda name: name == "model.ssm")
