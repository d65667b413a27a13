"""Device milliseconds a profiled step of the operations launched inside the
gossip rounds (the program's spans ``gossip.*``) and the exchanges
(``transport.*`` but ``transport.metric``): the wire kernels, the rolls of
the payloads, the mixes and the replica updates."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, spans.gossip_span)
