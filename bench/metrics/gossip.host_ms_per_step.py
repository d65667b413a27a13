"""Self host milliseconds a step of the gossip rounds (the program's spans
``gossip.*``) and of every exchange (``transport.*`` but the metrics'
``transport.metric``) over the traced window."""
from bench import spans


def read(rec):
    return spans.host_ms(rec, spans.gossip_span)
