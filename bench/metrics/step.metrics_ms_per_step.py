"""Device milliseconds a profiled step of the operations launched inside the
program's span ``step.metrics`` (the consensus metric and the gathered
losses), whose transport calls open the only ``transport.metric`` spans."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, lambda name: name in ("step.metrics", "transport.metric"))
