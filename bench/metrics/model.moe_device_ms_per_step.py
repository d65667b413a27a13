"""Device milliseconds a profiled step of the operations launched inside the
program's spans ``model.moe.route`` (the router's products, softmax, top-k,
sort and gather) and ``model.moe.experts`` (the held experts' grouped
products and the weighted sum back into the tokens): the dropless MoE's
forward; its backward's launches fall in ``model.backward``."""
from bench import spans


def read(rec):
    return spans.device_ms(rec, lambda name: name.startswith("model.moe."))
