"""The rows of the busiest held expert over the held experts' mean, the
largest over the MoE layers and averaged over the nodes: the program's step
metric ``moe_max_load``, averaged over the window's steps (the record's
``step_metrics``, which a harness that keeps the step's metrics gives);
None without it."""


def read(rec):
    value = (rec.get("step_metrics") or {}).get("moe_max_load")
    return None if value is None else float(value)
