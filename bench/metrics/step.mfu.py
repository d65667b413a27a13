"""The model's forward and backward operations a step (bench/yardstick.py),
over the window's seconds, as a share of the bf16 peak of the cards the
cell uses."""


def read(rec):
    return 100.0 * rec["flops_per_step"] * rec["steps"] / rec["window_s"] \
        / (rec["peaks"]["bf16_flops"] * rec["chips"])
