from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adamw,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    sgd,
)

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm", "make_optimizer", "sgd"]
