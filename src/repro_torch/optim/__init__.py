from repro_torch.optim.optimizers import (
    OptState,
    Optimizer,
    adamw,
    apply_updates,
    make_optimizer,
    sgd,
)

__all__ = ["OptState", "Optimizer", "adamw", "apply_updates", "make_optimizer", "sgd"]
