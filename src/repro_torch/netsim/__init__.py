from repro_torch.netsim.controller import Phase, PhasePlan

__all__ = ["Phase", "PhasePlan"]
