from repro_torch.netsim.controller import (
    Phase, PhasePlan, candidate_fidelity, candidate_iter_time,
    load_dryrun_records, plan_phases, plan_phases_measured, record_iter_time,
)
from repro_torch.netsim.cost_model import (
    BEST_NETWORK, HIGH_LAT, LOW_BW, WORST,
    CommStrategy, LinkModel, NetworkCondition, comm_time, comm_time_tail,
    epoch_time, expected_payloads, failure_trace, iter_time,
    sample_comm_times, straggler_curve, strategies, strategies_for,
)

__all__ = [
    "BEST_NETWORK", "HIGH_LAT", "LOW_BW", "WORST", "CommStrategy", "LinkModel",
    "NetworkCondition", "Phase", "PhasePlan", "candidate_fidelity", "candidate_iter_time",
    "comm_time", "comm_time_tail", "epoch_time", "expected_payloads", "failure_trace",
    "iter_time", "load_dryrun_records", "plan_phases", "plan_phases_measured",
    "record_iter_time", "sample_comm_times", "straggler_curve", "strategies", "strategies_for",
]
