"""Zamba2-7B: Mamba2 backbone with a SHARED attention block applied every 6th layer
[arXiv:2411.15242]. The shared block's params are reused at every application —
implemented as true parameter sharing, exercised by the hybrid scan driver."""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm=SSMSpec(d_inner=2 * 3584, d_state=64, n_heads=112, n_groups=2, chunk=256),
    hybrid_period=6,
    source="arXiv:2411.15242",
)
