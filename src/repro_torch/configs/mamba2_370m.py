"""Mamba2-370M: attention-free SSD [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMSpec(d_inner=2048, d_state=128, n_heads=32, n_groups=1, chunk=256),
    source="arXiv:2405.21060",
)
