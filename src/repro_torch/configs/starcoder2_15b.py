"""StarCoder2-15B: GQA 48H/4KV, LN + GeLU, RoPE [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    norm="ln",
    act="gelu",
    rope_theta=1e5,
    source="arXiv:2402.19173",
)
