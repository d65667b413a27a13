"""DeepSeekMoE-16B: fine-grained experts, 2 shared + 64 routed top-6, dense layer 0
[arXiv:2401.06066]."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert width
    vocab=102400,
    moe=MoESpec(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                dense_layers=(0,), d_ff_dense=10944),
    source="arXiv:2401.06066",
)
