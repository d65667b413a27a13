"""DeepSeek-V2-Lite (16B): MLA attention (kv_lora=512) + fine-grained MoE,
2 shared + 64 routed top-6 [arXiv:2405.04434]."""
from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mla=MLASpec(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoESpec(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                dense_layers=(0,), d_ff_dense=10944),
    source="arXiv:2405.04434",
)
