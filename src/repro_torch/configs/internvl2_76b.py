"""InternVL2-Llama3-76B backbone: InternLM2/Llama3-70B-style LM consuming InternViT
patch embeddings via an MLP projector [arXiv:2404.16821]. Vision encoder is a STUB
(input_specs provides patch embeddings); the 80-layer GQA decoder is fully real."""
from repro_torch.configs.base import ArchConfig, FrontendSpec

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    rope_theta=5e5,
    frontend=FrontendSpec(kind="vision", n_tokens=256, dim=3200),  # InternViT-6B width
    source="arXiv:2404.16821",
)
