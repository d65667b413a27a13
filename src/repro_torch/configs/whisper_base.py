"""Whisper-base: 6L encoder + 6L decoder, d=512, 8 heads [arXiv:2212.04356].
Mel-spectrogram + conv frontend is a STUB: input_specs provides the 1500 encoder
frames; encoder self-attn, decoder self+cross attention are fully real."""
from repro_torch.configs.base import ArchConfig, FrontendSpec

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    norm="ln",
    act="gelu",
    frontend=FrontendSpec(kind="audio", n_tokens=1500, dim=512),
    source="arXiv:2212.04356",
)
