"""NVIDIA Nemotron 3 Nano 30B-A3B (``nemotron_h``): 52 pre-norm residual
layers in the pattern ``hybrid_override_pattern`` (23 Mamba2 mixers 'M', 23
expert layers 'E', 6 attention layers '*'), d_model 2688, vocab 131,072,
untied head.  Mamba2: 64 heads of 64, state 128, 8 groups, conv 4 with a
bias, chunk 128, the gate-first norm over 8 groups.  Experts: a sigmoid
router over 128, top 6, the chosen scores normalized and scaled by 2.5, non-
gated relu^2 experts of 1,856 and one shared expert of 3,712 (``n_shared``
2 of the expert width: the same function).  Attention: GQA, 32 query heads
and 2 KV heads of 128, no position encoding (Nemotron-H's attention is
Jamba's).  31,577,937,344 parameters (the aux-loss-free routing bias, 128 a
layer held at 0, is not a leaf).
Source: https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16/blob/main/config.json
"""
from repro_torch.configs.base import ArchConfig, MoESpec, SSMSpec

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ArchConfig(
    name="nemotron-3-nano-30b",
    family="hybrid",
    n_layers=len(PATTERN),
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    d_ff=1856,
    vocab=131072,
    head_dim=128,
    moe=MoESpec(n_routed=128, n_shared=2, top_k=6, d_expert=1856, capacity_factor=None,
                dense_layers=(), norm_topk=True, score="sigmoid", routed_scale=2.5,
                act="relu2"),
    ssm=SSMSpec(d_inner=4096, d_state=128, n_heads=64, n_groups=8, chunk=128,
                gate_first=True),
    layer_pattern=PATTERN,
    rope=False,
    source="https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16",
)
