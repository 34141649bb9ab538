"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts
top-2, GQA kv=8. Engine tile r=2 (42B bf16 = 84GB / 32 chips)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                  num_shared_experts=0),
    rope_theta=10000.0,
    engine_rows=2,
))
