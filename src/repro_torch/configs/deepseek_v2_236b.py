"""deepseek-v2-236b [arXiv:2405.04434] — MoE 160e top-6, MLA kv_lora=512,
2 shared experts. Engine tile r=8 (DESIGN.md §4): 236B bf16 needs >=128
chips per replica."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,  # dense FFN in first layer(s); experts use d_ff_expert
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2),
    rope_theta=10000.0,
    engine_rows=8,
))
