"""qwen3-4b [hf:Qwen/Qwen3-8B family] — dense, GQA kv=8, qk_norm,
head_dim=128 (decoupled from d_model/num_heads as in Qwen3)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    engine_rows=1,
))
