"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b] — dense, GQA kv=32 (MHA)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    engine_rows=1,
))
