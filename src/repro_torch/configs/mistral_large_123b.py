"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407] — dense
88L GQA kv=8. Engine tile r=2: 246GB bf16 / 32 chips = 7.7GB/chip."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1000000.0,
    engine_rows=2,
))
