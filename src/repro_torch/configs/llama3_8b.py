"""llama3-8b [arXiv:2407.21783] — dense GQA kv=8, 128k vocab."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3-8b",
    family="dense",
    source="arXiv:2407.21783",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    engine_rows=1,
))
