"""recurrentgemma-9b [arXiv:2402.19427] — hybrid RG-LRU + local attention,
1 attn : 2 recurrent, window 2048, MQA kv=1."""
from repro_torch.configs.base import ArchConfig, HybridConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    hybrid=HybridConfig(pattern=("rglru", "rglru", "attn"), window=2048),
    rope_theta=10000.0,
    engine_rows=1,
))
