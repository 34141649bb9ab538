"""internvl2-1b [arXiv:2404.16821] — VLM: InternViT frontend (STUB: patch
embeddings supplied precomputed) + InternLM2-style 24L LM backbone,
GQA kv=2."""
from repro_torch.configs.base import ArchConfig, FrontendConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    frontend=FrontendConfig(kind="vision", num_embeds=256, embed_width=1024),
    rope_theta=1000000.0,
    engine_rows=1,
))
