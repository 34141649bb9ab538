"""whisper-base [arXiv:2212.04356] — enc-dec; mel+conv frontend STUB
(frame embeddings supplied precomputed). 6L encoder + 6L decoder,
d_model=512, 8H."""
from repro_torch.configs.base import ArchConfig, EncDecConfig, FrontendConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    enc_dec=EncDecConfig(enc_layers=6, enc_max_frames=1500),
    frontend=FrontendConfig(kind="audio", num_embeds=1500),
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions
    engine_rows=1,
    max_decode_context=448,
))
