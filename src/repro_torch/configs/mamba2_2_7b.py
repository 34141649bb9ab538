"""mamba2-2.7b [arXiv:2405.21060] — attention-free SSD (state-space
duality), ssm_state=128. No KV cache; per-request recurrent state."""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128,
                  conv_width=4),
    engine_rows=1,
))
