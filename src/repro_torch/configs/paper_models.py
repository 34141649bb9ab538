"""The paper's own evaluation models (§6.1.2), as additional configs so
benchmarks can be run against the same model set the paper used:
Llama-3-70B (dense), GPT-OSS-120B (MoE), Nemotron-8B (ultra-long ctx)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

LLAMA3_70B = register(ArchConfig(
    name="paper-llama3-70b",
    family="dense",
    source="arXiv:2407.21783 (paper eval model)",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500000.0,
    engine_rows=2,
))

GPT_OSS_120B = register(ArchConfig(
    name="paper-gpt-oss-120b",
    family="moe",
    source="arXiv:2508.10925 (paper eval model)",
    num_layers=36,
    d_model=2880,
    num_heads=64,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2880,
    vocab_size=201088,
    moe=MoEConfig(num_experts=128, top_k=4, d_ff_expert=2880),
    rope_theta=150000.0,
    engine_rows=2,
))

NEMOTRON_8B = register(ArchConfig(
    name="paper-nemotron-8b",
    family="dense",
    source="arXiv:2504.06214 (paper eval model, 4M ctx)",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=131072,
    rope_theta=10000000.0,
    engine_rows=1,
    max_decode_context=1 << 22,
))
