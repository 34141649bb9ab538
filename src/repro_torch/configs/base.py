"""Architecture configuration system.

Every assigned architecture gets one ``ArchConfig`` (exact sizes from the
assignment table, source cited in ``source``) plus a ``reduced()`` variant
used by CPU smoke tests (2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "vlm", "audio", "hybrid")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    # capacity factor for all_to_all dispatch (tokens per expert slot)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD (arXiv:2405.21060)."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4

    def num_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style RG-LRU + local attention (arXiv:2402.19427)."""
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # 1:2 attn:rglru
    window: int = 2048
    lru_width: Optional[int] = None  # defaults to d_model


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (Whisper, arXiv:2212.04356)."""
    enc_layers: int = 6
    enc_max_frames: int = 1500  # 30s audio at 50Hz after conv stub


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend STUB: precomputed embeddings of this many tokens
    are prepended (vlm) or cross-attended (audio). Per the assignment this
    is the single allowed stub."""
    kind: str  # 'vision' | 'audio'
    num_embeds: int  # patch / frame count at the backbone interface
    embed_width: int = 0  # stub embedding width (0 -> d_model)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # one of FAMILIES
    source: str  # citation from the assignment table

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads

    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    frontend: Optional[FrontendConfig] = None

    # sliding window (tokens) used for the sub-quadratic long_500k decode
    # variant on dense archs; archs with native windows set it natively.
    long_context_window: int = 16384

    # ---- parallelism plan (DESIGN.md §4) ----
    engine_rows: int = 1  # r: data-axis rows per engine tile
    max_decode_context: int = 1 << 20

    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def kv_cache_dims_per_token(self) -> int:
        """Per-token, per-layer KV cache width (elements), unsharded."""
        if self.family == "ssm":
            return 0
        if self.mla is not None:
            return self.mla.kv_lora_rank + self.mla.qk_rope_head_dim
        return 2 * self.num_kv_heads * self.resolved_head_dim

    def num_params(self) -> int:
        """Approximate total parameter count (used for roofline MODEL_FLOPS
        and memory budgeting; exact enough at the 1% level)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        p = V * d  # embedding
        if not self.tie_embeddings:
            p += V * d
        for _ in range(1):  # closed forms below already multiply by L
            pass
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = s.num_heads(d)
            per = (d * (2 * d_in + 2 * s.d_state + nh)  # z,x + B,C + dt
                   + d_in * d  # out_proj
                   + s.conv_width * (d_in + 2 * s.d_state)
                   + 2 * d + d_in)  # norms
            return p + L * per
        # attention params
        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_hd
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.num_heads * m.v_head_dim * d)
        else:
            attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
                + self.num_heads * hd * d
        # ffn params
        if self.moe is not None:
            e = self.moe
            ffn = (e.num_experts + e.num_shared_experts) * 3 * d * e.d_ff_expert \
                + d * e.num_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        if self.hybrid is not None:
            # rglru layers replace attention with gated linear recurrence
            pat = self.hybrid.pattern
            n_attn = sum(1 for k in pat if k == "attn") * (L // len(pat)) \
                + sum(1 for k in pat[: L % len(pat)] if k == "attn")
            n_rec = L - n_attn
            w = self.hybrid.lru_width or d
            rec = 2 * d * w + w * d + 3 * w + self.hybrid.window * 0 \
                + 4 * w * 4  # conv1d + gates (approx)
            return p + n_attn * per_layer + n_rec * (rec + ffn + 2 * d)
        return p + L * per_layer

    def active_params(self) -> int:
        """Activated params per token (MoE: shared + top_k experts)."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        total = self.num_params()
        all_expert = e.num_experts * 3 * self.d_model * e.d_ff_expert * self.num_layers
        act_expert = (e.top_k + e.num_shared_experts) * 3 * self.d_model \
            * e.d_ff_expert * self.num_layers
        return total - all_expert + act_expert - e.num_shared_experts * 3 \
            * self.d_model * e.d_ff_expert * self.num_layers * 0

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny sizes."""
        kw: dict = dict(
            name=self.name + "-reduced",
            num_layers=2,
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
        )
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        if self.num_kv_heads and self.num_heads % self.num_kv_heads == 0:
            kv = max(1, heads // max(1, self.num_heads // self.num_kv_heads))
        kw.update(num_heads=heads, num_kv_heads=kv,
                  head_dim=(64 if self.head_dim else 0),
                  d_ff=min(self.d_ff, 512) if self.d_ff else 0,
                  engine_rows=1)
        if self.moe is not None:
            # capacity_factor = E guarantees zero token drops, making the
            # reduced variant deterministic across batch partitionings
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=128, capacity_factor=4.0,
                num_shared_experts=min(self.moe.num_shared_experts, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=96,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=32, head_dim=32,
                                            chunk=32)
        if self.hybrid is not None:
            kw["hybrid"] = dataclasses.replace(self.hybrid, window=64)
        if self.enc_dec is not None:
            kw["enc_dec"] = EncDecConfig(enc_layers=2, enc_max_frames=64)
        if self.frontend is not None:
            kw["frontend"] = dataclasses.replace(self.frontend, num_embeds=16)
        kw["long_context_window"] = min(self.long_context_window, 128)
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        stablelm_1_6b, deepseek_v2_236b, qwen3_4b, mistral_large_123b,
        phi35_moe_42b, llama3_8b, mamba2_2_7b, internvl2_1b, whisper_base,
        recurrentgemma_9b, paper_models)
