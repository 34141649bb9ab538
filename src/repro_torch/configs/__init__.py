from repro_torch.configs.base import ArchConfig, get_config, list_configs, register
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape

ASSIGNED_ARCHS = (
    "stablelm-1.6b",
    "deepseek-v2-236b",
    "qwen3-4b",
    "mistral-large-123b",
    "phi3.5-moe-42b-a6.6b",
    "llama3-8b",
    "mamba2-2.7b",
    "internvl2-1b",
    "whisper-base",
    "recurrentgemma-9b",
)

__all__ = [
    "ArchConfig", "InputShape", "ASSIGNED_ARCHS", "SHAPES",
    "get_config", "get_shape", "list_configs", "register",
]
