"""qwen3-8b [hf:Qwen/Qwen3-8B].

36L, d_model=4096, 32H (GQA kv=8, head_dim=128), d_ff=12288, vocab=151936;
qk_norm (RMSNorm on per-head q/k).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    head_dim=128,
    d_ff=12288,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv=2, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", activ_dtype="float32",
    )
