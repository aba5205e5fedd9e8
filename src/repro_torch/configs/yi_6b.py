"""yi-6b [arXiv:2403.04652] — llama-architecture GQA.

32L, d_model=4096, 32H (GQA kv=4), d_ff=11008, vocab=64000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv=2, d_ff=256,
        vocab=512, param_dtype="float32", activ_dtype="float32",
    )
