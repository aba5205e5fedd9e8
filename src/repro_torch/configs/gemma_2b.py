"""gemma-2b [arXiv:2403.08295].

18L, d_model=2048, 8H with MQA (kv=1), head_dim=256, d_ff=16384 (GeGLU),
vocab=256000; tied embeddings scaled by sqrt(d_model).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    mlp="geglu",
    tie_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv=1, head_dim=32,
        d_ff=256, vocab=512, param_dtype="float32", activ_dtype="float32",
    )
