"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B].

24L, d_model=1024, 16H (kv=16, MHA), d_ff=2816, vocab=151936; QKV bias.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=2816,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=128, n_heads=4, n_kv=4, d_ff=256,
        vocab=512, param_dtype="float32", activ_dtype="float32",
    )
