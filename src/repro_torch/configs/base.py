"""Architecture configuration and the config registry (port of
``repro.configs.base``).

Every architecture has a module ``repro_torch/configs/<id>.py`` whose
``CONFIG`` is a ``ModelConfig`` with the published hyper-parameters, plus
a ``reduced()`` variant for CPU tests.  Only the dense decoder-only archs
are ported so far; ``get_config`` raises ``NotImplementedError`` for the
others, and the config fields of those archs (MoE, SSM, xLSTM, enc-dec,
VLM, training) come with the slice that first reads them.  Dtypes are
strings (``"bfloat16"``); ``models.param.torch_dtype`` maps them to torch
dtypes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    mlp: str = "swiglu"            # swiglu | geglu | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma: scale embeddings by sqrt(d_model)
    # layer stacking: an optional explicit prefix + a repeating period of
    # (mixer, ffn) slots; None period -> [("attn", "dense")]
    prefix_pattern: Tuple[Tuple[str, str], ...] = ()
    period_pattern: Optional[Tuple[Tuple[str, str], ...]] = None
    # dtypes: full configs run bf16 params/activations; reduced test configs
    # switch to f32 for CPU numerics
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"
    enc_dec: bool = False          # encoder-decoder (whisper)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        from repro_torch.models.model import build_decls_any
        from repro_torch.models.param import count_params
        return count_params(build_decls_any(self))


ARCH_IDS = [
    "jamba_v01_52b",
    "qwen15_05b",
    "qwen3_8b",
    "gemma_2b",
    "yi_6b",
    "deepseek_moe_16b",
    "phi35_moe_42b",
    "internvl2_26b",
    "xlstm_125m",
    "whisper_medium",
]

# external ids (with dashes/dots) -> module names
ALIASES = {
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen1.5-0.5b": "qwen15_05b",
    "qwen3-8b": "qwen3_8b",
    "gemma-2b": "gemma_2b",
    "yi-6b": "yi_6b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "internvl2-26b": "internvl2_26b",
    "xlstm-125m": "xlstm_125m",
    "whisper-medium": "whisper_medium",
}

# the dense decoder-only archs, the ones the port serves so far
PORTED_ARCHS = ("qwen15_05b", "qwen3_8b", "gemma_2b", "yi_6b")


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}")
    if mod_name not in PORTED_ARCHS:
        raise NotImplementedError(
            f"{arch}: only the dense archs {PORTED_ARCHS} are ported; MoE, "
            "SSM/hybrid, xLSTM, VLM and enc-dec wait for ROADMAP A20")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.CONFIG
