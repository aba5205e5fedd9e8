from repro_torch.configs.base import (
    ALIASES,
    ARCH_IDS,
    PORTED_ARCHS,
    ModelConfig,
    get_config,
)
