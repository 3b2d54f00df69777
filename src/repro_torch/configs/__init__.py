from repro_torch.configs.base import ModelConfig, reduced  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    ALL_ARCHS, get_config, get_smoke_config)
