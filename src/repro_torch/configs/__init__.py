from repro_torch.configs.base import (  # noqa: F401
    SHAPES, MLACfg, ModelConfig, MoECfg, ShapeCfg, get_config, list_configs,
    smoke_config,
)
