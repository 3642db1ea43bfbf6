from foley_tpu_torch.configs.model_configs import (
    ClapTextConfig,
    DACConfig,
    DiffusionConfig,
    MMDiTConfig,
    PipelineConfig,
    SynchformerConfig,
    TINY,
    XL,
    XXL,
    YAML_DIR,
    config_from_yaml,
    get_config,
)

__all__ = [
    "ClapTextConfig",
    "DACConfig",
    "DiffusionConfig",
    "MMDiTConfig",
    "PipelineConfig",
    "SynchformerConfig",
    "TINY",
    "XL",
    "XXL",
    "YAML_DIR",
    "config_from_yaml",
    "get_config",
]
