from foley_tpu_torch.configs.model_configs import (
    DACConfig,
    DiffusionConfig,
    MMDiTConfig,
    PipelineConfig,
    SynchformerConfig,
    TINY,
    XL,
    XXL,
    get_config,
)

__all__ = [
    "DACConfig",
    "DiffusionConfig",
    "MMDiTConfig",
    "PipelineConfig",
    "SynchformerConfig",
    "TINY",
    "XL",
    "XXL",
    "get_config",
]
