from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ParallelConfig, RunConfig, ShapeConfig, smoke_reduce,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, get_config, get_smoke_config,
)
