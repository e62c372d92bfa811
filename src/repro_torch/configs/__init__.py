from .registry import ARCH_IDS, get_config, get_smoke_config, list_archs
from .shapes import SHAPES, input_specs, shape_kind

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "get_smoke_config",
           "input_specs", "list_archs", "shape_kind"]
