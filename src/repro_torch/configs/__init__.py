"""Assigned architecture configs (exact published dims) + input shapes."""
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeSpec,
                                      get_config, input_specs,
                                      runnable_cells, shape_skipped)

__all__ = ["ARCH_IDS", "SHAPES", "ShapeSpec", "get_config",
           "input_specs", "runnable_cells", "shape_skipped"]
