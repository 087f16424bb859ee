"""Architecture configs the port runs (twin of ``repro/configs``)."""

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, ArchConfig,
                                      InputShape, get_arch)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "ArchConfig", "InputShape",
           "get_arch"]
