"""repro_torch.configs — the architecture registry (counterpart of
``repro.configs``): ``ArchConfig`` and its specs, the ten LM
architectures (each module registers its ``CFG``), the input-shape cells
and the paper's STRELA SoC (``strela_soc``). The configs are data, equal
field by field to the reference's."""
from repro_torch.configs.base import (SHAPES, ArchConfig, EncDecSpec,
                                      MoESpec, ShapeCfg, SSMSpec, all_archs,
                                      cell_runnable, get_arch)

__all__ = ["SHAPES", "ArchConfig", "EncDecSpec", "MoESpec", "ShapeCfg",
           "SSMSpec", "all_archs", "cell_runnable", "get_arch"]
