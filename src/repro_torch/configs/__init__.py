"""Architecture configs: one module per ported architecture.

``get(name)`` returns the full published config; ``get(name, smoke=True)``
returns the reduced same-family config used by CPU tests.  The ten
architectures of the reference, every model family.
"""

from repro_torch.configs.base import (ARCH_REGISTRY, ModelConfig, MoEConfig,
                                      get, list_archs)

__all__ = ["ARCH_REGISTRY", "ModelConfig", "MoEConfig", "get", "list_archs"]
