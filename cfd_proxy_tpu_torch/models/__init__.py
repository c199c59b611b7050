"""Model API of the port (counterpart of `cfd_proxy_tpu.models`)."""

from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch, PSDFluxModel

__all__ = ["GreenGaussTorch", "PSDFluxModel"]
