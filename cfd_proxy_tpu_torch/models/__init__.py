"""Model API of the port (counterpart of `cfd_proxy_tpu.models`): the kernel
model `GreenGaussTorch` with its flux variant, and the ELL model
`GreenGaussModel` (the reference's XLA backend, f32 or f64)."""

from cfd_proxy_tpu_torch.models.gradients import GreenGaussTorch, PSDFluxModel
from cfd_proxy_tpu_torch.models.gradients_ell import GreenGaussModel

__all__ = ["GreenGaussModel", "GreenGaussTorch", "PSDFluxModel"]
