from pfemfort_tpu_torch.elements.quadrature import gauss_rule
from pfemfort_tpu_torch.elements.basis import tabulate_basis

__all__ = ["gauss_rule", "tabulate_basis"]
