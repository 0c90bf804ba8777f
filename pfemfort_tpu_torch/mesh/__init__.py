from pfemfort_tpu_torch.mesh.core import Mesh, ELEMENT_INFO

__all__ = ["Mesh", "ELEMENT_INFO"]
