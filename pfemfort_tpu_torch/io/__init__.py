from pfemfort_tpu_torch.io.vtk import write_vtk

__all__ = ["write_vtk"]
