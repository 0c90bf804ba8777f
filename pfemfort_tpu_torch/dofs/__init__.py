from pfemfort_tpu_torch.dofs.dofmap import DofMap, build_dofmap

__all__ = ["DofMap", "build_dofmap"]
