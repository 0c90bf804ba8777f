from pfemfort_tpu_torch.parallel.partition import edge_cut, \
    partition_elements

__all__ = ["partition_elements", "edge_cut"]
