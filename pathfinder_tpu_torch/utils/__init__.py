from pathfinder_tpu_torch.utils.misc import findmax_skipnan

__all__ = ["findmax_skipnan"]
