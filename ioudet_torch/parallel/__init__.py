from .mesh import (allgather_pytrees, barrier, init_dist, is_initialized, local_rank, rank,
                   world_size)

__all__ = ["allgather_pytrees", "barrier", "init_dist", "is_initialized", "local_rank",
           "rank", "world_size"]
