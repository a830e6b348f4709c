"""Sharded solves over several devices, on ``torch.distributed``.

Two strategies, as in the JAX package's ``parallel``:
  - ``make_sharded_solver`` (sharding.py): the edge axis split over the
    ranks, every variable whole on every rank, the per-variable partial
    sums added up by one ``all_reduce`` a sweep;
  - ``make_map_sharded_solver`` (map_sharding.py): landmark blocks and
    their edges split over the ranks, the keyframes the only variables
    whose sums cross ranks.

``launch.run`` starts the ranks (the counterpart of ``make_mesh``).
"""

from .launch import Rank, run  # noqa: F401
from .map_sharding import (  # noqa: F401
    MapShardedSolver,
    gather_partitioned,
    make_map_sharded_solver,
    partition_by_landmark,
    rebuild_partitioned_segments,
)
from .sharding import (  # noqa: F401
    ShardedSolver,
    gather_state,
    make_sharded_solver,
    pad_edges,
    real_edge_count,
)
