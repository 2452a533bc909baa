"""Parallel execution over device meshes (shard_map + XLA collectives)."""

from tikejax.parallel.sharding import make_mesh, run_sharded, shard_problem
from tikejax.parallel.tiling import (make_full_mesh, make_obj_mesh,
                                     make_obj_scan_mesh, run_tiled)

__all__ = ["make_mesh", "run_sharded", "shard_problem", "make_full_mesh",
           "make_obj_mesh", "make_obj_scan_mesh", "run_tiled"]
