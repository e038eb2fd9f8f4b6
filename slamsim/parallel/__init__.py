"""Device meshes, sharded Monte-Carlo sweeps, particle parallelism."""

from slamsim.parallel.banded_shard import (sharded_cg_local,
                                           sharded_cg_solve)
from slamsim.parallel.graph_shard import (pad_edges,
                                           sharded_gn_iteration,
                                           sharded_graph_solve)
from slamsim.parallel.mesh import (PARTICLE_AXIS, ROLLOUT_AXIS,
                                   SLICE_AXIS, init_distributed,
                                   make_mesh, make_multislice_mesh,
                                   psum_hierarchical, replicated,
                                   rollout_sharding)
from slamsim.parallel.rollouts import (sharded_ekf_fused_sweep,
                                       sharded_ekf_sweep,
                                       sharded_pf_step)
from slamsim.parallel.tridiag_shard import (
    sharded_banded_solve_tridiag_flat, sharded_tridiag_local)

__all__ = ["PARTICLE_AXIS", "ROLLOUT_AXIS", "SLICE_AXIS",
           "init_distributed", "make_multislice_mesh", "psum_hierarchical",
           "make_mesh", "replicated",
           "rollout_sharding", "sharded_cg_local", "sharded_cg_solve",
           "sharded_ekf_sweep", "sharded_ekf_fused_sweep", "sharded_pf_step",
           "pad_edges",
           "sharded_gn_iteration", "sharded_graph_solve",
           "sharded_banded_solve_tridiag_flat", "sharded_tridiag_local"]
