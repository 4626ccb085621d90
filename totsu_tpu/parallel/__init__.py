"""Distribution layer: meshes, sharded operators, batched lockstep solves.

No reference counterpart (the reference is single-device; SURVEY.md
section 2.8): problem blocks and scenario batches partitioned over a
device mesh, residual/norm reductions and matvecs via XLA collectives
(NCCL over NVLink on a multi-GPU host).
"""

from totsu_tpu.parallel.mesh import make_mesh, local_mesh
from totsu_tpu.parallel.batch import batch_solver, solve_batch, shard_batch
from totsu_tpu.parallel.sharded import (shard_blocked_ell_problem,
                                         shard_dense_problem)
from totsu_tpu.parallel.admm import consensus_admm, AdmmResult
from totsu_tpu.parallel import multihost

__all__ = [
    "make_mesh", "local_mesh", "solve_batch", "batch_solver", "shard_batch",
    "shard_dense_problem", "shard_blocked_ell_problem", "consensus_admm", "AdmmResult", "multihost",
]
