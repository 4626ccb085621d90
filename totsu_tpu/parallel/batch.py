"""Batched lockstep solves: vmap over problem instances, optionally sharded
over a mesh 'batch' axis (embarrassingly parallel).

Instances iterate in lockstep inside one ``lax.while_loop``; each carries
its own status, and the loop runs until every instance terminates (the
masking semantics fall out of ``vmap``-of-``while_loop``, which XLA lowers
to a single fused loop with per-instance predicates).
"""

import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from totsu_tpu.solver.cone import ConeLayout
from totsu_tpu.solver.conic import solve_jit, SolveResult
from totsu_tpu.solver.params import SolverParam


def shard_batch(tree, mesh: Mesh, axis: str = "batch"):
    """Place a batch-leading pytree so its leading dim shards over
    ``axis`` (replicated over the other mesh axes)."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def solve_batch(
    c,
    a,
    b,
    cone: ConeLayout,
    param: SolverParam = SolverParam(),
    mesh: Optional[Mesh] = None,
    warm_start: Optional[Tuple[Any, Any]] = None,
    chunk_iters: Optional[int] = None,
) -> SolveResult:
    """Solve a batch of conic programs in lockstep.

    * ``c``: (B, n), ``a``: (B, m, n) array or batch-leading LinOp pytree,
      ``b``: (B, m); the cone layout is shared.
    * With ``mesh``, inputs are sharded over its ``batch`` axis first;
      XLA keeps every per-instance computation local to its device. The
      one collective is an all-reduce of the lockstep loop's predicate
      (does any lane still run?) on each trip of the outer loop.
    * ``chunk_iters=N`` runs the batch as N-iteration dispatches stitched
      with exact per-instance :class:`~totsu_tpu.ResumeState` checkpoints
      (the batched analogue of ``solve(chunk_iters=N)``). Instances that finish
      in an earlier chunk stay terminated (their checkpointed status is
      terminal), so their reported ``iters`` and solution are exactly
      those of the unchunked batch; dispatches continue while any
      instance is still EXCESS_ITER and the total is under
      ``param.max_iter``.
    """
    if mesh is not None:
        c, a, b = shard_batch((jnp.asarray(c), a, jnp.asarray(b)), mesh)
        if warm_start is not None:
            warm_start = shard_batch(warm_start, mesh)

    if chunk_iters is not None:
        return _solve_batch_chunked(c, a, b, cone, param, warm_start,
                                    int(chunk_iters))

    if warm_start is None:
        return batch_solver(cone, param)(c, a, b)
    return batch_solver(cone, param, has_warm=True)(c, a, b, warm_start)


@functools.lru_cache(maxsize=64)
def batch_solver(cone: ConeLayout, param: SolverParam,
                 has_warm: bool = False):
    """The jitted, vmapped program :func:`solve_batch` dispatches, cached
    per cone layout / params so repeated batches reuse one trace and one
    executable. Call it, or ``.lower(c, a, b[, warm_start]).compile()`` it
    to inspect that program."""
    if has_warm:
        return jax.jit(jax.vmap(lambda ci, ai, bi, ws: solve_jit(
            ci, ai, bi, cone, param, warm_start=ws)))
    return jax.jit(jax.vmap(lambda ci, ai, bi: solve_jit(
        ci, ai, bi, cone, param)))


def _solve_batch_chunked(c, a, b, cone, param, warm_start, chunk_iters):
    """Chunk-dispatched lockstep batch (see solve_batch docstring)."""
    import dataclasses
    from totsu_tpu.solver.params import SolverStatus
    if chunk_iters <= 0:
        raise ValueError(f"chunk_iters must be positive, got {chunk_iters}")
    cap = param.bounded_max_iter
    p_chunk = dataclasses.replace(param, max_iter=min(chunk_iters, cap),
                                  return_state=True)

    if warm_start is None:
        fn0 = jax.jit(jax.vmap(lambda ci, ai, bi: solve_jit(
            ci, ai, bi, cone, p_chunk)))
        res = fn0(c, a, b)
    else:
        fn0 = jax.jit(jax.vmap(lambda ci, ai, bi, ws: solve_jit(
            ci, ai, bi, cone, p_chunk, warm_start=ws)))
        res = fn0(c, a, b, warm_start)
    total = int(jnp.max(res.state.k))
    fn_mid = None
    while bool(jnp.any(res.status == SolverStatus.EXCESS_ITER)) \
            and total < cap:
        left = min(chunk_iters, cap - total)
        if left == chunk_iters:
            if fn_mid is None:
                fn_mid = jax.jit(jax.vmap(lambda ci, ai, bi, st: solve_jit(
                    ci, ai, bi, cone, p_chunk, resume_state=st)))
            fn = fn_mid
        else:
            p_tail = dataclasses.replace(p_chunk, max_iter=left)
            fn = jax.jit(jax.vmap(lambda ci, ai, bi, st: solve_jit(
                ci, ai, bi, cone, p_tail, resume_state=st)))
        res = fn(c, a, b, res.state)
        total = int(jnp.max(res.state.k))
    # per-instance totals are the global clocks the checkpoints carry
    return dataclasses.replace(
        res, iters=res.state.k,
        state=res.state if param.return_state else None)
