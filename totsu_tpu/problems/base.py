"""ConicProblem: the solver-form problem record produced by all reductions."""

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from totsu_tpu.solver.cone import ConeLayout
from totsu_tpu.solver.conic import solve, solve_jit, SolveResult
from totsu_tpu.solver.operator import LinOp, as_linop
from totsu_tpu.solver.params import SolverParam


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["c", "a", "b"],
    meta_fields=["cone", "row_sharding"],
)
@dataclasses.dataclass(frozen=True)
class ConicProblem:
    """A conic LP in solver form: min c^T x s.t. A x + s = b, s in K.

    The common output of every Prob* reduction (the analogue of the
    reference's ``problem()`` tuples, e.g. qp.rs:402-436 — minus the work
    slice, which JAX manages). A PyTree: batchable with ``vmap`` over the
    data leaves (c, a, b) with the cone layout shared.

    ``row_sharding`` (static, set by
    :func:`totsu_tpu.parallel.shard_dense_problem`) pins the solver's
    row-axis iterate segments to the mesh A is sharded over.
    """
    c: Any
    a: LinOp
    b: Any
    cone: ConeLayout
    row_sharding: Any = None

    @property
    def shape(self):
        return self.a.shape

    def solve(self, param: SolverParam = SolverParam(), warm_start=None) -> SolveResult:
        """Jit-compiled solve; raises SolverError on non-convergence."""
        return solve(self.c, self.a, self.b, self.cone, param,
                     warm_start=warm_start, row_sharding=self.row_sharding)

    def solve_jit(self, param: SolverParam = SolverParam(), warm_start=None) -> SolveResult:
        """Pure traceable solve; returns a status code, never raises."""
        return solve_jit(self.c, self.a, self.b, self.cone, param,
                         warm_start=warm_start,
                         row_sharding=self.row_sharding)


def _asvec(v, rows=None, dtype=None):
    """Coerce to a 1-D array; None -> zeros(rows) of ``dtype`` (pass the
    problem's dtype: an empty default-float block would otherwise promote
    f32 data to f64 in the stacked operator when x64 is enabled)."""
    if v is None:
        v = jnp.zeros((0 if rows is None else rows,), dtype=dtype)
    v = jnp.asarray(v)
    if v.ndim == 2 and v.shape[1] == 1:
        v = v[:, 0]
    if v.ndim != 1:
        raise ValueError(f"expected vector, got shape {v.shape}")
    return v


def _asmat(a, rows=None, cols=None, dtype=None):
    """Coerce to a 2-D array; None -> zeros((rows, cols)) of ``dtype``
    (see :func:`_asvec`)."""
    if a is None:
        a = jnp.zeros((0 if rows is None else rows, cols), dtype=dtype)
    a = jnp.asarray(a)
    if a.ndim != 2:
        raise ValueError(f"expected matrix, got shape {a.shape}")
    return a


def _from_matbuild(x):
    """Accept MatBuild / arrays / None uniformly."""
    from totsu_tpu.problems.matbuild import MatBuild
    if isinstance(x, MatBuild):
        return x.to_array()
    return x
