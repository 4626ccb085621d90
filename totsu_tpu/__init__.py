"""totsu_tpu — a JAX first-order conic linear program solver.

A from-scratch JAX/XLA framework with the capability surface of
convexbrain/Totsu (the Rust reference; see SURVEY.md): the
homogeneous self-dual embedding of a conic LP

    minimize    c^T x
    subject to  A x + s = b,   s in K

iterated with the diagonally-preconditioned Pock-Chambolle primal-dual
first-order method, where K is a product of zero / nonnegative / second-order
/ rotated-second-order / positive-semidefinite cones.

Everything is expressed as pure, jit-able JAX: the whole iteration (matvecs,
diagonal preconditioning, cone projections, convergence criteria) runs
on-device inside a single ``lax.while_loop``; problems batch with ``vmap``
and shard over ``jax.sharding.Mesh`` axes.

Layer map (mirrors reference SURVEY.md section 1):
  * ``totsu_tpu.solver``   — Solver core: params, operators, cones, HSDE loop
                             (ref: solver_rust_conic/totsu_core/src/solver/)
  * ``totsu_tpu.ops``      — packed-symmetric storage, PSD projection
                             (ref: totsu_core linalg backends)
  * ``totsu_tpu.problems`` — LP/QP/QCQP/SOCP/SDP reductions to conic form
                             (ref: solver_rust_conic/totsu/src/problem/)
  * ``totsu_tpu.parallel`` — meshes, sharded operators, batched solves, ADMM
                             (new capability; no reference counterpart)
"""

from totsu_tpu.solver.params import SolverParam, SolverStatus, SolverError
from totsu_tpu.solver.api import Solver
from totsu_tpu.solver.conic import (solve, solve_jit, solve_sequence,
                                    SolveResult, ResumeState)
from totsu_tpu.solver.cone import (
    ConeLayout, zero, rpos, soc, rsoc, psd, expc, powc, custom,
)
from totsu_tpu.solver.operator import (
    LinOp, DenseOp, DiagOp, SparseOp, BlockedEllOp, ZeroOp, CustomOp, VStackOp,
    HStackOp, BlockOp, ScaledOp, as_linop,
)
from totsu_tpu.diff import make_differentiable_solver
from totsu_tpu.problems import (
    ConicProblem, ProbLP, ProbQP, ProbQCQP, ProbSOCP, ProbSDP, MatBuild,
)

__version__ = "0.1.0"

__all__ = [
    "SolverParam", "SolverStatus", "SolverError", "Solver",
    "solve", "solve_jit", "solve_sequence", "SolveResult", "ResumeState",
    "ConeLayout", "zero", "rpos", "soc", "rsoc", "psd", "expc", "powc", "custom",
    "LinOp", "DenseOp", "DiagOp", "SparseOp", "BlockedEllOp", "ZeroOp", "CustomOp",
    "VStackOp", "HStackOp",
    "BlockOp", "ScaledOp", "as_linop",
    "make_differentiable_solver",
    "ConicProblem", "ProbLP", "ProbQP", "ProbQCQP", "ProbSOCP", "ProbSDP",
    "MatBuild",
]
