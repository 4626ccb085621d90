"""Quadratically constrained QP -> conic form: stacked rotated-SOC blocks.

    minimize    (1/2) x^T P0 x + q0^T x + r0
    subject to  (1/2) x^T Pi x + qi^T x + ri <= 0   (i = 1..m)
                A x = b

Reduction (ref: totsu/src/problem/qcqp.rs:353-400 doc; operators 9-349):
one rotated-SOC block of height 2+n per quadratic (objective included via
the epigraph variable t, which only the i=0 block touches):

    block 0:  [[0, 0], [q0^T, -1], [-P0^1/2, 0]] [x; t] + s0 = [1, -r0, 0]
    block i:  [[0], [qi^T], [-Pi^1/2]] x        + si = [1, -ri, 0]
    A x + sz = b
    s in Qr^(2+n) x ... x Qr^(2+n) x {0}^p

Every Pi is square-rooted at build time via one *batched* eigh
(ref qcqp.rs:443-448 does m+1 sequential LAPACK calls; here it is a single
vmapped eigendecomposition).
"""

import jax.numpy as jnp

from totsu_tpu.ops import sympack
from totsu_tpu.problems.base import (
    ConicProblem, _asvec, _asmat, _from_matbuild,
)
from totsu_tpu.solver import cone as cones
from totsu_tpu.solver.operator import DenseOp


def qcqp(p_mats, q_vecs, r_scls, a=None, b=None) -> ConicProblem:
    """JAX-traceable QCQP reduction.

    * ``p_mats``: (m+1, n, n) stacked dense symmetric PSD matrices (P0..Pm)
    * ``q_vecs``: (m+1, n)
    * ``r_scls``: (m+1,)
    """
    p_mats = jnp.asarray(p_mats)
    q_vecs = jnp.asarray(q_vecs)
    r_scls = _asvec(r_scls)
    m1, n = q_vecs.shape
    a = _asmat(a, 0, n, q_vecs.dtype)
    b = _asvec(b, a.shape[0], q_vecs.dtype)
    p = a.shape[0]
    dtype = q_vecs.dtype

    p_sqrts = sympack.psd_sqrt(p_mats)  # batched over the leading axis

    # Per-quadratic block rows over [x; t]: zeros row, [qi^T, -delta_{i0}],
    # [-Pi^1/2, 0]. Build all m1 blocks batched then reshape.
    t_col = jnp.zeros((m1, 1), dtype=dtype).at[0, 0].set(-1.0)
    row0 = jnp.zeros((m1, 1, n + 1), dtype=dtype)
    row1 = jnp.concatenate([q_vecs[:, None, :], t_col[:, None, :]], axis=2)
    rows2 = jnp.concatenate(
        [-p_sqrts, jnp.zeros((m1, n, 1), dtype=dtype)], axis=2)
    blocks = jnp.concatenate([row0, row1, rows2], axis=1)  # (m1, 2+n, n+1)
    conic_a = jnp.concatenate([
        blocks.reshape(m1 * (2 + n), n + 1),
        jnp.concatenate([a, jnp.zeros((p, 1), dtype=dtype)], axis=1),
    ], axis=0)

    b_blocks = jnp.concatenate([
        jnp.ones((m1, 1), dtype=dtype),
        -r_scls[:, None],
        jnp.zeros((m1, n), dtype=dtype),
    ], axis=1)  # (m1, 2+n)
    conic_b = jnp.concatenate([b_blocks.reshape(m1 * (2 + n)), b])

    conic_c = jnp.zeros((n + 1,), dtype=dtype).at[n].set(1.0)

    layout = cones.ConeLayout(
        [cones.rsoc(2 + n, count=m1), cones.zero(p)])
    return ConicProblem(c=conic_c, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbQCQP:
    """Reference-style QCQP wrapper (ref ProbQCQP, qcqp.rs:401-498)."""

    def __init__(self, syms_p, vecs_q, scls_r, mat_a=None, vec_b=None,
                 eps_zero: float = 1e-12):
        del eps_zero
        p_mats = jnp.stack([jnp.asarray(_from_matbuild(p)) for p in syms_p])
        q_vecs = jnp.stack([_asvec(_from_matbuild(q)) for q in vecs_q])
        self._prob = qcqp(
            p_mats, q_vecs, jnp.asarray(scls_r),
            _from_matbuild(mat_a), _from_matbuild(vec_b),
        )
        self.n = q_vecs.shape[1]

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
