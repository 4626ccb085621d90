"""Quadratic program -> conic form via epigraph + rotated-SOC embedding.

    minimize    (1/2) x^T P x + q^T x + r
    subject to  G x <= h
                A x  = b

Reduction (ref: totsu/src/problem/qp.rs:299-342 doc; operators 9-256):
introduce the epigraph variable t, minimize t subject to

    [ 0      0 ]            [ 1 ]
    [ q^T   -1 ] [x]        [ 0 ]
    [ -P^1/2 0 ] [t]  + s = [ 0 ]     s in Qr^(2+n) x R+^m x {0}^p
    [ G      0 ]            [ h ]
    [ A      0 ]            [ b ]

P^(1/2) is computed once at build time by eigendecomposition
(ref qp.rs:386 -> MatBuild::set_sqrt).
"""

import jax.numpy as jnp

from totsu_tpu.ops import sympack
from totsu_tpu.problems.base import (
    ConicProblem, _asvec, _asmat, _from_matbuild,
)
from totsu_tpu.solver import cone as cones
from totsu_tpu.solver.operator import DenseOp


def qp(p_mat, q, g=None, h=None, a=None, b=None) -> ConicProblem:
    """JAX-traceable QP reduction. ``p_mat`` is the dense symmetric PSD
    objective matrix (n, n)."""
    q = _asvec(q)
    n = q.shape[0]
    p_mat = jnp.asarray(p_mat)
    g = _asmat(g, 0, n, q.dtype)
    h = _asvec(h, g.shape[0], q.dtype)
    a = _asmat(a, 0, n, q.dtype)
    b = _asvec(b, a.shape[0], q.dtype)
    m = g.shape[0]
    p = a.shape[0]

    p_sqrt = sympack.psd_sqrt(p_mat)

    z_col = jnp.zeros((n, 1), dtype=q.dtype)
    conic_a = jnp.concatenate([
        jnp.zeros((1, n + 1), dtype=q.dtype),
        jnp.concatenate([q[None, :], -jnp.ones((1, 1), dtype=q.dtype)], axis=1),
        jnp.concatenate([-p_sqrt, z_col], axis=1),
        jnp.concatenate([g, jnp.zeros((m, 1), dtype=q.dtype)], axis=1),
        jnp.concatenate([a, jnp.zeros((p, 1), dtype=q.dtype)], axis=1),
    ], axis=0)
    conic_b = jnp.concatenate([
        jnp.ones((1,), dtype=q.dtype),
        jnp.zeros((1 + n,), dtype=q.dtype),
        h, b,
    ])
    conic_c = jnp.zeros((n + 1,), dtype=q.dtype).at[n].set(1.0)

    layout = cones.ConeLayout(
        [cones.rsoc(2 + n), cones.rpos(m), cones.zero(p)])
    return ConicProblem(c=conic_c, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbQP:
    """Reference-style QP wrapper (ref ProbQP, qp.rs:343-437).

    ``sym_p`` may be a SymPack MatBuild or a dense symmetric array.
    The solution's first n entries are x (the last is the epigraph t).
    """

    def __init__(self, sym_p, vec_q, mat_g=None, vec_h=None,
                 mat_a=None, vec_b=None, eps_zero: float = 1e-12):
        del eps_zero  # retained for API parity; eigh needs no tolerance here
        self._prob = qp(
            _from_matbuild(sym_p), _from_matbuild(vec_q),
            _from_matbuild(mat_g), _from_matbuild(vec_h),
            _from_matbuild(mat_a), _from_matbuild(vec_b),
        )
        self.n = _asvec(_from_matbuild(vec_q)).shape[0]

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
