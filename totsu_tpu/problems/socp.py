"""Second-order cone program -> conic form.

    minimize    f^T x
    subject to  || Gi x + hi ||_2 <= ci^T x + di   (i = 0..m-1)
                A x = b

Reduction (ref: totsu/src/problem/socp.rs:336-377 doc; operators 49-332):

    A' = [-c0^T; -G0; ...; -c_{m-1}^T; -G_{m-1}; A]
    b' = [d0; h0; ...; d_{m-1}; h_{m-1}; b]
    K  = Q^(1+n0) x ... x Q^(1+n_{m-1}) x {0}^p

Blocks may be degenerate (ni = 0 -> a 1-element SOC, which reduces to R+;
exercised by ref test_socp2 socp.rs:50-94).
"""

import jax.numpy as jnp

from totsu_tpu.problems.base import (
    ConicProblem, _asvec, _asmat, _from_matbuild,
)
from totsu_tpu.solver import cone as cones
from totsu_tpu.solver.operator import DenseOp


def socp(f, g_list, h_list, c_list, d_list, a=None, b=None) -> ConicProblem:
    """JAX-traceable SOCP reduction.

    * ``f``: (n,) objective
    * ``g_list``: list of (ni, n) arrays (ragged ni allowed, 0 included)
    * ``h_list``: list of (ni,) arrays
    * ``c_list``: list of (n,) arrays
    * ``d_list``: list of scalars
    """
    f = _asvec(f)
    n = f.shape[0]
    a = _asmat(a, 0, n, f.dtype)
    b = _asvec(b, a.shape[0], f.dtype)
    p = a.shape[0]
    dtype = f.dtype

    rows = []
    rhs = []
    factors = []
    for gi, hi, ci, di in zip(g_list, h_list, c_list, d_list):
        gi = _asmat(gi, 0, n, f.dtype)
        hi = _asvec(hi, gi.shape[0], f.dtype)
        ci = _asvec(ci)[:n]
        ni = gi.shape[0]
        rows.append(-ci[None, :])
        rows.append(-gi)
        rhs.append(jnp.asarray(di, dtype=dtype)[None])
        rhs.append(hi)
        # merge runs of equal-size blocks for batched projection
        if factors and factors[-1].kind == cones.SOC \
                and factors[-1].dim == 1 + ni:
            factors[-1] = cones.Factor(cones.SOC, 1 + ni,
                                       factors[-1].count + 1)
        else:
            factors.append(cones.soc(1 + ni))
    rows.append(a)
    rhs.append(b)
    factors.append(cones.zero(p))

    conic_a = jnp.concatenate(rows, axis=0)
    conic_b = jnp.concatenate(rhs)
    layout = cones.ConeLayout(factors)
    return ConicProblem(c=f, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbSOCP:
    """Reference-style SOCP wrapper (ref ProbSOCP, socp.rs:378-472)."""

    def __init__(self, vec_f, mats_g, vecs_h, vecs_c, scls_d,
                 mat_a=None, vec_b=None):
        self._prob = socp(
            _from_matbuild(vec_f),
            [_from_matbuild(g) for g in mats_g],
            [_from_matbuild(h) for h in vecs_h],
            [_asvec(_from_matbuild(ci)) for ci in vecs_c],
            list(scls_d),
            _from_matbuild(mat_a), _from_matbuild(vec_b),
        )

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
