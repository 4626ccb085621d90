"""Semidefinite program -> conic form.

    minimize    c^T x
    subject to  sum_i x_i F_i + F_n <= 0   (PSD order)
                A x = b

Reduction (ref: totsu/src/problem/sdp.rs:224-259 doc; 262-365):
vec() every F_j with the scaled-vec convention (off-diagonals * sqrt2,
ref sdp.rs:309-312), stack vec(F_0)..vec(F_{n-1}) as columns:

    A' = [vec(F_0) ... vec(F_{n-1}); A],  b' = [-vec(F_n); b]
    K  = vec(S+^k) x {0}^p
"""

import jax.numpy as jnp

from totsu_tpu.ops import sympack
from totsu_tpu.problems.base import (
    ConicProblem, _asvec, _asmat, _from_matbuild,
)
from totsu_tpu.solver import cone as cones
from totsu_tpu.solver.operator import DenseOp


def sdp(c, f_mats, a=None, b=None, psd_method: str = "auto") -> ConicProblem:
    """JAX-traceable SDP reduction.

    * ``c``: (n,) objective
    * ``f_mats``: (n+1, k, k) stacked dense symmetric matrices F_0..F_n
    * ``psd_method``: 'auto' (default — resolves per solve, see
      ``cones.resolve_auto_methods``), 'eigh' (exact projection), 'ns'
      (Newton-Schulz matmul-only projection, ~5e-6 error floor) or
      'jacobi' (parallel-order Jacobi — exact AND matmul-free; meant for
      many small blocks, see totsu_tpu.ops.jacobi)
    """
    c = _asvec(c)
    n = c.shape[0]
    f_mats = jnp.asarray(f_mats)
    k = f_mats.shape[-1]
    a = _asmat(a, 0, n, c.dtype)
    b = _asvec(b, a.shape[0], c.dtype)
    p = a.shape[0]

    f_vecs = sympack.pack(f_mats, scaled=True)  # (n+1, k(k+1)/2)
    conic_a = jnp.concatenate([
        f_vecs[:n].T,  # (sk, n) columns are vec(F_i)
        a,
    ], axis=0)
    conic_b = jnp.concatenate([-f_vecs[n], b])

    layout = cones.ConeLayout(
        [cones.psd(k, method=psd_method), cones.zero(p)])
    return ConicProblem(c=c, a=DenseOp(conic_a), b=conic_b, cone=layout)


class ProbSDP:
    """Reference-style SDP wrapper (ref ProbSDP, sdp.rs:262-365).

    ``syms_f`` is a list of n+1 SymPack MatBuilds (or dense symmetric
    arrays) holding the *literal* matrix entries; the sqrt2 scaled-vec
    conversion happens here, as in the reference's constructor.
    """

    def __init__(self, vec_c, syms_f, mat_a=None, vec_b=None,
                 eps_zero: float = 1e-12):
        del eps_zero
        f_mats = jnp.stack([jnp.asarray(_from_matbuild(f)) for f in syms_f])
        self._prob = sdp(
            _from_matbuild(vec_c), f_mats,
            _from_matbuild(mat_a), _from_matbuild(vec_b),
        )

    def problem(self) -> ConicProblem:
        return self._prob

    def solve(self, param=None, **kw):
        from totsu_tpu.solver.params import SolverParam
        return self._prob.solve(param or SolverParam(), **kw)
