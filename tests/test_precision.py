"""Every dot in the compiled solve must run at HIGHEST precision.

At DEFAULT precision XLA's GPU backend may run f32 matmuls and batched
dot_generals in TF32, which keeps a 10-bit mantissa: ~1e-3 relative error
per product. For single-instance solves the matvec is a GEMV, but under
vmap (BatchRunner, parallel.batch, consensus_admm subsolves) every matvec
and c^T x / b^T y inner product becomes a batched dot_general — and a
~1e-3 error stalls eps_acc=1e-3 convergence (batched halpern LPs that ran
to max_iter while the single-instance solve converged were the first
symptom of this class). The fix pins precision=HIGHEST on
DenseOp/BlockedEllOp matvecs, the solver-path dots (conic._hidot,
direct), the PSD projections and the QP reduction's matrix square root.

CPU tests cannot reproduce the numeric failure (CPU dots are exact f32
at any precision setting), but the precision ATTRIBUTE is visible in the
lowered StableHLO on every backend — so this pins the compiled artifact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import totsu_tpu as tt


def _default_dots(lowered_text):
    return [l.strip()[:160] for l in lowered_text.splitlines()
            if "dot_general" in l and "DEFAULT" in l]


def _lower_vmapped(param, lay, a, b):
    n = a.shape[1]
    f = jax.jit(jax.vmap(
        lambda ci: tt.solve_jit(ci, jnp.asarray(a), jnp.asarray(b), lay,
                                param)))
    return f.lower(jnp.ones((4, n), jnp.float32)).as_text()


def test_no_default_precision_dots_in_batched_pdhg():
    n = 8
    a = np.eye(n, dtype=np.float32)
    b = np.ones(n, np.float32)
    lay = tt.ConeLayout([tt.rpos(n)])
    txt = _lower_vmapped(
        tt.SolverParam(max_iter=10, check_period=5, accel="halpern"),
        lay, a, b)
    assert _default_dots(txt) == []


def test_no_default_precision_dots_in_batched_direct():
    n = 8
    a = np.eye(n, dtype=np.float32)
    b = np.ones(n, np.float32)
    lay = tt.ConeLayout([tt.rpos(n)])
    txt = _lower_vmapped(
        tt.SolverParam(max_iter=10, check_period=5, method="direct"),
        lay, a, b)
    assert _default_dots(txt) == []


def test_no_default_precision_dots_in_blocked_ell_solve():
    from totsu_tpu.solver.operator import BlockedEllOp

    bs = 8
    a = np.concatenate([np.eye(bs), -np.eye(bs)]).astype(np.float32)
    op = BlockedEllOp.from_dense(a, block=(bs, bs))
    lay = tt.ConeLayout([tt.rpos(2 * bs)])
    b = np.ones(2 * bs, np.float32)
    param = tt.SolverParam(max_iter=10, check_period=5)
    f = jax.jit(lambda ci: tt.solve_jit(ci, op, jnp.asarray(b), lay, param))
    txt = f.lower(jnp.ones((bs,), jnp.float32)).as_text()
    assert _default_dots(txt) == []


@pytest.mark.parametrize("method", ["ns", "eigh", "jacobi"])
def test_no_default_precision_dots_in_batched_sdp(method):
    # min tr(C X) s.t. diag(X) = 1, X PSD (k = 4), each PSD projection
    # method lowered under vmap
    k = 4
    sn = k * (k + 1) // 2
    f_mats = np.zeros((sn + 1, k, k), np.float32)
    kk, diag = 0, []
    for j in range(k):
        for i in range(j + 1):
            f_mats[kk, i, j] = f_mats[kk, j, i] = -1.0
            if i == j:
                diag.append(kk)
            kk += 1
    a_eq = np.zeros((k, sn), np.float32)
    a_eq[np.arange(k), diag] = 1.0
    prob = tt.problems.sdp(np.ones(sn, np.float32), f_mats, a_eq,
                           np.ones(k, np.float32), psd_method=method)
    assert prob.cone.factors[0].variant == method
    txt = _lower_vmapped(
        tt.SolverParam(max_iter=10, check_period=5, accel="halpern"),
        prob.cone, np.asarray(prob.a.a), np.asarray(prob.b))
    assert _default_dots(txt) == []


def test_no_default_precision_dots_in_qp_reduction_and_solve():
    # the reduction's P^(1/2) (eigh + reconstruction) and the solve of
    # the RSOC epigraph it builds
    rng = np.random.default_rng(0)
    n = 6
    f = rng.normal(size=(n, n)).astype(np.float32)
    p = f.T @ f + np.eye(n, dtype=np.float32)
    q = rng.normal(size=n).astype(np.float32)
    g = rng.normal(size=(n, n)).astype(np.float32)
    h = np.ones(n, np.float32)
    txt = jax.jit(lambda p_: tt.problems.qp(p_, q, g=g, h=h).a.a).lower(
        jnp.asarray(p)).as_text()
    assert "dot_general" in txt
    assert _default_dots(txt) == []
    prob = tt.problems.qp(p, q, g=g, h=h)
    txt = _lower_vmapped(
        tt.SolverParam(max_iter=10, check_period=5, method="direct"),
        prob.cone, np.asarray(prob.a.a), np.asarray(prob.b))
    assert _default_dots(txt) == []
