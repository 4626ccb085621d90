"""Direct (SCS-style ADMM) engine tests: same problems, same statuses,
far fewer iterations than the PDHG path."""

import numpy as np
import jax.numpy as jnp
import pytest

import totsu_tpu as tt

DIRECT = tt.SolverParam(max_iter=100_000, method="direct")


def test_direct_nostd_lp():
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    lay = tt.ConeLayout([tt.rpos(3)])
    res = tt.solve(c, a, b, lay, DIRECT)
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-4)
    # the whole point: far fewer iterations than PDHG's 160
    assert int(res.iters) < 100


def test_direct_all_problem_classes():
    # QP
    p = tt.problems.qp(np.eye(2), [1.0, 2.0], g=[[-0.5, -1.0 / 3.0]],
                       h=[-1.0])
    r = tt.solve(p.c, p.a, p.b, p.cone, DIRECT)
    np.testing.assert_allclose(np.asarray(r.x)[:2], [2.0, 0.0], atol=1e-3)
    # SDP (core reference test)
    r = tt.solve(jnp.array([1.0]),
                 jnp.array([[0.0], [-np.sqrt(2.0)], [-3.0]]),
                 jnp.array([1.0, 0.0, 10.0]),
                 tt.ConeLayout([tt.psd(2)]), DIRECT)
    np.testing.assert_allclose(float(r.x[0]), -2.0, atol=1e-3)
    # SOCP
    r = tt.solve(jnp.array([1.0, 1.0]),
                 jnp.array([[0.0, 0.0], [-1.0, 0.0], [0.0, -1.0]]),
                 jnp.array([np.sqrt(2.0), 0.0, 0.0]),
                 tt.ConeLayout([tt.soc(3)]), DIRECT)
    np.testing.assert_allclose(np.asarray(r.x), [-1.0, -1.0], atol=1e-3)


def test_direct_certificates():
    lay = tt.ConeLayout([tt.rpos(2)])
    with pytest.raises(tt.SolverError) as ei:
        tt.solve(jnp.array([1.0]), jnp.array([[1.0], [-1.0]]),
                 jnp.array([-5.0, -10.0]), lay, DIRECT)
    assert ei.value.status == tt.SolverStatus.INFEASIBLE
    with pytest.raises(tt.SolverError) as ei:
        tt.solve(jnp.array([1.0]), jnp.array([[1.0], [1.0]]),
                 jnp.array([5.0, 10.0]), lay, DIRECT)
    assert ei.value.status == tt.SolverStatus.UNBOUNDED


def test_direct_matches_pdhg_on_random_lp():
    rng = np.random.default_rng(0)
    n = 30
    g = rng.normal(size=(2 * n, n))
    x0 = rng.normal(size=n)
    h = g @ x0 + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    g2 = np.concatenate([g, eye, -eye])
    h2 = np.concatenate([h, 10 * np.ones(2 * n)])
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(4 * n)])
    rd = tt.solve_jit(jnp.asarray(c), jnp.asarray(g2), jnp.asarray(h2), lay,
                      tt.SolverParam(max_iter=200_000, method="direct",
                                     equil_iters=10))
    rp = tt.solve_jit(jnp.asarray(c), jnp.asarray(g2), jnp.asarray(h2), lay,
                      tt.SolverParam(max_iter=400_000))
    assert int(rd.status) == tt.SolverStatus.CONVERGED
    assert int(rp.status) == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(np.asarray(rd.x), np.asarray(rp.x), atol=1e-3)
    assert int(rd.iters) < int(rp.iters) / 3


def test_direct_halpern_converges_fewer_iters():
    # restarted Halpern on the (unrelaxed) DR map: same optimum, fewer
    # iterations than plain over-relaxed DR on the same instance
    rng = np.random.default_rng(3)
    n = 40
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    plain = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay,
                         tt.SolverParam(max_iter=200_000, method="direct",
                                        check_period=10))
    halp = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay,
                        tt.SolverParam(max_iter=200_000, method="direct",
                                       check_period=10, accel="halpern"))
    assert int(plain.status) == tt.SolverStatus.CONVERGED
    assert int(halp.status) == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(
        float(jnp.dot(jnp.asarray(c), halp.x)),
        float(jnp.dot(jnp.asarray(c), plain.x)), rtol=1e-4, atol=1e-4)
    assert int(halp.iters) <= int(plain.iters)


def test_direct_halpern_requires_unrelaxed():
    lay = tt.ConeLayout([tt.rpos(2)])
    with pytest.raises(ValueError):
        tt.solve_jit(jnp.ones(2), jnp.eye(2), jnp.ones(2), lay,
                     tt.SolverParam(method="direct", accel="halpern",
                                    relax=1.5))
    with pytest.raises(ValueError):
        tt.solve_jit(jnp.ones(2), jnp.eye(2), jnp.ones(2), lay,
                     tt.SolverParam(method="direct", accel="restart"))


def test_direct_normalize_off_still_solves():
    # normalize defaults ON for this engine; the opt-out path must still
    # converge on well-scaled data (f64 here — in f32 un-normalized DR is
    # fragile, which is exactly why the default flipped)
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    lay = tt.ConeLayout([tt.rpos(3)])
    res = tt.solve(c, a, b, lay,
                   tt.SolverParam(max_iter=100_000, method="direct",
                                  normalize=False))
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-4)


def _banded_box_lp(n=96, bw=6, seed=7):
    """Bounded LP with blocked-ELL-friendly structure: banded rows + a
    two-sided box (shared by the indirect-engine tests)."""
    rng = np.random.default_rng(seed)
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi2 = max(0, i - bw), min(n, i + bw)
        band[i, lo:hi2] = rng.normal(size=hi2 - lo)
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    c = rng.normal(size=n)
    return c, a, h, tt.ConeLayout([tt.rpos(3 * n)])


def test_direct_indirect_matrix_free():
    """The indirect (warm-started CG) mode makes ``method='direct'`` work
    for ANY LinOp, including matrix-free CustomOp (VERDICT r2 #4; the SCS
    'indirect' linear-system mode). Round 2 raised ValueError here."""
    c, a, h, lay = _banded_box_lp(n=48)
    op = tt.CustomOp(params=jnp.asarray(a), m=a.shape[0], n=a.shape[1],
                     matvec_fn=lambda p, x: p @ x)
    r = tt.solve_jit(jnp.asarray(c), op, jnp.asarray(h), lay,
                     tt.SolverParam(max_iter=100_000, method="direct",
                                    check_period=10, accel="halpern"))
    assert int(r.status) == tt.SolverStatus.CONVERGED
    r_ref = tt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(h),
                         lay, tt.SolverParam(max_iter=100_000,
                                             method="direct",
                                             check_period=10,
                                             accel="halpern"))
    assert abs(float(jnp.dot(jnp.asarray(c), r.x))
               - float(jnp.dot(jnp.asarray(c), r_ref.x))) <= 1e-3 * (
                   1.0 + abs(float(jnp.dot(jnp.asarray(c), r_ref.x))))


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_direct_indirect_blocked_ell_parity(accel):
    """Indirect solve on a BlockedEllOp agrees with the dense direct
    solve on the same data (objective within tolerance), and composes
    with operator-form Ruiz equilibration."""
    c, a, h, lay = _banded_box_lp(n=96)
    ell = tt.BlockedEllOp.from_dense(a, block=(32, 32))
    p = tt.SolverParam(max_iter=100_000, method="direct", check_period=10,
                       accel=accel, eps_acc=1e-5)
    r_dense = tt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(h),
                           lay, p)
    r_ind = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay, p)
    r_eq = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                        tt.SolverParam(max_iter=100_000, method="direct",
                                       check_period=10, accel=accel,
                                       eps_acc=1e-5, equil_iters=10))
    assert int(r_dense.status) == tt.SolverStatus.CONVERGED
    assert int(r_ind.status) == tt.SolverStatus.CONVERGED
    assert int(r_eq.status) == tt.SolverStatus.CONVERGED
    obj = float(np.asarray(c) @ np.asarray(r_dense.x))
    for r in (r_ind, r_eq):
        assert abs(float(np.asarray(c) @ np.asarray(r.x)) - obj) \
            <= 1e-3 * (1.0 + abs(obj))


def test_direct_indirect_certificates():
    """Unbounded/infeasible certificates survive the CG resolvent."""
    lay = tt.ConeLayout([tt.rpos(2)])
    op_inf = tt.CustomOp(params=jnp.asarray([[1.0], [-1.0]]), m=2, n=1,
                         matvec_fn=lambda p, x: p @ x)
    r = tt.solve_jit(jnp.asarray([1.0]), op_inf, jnp.asarray([-5.0, -10.0]),
                     lay, tt.SolverParam(max_iter=100_000, method="direct"))
    assert int(r.status) == tt.SolverStatus.INFEASIBLE
    op_unb = tt.CustomOp(params=jnp.asarray([[1.0], [1.0]]), m=2, n=1,
                         matvec_fn=lambda p, x: p @ x)
    r = tt.solve_jit(jnp.asarray([1.0]), op_unb, jnp.asarray([5.0, 10.0]),
                     lay, tt.SolverParam(max_iter=100_000, method="direct"))
    assert int(r.status) == tt.SolverStatus.UNBOUNDED


def test_direct_indirect_ill_conditioned_f32():
    """f32 stress mirroring test_direct_ill_conditioned_f32 on the CG
    path (VERDICT r2 #4 done-criterion): singular values spanning 3
    decades, solved through a BlockedEllOp with equilibration."""
    rng = np.random.default_rng(13)
    n = 96
    u_, _ = np.linalg.qr(rng.normal(size=(n, n)))
    v_, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = 10.0 ** np.linspace(1.5, -1.5, n)
    g = (u_ * sv) @ v_.T
    x0 = rng.normal(size=n)
    h = np.concatenate([g @ x0 + rng.random(n) + 0.1,
                        np.full(2 * n, 10.0)]).astype(np.float32)
    g2 = np.concatenate([g, np.eye(n), -np.eye(n)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    ell = tt.BlockedEllOp.from_dense(g2, block=(32, 32))
    res = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                       tt.SolverParam(max_iter=200_000, method="direct",
                                      eps_acc=1e-3, check_period=10,
                                      equil_iters=10))
    assert int(res.status) == tt.SolverStatus.CONVERGED
    x = np.asarray(res.x, dtype=np.float64)
    r = g2.astype(np.float64) @ x - h.astype(np.float64)
    cri = np.linalg.norm(np.maximum(r, 0.0)) / (1.0 + np.linalg.norm(h))
    assert cri <= 2e-3


def test_direct_warm_start_fixed_point():
    # warm start at the exact solution is an exact DR fixed point
    # ((I+Q)u* = u* + v* with v* = (0, s, 0)): 0 further iterations,
    # under both plain DR and the z-space Halpern runner
    rng = np.random.default_rng(11)
    n = 20
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    for accel in ("", "halpern"):
        p = tt.SolverParam(max_iter=200_000, method="direct",
                           check_period=10, accel=accel)
        cold = tt.solve(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                        lay, p)
        warm = tt.solve(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                        lay, p, warm_start=(cold.x, cold.y))
        assert int(warm.iters) == 0, (accel, int(warm.iters))


def test_direct_checkpoint_resume():
    # return_state / resume_state now supported on the direct engine too
    # (VERDICT r1 #6)
    rng = np.random.default_rng(12)
    n = 20
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    full = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay,
                        tt.SolverParam(max_iter=200_000, method="direct"))
    part1 = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay,
                         tt.SolverParam(max_iter=40, method="direct",
                                        return_state=True))
    assert int(part1.status) == tt.SolverStatus.EXCESS_ITER
    part2 = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay,
                         tt.SolverParam(max_iter=200_000, method="direct"),
                         resume_state=part1.state)
    assert int(part2.status) == tt.SolverStatus.CONVERGED
    assert int(part1.iters) + int(part2.iters) == int(full.iters)
    np.testing.assert_allclose(np.asarray(part2.x), np.asarray(full.x),
                               atol=1e-10)


def _ill_conditioned_lp(top, dtype, seed=13, n=200):
    """An LP whose A has singular values 10^top .. 10^-2, so that
    cond(I + A^T A) ~ 10^(2 top), boxed to stay bounded."""
    rng = np.random.default_rng(seed)
    u_, _ = np.linalg.qr(rng.normal(size=(2 * n, n)))
    v_, _ = np.linalg.qr(rng.normal(size=(n, n)))
    sv = 10.0 ** np.linspace(top, -2, n)
    g = (u_ * sv) @ v_.T
    x0 = rng.normal(size=n)
    h = g @ x0 + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    g2 = np.concatenate([g, eye, -eye]).astype(dtype)
    h2 = np.concatenate([h, np.full(2 * n, 10.0)]).astype(dtype)
    c = rng.normal(size=n).astype(dtype)
    return c, g2, h2, tt.ConeLayout([tt.rpos(4 * n)])


def _host_primal_infeas(g2, h2, x):
    r = g2.astype(np.float64) @ np.asarray(x, np.float64) \
        - h2.astype(np.float64)
    return np.linalg.norm(np.maximum(r, 0.0)) / (1.0 + np.linalg.norm(h2))


def test_direct_ill_conditioned_f32():
    # VERDICT r1 #6: the round-1 explicit inverse of I + A^T A (condition
    # ~ sigma_max(A)^2, here ~1e4) lost digits in f32 on ill-conditioned
    # data; the Cholesky-derived inverse with its two f32 refinement steps
    # must converge.
    c, g2, h2, lay = _ill_conditioned_lp(2, np.float32)
    res = tt.solve_jit(jnp.asarray(c), jnp.asarray(g2), jnp.asarray(h2), lay,
                       tt.SolverParam(max_iter=200_000, method="direct",
                                      eps_acc=1e-3, check_period=10,
                                      equil_iters=10))
    assert int(res.status) == tt.SolverStatus.CONVERGED
    # verify the KKT residual by hand in f64 against the f32 solution
    assert _host_primal_infeas(g2, h2, res.x) <= 2e-3


def test_direct_ill_conditioned_f64():
    # f64 applies the Cholesky-derived inverse with no refinement steps.
    # Its resolvent residual is ~cond * eps: at cond(I + A^T A) ~ 3e7 it
    # must stay within 10 cond eps (~7e-8; measured ~2e-9), and on the
    # f32 test's problem the f64 solve must reach a tighter eps_acc and
    # the optimum HiGHS finds.
    from scipy.optimize import linprog
    c, g2, h2, lay = _ill_conditioned_lp(4, np.float64)
    part = tt.solve_jit(jnp.asarray(c), jnp.asarray(g2), jnp.asarray(h2),
                        lay, tt.SolverParam(max_iter=1, method="direct",
                                            equil_iters=0, return_state=True))
    spd = np.eye(g2.shape[1]) + g2.T @ g2
    r = np.random.default_rng(0).normal(size=g2.shape[1])
    z = np.asarray(part.state.aux["spd_inv"]) @ r
    bound = 10.0 * np.linalg.cond(spd) * np.finfo(np.float64).eps
    assert np.linalg.norm(spd @ z - r) / np.linalg.norm(r) <= bound

    c, g2, h2, lay = _ill_conditioned_lp(2, np.float64)
    res = tt.solve_jit(jnp.asarray(c), jnp.asarray(g2), jnp.asarray(h2), lay,
                       tt.SolverParam(max_iter=200_000, method="direct",
                                      eps_acc=1e-4, check_period=10,
                                      equil_iters=10))
    assert int(res.status) == tt.SolverStatus.CONVERGED
    assert _host_primal_infeas(g2, h2, res.x) <= 2e-4
    ref = linprog(c, A_ub=g2, b_ub=h2, bounds=(None, None), method="highs")
    assert ref.status == 0
    obj = float(c @ np.asarray(res.x))
    assert abs(obj - ref.fun) <= 1e-3 * (1.0 + abs(ref.fun))


def test_equilibration_preserves_solution():
    rng = np.random.default_rng(5)
    n = 10
    # badly scaled data
    scale_r = 10.0 ** rng.uniform(-3, 3, size=2 * n)
    eye = np.eye(n)
    g = np.concatenate([eye, -eye]) * scale_r[:, None]
    h = np.ones(2 * n) * scale_r
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    req = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay,
                       tt.SolverParam(max_iter=200_000, equil_iters=10))
    assert int(req.status) == tt.SolverStatus.CONVERGED
    # solution of the box LP is known: x* = -sign(c)
    np.testing.assert_allclose(np.asarray(req.x), -np.sign(c), atol=5e-3)


def test_direct_f32_linear_solve_pins_highest_precision():
    """At DEFAULT precision f32 matmuls may run with reduced operand
    precision (TF32 on the GPU). A reduced-precision I + A^T A makes the
    DR map lose firm nonexpansiveness: observed on the growthport exp/pow
    instance as a cri_dual floor of 8.5e-3 (plain) and divergence to 0.38
    under the Halpern anchor, where exact f32 matmuls converged on the
    identical data. Guard: every matrix-matrix product in the lowered f32
    direct path must carry the HIGHEST operand-precision config."""
    import jax
    rng = np.random.default_rng(0)
    c = jnp.asarray(rng.normal(size=8), jnp.float32)
    g = jnp.asarray(rng.normal(size=(16, 8)), jnp.float32)
    h = jnp.asarray(np.abs(rng.normal(size=16)) + 1.0, jnp.float32)
    lay = tt.ConeLayout([tt.rpos(16)])
    p = tt.SolverParam(method="direct", max_iter=100, eps_acc=1e-3)
    f = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, p))
    txt = f.lower(c, g, h).as_text()
    import re
    # (8x16)x(16x8) is the A^T A product that forms M = I + A^T A
    mm = [s for s in re.findall(r"stablehlo\.dot_general.*", txt)
          if "tensor<8x8xf32>, tensor<8x8xf32>" in s
          or "tensor<8x16xf32>, tensor<16x8xf32>" in s]
    assert mm, "expected matrix-matrix dots in the direct f32 lowering"
    bad = [s for s in mm if "HIGHEST" not in s]
    assert not bad, f"matmuls without HIGHEST precision: {bad[:2]}"


def test_solve_sequence_fast_profile_structured():
    """Composition: solve_sequence warm-starts THROUGH the r4 fast-profile
    routing (structured operator -> indirect engine) — later solves in a
    slowly-varying sweep converge in fewer iterations than the cold
    first."""
    rng = np.random.default_rng(5)
    n = 12
    band = np.zeros((n, n))
    for i in range(n):
        band[i, max(0, i - 2):min(n, i + 2)] = rng.normal(
            size=min(n, i + 2) - max(0, i - 2))
    a = np.concatenate([band, np.eye(n), -np.eye(n)])
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    ell = tt.BlockedEllOp.from_dense(a, block=(4, 4))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    c0 = rng.normal(size=n)
    probs = [(jnp.asarray(c0 * (1.0 + 0.01 * t)), ell, jnp.asarray(h), lay)
             for t in range(4)]
    res = tt.solve_sequence(
        probs, tt.SolverParam(profile="fast", eps_acc=1e-8,
                              max_iter=200_000))
    assert all(int(r.status) == 1 for r in res)
    assert int(res[1].iters) < int(res[0].iters)


def test_resume_state_cross_engine_raises_clearly():
    """A checkpoint from one engine must not resume the other (different
    iteration variables) — fail with the cause, not a shape error."""
    c = jnp.array([1.0, 1.0])
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0], [0.0, 0.0]])
    h = jnp.array([-2.0, -2.0, 1.0])
    lay = tt.ConeLayout([tt.rpos(3)])
    pd = tt.solve_jit(c, g, h, lay,
                      tt.SolverParam(max_iter=50, return_state=True))
    dr = tt.solve_jit(c, g, h, lay,
                      tt.SolverParam(max_iter=50, method="direct",
                                     return_state=True))
    with pytest.raises(ValueError, match="pdhg engine"):
        tt.solve_jit(c, g, h, lay,
                     tt.SolverParam(max_iter=50, method="direct"),
                     resume_state=pd.state)
    with pytest.raises(ValueError, match="direct engine"):
        tt.solve_jit(c, g, h, lay, tt.SolverParam(max_iter=50),
                     resume_state=dr.state)


def _ill_scaled_banded(n=128, span=1e4, seed=13):
    """Banded+box LP whose COLUMN scales span ~``span`` (deliberately
    badly scaled: diag(A^T A) spread ~span^2 — VERDICT r4 #5's target).
    Box bounds follow the column scales so the instance stays feasible
    and bounded in the scaled variables."""
    rng = np.random.default_rng(seed)
    bw = 9
    a = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - bw // 2), min(n, i + bw // 2 + 1)
        a[i, lo:hi] = rng.normal(size=hi - lo)
    scales = np.exp(np.log(span) * rng.random(n) - 0.5 * np.log(span))
    a = a * scales[None, :]
    a_full = np.concatenate([a, np.eye(n), -np.eye(n)])
    x0 = rng.normal(size=n) / scales
    box = np.full(n, 10.0) / scales
    h = np.concatenate([a @ x0 + rng.random(n) + 0.1, box, box])
    c = rng.normal(size=n) * scales
    return c, a_full, h


def test_indirect_cg_jacobi_preconditioner_ill_scaled():
    """VERDICT r4 #5: on badly column-scaled data the Jacobi PCG keeps
    every resolvent solve at its tolerance where plain CG truncates at
    the max_cg cap by ~4 orders of magnitude; both outcomes are now
    SURFACED via SolveResult.diag. (Fixed small iteration budget — the
    assertions are about CG health, not outer convergence; the
    convergent configuration is pinned separately below.)"""
    c, a_full, h = _ill_scaled_banded()
    n = c.shape[0]
    ell = tt.BlockedEllOp.from_dense(a_full.astype(np.float64),
                                     block=(64, 64))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    kw = dict(max_iter=600, eps_acc=1e-6, check_period=20,
              method="direct", accel="halpern")
    r_pc = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                        tt.SolverParam(cg_precond="jacobi", **kw))
    r_pl = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                        tt.SolverParam(cg_precond="none", **kw))
    assert r_pc.diag is not None and "cg_worst_rel" in r_pc.diag
    worst_pc = float(r_pc.diag["cg_worst_rel"])
    worst_pl = float(r_pl.diag["cg_worst_rel"])
    tol = float(r_pc.diag["cg_tol"])
    assert worst_pc <= 10.0 * tol, (worst_pc, tol)
    assert worst_pl > 1e3 * worst_pc, (worst_pl, worst_pc)
    # 'auto' (the default) picks jacobi for operators with col_sqsum:
    # identical iterate path
    r_auto = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                          tt.SolverParam(**kw))
    np.testing.assert_allclose(np.asarray(r_auto.x), np.asarray(r_pc.x))


def test_indirect_ill_scaled_converges_with_equil_and_precond():
    """The wired remedy for badly scaled structured data: Ruiz
    equilibration + Jacobi PCG converges where every plain config
    stalls (measured on this instance: all of {direct/pdhg} x
    {plain, precond-only} sit at gap 4e-4..1e-1 after 8,000 iters)."""
    c, a_full, h = _ill_scaled_banded()
    n = c.shape[0]
    ell = tt.BlockedEllOp.from_dense(a_full.astype(np.float64),
                                     block=(64, 64))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    r = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                     tt.SolverParam(max_iter=20_000, eps_acc=1e-3,
                                    check_period=20, method="direct",
                                    accel="halpern", cg_precond="jacobi",
                                    equil_iters=10))
    assert int(r.status) == tt.SolverStatus.CONVERGED
    assert float(r.diag["cg_worst_rel"]) <= 10.0 * float(r.diag["cg_tol"])


def test_indirect_cg_truncation_warns_from_solve():
    import pytest
    c, a_full, h = _ill_scaled_banded()
    n = c.shape[0]
    ell = tt.BlockedEllOp.from_dense(a_full.astype(np.float64),
                                     block=(64, 64))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    with pytest.warns(RuntimeWarning, match="hit the iteration cap"):
        try:
            tt.solve(jnp.asarray(c), ell, jnp.asarray(h), lay,
                     tt.SolverParam(max_iter=300, eps_acc=1e-6,
                                    check_period=20, method="direct",
                                    accel="halpern", cg_precond="none"))
        except tt.SolverError:
            pass              # non-convergence is fine; the warning isn't


def test_indirect_cg_precond_matches_plain_well_scaled():
    # well-scaled banded instance: both modes converge to the same
    # solution (the preconditioner is then a near-constant rescale)
    rng = np.random.default_rng(3)
    n = 128
    a = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 4), min(n, i + 5)
        a[i, lo:hi] = rng.normal(size=hi - lo)
    a_full = np.concatenate([a, np.eye(n), -np.eye(n)])
    h = np.concatenate([a @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 10.0)])
    c = rng.normal(size=n)
    ell = tt.BlockedEllOp.from_dense(a_full, block=(64, 64))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    kw = dict(max_iter=50_000, eps_acc=1e-8, check_period=20,
              method="direct", accel="halpern")
    r1 = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                      tt.SolverParam(cg_precond="jacobi", **kw))
    r2 = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay,
                      tt.SolverParam(cg_precond="none", **kw))
    assert int(r1.status) == int(r2.status) == tt.SolverStatus.CONVERGED
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x),
                               atol=1e-6)


def test_cg_precond_jacobi_requires_col_sqsum():
    import pytest
    from totsu_tpu.solver.operator import CustomOp
    rng = np.random.default_rng(1)
    g8 = rng.normal(size=(4, 8))
    amat = jnp.asarray(np.concatenate([g8, np.eye(8), -np.eye(8)]))
    op = CustomOp(params=amat, m=20, n=8, matvec_fn=lambda p, x: p @ x)
    lay = tt.ConeLayout([tt.rpos(20)])
    b = jnp.asarray(np.concatenate([g8 @ rng.normal(size=8)
                                    + rng.random(4) + 0.1,
                                    np.full(16, 10.0)]))
    c = jnp.asarray(rng.normal(size=8))
    with pytest.raises(NotImplementedError, match="col_sqsum"):
        tt.solve_jit(c, op, b, lay,
                     tt.SolverParam(max_iter=100, method="direct",
                                    cg_precond="jacobi"))
    # 'auto' falls back to plain CG silently
    r = tt.solve_jit(c, op, b, lay,
                     tt.SolverParam(max_iter=20_000, method="direct",
                                    accel="halpern"))
    assert int(r.status) == tt.SolverStatus.CONVERGED


def test_scaling_spread_separates_measured_regimes():
    """Column 2-norm spread (the calibrated probe measure — abs-max
    spreads were rejected: box rows + wide bands damp them into
    overlap, see scaling_spread's docstring): the ill-scaled family
    probes 24-172, every well-scaled class 1.1-2.9, threshold 10."""
    from totsu_tpu.solver.scaling import scaling_spread
    c, a_full, h = _ill_scaled_banded()
    ill = tt.BlockedEllOp.from_dense(a_full, block=(64, 64))
    assert scaling_spread(ill) > 100.0          # calibrated: ~172
    rng = np.random.default_rng(3)
    n = 128
    a = np.concatenate([rng.normal(size=(n, n)), np.eye(n)])
    well = tt.BlockedEllOp.from_dense(a, block=(64, 64))
    assert scaling_spread(well) < 5.0           # calibrated: ~1.2
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 4), min(n, i + 5)
        band[i, lo:hi] = rng.normal(size=hi - lo)
    wellb = tt.BlockedEllOp.from_dense(
        np.concatenate([band, np.eye(n), -np.eye(n)]), block=(64, 64))
    assert scaling_spread(wellb) < 5.0          # calibrated: ~2.9


def test_auto_equil_policy_gating():
    """_maybe_auto_equil fires exactly when: fast profile, equil UNSET
    (None), unsharded, non-dense op supporting the Ruiz method trio."""
    from totsu_tpu.solver.conic import _maybe_auto_equil
    c, a_full, h = _ill_scaled_banded()
    ill = tt.BlockedEllOp.from_dense(a_full, block=(64, 64))
    fast = tt.SolverParam(profile="fast")
    # fires on ill-scaled structured data
    assert _maybe_auto_equil(fast, ill, None).equil_iters == 10
    # profile='reference' -> untouched
    assert _maybe_auto_equil(tt.SolverParam(), ill, None).equil_iters is None
    # explicit equil_iters wins
    p5 = tt.SolverParam(profile="fast", equil_iters=5)
    assert _maybe_auto_equil(p5, ill, None).equil_iters == 5
    # ... INCLUDING the explicit-0 opt-out (pins the unequilibrated
    # iterate path; the default is the None sentinel, so 0 is explicit)
    p0 = tt.SolverParam(profile="fast", equil_iters=0)
    assert _maybe_auto_equil(p0, ill, None).equil_iters == 0
    # sharded solves stay on their pinned configuration
    assert _maybe_auto_equil(fast, ill, object()).equil_iters is None
    # dense operators keep the profile's measured dense defaults
    dense = tt.DenseOp(jnp.asarray(a_full))
    assert _maybe_auto_equil(fast, dense, None).equil_iters is None
    # matrix-free CustomOp (no diag_scale): probe skipped, no crash
    cust = tt.CustomOp(params=jnp.asarray(a_full), m=a_full.shape[0],
                       n=a_full.shape[1], matvec_fn=lambda p, x: p @ x)
    assert _maybe_auto_equil(fast, cust, None).equil_iters is None
    # composite stack with a CustomOp child: the top-level VStackOp HAS
    # the trio but delegates to children — the probe must catch the
    # child's NotImplementedError and stand down, not crash (this was a
    # fast-profile regression: matrix-free A + box rows is exactly the
    # benchmark pattern)
    from totsu_tpu.solver.operator import VStackOp, DiagOp
    ones = jnp.ones(a_full.shape[1])
    stack = VStackOp((cust, DiagOp(ones), DiagOp(-ones)))
    assert _maybe_auto_equil(fast, stack, None).equil_iters is None
    # well-scaled structured op: probed, below threshold, untouched
    rng = np.random.default_rng(3)
    n = 128
    a = np.concatenate([rng.normal(size=(n, n)), np.eye(n)])
    well = tt.BlockedEllOp.from_dense(a, block=(64, 64))
    assert _maybe_auto_equil(fast, well, None).equil_iters is None


def test_fast_profile_composite_customop_still_solves():
    """End-to-end guard for the composite regression: solve() with
    profile='fast' on VStackOp((CustomOp, DiagOp, DiagOp)) — the probe
    stands down and the solve converges through the indirect engine."""
    c, a, h, lay = _banded_box_lp(n=48)
    n = 48
    band = a[:n]
    cust = tt.CustomOp(params=jnp.asarray(band), m=n, n=n,
                       matvec_fn=lambda p, x: p @ x)
    from totsu_tpu.solver.operator import VStackOp, DiagOp
    ones = jnp.ones(n)
    stack = VStackOp((cust, DiagOp(ones), DiagOp(-ones)))
    r = tt.solve(jnp.asarray(c), stack, jnp.asarray(h), lay,
                 tt.SolverParam(profile="fast", max_iter=100_000))
    assert int(r.status) == tt.SolverStatus.CONVERGED


def test_fast_profile_auto_equil_ill_scaled_end_to_end():
    """The hands-free story (r5): plain solve(profile='fast') on the
    ill-scaled structured instance converges — the auto policy adds
    the Ruiz sweeps that the A/B measured as the only converging
    configuration, with no knob set by the caller."""
    c, a_full, h = _ill_scaled_banded()
    n = c.shape[0]
    ell = tt.BlockedEllOp.from_dense(a_full.astype(np.float64),
                                     block=(64, 64))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    r = tt.solve(jnp.asarray(c), ell, jnp.asarray(h), lay,
                 tt.SolverParam(profile="fast", max_iter=20_000,
                                eps_acc=1e-3, check_period=20))
    assert int(r.status) == tt.SolverStatus.CONVERGED
    assert float(r.diag["cg_worst_rel"]) <= 10.0 * float(r.diag["cg_tol"])
