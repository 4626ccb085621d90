"""Solver-core end-to-end tests.

Oracles from the reference:
* the 1-variable SDP asserting x0 ~ -2 (totsu_core/tests/solver.rs:13-54) —
  the "same test, three backends" parity contract;
* the nostd LP converging to (2, 2) in 159 iterations at eps_acc=1e-6
  (examples/nostd_cortex-m/{main.rs:57-99, log_qemu.txt}) — iteration-count
  parity is a strong algorithm-fidelity check.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from totsu_tpu.solver import cone as cones
from totsu_tpu.solver.conic import solve, solve_jit
from totsu_tpu.solver.operator import DenseOp
from totsu_tpu.solver.params import SolverParam, SolverStatus


SQRT2 = np.sqrt(2.0)


def test_core_sdp_reference_parity():
    # ref totsu_core/tests/solver.rs: minimize x s.t.
    # [[0,-1],[-1,-3]]*x + [[1,0],[0,10]] >= 0 (PSD), scaled-vec packed.
    c = jnp.array([1.0])
    a = jnp.array([[0.0], [-1.0 * SQRT2], [-3.0]])
    b = jnp.array([1.0, 0.0, 10.0])
    layout = cones.ConeLayout([cones.psd(2)])
    res = solve(c, a, b, layout, SolverParam(max_iter=100_000))
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x)[0], -2.0, atol=1e-3)


def test_nostd_lp_parity_and_iteration_count():
    # ref examples/nostd_cortex-m/src/main.rs:57-99: maximize x0 inside the
    # triangle with vertices (2,2), (-2,1), (1,-2). The committed QEMU log
    # (log_qemu.txt) converges at iteration 159 (0-based) with
    # x = (1.9999994251590176, 2.0000004472430635); our per-iteration
    # criteria trace matches that log digit-for-digit.
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    layout = cones.ConeLayout([cones.rpos(3)])
    res = solve(c, a, b, layout, SolverParam(max_iter=100_000))
    assert res.converged
    # exact iteration-count parity (ours counts updates: 160 = ref's 0-based 159)
    assert int(res.iters) == 160, int(res.iters)
    np.testing.assert_allclose(
        np.asarray(res.x),
        [1.9999994251590176, 2.0000004472430635], atol=1e-9)


def test_solve_jit_is_jittable_and_pure():
    c = jnp.array([1.0, 1.0])
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0]])
    h = jnp.array([-1.0, -1.0])
    layout = cones.ConeLayout([cones.rpos(2)])
    param = SolverParam(max_iter=10_000)
    fn = jax.jit(lambda cc, aa, bb: solve_jit(cc, aa, bb, layout, param))
    res = fn(c, DenseOp(g), h)
    assert int(res.status) == SolverStatus.CONVERGED
    np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-3)


def test_batched_vmap_solve():
    # lockstep batched instances via vmap (new capability, SURVEY 2.8)
    layout = cones.ConeLayout([cones.rpos(2)])
    param = SolverParam(max_iter=20_000)
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0]])

    def one(lo):
        return solve_jit(jnp.array([1.0, 1.0]), DenseOp(g), -lo, layout,
                         param)

    los = jnp.array([[1.0, 2.0], [3.0, 0.5], [0.1, 0.2]])
    res = jax.vmap(one)(los)
    assert np.all(np.asarray(res.status) == SolverStatus.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(los), atol=1e-3)


def test_warm_start_reduces_iterations():
    c = jnp.array([1.0, 1.0])
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0], [0.0, 0.0]])
    h = jnp.array([-2.0, -2.0, 1.0])
    layout = cones.ConeLayout([cones.rpos(3)])
    param = SolverParam(max_iter=100_000)
    cold = solve(c, g, h, layout, param)
    warm = solve(c, g, h, layout, param,
                 warm_start=(cold.x, cold.y))
    assert int(warm.iters) < int(cold.iters)


def test_check_period_amortized():
    c = jnp.array([1.0, 1.0])
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0], [0.0, 0.0]])
    h = jnp.array([-2.0, -2.0, 1.0])
    layout = cones.ConeLayout([cones.rpos(3)])
    res = solve(c, g, h, layout,
                SolverParam(max_iter=100_000, check_period=25))
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-3)


def test_f32_solve():
    # f32 convergence at eps_acc=1e-3 (the f32cuda contract, SURVEY 2.4)
    c = jnp.array([1.0, 1.0], dtype=jnp.float32)
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0]], dtype=jnp.float32)
    h = jnp.array([-2.0, -2.0], dtype=jnp.float32)
    layout = cones.ConeLayout([cones.rpos(2)])
    res = solve(c, g, h, layout,
                SolverParam(max_iter=100_000, eps_acc=1e-3))
    assert res.converged
    assert res.x.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-2)


def test_solver_facade_par():
    # reference-style Solver().par(...).solve(problem()) ergonomics
    import totsu_tpu as tt
    import numpy as np
    prob = tt.problems.qp(np.eye(2), [1.0, 2.0],
                          g=[[-0.5, -1.0 / 3.0]], h=[-1.0])
    s = tt.Solver().par(lambda p: setattr(p, "max_iter", 100_000))
    res = s.solve(prob)
    assert s.param.max_iter == 100_000
    np.testing.assert_allclose(np.asarray(res.x)[:2], [2.0, 0.0], atol=1e-3)


def test_check_operator_utility():
    import numpy as np
    import pytest
    from totsu_tpu.solver.operator import CustomOp
    from totsu_tpu.utils import check_operator
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(7, 5)))
    good = CustomOp(params=a, m=7, n=5, matvec_fn=lambda p, x: p @ x)
    check_operator(good)
    bad = CustomOp(params=a, m=7, n=5, matvec_fn=lambda p, x: p @ x,
                   rmatvec_fn=lambda p, y: 2.0 * (y @ p))
    with pytest.raises(AssertionError):
        check_operator(bad)


def test_solve_sequence_warm_start():
    import totsu_tpu as tt
    lay = cones.ConeLayout([cones.rpos(3)])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    probs = [(jnp.array([-1.0, -t * 0.01]), a, b, lay) for t in range(4)]
    res = tt.solve_sequence(probs, SolverParam(max_iter=100_000))
    assert len(res) == 4
    # warm-started solves converge faster than the cold first one
    assert int(res[1].iters) < int(res[0].iters)
    np.testing.assert_allclose(np.asarray(res[-1].x), [2.0, 2.0], atol=1e-3)


def test_checkpoint_resume_exact():
    # split a solve in two via resume_state; total path identical to the
    # uninterrupted run
    import totsu_tpu as tt
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    lay = cones.ConeLayout([cones.rpos(3)])
    full = tt.solve_jit(c, a, b, lay, SolverParam(max_iter=100_000))
    part1 = tt.solve_jit(c, a, b, lay,
                         SolverParam(max_iter=80, return_state=True))
    assert int(part1.status) == SolverStatus.EXCESS_ITER
    part2 = tt.solve_jit(c, a, b, lay, SolverParam(max_iter=100_000),
                         resume_state=part1.state)
    assert int(part2.status) == SolverStatus.CONVERGED
    assert int(part1.iters) + int(part2.iters) == int(full.iters)
    np.testing.assert_allclose(np.asarray(part2.x), np.asarray(full.x),
                               atol=1e-12)


def _random_lp(n=60, seed=3):
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    c = rng.normal(size=n)
    return (jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
            cones.ConeLayout([cones.rpos(m)]))


def test_accel_halpern_converges_matching_plain():
    # restarted reflected-Halpern PDHG (opt-in; no reference counterpart) —
    # must reach the same optimum, typically in fewer iterations
    c, g, h, lay = _random_lp()
    plain = solve(c, g, h, lay,
                  SolverParam(eps_acc=1e-6, check_period=20,
                              max_iter=2_000_000))
    halp = solve(c, g, h, lay,
                 SolverParam(eps_acc=1e-6, check_period=20,
                             max_iter=2_000_000, accel="halpern"))
    obj_p = float(jnp.dot(c, plain.x))
    obj_h = float(jnp.dot(c, halp.x))
    np.testing.assert_allclose(obj_h, obj_p, rtol=1e-4, atol=1e-4)
    assert int(halp.iters) <= int(plain.iters)


def test_accel_restart_converges_matching_plain():
    # PDLP-style restarted averaging (opt-in)
    c, g, h, lay = _random_lp(seed=4)
    plain = solve(c, g, h, lay,
                  SolverParam(eps_acc=1e-5, check_period=20,
                              max_iter=2_000_000))
    rst = solve(c, g, h, lay,
                SolverParam(eps_acc=1e-5, check_period=20,
                            max_iter=2_000_000, accel="restart"))
    obj_p = float(jnp.dot(c, plain.x))
    obj_r = float(jnp.dot(c, rst.x))
    np.testing.assert_allclose(obj_r, obj_p, rtol=1e-3, atol=1e-3)


def _random_box_lp(n=60, seed=3):
    # like _random_lp but with |x| <= 10 box rows, guaranteeing boundedness
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye])
    h = np.concatenate([h, np.full(2 * n, 10.0)])
    c = rng.normal(size=n)
    return (jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
            cones.ConeLayout([cones.rpos(m + 2 * n)]))


def test_normalize_converges_matching_plain():
    # SolverParam.normalize iterates on b/||b||, c/||c|| but evaluates the
    # criteria on the un-normalized data — same optimum, same certificate
    # semantics, far fewer iterations on badly balanced data
    c, g, h, lay = _random_box_lp(seed=5)
    plain = solve(c, g, h, lay,
                  SolverParam(eps_acc=1e-6, check_period=20,
                              max_iter=2_000_000))
    normd = solve(c, g, h, lay,
                  SolverParam(eps_acc=1e-6, check_period=20,
                              max_iter=2_000_000, normalize=True))
    obj_p = float(jnp.dot(c, plain.x))
    obj_n = float(jnp.dot(c, normd.x))
    np.testing.assert_allclose(obj_n, obj_p, rtol=1e-4, atol=1e-4)
    # the returned criteria are in the un-normalized space: re-check the
    # primal residual by hand against the original data
    r = np.asarray(g) @ np.asarray(normd.x) - np.asarray(h)
    cri_pri = np.linalg.norm(np.maximum(r, 0.0)) / (
        1.0 + np.linalg.norm(np.asarray(h)))
    assert cri_pri <= 2e-6


def test_normalize_certificates_preserved():
    from totsu_tpu.problems import lp
    infeas = lp(c=[1.0], g=[[1.0], [-1.0]], h=[-5.0, -10.0])
    unbdd = lp(c=[1.0], g=[[1.0], [1.0]], h=[5.0, 10.0])
    p = SolverParam(max_iter=100_000, normalize=True, check_period=10)
    assert int(infeas.solve_jit(p).status) == SolverStatus.INFEASIBLE
    assert int(unbdd.solve_jit(p).status) == SolverStatus.UNBOUNDED


def test_normalize_warm_start_roundtrip():
    # warm-starting with the exact solution under normalize=True must
    # converge almost immediately (the (sb, sc) scalings map the seed into
    # the iterated space correctly)
    c, g, h, lay = _random_box_lp(seed=6)
    p = SolverParam(eps_acc=1e-6, check_period=10, max_iter=2_000_000,
                    normalize=True, accel="halpern")
    cold = solve(c, g, h, lay, p)
    warm = solve(c, g, h, lay, p, warm_start=(cold.x, cold.y))
    assert int(warm.iters) <= max(100, int(cold.iters) // 10)
    np.testing.assert_allclose(
        float(jnp.dot(c, warm.x)), float(jnp.dot(c, cold.x)),
        rtol=1e-4, atol=1e-4)


def test_warm_start_regression_matrix():
    # VERDICT r1 #1 done-criteria: warm-starting at the exact solution must
    # converge in <= a small fraction of cold iterations for EVERY
    # accel x normalize combination (round-1 bug: under halpern+normalize a
    # solution-seeded warm start took 1.5x the COLD iteration count because
    # only the u.x/u.y blocks were seeded — the slack block and the Halpern
    # anchor sat far from any fixed point).
    c, g, h, lay = _random_box_lp(seed=7)
    for accel in ("", "restart", "halpern"):
        for normalize in (False, True):
            p = SolverParam(eps_acc=1e-6, check_period=10,
                            max_iter=2_000_000, normalize=normalize,
                            accel=accel)
            cold = solve(c, g, h, lay, p)
            warm = solve(c, g, h, lay, p, warm_start=(cold.x, cold.y))
            assert int(warm.iters) <= max(50, int(cold.iters) // 10), (
                accel, normalize, int(warm.iters), int(cold.iters))
            np.testing.assert_allclose(
                float(jnp.dot(c, warm.x)), float(jnp.dot(c, cold.x)),
                rtol=1e-4, atol=1e-4)


def test_normalize_zero_vector_graceful():
    # advisor r1 (low): b = 0 or c = 0 must not divide seeds/solutions by
    # eps_zero under normalize=True — the scaling is a no-op instead
    lay = cones.ConeLayout([cones.rpos(3)])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    # c = 0: pure feasibility; any feasible point converges
    res = solve(jnp.zeros(2), a, b, lay,
                SolverParam(max_iter=200_000, normalize=True))
    r = np.asarray(a) @ np.asarray(res.x) - np.asarray(b)
    assert np.max(r) <= 1e-3
    assert np.all(np.isfinite(np.asarray(res.x)))
    # warm start on top of the zero-c problem exercises the seed path
    res2 = solve(jnp.zeros(2), a, b, lay,
                 SolverParam(max_iter=200_000, normalize=True),
                 warm_start=(res.x, res.y))
    assert np.all(np.isfinite(np.asarray(res2.x)))
    assert int(res2.iters) <= int(res.iters)


def test_fast_profile_lp():
    # VERDICT r1 #2: profile='fast' must reach the same optimum with far
    # fewer iterations than the reference profile; dense-small resolves to
    # the direct engine
    c, g, h, lay = _random_box_lp(seed=8)
    ref = solve(c, g, h, lay, SolverParam(eps_acc=1e-6, max_iter=2_000_000))
    fast = solve(c, g, h, lay, SolverParam(eps_acc=1e-6, max_iter=2_000_000,
                                           profile="fast"))
    np.testing.assert_allclose(float(jnp.dot(c, fast.x)),
                               float(jnp.dot(c, ref.x)), rtol=1e-4, atol=1e-4)
    assert int(fast.iters) < int(ref.iters) // 10


def test_fast_profile_respects_explicit_fields():
    from totsu_tpu.solver.conic import _resolve_fast_profile
    import totsu_tpu as tt
    a = jnp.zeros((6, 3))
    lay = tt.ConeLayout([tt.rpos(6)])
    # defaults: dense-small -> direct + halpern + check_period 20, the
    # profile tag resolved to 'reference' so the expansion runs once
    p = _resolve_fast_profile(SolverParam(profile="fast"), a, lay)
    assert (p.method, p.accel, p.check_period, p.profile) \
        == ("direct", "halpern", 20, "reference")
    # explicit pdhg stays pdhg and picks the first-order fast set
    p = _resolve_fast_profile(
        SolverParam(profile="fast", method="pdhg", relax=1.9), a, lay)
    assert p.method == "pdhg" and p.accel == "" and p.normalize is True \
        and p.equil_iters == 10
    # explicit accel and check_period are preserved
    p = _resolve_fast_profile(
        SolverParam(profile="fast", accel="restart", check_period=5), a, lay)
    assert p.accel == "restart" and p.check_period == 5
    # explicit direct engine settings are preserved too
    p = _resolve_fast_profile(
        SolverParam(profile="fast", method="direct", relax=1.5), a, lay)
    assert p.method == "direct" and p.accel == "" and p.relax == 1.5
    # explicit pdhg + mixed-precision matvec streaming stays on pdhg
    p = _resolve_fast_profile(
        SolverParam(profile="fast", matvec_dtype="bfloat16"), a, lay)
    assert p.method == "pdhg" and p.normalize is True


def test_fast_profile_routes_structured_operators():
    """The fast profile routes non-dense operators to the indirect direct
    engine with halpern, WITHOUT forcing equilibration (it cost both
    engines iterations on the well-scaled banded instance)."""
    from totsu_tpu.solver.conic import _resolve_fast_profile
    import totsu_tpu as tt
    lay = tt.ConeLayout([tt.rpos(6)])
    # matrix-free CustomOp -> indirect engine
    op = tt_custom_op()
    lay3 = tt.ConeLayout([tt.rpos(3)])
    p = _resolve_fast_profile(SolverParam(profile="fast"), op, lay3)
    assert p.method == "direct" and p.accel == "halpern"
    assert p.equil_iters is None    # unset: no forced equilibration
    # blocked-ELL -> indirect engine
    ell = tt.BlockedEllOp.from_dense(np.eye(6), block=(2, 2))
    p = _resolve_fast_profile(SolverParam(profile="fast"), ell, lay)
    assert p.method == "direct" and p.accel == "halpern"
    assert p.equil_iters is None    # unset: no forced equilibration
    # explicit method wins over the routing
    p = _resolve_fast_profile(
        SolverParam(profile="fast", method="pdhg", relax=1.9), ell, lay)
    assert p.method == "pdhg"
    # and the routed config actually solves a structured problem
    rng = np.random.default_rng(11)
    n = 16
    band = np.zeros((n, n))
    for i in range(n):
        band[i, max(0, i - 2):min(n, i + 2)] = rng.normal(
            size=min(n, i + 2) - max(0, i - 2))
    a2 = np.concatenate([band, np.eye(n), -np.eye(n)])
    h2 = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                         np.full(2 * n, 5.0)])
    c2 = rng.normal(size=n)
    lay2 = tt.ConeLayout([tt.rpos(3 * n)])
    ell2 = tt.BlockedEllOp.from_dense(a2, block=(4, 4))
    r = tt.solve_jit(jnp.asarray(c2), ell2, jnp.asarray(h2), lay2,
                     SolverParam(profile="fast", eps_acc=1e-6,
                                 max_iter=200_000))
    r_ref = tt.solve_jit(jnp.asarray(c2), jnp.asarray(a2),
                         jnp.asarray(h2), lay2,
                         SolverParam(eps_acc=1e-6, max_iter=2_000_000))
    assert int(r.status) == int(r_ref.status) == 1
    np.testing.assert_allclose(float(jnp.dot(jnp.asarray(c2), r.x)),
                               float(jnp.dot(jnp.asarray(c2), r_ref.x)),
                               rtol=1e-4, atol=1e-4)
    assert int(r.iters) < int(r_ref.iters) // 5


def tt_custom_op():
    from totsu_tpu.solver.operator import CustomOp
    return CustomOp(params=jnp.eye(3), m=3, n=3, matvec_fn=lambda p, x: p @ x)


def test_accel_certificates_preserved():
    # the infeasible / unbounded reference instances (totsu/tests/lp.rs)
    # must keep their certificates under both acceleration schemes
    from totsu_tpu.problems import lp
    infeas = lp(c=[1.0], g=[[1.0], [-1.0]], h=[-5.0, -10.0])
    unbdd = lp(c=[1.0], g=[[1.0], [1.0]], h=[5.0, 10.0])
    for accel in ("halpern", "restart"):
        p = SolverParam(max_iter=100_000, accel=accel, check_period=10)
        assert int(infeas.solve_jit(p).status) == SolverStatus.INFEASIBLE
        assert int(unbdd.solve_jit(p).status) == SolverStatus.UNBOUNDED


def test_accel_vmap_composes():
    layout = cones.ConeLayout([cones.rpos(2)])
    param = SolverParam(max_iter=100_000, accel="halpern", check_period=10)
    g = jnp.array([[-1.0, 0.0], [0.0, -1.0]])

    def one(lo):
        return solve_jit(jnp.array([1.0, 1.0]), DenseOp(g), -lo, layout,
                         param)

    los = jnp.array([[1.0, 2.0], [3.0, 0.5]])
    res = jax.vmap(one)(los)
    assert np.all(np.asarray(res.status) == SolverStatus.CONVERGED)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(los), atol=1e-3)


def test_matvec_dtype_bf16_exact_data_keeps_parity():
    # the golden LP's entries (4, -1, 6, 1) are exactly representable in
    # bfloat16, so the bf16 update path must reproduce the reference
    # iterate path bit-for-bit (160 updates)
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    layout = cones.ConeLayout([cones.rpos(3)])
    res = solve(c, a, b, layout,
                SolverParam(max_iter=100_000, matvec_dtype="bfloat16"))
    assert res.converged
    assert int(res.iters) == 160, int(res.iters)
    np.testing.assert_allclose(np.asarray(res.x), [2.0, 2.0], atol=1e-5)


def test_matvec_dtype_bf16_random_lp_honest_certification():
    # random data IS perturbed by bf16 rounding (relative ~4e-3). At a
    # coarse tolerance the exact-A criteria certify a solution of the
    # ORIGINAL problem; at a tolerance below the perturbation floor the
    # solver must report EXCESS_ITER rather than mis-certify.
    from bench import make_lp
    c, g, h = make_lp(60, seed=5)
    layout = cones.ConeLayout([cones.rpos(g.shape[0])])
    cj, gj, hj = (jnp.asarray(x) for x in (c, g, h))

    param_coarse = SolverParam(max_iter=300_000, eps_acc=3e-2,
                               check_period=20, matvec_dtype="bfloat16")
    r1 = solve_jit(cj, gj, hj, layout, param_coarse)
    assert int(r1.status) == SolverStatus.CONVERGED
    r0 = solve_jit(cj, gj, hj, layout,
                   SolverParam(max_iter=300_000, eps_acc=3e-2,
                               check_period=20))
    obj0 = float(c @ np.asarray(r0.x))
    obj1 = float(c @ np.asarray(r1.x))
    assert abs(obj0 - obj1) <= 1e-1 * (1.0 + abs(obj0)), (obj0, obj1)

    param_tight = SolverParam(max_iter=100_000, eps_acc=1e-3,
                              check_period=20, matvec_dtype="bfloat16")
    r2 = solve_jit(cj, gj, hj, layout, param_tight)
    assert int(r2.status) == SolverStatus.EXCESS_ITER
    # ... and the criteria it reports are the exact-A residuals, which
    # honestly sit above the requested tolerance
    assert float(r2.cri_pri) > 1e-4 or float(r2.cri_dual) > 1e-4


def test_matvec_dtype_requires_astype_support():
    # matvec_dtype composes with any LinOp implementing astype()
    # (dense, blocked-ELL, diag, stacks — VERDICT r2 #3); a matrix-free
    # CustomOp has no stored data to cast and raises.
    from totsu_tpu.solver.operator import CustomOp
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    op = CustomOp(a, 3, 2, lambda p, x: p @ x)
    layout = cones.ConeLayout([cones.rpos(3)])
    with pytest.raises(NotImplementedError):
        solve_jit(c, op, b, layout, SolverParam(matvec_dtype="bfloat16"))


def test_matvec_dtype_direct_rejected():
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    layout = cones.ConeLayout([cones.rpos(3)])
    with pytest.raises(ValueError):
        solve_jit(c, a, b, layout,
                  SolverParam(method="direct", matvec_dtype="bfloat16"))


def test_fast_profile_exp_pow_never_mega_first():
    """Small dense layouts of every cone kind the removed whole-solve
    kernel covered — exp, pow, SOC, RSOC — all route to the direct
    engine: no platform-dependent pdhg-first branch is left."""
    from totsu_tpu.solver.conic import _resolve_fast_profile
    import totsu_tpu as tt
    lay = tt.ConeLayout([tt.expc(count=2), tt.rpos(6)])
    a = jnp.zeros((lay.dim, 4), jnp.float32)
    p = _resolve_fast_profile(SolverParam(profile="fast"), a, lay)
    assert p.method == "direct" and p.accel == "halpern"
    layp = tt.ConeLayout([tt.powc(0.4, count=2), tt.rpos(6)])
    p = _resolve_fast_profile(SolverParam(profile="fast"), a, layp)
    assert p.method == "direct"
    for lays in (tt.ConeLayout([tt.soc(4, count=3)]),
                 tt.ConeLayout([tt.rsoc(4, count=3)])):
        a2 = jnp.zeros((lays.dim, 4), jnp.float32)
        p = _resolve_fast_profile(SolverParam(profile="fast"), a2, lays)
        assert p.method == "direct" and p.accel == "halpern"
    # progress logging no longer changes the routing
    p = _resolve_fast_profile(
        SolverParam(profile="fast", log_period=1000), a2, lays)
    assert p.method == "direct"
    assert not hasattr(SolverParam(), "kernel")


def test_fast_profile_psd_layouts_stay_on_pdhg():
    """Structured-operator PSD layouts keep the pdhg fast path (the
    inherited routing; ROADMAP Design 2 re-derives it on the H100)."""
    from totsu_tpu.solver.conic import _resolve_fast_profile
    import totsu_tpu as tt
    lay = tt.ConeLayout([tt.psd(4), tt.zero(3)])
    op = tt.BlockedEllOp.from_dense(np.eye(lay.dim), block=(13, 13))
    p = _resolve_fast_profile(SolverParam(profile="fast"), op, lay)
    assert p.method == "pdhg" and p.accel == "halpern"
    assert p.normalize is True


def test_set_par_by_env(monkeypatch):
    """utils2::set_par_by_env parity (ref set_par_by_env.rs:5-25) plus the
    the knobs added since (PROFILE/ACCEL)."""
    from totsu_tpu.utils import set_par_by_env
    monkeypatch.setenv("MAX_ITER", "1234")
    monkeypatch.setenv("EPS_ACC", "1e-4")
    monkeypatch.setenv("CHECK_PERIOD", "7")
    monkeypatch.setenv("PROFILE", "fast")
    monkeypatch.setenv("ACCEL", "halpern")
    p = set_par_by_env(SolverParam())
    assert p.max_iter == 1234 and p.eps_acc == 1e-4
    assert p.check_period == 7 and p.profile == "fast"
    assert p.accel == "halpern"
    monkeypatch.delenv("MAX_ITER")
    monkeypatch.delenv("EPS_ACC")
    monkeypatch.delenv("CHECK_PERIOD")
    monkeypatch.delenv("PROFILE")
    monkeypatch.delenv("ACCEL")
    assert set_par_by_env(SolverParam()) == SolverParam()


def test_solve_chunked_matches_single_dispatch():
    """solve(chunk_iters=N): N-iteration dispatches stitched with exact
    resume checkpoints must reproduce the single-dispatch result exactly
    for the plain engines."""
    c = jnp.array([-1.0, 0.0])
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]])
    b = jnp.array([6.0, 6.0, 1.0])
    lay = cones.ConeLayout([cones.rpos(3)])
    full = solve(c, a, b, lay, SolverParam(max_iter=100_000))
    chunked = solve(c, a, b, lay, SolverParam(max_iter=100_000),
                    chunk_iters=50)
    assert int(chunked.iters) == int(full.iters) == 160
    np.testing.assert_allclose(np.asarray(chunked.x), np.asarray(full.x),
                               atol=1e-12)
    # direct engine chunks too (exact for plain AND halpern since r5)
    ch_d = solve(c, a, b, lay,
                 SolverParam(max_iter=100_000, method="direct"),
                 chunk_iters=40)
    assert int(ch_d.status) == SolverStatus.CONVERGED
    # the overall max_iter cap applies EXACTLY across chunks (the tail
    # chunk is shortened — ADVICE r4: 100 is not a multiple of 40)
    import pytest as _pytest
    from totsu_tpu.solver.params import SolverError
    with _pytest.raises(SolverError):
        solve(c, a, b, lay, SolverParam(max_iter=100), chunk_iters=40)
    p_cap = SolverParam(max_iter=100, return_state=True)
    try:
        solve(c, a, b, lay, p_cap, chunk_iters=40)
    except SolverError:
        pass
    part = solve_jit(c, a, b, lay, p_cap)
    assert int(part.iters) == 100  # engine-level: cap honored exactly


def _boxed_lp(n, seed):
    """Feasible AND bounded random LP (box rows keep min c'x finite —
    the plain _random_lp instances can be genuinely unbounded)."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    g = np.concatenate([g, np.eye(n), -np.eye(n)])
    h = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)])
    c = rng.normal(size=n)
    return (jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
            cones.ConeLayout([cones.rpos(g.shape[0])]))


def test_solve_chunked_halpern_exact():
    """r5 (VERDICT r4 #2): chunked solves are EXACT for the accel
    wrappers too — the ResumeState carries the Halpern anchor + epoch
    counters (pdhg) and the DR z / CG warm start / cached inverse
    (direct), so the chunked iterate path equals the single-dispatch
    one, iteration count included."""
    c, g, h, lay = _boxed_lp(n=40, seed=5)
    for method in ("pdhg", "direct"):
        p = SolverParam(max_iter=200_000, eps_acc=1e-6, check_period=20,
                        accel="halpern", method=method)
        full = solve(c, g, h, lay, p)
        chunked = solve(c, g, h, lay, p, chunk_iters=100)
        assert int(full.iters) > 100  # the test actually chunks
        assert int(chunked.iters) == int(full.iters), method
        np.testing.assert_allclose(np.asarray(chunked.x),
                                   np.asarray(full.x), atol=1e-12)
    # restart accel: running-average sums carried across chunks
    p_r = SolverParam(max_iter=200_000, eps_acc=1e-6, check_period=20,
                      accel="restart")
    full = solve(c, g, h, lay, p_r)
    chunked = solve(c, g, h, lay, p_r, chunk_iters=100)
    assert int(chunked.iters) == int(full.iters)
    np.testing.assert_allclose(np.asarray(chunked.x), np.asarray(full.x),
                               atol=1e-12)


def test_resume_state_exact_across_engines_and_accels():
    """Manual two-part resume via ResumeState reproduces the
    uninterrupted run exactly (path + count) for every engine x accel."""
    import totsu_tpu as tt
    c, g, h, lay = _boxed_lp(n=30, seed=9)
    # per-combo eps so every FULL run converges within the cap (plain
    # pdhg's 1e-6 tail is ~10^6 iterations on this instance)
    combos = [("pdhg", "", 1e-3), ("pdhg", "halpern", 1e-6),
              ("pdhg", "restart", 1e-6), ("direct", "", 1e-6),
              ("direct", "halpern", 1e-6)]
    for method, accel, eps in combos:
        kw = dict(eps_acc=eps, check_period=20, method=method, accel=accel)
        full = tt.solve_jit(c, g, h, lay,
                            SolverParam(max_iter=200_000, **kw))
        part1 = tt.solve_jit(c, g, h, lay,
                             SolverParam(max_iter=60, return_state=True,
                                         **kw))
        assert int(part1.status) == SolverStatus.EXCESS_ITER, (method, accel)
        st = part1.state
        assert isinstance(st, tt.ResumeState)
        assert st.engine == method and st.accel == accel
        assert int(st.k) == int(part1.iters) == 60
        part2 = tt.solve_jit(c, g, h, lay,
                             SolverParam(max_iter=200_000, **kw),
                             resume_state=st)
        total = int(part1.iters) + int(part2.iters)
        assert total == int(full.iters), (method, accel, total,
                                          int(full.iters))
        np.testing.assert_allclose(np.asarray(part2.x), np.asarray(full.x),
                                   atol=1e-12, err_msg=f"{method}/{accel}")


def test_resume_state_direct_carries_caches():
    """The direct engine's checkpoint carries the cached inverse of
    I + A^T A (from its Cholesky factor) and the Sherman-Morrison border,
    and a resumed solve reuses them instead of rebuilding (VERDICT r4 #2
    'cheap')."""
    import totsu_tpu as tt
    c, g, h, lay = _boxed_lp(n=25, seed=11)
    p = SolverParam(max_iter=30, method="direct", accel="halpern",
                    return_state=True)
    part = tt.solve_jit(c, g, h, lay, p)
    aux = part.state.aux
    assert {"spd_inv", "gh", "denom", "ws", "anchor", "ke"} <= set(aux)
    # the resumed trace must not contain a Cholesky factorization:
    # lower the jaxpr and look for the cholesky primitive
    fn = jax.jit(lambda cc, aa, bb, st: tt.solve_jit(
        cc, aa, bb, lay, SolverParam(max_iter=30, method="direct",
                                     accel="halpern"), resume_state=st))
    txt = str(jax.make_jaxpr(
        lambda cc, aa, bb, st: tt.solve_jit(
            cc, aa, bb, lay, SolverParam(max_iter=30, method="direct",
                                         accel="halpern"),
            resume_state=st))(c, g, h, part.state))
    assert "cholesky" not in txt
    cold_txt = str(jax.make_jaxpr(
        lambda cc, aa, bb: tt.solve_jit(
            cc, aa, bb, lay, SolverParam(max_iter=30, method="direct",
                                         accel="halpern")))(c, g, h))
    assert "cholesky" in cold_txt  # the guard actually distinguishes


def test_terminal_checkpoint_resume_is_frozen():
    """Resuming a TERMINAL checkpoint must be a no-op: 0 iterations and
    a bit-identical solution (r5 review: the accel resume path reseeded
    from the raw reflected carry, so a resumed CONVERGED solve reported
    the checkpoint's criteria but a 7e-8/2.6e-7-drifted x — every later
    chunk of a chunked batch silently perturbed finished lanes)."""
    rng = np.random.default_rng(4)
    n = 24
    g = rng.normal(size=(2 * n, n))
    h = np.concatenate([g @ rng.normal(size=n) + rng.random(2 * n) + 0.1,
                        np.full(2 * n, 10.0)])
    g = np.concatenate([g, np.eye(n), -np.eye(n)])
    c = rng.normal(size=n)
    lay = cones.ConeLayout([cones.rpos(4 * n)])
    for method, accel in (("pdhg", "halpern"), ("pdhg", "restart"),
                          ("direct", "halpern")):
        p = SolverParam(max_iter=200_000, method=method, accel=accel,
                        check_period=10, return_state=True)
        r1 = solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                       lay, p)
        assert int(r1.status) == SolverStatus.CONVERGED, (method, accel)
        r2 = solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                       lay, p, resume_state=r1.state)
        assert int(r2.iters) == 0, (method, accel)
        assert int(r2.status) == int(r1.status)
        assert float(jnp.max(jnp.abs(r2.x - r1.x))) == 0.0, (method, accel)
        assert float(jnp.max(jnp.abs(r2.y - r1.y))) == 0.0, (method, accel)
        np.testing.assert_array_equal(np.asarray(r2.cri_pri),
                                      np.asarray(r1.cri_pri))
