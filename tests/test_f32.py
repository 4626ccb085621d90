"""f32 robustness: certificates and convergence in the dtype the
accelerator runs (VERDICT r1 #4; SURVEY section 7 flags criteria_inf's division
by small quantities, ref solver.rs:642-653, as an f32 risk).

The suite's conftest enables x64, but dtype follows the input arrays —
float32 data runs the whole solve in f32.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import totsu_tpu as tt

F32 = np.float32


def _solve32(c, g, h, lay, **kw):
    p = tt.SolverParam(max_iter=500_000, check_period=10, **kw)
    return tt.solve_jit(jnp.asarray(np.asarray(c, F32)),
                        jnp.asarray(np.asarray(g, F32)),
                        jnp.asarray(np.asarray(h, F32)), lay, p)


INFEAS = ([1.0], [[1.0], [-1.0]], [-5.0, -10.0])   # ref totsu/tests/lp.rs:44
UNBDD = ([1.0], [[1.0], [1.0]], [5.0, 10.0])       # ref totsu/tests/lp.rs:81


@pytest.mark.parametrize("method", ["pdhg", "direct"])
@pytest.mark.parametrize("accel", ["", "halpern"])
def test_f32_infeasible_certificate(method, accel):
    lay = tt.ConeLayout([tt.rpos(2)])
    r = _solve32(*INFEAS, lay, method=method, accel=accel)
    assert r.x.dtype == jnp.float32
    assert int(r.status) == tt.SolverStatus.INFEASIBLE


@pytest.mark.parametrize("method", ["pdhg", "direct"])
@pytest.mark.parametrize("accel", ["", "halpern"])
def test_f32_unbounded_certificate(method, accel):
    lay = tt.ConeLayout([tt.rpos(2)])
    r = _solve32(*UNBDD, lay, method=method, accel=accel)
    assert int(r.status) == tt.SolverStatus.UNBOUNDED


def test_f32_certificates_under_normalize_and_equil():
    lay = tt.ConeLayout([tt.rpos(2)])
    for data, want in ((INFEAS, tt.SolverStatus.INFEASIBLE),
                       (UNBDD, tt.SolverStatus.UNBOUNDED)):
        r = _solve32(*data, lay, normalize=True, equil_iters=10)
        assert int(r.status) == want


def test_f32_random_lp_converges_to_1e3():
    # the f32cuda backend's contract: eps_acc = 1e-3 converges in f32
    # (benchmark_lp/src/main.rs:13-92)
    rng = np.random.default_rng(0)
    n = 50
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(2 * n)])
    r = _solve32(c, g, h, lay, eps_acc=1e-3)
    assert int(r.status) == tt.SolverStatus.CONVERGED
    # cross-check the residual in f64 against the f32 solution
    x = np.asarray(r.x, dtype=np.float64)
    res = np.asarray(g) @ x - np.asarray(h)
    cri = np.linalg.norm(np.maximum(res, 0)) / (1 + np.linalg.norm(h))
    assert cri <= 2e-3


def test_f32_fast_profile_converges():
    rng = np.random.default_rng(1)
    n = 60
    g = rng.normal(size=(2 * n, n))
    h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye])       # box rows: bounded for sure
    h = np.concatenate([h, np.full(2 * n, 10.0)])
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(4 * n)])
    r = _solve32(c, g, h, lay, eps_acc=1e-3, profile="fast")
    assert int(r.status) == tt.SolverStatus.CONVERGED
    assert r.x.dtype == jnp.float32


def _unbounded_socp():
    """Unbounded SOCP whose f32 ray residual floors at ~8e-6 (shared by
    the certificate-floor tests below)."""
    rng = np.random.default_rng(5)
    n = 60
    gs = [rng.normal(size=(20, n)) for _ in range(3)]
    hs = [rng.normal(size=20) for _ in range(3)]
    cs = [rng.normal(size=n) * 0.1 for _ in range(3)]
    sp = tt.problems.socp(rng.normal(size=n), gs, hs, cs, [5.0] * 3)
    return (np.asarray(sp.c), np.asarray(sp.a.a), np.asarray(sp.b),
            sp.cone)


def test_f32_explicit_eps_inf_is_honored():
    """An explicitly set eps_inf must NOT be raised by the dtype floor
    (review finding round 2; premise corrected per VERDICT round 2): with
    eps_inf=1e-12 the solve must use 1e-12 verbatim, NOT the f32 floor
    (~1.2e-5). The f32 ray residual on this instance plateaus around
    ~8e-6 and can later cancel to *exactly 0.0* (s becomes bitwise the
    f32 rounding of -A@x), at which point UNBOUNDED fires legitimately —
    an exact-zero residual IS a valid certificate at any tolerance. So
    the contract under test is: either the budget runs out while the
    residual is still above 1e-12 (EXCESS_ITER), or certification
    happened with the explicit tolerance actually satisfied."""
    c, g, h, cone = _unbounded_socp()
    args32 = (jnp.asarray(c, jnp.float32), jnp.asarray(g, jnp.float32),
              jnp.asarray(h, jnp.float32))
    r = tt.solve_jit(*args32, cone,
                     tt.SolverParam(max_iter=30_000, check_period=20,
                                    eps_inf=1e-12))
    assert int(r.status) in (tt.SolverStatus.EXCESS_ITER,
                             tt.SolverStatus.UNBOUNDED)
    if int(r.status) == tt.SolverStatus.UNBOUNDED:
        assert float(r.cri_unbdd) <= 1e-12  # certified at the EXPLICIT tol
    # the same instance at the UNSET (floored) eps_inf certifies at the
    # ~1.2e-5 floor, i.e. strictly earlier than the 1e-12 run can
    r2 = tt.solve_jit(*args32, cone,
                      tt.SolverParam(max_iter=30_000, check_period=20))
    assert int(r2.status) == tt.SolverStatus.UNBOUNDED
    assert int(r.iters) > int(r2.iters)


def test_effective_eps_inf_sentinel():
    """ADVICE r2: None is the 'unset' sentinel; every explicit float —
    including one equal to the resolved default 1e-6 — is verbatim."""
    from totsu_tpu.solver.params import effective_eps_inf
    assert effective_eps_inf(tt.SolverParam(), jnp.float32) == pytest.approx(
        100 * float(jnp.finfo(jnp.float32).eps))
    assert effective_eps_inf(tt.SolverParam(), jnp.float64) == 1e-6
    assert effective_eps_inf(
        tt.SolverParam(eps_inf=1e-6), jnp.float32) == 1e-6
    assert effective_eps_inf(
        tt.SolverParam(eps_inf=1e-12), jnp.float32) == 1e-12
    # bf16 floor is capped at 1e-4 (100 eps = 0.78 would be meaningless)
    assert effective_eps_inf(tt.SolverParam(), jnp.bfloat16) == 1e-4


def test_f32_ns_projection_rank1_accuracy():
    """Regression (round-2 review): the scaled Newton-Schulz schedule must
    keep a safety margin from g(sqrt(3)) = 0 — without it the dominant
    eigenvalue of a (near-)rank-1 f32 block (the typical near-convergence
    SDP iterate) maps to ~1e-5 on step 1 and matmul rounding destroys the
    projection (measured 1.7e-3 error; with the margin, 8e-7)."""
    from totsu_tpu.ops.sympack import psd_part_ns
    rng = np.random.default_rng(3)
    k = 32
    mats = []
    for _ in range(25):
        v = rng.normal(size=k)
        v /= np.linalg.norm(v)
        mats.append(np.outer(v, v))                      # exact rank-1
        e = rng.normal(size=(k, k)) * 1e-4
        mats.append(np.outer(v, v) + (e + e.T) / 2)      # near-rank-1
    x32 = jnp.asarray(np.stack(mats), jnp.float32)
    got = np.asarray(psd_part_ns(x32), dtype=np.float64)
    # exact f64 oracle: clip negative eigenvalues
    w, vecs = np.linalg.eigh(np.stack(mats))
    exact = np.einsum("bik,bk,bjk->bij", vecs, np.maximum(w, 0.0), vecs)
    assert np.abs(got - exact).max() < 5e-6


@pytest.mark.parametrize("method", ["pdhg", "direct"])
def test_f32_unbounded_socp_certificate(method):
    """Regression (round-2): an unbounded SOCP whose f32 ray residual
    floors at ~8e-6 — above the default eps_inf=1e-6 — must still certify
    UNBOUNDED via the dtype floor on eps_inf (100 eps_mach), not spin to
    max_iter. f64 certifies the same instance at the unfloored 1e-6."""
    c, g, h, cone = _unbounded_socp()
    p = tt.SolverParam(max_iter=100_000, check_period=20, method=method)
    r32 = tt.solve_jit(jnp.asarray(c, jnp.float32),
                       jnp.asarray(g, jnp.float32),
                       jnp.asarray(h, jnp.float32), cone, p)
    assert int(r32.status) == tt.SolverStatus.UNBOUNDED, int(r32.iters)
    r64 = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                       cone, p)
    assert int(r64.status) == tt.SolverStatus.UNBOUNDED
