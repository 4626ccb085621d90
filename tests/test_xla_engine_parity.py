"""The pdhg engine's XLA loop against the native C++ engine on every cone
kind a dense first-order solve runs: R+, zero + SOC, RSOC, exp, pow,
mixed exp + pow and SOC + exp, each plain and under the Halpern wrapper.

The native engine runs the reference iteration in f64 to a tight
tolerance; the XLA solve must reach the same optimum. Also covered: the
infeasibility certificate, warm-start convergence at 0 iterations, and an
exact checkpoint resume.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import totsu_tpu as tt
from totsu_tpu.native import solve_native
from totsu_tpu.solver.params import SolverStatus


def _box_lp(n=24, m=60, seed=0):
    """bench.make_lp's shape at a small size: random rows + box."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(m, n))
    h = g @ rng.normal(size=n) + rng.random(m) + 0.1
    eye = np.eye(n)
    a = np.concatenate([g, eye, -eye])
    b = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)])
    return rng.normal(size=n), a, b, tt.ConeLayout([tt.rpos(m + 2 * n)])


def _soc_zero(seed=5, n=20):
    # SOC blocks (incl. a degenerate length-1 block) + equality rows
    rng = np.random.default_rng(seed)
    lay = tt.ConeLayout([tt.soc(3, count=6), tt.soc(1), tt.rpos(12),
                         tt.zero(4)])
    a = rng.normal(size=(lay.dim, n))
    b = a @ rng.normal(size=n)
    b[19:31] += rng.random(12) + 0.1      # rpos slack
    b[:19] += 0.5                         # soc slack
    return _bounded(rng.normal(size=n), a, b, lay)


def _rsoc(seed=11, n=18):
    # rotated-SOC blocks — the QP/QCQP reduction's cone shape
    rng = np.random.default_rng(seed)
    lay = tt.ConeLayout([tt.rsoc(4, count=5), tt.rsoc(1), tt.rpos(10),
                         tt.zero(3)])
    a = rng.normal(size=(lay.dim, n))
    b = a @ rng.normal(size=n)
    b[:20] += 2.0                         # rsoc slack
    b[21:31] += rng.random(10) + 0.1      # rpos slack
    return _bounded(rng.normal(size=n), a, b, lay)


def _bounded(c, a, b, lay):
    """Append the box |x_i| <= 10 so every instance has an optimum."""
    n = c.shape[0]
    eye = np.eye(n)
    lay2 = tt.ConeLayout(list(lay.factors) + [tt.rpos(2 * n)])
    return (c, np.concatenate([a, eye, -eye]),
            np.concatenate([b, np.full(2 * n, 10.0)]), lay2)


def _cone_mix(factors, interior, n=6, seed=0):
    """Feasible + bounded instance with the given leading cone factors,
    the slack of each block at a strictly interior point."""
    rng = np.random.default_rng(seed)
    lay = tt.ConeLayout(list(factors) + [tt.rpos(2 * n)])
    m = lay.dim
    a = np.concatenate([rng.normal(size=(m - 2 * n, n)) / np.sqrt(n),
                        np.eye(n), -np.eye(n)])
    s0 = np.concatenate([np.tile(pt, f.count)
                         for f, pt in zip(factors, interior)]
                        + [np.ones(2 * n)])
    b = a @ (rng.normal(size=n) * 0.5) + s0
    return rng.normal(size=n), a, b, lay


EXP_PT = np.array([0.0, 1.0, 2.0])
POW_PT = np.array([2.0, 2.0, 1.0])

INSTANCES = {
    "rpos": lambda: _box_lp(n=12, m=30, seed=3),
    "zero_soc": _soc_zero,
    "rsoc": _rsoc,
    "exp": lambda: _cone_mix([tt.expc(count=3), tt.rpos(2)],
                             [EXP_PT, np.ones(2)]),
    "pow": lambda: _cone_mix([tt.powc(0.3, count=2), tt.rpos(2)],
                             [POW_PT, np.ones(2)]),
    "exp_pow": lambda: _cone_mix(
        [tt.expc(count=2), tt.powc(0.7), tt.rpos(1)],
        [EXP_PT, POW_PT, np.ones(1)]),
    "soc_exp": lambda: _cone_mix(
        [tt.soc(4, count=2), tt.expc(count=2), tt.rpos(3)],
        [np.array([2.0, 0.3, 0.3, 0.3]), EXP_PT, np.ones(3)], seed=2),
}


@pytest.mark.parametrize("accel", ["", "halpern"])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_xla_loop_matches_native(name, accel):
    c, a, b, lay = INSTANCES[name]()
    xn, _, st_n, _ = solve_native(
        c, a, b, lay, tt.SolverParam(max_iter=2_000_000, eps_acc=1e-8))
    assert st_n == SolverStatus.CONVERGED
    res = tt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                       tt.SolverParam(max_iter=1_000_000, eps_acc=1e-5,
                                      check_period=10, accel=accel))
    assert int(res.status) == SolverStatus.CONVERGED
    # the optimal objective is unique, x only up to the optimal face
    # (nearly flat on the rsoc instance), so compare the objective and
    # check that the slack b - A x lies in the cone
    x = np.asarray(res.x)
    obj_n = float(c @ xn)
    assert abs(float(c @ x) - obj_n) <= 1e-4 * (1.0 + abs(obj_n))
    s = jnp.asarray(b - a @ x)
    dist = float(jnp.linalg.norm(s - lay.project(s, dual=False)))
    assert dist <= 1e-4 * (1.0 + np.linalg.norm(b))


def test_xla_loop_infeasible_certificate():
    # x <= -1 and -x <= -1: infeasible (ref totsu/tests/lp.rs:44 pattern)
    c = np.array([1.0])
    a = np.array([[1.0], [-1.0]])
    b = np.array([-1.0, -1.0])
    lay = tt.ConeLayout([tt.rpos(2)])
    _, _, st_n, it_n = solve_native(
        c, a, b, lay, tt.SolverParam(max_iter=50_000, eps_acc=1e-6))
    res = tt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay,
                       tt.SolverParam(max_iter=50_000, eps_acc=1e-6))
    assert st_n == int(res.status) == SolverStatus.INFEASIBLE
    assert int(res.iters) == it_n


@pytest.mark.parametrize("accel", ["", "halpern"])
def test_xla_loop_warm_start_converges_immediately(accel):
    c, a, b, lay = INSTANCES["exp"]()
    p = tt.SolverParam(max_iter=200_000, eps_acc=1e-4, check_period=20,
                       accel=accel)
    args = (jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay, p)
    r1 = tt.solve_jit(*args)
    assert int(r1.status) == SolverStatus.CONVERGED
    r2 = tt.solve_jit(*args, warm_start=(r1.x, r1.y))
    assert int(r2.status) == SolverStatus.CONVERGED
    assert int(r2.iters) == 0


def test_xla_loop_checkpoint_resume_is_exact():
    """return_state/resume_state: the split solve walks the same path as
    the uninterrupted one, epoch state included."""
    c, a, b, lay = _box_lp(seed=7)
    kw = dict(eps_acc=1e-4, check_period=20, accel="halpern")
    args = (jnp.asarray(c), jnp.asarray(a), jnp.asarray(b), lay)
    full = tt.solve_jit(*args, tt.SolverParam(max_iter=200_000, **kw))
    part1 = tt.solve_jit(*args, tt.SolverParam(max_iter=100,
                                               return_state=True, **kw))
    assert int(part1.status) == SolverStatus.EXCESS_ITER
    part2 = tt.solve_jit(*args, tt.SolverParam(max_iter=200_000, **kw),
                         resume_state=part1.state)
    assert int(part2.status) == SolverStatus.CONVERGED
    assert int(part1.iters) + int(part2.iters) == int(full.iters)
    np.testing.assert_allclose(np.asarray(part2.x), np.asarray(full.x),
                               atol=1e-9)
