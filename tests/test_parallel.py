"""Sharding & batching tests on a virtual 8-device CPU mesh.

The reference has no distributed surface (SURVEY.md section 4: "it isn't
tested — no such surface exists"); these tests are the invented contract:
sharded and unsharded solves must agree bit-for-bit-ish, and batch
sharding must keep instances independent.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import totsu_tpu as tt
from totsu_tpu.parallel import (
    batch_solver, make_mesh, solve_batch, shard_batch, shard_dense_problem,
)


def cpu_devices(n):
    devs = jax.devices("cpu")
    if len(devs) < n:
        pytest.skip(f"need {n} cpu devices, have {len(devs)}")
    return devs


def random_lp(rng, n=24, m=48, batch=()):
    # well-conditioned box LP (fast first-order convergence, exact known
    # solution x* = -sign(c)): min c.x s.t. -1 <= x <= 1 written as
    # G x <= h with a few extra random inactive rows
    c = rng.normal(size=batch + (n,)) + np.where(
        rng.random(batch + (n,)) > 0.5, 0.5, -0.5)
    eye = np.broadcast_to(np.eye(n), batch + (n, n))
    gr = rng.normal(size=batch + (m - 2 * n, n))
    hr = np.abs(gr).sum(-1) + 1.0  # satisfied everywhere in the box
    g = np.concatenate([eye, -eye, gr], axis=-2)
    h = np.concatenate([np.ones(batch + (n,)), np.ones(batch + (n,)), hr],
                       axis=-1)
    return c, g, h


def test_sharded_solve_matches_unsharded():
    rng = np.random.default_rng(0)
    c, g, h = random_lp(rng, n=16, m=48)
    layout = tt.ConeLayout([tt.rpos(g.shape[0])])
    param = tt.SolverParam(max_iter=50_000, eps_acc=1e-6)

    res_ref = tt.solve_jit(jnp.asarray(c), jnp.asarray(g), jnp.asarray(h),
                           layout, param)
    assert int(res_ref.status) == tt.SolverStatus.CONVERGED

    mesh = make_mesh(batch=1, row=8, devices=cpu_devices(8))
    prob = shard_dense_problem(
        tt.ConicProblem(jnp.asarray(c), tt.DenseOp(jnp.asarray(g)),
                        jnp.asarray(h), layout), mesh)
    res_sh = prob.solve_jit(param)
    assert int(res_sh.status) == tt.SolverStatus.CONVERGED
    # identical math, identical iterate path (up to reduction reassociation)
    assert int(res_sh.iters) == int(res_ref.iters)
    np.testing.assert_allclose(np.asarray(res_sh.x), np.asarray(res_ref.x),
                               atol=1e-8)


def test_sharded_solve_collective_counts():
    # VERDICT r1 #3 done-criteria: grep the compiled HLO of a row-sharded
    # solve. The design contract is "one all-reduce per A^T application,
    # nothing on A applications, no gathers"; XLA actually does better and
    # fuses the whole update's communication (both A^T matvecs + the two
    # scalar dots) into ONE tuple all-reduce per iteration. Expected
    # module-wide: 3 all-reduce ops (update loop / periodic check /
    # preconditioner+norm setup) and zero other collectives.
    import re
    rng = np.random.default_rng(0)
    c, g, h = random_lp(rng, n=16, m=48)
    layout = tt.ConeLayout([tt.rpos(g.shape[0])])
    mesh = make_mesh(batch=1, row=8, devices=cpu_devices(8))
    prob = shard_dense_problem(
        tt.ConicProblem(jnp.asarray(c), tt.DenseOp(jnp.asarray(g)),
                        jnp.asarray(h), layout), mesh)
    param = tt.SolverParam(max_iter=1000, eps_acc=1e-6, check_period=10)
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(
        c_, a_, b_, layout, param, row_sharding=prob.row_sharding))
    txt = fn.lower(prob.c, prob.a, prob.b).compile().as_text()
    n_allreduce = len(re.findall(r"all-reduce\w*\(", txt))
    assert n_allreduce <= 3, f"expected <= 3 all-reduces, got {n_allreduce}"
    for op in ("all-gather", "all-to-all", "collective-permute",
               "reduce-scatter"):
        assert len(re.findall(rf"{op}\w*\(", txt)) == 0, op


def test_batch_sharded_solve():
    rng = np.random.default_rng(1)
    batch = 8
    c, g, h = random_lp(rng, n=8, m=24, batch=(batch,))
    layout = tt.ConeLayout([tt.rpos(g.shape[-2])])
    param = tt.SolverParam(max_iter=50_000, eps_acc=1e-6)

    mesh = make_mesh(batch=8, row=1, devices=cpu_devices(8))
    res = solve_batch(c, jnp.asarray(g), h, layout, param, mesh=mesh)
    assert np.all(np.asarray(res.status) == tt.SolverStatus.CONVERGED)

    # every instance must match its solo solve
    for i in range(0, batch, 3):
        solo = tt.solve_jit(jnp.asarray(c[i]), jnp.asarray(g[i]),
                            jnp.asarray(h[i]), layout, param)
        np.testing.assert_allclose(np.asarray(res.x[i]),
                                   np.asarray(solo.x), atol=1e-6)


def test_batch_sharded_zero_collectives():
    # lockstep batch sharding must move NO iterate data between devices:
    # each device iterates its instances independently, so scaling
    # efficiency on real chips is 100% by construction (the proxy in
    # benchmarks/benchmark_sharding.py only quantifies dispatch overhead).
    # The single allowed all-reduce is the vmapped while_loop's joint
    # termination predicate — an OR over per-instance RUNNING flags, a few
    # bytes per check_period iterations.
    import re
    rng = np.random.default_rng(3)
    c, g, h = random_lp(rng, n=8, m=24, batch=(8,))
    layout = tt.ConeLayout([tt.rpos(g.shape[-2])])
    param = tt.SolverParam(max_iter=1000, eps_acc=1e-6, check_period=10)
    mesh = make_mesh(batch=8, row=1, devices=cpu_devices(8))
    from jax.sharding import NamedSharding, PartitionSpec as P
    cj = jax.device_put(jnp.asarray(c), NamedSharding(mesh, P("batch", None)))
    gj = jax.device_put(jnp.asarray(g),
                        NamedSharding(mesh, P("batch", None, None)))
    hj = jax.device_put(jnp.asarray(h), NamedSharding(mesh, P("batch", None)))
    fn = jax.jit(jax.vmap(
        lambda ci, ai, bi: tt.solve_jit(ci, ai, bi, layout, param)))
    txt = fn.lower(cj, gj, hj).compile().as_text()
    assert len(re.findall(r"all-reduce\w*\(", txt)) <= 1
    for op in ("all-gather", "all-to-all", "collective-permute",
               "reduce-scatter"):
        assert len(re.findall(rf"{op}\w*\(", txt)) == 0, op


def test_2d_mesh_batch_and_row():
    rng = np.random.default_rng(2)
    batch = 4
    c, g, h = random_lp(rng, n=8, m=24, batch=(batch,))
    layout = tt.ConeLayout([tt.rpos(g.shape[-2])])
    param = tt.SolverParam(max_iter=50_000, eps_acc=1e-6)

    mesh = make_mesh(batch=4, row=2, devices=cpu_devices(8))
    from jax.sharding import NamedSharding, PartitionSpec as P
    cj = jax.device_put(jnp.asarray(c), NamedSharding(mesh, P("batch", None)))
    gj = jax.device_put(jnp.asarray(g),
                        NamedSharding(mesh, P("batch", "row", None)))
    hj = jax.device_put(jnp.asarray(h), NamedSharding(mesh, P("batch", "row")))
    res = solve_batch(cj, gj, hj, layout, param)
    assert np.all(np.asarray(res.status) == tt.SolverStatus.CONVERGED)
    solo = tt.solve_jit(jnp.asarray(c[0]), jnp.asarray(g[0]),
                        jnp.asarray(h[0]), layout, param)
    np.testing.assert_allclose(np.asarray(res.x[0]), np.asarray(solo.x),
                               atol=1e-6)


def test_solve_batch_reuses_one_program():
    """Repeated solve_batch calls on one layout / params dispatch the one
    cached jit object, traced and compiled once (a fresh jit per call
    re-traced and recompiled the whole solve every time)."""
    rng = np.random.default_rng(7)
    c, g, h = random_lp(rng, n=8, m=24, batch=(3,))
    layout = tt.ConeLayout([tt.rpos(g.shape[-2])])
    param = tt.SolverParam(max_iter=2_000, eps_acc=1e-4)
    args = (jnp.asarray(c), jnp.asarray(g), jnp.asarray(h))
    fn = batch_solver(layout, param)
    first = solve_batch(*args, layout, param)
    second = solve_batch(*args, layout, param)
    assert batch_solver(layout, param) is fn
    assert fn._cache_size() == 1
    np.testing.assert_array_equal(np.asarray(first.x), np.asarray(second.x))
    # the lowered program is the one solve_batch ran
    again = fn.lower(*args).compile()(*args)
    np.testing.assert_array_equal(np.asarray(again.x), np.asarray(first.x))


def test_shard_batch_placement():
    mesh = make_mesh(batch=8, row=1, devices=cpu_devices(8))
    x = jnp.zeros((16, 5))
    (xs,) = shard_batch((x,), mesh)
    assert len(xs.sharding.device_set) == 8


def _blocked_ell_grid_lp(n=128, bm=16):
    """Bounded banded+box LP whose (m, n) exactly fill the tile grid and
    whose tile-grid axes divide the 8-way mesh."""
    rng = np.random.default_rng(21)
    band = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - 5), min(n, i + 5)
        band[i, lo:hi] = rng.normal(size=hi - lo)
    a = np.concatenate([band, np.eye(n), -np.eye(n)])   # m = 3n
    h = np.concatenate([band @ rng.normal(size=n) + rng.random(n) + 0.1,
                        np.full(2 * n, 5.0)])
    c = rng.normal(size=n)
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    ell = tt.BlockedEllOp.from_dense(a, block=(bm, bm))
    return c, ell, h, lay


def test_sharded_blocked_ell_matches_unsharded():
    """VERDICT r2 #3: the large-problem features must compose — a
    row-sharded blocked-ELL solve reproduces the unsharded iterate path."""
    from totsu_tpu.parallel import shard_blocked_ell_problem
    c, ell, h, lay = _blocked_ell_grid_lp()
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-5, check_period=10,
                           accel="halpern", normalize=True)
    r_ref = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay, param)
    assert int(r_ref.status) == tt.SolverStatus.CONVERGED
    mesh = make_mesh(batch=1, row=8, devices=cpu_devices(8))
    prob = shard_blocked_ell_problem(
        tt.ConicProblem(jnp.asarray(c), ell, jnp.asarray(h), lay), mesh)
    r_sh = prob.solve_jit(param)
    assert int(r_sh.status) == tt.SolverStatus.CONVERGED
    assert int(r_sh.iters) == int(r_ref.iters)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_ref.x),
                               atol=1e-10)


def test_sharded_blocked_ell_collective_contract():
    """HLO contract for the sharded blocked-ELL solve: tile data NEVER
    moves between devices (no >=3-D all-gathers), only (m,)/(n,)-vector
    gathers and the scalar-reduction all-reduces; no other collectives.
    This is what makes the scheme HBM-bandwidth-scaling: each device
    streams 1/ndev of the tile bytes per iteration."""
    import re
    from totsu_tpu.parallel import shard_blocked_ell_problem
    c, ell, h, lay = _blocked_ell_grid_lp()
    mesh = make_mesh(batch=1, row=8, devices=cpu_devices(8))
    prob = shard_blocked_ell_problem(
        tt.ConicProblem(jnp.asarray(c), ell, jnp.asarray(h), lay), mesh)
    param = tt.SolverParam(max_iter=1000, eps_acc=1e-5, check_period=10,
                           accel="halpern", normalize=True)
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(
        c_, a_, b_, lay, param, row_sharding=prob.row_sharding))
    txt = fn.lower(prob.c, prob.a, prob.b).compile().as_text()
    # every all-gather result must be vector-sized (<= m elements): tile
    # arrays (4-D, nbr*K*bm*bn elements) must never be gathered
    m = prob.b.shape[0]
    for shp in re.findall(r"=\s*\w+\[([\d,]*)\]\S*\s+all-gather", txt):
        elems = int(np.prod([int(s) for s in shp.split(",") if s]))
        assert elems <= m, f"all-gather of {elems} elements (> m = {m})"
    assert len(re.findall(r" all-reduce\w*\(", txt)) <= 5
    for op in ("all-to-all", "collective-permute", "reduce-scatter"):
        assert len(re.findall(rf" {op}\w*\(", txt)) == 0, op


def test_solve_batch_chunked_matches_unchunked():
    """solve_batch(chunk_iters=N): the chunked lockstep batch reproduces
    the unchunked batch exactly — per-instance statuses, iteration
    counts, and solutions (instances that finish early stay terminated
    across later chunks via their checkpointed terminal status)."""
    import numpy as np
    from totsu_tpu.parallel.batch import solve_batch
    rng = np.random.default_rng(2)
    bsz, n = 4, 24
    cs, gs, hs = [], [], []
    for i in range(bsz):
        g = rng.normal(size=(2 * n, n))
        h = g @ rng.normal(size=n) + rng.random(2 * n) + 0.1
        g = np.concatenate([g, np.eye(n), -np.eye(n)])
        h = np.concatenate([h, np.full(2 * n, 10.0)])
        cs.append(rng.normal(size=n))
        gs.append(g)
        hs.append(h)
    c = jnp.asarray(np.stack(cs))
    g = jnp.asarray(np.stack(gs))
    h = jnp.asarray(np.stack(hs))
    lay = tt.ConeLayout([tt.rpos(4 * n)])
    p = tt.SolverParam(max_iter=100_000, eps_acc=1e-6, check_period=20,
                       accel="halpern")
    full = solve_batch(c, g, h, lay, p)
    chunked = solve_batch(c, g, h, lay, p, chunk_iters=200)
    st_f, st_c = np.asarray(full.status), np.asarray(chunked.status)
    it_f, it_c = np.asarray(full.iters), np.asarray(chunked.iters)
    assert (st_f == 1).all() and (st_c == 1).all()
    assert it_f.max() > 200          # the test actually chunks
    np.testing.assert_array_equal(it_f, it_c)
    # solutions: with the r5 terminal-lane fix (finished instances keep
    # their checkpointed taken pair bit-for-bit instead of being
    # reseeded from the raw accel carry) this measures 0.0 on CPU; the
    # loose tolerance remains only for platforms where the chunked
    # programs' batched-GEMM association differs (the r4-measured ~4e-7
    # class; the EXACT iteration counts above are the path-identity
    # witness)
    np.testing.assert_allclose(np.asarray(chunked.x), np.asarray(full.x),
                               atol=1e-5)
    # max_iter caps the chunked batch exactly
    p_cap = tt.SolverParam(max_iter=100, eps_acc=1e-12, check_period=20)
    capped = solve_batch(c, g, h, lay, p_cap, chunk_iters=40)
    assert (np.asarray(capped.iters) == 100).all()
    assert (np.asarray(capped.status) == int(tt.SolverStatus.EXCESS_ITER)
            ).all()
