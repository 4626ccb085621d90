"""Headline benchmark: prints ONE JSON line, measured on a GPU.

Problem set follows the reference's experimental/benchmark_lp AND
benchmark_qp (random dense LP / diag-P QP, f32, eps_acc = 1e-3;
benchmark_lp/src/main.rs:13-92, benchmark_qp/src/main.rs:13-88), scaled up.
The baselines run the *same* reference iteration on the host: vectorized-f32
numpy (the F64LAPACK-equivalent) and the native C++ -O3 engine (the
FloatGeneric-equivalent) — the Rust reference publishes no numbers.

Headline: TIME-TO-SOLUTION. metric = wall-clock seconds of the fast-profile
solve of the n=1000 benchmark LP to eps_acc=1e-3; vs_baseline = estimated
host-baseline wall-clock / ours.

Harness layout: the parent process never touches JAX. It runs each row GROUP
in its own child process with its own timeout, strictly one at a time (a JAX
process reserves most of the card's memory, so two at once would fail),
merging each child's incrementally-written row file. A failed group is
recorded in ``groups_failed`` without discarding the other groups' rows.
Every child checks that JAX's first device is a GPU and fails otherwise:
there is no CPU fallback. Run: ``python bench.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

#: (group, child timeout in seconds), in execution order
GROUPS = [
    ("lp1000", 600),
    ("batch", 360),
    ("sdp48", 300),
    ("small", 420),
    ("qp1000", 600),
    ("ell", 600),
]
#: child exit code meaning "JAX found no GPU"
NO_GPU_EXIT = 3


def make_lp(n, seed=0):
    """Reference benchmark_lp shape: m = 2n random inequality rows with a
    feasible interior, plus the box |x_i| <= 10 (m = 4n rows in all)."""
    rng = np.random.default_rng(seed)
    m = 2 * n
    g = rng.normal(size=(m, n))
    x0 = rng.normal(size=n)
    h = g @ x0 + rng.random(m) + 0.1
    eye = np.eye(n)
    g = np.concatenate([g, eye, -eye], axis=0).astype(np.float32)
    h = np.concatenate([h, np.full(n, 10.0), np.full(n, 10.0)]).astype(
        np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, g, h


def make_qp(n, seed=0):
    """Reference benchmark_qp shape (benchmark_qp/src/main.rs:13-55):
    diag-P QP (uniform(0,1) diagonal), uniform q, G = -uniform (m = n),
    h = -uniform, no equalities, f32, eps_acc = 1e-3."""
    rng = np.random.default_rng(seed)
    p_diag = rng.random(n).astype(np.float32) + 0.01
    q = rng.random(n).astype(np.float32)
    g = -rng.random((n, n)).astype(np.float32)
    h = -rng.random(n).astype(np.float32)
    return np.diag(p_diag), q, g, h


def make_qp_dense(n, seed=7):
    """Dense-P QP at scale: P = F^T F + 0.1 I (F normal / sqrt(n)), uniform
    q, standard-normal G (m = n) with a feasible interior. The reference's
    -uniform G turns rank-1-dominated at n = 1000 (sigma_1 ~ n/2), and no
    first-order engine converges on it, so this shape is used at scale."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(n, n)).astype(np.float32) / np.sqrt(n)
    p = f.T @ f + 0.1 * np.eye(n, dtype=np.float32)
    q = rng.random(n).astype(np.float32)
    g = rng.normal(size=(n, n)).astype(np.float32)
    x0 = rng.normal(size=n)
    h = (g @ x0 + rng.random(n) + 0.1).astype(np.float32)
    return p, q, g, h


def make_ell_tiles_lp(n, bm=128, seed=11):
    """Block-tridiagonal LP built from 128 x 128 tiles, never dense:
    A = [T; I; -I] (m = 3n), T block-tridiagonal with N(0, 1/(3 bm))
    tiles, b = [T x_f + slack; 10; 10] so x_f is strictly feasible and the
    box keeps the LP bounded. Returns (c, tiles, b, m) with ``tiles`` the
    ``BlockedEllOp.from_tiles`` mapping; at n = 65,536 the tiles hold
    ~170 MB where dense A would be 51 GB."""
    rng = np.random.default_rng(seed)
    nb = n // bm
    x_feas = rng.normal(size=n).astype(np.float32)
    ax = np.zeros(n, np.float32)
    tiles = {}
    for i in range(nb):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nb:
                t = (rng.normal(size=(bm, bm)) / np.sqrt(3 * bm)).astype(
                    np.float32)
                tiles[(i, j)] = t
                ax[i * bm:(i + 1) * bm] += t @ x_feas[j * bm:(j + 1) * bm]
    eye = np.eye(bm, dtype=np.float32)
    for i in range(nb):
        tiles[(nb + i, i)] = eye
        tiles[(2 * nb + i, i)] = -eye
    b = np.concatenate([ax + rng.random(n).astype(np.float32) + 0.1,
                        np.full(2 * n, 10.0, np.float32)])
    c = rng.normal(size=n).astype(np.float32)
    return c, tiles, b, 3 * n


def gpu_identity():
    """``name, power.limit`` of each visible card, as nvidia-smi prints
    them (raises if nvidia-smi is missing or fails)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def numpy_solver_iters_per_s(c, a, b, iters=200):
    """The reference iteration (solver.rs:526-571) in vectorized numpy:
    R+^m cone, criteria check every iteration, f32."""
    eps_zero = np.float32(1e-12)
    m, n = a.shape
    col_a = np.abs(a).sum(0)
    row_a = np.abs(a).sum(1)
    abs_c, abs_b = np.abs(c), np.abs(b)
    sum_cb = abs_c.sum() + abs_b.sum()
    dp_tau = 1.0 / np.maximum(np.concatenate(
        [col_a + abs_c, row_a + abs_b, np.ones(m, np.float32),
         [sum_cb]]), eps_zero)
    dp_sigma = 1.0 / np.maximum(np.concatenate(
        [col_a + abs_c, row_a + abs_b + 1.0, [sum_cb]]), eps_zero)
    norm_b, norm_c = np.linalg.norm(b), np.linalg.norm(c)

    u = np.zeros(n + 2 * m + 1, np.float32)
    u[-1] = 1.0
    v = np.zeros(n + m + 1, np.float32)

    def kt(vv):
        vn, vm, v1 = vv[:n], vv[n:n + m], vv[-1]
        return np.concatenate([
            -(vm @ a) - c * v1, a @ vn - b * v1, -vm,
            [c @ vn + b @ vm]])

    def k(uu):
        ux, uy, us, ut = uu[:n], uu[n:n + m], uu[n + m:n + 2 * m], uu[-1]
        return np.concatenate([
            uy @ a + c * ut, -(a @ ux) - us + b * ut,
            [-(c @ ux) - b @ uy]])

    t0 = time.perf_counter()
    done = 0
    for i in range(iters):
        u_old = u
        u = u - dp_tau * kt(v)
        u[n:n + 2 * m] = np.maximum(u[n:n + 2 * m], 0.0)
        u[-1] = max(u[-1], 0.0)
        ru = u_old - 2.0 * u
        v = v - dp_sigma * k(ru)
        v[-1] = min(v[-1], 0.0)
        # criteria (2 extra matvecs, as the reference does every iteration)
        ux, uy, us = u[:n], u[n:n + m], u[n + m:n + 2 * m]
        ax, aty = a @ ux, uy @ a
        tau = u[-1]
        inv = 1.0 / max(tau, 1e-12)
        crit_p = np.linalg.norm(ax * inv + us * inv - b) / (1 + norm_b)
        crit_d = np.linalg.norm(c + aty * inv) / (1 + norm_c)
        done = i + 1
    dt = time.perf_counter() - t0
    return done / dt, (float(crit_p), float(crit_d))


# --------------------------------------------------------------------------
# child-side: one row group per process
# --------------------------------------------------------------------------

class _Ctx:
    """Per-child context: jax handles, the device, and an
    incrementally-flushed row dict."""

    def __init__(self, rows_path):
        import jax
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            print(f"bench: JAX's first device is {dev.platform}, not a GPU",
                  file=sys.stderr)
            os._exit(NO_GPU_EXIT)
        import jax.numpy as jnp
        import totsu_tpu as tt
        from totsu_tpu.utils import enable_compile_cache
        enable_compile_cache()
        self.jax, self.jnp, self.tt = jax, jnp, tt
        self.dev = dev
        self.rows_path = rows_path
        self.rows = {}

    def put(self, key, value):
        """Record a row and flush the file — a later failure in this child
        then costs only the rows not yet landed."""
        self.rows[key] = value
        tmp = self.rows_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.rows, f)
        os.replace(tmp, self.rows_path)

    def timed_solve(self, cj, aj, bj, layout, param, perturb="c"):
        """Compile, then time ONE solve of slightly perturbed data."""
        jax, tt = self.jax, self.tt
        fn = jax.jit(lambda a_, b_, c_: tt.solve_jit(c_, a_, b_, layout,
                                                     param))
        jax.block_until_ready(fn(aj, bj, cj))
        if perturb == "c":
            cj2, bj2 = cj * (1.0 + 1e-6), bj
        else:
            cj2, bj2 = cj, bj * (1.0 + 1e-6)
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn(aj, bj2, cj2))
        return time.perf_counter() - t0, r


def grp_lp1000(ctx):
    """Headline: benchmark LP n=1000 time-to-solution + host baselines +
    the fixed-iteration continuity row."""
    jax, jnp, tt = ctx.jax, ctx.jnp, ctx.tt
    from totsu_tpu.native import solve_native
    n = 1000
    c, g, h = make_lp(n)
    layout = tt.ConeLayout([tt.rpos(g.shape[0])])
    cj, gj, hj = (jax.device_put(jnp.asarray(x), ctx.dev)
                  for x in (c, g, h))

    fast = tt.SolverParam(max_iter=400_000, eps_acc=1e-3, profile="fast")
    t_fast, r = ctx.timed_solve(cj, gj, hj, layout, fast)
    ctx.put("lp_n1000_fast_time_s", t_fast)
    ctx.put("lp_n1000_fast_iters", int(r.iters))
    ctx.put("lp_n1000_fast_converged", int(r.status) == 1)

    # reference-parity iteration count on the same contract (capped: a cap
    # makes the baseline estimate a LOWER bound, so vs_baseline is ">=")
    par = tt.SolverParam(max_iter=300_000, eps_acc=1e-3, check_period=20)
    t_par, rp = ctx.timed_solve(cj, gj, hj, layout, par)
    parity_iters = int(rp.iters)
    ctx.put("lp_n1000_parity_iters", parity_iters)
    ctx.put("lp_n1000_parity_capped", int(rp.status) != 1)
    ctx.put("lp_n1000_parity_time_s", t_par)

    # host baselines: the SAME reference iteration, measured rate.
    # numpy/BLAS ~ the reference's F64LAPACK backend; C++ -O3 single core
    # ~ its FloatGeneric. The reference publishes no numbers.
    base_np_ips, _ = numpy_solver_iters_per_s(c, g, h, iters=200)
    t0 = time.perf_counter()
    _, _, _, it_nat = solve_native(
        c, g, h, layout,
        tt.SolverParam(max_iter=200, eps_acc=1e-9, check_period=20))
    base_cpp_ips = it_nat / (time.perf_counter() - t0)
    best_base = max(base_np_ips, base_cpp_ips)
    ctx.put("numpy_baseline_iters_per_s", base_np_ips)
    ctx.put("native_cpp_baseline_iters_per_s", base_cpp_ips)
    base_est = parity_iters / best_base
    ctx.put("lp_n1000_baseline_est_s", base_est)
    ctx.put("lp_n1000_time_to_sol_speedup", base_est / t_fast)

    # fixed-iteration iters/s: the hot-path throughput number
    # (each trial perturbs c; median of trials 2-4)
    iters_fixed = 20_000
    pf = tt.SolverParam(max_iter=iters_fixed, eps_acc=1e-9,
                        check_period=20)
    fn = jax.jit(lambda a_, b_, c_: tt.solve_jit(c_, a_, b_, layout, pf))
    jax.block_until_ready(fn(gj, hj, cj))
    rates = []
    for trial in range(4):
        cj2 = cj * (1.0 + 1e-6 * (trial + 1))
        t0 = time.perf_counter()
        rr = jax.block_until_ready(fn(gj, hj, cj2))
        rates.append(int(rr.iters) / (time.perf_counter() - t0))
    ours_ips = float(np.median(rates[1:]))
    ctx.put("lp_n1000_fixed_iters_per_s", ours_ips)
    ctx.put("lp_n1000_iters_per_s_vs_best_host", ours_ips / best_base)


def grp_batch(ctx):
    """Batched lockstep throughput + the batched-CONVERGENCE guard (CPU
    tests cannot see GPU matmul rounding; this row re-proves per-instance
    convergence on the card)."""
    jax, jnp, tt = ctx.jax, ctx.jnp, ctx.tt
    bc = 8
    rngb = np.random.default_rng(1)
    c1, g1, h1 = make_lp(100)
    cbc = jnp.asarray(np.stack(
        [c1 * (1.0 + 0.1 * rngb.random(100)) for _ in range(bc)]),
        jnp.float32)
    layc = tt.ConeLayout([tt.rpos(g1.shape[0])])
    pc = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, check_period=20,
                        accel="halpern")
    g1j = jax.device_put(jnp.asarray(g1, jnp.float32), ctx.dev)
    h1j = jax.device_put(jnp.asarray(h1, jnp.float32), ctx.dev)
    # A/b as ARGUMENTS, not closure constants (a captured constant A is
    # baked into the executable)
    fnc = jax.jit(jax.vmap(
        lambda ci, aj, bj: tt.solve_jit(ci, aj, bj, layc, pc),
        in_axes=(0, None, None)))
    rc_ = jax.block_until_ready(fnc(cbc, g1j, h1j))
    stc = np.asarray(rc_.status)
    itc = np.asarray(rc_.iters)
    ctx.put("batch8_lp_n100_all_converged", bool((stc == 1).all()))
    ctx.put("batch8_lp_n100_iters_med_max",
            [int(np.median(itc)), int(itc.max())])

    bsz = 64
    probs = [make_lp(100, seed=100 + i) for i in range(bsz)]
    cb, gb, hb = (np.stack([p[k] for p in probs]) for k in range(3))
    layb = tt.ConeLayout([tt.rpos(gb.shape[1])])
    pb = tt.SolverParam(max_iter=8000, eps_acc=1e-9, check_period=20)
    fnb = jax.jit(jax.vmap(
        lambda ci, ai, bi: tt.solve_jit(ci, ai, bi, layb, pb)))
    cbj, gbj, hbj = (jax.device_put(jnp.asarray(x), ctx.dev)
                     for x in (cb, gb, hb))
    jax.block_until_ready(fnb(cbj, gbj, hbj))
    t0 = time.perf_counter()
    jax.block_until_ready(fnb(cbj * (1.0 + 1e-6), gbj, hbj))
    ctx.put("batch64_lp_n100_instance_iters_per_s",
            bsz * 8000 / (time.perf_counter() - t0))


def grp_sdp48(ctx):
    """Partitioning SDP k=48 (ref examples/partitioning_sdp shape),
    structured-operator build, PSD method via psd(method='auto')."""
    jax, tt = ctx.jax, ctx.tt
    bdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks")
    if bdir not in sys.path:
        sys.path.insert(0, bdir)
    from benchmark_sdp import build_partitioning
    sc, sa, sb, _w = build_partitioning(48)
    slay = tt.ConeLayout([tt.psd(48), tt.zero(48)])
    sp = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    fns = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, slay, sp))
    jax.block_until_ready(fns(sc, sa, sb))
    best = None
    for trial in range(2):
        t0 = time.perf_counter()
        rs = jax.block_until_ready(fns(sc * (1.0 + 1e-6 * (trial + 1)),
                                       sa, sb))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    ctx.put("sdp_k48_fast_time_s", best)
    ctx.put("sdp_k48_fast_iters", int(rs.iters))
    ctx.put("sdp_k48_fast_converged", int(rs.status) == 1)


def grp_small(ctx):
    """benchmark LP n=100 and QP n=100 — the reference's own default
    shapes (its A/B harness contract)."""
    jax, jnp, tt = ctx.jax, ctx.jnp, ctx.tt
    from totsu_tpu.native import solve_native
    c1, g1, h1 = make_lp(100, seed=1)
    lay1 = tt.ConeLayout([tt.rpos(g1.shape[0])])
    c1j, g1j, h1j = (jax.device_put(jnp.asarray(x), ctx.dev)
                     for x in (c1, g1, h1))
    t_par, r2 = ctx.timed_solve(
        c1j, g1j, h1j, lay1,
        tt.SolverParam(max_iter=200_000, eps_acc=1e-3, check_period=20))
    t_fast, rf = ctx.timed_solve(
        c1j, g1j, h1j, lay1,
        tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast"))
    base100_np, _ = numpy_solver_iters_per_s(c1, g1, h1, iters=400)
    t0 = time.perf_counter()
    _, _, _, it_nat1 = solve_native(
        c1, g1, h1, lay1,
        tt.SolverParam(max_iter=2000, eps_acc=1e-9, check_period=20))
    base100 = max(base100_np, it_nat1 / (time.perf_counter() - t0))
    ctx.put("lp_n100_parity_time_s", t_par)
    ctx.put("lp_n100_parity_iters", int(r2.iters))
    ctx.put("lp_n100_parity_converged", int(r2.status) == 1)
    ctx.put("lp_n100_fast_time_s", t_fast)
    ctx.put("lp_n100_fast_iters", int(rf.iters))
    ctx.put("lp_n100_fast_converged", int(rf.status) == 1)
    ctx.put("lp_n100_baseline_est_s", int(r2.iters) / base100)
    ctx.put("lp_n100_time_to_sol_speedup", int(r2.iters) / base100 / t_fast)

    pm, q, gq, hq = make_qp(100, seed=2)
    qp = tt.problems.qp(pm, q, g=gq, h=hq)
    qc = np.asarray(qp.c, dtype=np.float32)
    qa = np.asarray(qp.a.a, dtype=np.float32)
    qb = np.asarray(qp.b, dtype=np.float32)
    qcj, qaj, qbj = (jax.device_put(jnp.asarray(x), ctx.dev)
                     for x in (qc, qa, qb))
    t_qp_par, rqp = ctx.timed_solve(
        qcj, qaj, qbj, qp.cone,
        tt.SolverParam(max_iter=300_000, eps_acc=1e-3, check_period=20),
        perturb="b")
    t_qp_fast, rqf = ctx.timed_solve(
        qcj, qaj, qbj, qp.cone,
        tt.SolverParam(max_iter=300_000, eps_acc=1e-3, profile="fast"),
        perturb="b")
    t0 = time.perf_counter()
    _, _, _, it_natq = solve_native(
        qc, qa, qb, qp.cone,
        tt.SolverParam(max_iter=2000, eps_acc=1e-9, check_period=20))
    baseq_cpp = it_natq / (time.perf_counter() - t0)
    ctx.put("qp_n100_parity_time_s", t_qp_par)
    ctx.put("qp_n100_parity_iters", int(rqp.iters))
    ctx.put("qp_n100_parity_capped", int(rqp.status) != 1)
    ctx.put("qp_n100_fast_time_s", t_qp_fast)
    ctx.put("qp_n100_fast_iters", int(rqf.iters))
    ctx.put("qp_n100_fast_converged", int(rqf.status) == 1)
    ctx.put("qp_n100_native_baseline_iters_per_s", baseq_cpp)
    ctx.put("qp_n100_baseline_est_s", int(rqp.iters) / baseq_cpp)
    ctx.put("qp_n100_time_to_sol_speedup",
            int(rqp.iters) / baseq_cpp / t_qp_fast)


def grp_qp1000(ctx):
    """QP n=1000, dense P (make_qp_dense)."""
    jax, jnp, tt = ctx.jax, ctx.jnp, ctx.tt
    from totsu_tpu.native import solve_native
    pmat, qv, gq2, hq2 = make_qp_dense(1000)
    qp2 = tt.problems.qp(pmat, qv, g=gq2, h=hq2)
    q2c, q2a, q2b = (jax.device_put(jnp.asarray(np.asarray(x, np.float32)),
                                    ctx.dev)
                     for x in (qp2.c, qp2.a.a, qp2.b))
    t_par, rpar = ctx.timed_solve(
        q2c, q2a, q2b, qp2.cone,
        tt.SolverParam(max_iter=300_000, eps_acc=1e-3, check_period=20),
        perturb="b")
    parity_iters = int(rpar.iters)
    conv = int(rpar.status) == 1
    t_fast, rq2f = ctx.timed_solve(
        q2c, q2a, q2b, qp2.cone,
        tt.SolverParam(max_iter=300_000, eps_acc=1e-3, profile="fast"),
        perturb="b")
    t0 = time.perf_counter()
    _, _, _, it_natq2 = solve_native(
        np.asarray(q2c), np.asarray(q2a), np.asarray(q2b), qp2.cone,
        tt.SolverParam(max_iter=60, eps_acc=1e-9, check_period=20))
    baseq2_cpp = it_natq2 / (time.perf_counter() - t0)
    ctx.put("qp_n1000_parity_time_s", t_par)
    ctx.put("qp_n1000_parity_iters", parity_iters)
    ctx.put("qp_n1000_parity_capped", not conv)
    ctx.put("qp_n1000_fast_time_s", t_fast)
    ctx.put("qp_n1000_fast_iters", int(rq2f.iters))
    ctx.put("qp_n1000_fast_converged", int(rq2f.status) == 1)
    ctx.put("qp_n1000_native_baseline_iters_per_s", baseq2_cpp)
    # if the parity run hit the cap, native needs MORE than parity_iters
    # to converge, so the speedup is a LOWER bound
    ctx.put("qp_n1000_baseline_est_s", parity_iters / baseq2_cpp)
    ctx.put("qp_n1000_baseline_is_lower_bound", not conv)
    ctx.put("qp_n1000_time_to_sol_speedup",
            parity_iters / baseq2_cpp / t_fast)


def grp_ell(ctx):
    """Structured-sparse rows: blocked-ELL n=8192 throughput, the n=4096
    routed fast-profile solve, and the n=65,536 from-tiles LP (dense A
    would be 51 GB — the operator is built from its tiles only)."""
    jax, jnp, tt = ctx.jax, ctx.jnp, ctx.tt
    bdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks")
    if bdir not in sys.path:
        sys.path.insert(0, bdir)
    import benchmark_sparse as _bs
    ec, ea, eb = _bs.make_banded_lp(8192, k_tiles=2)
    ell_op = tt.BlockedEllOp.from_dense(ea, block=(128, 128))
    elay = tt.ConeLayout([tt.rpos(8192)])
    ep = tt.SolverParam(max_iter=2000, eps_acc=1e-12, check_period=100)
    fne = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, elay, ep))
    ecj, ebj = jnp.asarray(ec), jnp.asarray(eb)
    jax.block_until_ready(fne(ecj, ell_op, ebj))
    beste = np.inf
    for trial in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fne(ecj * (1.0 + 1e-6 * (trial + 1)), ell_op,
                                  ebj))
        beste = min(beste, time.perf_counter() - t0)
    ctx.put("ell_n8192_banded_iters_per_s", 2000 / beste)

    from benchmark_indirect import make_banded_box_lp
    fc, fa, fb = make_banded_box_lp(4096)
    fell = tt.BlockedEllOp.from_dense(fa, block=(128, 128))
    del fa
    flay = tt.ConeLayout([tt.rpos(3 * 4096)])
    epf = tt.SolverParam(max_iter=400_000, eps_acc=1e-3, profile="fast")
    fnf = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, flay, epf))
    fcj, fbj = jnp.asarray(fc), jnp.asarray(fb)
    jax.block_until_ready(fnf(fcj, fell, fbj))
    bestf = np.inf
    for trial in range(2):
        t0 = time.perf_counter()
        rff = jax.block_until_ready(
            fnf(fcj * (1.0 + 1e-6 * (trial + 1)), fell, fbj))
        bestf = min(bestf, time.perf_counter() - t0)
    ctx.put("ell_n4096_fast_time_s", bestf)
    ctx.put("ell_n4096_fast_iters", int(rff.iters))
    ctx.put("ell_n4096_fast_converged", int(rff.status) == 1)

    n_big = 65_536
    c_big, tiles, b_big, m_big = make_ell_tiles_lp(n_big)
    big = tt.BlockedEllOp.from_tiles(tiles, m=m_big, n=n_big,
                                     block=(128, 128))
    del tiles
    blay = tt.ConeLayout([tt.rpos(m_big)])
    bparam = tt.SolverParam(max_iter=8_000, eps_acc=1e-3, profile="fast")
    cbj, bbj = jnp.asarray(c_big), jnp.asarray(b_big)
    # the host entry point, routed to the indirect engine
    try:
        tt.solve(cbj, big, bbj, blay, bparam)   # compile + warm
        t0 = time.perf_counter()
        rb = tt.solve(cbj * (1.0 + 1e-6), big, bbj, blay, bparam)
        ctx.put("ell_n65536_tiles_time_s", time.perf_counter() - t0)
        ctx.put("ell_n65536_tiles_iters", int(rb.iters))
        ctx.put("ell_n65536_tiles_converged", True)
    except tt.SolverError as e:
        ctx.put("ell_n65536_tiles_converged", False)
        ctx.put("ell_n65536_tiles_status", e.status.name)


GROUP_FNS = {
    "lp1000": grp_lp1000,
    "batch": grp_batch,
    "sdp48": grp_sdp48,
    "small": grp_small,
    "qp1000": grp_qp1000,
    "ell": grp_ell,
}


def run_group(name, rows_path):
    import jax
    ctx = _Ctx(rows_path)
    GROUP_FNS[name](ctx)
    ctx.put("device", {"platform": ctx.dev.platform,
                       "kind": ctx.dev.device_kind,
                       "count": len(jax.devices())})


# --------------------------------------------------------------------------
# parent-side orchestration (never imports JAX)
# --------------------------------------------------------------------------

def _parent():
    """Run each group in its own child with its own timeout, one at a
    time; merge the incrementally-written row files; print one JSON
    line. Exits non-zero, printing no result, when the headline group
    fails or JAX finds no GPU."""
    import tempfile

    detail = {"gpu": gpu_identity()}
    failed = {}
    with tempfile.TemporaryDirectory(prefix="totsu_bench_") as tmpdir:
        for name, tmo in GROUPS:
            rows_path = os.path.join(tmpdir, f"{name}.json")
            try:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__),
                     "--group", name, "--rows-out", rows_path],
                    timeout=tmo)
                rc = proc.returncode
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc == NO_GPU_EXIT:
                sys.exit("bench: no GPU found; nothing was measured")
            try:
                with open(rows_path) as f:
                    detail.update(json.load(f))
            except (OSError, json.JSONDecodeError):
                pass
            if rc != 0:
                failed[name] = f"child exit {rc}"
    if failed:
        detail["groups_failed"] = failed
    if "lp_n1000_fast_time_s" not in detail:
        print(json.dumps(detail), file=sys.stderr)
        sys.exit("bench: the headline group produced no result")
    print(json.dumps({
        "metric": "benchmark_lp_n1000_fast_time_to_solution_s",
        "value": detail["lp_n1000_fast_time_s"],
        "unit": "s",
        "vs_baseline": detail.get("lp_n1000_time_to_sol_speedup", 0),
        "detail": detail,
    }))


if __name__ == "__main__":
    if "--group" in sys.argv:
        run_group(sys.argv[sys.argv.index("--group") + 1],
                  sys.argv[sys.argv.index("--rows-out") + 1])
    else:
        _parent()
