"""Run the conic solver end to end on a GPU and check every result.

    python chip_smoke.py            # phases a-g on one card
    python chip_smoke.py --multi    # phase h only, on four cards

Each phase drives a public entry point (``tt.solve``, ``Prob*.solve``,
``parallel.solve_batch``, ``runtime.BatchRunner``) at the size users run
and compares the result with a plain reference: the golden iterate trace,
HiGHS, host f64 residuals, the same solve on the CPU in f64, scipy.sparse,
or the same solve on one card. Per phase it prints the compile time, solve
time, iterations, status, each reference error beside its tolerance, the
precision and ``memory_analysis()`` of the compiled solve. The last line of
standard output is one JSON object naming the device; it is printed only if
every check passed. The script exits non-zero at once when JAX's first
device is not a GPU. It runs as one process and starts no other JAX
process.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


class Checks:
    """Reference comparisons; a failed one fails the run at the end."""

    def __init__(self):
        self.failed = []

    def __call__(self, phase, name, err, tol):
        err = float(err)
        ok = bool(np.isfinite(err) and err <= tol)
        log(phase, f"check {name}: err={err:.3e} tol={tol:.1e} "
                   f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failed.append(f"{phase}:{name}")


def mem_line(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis=None"
    mb = 1 << 20
    return (f"memory_analysis: args={ma.argument_size_in_bytes / mb:.1f}MB "
            f"out={ma.output_size_in_bytes / mb:.1f}MB "
            f"temp={ma.temp_size_in_bytes / mb:.1f}MB "
            f"alias={ma.alias_size_in_bytes / mb:.1f}MB "
            f"code={ma.generated_code_size_in_bytes / mb:.1f}MB")


def default_dots(hlo_text):
    """dot_generals lowered at DEFAULT precision (TF32 on the GPU)."""
    return sum(1 for ln in hlo_text.splitlines()
               if "dot_general" in ln and "DEFAULT" in ln)


def host_solve(phase, tt, solve_fn, c, a, b, cone, param):
    """Run ``solve_fn()`` (a host entry point that raises on
    non-convergence) twice and report it. The compile time and memory
    figures come from AOT-compiling the very jit object ``tt.solve`` uses,
    whose executable the first call then reuses."""
    import jax
    import jax.numpy as jnp
    from totsu_tpu.solver import conic
    from totsu_tpu.solver.operator import as_linop
    a_op = as_linop(a)
    p_eff = conic._maybe_auto_equil(param, a_op, None)
    fn = conic._jitted_solver(cone, p_eff, False, None)
    args = (jnp.asarray(c), a_op, jnp.asarray(b))
    t0 = time.perf_counter()
    lowered = fn.lower(*args)
    compiled = lowered.compile()
    t_compile = time.perf_counter() - t0
    n_default = default_dots(lowered.as_text())
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve_fn())
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(solve_fn())
    t_solve = time.perf_counter() - t0
    log(phase, f"compile_s={t_compile:.3f} first_call_s={t_first:.4f} "
               f"solve_s={t_solve:.4f} iters={int(res.iters)} "
               f"status={tt.SolverStatus(int(res.status)).name} "
               f"cri=({float(res.cri_pri):.2e},{float(res.cri_dual):.2e},"
               f"{float(res.cri_gap):.2e})")
    log(phase, f"precision: data={res.x.dtype} matmul=HIGHEST "
               f"default_precision_dots={n_default}; {mem_line(compiled)}")
    return res, n_default


def lp_residuals(c, a_mv, a_rmv, b, x, y, zero_rows=0):
    """Host f64 relative residuals of min c'x s.t. A x + s = b, s in
    {0}^zero_rows x R+: primal infeasibility, dual residual (incl. the
    dual-cone violation of y) and duality gap."""
    c, b, x, y = (np.asarray(v, np.float64) for v in (c, b, x, y))
    r = a_mv(x) - b
    viol = np.concatenate([r[:zero_rows], np.maximum(r[zero_rows:], 0.0)])
    pri = np.linalg.norm(viol) / (1.0 + np.linalg.norm(b))
    dual = (np.linalg.norm(c + a_rmv(y))
            + np.linalg.norm(np.minimum(y[zero_rows:], 0.0))) \
        / (1.0 + np.linalg.norm(c))
    cx, by = c @ x, b @ y
    gap = abs(cx + by) / (1.0 + abs(cx) + abs(by))
    return pri, dual, gap


def dense_lp_check(phase, chk, c, g, h, res):
    x = np.asarray(res.x, np.float64)
    y = np.asarray(res.y, np.float64)
    g64 = g.astype(np.float64)
    pri, dual, gap = lp_residuals(c, lambda v: g64 @ v, lambda v: v @ g64,
                                  h, x, y)
    chk(phase, "host_f64_primal_infeas", pri, 1e-2)
    chk(phase, "host_f64_dual_residual", dual, 1e-2)
    log(phase, f"host_f64_gap={gap:.3e}")
    return x


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_a_golden(tt, chk):
    """Reference nostd LP in f64 with the reference iteration: the golden
    QEMU trace converges after 160 updates at (1.99999943, 2.00000045)."""
    import jax.numpy as jnp
    c = jnp.array([-1.0, 0.0], jnp.float64)
    a = jnp.array([[4.0, -1.0], [-1.0, 4.0], [-1.0, -1.0]], jnp.float64)
    b = jnp.array([6.0, 6.0, 1.0], jnp.float64)
    lay = tt.ConeLayout([tt.rpos(3)])
    param = tt.SolverParam(max_iter=100_000, method="pdhg", relax=1.0)
    res, _ = host_solve("a", tt, lambda: tt.solve(c, a, b, lay, param),
                        c, a, b, lay, param)
    chk("a", "updates_vs_160", abs(int(res.iters) - 160), 1)
    golden = np.array([1.9999994251590176, 2.0000004472430635])
    chk("a", "x_vs_golden", np.max(np.abs(np.asarray(res.x) - golden)),
        1e-6)


def phase_dense_lp(phase, tt, chk, bench, n, with_highs):
    import jax.numpy as jnp
    c, g, h = bench.make_lp(n)
    log(phase, f"LP n={n} m={g.shape[0]} A={g.nbytes / 1e6:.0f}MB f32")
    lay = tt.ConeLayout([tt.rpos(g.shape[0])])
    param = tt.SolverParam(max_iter=400_000, eps_acc=1e-3, profile="fast")
    cj, gj, hj = jnp.asarray(c), jnp.asarray(g), jnp.asarray(h)
    res, _ = host_solve(phase, tt,
                        lambda: tt.solve(cj, gj, hj, lay, param),
                        cj, gj, hj, lay, param)
    chk(phase, "dtype_is_f32", 0.0 if res.x.dtype == np.float32 else 1.0, 0)
    x = dense_lp_check(phase, chk, c, g, h, res)
    if with_highs:
        from scipy.optimize import linprog
        t0 = time.perf_counter()
        ref = linprog(c.astype(np.float64), A_ub=g.astype(np.float64),
                      b_ub=h.astype(np.float64), bounds=(None, None),
                      method="highs")
        log(phase, f"highs status={ref.status} obj={ref.fun:.6f} "
                   f"({time.perf_counter() - t0:.1f}s)")
        obj = float(c.astype(np.float64) @ x)
        chk(phase, "objective_vs_highs",
            abs(obj - ref.fun) / max(1.0, abs(ref.fun)), 1e-2)


def phase_d_qp(tt, chk, bench):
    """The n = 1000 QP through ``tt.problems.qp``. eps_acc is 1e-4 here:
    the QP's stationarity P x + q + G'lam passes through the RSOC
    epigraph of the reformulation, and on this instance conic residuals
    of 1e-3 leave it near 3e-2 (5e-4 at 1e-4, on the CPU in f32)."""
    import jax
    p, q, g, h = bench.make_qp_dense(1000)
    n, m = q.shape[0], g.shape[0]
    prob = tt.problems.qp(p, q, g=g, h=h)
    param = tt.SolverParam(max_iter=400_000, eps_acc=1e-4, profile="fast")
    res, _ = host_solve("d", tt, lambda: prob.solve(param),
                        prob.c, prob.a, prob.b, prob.cone, param)
    chk("d", "dtype_is_f32", 0.0 if res.x.dtype == np.float32 else 1.0, 0)
    p64, q64, g64, h64 = (v.astype(np.float64) for v in (p, q, g, h))
    x = np.asarray(res.x, np.float64)[:n]
    lam = np.asarray(res.y, np.float64)[2 + n:2 + n + m]
    stat = np.linalg.norm(p64 @ x + q64 + g64.T @ lam) \
        / (1.0 + np.linalg.norm(q64))
    slack = h64 - g64 @ x
    pri = np.linalg.norm(np.maximum(-slack, 0.0)) / (1.0 + np.linalg.norm(h64))
    obj = 0.5 * x @ p64 @ x + q64 @ x
    comp = abs(lam @ slack) / (1.0 + abs(obj))
    chk("d", "kkt_stationarity", stat, 1e-2)
    chk("d", "kkt_primal_feas", pri, 1e-2)
    chk("d", "kkt_complementarity", comp, 1e-2)
    chk("d", "multiplier_sign", np.linalg.norm(np.minimum(lam, 0.0))
        / (1.0 + np.linalg.norm(lam)), 1e-2)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        prob64 = tt.problems.qp(p64, q64, g=g64, h=h64)
        r64 = prob64.solve(tt.SolverParam(max_iter=400_000, eps_acc=1e-6,
                                          profile="fast"))
        x64 = np.asarray(r64.x, np.float64)[:n]
    obj64 = 0.5 * x64 @ p64 @ x64 + q64 @ x64
    log("d", f"cpu f64 reference: iters={int(r64.iters)} obj={obj64:.8f} "
             f"({time.perf_counter() - t0:.1f}s); gpu obj={obj:.8f}")
    chk("d", "objective_vs_cpu_f64", abs(obj - obj64) / max(1.0, abs(obj64)),
        1e-2)


def _unpack_scaled(v, k):
    """Scaled-vec (upper-tri, column-major, off-diagonals * sqrt2) -> S."""
    s = np.zeros((k, k))
    kk = 0
    for j in range(k):
        for i in range(j + 1):
            val = v[kk] if i == j else v[kk] / np.sqrt(2.0)
            s[i, j] = s[j, i] = val
            kk += 1
    return s


def phase_e_sdp(tt, chk):
    import jax
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from partitioning_sdp import build, build_problem
    w = build(8, 6)
    k = w.shape[0]
    sn = k * (k + 1) // 2
    prob = build_problem(w, tt, np.float32)
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    from totsu_tpu.solver.cone import resolve_auto_methods
    methods = [f.variant for f in resolve_auto_methods(prob.cone,
                                                       param).factors]
    log("e", f"partitioning SDP k={k}: psd projection {methods[0]!r}")
    res, _ = host_solve("e", tt, lambda: prob.solve(param),
                        prob.c, prob.a, prob.b, prob.cone, param)
    chk("e", "projection_is_ns", 0.0 if methods[0] == "ns" else 1.0, 0)
    x = np.asarray(res.x, np.float64)
    a64 = np.asarray(prob.a.a, np.float64)
    c64 = np.asarray(prob.c, np.float64)
    s = _unpack_scaled((np.asarray(prob.b, np.float64) - a64 @ x)[:sn], k)
    lmin = float(np.linalg.eigvalsh(s)[0])
    snorm = float(np.linalg.norm(s))
    chk("e", "slack_min_eig_over_norm", max(0.0, -lmin) / snorm, 1e-2)
    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        # 1e-5: the exact-projection reference needs ~4x the iterations
        # at 1e-6, for an objective compared at 1e-2
        prob64 = build_problem(w, tt, np.float64)
        r64 = prob64.solve(tt.SolverParam(max_iter=400_000, eps_acc=1e-5,
                                          profile="fast"))
        x64 = np.asarray(r64.x, np.float64)
    obj, obj64 = float(c64 @ x), float(c64 @ x64)
    log("e", f"cpu f64 eigh reference: iters={int(r64.iters)} "
             f"obj={obj64:.6f} ({time.perf_counter() - t0:.1f}s); "
             f"gpu obj={obj:.6f}")
    chk("e", "objective_vs_cpu_f64", abs(obj - obj64) / max(1.0, abs(obj64)),
        1e-2)


def ell_problem(tt, bench, n=65_536):
    """The n = 65,536 blocked-ELL LP from tiles, and its scipy BSR copy."""
    import scipy.sparse as sp
    c, tiles, b, m = bench.make_ell_tiles_lp(n)
    keys = sorted(tiles)
    data = np.stack([tiles[kk] for kk in keys]).astype(np.float64)
    indices = np.array([kk[1] for kk in keys], np.int64)
    counts = np.bincount([kk[0] for kk in keys], minlength=m // 128)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    ref = sp.bsr_matrix((data, indices, indptr), shape=(m, n))
    op = tt.BlockedEllOp.from_tiles(tiles, m=m, n=n, block=(128, 128))
    return c, op, b, m, ref


def phase_f_ell(tt, chk, bench):
    import jax
    import jax.numpy as jnp
    c, op, b, m, ref = ell_problem(tt, bench)
    n = c.shape[0]
    log("f", f"blocked-ELL LP n={n} m={m} tiles="
             f"{(op.blocks.nbytes + op.blocks_t.nbytes) / 1e6:.0f}MB f32")
    rng = np.random.default_rng(3)
    u = rng.normal(size=n).astype(np.float32)
    v = rng.normal(size=m).astype(np.float32)
    mv = jax.jit(lambda o, x: o.matvec(x))(op, jnp.asarray(u))
    rmv = jax.jit(lambda o, y: o.rmatvec(y))(op, jnp.asarray(v))
    mv_ref = ref @ u.astype(np.float64)
    rmv_ref = ref.T @ v.astype(np.float64)
    chk("f", "matvec_vs_scipy", np.linalg.norm(np.asarray(mv) - mv_ref)
        / np.linalg.norm(mv_ref), 1e-5)
    chk("f", "rmatvec_vs_scipy", np.linalg.norm(np.asarray(rmv) - rmv_ref)
        / np.linalg.norm(rmv_ref), 1e-5)
    lay = tt.ConeLayout([tt.rpos(m)])
    param = tt.SolverParam(max_iter=20_000, eps_acc=1e-3, profile="fast")
    cj, bj = jnp.asarray(c), jnp.asarray(b)
    res, _ = host_solve("f", tt, lambda: tt.solve(cj, op, bj, lay, param),
                        cj, op, bj, lay, param)
    pri, dual, gap = lp_residuals(c, lambda x: ref @ x, lambda y: ref.T @ y,
                                  b, res.x, res.y)
    chk("f", "host_f64_primal_infeas", pri, 1e-2)
    chk("f", "host_f64_dual_residual", dual, 1e-2)
    log("f", f"host_f64_gap={gap:.3e}")


def batch_lps(bench, count=64, n=100):
    probs = [bench.make_lp(n, seed=100 + i) for i in range(count)]
    return tuple(np.stack([p[k] for p in probs]) for k in range(3))


def lane_agreement(xb, xs):
    """Worst lane of ||x_batch - x_single|| / (1 + ||x_single||)."""
    xb, xs = np.asarray(xb, np.float64), np.asarray(xs, np.float64)
    return float(np.max(np.linalg.norm(xb - xs, axis=1)
                        / (1.0 + np.linalg.norm(xs, axis=1))))


def phase_g_batch(tt, chk, bench):
    """64 LPs through solve_batch and BatchRunner.submit, each lane
    against its own single solve on the same card."""
    import jax
    import jax.numpy as jnp
    from totsu_tpu.parallel import batch_solver, solve_batch
    from totsu_tpu.runtime import BatchRunner
    cb, ab, bb = batch_lps(bench)
    lay = tt.ConeLayout([tt.rpos(ab.shape[1])])
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    cbj, abj, bbj = jnp.asarray(cb), jnp.asarray(ab), jnp.asarray(bb)
    # the jit object solve_batch dispatches, compiled ahead for its figures
    t0 = time.perf_counter()
    lowered = batch_solver(lay, param).lower(cbj, abj, bbj)
    compiled = lowered.compile()
    log("g", f"compile_s={time.perf_counter() - t0:.3f} precision: "
             f"data={cbj.dtype} matmul=HIGHEST default_precision_dots="
             f"{default_dots(lowered.as_text())}; {mem_line(compiled)}")
    t0 = time.perf_counter()
    rb = jax.block_until_ready(solve_batch(cbj, abj, bbj, lay, param))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    rb = jax.block_until_ready(solve_batch(cbj, abj, bbj, lay, param))
    log("g", f"solve_batch B=64 n=100: first_call_s={t_first:.3f} "
             f"solve_s={time.perf_counter() - t0:.4f} "
             f"iters_max={int(np.max(np.asarray(rb.iters)))}")
    runner = BatchRunner(param)
    t0 = time.perf_counter()
    futs = [runner.submit((cb[i], ab[i], bb[i], lay))
            for i in range(cb.shape[0])]
    rr = [f.result(timeout=600) for f in futs]
    log("g", f"BatchRunner.submit x64: {time.perf_counter() - t0:.3f}s "
             f"(compiles included), "
             f"{runner.compiled_signatures} executables")
    singles = [tt.solve(cbj[i], abj[i], bbj[i], lay, param)
               for i in range(cb.shape[0])]
    xs = np.stack([np.asarray(r.x) for r in singles])
    chk("g", "solve_batch_lanes_not_converged",
        int(np.sum(np.asarray(rb.status) != 1)), 0)
    chk("g", "batchrunner_not_converged",
        sum(int(r.status) != 1 for r in rr), 0)
    chk("g", "solve_batch_x_vs_single", lane_agreement(rb.x, xs), 1e-3)
    chk("g", "batchrunner_x_vs_single",
        lane_agreement(np.stack([np.asarray(r.x) for r in rr]), xs), 1e-3)


def collectives(hlo_text):
    return {op: hlo_text.count(f" {op}(") + hlo_text.count(f" {op}-start(")
            for op in ("all-reduce", "all-gather", "reduce-scatter")}


def phase_h_multi(tt, chk, bench):
    """Mesh paths on four cards, each compared with one card."""
    import jax
    import jax.numpy as jnp
    from totsu_tpu.parallel import (batch_solver, make_mesh, shard_batch,
                                    shard_blocked_ell_problem,
                                    shard_dense_problem, solve_batch)
    from totsu_tpu.problems.base import ConicProblem
    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--multi needs 4 GPUs, JAX sees {len(devs)}")

    # h1: batch-sharded lockstep solve
    cb, ab, bb = batch_lps(bench)
    lay = tt.ConeLayout([tt.rpos(ab.shape[1])])
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    args = (jnp.asarray(cb), jnp.asarray(ab), jnp.asarray(bb))
    r1 = jax.block_until_ready(solve_batch(*args, lay, param))
    mesh = make_mesh(batch=4)
    t0 = time.perf_counter()
    r4 = jax.block_until_ready(solve_batch(*args, lay, param, mesh=mesh))
    log("h1", f"solve_batch B=64 on batch=4 mesh: {time.perf_counter() - t0:.3f}s"
              f" (compile included); x sharding {r4.x.sharding}")
    # the program solve_batch(mesh=...) ran: its jit object on the inputs
    # as solve_batch shards them
    txt = batch_solver(lay, param).lower(
        *shard_batch(args, mesh)).compile().as_text()
    log("h1", f"collectives in compiled HLO: {collectives(txt)}")
    chk("h1", "lanes_not_converged", int(np.sum(np.asarray(r4.status) != 1)),
        0)
    chk("h1", "x_vs_one_card", lane_agreement(r4.x, r1.x), 1e-3)

    # fixed-iteration pdhg runs: both sides do exactly the same updates
    fixed = tt.SolverParam(max_iter=4000, eps_acc=1e-12, check_period=20,
                           accel="halpern", normalize=True)

    def compare(tag, prob, prob_s):
        fn1 = jax.jit(lambda c, a, b: tt.solve_jit(c, a, b, prob.cone,
                                                   fixed))
        fn4 = jax.jit(lambda c, a, b: tt.solve_jit(
            c, a, b, prob_s.cone, fixed, row_sharding=prob_s.row_sharding))
        t0 = time.perf_counter()
        comp4 = fn4.lower(prob_s.c, prob_s.a, prob_s.b).compile()
        t_c = time.perf_counter() - t0
        log(tag, f"compile_s={t_c:.2f} collectives in compiled HLO: "
                 f"{collectives(comp4.as_text())}; {mem_line(comp4)}")
        res1 = jax.block_until_ready(fn1(prob.c, prob.a, prob.b))
        jax.block_until_ready(comp4(prob_s.c, prob_s.a, prob_s.b))
        t0 = time.perf_counter()
        res4 = jax.block_until_ready(comp4(prob_s.c, prob_s.a, prob_s.b))
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        res1 = jax.block_until_ready(fn1(prob.c, prob.a, prob.b))
        t1 = time.perf_counter() - t0
        log(tag, f"{int(res4.iters)} updates: 4 cards {t4:.3f}s, one card "
                 f"{t1:.3f}s; cri 4 cards ({float(res4.cri_pri):.2e},"
                 f"{float(res4.cri_dual):.2e}) one card "
                 f"({float(res1.cri_pri):.2e},{float(res1.cri_dual):.2e})")
        x1 = np.asarray(res1.x, np.float64)
        x4 = np.asarray(res4.x, np.float64)
        chk(tag, "x_vs_one_card",
            np.linalg.norm(x4 - x1) / (1.0 + np.linalg.norm(x1)), 1e-3)
        chk(tag, "same_update_count", abs(int(res4.iters) - int(res1.iters)),
            0)
        return comp4.as_text()

    # h2: row-sharded dense pdhg, n = 4096
    c, g, h = bench.make_lp(4096)
    prob = ConicProblem(c=jnp.asarray(c), a=tt.DenseOp(jnp.asarray(g)),
                        b=jnp.asarray(h),
                        cone=tt.ConeLayout([tt.rpos(g.shape[0])]))
    txt = compare("h2", prob, shard_dense_problem(prob, make_mesh(row=4)))
    chk("h2", "all_reduce_present",
        0.0 if collectives(txt)["all-reduce"] > 0 else 1.0, 0)

    # h3: row-sharded blocked-ELL, the phase-f problem
    c, op, b, m, _ref = ell_problem(tt, bench)
    prob = ConicProblem(c=jnp.asarray(c), a=op, b=jnp.asarray(b),
                        cone=tt.ConeLayout([tt.rpos(m)]))
    compare("h3", prob, shard_blocked_ell_problem(prob, make_mesh(row=4)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's first device is {dev.platform!r}, not a "
              "GPU; nothing was run", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)   # phase a runs in f64
    sys.path.insert(0, ROOT)
    import bench
    import totsu_tpu as tt
    from totsu_tpu.utils import enable_compile_cache
    cache = enable_compile_cache()
    t_start = time.perf_counter()
    for line in bench.gpu_identity():   # name, power limit per card
        print(line, flush=True)
    log("setup", f"jax {jax.__version__}, {len(jax.devices())} x "
                 f"{dev.device_kind}, compile cache {cache}")
    chk = Checks()
    if args.multi:
        phases = [("h", lambda: phase_h_multi(tt, chk, bench))]
    else:
        phases = [
            ("a", lambda: phase_a_golden(tt, chk)),
            ("b", lambda: phase_dense_lp("b", tt, chk, bench, 1000, True)),
            ("c", lambda: phase_dense_lp("c", tt, chk, bench, 4096, False)),
            ("d", lambda: phase_d_qp(tt, chk, bench)),
            ("e", lambda: phase_e_sdp(tt, chk)),
            ("f", lambda: phase_f_ell(tt, chk, bench)),
            ("g", lambda: phase_g_batch(tt, chk, bench)),
        ]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        log(name, f"phase wall {time.perf_counter() - t0:.1f}s")
    log("total", f"{time.perf_counter() - t_start:.1f}s; "
                 f"failed checks: {chk.failed or 'none'}")
    if chk.failed:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
