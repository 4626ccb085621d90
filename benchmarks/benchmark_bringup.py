"""GPU bring-up measurements: what XLA makes of the paths that once had
hand-written kernels, and the dense direct engine's factorization.

* ``--loop``: the pdhg engine's XLA loop (pdhg + Halpern, f32,
  check_period 20) on the benchmark LP at n = 100 and 300 and on the dense
  QP's RSOC epigraph at n = 100 and 200 — the sizes a whole-solve kernel
  would serve. Reports iterations/s over a fixed 4,000-update run and, from
  a traced 400-update run, kernels per update and the device's idle share.
* ``--matvec``: ``DenseOp.dual_matvec`` (A u, A^T v) in f32 at
  16000 x 4000 and 65536 x 16384: time per pair inside one jitted loop,
  kernels per pair from a trace, and the share of the H100's 3.35 TB/s
  that one read of A per pair would reach.
* ``--factor``: the dense direct engine at the benchmark LP n = 1000 and
  4096 (profile='fast'): setup time (a 20-update solve) and time to
  eps_acc = 1e-3 with iterations.

Prints one JSON object per measurement; run on the GPU:
``python benchmarks/benchmark_bringup.py --loop --matvec --factor``.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

#: published H100 SXM memory bandwidth (NVIDIA data sheet)
H100_HBM_BYTES_PER_S = 3.35e12


def _emit(row):
    print(json.dumps(row), flush=True)


def _traced(fn, *args):
    """Run ``fn(*args)`` once under the profiler; return device stats."""
    import jax
    from trace_stats import device_stats
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            jax.block_until_ready(fn(*args))
        return device_stats(d)


def _first_gpu(stats):
    name = sorted(stats)[0]
    return stats[name]


def loop_rows():
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    import bench
    cases = []
    for n in (100, 300):
        c, g, h = bench.make_lp(n)
        cases.append((f"lp_n{n}", c, g, h, tt.ConeLayout([tt.rpos(g.shape[0])])))
    for n in (100, 200):
        p, q, g, h = bench.make_qp_dense(n)
        prob = tt.problems.qp(p, q, g=g, h=h)
        cases.append((f"qp_rsoc_n{n}", np.asarray(prob.c, np.float32),
                      np.asarray(prob.a.a, np.float32),
                      np.asarray(prob.b, np.float32), prob.cone))
    for name, c, a, b, lay in cases:
        def run(iters):
            p = tt.SolverParam(max_iter=iters, eps_acc=1e-12,
                               check_period=20, accel="halpern",
                               normalize=True)
            return jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, p))
        args = tuple(jnp.asarray(x, jnp.float32) for x in (c, a, b))
        f_long, f_short = run(4000), run(400)
        jax.block_until_ready(f_long(*args))
        jax.block_until_ready(f_short(*args))
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            r = jax.block_until_ready(f_long(*args))
            times.append(time.perf_counter() - t0)
        st = _first_gpu(_traced(f_short, *args))
        _emit({"row": "xla_pdhg_loop", "case": name,
               "m_n": list(a.shape), "updates": int(r.iters),
               "iters_per_s": int(r.iters) / min(times),
               "times_s": times,
               "kernels_per_update": st["kernels"] / 400,
               "idle_share": st["idle_share"],
               "top_kernels": st["top"][:5]})


def matvec_rows():
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    for m, n in ((16000, 4000), (65536, 16384)):
        key = jax.random.PRNGKey(0)
        a = jax.random.normal(key, (m, n), jnp.float32)
        op = tt.DenseOp(a)
        u = jnp.ones((n,), jnp.float32)
        v = jnp.ones((m,), jnp.float32)
        reps = 20

        @jax.jit
        def pairs(op, u, v):
            def body(_, uv):
                p, q = op.dual_matvec(uv[0], uv[1])
                # carried dependency, so no pair can be skipped or hoisted
                return (uv[0] + 1e-30 * q, uv[1] + 1e-30 * p)
            return jax.lax.fori_loop(0, reps, body, (u, v))

        jax.block_until_ready(pairs(op, u, v))
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            jax.block_until_ready(pairs(op, u, v))
            times.append((time.perf_counter() - t0) / reps)
        st = _first_gpu(_traced(pairs, op, u, v))
        t = min(times)
        a_bytes = m * n * 4
        _emit({"row": "dense_dual_matvec_f32", "m_n": [m, n],
               "pair_s": t, "pair_times_s": times,
               "kernels_per_pair": st["kernels"] / reps,
               "device_ns_per_pair": st["kernel_ns"] / reps,
               "one_read_share_of_3.35TBps":
                   a_bytes / t / H100_HBM_BYTES_PER_S,
               "top_kernels": st["top"][:4]})
        del a, op


def factor_rows():
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    import bench
    for n in (1000, 4096):
        c, g, h = bench.make_lp(n)
        lay = tt.ConeLayout([tt.rpos(g.shape[0])])
        args = tuple(jnp.asarray(x) for x in (c, g, h))

        def fn(max_iter):
            p = tt.SolverParam(max_iter=max_iter, eps_acc=1e-3,
                               profile="fast")
            return jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, p))
        f_setup, f_full = fn(20), fn(400_000)
        t0 = time.perf_counter()
        jax.block_until_ready(f_setup(*args))
        jax.block_until_ready(f_full(*args))
        t_compile = time.perf_counter() - t0
        ts, tf = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            jax.block_until_ready(f_setup(*args))
            ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            r = jax.block_until_ready(f_full(*args))
            tf.append(time.perf_counter() - t0)
        _emit({"row": "direct_dense_factor", "n": n,
               "m": g.shape[0], "compile_and_first_s": t_compile,
               "setup_20_updates_s": min(ts), "time_to_1e-3_s": min(tf),
               "iters": int(r.iters),
               "status": int(r.status), "times_s": [ts, tf]})


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"benchmark_bringup: JAX's first device is {dev.platform},"
                 " not a GPU")
    from totsu_tpu.utils import enable_compile_cache
    import bench
    enable_compile_cache()
    _emit({"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "gpu": bench.gpu_identity()})
    if "--loop" in sys.argv:
        loop_rows()
    if "--matvec" in sys.argv:
        matvec_rows()
    if "--factor" in sys.argv:
        factor_rows()


if __name__ == "__main__":
    main()
