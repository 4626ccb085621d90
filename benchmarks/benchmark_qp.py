"""A/B benchmark harness: random diagonal-P QP through the JAX path and
the native C++ engine.

Mirrors ref experimental/benchmark_qp/src/main.rs:13-88 (random QP with
diagonal P, n = m = sz from argv, eps_acc = 1e-3).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def make_qp(sz, seed=0):
    rng = np.random.default_rng(seed)
    p_diag = rng.random(sz) + 0.5
    p_mat = np.diag(p_diag)
    q = rng.normal(size=sz)
    g = rng.normal(size=(sz, sz))
    x0 = rng.normal(size=sz)
    h = g @ x0 + rng.random(sz) + 0.1
    return p_mat, q, g, h


def run(sz=100):
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    from totsu_tpu.native import solve_native
    from totsu_tpu.utils import enable_compile_cache
    enable_compile_cache()

    p_mat, q, g, h = make_qp(sz)
    prob = tt.problems.qp(p_mat.astype(np.float32), q.astype(np.float32),
                          g.astype(np.float32), h.astype(np.float32))
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, check_period=20)

    c_np = np.asarray(prob.c, dtype=np.float64)
    a_np = np.asarray(prob.a.a, dtype=np.float64)
    b_np = np.asarray(prob.b, dtype=np.float64)
    t0 = time.perf_counter()
    xn, _, status_n, iters_n = solve_native(c_np, a_np, b_np, prob.cone,
                                            param)
    t_native = time.perf_counter() - t0

    fn = jax.jit(lambda cc, aa, bb: tt.solve_jit(cc, aa, bb, prob.cone,
                                                 param))
    fn(prob.c, prob.a.a, prob.b).x.block_until_ready()
    t0 = time.perf_counter()
    r = jax.block_until_ready(fn(prob.c, prob.a.a * (1 + 1e-7), prob.b))
    t_jax = time.perf_counter() - t0

    def obj(x):
        return float(0.5 * x[:sz] @ p_mat @ x[:sz] + q @ x[:sz])

    dev = jax.devices()[0].platform
    obj_n, obj_j = obj(xn), obj(np.asarray(r.x, dtype=np.float64))
    print(f"[benchmark_qp sz={sz}] native: {status_n.name} {iters_n} iters "
          f"{t_native:.3f}s obj={obj_n:.5f} | jax/{dev}: "
          f"status={int(r.status)} {int(r.iters)} iters {t_jax:.3f}s "
          f"obj={obj_j:.5f} | speedup {t_native / t_jax:.1f}x")
    assert abs(obj_n - obj_j) <= 1e-2 * max(1.0, abs(obj_n)), \
        "objective parity violated"
    return t_native, t_jax


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
