"""A/B benchmark harness: random dense LP through the JAX path and the
native C++ engine on the identical problem.

Mirrors ref experimental/benchmark_lp/src/main.rs:13-92 (random LP,
n = sz from argv (default 100), m = 2n + box rows, eps_acc = 1e-3) — the
reference runs FloatGeneric<f32> then F32CUDA on the same instance; here
the pair is native-C++ f64 vs JAX (f32 on the GPU, f64 on the CPU).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def run(sz=100):
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    from totsu_tpu.native import solve_native
    from bench import make_lp
    from totsu_tpu.utils import enable_compile_cache
    enable_compile_cache()

    c, g, h = make_lp(sz)
    layout = tt.ConeLayout([tt.rpos(g.shape[0])])
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, check_period=20)

    t0 = time.perf_counter()
    xn, _, status_n, iters_n = solve_native(c, g, h, layout, param)
    t_native = time.perf_counter() - t0

    fn = jax.jit(lambda a_, b_, c_: tt.solve_jit(c_, a_, b_, layout, param))
    cj, gj, hj = map(jnp.asarray, (c, g, h))
    fn(gj, hj, cj).x.block_until_ready()  # compile
    t0 = time.perf_counter()
    r = jax.block_until_ready(fn(gj, hj, cj * (1 + 1e-7)))
    t_jax = time.perf_counter() - t0

    obj_n = float(c @ xn)
    obj_j = float(c @ np.asarray(r.x))
    dev = jax.devices()[0].platform
    print(f"[benchmark_lp sz={sz}] native: {status_n.name} {iters_n} iters "
          f"{t_native:.3f}s obj={obj_n:.5f} | jax/{dev}: "
          f"status={int(r.status)} {int(r.iters)} iters {t_jax:.3f}s "
          f"obj={obj_j:.5f} | speedup {t_native / t_jax:.1f}x")
    assert abs(obj_n - obj_j) <= 1e-2 * max(1.0, abs(obj_n)), \
        "objective parity violated"
    return t_native, t_jax


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 100)
