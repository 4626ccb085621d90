"""Acceleration-scheme overhead A/B (VERDICT r2 weak #6).

Per check_period steps the three loop drivers do different amounts of
extra work on top of the shared PDHG update (2 A-applies + 2 A^T-applies
per iteration):

* plain (``accel=''``)     — one criteria evaluation: +2 A-applies/check
* halpern                  — one criteria evaluation at T(z): +2/check
* restart (PDLP averaging) — criteria at BOTH the current iterate and
  the running average: +4/check, plus O(n+m) running-sum updates every
  iteration.

This harness measures what those differences actually cost on the
default device: fixed-iteration iters/s on the benchmark LP (n from argv,
default 1000, m = 4n incl. box rows) for each accel x check_period, with
perturbed inputs per timed call.

Run: python benchmarks/benchmark_accel.py [n]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(n=1000, iters=4000, trials=3):
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    from totsu_tpu.utils import enable_compile_cache
    from bench import make_lp
    enable_compile_cache()

    c, g, h = make_lp(n)
    layout = tt.ConeLayout([tt.rpos(g.shape[0])])
    cj, gj, hj = map(jnp.asarray, (c, g, h))
    dev = jax.devices()[0]
    print(f"# device: {dev}; LP n={n} m={g.shape[0]}; fixed {iters} iters")
    print(f"{'accel':>8} {'period':>6} {'iters/s':>10} {'vs plain':>9}")

    base = {}
    for period in (20, 100):
        for accel in ("", "halpern", "restart"):
            param = tt.SolverParam(max_iter=iters, eps_acc=1e-12,
                                   check_period=period, accel=accel)
            fn = jax.jit(lambda a_, b_, c_: tt.solve_jit(
                c_, a_, b_, layout, param))
            jax.block_until_ready(fn(gj, hj, cj))          # compile
            best = np.inf
            for t in range(trials):
                ct = cj * (1.0 + 1e-6 * (t + 1))
                t0 = time.perf_counter()
                jax.block_until_ready(fn(gj, hj, ct))
                best = min(best, time.perf_counter() - t0)
            ips = iters / best
            if accel == "":
                base[period] = ips
            rel = ips / base[period]
            print(f"{accel or 'plain':>8} {period:>6} {ips:>10.0f} "
                  f"{rel:>8.2f}x", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1000)
