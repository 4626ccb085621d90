"""Exp/pow-cone cost on the default device (VERDICT r1 #7).

Three measurements (perturbed inputs per timed call):

* **projection microbench** — us/call of the batched exp- and pow-cone
  projections at block counts {64, 1024, 16384}. Each projection is a
  fixed-trip safeguarded Newton-bisection (exp: 40 expansion + 26 trips
  f32; pow: 28 trips f32 — cone.py), all elementwise work.
* **in-loop overhead** — fixed-iteration iters/s of the SAME-size random
  conic solve with (a) all-rpos rows, (b) one third of rows as exp
  blocks, (c) one third as pow blocks. The delta is what the cone
  actually costs inside the jitted PDHG loop.
* **growthport end-to-end** — the growth-optimal allocation example
  (examples/growthport_powexp.py: power-cone tree + exp-cone entropy
  budget) scaled to n=64 assets / 64 scenarios, solved in f32,
  objective checked against the host scipy SLSQP oracle.

Run: python benchmarks/benchmark_expcone.py
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
sys.path.insert(0, "examples")

import totsu_tpu as tt
from totsu_tpu.solver import cone as cones
from totsu_tpu.utils import enable_compile_cache

enable_compile_cache()


def _fetch(r):
    return jax.block_until_ready(r)


def time_proj(kind, count, reps=100, trials=3):
    rng = np.random.default_rng(count)
    x0 = jnp.asarray(rng.normal(scale=3.0, size=(count, 3)), jnp.float32)
    proj = (cones._proj_exp_blocks if kind == "exp"
            else lambda v: cones._proj_pow_blocks(v, 0.5))

    def chain(v):
        def body(i, vv):
            return proj(vv + 1e-5 * (i + 1.0))
        return jax.lax.fori_loop(0, reps, body, v)

    fn = jax.jit(chain)
    _fetch(fn(x0))
    best = np.inf
    for t in range(trials):
        vt = x0 * (1.0 + 1e-5 * (t + 1))
        t0 = time.perf_counter()
        _fetch(fn(vt))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def make_conic(n, m, kind, seed=0):
    """Random feasible-ish conic instance with the last third of the m
    rows as 3-d exp/pow blocks (or plain rpos)."""
    rng = np.random.default_rng(seed)
    blocks = m // 9  # one third of rows, 3 rows per block
    m_lin = m - 3 * blocks
    g = rng.normal(size=(m, n)).astype(np.float32) / np.sqrt(n)
    x0 = rng.normal(size=n)
    h = (g @ x0 + rng.random(m) + 0.5).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    if kind == "rpos":
        lay = tt.ConeLayout([tt.rpos(m)])
    elif kind == "exp":
        lay = tt.ConeLayout([tt.rpos(m_lin), tt.expc(count=blocks)])
    else:
        lay = tt.ConeLayout([tt.rpos(m_lin), tt.powc(0.5, count=blocks)])
    return jnp.asarray(c), jnp.asarray(g), jnp.asarray(h), lay


def time_inloop(kind, n=512, m=2304, iters=2000, trials=2):
    c, g, h, lay = make_conic(n, m, kind)
    param = tt.SolverParam(max_iter=iters, eps_acc=1e-12, check_period=100)
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, param))
    _fetch(fn(c, g, h))
    best = np.inf
    for t in range(trials):
        ct = c * (1.0 + 1e-6 * (t + 1))
        t0 = time.perf_counter()
        _fetch(fn(ct, g, h))
        best = min(best, time.perf_counter() - t0)
    return iters / best


def growthport_f32(n=64, s_num=64, h_budget=None, seed=0):
    from growthport_powexp import build_problem, scipy_oracle
    rng = np.random.default_rng(seed)
    returns = 1.0 + 0.3 * rng.standard_normal((s_num, n)) ** 2 \
        - 0.1 * rng.random((s_num, n))
    if h_budget is None:
        h_budget = -0.5 * np.log(n)  # between uniform (-log n) and point (0)
    c, a, b, layout, root = build_problem(returns, h_budget)
    cj = jnp.asarray(c, jnp.float32)
    aj = jnp.asarray(a, jnp.float32)
    bj = jnp.asarray(b, jnp.float32)
    param = tt.SolverParam(max_iter=400_000, eps_acc=1e-4, profile="fast")
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, layout, param))
    _fetch(fn(cj, aj, bj))
    t0 = time.perf_counter()
    res = fn(cj * (1.0 + 1e-6), aj, bj)
    _fetch(res)
    dt = time.perf_counter() - t0
    growth = float(np.asarray(res.x)[root])
    g_ref, _ = scipy_oracle(returns, h_budget)
    return dt, int(res.iters), int(res.status), growth, float(g_ref)


def main():
    print(f"# device: {jax.devices()[0]}")

    print("\n# projection microbench (us/call, f32)")
    print(f"{'blocks':>7} | {'exp':>8} {'pow':>8}")
    for count in (64, 1024, 16384):
        e = time_proj("exp", count)
        p = time_proj("pow", count)
        print(f"{count:>7} | {e * 1e6:8.1f} {p * 1e6:8.1f}", flush=True)

    print("\n# in-loop overhead: n=512, m=2304, 2000 fixed iters (iters/s)")
    base = time_inloop("rpos")
    print(f"   rpos-only: {base:8.0f}")
    for kind in ("exp", "pow"):
        ips = time_inloop(kind)
        print(f"   {kind:>4} 256 blk: {ips:8.0f}  "
              f"(x{base / ips:.2f} slower than rpos)", flush=True)

    print("\n# growthport end-to-end, n=64 assets x 64 scenarios, "
          "f32 fast profile, eps 1e-4")
    dt, iters, status, growth, g_ref = growthport_f32()
    print(f"   {dt:.3f} s  {iters} iters  status={status}  "
          f"growth={growth:.6f}  scipy_oracle={g_ref:.6f}  "
          f"rel_err={abs(growth - g_ref) / g_ref:.2e}")


if __name__ == "__main__":
    main()
