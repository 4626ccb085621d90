"""Indirect direct engine at scale (VERDICT r3 #1): measured time-to-1e-3
of ``method='direct'`` (warm-started CG on I + A^T A — the SCS "indirect"
mode, solver/direct.py) vs the pdhg fast profile, on the two large
structured operator classes the engine exists for:

* **blocked-ELL** banded+box LP at n = 8192 (m = 3n = 24576; the same
  128x128-tile band instance as benchmark_sparse.py plus box rows so
  time-to-solution exists) — the structured-sparse path;
* **matrix-free** circulant-stencil+box LP at the same shape (CustomOp
  with hand-derived abs-sum oracles, the imgnr_udef pattern) — the path
  with no materializable A at all.

Each operator runs the candidate fast configurations:

  pdhg+halpern+normalize            (what profile='fast' resolved to
                                     for non-dense operators before r4)
  pdhg+halpern+normalize+equil10    (the r4 composition: operator-form
                                     Ruiz now reachable via the profile)
  direct(indirect CG)+halpern       (the engine under test)
  direct(indirect CG)+halpern+equil10

Reference cost anchor: the pdhg engine pays 4 A-applications/iteration
(solver.rs:364-457) and first-order iteration counts at n ~ 10^4 sit in
the 10^4-10^5 tail; the indirect engine trades that for ~10^2-10^3 DR
iterations x a few warm-started CG steps each. This benchmark measures
which side of that trade wins per operator class; the winner is wired
into ``_resolve_fast_profile`` (solver/conic.py) and pinned by
tests/test_solver.py::test_fast_profile_routes_structured_operators.

Run: python benchmarks/benchmark_indirect.py  (on the default device)
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

import totsu_tpu as tt
from totsu_tpu.solver.operator import CustomOp


def _fetch(r):
    return jax.block_until_ready(r)


def make_banded_box_lp(n, k_tiles=2, tile=128, seed=0):
    """Feasible + bounded banded LP: [band; I; -I] x <= [b; 10; 10]."""
    rng = np.random.default_rng(seed)
    nb = n // tile
    a = np.zeros((3 * n, n), dtype=np.float32)
    for i in range(nb):
        for d in range(k_tiles):
            j = (i + d) % nb
            a[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = \
                rng.normal(size=(tile, tile)).astype(np.float32) / np.sqrt(
                    k_tiles * tile)
    a[n:2 * n] = np.eye(n, dtype=np.float32)
    a[2 * n:] = -np.eye(n, dtype=np.float32)
    x0 = rng.normal(size=n)
    b = np.concatenate([
        (a[:n] @ x0 + rng.random(n) + 0.1),
        np.full(n, 10.0), np.full(n, 10.0)]).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b


def make_stencil_op(n, dtype=jnp.float32):
    """Matrix-free circulant 3-point stencil + box rows as one CustomOp
    (m = 3n). Hand-derived abs-sum/absmax oracles (the reference's
    laplacian.rs:52-109 pattern) — nothing is ever materialized."""
    w = jnp.asarray([1.0, -0.45, -0.55], dtype)   # diagonally dominant

    def mv(params, x):
        s = params[0] * x + params[1] * jnp.roll(x, 1) \
            + params[2] * jnp.roll(x, -1)
        return jnp.concatenate([s, x, -x])

    def rmv(params, y):
        n_ = y.shape[0] // 3
        ys, yp, ym = y[:n_], y[n_:2 * n_], y[2 * n_:]
        return (params[0] * ys + params[1] * jnp.roll(ys, -1)
                + params[2] * jnp.roll(ys, 1)) + yp - ym

    absw = float(np.abs(np.asarray(w)).sum())

    def col_abssum(params):
        return jnp.full((n,), absw + 2.0, dtype)

    def row_abssum(params):
        return jnp.concatenate([jnp.full((n,), absw, dtype),
                                jnp.ones((2 * n,), dtype)])

    return CustomOp(params=w, m=3 * n, n=n, matvec_fn=mv, rmatvec_fn=rmv,
                    col_abssum_fn=col_abssum, row_abssum_fn=row_abssum)


def make_stencil_lp(n, seed=1):
    rng = np.random.default_rng(seed)
    op = make_stencil_op(n)
    x0 = jnp.asarray(rng.normal(size=n), jnp.float32)
    bs = op.matvec(x0)[:n] + jnp.asarray(rng.random(n) + 0.1, jnp.float32)
    b = jnp.concatenate([bs, jnp.full((2 * n,), 10.0, jnp.float32)])
    c = jnp.asarray(rng.normal(size=n), jnp.float32)
    return c, op, b


def time_to_sol(c, a_op, b, lay, param, trials=2, tag=""):
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, param))
    r = fn(c, a_op, b)
    _fetch(r)
    best = np.inf
    for t in range(trials):
        ct = c * (1.0 + 1e-6 * (t + 1))
        t0 = time.perf_counter()
        r = fn(ct, a_op, b)
        _fetch(r)
        best = min(best, time.perf_counter() - t0)
    status = int(r.status)
    print(f"  {tag:34s} {best:8.3f} s  iters={int(r.iters):>7d}  "
          f"status={status}{'' if status == 1 else '  (NOT CONVERGED)'}",
          flush=True)
    return best, r


CONFIGS = [
    ("pdhg halpern norm",        dict(method="pdhg", accel="halpern",
                                      normalize=True)),
    ("pdhg halpern norm equil10", dict(method="pdhg", accel="halpern",
                                       normalize=True, equil_iters=10)),
    ("direct(CG) halpern",       dict(method="direct", accel="halpern")),
    ("direct(CG) halpern equil10", dict(method="direct", accel="halpern",
                                        equil_iters=10)),
]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    eps = 1e-3
    from totsu_tpu.utils import enable_compile_cache
    enable_compile_cache()
    print(f"# indirect-vs-pdhg time-to-{eps:g}, n={n}, m={3 * n}, device:",
          jax.devices()[0], flush=True)
    lay = tt.ConeLayout([tt.rpos(3 * n)])

    print("\n## blocked-ELL banded+box LP")
    c, a, b = make_banded_box_lp(n)
    ell = tt.BlockedEllOp.from_dense(a, block=(128, 128))
    del a
    print("# ell built", flush=True)
    cj, bj = jnp.asarray(c), jnp.asarray(b)
    for tag, kw in CONFIGS:
        param = tt.SolverParam(max_iter=400_000, eps_acc=eps,
                               check_period=20, **kw)
        time_to_sol(cj, ell, bj, lay, param, tag=tag)

    print("\n## matrix-free stencil+box LP (CustomOp; equil rows skipped "
          "— CustomOp has no absmax by design)")
    c2, op2, b2 = make_stencil_lp(n)
    for tag, kw in CONFIGS:
        if kw.get("equil_iters"):
            continue
        param = tt.SolverParam(max_iter=400_000, eps_acc=eps,
                               check_period=20, **kw)
        time_to_sol(c2, op2, b2, lay, param, tag=tag)


if __name__ == "__main__":
    main()
