"""Structured-sparse vs dense crossover on the default device (VERDICT r1 #8).

The reference is dense-only (MatOp, matop.rs:9-40). This repo adds two
sparse paths and this benchmark locates where each pays at n ~ 8000:

* **BlockedEllOp** (gather + batched matmul, no scatter) on a
  block-banded LP at n = m = 8192 with tile bandwidths K in {1, 2, 4, 8}
  128x128 tiles per tile-row (scalar density 1.6% ... 12.5%): full
  fixed-iteration solve iters/s vs the SAME matrix through DenseOp.
  Also reports device bytes for A (the capability argument: blocked-ELL
  keeps problems addressable after dense A outgrows device memory).
* **SparseOp** (BCOO gather/scatter): one fused matvec-pair
  (A @ u, A^T v) per call vs dense, at uniform-random 1% density.
* **tile-occupancy statistic** for uniform-random 1%: the fraction of
  128x128 tiles with at least one nonzero (~100%), demonstrating why
  unstructured sparsity does not tile.

Run: python benchmarks/benchmark_sparse.py
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

import totsu_tpu as tt


def _fetch(r):
    return jax.block_until_ready(r)


def make_banded_lp(n, k_tiles, tile=128, seed=0):
    """Block-banded feasible LP: A has k_tiles 128x128 tiles per tile-row
    along the diagonal band (wrap-around), dense inside tiles."""
    rng = np.random.default_rng(seed)
    nb = n // tile
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(nb):
        for d in range(k_tiles):
            j = (i + d) % nb
            a[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = \
                rng.normal(size=(tile, tile)).astype(np.float32) / np.sqrt(
                    k_tiles * tile)
    x0 = rng.normal(size=n)
    b = (a @ x0 + rng.random(n) + 0.1).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    return c, a, b


def time_solve(c, a_op, b, lay, iters=2000, trials=2):
    param = tt.SolverParam(max_iter=iters, eps_acc=1e-12, check_period=100)
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, param))
    _fetch(fn(c, a_op, b))
    best = np.inf
    for t in range(trials):
        ct = c * (1.0 + 1e-6 * (t + 1))
        t0 = time.perf_counter()
        _fetch(fn(ct, a_op, b))
        best = min(best, time.perf_counter() - t0)
    return iters / best


def device_bytes(op):
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(op)
               if hasattr(x, "dtype"))


def time_matvec_pair(op, n, m, reps=200, trials=3):
    """us per fused (A @ u, A^T v) pair — the per-iteration operator work."""
    rng = np.random.default_rng(1)
    u0 = jnp.asarray(rng.normal(size=n), jnp.float32)
    v0 = jnp.asarray(rng.normal(size=m), jnp.float32)

    def chain(op_, u, v):
        def body(i, uv):
            u_, v_ = uv
            y = op_.matvec(u_ / (1.0 + jnp.abs(v_[0])))
            x = op_.rmatvec(v_)
            return x, y
        return jax.lax.fori_loop(0, reps, body, (u0 * u[0], v0 * v[0]))

    fn = jax.jit(chain)
    _fetch(fn(op, u0[:1], v0[:1]))
    best = np.inf
    for t in range(trials):
        t0 = time.perf_counter()
        _fetch(fn(op, u0[:1] * (1 + 1e-5 * (t + 1)), v0[:1]))
        best = min(best, time.perf_counter() - t0)
    return best / reps


def main():
    from totsu_tpu.utils import enable_compile_cache
    enable_compile_cache()
    print(f"# device: {jax.devices()[0]}")
    n = 8192
    lay = tt.ConeLayout([tt.rpos(n)])

    print(f"\n# block-banded LP n=m={n}, 2000 fixed iters: "
          "dense vs blocked-ELL (iters/s)")
    print(f"{'K':>2} {'density':>8} | {'dense':>8} {'ell':>8} "
          f"{'speedup':>8} | {'A bytes dense':>13} {'ell':>10}")
    for k_tiles in (1, 2, 4, 8):
        c, a, b = make_banded_lp(n, k_tiles)
        cj, bj = jnp.asarray(c), jnp.asarray(b)
        dense_op = tt.DenseOp(jnp.asarray(a))
        ell_op = tt.BlockedEllOp.from_dense(a, block=(128, 128))
        ips_d = time_solve(cj, dense_op, bj, lay)
        ips_e = time_solve(cj, ell_op, bj, lay)
        dens = k_tiles / (n // 128)
        print(f"{k_tiles:>2} {dens:8.1%} | {ips_d:8.0f} {ips_e:8.0f} "
              f"{ips_e / ips_d:7.2f}x | {device_bytes(dense_op):13,} "
              f"{device_bytes(ell_op):10,}", flush=True)

    print(f"\n# uniform-random 1% density n={n}: matvec-pair us/call")
    rng = np.random.default_rng(7)
    a_rand = np.where(rng.random((n, n)) < 0.01,
                      rng.normal(size=(n, n)), 0.0).astype(np.float32)
    tiles = a_rand.reshape(n // 128, 128, n // 128, 128)
    occ = (np.abs(tiles).sum(axis=(1, 3)) > 0).mean()
    print(f"   tile occupancy at 128x128: {occ:.1%} "
          "(unstructured 1% does not tile)")
    t_dense = time_matvec_pair(tt.DenseOp(jnp.asarray(a_rand)), n, n)
    print(f"   dense:  {t_dense * 1e6:9.1f} us/pair", flush=True)
    t_bcoo = time_matvec_pair(
        tt.SparseOp.from_dense(a_rand, nse=int((a_rand != 0).sum())), n, n)
    print(f"   bcoo:   {t_bcoo * 1e6:9.1f} us/pair "
          f"(x{t_bcoo / t_dense:.1f} vs dense)", flush=True)


if __name__ == "__main__":
    main()
