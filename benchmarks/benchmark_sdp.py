"""SDP-at-scale benchmark on the default device (VERDICT r1 #5).

Two sweeps (perturbed inputs per timed call):

* **projection sweep** — per-call cost of the PSD cone projection
  (`ops.sympack.proj_psd_packed`) at k in {48, 128, 256}, batch in
  {1, 16}, method in {eigh, ns, jacobi}. This is the SDP inner-loop
  bottleneck SURVEY.md section 7 names; the numbers drive the
  `psd(k, method='auto')` selection table.
* **end-to-end sweep** — the partitioning SDP (ref
  examples/partitioning_sdp/src/main.rs:21-163: min Tr(WX), X >= 0,
  X_ii = 1) at l = k nodes for k in {48, 128, 256}, fixed-iteration
  iters/s per method, plus a converged time-to-eps run at the
  reference's k = 48. The conic operator is built *structured*
  (DiagOp over the packed LMI + a thin selection DenseOp for the
  diagonal equalities) — at k = 256 the dense A' would be 4.3 GB f32
  while the structured one is 33 MB, which is itself the point: the
  operator algebra is what makes big SDPs representable at all.

Run: python benchmarks/benchmark_sdp.py [--quick]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

import totsu_tpu as tt
from totsu_tpu.ops import sympack
from totsu_tpu.ops.sympack import proj_psd_packed, tri_len, _pack_index
from totsu_tpu.solver.operator import DenseOp, DiagOp, VStackOp


def _fetch(r):
    return jax.block_until_ready(r)


def time_proj(k, batch, method, reps=30, trials=3):
    """Per-call projection cost: `reps` chained projections inside ONE jit
    (fori_loop), each on a perturbed input so nothing memoizes."""
    rng = np.random.default_rng(k * 1000 + batch)
    v0 = jnp.asarray(rng.normal(size=(batch, tri_len(k))), jnp.float32)

    def chain(v):
        def body(i, vv):
            return proj_psd_packed(vv + 1e-6 * (i + 1.0), scaled=True,
                                   method=method)
        return jax.lax.fori_loop(0, reps, body, v)

    fn = jax.jit(chain)
    t0 = time.perf_counter()
    _fetch(fn(v0))
    t_compile = time.perf_counter() - t0
    best = np.inf
    for t in range(trials):
        vt = v0 * (1.0 + 1e-5 * (t + 1))
        t0 = time.perf_counter()
        _fetch(fn(vt))
        best = min(best, time.perf_counter() - t0)
    return best / reps, t_compile


def build_partitioning(l, seed=10_000):
    """Structured-operator partitioning SDP: c = packed W, A' =
    [diag(-dscale); selection rows], b' = [0; 1], K = vec(S+^l) x {0}^l.
    (For F_i = -E_i the LMI columns vec(F_i) form exactly -diag(dscale)
    with dscale = 1 on diagonal slots, sqrt2 off — see
    examples/partitioning_sdp.py for the dense-builder version.)"""
    rng = np.random.default_rng(seed)
    # grid graph edge weights like the reference (square-ish grid)
    y_num = int(np.sqrt(l))
    while l % y_num:
        y_num -= 1
    x_num = l // y_num
    w = np.zeros((l, l))
    for i in range(l):
        x, y = divmod(i, y_num)
        if x < x_num - 1:
            w[i, i + y_num] = w[i + y_num, i] = rng.standard_normal()
        if y < y_num - 1:
            w[i, i + 1] = w[i + 1, i] = rng.standard_normal()

    sn = tri_len(l)
    rr, cc = _pack_index(l)
    dscale = np.where(rr == cc, 1.0, np.sqrt(2.0)).astype(np.float32)
    c = w[rr, cc].astype(np.float32)             # raw packed W (ref conv.)
    sel = np.zeros((l, sn), np.float32)
    diag_slots = np.nonzero(rr == cc)[0]
    sel[np.arange(l), diag_slots] = 1.0
    a = VStackOp((DiagOp(jnp.asarray(-dscale)), DenseOp(jnp.asarray(sel))))
    b = jnp.concatenate([jnp.zeros(sn, jnp.float32), jnp.ones(l, jnp.float32)])
    return jnp.asarray(c), a, b, w


def time_e2e(l, method, iters, trials=2):
    """Fixed-iteration partitioning solve -> (iters/s, compile_s)."""
    c, a, b, _ = build_partitioning(l)
    layout = tt.ConeLayout([tt.psd(l, method=method), tt.zero(l)])
    param = tt.SolverParam(max_iter=iters, eps_acc=1e-12,
                           check_period=max(iters // 10, 1))
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, layout, param))
    t0 = time.perf_counter()
    _fetch(fn(c, a, b))
    t_compile = time.perf_counter() - t0
    best = np.inf
    for t in range(trials):
        ct = c * (1.0 + 1e-6 * (t + 1))
        t0 = time.perf_counter()
        _fetch(fn(ct, a, b))
        best = min(best, time.perf_counter() - t0)
    return iters / best, t_compile


def converged_k48(method):
    """Reference-contract partitioning run: k=48, eps_acc=1e-3, fast
    profile — time-to-solution + iterations + objective."""
    c, a, b, w = build_partitioning(48)
    layout = tt.ConeLayout([tt.psd(48, method=method), tt.zero(48)])
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    fn = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, layout, param))
    _fetch(fn(c, a, b))
    t0 = time.perf_counter()
    res = fn(c * (1.0 + 1e-6), a, b)
    _fetch(res)
    dt = time.perf_counter() - t0
    x = np.asarray(res.x)
    l = 48
    xm = np.zeros((l, l))
    rr, cc = _pack_index(l)
    xm[rr, cc] = x
    xm[cc, rr] = x
    obj = float(np.trace(w @ xm))
    return dt, int(res.iters), int(res.status), obj


def main():
    from totsu_tpu.utils import enable_compile_cache
    enable_compile_cache()
    quick = "--quick" in sys.argv
    dev = jax.devices()[0]
    print(f"# device: {dev}")

    print("\n# PSD projection sweep (us/call; compile_s in parens)")
    print(f"{'k':>4} {'batch':>5} | {'eigh':>16} {'ns':>16} {'jacobi':>16}")
    for k in (48, 128, 256, 512):
        for batch in (1, 16):
            if quick and batch == 16:
                continue
            row = f"{k:>4} {batch:>5} |"
            for method in ("eigh", "ns", "jacobi"):
                if method == "jacobi" and k > 256:
                    row += f" {'--':>16}"
                    continue
                reps = 30 if k <= 128 else (10 if k <= 256 else 5)
                try:
                    per, comp = time_proj(k, batch, method, reps=reps)
                    row += f" {per * 1e6:9.0f} ({comp:4.0f}s)"
                except Exception as e:  # noqa: BLE001 - record, keep sweeping
                    row += f" {'ERR':>16}"
                    print(f"#  {method} k={k} b={batch}: {type(e).__name__}: {e}")
            print(row, flush=True)

    print("\n# end-to-end partitioning SDP, fixed-iteration iters/s")
    print(f"{'k':>4} {'iters':>6} | {'eigh':>16} {'ns':>16} {'jacobi':>16}")
    for l in (48, 128, 256, 512):
        iters = {48: 2000, 128: 500, 256: 200, 512: 100}[l]
        if quick:
            iters //= 4
        row = f"{l:>4} {iters:>6} |"
        for method in ("eigh", "ns", "jacobi"):
            if method == "jacobi" and l > 256:
                row += f" {'--':>16}"
                continue
            try:
                ips, comp = time_e2e(l, method, iters)
                row += f" {ips:9.0f} ({comp:4.0f}s)"
            except Exception as e:  # noqa: BLE001
                row += f" {'ERR':>16}"
                print(f"#  e2e {method} k={l}: {type(e).__name__}: {e}")
        print(row, flush=True)

    print("\n# converged k=48 partitioning (eps_acc=1e-3, fast profile)")
    for method in ("eigh", "ns", "jacobi"):
        dt, iters, status, obj = converged_k48(method)
        print(f"{method:>7}: {dt:7.3f} s  {iters:6d} iters  "
              f"status={status}  obj={obj:+.4f}", flush=True)

    # jacobi compile-time envelope (VERDICT r2 #10): the k-1 statically
    # unrolled rounds/sweep of jacobi_eigh grow lowering+compile time with
    # k; this records the curve that caps resolve_auto_methods' jacobi
    # selection (k <= 16) and justifies the k > 256 explicit-sweeps gate.
    print("\n# jacobi_eigh compile envelope (single projection, batch=8)")
    print(f"{'k':>4} {'compile_s':>10} {'run_us':>8} {'max|err| vs eigh':>17}")
    from totsu_tpu.ops.jacobi import psd_part_jacobi
    from totsu_tpu.ops.sympack import psd_part
    env_ks = (8, 16, 32, 64, 128) if quick else (8, 16, 32, 64, 128, 192, 256)
    for k in env_ks:
        rng = np.random.default_rng(k)
        x = jnp.asarray(rng.normal(size=(8, k, k)), jnp.float32)
        x = 0.5 * (x + jnp.swapaxes(x, -1, -2))
        fn = jax.jit(lambda m: psd_part_jacobi(m, sweeps=None if k <= 256
                                               else 16))
        t0 = time.perf_counter()
        out = fn(x)
        jax.block_until_ready(out)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        _fetch(fn(x * (1.0 + 1e-6)))
        t_run = time.perf_counter() - t0
        ref = psd_part(np.asarray(x, np.float64))
        err = float(np.max(np.abs(np.asarray(out, np.float64) - ref)))
        print(f"{k:>4} {t_compile:>10.1f} {t_run * 1e6:>8.0f} {err:>17.2e}",
              flush=True)


if __name__ == "__main__":
    main()
