"""Sharding scaling proxy on the virtual CPU mesh (VERDICT r1 #3).

This is the CPU proxy, runnable anywhere: it measures what can be
measured honestly on N virtual CPU devices sharing the host cores (the
same paths on four GPUs are run by ``python chip_smoke.py --multi``):

* row-shard sweep — per-iteration wall time of the SAME fixed-iteration
  LP solve with A row-sharded over row in {1, 2, 4, 8}: the sharding
  machinery + one fused all-reduce per iteration must not blow up the
  iteration cost (the devices share silicon, so no speedup is expected
  here — overhead is the signal);
* batch-shard sweep — lockstep vmapped instances sharded over the batch
  axis vs the same batch on one device: batch sharding emits ZERO
  collectives (each device iterates its instances independently — see
  tests/test_parallel.py::test_batch_sharded_zero_collectives), so on
  real chips its scaling efficiency is 100% by construction minus any
  dispatch overhead, which is exactly the ratio printed here.

The only FAIR wall-time comparison on this host is a mesh with
devices == physical cores (one core of silicon per device); meshes wider
than the core count oversubscribe the cores and the slowdown measures the
host's thread scheduler, not the sharding machinery. Both are printed,
labeled.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/benchmark_sharding.py
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_default_device", jax.devices("cpu")[0])

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import totsu_tpu as tt
from totsu_tpu.parallel import make_mesh, shard_dense_problem
from totsu_tpu.utils import enable_compile_cache
from jax.sharding import NamedSharding, PartitionSpec as P

enable_compile_cache()


def make_lp(n, m, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = (m, n) if batch is None else (batch, m, n)
    g = rng.normal(size=shape).astype(np.float32)
    x0 = rng.normal(size=(n,) if batch is None else (batch, n))
    h = (np.einsum("...mn,...n->...m", g, x0)
         + rng.random((m,) if batch is None else (batch, m)) + 0.1)
    c = rng.normal(size=(n,) if batch is None else (batch, n))
    return (c.astype(np.float32), g, h.astype(np.float32))


def timeit(fn, *args, trials=3):
    r = jax.block_until_ready(fn(*args))  # compile
    best = np.inf
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, r


def main():
    devs = jax.devices("cpu")
    # fair mesh width = one core per device, capped by the virtual-device
    # count (XLA_FLAGS above creates 8; hosts with more cores still run)
    ncores = min(len(os.sched_getaffinity(0)), len(devs))
    n, m, iters = 256, 2048, 2000
    c, g, h = make_lp(n, m)
    lay = tt.ConeLayout([tt.rpos(m)])
    param = tt.SolverParam(max_iter=iters, eps_acc=1e-12, check_period=100)

    print(f"# row-shard sweep: n={n} m={m}, {iters} fixed iterations, "
          f"{len(devs)} virtual cpu devices on {ncores} physical cores "
          f"(rows with row > {ncores} oversubscribe the cores)")
    base_dt = None
    for row in (1, 2, 4, 8):
        mesh = make_mesh(batch=1, row=row, devices=devs[:row])
        prob = shard_dense_problem(
            tt.ConicProblem(jnp.asarray(c), tt.DenseOp(jnp.asarray(g)),
                            jnp.asarray(h), lay), mesh)
        fn = jax.jit(lambda c_, a_, b_, rs=prob.row_sharding:
                     tt.solve_jit(c_, a_, b_, lay, param, row_sharding=rs))
        dt, r = timeit(fn, prob.c, prob.a, prob.b)
        if base_dt is None:
            base_dt = dt
        print(f"row={row}: {dt / iters * 1e6:8.1f} us/iter  "
              f"(x{dt / base_dt:.2f} vs row=1)  iters={int(r.iters)}")

    print(f"\n# batch-shard: lockstep n=64 m=192 instances, "
          f"{iters} fixed iterations")
    nb, mb = 64, 192
    layb = tt.ConeLayout([tt.rpos(mb)])
    pb = tt.SolverParam(max_iter=iters, eps_acc=1e-12, check_period=100)
    vfn = jax.jit(jax.vmap(
        lambda ci, ai, bi: tt.solve_jit(ci, ai, bi, layb, pb)))
    one = jax.devices("cpu")[0]

    def batch_args(bsz, sharded):
        cb, gb, hb = make_lp(nb, mb, seed=1, batch=bsz)
        if not sharded:
            return tuple(jax.device_put(jnp.asarray(x), one)
                         for x in (cb, gb, hb))
        mesh = make_mesh(batch=bsz, row=1, devices=devs[:bsz])
        return (jax.device_put(jnp.asarray(cb),
                               NamedSharding(mesh, P("batch", None))),
                jax.device_put(jnp.asarray(gb),
                               NamedSharding(mesh, P("batch", None, None))),
                jax.device_put(jnp.asarray(hb),
                               NamedSharding(mesh, P("batch", None))))

    # FAIR scaling measurement: one physical core of silicon per device.
    # batch=1 on 1 device vs batch=ncores sharded over ncores devices —
    # identical per-device work, so ideal scaling multiplies the instance
    # throughput by ncores; the shortfall is dispatch overhead + shared
    # memory bandwidth, the same losses a real multi-chip batch run has.
    # (ADVICE r2: on a 1-core host this comparison is degenerate — skip.)
    if ncores >= 2:
        dt_1, _ = timeit(vfn, *batch_args(1, sharded=False))
        dt_nc, _ = timeit(vfn, *batch_args(ncores, sharded=True))
        rate_1 = iters / dt_1
        rate_nc = ncores * iters / dt_nc
        eff = rate_nc / (ncores * rate_1)
        print(f"[fair: 1 core/device] batch=1 on 1 device : "
              f"{rate_1:10.0f} instance-iters/s")
        print(f"[fair: 1 core/device] batch={ncores} over {ncores} devices: "
              f"{rate_nc:10.0f} instance-iters/s")
        print(f"batch-scaling efficiency at {ncores} devices: "
              f"{eff * 100:.0f}% (ideal = 100%)")
    else:
        print("[fair] skipped: 1-core host cannot measure scaling "
              "(batch=1 over 1 device vs itself is trivially ~100%)")

    # oversubscribed sanity point (8 devices on the same cores): measures
    # the host scheduler, NOT the sharding machinery — kept for context
    dt_one, _ = timeit(vfn, *batch_args(8, sharded=False))
    dt_sh, _ = timeit(vfn, *batch_args(8, sharded=True))
    print(f"[oversubscribed] batch=8 single device : "
          f"{8 * iters / dt_one:10.0f} instance-iters/s")
    print(f"[oversubscribed] batch=8 over 8 devices: "
          f"{8 * iters / dt_sh:10.0f} instance-iters/s")


def main_ell8192(n=8192, iters=200):
    """Sharded blocked-ELL at the scale it exists for (VERDICT r3 #2):
    the n=8192 banded+box LP through ``shard_blocked_ell_problem`` on the
    FAIR 2-device virtual mesh — per-iteration overhead vs unsharded, and
    the HLO collective contract re-checked at this scale (tile arrays
    must never move between devices; only (m,)/(n,)-vector gathers)."""
    import re
    from totsu_tpu.parallel import shard_blocked_ell_problem
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from benchmark_indirect import make_banded_box_lp

    devs = jax.devices("cpu")
    ncores = min(len(os.sched_getaffinity(0)), len(devs))
    ndev = min(2, ncores)
    print(f"# sharded blocked-ELL n={n} (m={3 * n}) banded+box LP, "
          f"{iters} fixed iterations, fair mesh = {ndev} devices", flush=True)
    c, a, b = make_banded_box_lp(n)
    ell = tt.BlockedEllOp.from_dense(a, block=(128, 128))
    del a
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    param = tt.SolverParam(max_iter=iters, eps_acc=1e-12, check_period=100,
                           accel="halpern", normalize=True)
    cj, bj = jnp.asarray(c), jnp.asarray(b)

    fn0 = jax.jit(lambda c_, a_, b_: tt.solve_jit(c_, a_, b_, lay, param))
    dt0, r0 = timeit(fn0, cj, ell, bj)
    print(f"unsharded      : {dt0 / iters * 1e6:8.1f} us/iter "
          f"(iters={int(r0.iters)})", flush=True)

    mesh = make_mesh(batch=1, row=ndev, devices=devs[:ndev])
    prob = shard_blocked_ell_problem(
        tt.ConicProblem(cj, ell, bj, lay), mesh)
    fn1 = jax.jit(lambda c_, a_, b_: tt.solve_jit(
        c_, a_, b_, lay, param, row_sharding=prob.row_sharding))
    dt1, r1 = timeit(fn1, prob.c, prob.a, prob.b)
    print(f"row-sharded x{ndev}: {dt1 / iters * 1e6:8.1f} us/iter "
          f"(x{dt1 / dt0:.2f} vs unsharded; devices share the silicon, "
          f"so overhead is the signal)", flush=True)
    assert int(r1.iters) == int(r0.iters)

    # HLO collective contract at n=8192 (the test pins it at n=128)
    txt = fn1.lower(prob.c, prob.a, prob.b).compile().as_text()
    m = prob.b.shape[0]
    biggest = 0
    for shp in re.findall(r"=\s*\w+\[([\d,]*)\]\S*\s+all-gather", txt):
        elems = int(np.prod([int(s) for s in shp.split(",") if s]))
        biggest = max(biggest, elems)
    n_ar = len(re.findall(r" all-reduce\w*\(", txt))
    print(f"HLO: largest all-gather = {biggest} elements (<= m = {m}: "
          f"{'OK' if biggest <= m else 'VIOLATION'}), "
          f"all-reduces = {n_ar}; tile arrays never move", flush=True)


if __name__ == "__main__":
    if "--ell8192" in sys.argv:
        main_ell8192()
    else:
        main()
