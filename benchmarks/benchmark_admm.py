"""Consensus-ADMM scaling proxy on the virtual CPU mesh (VERDICT r2 #7).

The consensus mode (parallel/admm.py) is the one §2.8 capability with no
measured number. Like benchmark_sharding.py, this is the virtual CPU mesh
proxy, and it measures:

* agents × n sweep — wall time per outer round of the full consensus
  loop (vmapped subsolves + z/u reduction) on ONE device, showing how
  the round cost scales with the fleet;
* mesh sweep — the identical fleet with agents sharded over the mesh
  'batch' axis. Only the (n,)-vector z/u consensus mean crosses devices
  each round, so (as with batch sharding) real-chip efficiency is the
  dispatch-overhead ratio printed here; the only FAIR wall-time mesh on
  this host is devices == physical cores.

Run: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
     python benchmarks/benchmark_admm.py

``--sync`` instead measures the HOST-SYNC cost of the outer loop on the
default accelerator (VERDICT r3 weak #5): seconds per outer round at
``rounds_per_sync`` in {1, 8} through the real dispatch path; the
lax.scan chunking amortizes one dispatch and fetch over 8 rounds.
"""

import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import jax

if "--sync" not in sys.argv:
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import totsu_tpu as tt
from totsu_tpu.parallel import consensus_admm, make_mesh
from totsu_tpu.utils import enable_compile_cache

enable_compile_cache()


def make_fleet(n_agents, n, m, seed=0):
    """Random feasible per-agent LPs sharing the consensus variable."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n_agents, m, n))
    x0 = rng.normal(size=n)
    b = a @ x0 + rng.random((n_agents, m)) + 0.1
    c = rng.normal(size=(n_agents, n))
    return c, a, b, tt.ConeLayout([tt.rpos(m)])


def run(n_agents, n, m, mesh=None, max_outer=10, trials=2):
    c, a, b, cone = make_fleet(n_agents, n, m)
    param = tt.SolverParam(max_iter=20_000, eps_acc=1e-3, check_period=20)
    # warm-up (compile)
    consensus_admm(c, a, b, cone, max_outer=2, tol=0.0, param=param,
                   mesh=mesh)
    best = np.inf
    for t in range(trials):
        ct = c * (1.0 + 1e-6 * (t + 1))
        t0 = time.perf_counter()
        res = consensus_admm(ct, a, b, cone, max_outer=max_outer, tol=0.0,
                             param=param, mesh=mesh)
        jax.block_until_ready(res.z)
        best = min(best, time.perf_counter() - t0)
    return best / max_outer, res


def main():
    ncores = os.cpu_count() or 1
    print(f"# virtual devices: {len(jax.devices('cpu'))}; physical cores: "
          f"{ncores} (fair mesh = {min(ncores, 8)} devices)")

    print("\n# agents x n sweep, one device: s/outer-round")
    print(f"{'agents':>6} {'n':>5} {'m':>5} {'s/round':>9}")
    for n_agents, n, m in ((2, 64, 192), (4, 64, 192), (8, 64, 192),
                           (8, 128, 384)):
        dt, res = run(n_agents, n, m)
        print(f"{n_agents:>6} {n:>5} {m:>5} {dt:>9.3f}", flush=True)

    print("\n# mesh sweep, 8 agents n=64 m=192: s/outer-round")
    print(f"{'devices':>7} {'s/round':>9} {'vs 1dev':>8}")
    base = None
    for ndev in (1, 2, 4, 8):
        devs = jax.devices("cpu")
        mesh = make_mesh(batch=ndev, devices=devs[:ndev]) if ndev > 1 \
            else None
        dt, res = run(8, 64, 192, mesh=mesh)
        base = dt if base is None else base
        fair = "  (fair)" if ndev <= ncores else "  (oversubscribed)"
        print(f"{ndev:>7} {dt:>9.3f} {dt / base:>7.2f}x{fair}", flush=True)
    print(f"# unconverged-subsolve rounds in last run: "
          f"{int(res.rounds_with_unconverged_subsolves)}")


def main_sync():
    dev = jax.devices()[0]
    print(f"# ADMM host-sync cost on {dev}: s/outer-round, 16 rounds, "
          "8 agents n=64 m=192, tol=0 (all rounds run)")
    c, a, b, cone = make_fleet(8, 64, 192)
    param = tt.SolverParam(max_iter=20_000, eps_acc=1e-3, check_period=20)
    rounds = 16
    for rps in (1, 8):
        consensus_admm(c, a, b, cone, max_outer=rounds, tol=0.0,
                       param=param, rounds_per_sync=rps)   # compile
        best = np.inf
        for t in range(2):
            ct = c * (1.0 + 1e-6 * (t + 1))
            t0 = time.perf_counter()
            res = consensus_admm(ct, a, b, cone, max_outer=rounds,
                                 tol=0.0, param=param, rounds_per_sync=rps)
            jax.block_until_ready(res.z)
            best = min(best, time.perf_counter() - t0)
        print(f"rounds_per_sync={rps}: {best / rounds * 1e3:8.1f} ms/round "
              f"({rounds / best:6.1f} rounds/s)  pri={res.pri_res:.2e}",
              flush=True)


if __name__ == "__main__":
    if "--sync" in sys.argv:
        main_sync()
    else:
        main()
