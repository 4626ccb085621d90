"""Shared example helpers: device selection and CLI/env parameter handling."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def setup(cpu: bool = None, x64: bool = None):
    """Pick the device. Default: run on whatever JAX has (the GPU if
    present, f32); with --cpu pin to the host CPU with f64 like the
    reference's FloatGeneric/LAPACK backends."""
    import jax
    if cpu is None:
        cpu = "--cpu" in sys.argv or os.environ.get("TOTSU_CPU") == "1"
    if cpu:
        from totsu_tpu.utils import use_cpu
        use_cpu(enable_x64=(x64 if x64 is not None else True))
        return "cpu-f64"
    return f"{jax.devices()[0].platform}-f32"


def report(name, res, t_solve, extra=""):
    import numpy as np
    status = ["RUNNING", "CONVERGED", "EXCESS_ITER", "UNBOUNDED",
              "INFEASIBLE"][int(res.status)]
    print(f"[{name}] {status} iters={int(res.iters)} "
          f"cri=({float(res.cri_pri):.2e},{float(res.cri_dual):.2e},"
          f"{float(res.cri_gap):.2e}) solve={t_solve:.3f}s {extra}")
    return status
