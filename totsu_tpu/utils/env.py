"""Environment-variable configuration.

Mirrors the reference's ``utils2::set_par_by_env``
(ref: examples/utils2/src/set_par_by_env.rs:5-25): MAX_ITER / EPS_ACC /
EPS_INF / EPS_ZERO / LOG_PERIOD override solver parameters, plus the
knobs this solver adds (CHECK_PERIOD, EQUIL_ITERS, RELAX, METHOD,
PROFILE, ACCEL).
"""

import dataclasses
import os

from totsu_tpu.solver.params import SolverParam


def set_par_by_env(param: SolverParam) -> SolverParam:
    """Return a copy of ``param`` with env-var overrides applied."""
    updates = {}
    if "MAX_ITER" in os.environ:
        updates["max_iter"] = int(os.environ["MAX_ITER"])
    for name in ("EPS_ACC", "EPS_INF", "EPS_ZERO"):
        if name in os.environ:
            updates[name.lower()] = float(os.environ[name])
    for name in ("LOG_PERIOD", "CHECK_PERIOD", "EQUIL_ITERS"):
        if name in os.environ:
            updates[name.lower()] = int(os.environ[name])
    if "RELAX" in os.environ:
        updates["relax"] = float(os.environ["RELAX"])
    for name in ("METHOD", "PROFILE", "ACCEL"):
        if name in os.environ:
            updates[name.lower()] = os.environ[name]
    return dataclasses.replace(param, **updates) if updates else param


def use_cpu(enable_x64: bool = True):
    """Make the host CPU the default device (developer/test convenience).

    On a machine with a GPU, ``JAX_PLATFORMS=cpu`` set before JAX starts
    hides the GPU entirely; this call instead keeps the GPU visible and
    sends un-placed computations to the CPU via ``jax_default_device``.
    Call before any computation.
    """
    import jax
    if enable_x64:
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
