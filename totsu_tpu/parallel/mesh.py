"""Device-mesh helpers."""

from typing import Mapping, Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh


def local_mesh(axis_sizes: Mapping[str, int],
               devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from (axis name -> size). Uses the default device list
    (or an explicit one, e.g. ``jax.devices('cpu')`` for a virtual CPU
    mesh on a machine that also has GPUs)."""
    if devices is None:
        devices = jax.devices()
    sizes = list(axis_sizes.values())
    need = int(np.prod(sizes))
    if need > len(devices):
        raise ValueError(f"mesh needs {need} devices, have {len(devices)}")
    dev_array = np.asarray(devices[:need]).reshape(sizes)
    return Mesh(dev_array, tuple(axis_sizes.keys()))


def make_mesh(batch: int = 1, row: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """The solver's canonical 2-axis mesh: ``batch`` (data-parallel over
    problem instances) x ``row`` (operator-row/cone-block parallel —
    the analogue of tensor parallelism for the constraint matrix)."""
    return local_mesh({"batch": batch, "row": row}, devices)
