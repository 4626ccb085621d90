"""The GPU entry points refuse to run without a GPU, and the tests that
need a card.

``chip_smoke.py`` and ``bench.py`` must fail (non-zero exit, no result
line) when JAX's first device is the CPU: neither falls back. Tests marked
``gpu`` run only where JAX sees a GPU (``JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/`` on the card) and skip elsewhere; whether a card is
present is decided inside the fixture, never at import time.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_on_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def _json_lines(stdout):
    out = []
    for ln in stdout.splitlines():
        try:
            out.append(json.loads(ln))
        except ValueError:
            pass
    return out


def test_chip_smoke_refuses_the_cpu():
    proc = _run_on_cpu(["chip_smoke.py"])
    assert proc.returncode != 0
    assert "not a GPU" in proc.stderr
    assert _json_lines(proc.stdout) == []


def test_bench_refuses_the_cpu():
    proc = _run_on_cpu(["bench.py"])
    assert proc.returncode != 0
    assert _json_lines(proc.stdout) == []


@pytest.fixture
def gpu_device():
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_batched_direct_solve_converges_on_gpu(gpu_device):
    """Batched f32 solves on the card: every lane converges (the class of
    failure DEFAULT-precision batched dots would cause)."""
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    sys.path.insert(0, ROOT)
    import bench
    probs = [bench.make_lp(60, seed=s) for s in range(8)]
    cb, ab, bb = (jnp.asarray(np.stack([p[k] for p in probs]))
                  for k in range(3))
    lay = tt.ConeLayout([tt.rpos(ab.shape[1])])
    param = tt.SolverParam(max_iter=200_000, eps_acc=1e-3, profile="fast")
    with jax.default_device(gpu_device):
        res = tt.parallel.solve_batch(cb, ab, bb, lay, param)
    assert res.x.devices() == {gpu_device}
    assert (np.asarray(res.status) == 1).all()
