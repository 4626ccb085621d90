"""DenseOp.dual_matvec — the (A u, A^T v) pair every embedding
application needs — against numpy in f64, for f32 storage and for the
bf16 storage that SolverParam.matvec_dtype streams."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import totsu_tpu as tt


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(256, 128), (173, 77), (8, 128), (300, 500)])
def test_dense_dual_matvec_matches_numpy(m, n, storage):
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.normal(size=(m, n)).astype(np.float32)
    u = rng.normal(size=n).astype(np.float32)
    v = rng.normal(size=m).astype(np.float32)
    a_dev = jnp.asarray(a).astype(storage)
    # the reference multiplies the matrix the operator actually stores
    a_ref = np.asarray(a_dev.astype(jnp.float32), np.float64)
    op = tt.DenseOp(a_dev)
    p, q = jax.jit(lambda o, x, y: o.dual_matvec(x, y))(
        op, jnp.asarray(u), jnp.asarray(v))
    assert p.shape == (m,) and q.shape == (n,)
    # f32 accumulation of n (resp. m) products: a few ulp of the row norm
    np.testing.assert_allclose(np.asarray(p, np.float64),
                               a_ref @ u.astype(np.float64),
                               rtol=2e-4, atol=1e-4 * np.sqrt(n))
    np.testing.assert_allclose(np.asarray(q, np.float64),
                               v.astype(np.float64) @ a_ref,
                               rtol=2e-4, atol=1e-4 * np.sqrt(m))
