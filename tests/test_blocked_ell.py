"""Blocked-ELL structured-sparse operator (VERDICT r1 #8): the
large-problem path — gather + batched matmul both directions, no scatter."""

import numpy as np
import jax.numpy as jnp

import totsu_tpu as tt
from totsu_tpu.utils import check_operator


def block_banded(m, n, bm, bn, band=1, seed=0, dtype=np.float64):
    """Dense matrix that is block-banded at tile granularity."""
    rng = np.random.default_rng(seed)
    a = np.zeros((m, n), dtype=dtype)
    nbr, nbc = -(-m // bm), -(-n // bn)
    for i in range(nbr):
        for j in range(nbc):
            if abs(i * nbc // nbr - j) <= band:
                r0, c0 = i * bm, j * bn
                a[r0:min(r0 + bm, m), c0:min(c0 + bn, n)] = rng.normal(
                    size=(min(bm, m - r0), min(bn, n - c0)))
    return a


def test_blocked_ell_matches_dense():
    a = block_banded(70, 50, bm=16, bn=8)   # non-multiple dims -> padding
    op = tt.BlockedEllOp.from_dense(a, block=(16, 8))
    dense = tt.DenseOp(jnp.asarray(a))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=50))
    y = jnp.asarray(rng.normal(size=70))
    np.testing.assert_allclose(np.asarray(op.matvec(x)),
                               np.asarray(dense.matvec(x)), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)),
                               np.asarray(dense.rmatvec(y)), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.col_abssum()),
                               np.asarray(dense.col_abssum()), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.row_abssum()),
                               np.asarray(dense.row_abssum()), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a, atol=1e-12)


def test_blocked_ell_operator_contract():
    # the reference's operator-oracle discipline (utils2/operator_ref.rs)
    a = block_banded(48, 32, bm=8, bn=8, seed=2)
    op = tt.BlockedEllOp.from_dense(a, block=(8, 8))
    check_operator(op)


def test_blocked_ell_solve_matches_dense_solve():
    # end-to-end: a block-banded LP through the pdhg engine on both
    # operators must follow the identical iterate path
    rng = np.random.default_rng(3)
    n, m = 32, 64
    a = block_banded(m, n, bm=8, bn=8, band=1, seed=3)
    # box rows to make it bounded and feasible
    x0 = rng.normal(size=n)
    h = a @ x0 + rng.random(m) + 0.1
    c = rng.normal(size=n) * 0.1
    lay = tt.ConeLayout([tt.rpos(m)])
    p = tt.SolverParam(max_iter=200_000, eps_acc=1e-6, check_period=10)
    rd = tt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(h), lay, p)
    rs = tt.solve_jit(jnp.asarray(c),
                      tt.BlockedEllOp.from_dense(a, block=(8, 8)),
                      jnp.asarray(h), lay, p)
    assert int(rs.status) == int(rd.status)
    assert int(rs.iters) == int(rd.iters)
    np.testing.assert_allclose(np.asarray(rs.x), np.asarray(rd.x),
                               atol=1e-8)


def test_blocked_ell_tile_density():
    a = block_banded(64, 64, bm=8, bn=8, band=1, seed=4)
    op = tt.BlockedEllOp.from_dense(a, block=(8, 8))
    assert op.tile_density < 0.5   # banded: ~3/8 of the grid


def test_blocked_ell_absmax_and_diag_scale():
    """Ruiz building blocks (VERDICT r2 #3): absmax reductions and
    structure-preserving diagonal scaling match the dense oracle."""
    a = block_banded(70, 50, bm=16, bn=8, seed=4)
    op = tt.BlockedEllOp.from_dense(a, block=(16, 8))
    np.testing.assert_allclose(np.asarray(op.row_absmax()),
                               np.abs(a).max(axis=1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.col_absmax()),
                               np.abs(a).max(axis=0), atol=1e-12)
    rng = np.random.default_rng(5)
    d = jnp.asarray(rng.random(70) + 0.5)
    e = jnp.asarray(rng.random(50) + 0.5)
    scaled = op.diag_scale(d, e)
    assert isinstance(scaled, tt.BlockedEllOp)
    np.testing.assert_allclose(
        np.asarray(scaled.to_dense()),
        np.asarray(d)[:, None] * a * np.asarray(e)[None, :], atol=1e-12)


def test_blocked_ell_ruiz_matches_dense_ruiz():
    from totsu_tpu.solver.scaling import ruiz_equilibrate_op
    from totsu_tpu.solver.operator import DenseOp
    a = block_banded(64, 48, bm=16, bn=16, seed=6)
    a *= 10.0 ** np.random.default_rng(7).uniform(-2, 2, size=(64, 1))
    lay = tt.ConeLayout([tt.rpos(64)])
    b = jnp.asarray(np.random.default_rng(8).random(64))
    c = jnp.asarray(np.random.default_rng(9).random(48))
    op_e, b_e, c_e, d_e, e_e = ruiz_equilibrate_op(
        tt.BlockedEllOp.from_dense(a, block=(16, 16)), b, c, lay, 10)
    dn_e, b_d, c_d, d_d, e_d = ruiz_equilibrate_op(
        DenseOp(jnp.asarray(a)), b, c, lay, 10)
    np.testing.assert_allclose(np.asarray(d_e), np.asarray(d_d), atol=1e-12)
    np.testing.assert_allclose(np.asarray(e_e), np.asarray(e_d), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op_e.to_dense()),
                               np.asarray(dn_e.a), atol=1e-12)


def test_blocked_ell_astype_bf16_matvec_dtype():
    """Mixed-precision composition: bf16 tile storage for the update
    matvecs while criteria keep the exact operator (VERDICT r2 #3)."""
    a = block_banded(96, 48, bm=16, bn=16, seed=10)
    cast = tt.BlockedEllOp.from_dense(a, block=(16, 16)).astype(jnp.bfloat16)
    assert cast.blocks.dtype == jnp.bfloat16
    assert cast.cols.dtype == jnp.int32      # indices untouched
    rng = np.random.default_rng(11)
    x0 = rng.normal(size=48)
    h = a @ x0 + rng.random(96) + 0.1
    c = rng.normal(size=48)
    lay = tt.ConeLayout([tt.rpos(96)])
    ell32 = tt.BlockedEllOp.from_dense(a.astype(np.float32),
                                       block=(16, 16))
    p = tt.SolverParam(max_iter=300_000, eps_acc=1e-2, check_period=20,
                       accel="halpern", normalize=True,
                       matvec_dtype="bfloat16")
    r = tt.solve_jit(jnp.asarray(c, jnp.float32), ell32,
                     jnp.asarray(h, jnp.float32), lay, p)
    # the criteria use the exact f32 operator, so CONVERGED still
    # certifies the original problem at eps_acc
    assert int(r.status) == tt.SolverStatus.CONVERGED


def test_blocked_ell_pdhg_equilibrated_solve():
    """pdhg + blocked-ELL + operator Ruiz: the round-2 mutual-exclusion
    gap (equil_iters raised on non-dense operators) is closed."""
    a0 = block_banded(48, 48, bm=16, bn=16, seed=12)
    # two-sided box rows keep the LP bounded; per-row scales make Ruiz
    # actually matter
    a = np.concatenate([a0, np.eye(48), -np.eye(48)])
    a *= 10.0 ** np.random.default_rng(13).uniform(-1.5, 1.5, size=(144, 1))
    rng = np.random.default_rng(14)
    x0 = rng.normal(size=48)
    h = a @ x0 + rng.random(144) + 0.1
    c = rng.normal(size=48)
    lay = tt.ConeLayout([tt.rpos(144)])
    ell = tt.BlockedEllOp.from_dense(a, block=(16, 16))
    p = tt.SolverParam(max_iter=400_000, eps_acc=1e-6, check_period=20,
                       accel="halpern", normalize=True, equil_iters=10)
    r = tt.solve_jit(jnp.asarray(c), ell, jnp.asarray(h), lay, p)
    assert int(r.status) == tt.SolverStatus.CONVERGED
    r_ref = tt.solve_jit(jnp.asarray(c), jnp.asarray(a), jnp.asarray(h),
                         lay, p)
    np.testing.assert_allclose(
        float(np.asarray(c) @ np.asarray(r.x)),
        float(np.asarray(c) @ np.asarray(r_ref.x)), rtol=1e-4, atol=1e-4)


def test_blocked_ell_from_tiles_matches_from_dense():
    """VERDICT r4 #4: from_tiles builds the identical layout (incl. the
    transpose tile arrays) without ever materializing the dense A."""
    bm, bn = 16, 8
    a = block_banded(64, 40, bm=bm, bn=bn, seed=3)
    ref = tt.BlockedEllOp.from_dense(a, block=(bm, bn))
    # harvest the nonzero tiles of the padded grid by hand
    mp, np_ = 64, 40
    ap = np.zeros((-(-mp // bm) * bm, -(-np_ // bn) * bn))
    ap[:mp, :np_] = a
    tiles = {}
    for i in range(ap.shape[0] // bm):
        for j in range(ap.shape[1] // bn):
            t = ap[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
            if np.abs(t).sum() > 0:
                tiles[(i, j)] = t
    op = tt.BlockedEllOp.from_tiles(tiles, m=64, n=40, block=(bm, bn))
    check_operator(op)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=40))
    y = jnp.asarray(rng.normal(size=64))
    np.testing.assert_allclose(np.asarray(op.matvec(x)),
                               np.asarray(ref.matvec(x)), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.rmatvec(y)),
                               np.asarray(ref.rmatvec(y)), atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a, atol=1e-12)
    # duplicate tile coordinates sum (BSR semantics)
    t00 = next(iter(tiles.values()))
    dup = tt.BlockedEllOp.from_tiles(
        {(0, 0): t00, (0, 1): t00}, m=bm, n=2 * bn, block=(bm, bn))
    two = tt.BlockedEllOp.from_tiles(
        {(0, 0): 2.0 * t00}, m=bm, n=bn, block=(bm, bn))
    np.testing.assert_allclose(
        np.asarray(dup.matvec(jnp.ones(2 * bn))),
        np.asarray(two.matvec(jnp.ones(bn))), atol=1e-12)


def test_blocked_ell_from_bsr_matches_dense():
    import pytest
    scipy = pytest.importorskip("scipy")
    from scipy import sparse
    bm, bn = 8, 8
    a = block_banded(64, 32, bm=bm, bn=bn, seed=5)
    op = tt.BlockedEllOp.from_bsr(sparse.csr_matrix(a), block=(bm, bn))
    check_operator(op)
    np.testing.assert_allclose(np.asarray(op.to_dense()), a, atol=1e-12)
    with pytest.raises(ValueError, match="divide the shape"):
        tt.BlockedEllOp.from_bsr(sparse.csr_matrix(np.ones((10, 10))),
                                 block=(8, 8))


def test_blocked_ell_from_tiles_large_virtual_no_dense():
    """The point of from_tiles: an operator whose dense form would be
    prohibitive (here 4096^2 = 128 MB f64 — kept CPU-test-sized; the
    same constructor builds the 65,536^2 / 16 GB case from ~100 MB of
    tiles in bench.py and chip_smoke.py) built from its band tiles
    only, then solved through the routed indirect engine."""
    bm = bn = 128
    n = 4096
    rng = np.random.default_rng(7)
    nb = n // bm
    tiles = {}
    for i in range(nb):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nb:
                tiles[(i, j)] = rng.normal(size=(bm, bn)) / np.sqrt(3 * bn)
    op = tt.BlockedEllOp.from_tiles(tiles, m=n, n=n, block=(bm, bn))
    assert op.cols.shape[1] <= 3          # K = band tiles, not nb
    x0 = rng.normal(size=n)
    ax = np.asarray(op.matvec(jnp.asarray(x0)))
    # solve a small feasible banded LP through the fast profile (routes
    # to the indirect engine for non-dense operators)
    from totsu_tpu.solver.operator import VStackOp, DiagOp
    a_full = VStackOp((op, DiagOp(jnp.ones(n)), DiagOp(-jnp.ones(n))))
    b = jnp.asarray(np.concatenate([ax + rng.random(n) + 0.1,
                                    np.full(n, 10.0), np.full(n, 10.0)]))
    c = jnp.asarray(rng.normal(size=n))
    lay = tt.ConeLayout([tt.rpos(3 * n)])
    res = tt.solve(c, a_full, b, lay,
                   tt.SolverParam(max_iter=50_000, eps_acc=1e-3,
                                  profile="fast"))
    assert int(res.status) == 1


def test_from_tiles_accepts_array_likes():
    # the docstring promises array-like tiles; dtype must come from the
    # converted arrays, not a .dtype attribute on the raw dict value
    ell = tt.BlockedEllOp.from_tiles({(0, 0): [[1.0, 2.0], [3.0, 4.0]]},
                                     m=2, n=2, block=(2, 2))
    np.testing.assert_allclose(np.asarray(ell.to_dense()),
                               [[1.0, 2.0], [3.0, 4.0]])


def test_from_bsr_does_not_mutate_caller():
    from scipy import sparse as sp
    data = np.stack([np.full((2, 2), 2.0), np.full((2, 2), 1.0)])
    indices = np.array([1, 0])          # deliberately unsorted
    indptr = np.array([0, 2, 2])
    bu = sp.bsr_matrix((data, indices, indptr), shape=(4, 4))
    before = bu.indices.copy()
    ell = tt.BlockedEllOp.from_bsr(bu, block=(2, 2))
    assert (bu.indices == before).all()      # caller untouched
    np.testing.assert_allclose(np.asarray(ell.to_dense()), bu.toarray())
