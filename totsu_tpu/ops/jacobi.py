"""Batched symmetric eigendecomposition via parallel-order cyclic Jacobi.

The reference proves a plain cyclic Jacobi sweep suffices at solver
tolerances (FloatGeneric's ``jacobi_eig``, ref floatgeneric.rs:273-324,
backs its ConePSD projection). That loop rotates one off-diagonal element
at a time — O(k^2) sequential 2x2 rotations per sweep — which is the wrong
shape for a data-parallel accelerator. This module re-derives it as
elementwise work:

* a **round-robin tournament schedule** picks k/2 *disjoint* pivot pairs
  per round (k-1 rounds touch every off-diagonal pair exactly once per
  sweep — the classic parallel Jacobi ordering, Brent & Luk 1985);
* all rotations of a round combine into ONE orthogonal matrix
  ``J = diag(c) + s_row * P`` (P the partner permutation), because
  disjoint Givens rotations commute. Crucially J has exactly two nonzeros
  per row, so ``A <- J^T A J`` is NOT a matmul: it is two static
  row/column permutations plus elementwise multiply-adds —
  O(k^2 * batch) elementwise work per round instead of an O(k^3 * batch)
  matmul:

      (A J)[i, b]   = c_b A[i, b] - s_b A[i, partner[b]]
      (J^T B)[a, b] = c_a B[a, b] - s_a B[partner[a], b]

  (the minus signs use ``s[partner[r]] == -s_r``, exact in floating
  point because the Schur tangent is odd);
* per-row rotation parameters come from the classic symmetric Schur
  formulas (Golub & Van Loan 8.4): for row r with partner m,
  ``theta_r = (a_mm - a_rr) / (2 a_rm)``, ``t = sign(theta)/(|theta| +
  sqrt(theta^2+1))``, ``c = 1/sqrt(t^2+1)``, ``s = t c``. Evaluating this
  per *row* (not per pair) automatically yields the sign-correct
  ``J[q, p] = -s`` because ``t`` is odd in ``theta``.

Convergence is quadratic once sweeps localize; parallel orderings reach
f32 roundoff in ~6-10 sweeps for k <= 128 (measured). Everything is static-shape,
jit/vmap-friendly, and runs entirely on-device — the batched-eigh building
block SURVEY.md section 7 calls for (many small PSD cone blocks), exact
where the Newton-Schulz sign iteration (sympack.psd_part_ns) has an error
floor near zero eigenvalues.
"""

import functools
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=None)
def _schedule(k: int):
    """Tuple of k-1 partner-index tuples: round-robin tournament over k
    players (k even). Entry r gives each row's pivot partner in round r."""
    assert k % 2 == 0
    players = list(range(k))
    rounds = []
    for _ in range(k - 1):
        part = [0] * k
        half = k // 2
        for i in range(half):
            a, b = players[i], players[k - 1 - i]
            part[a], part[b] = b, a
        rounds.append(tuple(part))
        # rotate all but the first player
        players = [players[0]] + [players[-1]] + players[1:-1]
    return tuple(rounds)


def _round(a, v, partner, lt_sign, eps, diag_idx):
    """One parallel-Jacobi round: rotate all disjoint pairs of ``partner``.

    ``partner``: static tuple (length k, an involution); ``lt_sign``:
    static (k,) +-1 array (+1 where r < partner[r]) used as the
    antisymmetric 45-degree tie-break when diagonals are equal.
    """
    part = list(partner)
    d = a[..., diag_idx, diag_idx]                    # (..., k) a_rr
    d_part = d[..., part]                             # a_mm
    a_rm = a[..., diag_idx, part]                     # a_r,partner[r]
    # symmetric Schur; skip (identity rotation) when the pivot is ~zero
    small = jnp.abs(a_rm) <= eps * jnp.maximum(
        jnp.sqrt(jnp.abs(d) * jnp.abs(d_part)), eps)
    safe_arm = jnp.where(small, 1.0, a_rm)
    theta = (d_part - d) / (2.0 * safe_arm)
    t = jnp.sign(theta) / (jnp.abs(theta) + jnp.sqrt(theta * theta + 1.0))
    # equal-diagonal pivots need a 45-degree rotation whose sign is
    # ANTIsymmetric between the two rows of a pair (else J is singular)
    t = jnp.where(theta == 0.0, lt_sign, t)
    c = jax.lax.rsqrt(t * t + 1.0)
    s = t * c
    c = jnp.where(small, 1.0, c)
    s = jnp.where(small, 0.0, s)

    cc = c[..., None, :]
    sc = s[..., None, :]
    b1 = a * cc - a[..., :, part] * sc               # A J
    a2 = b1 * c[..., :, None] - b1[..., part, :] * s[..., :, None]  # J^T(AJ)
    # keep exactly symmetric against roundoff drift (preserves quadratic
    # convergence and the symmetric-read invariant of the next round)
    a2 = 0.5 * (a2 + jnp.swapaxes(a2, -1, -2))
    v2 = v * cc - v[..., :, part] * sc               # V J
    return a2, v2


def jacobi_eigh(a, sweeps: int = 10, eps: float = 0.0):
    """Eigendecomposition of batched symmetric matrices by parallel Jacobi.

    ``a``: (..., k, k) symmetric (only ever read symmetrically). Returns
    ``(w, v)`` with ``a ~= v @ diag(w) @ v.T`` — same contract as
    ``jnp.linalg.eigh`` except eigenvalues are NOT sorted (cone projection
    and spectral maps are order-free; sort on the host if needed).

    ``sweeps`` is static; 10 reaches f32 roundoff for k <= 128 on random
    spectra (measured; quadratic convergence — clustered spectra converge
    faster, adversarial ones may need more). Compile time grows with the
    k-1 statically unrolled rounds per sweep; prefer k <~ 200.
    ``eps`` guards the rotation against ~zero pivots using
    the reference's convergence test shape d^2 > tol*a*b
    (floatgeneric.rs:300-306); 0 uses exact zero-pivot skip only.
    """
    k = a.shape[-1]
    # exact symmetry is load-bearing: the rotation build reads the pivot
    # from both triangles and relies on s[partner[r]] == -s_r holding in
    # floating point, which needs a[p, q] == a[q, p] bit-for-bit
    a = 0.5 * (a + jnp.swapaxes(a, -1, -2))
    kp = k + (k % 2)  # pad odd orders with one decoupled zero row/col
    if kp != k:
        pad = [(0, 0)] * (a.ndim - 2) + [(0, 1), (0, 1)]
        a = jnp.pad(a, pad)
    sched = _schedule(kp)
    lt_signs = [
        jnp.asarray(np.where(np.arange(kp) < np.asarray(p), 1.0, -1.0),
                    dtype=a.dtype)
        for p in sched
    ]
    epsv = jnp.asarray(eps, dtype=a.dtype)
    diag_idx = np.arange(kp)

    def sweep(_, carry):
        acur, vcur = carry
        for p, lt in zip(sched, lt_signs):  # static unroll: kp-1 rounds
            acur, vcur = _round(acur, vcur, p, lt, epsv, diag_idx)
        return (acur, vcur)

    v0 = jnp.broadcast_to(jnp.eye(kp, dtype=a.dtype), a.shape)
    a_fin, v_fin = jax.lax.fori_loop(0, sweeps, sweep, (a, v0))
    w = a_fin[..., diag_idx, diag_idx]
    if kp != k:
        w = w[..., :k]
        v_fin = v_fin[..., :k, :k]
    return w, v_fin


def psd_part_jacobi(x, sweeps: Optional[int] = None):
    """PSD projection via :func:`jacobi_eigh`: clip negative eigenvalues,
    reconstruct. Exact (to roundoff) where psd_part_ns has a floor; all
    permute/multiply-add work where jnp.linalg.eigh is a latency-bound
    custom call. Mirrors ref ConePSD::proj's map ``e -> e if e > 0``
    (cone_psd.rs:69-76).

    ``sweeps=None`` auto-scales with the order (measured: f32 roundoff by
    sweep 8 up to k = 128 on random spectra; a safety margin covers up to
    k = 256). Beyond k = 256 an explicit count is required: the regime is
    unmeasured for convergence, and the unrolled rounds make compile time
    grow about quadratically with k, so a silent k = 512 path would
    burn minutes compiling (use method='eigh' there). Pass an explicit
    count likewise for pathological spectra.
    """
    if sweeps is None:
        k = x.shape[-1]
        if k > 256:
            raise ValueError(
                f"psd_part_jacobi auto-sweeps is unmeasured for k={k} > "
                "256; pass sweeps explicitly (or use method='eigh')")
        sweeps = 10 if k <= 128 else 14
    w, v = jacobi_eigh(x, sweeps=sweeps)
    w = jnp.maximum(w, 0.0)
    # HIGHEST: DEFAULT precision may run f32 matmuls in TF32 on the GPU
    return jnp.einsum("...ik,...k,...jk->...ij", v, w, v,
                      precision=jax.lax.Precision.HIGHEST)
