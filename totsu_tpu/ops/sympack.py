"""Packed-symmetric-matrix storage utilities.

The reference stores symmetric matrices as the upper triangle packed
column-major: for ``r <= c`` element ``(r, c)`` lives at ``c*(c+1)/2 + r``
(ref: totsu_core/src/floatgeneric.rs:187-214 SpMatIdx, matop.rs:9-40).

Two conventions appear in the reference and both are kept here:

* **plain packing** — packed entries are the literal matrix entries
  (used by ``MatBuild`` SymPack storage, e.g. the QP's P matrix).
* **scaled-vec packing** — ``vec(X) = (X11, sqrt2*X12, X22, sqrt2*X13, ...)``
  so that ``||vec(X)||_2 == ||X||_F``; used for the PSD cone and SDP data
  (ref: totsu_core/src/cone_psd.rs:13-19).

No strided packed arithmetic is done: packed vectors are expanded to dense
(k, k) matrices with a static gather (XLA lowers it to a cheap reshuffle) and
all compute is dense and batched.
"""

import functools
import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

SQRT2 = math.sqrt(2.0)


def tri_len(k: int) -> int:
    """Length of the packed upper triangle of a (k, k) symmetric matrix."""
    return k * (k + 1) // 2


def order_from_len(sn: int) -> int:
    """Invert ``tri_len``: matrix order k with k(k+1)/2 == sn.

    Mirrors the size recovery in ref cone_psd.rs:32-38.
    """
    k = (math.isqrt(8 * sn + 1) - 1) // 2
    if tri_len(k) != sn:
        raise ValueError(f"{sn} is not a triangular number")
    return k


@functools.lru_cache(maxsize=None)
def _gather_index(k: int) -> np.ndarray:
    """(k, k) int array: position of element (r, c) in the packed vector."""
    idx = np.zeros((k, k), dtype=np.int32)
    for c in range(k):
        for r in range(c + 1):
            p = c * (c + 1) // 2 + r
            idx[r, c] = p
            idx[c, r] = p
    return idx


@functools.lru_cache(maxsize=None)
def _pack_index(k: int):
    """Row/col indices of packed entries in packed (column-major) order."""
    rr = np.zeros(tri_len(k), dtype=np.int32)
    cc = np.zeros(tri_len(k), dtype=np.int32)
    p = 0
    for c in range(k):
        for r in range(c + 1):
            rr[p] = r
            cc[p] = c
            p += 1
    return rr, cc


def unpack(v, k: int, *, scaled: bool = False):
    """Packed upper-triangle vector -> dense symmetric matrix.

    ``v`` may have leading batch dims; the packed axis is the last one.
    With ``scaled=True`` the input follows the scaled-vec convention
    (off-diagonals hold sqrt2 * X_ij) and the true matrix X is returned.
    """
    idx = _gather_index(k)
    m = jnp.take(v, jnp.asarray(idx), axis=-1)
    if scaled:
        w = np.where(np.eye(k, dtype=bool), 1.0, 1.0 / SQRT2)
        m = m * jnp.asarray(w, dtype=m.dtype)
    return m


def pack(x, *, scaled: bool = False):
    """Dense symmetric matrix -> packed upper-triangle vector (col-major).

    With ``scaled=True`` produces the scaled-vec convention
    (off-diagonals multiplied by sqrt2).
    """
    k = x.shape[-1]
    rr, cc = _pack_index(k)
    v = x[..., jnp.asarray(rr), jnp.asarray(cc)]
    if scaled:
        w = np.where(rr == cc, 1.0, SQRT2)
        v = v * jnp.asarray(w, dtype=v.dtype)
    return v


def psd_part(x):
    """Project a dense symmetric matrix onto the PSD cone via eigh.

    Keeps strictly positive eigenvalues only, mirroring the reference's
    ``map_eig`` with ``e > 0`` filter (ref: cone_psd.rs:69-76,
    floatgeneric.rs:384-439). Batched over leading dims.
    """
    w, vecs = jnp.linalg.eigh(x)
    w = jnp.maximum(w, 0.0)
    # HIGHEST: DEFAULT precision may run f32 matmuls in TF32 on the GPU
    # (10-bit mantissa), costing ~1e-3 absolute error in the reconstruction
    return jnp.einsum("...ik,...k,...jk->...ij", vecs, w, vecs,
                      precision=jax.lax.Precision.HIGHEST)


@functools.lru_cache(maxsize=None)
def _ns_scaled_schedule(l0: float = 5e-6, tol: float = 1e-12,
                        max_steps: int = 40, margin: float = 1e-2):
    """Static per-step scale factors for the SCALED Newton-Schulz sign
    iteration (composite odd-polynomial filtering of sign(x), in the
    spirit of arXiv 2507.09165 / the scaled-Newton literature).

    The cubic g(y) = y (3 - y^2)/2 fixes sign but contracts slowly from
    tiny eigenvalues (|g| ~ 1.5 |y| near 0 — the plain iteration needs
    ~23 steps from 1e-5). Rescaling the iterate by s_k > 1 before each
    cubic (safe while s_k * upper <= sqrt(3), which keeps |g| <= 1 and
    the sign intact) triples the lower edge per step instead. s_k is
    chosen host-side by bisection to BALANCE the mapped interval ends,
    g(s l) = g(s u) — the greedy optimal for this family — tracking the
    exact [l, u] bracket of |eigenvalue| through the composition until
    l >= 1 - tol. From l0 = 5e-6 this takes 17 steps vs the 30 unscaled
    steps round 1 shipped, at identical ~l0 error floor (eigenvalues
    inside (0, l0) contribute <= l0/2 absolute error to max(x, 0)).

    ``margin`` caps the bisection at s <= (1 - margin) sqrt(3)/u so the
    TOP edge never maps below g((1-margin) sqrt(3)) (~0.05 at 1e-2).
    Without it the balancing drives s*u to within ~4e-6 of sqrt(3)
    (where g = 0) on the first step, and f32 matmul rounding (~1e-7 of
    block scale) becomes ~1% RELATIVE error on the dominant eigenvalue —
    measured 1.7e-3 projection error on rank-1 f32 blocks (exactly the
    near-convergence SDP iterate shape). With margin=1e-2 the measured
    f32 error is 8e-7 (rank-1) / 4e-6 (random spectra) at the same 17
    steps.
    """

    def g(y):
        return y * (3.0 - y * y) / 2.0

    l, u = float(l0), 1.0
    scales = []
    while l < 1.0 - tol and len(scales) < max_steps:
        lo, hi = 1.0, (1.0 - margin) * np.sqrt(3.0) / u
        for _ in range(80):   # bisect on g(s u) - g(s l) (decreasing in s)
            mid = 0.5 * (lo + hi)
            if g(mid * u) > g(mid * l):
                lo = mid
            else:
                hi = mid
        s = 0.5 * (lo + hi)
        ends = (g(s * l), g(s * u))
        peak = 1.0 if (s * l <= 1.0 <= s * u) else max(ends)
        l, u = min(ends), min(peak, 1.0)
        scales.append(s)
    return tuple(scales)


def psd_part_ns(x, iters: Optional[int] = None):
    """PSD projection via the SCALED Newton-Schulz matrix-sign iteration —
    pure batched matmuls, no eigendecomposition.

        X+ = (X + |X|)/2,   |X| = X sign(X),
        S_0 = X/||X||_F,    S_{k+1} = (s_k S_k)(3I - (s_k S_k)^2)/2

    with the static scale schedule of :func:`_ns_scaled_schedule` (17
    composite cubic steps reach machine precision on clean spectra where
    30 unscaled steps were needed in round 1 — ~2x fewer matmuls). The
    matmul-only alternative to :func:`psd_part` for the inner-loop PSD
    cone projection, where small/medium ``eigh`` is latency-bound.
    Projection error floor ~5e-6 of the block scale, ample for
    eps_acc >= 1e-4 solves. Batched over leading dims.

    ``iters`` (optional) runs that many UNSCALED steps instead — the
    round-1 behavior, kept for A/B comparison.
    """
    norm = jnp.sqrt(jnp.sum(x * x, axis=(-2, -1), keepdims=True))
    safe = jnp.where(norm > 0, norm, 1.0)
    s = x / safe
    hi = jax.lax.Precision.HIGHEST  # no TF32 rounding on the GPU
    scales = ((1.0,) * iters) if iters is not None else _ns_scaled_schedule()
    for sc in scales:
        y = s * jnp.asarray(sc, dtype=s.dtype)
        y2 = jnp.matmul(y, y, precision=hi)
        s = 0.5 * (3.0 * y - jnp.matmul(y, y2, precision=hi))
    # symmetrize |X| = X @ sign(X) against drift
    ax = jnp.matmul(x, s, precision=hi)
    ax = 0.5 * (ax + jnp.swapaxes(ax, -1, -2))
    return 0.5 * (x + ax)


def psd_sqrt(x, eps_zero: float = 0.0):
    """Symmetric PSD square root X -> X^(1/2) via eigh.

    Eigenvalues <= 0 are dropped, mirroring ``MatBuild::set_sqrt``
    (ref: totsu/src/matbuild/mod.rs:220-247: map e -> sqrt(e) for e > 0).
    Batched over leading dims.
    """
    w, vecs = jnp.linalg.eigh(x)
    sw = jnp.sqrt(jnp.maximum(w, 0.0))
    return jnp.einsum("...ik,...k,...jk->...ij", vecs, sw, vecs,
                      precision=jax.lax.Precision.HIGHEST)


def proj_psd_packed(v, *, scaled: bool = True, method: str = "eigh"):
    """PSD-cone projection of packed symmetric vectors (batched).

    ``v``: (..., k(k+1)/2) in the scaled-vec convention by default.
    Equivalent to ref ConePSD::proj (cone_psd.rs:56-77): unpack, clip
    negative eigenvalues, repack — but as one fused jitted expression
    with no host round-trip (the CUDA backend's eigenvalue host-sync at
    f32cuda.rs:376-378 is the design wart this avoids).

    ``method``: 'eigh' (exact, XLA custom call), 'ns' (Newton-Schulz
    matrix sign — matmul-only, ~5e-6 error
    floor; see :func:`psd_part_ns`), or 'jacobi' (parallel-order Jacobi —
    matmul-only AND exact; batched-friendly; see
    :func:`totsu_tpu.ops.jacobi.jacobi_eigh`).
    """
    k = order_from_len(v.shape[-1])
    x = unpack(v, k, scaled=scaled)
    if method == "ns":
        part = psd_part_ns(x)
    elif method == "jacobi":
        from totsu_tpu.ops.jacobi import psd_part_jacobi
        part = psd_part_jacobi(x)
    elif method == "eigh" or not method:
        part = psd_part(x)
    else:
        raise ValueError(f"unknown PSD projection method {method!r}")
    return pack(part, scaled=scaled)
