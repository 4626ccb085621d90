"""Cones as pure projection functions over a static product layout.

The reference expresses a cone K as a trait with two methods
(ref: totsu_core/src/solver/cone.rs:9-30):

* ``proj(dual_cone, x)`` — Euclidean projection of a slack segment in place;
* ``product_group(dp_tau, group)`` — apply a grouping closure to each cone
  factor's diagonal-preconditioner block (non-separable cones must share one
  isotropic scale; ref book/src/combine.md).

Here a cone is **static metadata** (a :class:`ConeLayout` of factors, plain
Python) plus **pure functions** over the concatenated slack vector. Sizes are
static, so slicing is free at trace time, and runs of equal-size blocks are
projected batched (reshape + vmapped math) — the data-parallel equivalent of the
reference's per-block Rust loops (e.g. ProbQCQPCone qcqp.rs:304-349).

Factor kinds and their projections (primal cone; ``dual=True`` gives the dual
cone, which differs only for the zero cone):

========  =====================================================================
zero      {0}^n; primal -> 0, dual -> identity (ref cone_zero.rs:36-50)
rpos      R+^n; elementwise max(x, 0); self-dual (ref cone_rpos.rs:36-51)
soc       {(s, v) : ||v|| <= s}; 3-case projection; self-dual
          (ref cone_soc.rs:36-71)
rsoc      {x3^2+... <= 2 x1 x2, x1,x2 >= 0}; Givens-rotate into soc
          (ref cone_rotsoc.rs:36-71)
psd       vec(S+^k) in the scaled-vec convention; eigh + clip
          (ref cone_psd.rs:20-85)
========  =====================================================================
"""

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from totsu_tpu.ops import sympack

ZERO = "zero"
RPOS = "rpos"
SOC = "soc"
RSOC = "rsoc"
PSD = "psd"
EXP = "exp"
POW = "pow"
CUSTOM = "custom"

# factors needing per-block preconditioner grouping
_GROUPED = (SOC, RSOC, PSD, EXP, POW)


@dataclasses.dataclass(frozen=True)
class Factor:
    """``count`` consecutive blocks of ``dim`` slack elements each.

    ``variant`` selects a projection algorithm where more than one exists
    (PSD: 'eigh' exact, 'ns' Newton-Schulz matmul-only, 'jacobi'
    parallel-order Jacobi matmul-only+exact). ``proj`` /
    ``dual_proj`` / ``grouped`` belong to :func:`custom` factors only; the
    callables are static metadata (jit cache keys by identity), never traced
    values."""
    kind: str
    dim: int
    count: int = 1
    variant: str = ""
    proj: Optional[Callable] = None
    dual_proj: Optional[Callable] = None
    grouped: bool = True
    alpha: float = 0.0  # power-cone exponent (POW factors only)

    @property
    def total(self) -> int:
        return self.dim * self.count

    @property
    def needs_group(self) -> bool:
        """True when diagonal scalings must be uniform within each block of
        this factor for the cone to stay invariant (ref Cone::product_group
        semantics) — the single predicate shared by the preconditioner
        grouping (:meth:`ConeLayout.group_min`) and Ruiz equilibration
        (solver/scaling.py)."""
        return self.kind in _GROUPED or (self.kind == CUSTOM and self.grouped)


def zero(n: int) -> Factor:
    return Factor(ZERO, n)


def rpos(n: int) -> Factor:
    return Factor(RPOS, n)


def soc(dim: int, count: int = 1) -> Factor:
    """``count`` second-order cone blocks, each of total length ``dim``
    (1 radius element + dim-1 vector elements)."""
    return Factor(SOC, dim, count)


def rsoc(dim: int, count: int = 1) -> Factor:
    """Rotated second-order cone blocks of total length ``dim``."""
    return Factor(RSOC, dim, count)


def psd(k: int, count: int = 1, method: str = "auto") -> Factor:
    """PSD cone blocks vec(S+^k), each of packed length k(k+1)/2.

    ``method='ns'`` uses the Newton-Schulz matrix-sign projection
    (matmul-only, ~5e-6 error floor);
    ``method='jacobi'`` uses the parallel-order Jacobi eigendecomposition
    (matmul-only AND exact; see totsu_tpu.ops.jacobi).

    ``method='auto'`` (default) picks per solve from (k, count, profile,
    eps_acc) by the policy in :func:`resolve_auto_methods`: exact 'eigh'
    everywhere under the reference profile, 'ns' under ``profile='fast'``
    at tolerances its ~5e-6 error floor cannot disturb, 'jacobi' for many
    small blocks."""
    if method not in ("auto", "eigh", "ns", "jacobi"):
        raise ValueError(f"unknown PSD projection method {method!r}; "
                         "expected 'auto', 'eigh', 'ns' or 'jacobi'")
    return Factor(PSD, sympack.tri_len(k), count, variant=method)


def expc(count: int = 1) -> Factor:
    """``count`` exponential-cone blocks (x, y, z) of length 3 each,

        K_exp = cl{ (x, y, z) : y e^{x/y} <= z, y > 0 }
              = { y > 0, y e^{x/y} <= z } U { x <= 0, y = 0, z >= 0 }.

    **Beyond the reference surface** (Totsu stops at zero/R+/SOC/RSOC/PSD):
    the exponential cone admits entropy / log-sum-exp / logistic /
    geometric-programming constraints. The dual cone

        K* = cl{ (u, v, w) : -u e^{v/u} <= e w, u < 0 }

    is not self-dual; its projection is derived via the Moreau
    decomposition proj_{K*}(x) = x + proj_K(-x). The primal projection is
    a branch-free batched bisection on a univariate root problem (see
    :func:`_proj_exp_blocks`) — fixed trip count, no data-dependent
    control flow."""
    return Factor(EXP, 3, count)


def powc(alpha: float, count: int = 1) -> Factor:
    """``count`` three-dimensional power-cone blocks (x, y, z) of

        K_pow(a) = { (x, y, z) : x^a y^(1-a) >= |z|,  x, y >= 0 },
        0 < a < 1.

    **Beyond the reference surface** (like :func:`expc`): power cones
    admit p-norm, geometric-mean and entropy-like constraints. The dual

        K* = { (u, v, w) : (u/a)^a (v/(1-a))^(1-a) >= |w|,  u, v >= 0 }

    is not self-dual; its projection is derived via the Moreau
    decomposition. The primal projection reduces to a univariate root
    problem on r = |z_proj| in (0, |z0|) (Hien, "Differential properties
    of Euclidean projection onto power cone", Math. Meth. OR 2015 --
    the same reduction SCS uses), solved by fixed-trip branch-free
    bisection (see :func:`_proj_pow_blocks`) -- vmappable, no
    data-dependent control flow."""
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"power cone exponent must be in (0, 1), "
                         f"got {alpha}")
    return Factor(POW, 3, count, alpha=float(alpha))


def custom(dim: int, proj: Callable, count: int = 1, *,
           dual_proj: Optional[Callable] = None, grouped: bool = True,
           name: str = "custom") -> Factor:
    """User-defined cone factor — the analogue of implementing the
    reference's public ``Cone`` trait (ref cone.rs:9-30; exercised by the
    custom ``ProbCone`` of examples/imgnr_udef/src/prob_cone.rs:8-47).

    ``proj(blocks)`` is the Euclidean projection onto the *primal* cone K,
    mapping a ``(count, dim)`` array of slack blocks to its projection;
    it must be pure and jit-traceable. The projection onto the dual cone
    K* is derived automatically via the Moreau decomposition

        proj_{K*}(x) = x + proj_K(-x),

    which is exact for any nonempty closed convex cone; pass ``dual_proj``
    to override (e.g. when a cheaper closed form exists — for self-dual
    cones simply pass the same function).

    ``grouped=False`` marks the cone as separable per-element, letting the
    diagonal preconditioner keep per-element scales; the default groups
    each block to one isotropic scale (min over the block), which is the
    safe choice for any projection that is only invariant under isotropic
    scaling (ref Cone::product_group, book/src/combine.md).
    """
    return Factor(CUSTOM, dim, count, variant=name, proj=proj,
                  dual_proj=dual_proj, grouped=grouped)


def _proj_soc_blocks(xb):
    """Batched SOC projection. xb: (count, d) with xb[:, 0] the radius.

    Standard 3-case projection (ref cone_soc.rs:44-66):
      ||v|| <= -s  ->  0
      ||v|| <=  s  ->  unchanged
      otherwise    ->  ((||v||+s)/2, alpha*v),  alpha = (1 + s/||v||)/2
    Works for d == 1 (empty v, reduces to max(s, 0)).
    """
    s = xb[:, :1]
    v = xb[:, 1:]
    nv = jnp.linalg.norm(v, axis=1, keepdims=True)
    safe_nv = jnp.where(nv > 0, nv, 1.0)
    alpha = (1.0 + s / safe_nv) * 0.5
    out_v = jnp.where(nv <= -s, 0.0, jnp.where(nv <= s, v, alpha * v))
    out_s = jnp.where(nv <= -s, 0.0, jnp.where(nv <= s, s, (nv + s) * 0.5))
    return jnp.concatenate([out_s, out_v], axis=1)


_INV_SQRT2 = 1.0 / sympack.SQRT2


def _proj_rsoc_blocks(xb):
    """Batched rotated-SOC projection: rotate first two coords by the
    involutive Givens map (r, s) -> ((r+s)/sqrt2, (r-s)/sqrt2), project onto
    SOC, rotate back (ref cone_rotsoc.rs:44-66). d == 1 -> max(x, 0)."""
    if xb.shape[1] == 1:
        return jnp.maximum(xb, 0.0)

    def rot(z):
        r = (z[:, :1] + z[:, 1:2]) * _INV_SQRT2
        s = (z[:, :1] - z[:, 1:2]) * _INV_SQRT2
        return jnp.concatenate([r, s, z[:, 2:]], axis=1)

    return rot(_proj_soc_blocks(rot(xb)))


def _proj_exp_rst(r0, s0, t0):
    """Elementwise exponential-cone projection core: maps same-shaped
    arrays (r0, s0, t0) — each element an independent block — to the
    projected (r, s, t). Shape-agnostic (no cross-element ops), so any
    batching of the blocks can share this one implementation.

    Following Friberg
    ("Projection onto the exponential cone: a univariate root-finding
    problem", Optim. Letters 2023), the non-trivial case reduces to the
    root of a strictly increasing scalar function: the projection lies on
    the smooth boundary t = s e^{rho} with rho = r/s, and eliminating the
    multiplier from the KKT system leaves

        h(rho) = [((rho-1) r0 + s0) e^rho - (r0 - rho s0) e^{-rho}]
                 / (rho^2 - rho + 1)  -  t0 = 0

    on the bracket where s(rho) = ((rho-1) r0 + s0)/(rho^2-rho+1) > 0 and
    lambda(rho) = (r0 - rho s0) e^{-rho}/(rho^2-rho+1) > 0. Implemented as
    fixed-trip bracket expansion + a safeguarded Newton-bisection hybrid
    on an overflow-safe rescaling of h (multiplied by
    e^{-|rho|}(rho^2-rho+1) > 0, sign- and root-preserving) —
    branch-free, vmappable, elementwise only.

    Trivial cases (exact, mask-selected):
      v0 in K                -> v0
      v0 in K° (polar)       -> 0
      r0 <= 0 and s0 <= 0    -> (r0, 0, max(t0, 0))
    """
    dt = r0.dtype
    e = jnp.asarray(jnp.e, dt)

    safe_s = jnp.where(s0 != 0, s0, 1.0)
    safe_r = jnp.where(r0 != 0, r0, 1.0)
    in_cone = ((s0 > 0) & (s0 * jnp.exp(r0 / safe_s) <= t0)) | \
              ((s0 == 0) & (r0 <= 0) & (t0 >= 0))
    in_polar = ((r0 > 0) & (r0 * jnp.exp(s0 / safe_r) <= -e * t0)) | \
               ((r0 == 0) & (s0 <= 0) & (t0 <= 0))
    neg_quad = (r0 <= 0) & (s0 <= 0)

    def hval_grad(rho):
        # h rescaled by e^{-|rho|} (rho^2 - rho + 1) > 0 (sign- and
        # root-preserving): every term bounded, so bracket expansion can
        # push rho to +-2^40 without inf-inf NaNs. Returns (value, d/drho)
        # of the rescaled function for the Newton-bisection hybrid.
        num1 = (rho - 1.0) * r0 + s0          # coefficient of e^{rho}
        num2 = r0 - rho * s0                  # coefficient of e^{-rho}
        den = rho * (rho - 1.0) + 1.0         # > 0 for all rho
        denp = 2.0 * rho - 1.0
        e2n, e1n = jnp.exp(-2.0 * rho), jnp.exp(-rho)
        e2p, e1p = jnp.exp(2.0 * rho), jnp.exp(rho)
        pos = num1 - num2 * e2n - t0 * den * e1n
        pos_g = r0 + (s0 + 2.0 * num2) * e2n - t0 * (denp - den) * e1n
        neg = num1 * e2p - num2 - t0 * den * e1p
        neg_g = (r0 + 2.0 * num1) * e2p + s0 - t0 * (denp + den) * e1p
        take_pos = rho >= 0
        return (jnp.where(take_pos, pos, neg),
                jnp.where(take_pos, pos_g, neg_g))

    def hsign(rho):
        return hval_grad(rho)[0]

    # bracket from the validity constraints s(rho) > 0, lambda(rho) > 0:
    #   r0 > 0 -> rho > 1 - s0/r0        r0 < 0 -> rho < 1 - s0/r0
    #   s0 < 0 -> rho > r0/s0            s0 > 0 -> rho < r0/s0
    inf = jnp.asarray(jnp.inf, dt)
    lo = jnp.maximum(jnp.where(r0 > 0, 1.0 - s0 / safe_r, -inf),
                     jnp.where(s0 < 0, r0 / safe_s, -inf))
    hi = jnp.minimum(jnp.where(r0 < 0, 1.0 - s0 / safe_r, inf),
                     jnp.where(s0 > 0, r0 / safe_s, inf))
    # expand the (at most one) infinite end by doubling until h changes sign
    def expand(_, lh):
        lo_f, hi_f = lh
        hi_f = jnp.where(jnp.isinf(hi) & (hsign(hi_f) < 0),
                         lo_f + 2.0 * (hi_f - lo_f), hi_f)
        lo_f = jnp.where(jnp.isinf(lo) & (hsign(lo_f) > 0),
                         hi_f + 2.0 * (lo_f - hi_f), lo_f)
        return lo_f, hi_f

    lo_f, hi_f = jax.lax.fori_loop(
        0, 40, expand, (jnp.where(jnp.isfinite(lo), lo, hi - 1.0),
                        jnp.where(jnp.isfinite(hi), hi, lo + 1.0)))

    def hybrid(_, state):
        # safeguarded Newton (rtsafe-style): the sign at the current point
        # shrinks the bracket exactly like bisection; the next point is the
        # Newton step when it lands strictly inside the bracket, else the
        # midpoint — worst case equals bisection, smooth case is quadratic.
        lo_f, hi_f, r = state
        v, g = hval_grad(r)
        neg_mask = v < 0                      # h increasing: root above r
        lo_f = jnp.where(neg_mask, r, lo_f)
        hi_f = jnp.where(neg_mask, hi_f, r)
        nxt = r - v / jnp.where(g != 0, g, 1.0)
        # accept strictly-inside Newton points; ALSO keep r when the step
        # rounds to zero (nxt == r: converged to the last ULP — without
        # this, the == endpoint fails the strict test and the iterate gets
        # thrown back to the midpoint of a stale one-sided bracket)
        ok = jnp.isfinite(nxt) & (g != 0) & \
            (((nxt > lo_f) & (nxt < hi_f)) | (nxt == r))
        return lo_f, hi_f, jnp.where(ok, nxt, 0.5 * (lo_f + hi_f))

    # the Newton tail reaches roundoff in ~3 trips once localized; the
    # trip counts below hold a margin over the measured worst case on the
    # adversarial suite (tests/test_cones.py Moreau-optimality tests),
    # replacing 64 (f32) / 110 (f64) pure-bisection trips (the old f64
    # count was saturated anyway: a bisection midpoint stops moving after
    # ~53 halvings of the mantissa)
    n_trips = 38 if dt == jnp.float64 else 26
    lo_f, hi_f, rho = jax.lax.fori_loop(
        0, n_trips, hybrid, (lo_f, hi_f, 0.5 * (lo_f + hi_f)))
    den = rho * (rho - 1.0) + 1.0
    s = jnp.maximum(((rho - 1.0) * r0 + s0) / den, 0.0)
    # t: two algebraically equal forms, each catastrophically
    # ill-conditioned at one end of the rho range and damped at the other —
    # boundary form s e^{rho} blows up for rho >> 0 (d/drho ~ r0 e^rho),
    # KKT form t0 + lambda(rho) blows up for rho << 0 (lambda carries
    # e^{-rho}); select the damped one by sign(rho)
    t_kkt = t0 + (r0 - rho * s0) * jnp.exp(-jnp.maximum(rho, 0.0)) / den
    t = jnp.maximum(jnp.where(rho >= 0, t_kkt, s * jnp.exp(rho)), 0.0)

    # select per component: root -> neg-quadrant -> polar -> in-cone
    zero = jnp.zeros_like(r0)
    out_r = jnp.where(neg_quad, r0, rho * s)
    out_s = jnp.where(neg_quad, zero, s)
    out_t = jnp.where(neg_quad, jnp.maximum(t0, 0.0), t)
    out_r = jnp.where(in_polar, zero, out_r)
    out_s = jnp.where(in_polar, zero, out_s)
    out_t = jnp.where(in_polar, zero, out_t)
    return (jnp.where(in_cone, r0, out_r),
            jnp.where(in_cone, s0, out_s),
            jnp.where(in_cone, t0, out_t))


def _proj_exp_blocks(xb):
    """Batched exp-cone projection over (count, 3) blocks (the solver's
    slack-segment layout); the math lives in :func:`_proj_exp_rst`."""
    r, s, t = _proj_exp_rst(xb[:, 0], xb[:, 1], xb[:, 2])
    return jnp.stack([r, s, t], axis=1)


def _proj_pow_rst(x0, y0, z0, alpha):
    """Elementwise power-cone projection core: same-shaped arrays
    (x0, y0, z0), each element an independent block; ``alpha`` is a
    static float or a broadcastable array (per-element exponents). Used
    by the blocked path below.

    The
    non-trivial case (v0 outside K and its polar -K*) projects onto the
    smooth boundary x^a y^(1-a) = |z|: eliminating the KKT multiplier
    (Hien 2015, prop. 2.2) leaves a scalar root problem on r = |z_proj|,

        x(r) = (x0 + sqrt(x0^2 + 4 a r (|z0| - r))) / 2
        y(r) = (y0 + sqrt(y0^2 + 4 (1-a) r (|z0| - r))) / 2
        Phi(r) = x(r)^a y(r)^(1-a) - r = 0,   r in (0, |z0|),

    with Phi > 0 at 0+ (v0 not in polar) and Phi(|z0|) < 0 (v0 not in K).
    Solved by a fixed-trip safeguarded Newton-bisection hybrid with the
    sign test in log domain (a log x + (1-a) log y vs log r) --
    branch-free, vmappable. Blocks
    are pre-normalized by their max-abs (projections onto cones are
    positively homogeneous), so no overflow for extreme inputs."""
    a = alpha
    dt = x0.dtype
    scl = jnp.maximum(jnp.maximum(jnp.abs(x0), jnp.abs(y0)),
                      jnp.maximum(jnp.abs(z0), jnp.asarray(1e-30, dt)))
    x0, y0, z0 = x0 / scl, y0 / scl, z0 / scl
    az = jnp.abs(z0)
    tiny = jnp.asarray(1e-38 if dt == jnp.float32 else 1e-300, dt)

    def pow_val(x, y):
        """x^a y^(1-a) for x, y >= 0 (0 when either is 0)."""
        v = jnp.exp(a * jnp.log(jnp.maximum(x, tiny))
                    + (1.0 - a) * jnp.log(jnp.maximum(y, tiny)))
        return jnp.where((x > 0) & (y > 0), v, 0.0)

    in_cone = (x0 >= 0) & (y0 >= 0) & (pow_val(x0, y0) >= az)
    in_polar = (x0 <= 0) & (y0 <= 0) & \
        (pow_val(-x0 / a, -y0 / (1.0 - a)) >= az)
    z_zero = az == 0

    def half_quad(w0, coef, q):
        """Stable (w0 + sqrt(w0^2 + 4 c q)) / 2: for w0 < 0 the direct form
        cancels catastrophically at small q; use the conjugate 2cq/(s-w0)."""
        s = jnp.sqrt(w0 * w0 + 4.0 * coef * q)
        return jnp.where(w0 >= 0, 0.5 * (w0 + s),
                         2.0 * coef * q / jnp.maximum(s - w0, tiny))

    def xy(r):
        q = r * (az - r)
        return half_quad(x0, a, q), half_quad(y0, 1.0 - a, q)

    def phi_and_grad(r):
        """Log-domain phi = a log x(r) + (1-a) log y(r) - log r and its
        derivative a^2 q'/(x sx) + (1-a)^2 q'/(y sy) - 1/r, where
        sx = sqrt(x0^2 + 4 a q), q = r(|z0| - r), q' = |z0| - 2r and
        x'(r) = a q'/sx (chain rule through the quadratic root)."""
        q = r * (az - r)
        qp = az - 2.0 * r
        sx = jnp.sqrt(x0 * x0 + 4.0 * a * q)
        sy = jnp.sqrt(y0 * y0 + 4.0 * (1.0 - a) * q)
        xr, yr = xy(r)
        v = (a * jnp.log(jnp.maximum(xr, tiny))
             + (1.0 - a) * jnp.log(jnp.maximum(yr, tiny))
             - jnp.log(jnp.maximum(r, tiny)))
        g = (a * a * qp / jnp.maximum(xr * sx, tiny)
             + (1.0 - a) * (1.0 - a) * qp / jnp.maximum(yr * sy, tiny)
             - 1.0 / jnp.maximum(r, tiny))
        return v, g

    # safeguarded Newton-bisection on (0, |z0|): sign shrinks the bracket
    # like bisection, the Newton step is taken when strictly inside.
    # Unlike the exp cone, the trip counts here must preserve the FULL
    # bisection guarantee (f32: ~24 mantissa halvings + margin, f64: ~53):
    # when the root sits at the |z0| endpoint (re-projecting a boundary
    # point with tiny y at extreme alpha) the sqrt singularity of y(r)
    # amplifies an r-error of eps*|z0| to a y-error of ~sqrt(eps)*|z0|,
    # and Newton's quadratic basin shrinks to nothing — measured by the
    # idempotency case in tests/test_cones.py (a=0.9, y~1e-5). The old
    # 64/110 pure-bisection counts were saturated past the mantissa; these
    # match their worst case and add the exact Newton tail elsewhere.
    n_trips = 54 if dt == jnp.float64 else 28

    def step(_, state):
        lo, hi, r = state
        v, g = phi_and_grad(r)
        pos = v > 0                           # phi decreasing: root above
        lo = jnp.where(pos, r, lo)
        hi = jnp.where(pos, hi, r)
        nxt = r - v / jnp.where(g != 0, g, 1.0)
        # keep r when the Newton step rounds to zero (converged to the
        # last ULP) — see the matching comment in _proj_exp_blocks
        ok = jnp.isfinite(nxt) & (g != 0) & \
            (((nxt > lo) & (nxt < hi)) | (nxt == r))
        return lo, hi, jnp.where(ok, nxt, 0.5 * (lo + hi))

    lo, hi, r = jax.lax.fori_loop(
        0, n_trips, step, (jnp.zeros_like(az), az, 0.5 * az))
    xr, yr = xy(r)

    # select per component: root -> z=0 quadrant -> polar -> in-cone
    zero = jnp.zeros_like(x0)
    out_x = jnp.where(z_zero, jnp.maximum(x0, 0.0), xr)
    out_y = jnp.where(z_zero, jnp.maximum(y0, 0.0), yr)
    out_z = jnp.where(z_zero, zero, jnp.sign(z0) * r)
    out_x = jnp.where(in_polar, zero, out_x)
    out_y = jnp.where(in_polar, zero, out_y)
    out_z = jnp.where(in_polar, zero, out_z)
    return (jnp.where(in_cone, x0, out_x) * scl,
            jnp.where(in_cone, y0, out_y) * scl,
            jnp.where(in_cone, z0, out_z) * scl)


def _proj_pow_blocks(xb, alpha):
    """Batched power-cone projection over (count, 3) blocks; the math
    lives in :func:`_proj_pow_rst`."""
    x, y, z = _proj_pow_rst(xb[:, 0], xb[:, 1], xb[:, 2], alpha)
    return jnp.stack([x, y, z], axis=1)


def _project_factor(f: Factor, seg, dual: bool):
    if f.total == 0:
        return seg
    if f.kind == ZERO:
        return seg if dual else jnp.zeros_like(seg)
    if f.kind == RPOS:
        return jnp.maximum(seg, 0.0)
    blocks = seg.reshape(f.count, f.dim)
    if f.kind == SOC:
        out = _proj_soc_blocks(blocks)
    elif f.kind == RSOC:
        out = _proj_rsoc_blocks(blocks)
    elif f.kind == PSD:
        out = sympack.proj_psd_packed(
            blocks, scaled=True,
            # an 'auto' factor projected outside a solve (no param to
            # resolve against, e.g. direct ConeLayout.project calls) uses
            # the exact default; solve_jit resolves 'auto' at entry
            method="eigh" if f.variant in ("", "auto") else f.variant)
    elif f.kind == EXP:
        # not self-dual: Moreau decomposition proj_{K*}(x) = x + proj_K(-x)
        out = (blocks + _proj_exp_blocks(-blocks) if dual
               else _proj_exp_blocks(blocks))
    elif f.kind == POW:
        out = (blocks + _proj_pow_blocks(-blocks, f.alpha) if dual
               else _proj_pow_blocks(blocks, f.alpha))
    elif f.kind == CUSTOM:
        if dual:
            out = (f.dual_proj(blocks) if f.dual_proj is not None
                   else blocks + f.proj(-blocks))  # Moreau decomposition
        else:
            out = f.proj(blocks)
    else:
        raise ValueError(f"unknown cone kind {f.kind!r}")
    return out.reshape(f.total)


@dataclasses.dataclass(frozen=True)
class ConeLayout:
    """A product cone: ordered factors over a concatenated slack vector."""
    factors: Tuple[Factor, ...]

    def __init__(self, factors):
        object.__setattr__(self, "factors", tuple(factors))

    @property
    def dim(self) -> int:
        return sum(f.total for f in self.factors)

    def project(self, x, dual: bool):
        """Euclidean projection of the full slack vector onto K (or K*).

        Pure and jit-traceable; equivalent of Cone::proj over the product
        (ref cone.rs:9-21 and the Prob*Cone splits, e.g. lp.rs:190-218).
        """
        segs = []
        off = 0
        for f in self.factors:
            segs.append(_project_factor(f, x[off:off + f.total], dual))
            off += f.total
        if not segs:
            return x
        return jnp.concatenate(segs) if len(segs) > 1 else segs[0]

    def group_reduce(self, t, reduce_fn):
        """Replace each block of every ``needs_group`` factor of ``t`` by
        ``reduce_fn`` over the block — the single grouping walk shared by
        the preconditioner (min, ref Cone::product_group + solver.rs:509-523)
        and Ruiz equilibration (max, solver/scaling.py)."""
        segs = []
        off = 0
        for f in self.factors:
            seg = t[off:off + f.total]
            if f.needs_group and f.total > 0:
                blocks = seg.reshape(f.count, f.dim)
                seg = jnp.broadcast_to(
                    reduce_fn(blocks, axis=1, keepdims=True), blocks.shape
                ).reshape(f.total)
            segs.append(seg)
            off += f.total
        if not segs:
            return t
        return jnp.concatenate(segs) if len(segs) > 1 else segs[0]

    def group_min(self, t):
        """Preconditioner grouping (see :meth:`group_reduce`)."""
        return self.group_reduce(t, jnp.min)


def resolve_auto_methods(layout: "ConeLayout", param) -> "ConeLayout":
    """Resolve ``psd(..., method='auto')`` factors to a concrete projection
    algorithm for one solve. Called at solve entry (conic.solve_jit) with
    the ORIGINAL param (before fast-profile expansion rewrites ``profile``).

    Policy (benchmarks/benchmark_sdp.py measures the three methods). The
    crossovers below were calibrated on the hardware this solver was
    first built for and are inherited unmeasured on the H100, where
    ``eigh`` lowers to cuSOLVER (ROADMAP Speed 6):

    * ``profile='fast'`` and ``eps_acc >= 1e-4`` and ``k >= 16``: **'ns'**
      — Newton-Schulz is matmul-only, and its ~5e-6 relative error floor
      sits far below these tolerances.
    * exact required (reference profile or tight eps_acc): **'jacobi'**
      only for many small blocks (k <= 16 and count >= 64, where one
      batched eigh call per block is latency-bound, and where jacobi's
      unrolled rounds still compile quickly), else **'eigh'** — large
      orders stay on eigh/ns, never jacobi.
    """
    if not any(f.kind == PSD and f.variant == "auto" for f in layout.factors):
        return layout
    fast = (getattr(param, "profile", "reference") == "fast"
            and param.eps_acc >= 1e-4)
    out = []
    for f in layout.factors:
        if f.kind == PSD and f.variant == "auto":
            k = sympack.order_from_len(f.dim)
            if fast and k >= 16:
                v = "ns"
            elif k <= 16 and f.count >= 64:
                v = "jacobi"
            else:
                v = "eigh"
            f = dataclasses.replace(f, variant=v)
        out.append(f)
    return ConeLayout(out)
