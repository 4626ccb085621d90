"""Direct (ADMM / SCS-style) solve of the homogeneous self-dual embedding.

The reference iterates the HSDE with the matrix-free Pock-Chambolle method
(totsu_core solver.rs; our conic.py — ``method='pdhg'``). This module adds
the O'Donoghue et al. (SCS) ADMM splitting of the *same* embedding, which
trades a one-time dense factorization for iteration counts that are
typically two to three orders of magnitude smaller:

    u~  <- (I + Q)^{-1} (u + v)            (cached linear solve)
    u   <- Pi_C(u~ - v)                    (cone projection)
    v   <- v - u~ + u

with Q = [[0, A^T, c], [-A, 0, b], [-c^T, -b^T, 0]] and
C = R^n x K* x R+ over the variable u = (x, y, tau).

The linear solve reduces to a cached SPD n x n inverse (from a Cholesky
factorization) via block elimination + Sherman-Morrison on the (c, b)
border:

    M = [[I, A^T], [-A, I]],   h = (c, b)
    M z = r  <=>  (I + A^T A) z1 = r1 - A^T r2,  z2 = r2 + A z1
    (I+Q) solve = M-solve + rank-1 correction with g = M^{-1} h

Per iteration: one (n x n) GEMV with the cached inverse + two A GEMVs +
projections — the same memory-bound profile as the PDHG path, but
converging in hundreds to thousands of iterations. This is a
capability the reference does not have; termination uses the reference's
exact criteria (solver.rs:573-656) so statuses are comparable.

**Indirect mode** (VERDICT r2 #4; SCS's "indirect" linear-system mode):
for any non-dense :class:`LinOp` — blocked-ELL, stacked, matrix-free —
the SPD solve runs warm-started conjugate gradient on z + A^T(A z)
instead of a cached inverse. The previous iteration's CG solution is
threaded through the DR loop as the next initial guess, so once DR
approaches its fixed point each resolvent costs only a handful of CG
steps (the rhs barely moves). This composes the direct engine's
100-1000x iteration-count advantage with every structured operator.
"""

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from totsu_tpu.solver.cone import ConeLayout
from totsu_tpu.solver.operator import DenseOp, as_linop
from totsu_tpu.solver.params import (SolverParam, SolverStatus,
                                     effective_eps_inf)
from totsu_tpu.solver.conic import (SolveResult, ResumeState, _hidot,
                                    _unpack_resume)


def _run_halpern_dr(t_map, pair, check, z0, ws0, check_period, max_iter,
                    param, dtype, status0, crits0, k0=None, aux=None):
    """Restarted Halpern iteration on the DR variable ``z``.

    Round 1 reused the (u, v)-pair Halpern runner from the pdhg engine,
    but the DR map is firmly nonexpansive only in z = utilde - v: one
    Halpern averaging of the pair leaves the Moreau manifold, after which
    the steps are no longer DR steps on z and the O(1/k) rate does not
    transfer (advisor finding, round 1). This runner averages z itself,

        z_{k+1} = (k+1)/(k+2) * (2 T(z_k) - z_k) + 1/(k+2) * z_anchor,

    and reconstructs the (u, v) pair by Moreau decomposition only where
    needed. Epoch restarts (anchor <- T(z)) on sufficient decay (x0.2) /
    stalled necessary decay (x0.8) of the fixed-point residual
    ||T(z) - z||, or when the epoch exceeds 36% of total iterations.
    Termination is evaluated at the Moreau pair of T(z) — projected and
    feasible — so convergence/infeasibility statuses keep their
    certificate semantics.

    ``ws0`` is opaque auxiliary state threaded through ``t_map(z, ws) ->
    (T(z), ws)`` — the indirect engine carries its CG warm start there
    (the dense engine passes a 0-d dummy).
    """
    beta_suff, beta_nec, beta_art = 0.2, 0.8, 0.36
    inf = jnp.asarray(jnp.inf, dtype=dtype)

    def cond(state):
        k, status = state[3], state[4]
        return (status == SolverStatus.RUNNING) & (k < max_iter)

    def body(state):
        z, ws, anchor, k, status, crits, ke, fp_rst, fp_last, _rz = state

        def inner(_, c2):
            zi, wsi, kei = c2
            tz, wsi = t_map(zi, wsi)
            w = (kei.astype(dtype) + 1.0) / (kei.astype(dtype) + 2.0)
            zn = w * (2.0 * tz - zi) + (1.0 - w) * anchor
            return (zn, wsi, kei + 1)

        z, ws, ke = jax.lax.fori_loop(0, check_period, inner, (z, ws, ke))
        k = k + check_period
        tz, ws = t_map(z, ws)
        fp = jnp.linalg.norm(tz - z)
        pu, pv = pair(tz)
        status, crits = check(pu, pv, k)
        restart = (fp <= beta_suff * fp_rst) \
            | ((fp <= beta_nec * fp_rst) & (fp > fp_last)) \
            | (ke.astype(dtype) >= jnp.maximum(
                beta_art * k.astype(dtype),
                jnp.asarray(4.0 * check_period, dtype=dtype)))
        take = restart | (status != SolverStatus.RUNNING)
        # rz = the z the loop would CONTINUE with if not done — the exact
        # resume point; z itself takes T(z) on exit for the result pair
        rz = jnp.where(restart, tz, z)
        z = jnp.where(take, tz, z)
        anchor = jnp.where(restart, tz, anchor)
        ke = jnp.where(restart, 0, ke)
        fp_rst = jnp.where(restart, fp, fp_rst)
        return (z, ws, anchor, k, status, crits, ke, fp_rst, fp, rz)

    if k0 is None:
        k0 = jnp.asarray(0, dtype=jnp.int32)
    ke0 = jnp.asarray(0, dtype=jnp.int32)
    if aux is not None:
        # exact resume: restore the Halpern anchor and epoch counters
        state0 = (z0, ws0, aux["anchor"], k0, status0, crits0,
                  aux["ke"], aux["fp_rst"], aux["fp_last"], z0)
    else:
        state0 = (z0, ws0, z0, k0, status0, crits0, ke0, inf, inf, z0)
    out = jax.lax.while_loop(cond, body, state0)
    z, ws, anchor, k, status, crits, ke, fp_rst, fp_last, rz = out
    aux_out = {"anchor": anchor, "ke": ke, "fp_rst": fp_rst,
               "fp_last": fp_last, "z": rz}
    return z, ws, k, status, crits, aux_out


def _cg(apply_fn, rhs, x0, rel_tol, max_cg, inv_diag=None):
    """Warm-started (optionally Jacobi-preconditioned) conjugate gradient
    on an SPD operator (jit-traceable, data-dependent trip count via
    ``lax.while_loop``).

    The SCS "indirect" linear-system mode: apply_fn(z) = z + A^T(A z) has
    eigenvalues in [1, 1 + sigma_max(A)^2], so plain CG converges
    geometrically. ``inv_diag`` (the reciprocal of diag(I + A^T A))
    enables Jacobi PCG — the lever for badly column-scaled data, where
    the unpreconditioned iteration count tracks the scale spread. The stopping test monitors the
    UN-preconditioned residual either way, so ``rel_tol`` means the same
    thing in both modes.

    Returns ``(x, rel2)`` with ``rel2`` = the relative squared residual
    at exit — > rel_tol^2 exactly when the ``max_cg`` cap truncated.
    """
    r0 = rhs - apply_fn(x0)
    den = jnp.maximum(_hidot(rhs, rhs), jnp.finfo(rhs.dtype).tiny)
    tol2 = (rel_tol ** 2) * den

    def prec(r):
        return r * inv_diag if inv_diag is not None else r

    z0 = prec(r0)

    def cond(cs):
        _, _, _, _, rr, i = cs
        return (rr > tol2) & (i < max_cg)

    def body(cs):
        x, r, p, rz, _rr, i = cs
        ap = apply_fn(p)
        alpha = rz / _hidot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = prec(r)
        rz_new = _hidot(r, z)
        rr_new = _hidot(r, r)
        p = z + (rz_new / rz) * p
        return (x, r, p, rz_new, rr_new, i + 1)

    x, _, _, _, rr, _ = jax.lax.while_loop(
        cond, body, (x0, r0, z0, _hidot(r0, z0), _hidot(r0, r0),
                     jnp.asarray(0, jnp.int32)))
    return x, rr / den


def solve_direct_jit(
    c,
    a,
    b,
    cone: ConeLayout,
    param: SolverParam = SolverParam(),
    warm_start: Optional[Tuple[Any, Any]] = None,
    resume_state: Optional[Tuple[Any, Any]] = None,
) -> SolveResult:
    """Pure, jit-traceable direct-method solve.

    Dense operators get the cached-factorization path; every other
    :class:`LinOp` gets the indirect (warm-started CG) path — see module
    docstring. Matmul precision is pinned to HIGHEST for the whole engine:
    the resolvent accuracy is load-bearing (TF32 rounding breaks the DR
    map's firm nonexpansiveness — see the dense-path comment below), and
    the per-iteration products are GEMV-shaped (bandwidth-bound), so the
    pin costs nothing there.
    """
    with jax.default_matmul_precision("highest"):
        return _solve_direct_impl(c, a, b, cone, param, warm_start,
                                  resume_state)


def _solve_direct_impl(c, a, b, cone, param, warm_start, resume_state):
    a_op = as_linop(a)
    dense = isinstance(a_op, DenseOp)
    c = jnp.asarray(c)
    b = jnp.asarray(b)
    dtype = jnp.result_type(c.dtype, b.dtype)
    c = c.astype(dtype)
    b = b.astype(dtype)
    if dense:
        a_op = DenseOp(a_op.a.astype(dtype))
    n = c.shape[0]
    m = b.shape[0]
    if cone.dim != m:
        raise ValueError(f"cone dim {cone.dim} != m {m}")

    equil_d = equil_e = None
    if param.equil_iters is not None and param.equil_iters > 0:
        from totsu_tpu.solver.scaling import ruiz_equilibrate_op
        a_op, b, c, equil_d, equil_e = ruiz_equilibrate_op(
            a_op, b, c, cone, iters=param.equil_iters)
    amat = a_op.a if dense else None

    eps_zero = param.eps_zero
    eps_acc = param.eps_acc
    # dtype floor on the certificate tolerance (default-eps only, capped;
    # measured f32 ray-residual floor ~8e-6 — without the floor an
    # unbounded f32 SOCP spins to max_iter instead of certifying)
    eps_inf = effective_eps_inf(param, dtype)
    max_iter = param.bounded_max_iter
    check_period = max(1, param.check_period)
    if param.accel == "halpern":
        # the reflection 2T - I is nonexpansive for the UNRELAXED DR map
        # (firmly nonexpansive); over-relaxation would break the Halpern
        # convergence guarantee
        if param.relax != 1.0:
            raise ValueError("accel='halpern' requires relax=1.0")
        relax = 1.0
    elif param.accel:
        raise ValueError(
            f"accel {param.accel!r} is not supported by the direct engine"
            " ('halpern' is)")
    else:
        relax = float(param.relax) if param.relax != 1.0 else 1.5
        # (SCS defaults to over-relaxation ~1.5; relax=1.0 in params means
        # "default", which for this method is 1.5.)

    norm_b = jnp.linalg.norm(b)
    norm_c = jnp.linalg.norm(c)

    # b/c norm normalization (SolverParam.normalize; default ON for this
    # engine): iterate on b/||b||, c/||c||; criteria / certificates /
    # solution below are evaluated on the un-normalized data. On the
    # benchmark LP contract (n=100, eps 1e-3) it cut plain DR from 18040
    # to 780 iterations, 260-560 with accel='halpern'.
    do_norm = bool(param.normalize) if param.normalize is not None else True
    if do_norm:
        # no-op when the norm is negligible (b = 0 / c = 0 problems) —
        # dividing by eps_zero would scale seeds/solutions by 1e12
        sb = jnp.where(norm_b > eps_zero, norm_b, 1.0)
        sc = jnp.where(norm_c > eps_zero, norm_c, 1.0)
        b_it, c_it = b / sb, c / sc
    else:
        sb = sc = None
        b_it, c_it = b, c

    # -- seed / resume unpack (before the cache build: a ResumeState
    # checkpoint carries the cached inverse / Sherman-Morrison border,
    # letting each resumed dispatch skip the O(n^3) rebuild — VERDICT
    # r4 #2)
    nm1 = n + m + 1
    u0 = jnp.zeros((nm1,), dtype=dtype).at[-1].set(1.0)
    v0 = jnp.zeros((nm1,), dtype=dtype).at[-1].set(1.0)
    k_start = jnp.asarray(0, dtype=jnp.int32)
    resume_aux = None
    if resume_state is not None:
        u0, v0, k_start, resume_aux = _unpack_resume(
            resume_state, "direct", param.accel)
    elif warm_start is not None:
        ws_x, ws_y = warm_start
        if ws_x is not None:
            ws_x = jnp.asarray(ws_x, dtype=dtype)
            if equil_e is not None:
                ws_x = ws_x / equil_e
            if do_norm:
                ws_x = ws_x / sb
            u0 = u0.at[:n].set(ws_x)
        if ws_y is not None:
            ws_y = jnp.asarray(ws_y, dtype=dtype)
            if equil_d is not None:
                ws_y = ws_y / equil_d
            if do_norm:
                ws_y = ws_y / sc
            u0 = u0.at[n:n + m].set(cone.project(ws_y, dual=True))
        # SCS-style warm start of the dual variable: v = (0, s, kappa=0)
        # with s = Pi_K(b - A x0). At the exact solution this makes
        # (u0, v0) an exact DR fixed point ((I+Q)u* = u* + v*, and the
        # Moreau pair relation Pi_{K*}(y - s) = y holds by y perp s).
        s_seed = cone.project(b_it - a_op.matvec(u0[:n]), dual=False)
        v0 = jnp.zeros((nm1,), dtype=dtype).at[n:n + m].set(s_seed)
    aux_c = resume_aux if resume_aux is not None else {}

    # cached solve pieces for the SPD matrix M = I + A^T A (condition
    # ~ 1 + sigma_max(A)^2): one Cholesky factorization (cuSOLVER potrf on
    # the GPU, LAPACK on the CPU) and the explicit inverse from its
    # triangular solves, so each resolvent is a GEMV. Measured on an H100
    # at its 400 W limit (PERF.md): applying the factor by two triangular solves per
    # resolvent was 3-5x slower to solution, and a Newton-Schulz inverse
    # cost 6x the setup at n = 4096. In f32 every solve adds
    # iterative-refinement steps (GEMV-only) that push the residual to
    # factorization-level accuracy on ill-conditioned data; the
    # ill-conditioned f32 stress test in tests/test_direct.py pins this.
    # f64 takes none: the inverse's resolvent residual is ~cond * eps
    # (~2e-9 at cond 3e7, pinned by the f64 stress test).
    # HIGHEST precision is load-bearing on the A^T A product: at DEFAULT
    # precision the GPU may form it in TF32 (10-bit mantissa), corrupting
    # M by ~1e-3 relative before it is factored, and a DR map built on a
    # biased resolvent loses firm nonexpansiveness and stalls.
    hi = jax.lax.Precision.HIGHEST
    eps_mach = float(jnp.finfo(dtype).eps)

    def _mv(mat, vec):
        # the refinement/m_solve matvecs bound the final solve accuracy
        # (cost: negligible, GEMVs are bandwidth-bound)
        return jnp.matmul(mat, vec, precision=hi)

    # ``m_solve`` threads opaque warm-start state ``ws``: a 0-d dummy on
    # the cached dense path, the previous CG solution on the indirect path.
    if dense:
        if "spd_inv" in aux_c:
            spd_inv = aux_c["spd_inv"]
        else:
            import jax.scipy.linalg as jsl
            spd = jnp.eye(n, dtype=dtype) + jnp.matmul(
                amat.T, amat, precision=hi)
            spd_inv = jsl.cho_solve(jsl.cho_factor(spd),
                                    jnp.eye(n, dtype=dtype))
        cache = {"spd_inv": spd_inv}
        refine_steps = 0 if dtype == jnp.float64 else 2

        def spd_apply_inv(r):
            return _mv(spd_inv, r)

        def spd_solve(rhs):
            z = spd_apply_inv(rhs)
            for _ in range(refine_steps):
                resid = rhs - z - _mv(amat.T, _mv(amat, z))
                z = z + spd_apply_inv(resid)
            return z

        def m_solve(r1, r2, ws):
            z1 = spd_solve(r1 - _mv(amat.T, r2))
            z2 = r2 + _mv(amat, z1)
            return z1, z2, ws

        def setup_solve(r1, r2):
            z1, z2, _ = m_solve(r1, r2, None)
            return z1, z2

        ws0 = jnp.zeros((), dtype=dtype)
        if "ws" in aux_c:
            ws0 = aux_c["ws"]
    else:
        # indirect mode: CG on (I + A^T A), warm-started across DR
        # iterations (SCS indirect; VERDICT r2 #4). Works with any LinOp.
        def spd_apply(z):
            return z + a_op.rmatvec(a_op.matvec(z))

        # resolvent tolerance: well below eps_acc so the DR map stays
        # effectively exact, floored at the dtype's attainable residual
        cg_tol = max(min(eps_acc * 1e-2, 1e-8), 30.0 * eps_mach)
        max_cg = min(n, 500)
        # Jacobi preconditioner diag(I + A^T A) = 1 + col_sqsum(A)
        # (SolverParam.cg_precond); 'auto' falls back to plain CG for
        # operators without col_sqsum (e.g. matrix-free CustomOp)
        if param.cg_precond not in ("auto", "jacobi", "none"):
            raise ValueError(
                f"unknown cg_precond {param.cg_precond!r}; expected "
                "'auto', 'jacobi' or 'none'")
        inv_diag = None
        if param.cg_precond in ("auto", "jacobi"):
            try:
                inv_diag = 1.0 / (1.0 + a_op.col_sqsum().astype(dtype))
            except NotImplementedError:
                if param.cg_precond == "jacobi":
                    raise
        zero_rel = jnp.zeros((), dtype=dtype)

        def m_solve(r1, r2, ws):
            xw, worst = ws
            z1, rel2 = _cg(spd_apply, r1 - a_op.rmatvec(r2), xw, cg_tol,
                           max_cg, inv_diag)
            z2 = r2 + a_op.matvec(z1)
            return z1, z2, (z1, jnp.maximum(worst, rel2))

        def setup_solve(r1, r2):
            # one-time g = M^{-1} h: solved tighter (it enters the
            # Sherman-Morrison correction of EVERY subsequent resolvent)
            z1, _ = _cg(spd_apply, r1 - a_op.rmatvec(r2),
                        jnp.zeros((n,), dtype=dtype),
                        max(cg_tol * 1e-2, 4.0 * eps_mach),
                        min(4 * n, 4000), inv_diag)
            return z1, r2 + a_op.matvec(z1)

        cache = {}
        ws0 = (jnp.zeros((n,), dtype=dtype), zero_rel)
        if "ws" in aux_c:
            # resumed CG warm start: the previous chunk's last resolvent
            # solution (near the DR fixed point the rhs barely moves)
            ws0 = aux_c["ws"]

    h = jnp.concatenate([c_it, b_it])
    if "gh" in aux_c:
        gh, denom = aux_c["gh"], aux_c["denom"]
    else:
        g1, g2 = setup_solve(c_it, b_it)
        gh = jnp.concatenate([g1, g2])
        denom = 1.0 + _hidot(h, gh)
    cache["gh"] = gh
    cache["denom"] = denom

    def iq_solve(w, ws):
        # solve (I + Q) z = w, z = (z1 (n), z2 (m), ztau (1))
        w1 = w[:n + m]
        wtau = w[-1]
        rhs = w1 - wtau * h
        t1, t2, ws = m_solve(rhs[:n], rhs[n:], ws)
        t = jnp.concatenate([t1, t2])
        z = t - gh * (_hidot(h, t) / denom)
        ztau = wtau + _hidot(h, z)
        return jnp.concatenate([z, ztau[None]]), ws

    def proj_c(w):
        # Pi_C with C = R^n x K* x R+
        wy = cone.project(w[n:n + m], dual=True)
        wtau = jnp.maximum(w[-1], 0.0)
        return jnp.concatenate([w[:n], wy, wtau[None]])

    def update(_, carry):
        u, v, ws = carry
        ut, ws = iq_solve(u + v, ws)
        ut = u + relax * (ut - u)      # over-relaxation on the affine step
        u_new = proj_c(ut - v)
        v_new = v - ut + u_new
        return (u_new, v_new, ws)

    def t_map(z, ws):
        # The Douglas-Rachford operator on the DR variable z (= utilde - v):
        #   T(z) = S(2 Pi_C(z) - z) - Pi_C(z) + z
        # with S the (I+Q)-resolvent. T is firmly nonexpansive in z (the
        # standard DR operator), so its reflection 2T - I is nonexpansive
        # and Halpern's O(1/k) fixed-point-residual rate applies. The pair
        # iteration in `update` carries the Moreau pair of z implicitly:
        # u_{k+1} - v_{k+1} = T(u_k~ - v_k).
        pu = proj_c(z)
        ut, ws = iq_solve(2.0 * pu - z, ws)
        return ut - pu + z, ws

    def pair(z):
        # Moreau pair of z: u = Pi_C(z) in C, v = u - z with <u, v> = 0 —
        # exactly the (u, v) the plain pair iteration would carry.
        pu = proj_c(z)
        return pu, pu - z

    inf = jnp.asarray(jnp.inf, dtype=dtype)
    # global-iteration cap: on resume the loop continues from k_start and
    # max_iter bounds the iterations of THIS call (chunk semantics)
    cap = k_start + max_iter

    def check(u, v, k):
        """Reference termination criteria (solver.rs:573-656) with
        x = u.x, y = u.y, tau = u.tau, s = v.y (the slack lives in the
        dual residual block of v), kappa = v.tau. Evaluated on the
        UN-normalized data (iterates scaled back by sb/sc first)."""
        ux, uy_, val_tau = u[:n], u[n:n + m], u[-1]
        us = v[n:n + m]
        if do_norm:
            ux, uy_, us = ux * sb, uy_ * sc, us * sb
        ax, aty = a_op.dual_matvec(ux, uy_)
        cx = _hidot(c, ux)
        by = _hidot(b, uy_)

        tau_pos = val_tau > eps_zero
        inv_tau = 1.0 / jnp.where(tau_pos, val_tau, 1.0)
        p = ax * inv_tau + us * inv_tau - b
        d = c + aty * inv_tau
        g_x = cx * inv_tau
        g_y = by * inv_tau
        g = g_x + g_y
        cri_pri = jnp.linalg.norm(p) / (1.0 + norm_b)
        cri_dual = jnp.linalg.norm(d) / (1.0 + norm_c)
        cri_gap = jnp.abs(g) / (1.0 + jnp.abs(g_x) + jnp.abs(g_y))
        conv = tau_pos & (cri_pri <= eps_acc) & (cri_dual <= eps_acc) \
            & (cri_gap <= eps_acc)

        p_inf = ax + us
        d_inf = aty
        m_cx = -cx
        m_by = -by
        cri_unbdd = jnp.where(
            m_cx > eps_zero, jnp.linalg.norm(p_inf) * norm_c / m_cx, inf)
        cri_infeas = jnp.where(
            m_by > eps_zero, jnp.linalg.norm(d_inf) * norm_b / m_by, inf)
        unbdd = (~tau_pos) & (cri_unbdd <= eps_inf)
        infeas = (~tau_pos) & (cri_infeas <= eps_inf)

        excess = k >= cap
        status = jnp.where(
            conv, SolverStatus.CONVERGED,
            jnp.where(unbdd, SolverStatus.UNBOUNDED,
                      jnp.where(infeas, SolverStatus.INFEASIBLE,
                                jnp.where(excess, SolverStatus.EXCESS_ITER,
                                          SolverStatus.RUNNING))))
        crits = jnp.stack([cri_pri, cri_dual, cri_gap, cri_unbdd, cri_infeas])
        return status.astype(jnp.int32), crits

    def cond(state):
        k, status = state[3], state[4]
        return (status == SolverStatus.RUNNING) & (k < cap)

    def body(state):
        u, v, ws, k, status, crits = state
        u, v, ws = jax.lax.fori_loop(0, check_period, update, (u, v, ws))
        k = k + check_period
        status, crits = check(u, v, k)
        return (u, v, ws, k, status, crits)

    if resume_aux is not None and "crits" in resume_aux:
        # exact resume: restore the checkpointed criteria and status
        # (EXCESS -> RUNNING; terminal statuses stay terminal — see the
        # matching comment in conic.py)
        saved = resume_aux.get("status")
        if saved is not None:
            status0 = jnp.where(
                saved == SolverStatus.EXCESS_ITER,
                SolverStatus.RUNNING, saved).astype(jnp.int32)
        else:
            status0 = jnp.asarray(SolverStatus.RUNNING, dtype=jnp.int32)
        crits0 = resume_aux["crits"]
    elif warm_start is not None or resume_state is not None:
        # an already-converged seed terminates at 0 iterations
        status0, crits0 = check(u0, v0, k_start)
    else:
        status0 = jnp.asarray(SolverStatus.RUNNING, dtype=jnp.int32)
        crits0 = jnp.full((5,), jnp.inf, dtype=dtype)
    if param.accel == "halpern":
        hal_resume = resume_aux if resume_aux is not None and \
            {"anchor", "ke", "fp_rst", "fp_last", "z"} <= set(resume_aux) \
            else None
        if hal_resume is not None:
            # exact resume from the raw DR carry saved at the checkpoint
            z0, ws1 = hal_resume["z"], ws0
        else:
            # seed the DR variable: z0 = utilde_0 - v0 (what the first
            # pair step would produce); for a cold start u0 = v0 = e_tau
            # this is NOT u0 - v0 = 0 (the trivial fixed point of the
            # homogeneous embedding) but a nontrivial point.
            ut0, ws1 = iq_solve(u0 + v0, ws0)
            z0 = ut0 - v0
        z, ws_fin, k, status, crits, hal_aux = _run_halpern_dr(
            t_map, pair, check, z0, ws1, check_period, cap, param,
            dtype, status0, crits0, k0=k_start, aux=hal_resume)
        u, v = pair(z)
        if hal_resume is not None and hal_resume.get("status") is not None:
            # TERMINAL checkpoints exit the runner immediately with
            # z = the raw DR carry, whose pair(z) is NOT the pair the
            # checkpoint presented (r5 review: 2.6e-7 solution drift on
            # a resumed CONVERGED solve while the criteria were copied
            # bit-identical). Keep the checkpointed taken pair for
            # terminal lanes; running lanes keep pair(z).
            saved_st = hal_resume["status"]
            term = jnp.logical_and(
                saved_st != SolverStatus.EXCESS_ITER,
                saved_st != SolverStatus.RUNNING)
            u = jnp.where(term, u0, u)
            v = jnp.where(term, v0, v)
        aux_out = {**cache, "ws": ws_fin, **hal_aux, "crits": crits,
                   "status": status}
    else:
        out = jax.lax.while_loop(
            cond, body, (u0, v0, ws0, k_start, status0, crits0))
        u, v, ws_fin, k, status, crits = out
        aux_out = {**cache, "ws": ws_fin, "crits": crits,
                   "status": status}

    val_tau = u[-1]
    tau_pos = val_tau > eps_zero
    scale = jnp.where(tau_pos, 1.0 / jnp.where(tau_pos, val_tau, 1.0), 1.0)
    sol_x = u[:n] * scale
    sol_y = u[n:n + m] * scale
    if do_norm:
        # undo the b/c normalization: x = sb x', y = sc y'
        sol_x = sol_x * sb
        sol_y = sol_y * sc
    if equil_e is not None:
        sol_x = sol_x * equil_e
        sol_y = sol_y * equil_d

    diag_out = None
    if not dense:
        # surfaced CG health (see SolveResult.diag): worst relative
        # resolvent residual across the whole solve vs its target
        diag_out = {"cg_worst_rel": jnp.sqrt(ws_fin[1]),
                    "cg_tol": jnp.asarray(cg_tol, dtype)}
    return SolveResult(
        x=sol_x, y=sol_y, status=status, iters=k - k_start,
        cri_pri=crits[0], cri_dual=crits[1], cri_gap=crits[2],
        cri_unbdd=crits[3], cri_infeas=crits[4],
        state=ResumeState(u=u, v=v, k=k, aux=aux_out, engine="direct",
                          accel=param.accel)
        if param.return_state else None,
        diag=diag_out)
