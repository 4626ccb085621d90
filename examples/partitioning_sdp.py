"""Max-cut-style graph partitioning as an SDP with randomized rounding.

Port of ref examples/partitioning_sdp/src/main.rs:21-163: grid graph with
N(0, 1) edge weights W; solve  min Tr(W X) s.t. X >= 0 (PSD), X_ii = 1
(k = l = 48 nodes, p = l equalities); then Goemans-Williamson-style
rounding: sample Gaussian probes through X^(1/2) and take the best
sign-rounded cut (ref sample_feasible main.rs:80-135, using
MatBuild::set_sqrt).

The SDP variable is vec(X); the i-th conic variable multiplies the basis
matrix -E_ij, so x = vec-packed X itself and c = vec-packed W halves...
(the reference sets c = raw packed W, F_kk = -1 at one upper-tri slot).
"""

import time

import numpy as np

from _common import setup, report


def build(x_num=8, y_num=6, seed=10_000):
    l = x_num * y_num
    rng = np.random.default_rng(seed)
    w = np.zeros((l, l))
    for i in range(l):
        x, y = divmod(i, y_num)
        if x < x_num - 1:
            w[i, i + y_num] = w[i + y_num, i] = rng.standard_normal()
        if y < y_num - 1:
            w[i, i + 1] = w[i + 1, i] = rng.standard_normal()
    return w


def build_problem(w, tt, dtype=np.float64):
    """min <W, X> s.t. X PSD, diag(X) = 1 — expressed through the generic
    SDP builder: variables x_k = entries of packed X, LMI
    sum_k x_k (-E_k) + 0 <= 0 i.e. X >= 0, equalities on diagonal slots.
    Returns the ConicProblem with data of ``dtype``."""
    l = w.shape[0]
    sn = l * (l + 1) // 2
    # c: the packed W read in upper-tri col-major order with off-diagonals
    # appearing once — objective sum_k c_k x_k = Tr(W X) requires doubling
    # the off-diagonals; the reference uses raw packed W (objective then is
    # the half off-diagonal sum — same minimizer, reported value differs by
    # convention). We keep the reference's convention.
    c = np.zeros(sn)
    f_mats = np.zeros((sn + 1, l, l))
    diag_slots = []
    kk = 0
    for j in range(l):
        for i in range(j + 1):
            c[kk] = w[i, j]
            f_mats[kk, i, j] = -1.0
            f_mats[kk, j, i] = -1.0
            if i == j:
                diag_slots.append(kk)
            kk += 1
    a = np.zeros((l, sn))
    for r, s in enumerate(diag_slots):
        a[r, s] = 1.0
    b = np.ones(l)
    return tt.problems.sdp(c.astype(dtype), f_mats.astype(dtype),
                           a.astype(dtype), b.astype(dtype))


def solve_sdp(w, tt, param):
    prob = build_problem(w, tt)
    t0 = time.time()
    res = prob.solve_jit(param)
    res.x.block_until_ready()
    return res, time.time() - t0


def sample_feasible(sol_packed, w, seed=20_000):
    """Random-hyperplane rounding through X^(1/2) (ref main.rs:80-135)."""
    l = w.shape[0]
    x_mat = np.zeros((l, l))
    kk = 0
    for j in range(l):
        for i in range(j + 1):
            x_mat[i, j] = x_mat[j, i] = sol_packed[kk]
            kk += 1
    ew, ev = np.linalg.eigh(x_mat)
    root = (ev * np.sqrt(np.maximum(ew, 0.0))) @ ev.T
    rng = np.random.default_rng(seed)
    best_o, best_x = None, None
    for _ in range(l):
        probe = root @ rng.standard_normal(l)
        cut = np.where(probe > 0, 1.0, -1.0)
        o = float(cut @ w @ cut)
        if best_o is None or o < best_o:
            best_o, best_x = o, cut
    return best_o, best_x


def main(x_num=8, y_num=6):
    backend = setup()
    import totsu_tpu as tt
    from totsu_tpu.utils import set_par_by_env

    w = build(x_num, y_num)
    param = set_par_by_env(tt.SolverParam(max_iter=200_000, eps_acc=1e-3))
    res, t_solve = solve_sdp(w, tt, param)

    sol = np.asarray(res.x)
    o_feas, x_feas = sample_feasible(sol, w)
    # self-checks: SDP lower-bounds any feasible cut (weak duality);
    # rounding must beat a random cut on average
    l = w.shape[0]
    sdp_obj = float(np.trace(w @ _unpack(sol, l)))
    rng = np.random.default_rng(0)
    rand_cuts = [float(c @ w @ c) for c in
                 np.where(rng.random((20, l)) > 0.5, 1.0, -1.0)]
    report("partitioning_sdp", res, t_solve,
           f"backend={backend} nodes={l} sdp_obj={sdp_obj:.4f} "
           f"best_cut={o_feas:.4f} rand_mean={np.mean(rand_cuts):.4f}")
    assert sdp_obj <= o_feas + 1e-2  # lower bound holds
    assert o_feas < np.mean(rand_cuts)  # rounding beats random
    return o_feas


def _unpack(packed, l):
    m = np.zeros((l, l))
    kk = 0
    for j in range(l):
        for i in range(j + 1):
            m[i, j] = m[j, i] = packed[kk]
            kk += 1
    return m


if __name__ == "__main__":
    main()
