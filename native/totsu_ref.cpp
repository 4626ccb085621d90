// totsu_ref: native C++ reference engine for the totsu_tpu framework.
//
// A self-contained f64 implementation of the same homogeneous self-dual
// embedding + diagonally preconditioned Pock-Chambolle iteration that the
// JAX solver runs on the accelerator (totsu_tpu/solver/conic.py; algorithm semantics
// follow the reference solver at
// /root/reference/solver_rust_conic/totsu_core/src/solver/solver.rs).
//
// Roles in the framework:
//   * independent correctness oracle for the JAX path (same problem in,
//     same iterate path out — cross-checked in tests/test_native.py)
//   * honest single-core CPU baseline for bench.py (the FloatGeneric-
//     equivalent the Rust reference ships)
//   * host-side fallback engine for tiny problems where accelerator
//     dispatch latency dominates
//
// Exposed via a C ABI consumed with ctypes (no pybind11 dependency).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

enum Status : int32_t {
  RUNNING = 0,
  CONVERGED = 1,
  EXCESS_ITER = 2,
  UNBOUNDED = 3,
  INFEASIBLE = 4,
};

enum ConeKind : int32_t {
  CONE_ZERO = 0,
  CONE_RPOS = 1,
  CONE_SOC = 2,
  CONE_RSOC = 3,
  CONE_PSD = 4,
  CONE_EXP = 5,
  CONE_POW = 6,
};

struct Factor {
  int32_t kind;
  int32_t dim;    // length of one block
  int32_t count;  // number of consecutive equal blocks
  double alpha;   // power-cone exponent (CONE_POW only)
};

double nrm2(const double* x, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += x[i] * x[i];
  return std::sqrt(s);
}

double dot(const double* x, const double* y, int n) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += x[i] * y[i];
  return s;
}

// y = A x (A row-major m x n)
void gemv(const double* a, const double* x, double* y, int m, int n) {
  for (int i = 0; i < m; ++i) {
    const double* row = a + (size_t)i * n;
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += row[j] * x[j];
    y[i] = s;
  }
}

// y = A^T x
void gemv_t(const double* a, const double* x, double* y, int m, int n) {
  std::fill(y, y + n, 0.0);
  for (int i = 0; i < m; ++i) {
    const double* row = a + (size_t)i * n;
    const double xi = x[i];
    for (int j = 0; j < n; ++j) y[j] += row[j] * xi;
  }
}

// ---- cone projections (dense blocks) ----

void proj_soc(double* x, int d) {
  if (d <= 0) return;
  const double s = x[0];
  const double nv = nrm2(x + 1, d - 1);
  if (nv <= -s) {
    std::fill(x, x + d, 0.0);
  } else if (nv <= s) {
    // unchanged
  } else {
    const double alpha = 0.5 * (1.0 + s / nv);
    x[0] = 0.5 * (nv + s);
    for (int i = 1; i < d; ++i) x[i] *= alpha;
  }
}

void proj_rsoc(double* x, int d) {
  if (d <= 0) return;
  if (d == 1) {
    x[0] = std::max(x[0], 0.0);
    return;
  }
  const double inv_sqrt2 = 1.0 / std::sqrt(2.0);
  double r = (x[0] + x[1]) * inv_sqrt2;
  double s = (x[0] - x[1]) * inv_sqrt2;
  x[0] = r; x[1] = s;
  proj_soc(x, d);
  r = (x[0] + x[1]) * inv_sqrt2;
  s = (x[0] - x[1]) * inv_sqrt2;
  x[0] = r; x[1] = s;
}

// Euclidean projection onto the exponential cone
//   K_exp = cl{ (r, s, t) : s > 0, s e^{r/s} <= t }.
// Scalar f64 SAFEGUARDED BISECTION on the published univariate reduction
// (Friberg 2023: the projection lies on t = s e^{r/s}; eliminating the
// multiplier leaves one increasing root function h(rho)). Deliberately a
// different algorithm/structure than the JAX engine's fixed-trip
// vectorized Newton hybrid (totsu_tpu/solver/cone.py), so the two
// engines' exp iterate paths fail independently — this file's oracle
// role (tests/test_cross_engine.py).
void proj_exp(double* x) {
  const double r0 = x[0], s0 = x[1], t0 = x[2];
  const double e1 = std::exp(1.0);
  const bool in_k = (s0 > 0.0 && s0 * std::exp(r0 / s0) <= t0) ||
                    (s0 == 0.0 && r0 <= 0.0 && t0 >= 0.0);
  if (in_k) return;
  const bool in_polar = (r0 > 0.0 && r0 * std::exp(s0 / r0) <= -e1 * t0) ||
                        (r0 == 0.0 && s0 <= 0.0 && t0 <= 0.0);
  if (in_polar) {
    x[0] = x[1] = x[2] = 0.0;
    return;
  }
  if (r0 <= 0.0 && s0 <= 0.0) {
    x[1] = 0.0;
    x[2] = std::max(t0, 0.0);
    return;
  }
  // h(rho) scaled by e^{-|rho|} (sign- and root-preserving: overflow-safe)
  auto hval = [&](double rho) {
    const double num1 = (rho - 1.0) * r0 + s0;
    const double num2 = r0 - rho * s0;
    const double den = rho * (rho - 1.0) + 1.0;  // > 0 for all rho
    if (rho >= 0.0)
      return num1 - num2 * std::exp(-2.0 * rho) -
             t0 * den * std::exp(-rho);
    return num1 * std::exp(2.0 * rho) - num2 - t0 * den * std::exp(rho);
  };
  // bracket from the validity constraints s(rho) > 0, lambda(rho) > 0
  double lo = -INFINITY, hi = INFINITY;
  if (r0 > 0.0) lo = 1.0 - s0 / r0;
  else if (r0 < 0.0) hi = 1.0 - s0 / r0;
  if (s0 < 0.0) lo = std::max(lo, r0 / s0);
  else if (s0 > 0.0) hi = std::min(hi, r0 / s0);
  double lo_f = std::isfinite(lo) ? lo : hi - 1.0;
  double hi_f = std::isfinite(hi) ? hi : lo + 1.0;
  if (!std::isfinite(hi))
    for (int i = 0; i < 200 && hval(hi_f) < 0.0; ++i)
      hi_f = lo_f + 2.0 * (hi_f - lo_f);
  if (!std::isfinite(lo))
    for (int i = 0; i < 200 && hval(lo_f) > 0.0; ++i)
      lo_f = hi_f + 2.0 * (lo_f - hi_f);
  double rho = 0.5 * (lo_f + hi_f);
  for (int i = 0; i < 200; ++i) {
    rho = 0.5 * (lo_f + hi_f);
    if (hval(rho) < 0.0) lo_f = rho;
    else hi_f = rho;
    if (hi_f - lo_f <= 1e-16 * std::max(1.0, std::fabs(rho))) break;
  }
  const double den = rho * (rho - 1.0) + 1.0;
  const double s = std::max(((rho - 1.0) * r0 + s0) / den, 0.0);
  // the damped of the two algebraically equal forms (boundary vs KKT)
  const double t = (rho >= 0.0)
      ? t0 + (r0 - rho * s0) * std::exp(-rho) / den
      : s * std::exp(rho);
  x[0] = rho * s;
  x[1] = s;
  x[2] = std::max(t, 0.0);
}

// Euclidean projection onto the power cone
//   K_pow(a) = { (x, y, z) : x^a y^(1-a) >= |z|, x, y >= 0 }.
// Scalar bisection on r = |z_proj| in (0, |z0|) (Hien 2015 reduction);
// independent of the JAX engine's implementation, see proj_exp's note.
void proj_pow(double* xv, double a) {
  const double scl = std::max(
      std::max(std::fabs(xv[0]), std::fabs(xv[1])),
      std::max(std::fabs(xv[2]), 1e-300));
  const double x0 = xv[0] / scl, y0 = xv[1] / scl, z0 = xv[2] / scl;
  const double az = std::fabs(z0);
  auto powv = [&](double u, double v) {
    return (u > 0.0 && v > 0.0)
        ? std::exp(a * std::log(u) + (1.0 - a) * std::log(v)) : 0.0;
  };
  if (x0 >= 0.0 && y0 >= 0.0 && powv(x0, y0) >= az) return;
  if (x0 <= 0.0 && y0 <= 0.0 &&
      powv(-x0 / a, -y0 / (1.0 - a)) >= az) {
    xv[0] = xv[1] = xv[2] = 0.0;
    return;
  }
  if (az == 0.0) {
    xv[0] = std::max(x0, 0.0) * scl;
    xv[1] = std::max(y0, 0.0) * scl;
    xv[2] = 0.0;
    return;
  }
  auto xy = [&](double r, double& xr, double& yr) {
    // stable quadratic roots (conjugate form for negative offsets)
    const double q = r * (az - r);
    const double sx = std::sqrt(x0 * x0 + 4.0 * a * q);
    const double sy = std::sqrt(y0 * y0 + 4.0 * (1.0 - a) * q);
    xr = (x0 >= 0.0) ? 0.5 * (x0 + sx)
                     : 2.0 * a * q / std::max(sx - x0, 1e-300);
    yr = (y0 >= 0.0) ? 0.5 * (y0 + sy)
                     : 2.0 * (1.0 - a) * q / std::max(sy - y0, 1e-300);
  };
  double lo = 0.0, hi = az, r = 0.5 * az;
  for (int i = 0; i < 200; ++i) {
    r = 0.5 * (lo + hi);
    double xr, yr;
    xy(r, xr, yr);
    const double phi = a * std::log(std::max(xr, 1e-300)) +
                       (1.0 - a) * std::log(std::max(yr, 1e-300)) -
                       std::log(r);
    if (phi > 0.0) lo = r;
    else hi = r;
    if (hi - lo <= 1e-17 * az) break;
  }
  double xr, yr;
  r = 0.5 * (lo + hi);
  xy(r, xr, yr);
  xv[0] = xr * scl;
  xv[1] = yr * scl;
  xv[2] = (z0 >= 0.0 ? r : -r) * scl;
}

// Cyclic Jacobi eigendecomposition of a dense symmetric k x k matrix.
// On return `a` holds eigenvalues on its diagonal and `z` the eigenvectors
// (columns). Convergence gate mirrors the reference's FloatGeneric
// tolerance semantics (floatgeneric.rs:273-324).
void jacobi_eig(double* a, double* z, int k, double eps) {
  const double tol = eps * eps;
  for (int i = 0; i < k * k; ++i) z[i] = 0.0;
  for (int i = 0; i < k; ++i) z[(size_t)i * k + i] = 1.0;
  bool conv = false;
  int sweeps = 0;
  while (!conv && sweeps < 100) {
    conv = true;
    ++sweeps;
    for (int p = 0; p < k; ++p) {
      for (int q = p + 1; q < k; ++q) {
        const double app = a[(size_t)p * k + p];
        const double aqq = a[(size_t)q * k + q];
        const double apq = a[(size_t)p * k + q];
        if (!(apq * apq > tol * app * aqq && apq * apq > tol)) continue;
        conv = false;
        const double zeta = (aqq - app) / (2.0 * apq);
        const double t = (zeta > 0.0)
            ? 1.0 / (zeta + std::sqrt(1.0 + zeta * zeta))
            : -1.0 / (-zeta + std::sqrt(1.0 + zeta * zeta));
        const double cth = 1.0 / std::sqrt(1.0 + t * t);
        const double sth = cth * t;
        for (int r = 0; r < k; ++r) {
          const double arp = a[(size_t)r * k + p];
          const double arq = a[(size_t)r * k + q];
          a[(size_t)r * k + p] = cth * arp - sth * arq;
          a[(size_t)r * k + q] = sth * arp + cth * arq;
        }
        for (int r = 0; r < k; ++r) {
          const double apr = a[(size_t)p * k + r];
          const double aqr = a[(size_t)q * k + r];
          a[(size_t)p * k + r] = cth * apr - sth * aqr;
          a[(size_t)q * k + r] = sth * apr + cth * aqr;
        }
        for (int r = 0; r < k; ++r) {
          const double zrp = z[(size_t)r * k + p];
          const double zrq = z[(size_t)r * k + q];
          z[(size_t)r * k + p] = cth * zrp - sth * zrq;
          z[(size_t)r * k + q] = sth * zrp + cth * zrq;
        }
      }
    }
  }
}

// PSD projection of a scaled-vec packed block (upper triangle col-major,
// off-diagonals hold sqrt2 * X_ij).
void proj_psd(double* x, int d, double eps_zero, std::vector<double>& wrk) {
  // recover k from d = k(k+1)/2
  int k = (int)((std::sqrt(8.0 * d + 1.0) - 1.0) / 2.0 + 0.5);
  const double inv_sqrt2 = 1.0 / std::sqrt(2.0);
  wrk.resize((size_t)2 * k * k + k);
  double* mat = wrk.data();
  double* z = mat + (size_t)k * k;
  double* w = z + (size_t)k * k;
  // unpack
  int idx = 0;
  for (int c = 0; c < k; ++c) {
    for (int r = 0; r <= c; ++r) {
      const double v = (r == c) ? x[idx] : x[idx] * inv_sqrt2;
      mat[(size_t)r * k + c] = v;
      mat[(size_t)c * k + r] = v;
      ++idx;
    }
  }
  jacobi_eig(mat, z, k, eps_zero);
  for (int i = 0; i < k; ++i) w[i] = std::max(mat[(size_t)i * k + i], 0.0);
  // reconstruct X+ = Z diag(w) Z^T, packed
  idx = 0;
  for (int c = 0; c < k; ++c) {
    for (int r = 0; r <= c; ++r) {
      double s = 0.0;
      for (int i = 0; i < k; ++i)
        s += z[(size_t)r * k + i] * w[i] * z[(size_t)c * k + i];
      x[idx] = (r == c) ? s : s * std::sqrt(2.0);
      ++idx;
    }
  }
}

void cone_project(double* x, const Factor* factors, int nf, bool dual,
                  double eps_zero, std::vector<double>& wrk) {
  int off = 0;
  for (int f = 0; f < nf; ++f) {
    const Factor& fa = factors[f];
    for (int b = 0; b < fa.count; ++b) {
      double* blk = x + off;
      switch (fa.kind) {
        case CONE_ZERO:
          if (!dual) std::fill(blk, blk + fa.dim, 0.0);
          break;
        case CONE_RPOS:
          for (int i = 0; i < fa.dim; ++i) blk[i] = std::max(blk[i], 0.0);
          break;
        case CONE_SOC: proj_soc(blk, fa.dim); break;
        case CONE_RSOC: proj_rsoc(blk, fa.dim); break;
        case CONE_PSD: proj_psd(blk, fa.dim, eps_zero, wrk); break;
        case CONE_EXP:
        case CONE_POW: {
          // exp/pow are not self-dual: dual via Moreau decomposition
          // proj_{K*}(x) = x + proj_K(-x)
          double t3[3] = {blk[0], blk[1], blk[2]};
          if (dual) { t3[0] = -t3[0]; t3[1] = -t3[1]; t3[2] = -t3[2]; }
          if (fa.kind == CONE_EXP) proj_exp(t3);
          else proj_pow(t3, fa.alpha);
          if (dual) {
            blk[0] += t3[0]; blk[1] += t3[1]; blk[2] += t3[2];
          } else {
            blk[0] = t3[0]; blk[1] = t3[1]; blk[2] = t3[2];
          }
          break;
        }
      }
      off += fa.dim;
    }
  }
}

void cone_group_min(double* t, const Factor* factors, int nf) {
  int off = 0;
  for (int f = 0; f < nf; ++f) {
    const Factor& fa = factors[f];
    const bool grouped = fa.kind == CONE_SOC || fa.kind == CONE_RSOC ||
                         fa.kind == CONE_PSD || fa.kind == CONE_EXP ||
                         fa.kind == CONE_POW;
    for (int b = 0; b < fa.count; ++b) {
      if (grouped && fa.dim > 0) {
        double mn = t[off];
        for (int i = 1; i < fa.dim; ++i) mn = std::min(mn, t[off + i]);
        for (int i = 0; i < fa.dim; ++i) t[off + i] = mn;
      }
      off += fa.dim;
    }
  }
}

}  // namespace

extern "C" {

// Projection-level oracle entry points (tests/test_native.py compares
// these directly against the JAX engine's batched projections).
void totsu_proj_exp(double* xyz, int64_t count) {
  for (int64_t i = 0; i < count; ++i) proj_exp(xyz + 3 * i);
}

void totsu_proj_pow(double* xyz, int64_t count, double alpha) {
  for (int64_t i = 0; i < count; ++i) proj_pow(xyz + 3 * i, alpha);
}

// Solve min c'x s.t. Ax + s = b, s in K (dense row-major A).
// Returns a Status code; writes x (n), y (m) and the iteration count.
int32_t totsu_solve_dense(
    int32_t n, int32_t m, const double* c, const double* a, const double* b,
    int32_t n_factors, const int32_t* f_kinds, const int32_t* f_dims,
    const int32_t* f_counts, const double* f_alphas, double eps_acc,
    double eps_inf, double eps_zero,
    int64_t max_iter, int32_t check_period, double* out_x, double* out_y,
    int64_t* out_iters) {
  std::vector<Factor> factors(n_factors);
  for (int i = 0; i < n_factors; ++i)
    factors[i] = Factor{f_kinds[i], f_dims[i], f_counts[i],
                        f_alphas ? f_alphas[i] : 0.0};
  if (check_period < 1) check_period = 1;

  const int N = n + 2 * m + 1;  // u = [x | y | s | tau]
  const int M = n + m + 1;      // v = [vn | vm | kappa]

  // diagonal preconditioners (colabssum / rowabssum of the embedding)
  std::vector<double> col_a(n, 0.0), row_a(m, 0.0);
  for (int i = 0; i < m; ++i) {
    const double* row = a + (size_t)i * n;
    double rs = 0.0;
    for (int j = 0; j < n; ++j) {
      const double v = std::fabs(row[j]);
      col_a[j] += v;
      rs += v;
    }
    row_a[i] = rs;
  }
  double sum_cb = 0.0;
  for (int j = 0; j < n; ++j) sum_cb += std::fabs(c[j]);
  for (int i = 0; i < m; ++i) sum_cb += std::fabs(b[i]);

  std::vector<double> dp_tau(N), dp_sigma(M);
  for (int j = 0; j < n; ++j)
    dp_tau[j] = 1.0 / std::max(col_a[j] + std::fabs(c[j]), eps_zero);
  for (int i = 0; i < m; ++i) {
    dp_tau[n + i] = 1.0 / std::max(row_a[i] + std::fabs(b[i]), eps_zero);
    dp_tau[n + m + i] = 1.0;  // the -I block
  }
  dp_tau[N - 1] = 1.0 / std::max(sum_cb, eps_zero);
  for (int j = 0; j < n; ++j) dp_sigma[j] = dp_tau[j];
  for (int i = 0; i < m; ++i)
    dp_sigma[n + i] =
        1.0 / std::max(row_a[i] + std::fabs(b[i]) + 1.0, eps_zero);
  dp_sigma[M - 1] = dp_tau[N - 1];
  cone_group_min(dp_tau.data() + n, factors.data(), n_factors);
  cone_group_min(dp_tau.data() + n + m, factors.data(), n_factors);

  const double norm_b = nrm2(b, m);
  const double norm_c = nrm2(c, n);

  std::vector<double> u(N, 0.0), v(M, 0.0), u_old(N), tmpn(n), tmpm(m);
  std::vector<double> wrk;
  u[N - 1] = 1.0;

  int64_t k = 0;
  int32_t status = RUNNING;
  while (status == RUNNING && k < max_iter) {
    for (int step = 0; step < check_period; ++step) {
      // u <- u - dp_tau * K^T v
      std::memcpy(u_old.data(), u.data(), sizeof(double) * N);
      const double v1 = v[M - 1];
      gemv_t(a, v.data() + n, tmpn.data(), m, n);  // A^T vm
      for (int j = 0; j < n; ++j)
        u[j] -= dp_tau[j] * (-tmpn[j] - c[j] * v1);
      gemv(a, v.data(), tmpm.data(), m, n);        // A vn
      for (int i = 0; i < m; ++i) {
        u[n + i] -= dp_tau[n + i] * (tmpm[i] - b[i] * v1);
        u[n + m + i] -= dp_tau[n + m + i] * (-v[n + i]);
      }
      u[N - 1] -= dp_tau[N - 1] *
                  (dot(c, v.data(), n) + dot(b, v.data() + n, m));
      // projections: dual cone on y block, primal on s block, tau >= 0
      cone_project(u.data() + n, factors.data(), n_factors, true, eps_zero,
                   wrk);
      cone_project(u.data() + n + m, factors.data(), n_factors, false,
                   eps_zero, wrk);
      u[N - 1] = std::max(u[N - 1], 0.0);
      // ru = u_old - 2 u;  v <- v - dp_sigma * K ru
      for (int i = 0; i < N; ++i) u_old[i] -= 2.0 * u[i];
      const double rtau = u_old[N - 1];
      gemv_t(a, u_old.data() + n, tmpn.data(), m, n);  // A^T ruy
      for (int j = 0; j < n; ++j)
        v[j] -= dp_sigma[j] * (tmpn[j] + c[j] * rtau);
      gemv(a, u_old.data(), tmpm.data(), m, n);        // A rux
      for (int i = 0; i < m; ++i)
        v[n + i] -=
            dp_sigma[n + i] * (-tmpm[i] - u_old[n + m + i] + b[i] * rtau);
      v[M - 1] -= dp_sigma[M - 1] *
                  (-dot(c, u_old.data(), n) - dot(b, u_old.data() + n, m));
      v[M - 1] = std::min(v[M - 1], 0.0);
    }
    k += check_period;

    // termination criteria (criteria_conv / criteria_inf, solver.rs:573-656)
    const double tau = u[N - 1];
    gemv(a, u.data(), tmpm.data(), m, n);            // A ux
    gemv_t(a, u.data() + n, tmpn.data(), m, n);      // A^T uy
    const double cx = dot(c, u.data(), n);
    double by = dot(b, u.data() + n, m);
    if (tau > eps_zero) {
      const double inv = 1.0 / tau;
      double pn = 0.0, dn = 0.0;
      for (int i = 0; i < m; ++i) {
        const double p = tmpm[i] * inv + u[n + m + i] * inv - b[i];
        pn += p * p;
      }
      for (int j = 0; j < n; ++j) {
        const double d = c[j] + tmpn[j] * inv;
        dn += d * d;
      }
      const double gx = cx * inv, gy = by * inv;
      const double cri_pri = std::sqrt(pn) / (1.0 + norm_b);
      const double cri_dual = std::sqrt(dn) / (1.0 + norm_c);
      const double cri_gap =
          std::fabs(gx + gy) / (1.0 + std::fabs(gx) + std::fabs(gy));
      if (cri_pri <= eps_acc && cri_dual <= eps_acc && cri_gap <= eps_acc)
        status = CONVERGED;
      else if (k >= max_iter)
        status = EXCESS_ITER;
    } else {
      double pn = 0.0, dn = 0.0;
      for (int i = 0; i < m; ++i) {
        const double p = tmpm[i] + u[n + m + i];
        pn += p * p;
      }
      for (int j = 0; j < n; ++j) dn += tmpn[j] * tmpn[j];
      const double m_cx = -cx, m_by = -by;
      const double cri_unbdd = (m_cx > eps_zero)
          ? std::sqrt(pn) * norm_c / m_cx : INFINITY;
      const double cri_infeas = (m_by > eps_zero)
          ? std::sqrt(dn) * norm_b / m_by : INFINITY;
      if (cri_unbdd <= eps_inf) status = UNBOUNDED;
      else if (cri_infeas <= eps_inf) status = INFEASIBLE;
      else if (k >= max_iter) status = EXCESS_ITER;
    }
  }
  if (status == RUNNING) status = EXCESS_ITER;

  const double tau = u[N - 1];
  const double scale =
      (tau > eps_zero && (status == CONVERGED || status == EXCESS_ITER))
          ? 1.0 / tau : 1.0;
  for (int j = 0; j < n; ++j) out_x[j] = u[j] * scale;
  for (int i = 0; i < m; ++i) out_y[i] = u[n + i] * scale;
  *out_iters = k;
  return status;
}

}  // extern "C"
