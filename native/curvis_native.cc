// curvis_native — C++ runtime components of the curvis_tpu framework.
//
// The accelerator compute path is JAX/XLA/Pallas; this library provides the native
// host-runtime pieces around it (the role the reference's Rust plays outside
// the inner math):
//
//   cn_load_path        camera-path CSV loader (csv.rs:24-61 schema)
//   cn_march_planar_f64 double-precision CPU planar march — the golden
//                       oracle executor for parity gates (same escape
//                       semantics as systems.rs:115-139)
//   cn_doubly_sample    the adaptive-sampling driver loop
//                       (sampling.rs:46-124 semantics): C++ owns the
//                       refinement bookkeeping and calls back into a
//                       batched evaluator (a jitted device bundle on the
//                       Python side)
//
// Pure C ABI (ctypes); no Python.h.  Build: make -C native (g++ -O3 -shared).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSV camera-path loader.  Schema: header line ignored, then 10
// comma-separated doubles per row (t,l,theta,phi, fx,fy,fz, ux,uy,uz).
// Two-call pattern: out == nullptr -> returns row count (or -1 on error);
// otherwise fills out[10 * cap_rows] row-major and returns rows written.
// ---------------------------------------------------------------------------
int cn_load_path(const char* path, double* out, int cap_rows) {
  FILE* f = std::fopen(path, "r");
  if (!f) return -1;
  char line[4096];
  int row = 0;
  bool first = true;
  while (std::fgets(line, sizeof line, f)) {
    if (first) { first = false; continue; }            // skip header
    // skip blank lines
    bool blank = true;
    for (char* c = line; *c; ++c)
      if (!std::isspace((unsigned char)*c)) { blank = false; break; }
    if (blank) continue;
    if (out) {
      if (row >= cap_rows) { std::fclose(f); return -2; }
      double v[10];
      char* p = line;
      for (int k = 0; k < 10; ++k) {
        char* end = nullptr;
        v[k] = std::strtod(p, &end);
        if (end == p) { std::fclose(f); return -3; }   // parse error
        p = end;
        while (*p == ',' || *p == ' ') ++p;
      }
      std::memcpy(out + 10 * row, v, sizeof v);
    }
    ++row;
  }
  std::fclose(f);
  return row;
}

// ---------------------------------------------------------------------------
// f64 planar march (CPU oracle).  kind: 0 = Ellis(rho), 1 = DNEG(m, a, rho),
// 2 = flat.  stepper: 0 = Euler (reference parity), 1 = RK4.
// State arrays are updated in place; sign/steps written out.
// ---------------------------------------------------------------------------
namespace {

struct Shape {
  int kind;
  double p0, p1, p2;
  inline double r(double l) const {
    switch (kind) {
      case 0: return std::sqrt(p0 * p0 + l * l);
      case 1: {
        const double m = p0, a = p1, rho = p2;
        const double al = std::fabs(l);
        if (al <= a) return rho;
        const double x = 2.0 * (al - a) / (M_PI * m);
        return rho + m * (x * std::atan(x) - 0.5 * std::log1p(x * x));
      }
      default: return l;
    }
  }
  inline double r2(double l) const {
    if (kind == 0) return p0 * p0 + l * l;
    const double rr = r(l);
    return rr * rr;
  }
  inline double dr(double l) const {
    switch (kind) {
      case 0: return l / std::sqrt(p0 * p0 + l * l);
      case 1: {
        const double m = p0, a = p1;
        const double al = std::fabs(l);
        if (al <= a) return 0.0;
        const double x = 2.0 * (al - a) / (M_PI * m);
        return (2.0 / M_PI) * (l > 0 ? 1.0 : -1.0) * std::atan(x);
      }
      default: return 1.0;
    }
  }
};

struct Deriv { double dl, dpsi, dpl; };

inline Deriv rhs(const Shape& s, double l, double pl, double b) {
  const double r2 = s.r2(l);
  const double r = s.r(l);
  return {pl, b / r2, b * b * s.dr(l) / (r2 * r)};
}

}  // namespace

void cn_march_planar_f64(int kind, const double* params, int n, double* l,
                         double* psi, double* pl, const double* b, double dt,
                         int max_steps, double escape_radius, int stepper,
                         int32_t* sign, int32_t* steps) {
  const Shape s{kind, params[0], params[1], params[2]};
  for (int i = 0; i < n; ++i) {
    double li = l[i], pi = psi[i], pli = pl[i];
    const double bi = b[i];
    int32_t sg = 0;
    int it = 0;
    for (; it < max_steps; ++it) {
      if (stepper == 0) {
        const Deriv d = rhs(s, li, pli, bi);
        li += dt * d.dl; pi += dt * d.dpsi; pli += dt * d.dpl;
      } else {
        const Deriv k1 = rhs(s, li, pli, bi);
        const Deriv k2 = rhs(s, li + 0.5 * dt * k1.dl, pli + 0.5 * dt * k1.dpl, bi);
        const Deriv k3 = rhs(s, li + 0.5 * dt * k2.dl, pli + 0.5 * dt * k2.dpl, bi);
        const Deriv k4 = rhs(s, li + dt * k3.dl, pli + dt * k3.dpl, bi);
        li += dt / 6.0 * (k1.dl + 2 * k2.dl + 2 * k3.dl + k4.dl);
        pi += dt / 6.0 * (k1.dpsi + 2 * k2.dpsi + 2 * k3.dpsi + k4.dpsi);
        pli += dt / 6.0 * (k1.dpl + 2 * k2.dpl + 2 * k3.dpl + k4.dpl);
      }
      if (li > escape_radius) { sg = 1; ++it; break; }
      if (li < -escape_radius) { sg = -1; ++it; break; }
    }
    l[i] = li; psi[i] = pi; pl[i] = pli;
    sign[i] = sg;
    steps[i] = it;
  }
}

// ---------------------------------------------------------------------------
// Full-image f64 naive render — the independent end-to-end golden oracle for
// the reference's exact naive pixel semantics (SURVEY.md section 3.4 chain):
//   camera ray        cameras.rs:150-172 (pixel-corner fractions, -sw, +sh)
//   photon spawn      metrics.rs:301-334 fed the WORLD direction unrotated
//                     (systems.rs:531-534 — "identity" frame convention)
//   Euler march       metrics.rs:283-297 with the A7 RHS (metrics.rs:223-270)
//   escape test       post-step strict l > R / l < -R (systems.rs:126-135)
//   readout           relativistic_vector_to_direction INCLUDING the
//                     frame_field_22-for-33 bug (metrics.rs:339-349), rotated
//                     by the minimal rotation x_hat -> r_hat(theta, phi)
//                     (systems.rs:144-187, algebra.rs:92-101)
//   texel lookup      nearest with the (0.5 - phi/2pi) mod 1 horizontal flip
//                     (images.rs:115-121), identity background orientation
// Implemented with libm doubles, no JAX anywhere — a genuinely independent
// executor gating render_direct(method='frame3d') in tests/test_golden.py.
// ---------------------------------------------------------------------------
namespace {

inline void minimal_rotation_apply(double tx, double ty, double tz,
                                   const double u[3], double w[3]) {
  // Rotation taking x_hat to the unit vector t, applied to u (Rodrigues).
  // Degenerate t ~ +-x_hat handled like nalgebra's rotation_between limit.
  double kx = 0.0, ky = -tz, kz = ty;            // x_hat cross t
  const double s2 = ky * ky + kz * kz;
  const double c = tx;                           // x_hat dot t
  if (s2 < 1e-300) {                             // parallel / antiparallel
    if (c > 0) { w[0] = u[0]; w[1] = u[1]; w[2] = u[2]; }
    else { w[0] = -u[0]; w[1] = -u[1]; w[2] = u[2]; }   // 180deg about z
    return;
  }
  const double s = std::sqrt(s2);
  kx = 0.0; ky /= s; kz /= s;
  const double kd = ky * u[1] + kz * u[2];       // k . u (kx = 0)
  const double cx = ky * u[2] - kz * u[1];       // k x u
  const double cy = kz * u[0];
  const double cz = -ky * u[0];
  const double omc = 1.0 - c;
  w[0] = u[0] * c + cx * s + kx * kd * omc;
  w[1] = u[1] * c + cy * s + ky * kd * omc;
  w[2] = u[2] * c + cz * s + kz * kd * omc;
}

}  // namespace

// Renders an (res_y, res_x, 3) row-major f64 image.  cam = [l0, theta0,
// phi0, focal, diag]; R = 3x3 camera->world rotation, row-major (world = R v).
// bgp/bgn: (bh, bw, 3) row-major f64 textures, identity orientation.
void cn_render_naive_f64(int kind, const double* params, const double* cam,
                         const double* R, int res_x, int res_y,
                         const double* bgp, int ph_, int pw_,
                         const double* bgn, int nh_, int nw_, double dt,
                         int max_steps, double escape_radius, double* out) {
  const Shape s{kind, params[0], params[1], params[2]};
  const double l0 = cam[0], th0 = cam[1], ph0 = cam[2];
  const double focal = cam[3], diag = cam[4];
  const double aspect = (double)res_x / (double)res_y;
  const double sh = std::sqrt(diag * diag / (aspect * aspect + 1.0));
  const double sw = aspect * sh;
  const double r0 = s.r(l0);
  const double st0 = std::sin(th0);

  for (int px = 0; px < res_x; ++px) {
    for (int py = 0; py < res_y; ++py) {
      // camera ray (cameras.rs:150-172; pixel corners, no +0.5)
      const double wf = (double)px / res_x - 0.5;
      const double hf = 0.5 - (double)py / res_y;
      double v[3] = {focal, -sw * wf, sh * hf};
      const double vn = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
      v[0] /= vn; v[1] /= vn; v[2] /= vn;
      double d[3] = {R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
                     R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
                     R[6] * v[0] + R[7] * v[1] + R[8] * v[2]};
      // identity-frame spawn (systems.rs:531-534 -> metrics.rs:301-334);
      // d is unit already
      double pt = 1.0, pl = d[0], pth = d[1] * r0, pph = d[2] * r0 * st0;
      double t = 0.0, l = l0, th = th0, ph = ph0;
      (void)pt; (void)t;
      int sg = 0;
      for (int it = 0; it < max_steps; ++it) {
        // A7 RHS (metrics.rs:223-270) + explicit Euler (metrics.rs:283-297)
        const double r2 = s.r2(l);
        const double r = s.r(l);
        const double stt = std::sin(th);
        const double s2 = stt * stt;
        const double b2 = pth * pth + pph * pph / s2;
        const double dl = pl;
        const double dth = pth / r2;
        const double dph = pph / (r2 * s2);
        const double dpl = b2 * s.dr(l) / (r2 * r);
        const double dpth = pph * pph * std::cos(th) / (r2 * s2 * stt);
        l += dt * dl; th += dt * dth; ph += dt * dph;
        pl += dt * dpl; pth += dt * dpth;
        if (l > escape_radius) { sg = 1; break; }
        if (l < -escape_radius) { sg = -1; break; }
      }
      double rgb[3] = {0.0, 0.0, 0.0};
      if (sg != 0) {
        // readout with the ff22 bug: third component scaled by r, not
        // r sin(theta) (metrics.rs:344-348)
        const double r2 = s.r2(l);
        const double r = s.r(l);
        const double stt = std::sin(th);
        double u[3] = {pl, (pth / r2) * r, (pph / (r2 * stt * stt)) * r};
        // minimal rotation x_hat -> r_hat(theta, phi) (systems.rs:144-187)
        const double rx = stt * std::cos(ph);
        const double ry = stt * std::sin(ph);
        const double rz = std::cos(th);
        double w[3];
        minimal_rotation_apply(rx, ry, rz, u, w);
        const double wn = std::sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
        // texel (images.rs:115-121; theta-phi normalization algebra.rs:106)
        const double theta_i = std::acos(std::fmax(-1.0, std::fmin(1.0, w[2] / wn)));
        double phi_i = std::atan2(w[1], w[0]);
        double uu = std::fmod(0.5 - phi_i / (2.0 * M_PI), 1.0);
        if (uu < 0.0) uu += 1.0;
        const double vv = theta_i / M_PI;
        const double* tex = (sg == 1) ? bgp : bgn;
        const int W = (sg == 1) ? pw_ : nw_;
        const int H = (sg == 1) ? ph_ : nh_;
        int xi = (int)(uu * W); if (xi > W - 1) xi = W - 1; if (xi < 0) xi = 0;
        int yi = (int)(vv * H); if (yi > H - 1) yi = H - 1; if (yi < 0) yi = 0;
        const double* px3 = tex + 3 * (yi * W + xi);
        rgb[0] = px3[0]; rgb[1] = px3[1]; rgb[2] = px3[2];
      }
      double* o = out + 3 * (py * res_x + px);
      o[0] = rgb[0]; o[1] = rgb[1]; o[2] = rgb[2];
    }
  }
}

// ---------------------------------------------------------------------------
// Adaptive sampling driver (sampling.rs:46-124 semantics, quirks included).
// The evaluator callback receives a batch of alphas and writes escapes/signs;
// on the Python side it is a jitted device bundle.
// ---------------------------------------------------------------------------
typedef void (*cn_eval_fn)(const double* alphas, int n, double* out_e,
                           double* out_s, void* ctx);

namespace {

struct BiPoint { double a, e, s; };

inline bool finite3(const BiPoint& p) {
  return std::isfinite(p.a) && std::isfinite(p.e) && std::isfinite(p.s);
}

std::vector<BiPoint> clean(const std::vector<BiPoint>& v) {
  std::vector<BiPoint> out;
  out.reserve(v.size());
  for (const auto& p : v) if (finite3(p)) out.push_back(p);
  return out;
}

inline void scores(const BiPoint& p1, const BiPoint& p2, const BiPoint& p3,
                   double* s1, double* s2) {
  *s1 = std::fabs((p1.a * p2.e + p2.a * p3.e + p3.a * p1.e) -
                  (p1.e * p2.a + p2.e * p3.a + p3.e * p1.a));
  *s2 = std::fabs((p1.a * p2.s + p2.a * p3.s + p3.a * p1.s) -
                  (p1.s * p2.a + p2.s * p3.a + p3.s * p1.a));
}

}  // namespace

// Returns number of points written to out (a*3 layout: a, e, s per row), or
// -1 if the output capacity was exceeded, -2 if a pass had < 3 points.
int cn_doubly_sample(double a_min, double a_max, int n0, int max_iter,
                     double thr1, double thr2, cn_eval_fn eval, void* ctx,
                     double* out, int cap) {
  std::vector<double> xs(n0);
  const double step = (a_max - a_min) / (n0 - 1);
  for (int i = 0; i < n0; ++i) xs[i] = a_min + i * step;
  std::vector<double> es(n0), ss(n0);
  eval(xs.data(), n0, es.data(), ss.data(), ctx);
  std::vector<BiPoint> pts;
  for (int i = 0; i < n0; ++i) pts.push_back({xs[i], es[i], ss[i]});
  pts = clean(pts);

  int iter = 0;
  while (iter < max_iter) {
    const size_t prev = pts.size();
    // one refine pass (sampling.rs:144-195)
    pts = clean(pts);
    if (pts.size() < 3) return -2;
    struct Op { bool refine; size_t i; };
    std::vector<Op> plan;
    std::vector<double> mids;
    size_t i = 0;
    while (i + 2 < pts.size()) {
      double s1, s2;
      scores(pts[i], pts[i + 1], pts[i + 2], &s1, &s2);
      if (!(s1 > thr1 || s2 > thr2)) {
        plan.push_back({false, i});
        i += 1;
      } else {
        plan.push_back({true, i});
        mids.push_back(0.5 * (pts[i].a + pts[i + 1].a));
        mids.push_back(0.5 * (pts[i + 1].a + pts[i + 2].a));
        i += 2;
      }
    }
    std::vector<double> me(mids.size()), ms(mids.size());
    if (!mids.empty())
      eval(mids.data(), (int)mids.size(), me.data(), ms.data(), ctx);
    std::vector<BiPoint> next;
    size_t k = 0;
    for (const Op& op : plan) {
      if (!op.refine) {
        next.push_back(pts[op.i]);
      } else {
        next.push_back(pts[op.i]);
        next.push_back({mids[k], me[k], ms[k]});
        next.push_back(pts[op.i + 1]);
        next.push_back({mids[k + 1], me[k + 1], ms[k + 1]});
        k += 2;
      }
    }
    pts = clean(next);

    if (pts.size() < prev) break;          // sampling.rs:98-103
    if (pts.size() == prev) break;
    ++iter;
  }
  if (iter == max_iter)
    std::fprintf(stdout,
                 "Warning: maximum number of iterations (%d) reached in "
                 "sampling algorithm.\n", max_iter);

  if ((int)pts.size() > cap) return -1;
  for (size_t j = 0; j < pts.size(); ++j) {
    out[3 * j] = pts[j].a;
    out[3 * j + 1] = pts[j].e;
    out[3 * j + 2] = pts[j].s;
  }
  return (int)pts.size();
}

}  // extern "C"
