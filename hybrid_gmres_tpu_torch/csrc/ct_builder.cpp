// Native fan-beam CT operator builder (C ABI, loaded via ctypes).
//
// Produces the same operators as the numpy reference implementation in
// problems/ct.py (ray-driven Joseph-style forward projector A and a
// pixel-driven, deliberately mismatched back-projector B), but ~20x faster:
// the operator assembly is the framework's data-loading path and belongs in
// native code (the reference has no native tier at all; this one is chosen
// by the framework's needs, not ported).
//
// Conventions match problems/ct.py exactly:
//  * image n x n pixels spanning [-n/2, n/2]^2, pixel (i, j) center at
//    (j - n/2 + 0.5, i - n/2 + 0.5), row-major flattening p = i * n + j;
//  * sources on a circle of radius R, angles phi_a = 2 pi a / n_angles;
//  * fan half-angle gmax = fan_margin * asin(min(n*sqrt(2)/2 / R, 1));
//  * detector gammas centered: g_d = ((d + 0.5) / n_det) * 2 gmax - gmax;
//  * forward: sample every `step` pixels along each ray from the source,
//    t in (k + 0.5) * step, bilinear scatter of weight `step` while
//    |x|,|y| <= n/2 + 1;
//  * backprojector: project each pixel center onto the detector coordinate,
//    linear interpolation over the two nearest bins.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Accum {
  // dense row accumulator with touched-list for exact duplicate merging
  std::vector<double> val;
  std::vector<int32_t> touched;
  std::vector<uint8_t> mark;
  explicit Accum(int32_t ncols) : val(ncols, 0.0), mark(ncols, 0) {
    touched.reserve(1024);
  }
  inline void add(int32_t c, double w) {
    if (!mark[c]) {
      mark[c] = 1;
      touched.push_back(c);
    }
    val[c] += w;
  }
  template <typename F>
  inline int64_t flush(F&& emit) {
    // emit in ascending column order (CSR canonical form)
    std::sort(touched.begin(), touched.end());
    int64_t cnt = 0;
    for (int32_t c : touched) {
      emit(c, val[c]);
      val[c] = 0.0;
      mark[c] = 0;
      ++cnt;
    }
    touched.clear();
    return cnt;
  }
};

}  // namespace

extern "C" {

// Forward projector: CSR of shape (n_angles*n_det, n*n).
// Caller allocates indptr (rows+1), indices (cap), data (cap).
// Returns nnz, or -1 if cap exceeded.
int64_t build_fan_projector(int32_t n, int32_t n_angles, int32_t n_det,
                            double source_radius, double fan_margin,
                            double step, int64_t* indptr, int32_t* indices,
                            double* data, int64_t cap) {
  const double half_diag = n * std::sqrt(2.0) / 2.0;
  const double gmax =
      fan_margin * std::asin(std::min(half_diag / source_radius, 1.0));
  const double t_max = 2.0 * source_radius;
  const int64_t n_samp = (int64_t)std::ceil(t_max / step);
  const int32_t npix = n * n;

  Accum acc(npix);
  int64_t nnz = 0;
  indptr[0] = 0;
  int64_t row = 0;
  for (int32_t a = 0; a < n_angles; ++a) {
    const double phi = 2.0 * M_PI * a / n_angles;
    const double sx = source_radius * std::cos(phi);
    const double sy = source_radius * std::sin(phi);
    const double base = std::atan2(-sy, -sx);
    for (int32_t d = 0; d < n_det; ++d, ++row) {
      const double gamma = ((d + 0.5) / n_det) * 2.0 * gmax - gmax;
      const double ang = base + gamma;
      const double dx = std::cos(ang), dy = std::sin(ang);
      for (int64_t k = 0; k < n_samp; ++k) {
        const double t = (k + 0.5) * step;
        const double x = sx + dx * t;
        const double y = sy + dy * t;
        if (std::fabs(x) > n / 2.0 + 1.0 || std::fabs(y) > n / 2.0 + 1.0)
          continue;
        const double gx = x + n / 2.0 - 0.5;
        const double gy = y + n / 2.0 - 0.5;
        const double fj = std::floor(gx), fi = std::floor(gy);
        const int64_t j0 = (int64_t)fj, i0 = (int64_t)fi;
        const double ax = gx - fj, ay = gy - fi;
        const double w[4] = {(1 - ax) * (1 - ay), ax * (1 - ay),
                             (1 - ax) * ay, ax * ay};
        const int64_t ii[4] = {i0, i0, i0 + 1, i0 + 1};
        const int64_t jj[4] = {j0, j0 + 1, j0, j0 + 1};
        for (int q = 0; q < 4; ++q) {
          if (ii[q] >= 0 && ii[q] < n && jj[q] >= 0 && jj[q] < n)
            acc.add((int32_t)(ii[q] * n + jj[q]), step * w[q]);
        }
      }
      const int64_t added = acc.flush([&](int32_t c, double v) {
        if (nnz < cap) {
          indices[nnz] = c;
          data[nnz] = v;
        }
        ++nnz;
      });
      (void)added;
      if (nnz > cap) return -1;
      indptr[row + 1] = nnz;
    }
  }
  return nnz;
}

// Pixel-driven back-projector: CSR of shape (n*n, n_angles*n_det).
int64_t build_pixel_backprojector(int32_t n, int32_t n_angles, int32_t n_det,
                                  double source_radius, double fan_margin,
                                  int64_t* indptr, int32_t* indices,
                                  double* data, int64_t cap) {
  const double half_diag = n * std::sqrt(2.0) / 2.0;
  const double gmax =
      fan_margin * std::asin(std::min(half_diag / source_radius, 1.0));
  const int32_t nrays = n_angles * n_det;

  // precompute source positions / base angles
  std::vector<double> sxs(n_angles), sys(n_angles), bases(n_angles);
  for (int32_t a = 0; a < n_angles; ++a) {
    const double phi = 2.0 * M_PI * a / n_angles;
    sxs[a] = source_radius * std::cos(phi);
    sys[a] = source_radius * std::sin(phi);
    bases[a] = std::atan2(-sys[a], -sxs[a]);
  }

  Accum acc(nrays);
  int64_t nnz = 0;
  indptr[0] = 0;
  int64_t row = 0;
  for (int32_t i = 0; i < n; ++i) {
    for (int32_t j = 0; j < n; ++j, ++row) {
      const double px = j + 0.5 - n / 2.0;
      const double py = i + 0.5 - n / 2.0;
      for (int32_t a = 0; a < n_angles; ++a) {
        double ang = std::atan2(py - sys[a], px - sxs[a]) - bases[a];
        // wrap to (-pi, pi]
        ang = std::fmod(ang + M_PI, 2.0 * M_PI);
        if (ang < 0) ang += 2.0 * M_PI;
        ang -= M_PI;
        const double det_coord = (ang + gmax) / (2.0 * gmax) * n_det - 0.5;
        const double fd = std::floor(det_coord);
        const int64_t d0 = (int64_t)fd;
        const double f = det_coord - fd;
        if (d0 >= 0 && d0 < n_det)
          acc.add((int32_t)(a * n_det + d0), 1.0 - f);
        if (d0 + 1 >= 0 && d0 + 1 < n_det)
          acc.add((int32_t)(a * n_det + d0 + 1), f);
      }
      acc.flush([&](int32_t c, double v) {
        if (nnz < cap) {
          indices[nnz] = c;
          data[nnz] = v;
        }
        ++nnz;
      });
      if (nnz > cap) return -1;
      indptr[row + 1] = nnz;
    }
  }
  return nnz;
}

}  // extern "C"
