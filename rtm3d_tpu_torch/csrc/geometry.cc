// Batched rotated-rectangle intersection areas for the KITTI AP evaluator
// (rtm3d_tpu_torch/eval/ap.py): host C++, the port's own copy of the JAX
// package's native/geometry.cc.
//
// The devkit computes rotated-box overlap per det x gt pair with a polygon
// clip; in Python that is the evaluator's scaling wall. This library
// computes the whole det x gt intersection matrix in one call: a
// Sutherland-Hodgman clip of convex quads, in double precision.
//
// Box layout matches eval/ap.py::_bev_corners:
//   (x, z, w, l, ry) -> corners dx=[l/2,l/2,-l/2,-l/2], dz=[w/2,-w/2,-w/2,w/2]
//   rotated by rx = c*dx + s*dz, rz = -s*dx + c*dz.
//
// Built at first use by rtm3d_tpu_torch/utils/kernel_build.py (build_host):
//   c++ -O3 -std=c++17 -shared -fPIC -> rtm3d_tpu_torch/_build/geometry-<hash>.so

#include <cmath>
#include <cstdint>

namespace {

struct P {
  double x, y;
};

// corners of (x, z, w, l, ry) in the BEV plane
inline void corners(const float* b, P* out) {
  const double x = b[0], z = b[1], w = b[2], l = b[3], ry = b[4];
  const double c = std::cos(ry), s = std::sin(ry);
  const double dx[4] = {l / 2, l / 2, -l / 2, -l / 2};
  const double dz[4] = {w / 2, -w / 2, -w / 2, w / 2};
  for (int i = 0; i < 4; ++i) {
    out[i].x = x + c * dx[i] + s * dz[i];
    out[i].y = z - s * dx[i] + c * dz[i];
  }
}

// clip convex polygon (n verts) by half-plane left of edge p1->p2
inline int clip_edge(const P* poly, int n, P p1, P p2, P* out) {
  const double ex = p2.x - p1.x, ey = p2.y - p1.y;
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const P cur = poly[i];
    const P nxt = poly[(i + 1) % n];
    const double dc = ex * (cur.y - p1.y) - ey * (cur.x - p1.x);
    const double dn = ex * (nxt.y - p1.y) - ey * (nxt.x - p1.x);
    const bool ic = dc <= 1e-12, in_ = dn <= 1e-12;
    if (ic) {
      out[m++] = cur;
      if (!in_) {
        const double dx = nxt.x - cur.x, dy = nxt.y - cur.y;
        const double denom = ex * dy - ey * dx;
        if (std::fabs(denom) < 1e-12) {
          out[m++] = nxt;
        } else {
          const double t =
              (ex * (p1.y - cur.y) - ey * (p1.x - cur.x)) / denom;
          out[m++] = {cur.x + t * dx, cur.y + t * dy};
        }
      }
    } else if (in_) {
      const double dx = nxt.x - cur.x, dy = nxt.y - cur.y;
      const double denom = ex * dy - ey * dx;
      if (std::fabs(denom) < 1e-12) {
        out[m++] = nxt;
      } else {
        const double t = (ex * (p1.y - cur.y) - ey * (p1.x - cur.x)) / denom;
        out[m++] = {cur.x + t * dx, cur.y + t * dy};
      }
    }
  }
  return m;
}

inline double poly_area(const P* poly, int n) {
  if (n < 3) return 0.0;
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const P& p = poly[i];
    const P& q = poly[(i + 1) % n];
    a += p.x * q.y - q.x * p.y;
  }
  return std::fabs(a) * 0.5;
}

inline double rect_intersection(const P* ca, const P* cb) {
  // clip A by the 4 edges of B; vertex count stays <= 8 for quad-quad
  P buf0[16], buf1[16];
  for (int i = 0; i < 4; ++i) buf0[i] = ca[i];
  int n = 4;
  P* src = buf0;
  P* dst = buf1;
  for (int e = 0; e < 4; ++e) {
    n = clip_edge(src, n, cb[e], cb[(e + 1) % 4], dst);
    if (n == 0) return 0.0;
    P* t = src;
    src = dst;
    dst = t;
  }
  return poly_area(src, n);
}

}  // namespace

extern "C" {

// out[i*nb + j] = intersection area of a[i] with b[j]; boxes are (n, 5) f32
void bev_intersection_matrix(const float* a, int64_t na, const float* b,
                             int64_t nb, float* out) {
  // gt corner cache (nb is small; stack-free heap batch)
  P cb[64][4];
  P* heap_cb = nullptr;
  P(*cbp)[4] = cb;
  if (nb > 64) {
    heap_cb = new P[nb * 4];
    cbp = reinterpret_cast<P(*)[4]>(heap_cb);
  }
  for (int64_t j = 0; j < nb; ++j) corners(b + j * 5, cbp[j]);
  for (int64_t i = 0; i < na; ++i) {
    P ca[4];
    corners(a + i * 5, ca);
    for (int64_t j = 0; j < nb; ++j) {
      out[i * nb + j] = static_cast<float>(rect_intersection(ca, cbp[j]));
    }
  }
  delete[] heap_cb;
}

}  // extern "C"
