// Per-lane body of the Whitted raytracer on analytic scenes: every depth
// of one lane -- the sphere / plane closest hit, light-hit emission,
// point-light direct lighting with a hard shadow test per light, and the
// dielectric / mirror continuation.
//
// Port of the JAX package's Pallas kernel body ops/whitted_kernel.py
// (_whitted_kernel), which replicates models/whitted.trace_whitted.  Every
// predicate, epsilon, RNG draw and f32 association follows it op for op
// (build without contraction or fast-math).  As in both JAX versions, a
// lane steps its xorshift32 state once per depth whether its path is
// alive or not, so states match on every lane; the path tracers of
// pt_device.cuh freeze a dead lane instead.
//
// Arithmetic whose result cannot reach a lane's outputs is skipped, and
// nothing else changes, so every output stays bitwise: the normal of a
// light hit, the lights of a surface with no diffuse weight, and the
// refraction and Fresnel term of a surface that is not a dielectric
// (whitted_depth); pt_device.cuh's sphere and plane tests skip the square
// root and the division where no hit is possible.

#pragma once

#include "pt_device.cuh"

namespace pt {

// The ray inputs' and traced output's layout of a Whitted launch
// (ops/whitted_kernel.py _WhittedIO mirrors it): lane i's ray component c
// is p.ray[c][i * stride], its energy component c p.en_out[c][3 i] (rows
// of an (n, 3) tensor), and the launch's traced rays one int64 total.
struct WhittedIO {
  // the lane stride of the origin (p.ray[0..2]) and direction
  // (p.ray[3..5]) inputs: 1 for columns, 3 for (n, 3) rows, 0 for one
  // origin shared by every lane
  long long o_stride, d_stride;
  void* traced;   // () int64 out: the rays every lane traced
  void* scratch;  // one u64, zero between launches (whitted.cu add_traced)
};

// One lane's path between depths.
struct WPath {
  float ox, oy, oz, dx, dy, dz;
  float tpx, tpy, tpz, enx, eny, enz;
  uint32_t st;
  int tr;  // rays traced: one per live depth plus one per shadow ray
  bool act;
};

// One depth of the live path c.  kTrips: count it (Counters ray, sray).
template <bool kTrips>
PT_HD void whitted_depth(const Tables& tb, WPath& c, Counters& cnt) {
  c.tr += 1;
  if constexpr (kTrips) ++cnt.ray;
  float t = RAY_TMAX;
  int kind = 0;
  analytic_tests(tb, c.ox, c.oy, c.oz, c.dx, c.dy, c.dz, t, kind);
  if (kind == 0) {  // miss
    c.act = false;
    c.st = xs32(c.st);
    return;
  }

  // hit surface (models/scene.hit_surface, analytic arms)
  const float px = c.ox + c.dx * t, py = c.oy + c.dy * t,
              pz = c.oz + c.dz * t;
  const bool sph = kind <= tb.num_sph;
  int mat_idx = sph ? tb.sphmat[kind - 1] : tb.plnmat[kind - 1 - tb.num_sph];
  if (mat_idx < 0 || mat_idx >= tb.num_mats) mat_idx = 0;
  const float* M = tb.mats + M_COLS * mat_idx;

  // light hit: emission, then the path ends (before its normal, which
  // nothing reads)
  if (M[M_IS_LIGHT] > 0.5f) {
    const float inten = M[M_INTENSITY];
    c.enx = c.enx + c.tpx * M[M_EMISSIVE] * inten;
    c.eny = c.eny + c.tpy * M[M_EMISSIVE + 1] * inten;
    c.enz = c.enz + c.tpz * M[M_EMISSIVE + 2] * inten;
    c.act = false;
    c.st = xs32(c.st);
    return;
  }
  float nx, ny, nz;
  if (sph) {
    const float* sp = tb.sph + S_COLS * (kind - 1);
    float vx = px - sp[0], vy = py - sp[1], vz = pz - sp[2];
    float l_s = sqrtf(vx * vx + vy * vy + vz * vz);
    nx = vx / l_s;
    ny = vy / l_s;
    nz = vz / l_s;
  } else {
    const float* pp = tb.pln + P_COLS * (kind - 1 - tb.num_sph);
    nx = pp[3];
    ny = pp[4];
    nz = pp[5];
  }
  const float alb_r = M[M_ALBEDO], alb_g = M[M_ALBEDO + 1],
              alb_b = M[M_ALBEDO + 2];
  const float m_spec = M[M_SPECULAR], m_refr = M[M_REFRACT];

  // direct lighting: every light a point light at its center, hard
  // shadows stopping at the light sphere's surface, lights in order;
  // nothing of a light reaches the path unless dw > 0
  const float dw = fmaxf(0.0f, 1.0f - m_spec - m_refr);
  float dir_r = 0.0f, dir_g = 0.0f, dir_b = 0.0f;
  for (int li = 0; dw > 0.0f && li < tb.num_lights; ++li) {
    const float* L = tb.lights + L_COLS * li;
    float tlx = L[L_CENTER] - px, tly = L[L_CENTER + 1] - py,
          tlz = L[L_CENTER + 2] - pz;
    const float dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const float d_d = fmaxf(dist, 1e-20f);
    tlx = tlx / d_d;
    tly = tly / d_d;
    tlz = tlz / d_d;
    const float ndotl = nx * tlx + ny * tly + nz * tlz;
    if (!(ndotl > 0.0f)) continue;
    c.tr += 1;
    if constexpr (kTrips) ++cnt.sray;
    const float stmax = dist - L[L_RADIUS] - TWO_NUDGE;
    if (analytic_occluded(tb, px + tlx * RAY_NUDGE, py + tly * RAY_NUDGE,
                          pz + tlz * RAY_NUDGE, tlx, tly, tlz, stmax)) {
      continue;
    }
    const float atten = 1.0f / fmaxf(dist * dist, 1e-20f);
    dir_r = dir_r + (ndotl * atten) * L[L_EMISSION];
    dir_g = dir_g + (ndotl * atten) * L[L_EMISSION + 1];
    dir_b = dir_b + (ndotl * atten) * L[L_EMISSION + 2];
  }
  c.enx = c.enx + c.tpx * dw * alb_r * dir_r;
  c.eny = c.eny + c.tpy * dw * alb_g * dir_g;
  c.enz = c.enz + c.tpz * dw * alb_b * dir_b;

  // continuation: dielectric first, else mirror, else the path ends (its
  // throughput is never read again)
  const float dx = c.dx, dy = c.dy, dz = c.dz;
  const float ddn = dx * nx + dy * ny + dz * nz;
  const float rfx = dx - 2.0f * nx * ddn;
  const float rfy = dy - 2.0f * ny * ddn;
  const float rfz = dz - 2.0f * nz * ddn;
  c.st = xs32(c.st);
  if (!(m_refr > 0.0f)) {  // the draw is the dielectric's alone
    if (m_spec > 0.0f) {
      c.tpx = c.tpx * (m_spec * alb_r);
      c.tpy = c.tpy * (m_spec * alb_g);
      c.tpz = c.tpz * (m_spec * alb_b);
      c.ox = px + rfx * RAY_NUDGE;
      c.oy = py + rfy * RAY_NUDGE;
      c.oz = pz + rfz * RAY_NUDGE;
      c.dx = rfx;
      c.dy = rfy;
      c.dz = rfz;
    } else {
      c.act = false;
    }
    return;
  }
  const float m_ior = M[M_IOR];
  const float cosi_raw = fminf(fmaxf(ddn, -1.0f), 1.0f);
  const bool outside = cosi_raw < 0.0f;
  const float cosi = fabsf(cosi_raw);
  const float etai = outside ? 1.0f : m_ior;
  const float etat = outside ? m_ior : 1.0f;
  const float nrx = outside ? nx : -nx, nry = outside ? ny : -ny,
              nrz = outside ? nz : -nz;
  const float eta = etai / etat;
  const float kk = 1.0f - eta * eta * (1.0f - cosi * cosi);
  const bool tir = kk < 0.0f;
  const float coef = eta * cosi - sqrtf(fmaxf(kk, 0.0f));
  float rx = dx * eta + coef * nrx;
  float ry = dy * eta + coef * nry;
  float rz = dz * eta + coef * nrz;
  const float l_r = sqrtf(rx * rx + ry * ry + rz * rz);
  rx = rx / l_r;
  ry = ry / l_r;
  rz = rz / l_r;
  const float angle_out = rx * nx + ry * ny + rz * nz;
  const float s_pol = (etai * ddn - etat * angle_out) /
                      (etai * ddn + etat * angle_out);
  const float p_pol = (etai * angle_out - etat * ddn) /
                      (etai * angle_out + etat * ddn);
  const float fr = 0.5f * (s_pol * s_pol + p_pol * p_pol);
  // refract when the draw passes the Fresnel term, else reflect (always
  // under total internal reflection)
  const bool refract = !tir && u2f(c.st) > fr;
  float tm_r = m_refr * alb_r, tm_g = m_refr * alb_g, tm_b = m_refr * alb_b;
  if (refract && !outside) {
    // Beer's-law absorption on medium exit
    tm_r = m_refr * alb_r * expf(-M[M_ABSORB] * t);
    tm_g = m_refr * alb_g * expf(-M[M_ABSORB + 1] * t);
    tm_b = m_refr * alb_b * expf(-M[M_ABSORB + 2] * t);
  }
  c.tpx = c.tpx * tm_r;
  c.tpy = c.tpy * tm_g;
  c.tpz = c.tpz * tm_b;
  const float ndx = refract ? rx : rfx;
  const float ndy = refract ? ry : rfy;
  const float ndz = refract ? rz : rfz;
  c.ox = px + ndx * RAY_NUDGE;
  c.oy = py + ndy * RAY_NUDGE;
  c.oz = pz + ndz * RAY_NUDGE;
  c.dx = ndx;
  c.dy = ndy;
  c.dz = ndz;
}

// One depth of the count arm (kTrips): a warp trip when a lane of the
// warp is live, and its live lanes as lane trips (every thread of the warp
// takes part; the host build's warp is one lane).
PT_HD void count_live(unsigned long long* trips, bool live) {
#ifdef __CUDA_ARCH__
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (m && (threadIdx.x & 31u) == 0) {
    atomicAdd(trips, 1ull);
    atomicAdd(trips + 1, (unsigned long long)__popc(m));
  }
#else
  if (live) {
    trips[0] += 1;
    trips[1] += 1;
  }
#endif
}

// Every depth of one lane, by its own thread: reads its ray (io's
// layout) and state, writes its energy (a row of the (n, 3) output) and
// state, and returns the rays it traced.  kTrips (the count arm): count
// the live depths and shadow rays (ray, sray), each depth's live lanes per
// warp (count_live) and the lane's live depths as its path
// (Counters::longest); every thread of the warp calls it then, one past
// p.n (in false) as a dead lane that reads and writes nothing.
template <bool kTrips>
PT_HD int whitted_lane(const Params& p, const Tables& tb,
                       const WhittedIO& io, int lane, bool in,
                       Counters& cnt) {
  WPath c{};
  c.tpx = c.tpy = c.tpz = 1.0f;
  c.act = in;
  if (in) {
    const long long o = io.o_stride * lane, d = io.d_stride * lane;
    c.ox = p.ray[0][o];
    c.oy = p.ray[1][o];
    c.oz = p.ray[2][o];
    c.dx = p.ray[3][d];
    c.dy = p.ray[4][d];
    c.dz = p.ray[5][d];
    c.st = (uint32_t)p.state[lane];
  }
  unsigned long long live = 0;
  for (int d = 0; d < p.depths; ++d) {
    if constexpr (kTrips) {
      if (p.tree.trips) count_live(p.tree.trips, c.act);
      live += c.act;
    }
    if (c.act) {
      whitted_depth<kTrips>(tb, c, cnt);
    } else {
      c.st = xs32(c.st);  // the one draw of a depth, taken by dead lanes too
    }
  }
  if constexpr (kTrips) {
    if (live > cnt.longest) cnt.longest = live;
  }
  if (in) {
    const long long e = 3ll * lane;
    p.en_out[0][e] = c.enx;
    p.en_out[1][e] = c.eny;
    p.en_out[2][e] = c.enz;
    p.state_out[lane] = (long long)c.st;
  }
  return c.tr;
}

}  // namespace pt
