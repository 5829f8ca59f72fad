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

#pragma once

#include "pt_device.cuh"

namespace pt {

// Every depth of one lane: reads its ray and state from p.ray / p.state,
// writes energy (p.en_out), state (p.state_out) and the rays it traced
// (p.tr_out: one per live depth plus one per shadow ray).  Never fails.
PT_HD bool whitted_lane(const Params& p, const Tables& tb, int lane,
                        Counters& cnt) {
  float ox = p.ray[0][lane], oy = p.ray[1][lane], oz = p.ray[2][lane];
  float dx = p.ray[3][lane], dy = p.ray[4][lane], dz = p.ray[5][lane];
  uint32_t st = (uint32_t)p.state[lane];
  float tpx = 1.0f, tpy = 1.0f, tpz = 1.0f;
  float enx = 0.0f, eny = 0.0f, enz = 0.0f;
  bool act = true;
  int tr = 0;
  for (int d = 0; d < p.depths; ++d) {
    if (!act) {
      st = xs32(st);  // the one draw of a depth, taken by dead lanes too
      continue;
    }
    tr += 1;
    ++cnt.ray;
    float t = RAY_TMAX;
    int kind = 0;
    analytic_tests(tb, ox, oy, oz, dx, dy, dz, t, kind);
    if (kind == 0) {  // miss
      act = false;
      st = xs32(st);
      continue;
    }

    // hit surface (models/scene.hit_surface, analytic arms)
    const float px = ox + dx * t, py = oy + dy * t, pz = oz + dz * t;
    float nx, ny, nz;
    int mat_idx;
    if (kind <= tb.num_sph) {
      const float* sp = tb.sph + S_COLS * (kind - 1);
      float vx = px - sp[0], vy = py - sp[1], vz = pz - sp[2];
      float l_s = sqrtf(vx * vx + vy * vy + vz * vz);
      nx = vx / l_s;
      ny = vy / l_s;
      nz = vz / l_s;
      mat_idx = tb.sphmat[kind - 1];
    } else {
      const int q = kind - 1 - tb.num_sph;
      const float* pp = tb.pln + P_COLS * q;
      nx = pp[3];
      ny = pp[4];
      nz = pp[5];
      mat_idx = tb.plnmat[q];
    }
    if (mat_idx < 0 || mat_idx >= tb.num_mats) mat_idx = 0;
    const float* M = tb.mats + M_COLS * mat_idx;
    const float alb_r = M[M_ALBEDO], alb_g = M[M_ALBEDO + 1],
                alb_b = M[M_ALBEDO + 2];
    const float m_spec = M[M_SPECULAR], m_refr = M[M_REFRACT],
                m_ior = M[M_IOR];

    // light hit: emission, then the path ends
    if (M[M_IS_LIGHT] > 0.5f) {
      const float inten = M[M_INTENSITY];
      enx = enx + tpx * M[M_EMISSIVE] * inten;
      eny = eny + tpy * M[M_EMISSIVE + 1] * inten;
      enz = enz + tpz * M[M_EMISSIVE + 2] * inten;
      act = false;
      st = xs32(st);
      continue;
    }

    // direct lighting: every light a point light at its center, hard
    // shadows stopping at the light sphere's surface, lights in order
    const float dw = fmaxf(0.0f, 1.0f - m_spec - m_refr);
    float dir_r = 0.0f, dir_g = 0.0f, dir_b = 0.0f;
    for (int li = 0; li < tb.num_lights; ++li) {
      const float* L = tb.lights + L_COLS * li;
      float tlx = L[L_CENTER] - px, tly = L[L_CENTER + 1] - py,
            tlz = L[L_CENTER + 2] - pz;
      const float dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
      const float d_d = fmaxf(dist, 1e-20f);
      tlx = tlx / d_d;
      tly = tly / d_d;
      tlz = tlz / d_d;
      const float ndotl = nx * tlx + ny * tly + nz * tlz;
      if (!(dw > 0.0f && ndotl > 0.0f)) continue;
      tr += 1;
      ++cnt.sray;
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
    enx = enx + tpx * dw * alb_r * dir_r;
    eny = eny + tpy * dw * alb_g * dir_g;
    enz = enz + tpz * dw * alb_b * dir_b;

    // continuation: dielectric first, else mirror, else the path ends
    const float ddn = dx * nx + dy * ny + dz * nz;
    const float rfx = dx - 2.0f * nx * ddn;
    const float rfy = dy - 2.0f * ny * ddn;
    const float rfz = dz - 2.0f * nz * ddn;
    const float cosi_raw = fminf(fmaxf(ddn, -1.0f), 1.0f);
    const bool outside = cosi_raw < 0.0f;
    const bool inside = !outside;
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
    float fr = 0.5f * (s_pol * s_pol + p_pol * p_pol);
    if (tir) fr = 1.0f;
    st = xs32(st);
    const bool choose_refract = u2f(st) > fr;

    const bool has_refr = m_refr > 0.0f;
    const bool cont_diel = has_refr && !tir;
    const bool diel_refract = cont_diel && choose_refract;
    const bool diel_reflect = cont_diel && !choose_refract;
    const bool cont_spec = !has_refr && m_spec > 0.0f;
    const bool tir_reflect = has_refr && tir;
    const bool refl = cont_spec || diel_reflect || tir_reflect;

    float tm_r = 1.0f, tm_g = 1.0f, tm_b = 1.0f;
    if (diel_refract || diel_reflect || tir_reflect) {
      tm_r = m_refr * alb_r;
      tm_g = m_refr * alb_g;
      tm_b = m_refr * alb_b;
    }
    if (diel_refract && inside) {
      // Beer's-law absorption on medium exit
      tm_r = m_refr * alb_r * expf(-M[M_ABSORB] * t);
      tm_g = m_refr * alb_g * expf(-M[M_ABSORB + 1] * t);
      tm_b = m_refr * alb_b * expf(-M[M_ABSORB + 2] * t);
    }
    if (cont_spec) {
      tm_r = m_spec * alb_r;
      tm_g = m_spec * alb_g;
      tm_b = m_spec * alb_b;
    }
    tpx = tpx * tm_r;
    tpy = tpy * tm_g;
    tpz = tpz * tm_b;

    if (refl || diel_refract) {
      const float ndx = diel_refract ? rx : rfx;
      const float ndy = diel_refract ? ry : rfy;
      const float ndz = diel_refract ? rz : rfz;
      ox = px + ndx * RAY_NUDGE;
      oy = py + ndy * RAY_NUDGE;
      oz = pz + ndz * RAY_NUDGE;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    } else {
      act = false;
    }
  }
  p.en_out[0][lane] = enx;
  p.en_out[1][lane] = eny;
  p.en_out[2][lane] = enz;
  p.state_out[lane] = (long long)st;
  p.tr_out[lane] = tr;
  return true;
}

}  // namespace pt
