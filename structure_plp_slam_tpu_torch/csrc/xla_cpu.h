/* XLA:CPU's x86-64 arithmetic, shared by the port's CPU sources
 * (pose_solve_cpu.c, ba_solve_cpu.c): the operations XLA's kernels perform,
 * in their order. fmaf() is a fused multiply-add, every other operator rounds
 * to f32 (build with -ffp-contract=off). x86-64 only: XLA:CPU's rsqrt is the
 * SSE rsqrtss instruction, whose last bits other CPUs do not give. */
#ifndef XLA_CPU_H
#define XLA_CPU_H
#if !defined(__x86_64__)
#error "the port's CPU sources compute XLA:CPU's x86-64 arithmetic (rsqrtss) and build on x86-64 only"
#endif
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <immintrin.h>

/* XLA:CPU's rsqrt: rsqrtss, then two Newton steps. */
static float xla_rsqrt(float x) {
  float y0 = _mm_cvtss_f32(_mm_rsqrt_ss(_mm_set_ss(x)));
  uint32_t bits;
  memcpy(&bits, &x, 4);
  float y = y0;
  for (int it = 0; it < 2; it++) {
    float t = fmaf(x * y, y, -1.0f);
    y = fmaf(-0.5f * y, t, y);
  }
  if ((bits & 0x7fffffffu) == 0 || bits - 1u < 0x7fffffu || bits == 0x7f800000u) return y0;
  return y;
}

static float fmax_xla(float a, float b) { return a > b ? a : b; }
static float fmin_xla(float a, float b) { return a < b ? a : b; }

static float safe_z(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

/* sum_k a[k * sa] * b[k * sb] as one chain from 0 (XLA's small dots). */
static float dot_chain0(const float* a, int sa, const float* b, int sb, int K) {
  float acc = 0.0f;
  for (int k = 0; k < K; k++) acc = fmaf(a[k * sa], b[k * sb], acc);
  return acc;
}

/* The reduce XLA:CPU emits for jnp.sum over n values at stride s: while more
 * than 32 values are left, windows of 32 with the padding split around them
 * (the lower half in front), each window summed in order from 0; then the
 * last values in order from 0. */
static float tree_sum(const float* x, long s, int n) {
  float buf[2][(n + 31) / 32 + 1];
  const float* src = x;
  int cur = 0;
  while (n > 32) {
    int nw = (n + 31) / 32;
    int lo = (nw * 32 - n) / 2;
    for (int w = 0; w < nw; w++) {
      float acc = 0.0f;
      for (int j = 32 * w - lo; j < 32 * w - lo + 32; j++)
        if (j >= 0 && j < n) acc += src[j * s];
      buf[cur][w] = acc;
    }
    src = buf[cur];
    s = 1;
    cur ^= 1;
    n = nw;
  }
  float total = 0.0f;
  for (int j = 0; j < n; j++) total += src[j * s];
  return total;
}

/* adj(M) and 1 / det(M) of a 3x3 as inv3x3 (ops/linalg.py) compiles: in
 * each x*y - u*v the first product is fused. */
static void adj3x3(const float* m, float* adj, float* inv_det) {
  float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5], g = m[6], h = m[7],
        i = m[8];
  float A = fmaf(e, i, -(f * h));
  float Bn = fmaf(d, i, -(f * g));
  float Cc = fmaf(d, h, -(e * g));
  float det = fmaf(c, Cc, fmaf(a, A, -(Bn * b)));
  *inv_det = 1.0f / (fabsf(det) < 1e-12f ? 1e-12f : det);
  adj[0] = A; adj[1] = -fmaf(b, i, -(c * h)); adj[2] = fmaf(b, f, -(c * e));
  adj[3] = -Bn; adj[4] = fmaf(a, i, -(c * g)); adj[5] = -fmaf(a, f, -(c * d));
  adj[6] = Cc; adj[7] = -fmaf(a, h, -(b * g)); adj[8] = fmaf(a, e, -(b * d));
}

/* sum_k v[k]^2 over 3 entries: a fused multiply-add chain from 0, or (with
 * rounded, as a vector loop of XLA's kernel computes it) the rounded squares
 * added in order. */
static float sq3(const float* v, int rounded) {
  if (rounded) return (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
  return fmaf(v[2], v[2], fmaf(v[1], v[1], fmaf(v[0], v[0], 0.0f)));
}

/* clamp_tangent(xi, max_rot, max_trans), then se3_update: (R_new, t_new) =
 * exp(xi) o (R, t), with the step zeroed unless ok; writes the clamped step
 * to xi_c. rounded: the three squared norms (the clamp's two, the rotation
 * angle's) sum rounded squares (sq3). */
static void se3_step(float max_rot, float max_trans, const float* xi, int ok, const float* R,
                     const float* t, float* Rn, float* tn, float* xi_c, int rounded) {
  float nr2 = sq3(xi, rounded);
  float np2 = sq3(xi + 3, rounded);
  float sr = fmin_xla(max_trans * xla_rsqrt(fmax_xla(nr2, 1e-24f)), 1.0f);
  float sp = fmin_xla(max_rot * xla_rsqrt(fmax_xla(np2, 1e-24f)), 1.0f);
  for (int i = 0; i < 3; i++) {
    xi_c[i] = ok ? xi[i] * sr : 0.0f;
    xi_c[3 + i] = ok ? xi[3 + i] * sp : 0.0f;
  }
  const float* rho = xi_c;
  const float* phi = xi_c + 3;
  float th2 = sq3(phi, rounded);
  float th = sqrtf(fmax_xla(th2, 1e-24f));
  int small = fabsf(th) < 1e-4f;
  float s = small ? 1.0f : th;
  float sn = sinf(s), cs = cosf(s);
  float t2 = fmax_xla(th2, 1e-24f);
  float a = small ? fmaf(t2, -0.16666667f, 1.0f) : sn / s;
  float b = small ? fmaf(-0.041666668f, t2, 0.5f) : (1.0f - cs) / (s * s);
  float cc = small ? fmaf(t2, -0.041666668f, 0.5f) : (1.0f - cs) / (s * s);
  float d = small ? fmaf(-0.008333334f, t2, 0.16666667f) : (s - sn) / ((s * s) * s);
  float K[9] = {0.0f, -phi[2], phi[1], phi[2], 0.0f, -phi[0], -phi[1], phi[0], 0.0f};
  float K2[9], dR[9], J[9];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) K2[3 * i + j] = dot_chain0(K + 3 * i, 1, K + j, 3, 3);
  for (int k = 0; k < 9; k++) {
    float I = (k % 4 == 0) ? 1.0f : 0.0f;
    dR[k] = fmaf(b, K2[k], fmaf(a, K[k], I));
    J[k] = fmaf(d, K2[k], fmaf(cc, K[k], I));
  }
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) Rn[3 * i + j] = dot_chain0(dR + 3 * i, 1, R + j, 3, 3);
  for (int i = 0; i < 3; i++)
    tn[i] = (dot_chain0(dR + 3 * i, 1, t, 1, 3) + 0.0f) + (dot_chain0(J + 3 * i, 1, rho, 1, 3) + 0.0f);
}

#endif
