/* The motion-only pose solve (models/pose_opt.py) on the CPU, computed as
 * XLA:CPU compiles the JAX package's solve inside its jitted tracker.
 *
 * The JAX tracker runs the solve twice per frame: vmapped over three
 * association strategies (stage 1, 2 trials x 8 iterations) and once over
 * the union of the associations (stage 2, 4 x 10). XLA fuses each
 * element-wise expression into one kernel and lets LLVM turn a product that
 * feeds a sum into one fused multiply-add, and which product it fuses
 * follows the kernel, not the expression: the same chi2 is summed one way
 * in the Gauss-Newton step and another in the robust cost. Every operation
 * below is the one XLA's kernel performs, in its order; fmaf() is a fused
 * multiply-add, every other operator rounds to f32 (build with
 * -ffp-contract=off). The comments name the expression of
 * structure_plp_slam_tpu/models/pose_opt.py each block computes.
 *
 * Sums over the observations follow the summation order of the routine XLA
 * hands each dot (the caller passes the shape's block table, ops/pose_cpu.py):
 *   H's monocular dot sum Jw2^T J2: 4 lanes (row k -> lane k % 4), each a
 *     fused multiply-add chain, the lanes added pairwise;
 *   H's stereo dot sum J3w^T J3r: consecutive blocks of rows, each one
 *     chain, the blocks added in order;
 *   g's monocular dot: 8 lanes added as AVX reduces a vector register;
 *   g's stereo dot: one chain;
 *   the robust cost: windows of 32 rows, each summed in order, then the
 *     windows the same way.
 * rsqrt is the CPU's approximate reciprocal root refined by two Newton
 * steps, as XLA:CPU lowers it on x86.
 *
 * The loop (trials, LM steps, acceptance, inlier re-classification) is the
 * one of _optimize_pose_torch in models/pose_opt.py; its constants, the LM
 * policy and the chi2 gates, come from there as the policy argument.
 *
 * Pinhole projection only (u = fx x / z + cx: perspective and fisheye
 * cameras); models/pose_opt.py routes the other models to the PyTorch solve.
 * x86-64 only: XLA:CPU's rsqrt is the SSE rsqrtss instruction.
 */
#include "xla_cpu.h"

/* The camera and the solve's constants (models/pose_opt.py _lm_policy). */
typedef struct {
  float fx, fy, cx, cy, fxb;
  float lam0, down, lam_min, up, lam_max, diag_floor, max_rot, max_trans, chi2_2d, chi2_3d;
} cam_t;

/* The camera-space point of pts row p under (R, t): one chain over k from
 * 0, then + t (pc = pts @ R^T + t). */
static void cam_point(const float* R, const float* t, const float* X, float* pc) {
  for (int i = 0; i < 3; i++) pc[i] = dot_chain0(X, 1, R + 3 * i, 1, 3) + t[i];
}

/* Residuals of one row: r_uv (d0, d1) and r_xr. */
static void residual(const cam_t* c, const float* pc, const float* uv_obs, float xr_obs,
                     float* d0, float* d1, float* rxr) {
  float sz = safe_z(pc[2]);
  float u = (pc[0] * c->fx) / sz + c->cx;
  float v = (pc[1] * c->fy) / sz + c->cy;
  *d0 = u - uv_obs[0];
  *d1 = v - uv_obs[1];
  *rxr = (u - c->fxb / sz) - xr_obs;
}

/* chi2 of the robust cost and the inlier test (robust_cost, trial_body):
 * the squares in one chain from 0, the stereo term added by the fused
 * weight. */
static float chi2_cost(const cam_t* c, const float* pc, const float* uv_obs, float xr_obs,
                       float isg) {
  float d0, d1, rx;
  residual(c, pc, uv_obs, xr_obs, &d0, &d1, &rx);
  float s = fmaf(d1, d1, fmaf(d0, d0, 0.0f));
  float st = xr_obs >= 0.0f ? (rx * rx) * isg : 0.0f;
  return fmaf(isg, s, st);
}

static float delta_sq(const cam_t* c, float xr_obs) {
  return xr_obs >= 0.0f ? c->chi2_3d : c->chi2_2d;
}

/* robust_cost: sum of the Huber cost over valid inliers. */
static float robust_cost(const cam_t* c, int N, const float* R, const float* t,
                         const float* pts, const float* uv, const float* xr, const float* isg,
                         const uint8_t* use, float* rho) {
  for (int p = 0; p < N; p++) {
    float pc[3];
    cam_point(R, t, pts + 3 * p, pc);
    float chi2 = chi2_cost(c, pc, uv + 2 * p, xr[p], isg[p]);
    float d = delta_sq(c, xr[p]);
    float r = chi2 <= d ? chi2 : fmaf(sqrtf(d * fmax_xla(chi2, 1e-12f)), 2.0f, -d);
    rho[p] = use[p] ? r : 0.0f;
  }
  return tree_sum(rho, 1, N);
}

/* solve6_spd(H_lm, -g) of one pose; H_lm's diagonal is fma(lam, max(diag,
 * 1e-6), H) and its off-diagonal H itself. Returns the raw step x * dinv. */
static void solve6(const float* H, float lam, float diag_floor, const float* g, float* xi) {
  float Hl[36], dinv[6], He[36], be[6];
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 6; j++)
      Hl[6 * i + j] = fmaf(lam, i == j ? fmax_xla(H[7 * i], diag_floor) : 0.0f, H[6 * i + j]);
  for (int i = 0; i < 6; i++) dinv[i] = xla_rsqrt(fmax_xla(Hl[7 * i], 1e-12f));
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 6; j++) He[6 * i + j] = (Hl[6 * i + j] * dinv[i]) * dinv[j];
  for (int i = 0; i < 6; i++) be[i] = (-g[i]) * dinv[i];
  /* inv6x6_spd(He): A = He[:3,:3], B = He[:3,3:], D = He[3:,3:]. */
  float A[9], B[9], adjA[9], invdetA, Ai[9], AiB[9], BtAiB[9], Sd[9], adjS[9], invdetS,
      Sdi[9], AiBSdi[9], T[9];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      A[3 * i + j] = He[6 * i + j];
      B[3 * i + j] = He[6 * i + 3 + j];
    }
  adj3x3(A, adjA, &invdetA);
  for (int k = 0; k < 9; k++) Ai[k] = adjA[k] * invdetA;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) AiB[3 * i + j] = dot_chain0(Ai + 3 * i, 1, B + j, 3, 3);
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) BtAiB[3 * i + j] = dot_chain0(B + i, 3, AiB + j, 3, 3);
  /* Sd = D - B^T Ai B, with D's second equilibration product fused. */
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      Sd[3 * i + j] = fmaf(dinv[3 + j], Hl[6 * (3 + i) + 3 + j] * dinv[3 + i], -BtAiB[3 * i + j]);
  adj3x3(Sd, adjS, &invdetS);
  for (int k = 0; k < 9; k++) Sdi[k] = adjS[k] * invdetS;
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) AiBSdi[3 * i + j] = dot_chain0(AiB + 3 * i, 1, Sdi + j, 3, 3);
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) T[3 * i + j] = dot_chain0(AiBSdi + 3 * i, 1, AiB + 3 * j, 1, 3);
  float Hi[36];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      Hi[6 * i + j] = fmaf(invdetA, adjA[3 * i + j], T[3 * i + j]);
      Hi[6 * i + 3 + j] = -AiBSdi[3 * i + j];
      Hi[6 * (3 + i) + j] = -AiBSdi[3 * j + i];
      Hi[6 * (3 + i) + 3 + j] = Sdi[3 * i + j];
    }
  /* x = Hi be, then two refinement steps. */
  float x[6], r[6], y[6];
  for (int i = 0; i < 6; i++) x[i] = dot_chain0(Hi + 6 * i, 1, be, 1, 6) + 0.0f;
  for (int it = 0; it < 2; it++) {
    for (int i = 0; i < 6; i++) r[i] = be[i] - (dot_chain0(He + 6 * i, 1, x, 1, 6) + 0.0f);
    for (int i = 0; i < 6; i++) y[i] = dot_chain0(Hi + 6 * i, 1, r, 1, 6) + 0.0f;
    for (int i = 0; i < 6; i++) x[i] = x[i] + y[i];
  }
  for (int i = 0; i < 6; i++) xi[i] = x[i] * dinv[i];
}

/* orthonormalize(R): the quaternion round trip. */
static void orthonormalize(const float* m, float* out) {
  float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[3], m11 = m[4], m12 = m[5], m20 = m[6],
        m21 = m[7], m22 = m[8];
  float scores[4] = {((m00 + m11) + m22) + 1.0f, ((1.0f + m00) - m11) - m22,
                     ((1.0f - m00) + m11) - m22, ((1.0f - m00) - m11) + m22};
  int c = 0;
  for (int k = 1; k < 4; k++)
    if (scores[k] > scores[c]) c = k;
  float cand[4][4] = {
      {scores[0], m21 - m12, m02 - m20, m10 - m01},
      {m21 - m12, scores[1], m01 + m10, m02 + m20},
      {m02 - m20, m01 + m10, scores[2], m12 + m21},
      {m10 - m01, m02 + m20, m12 + m21, scores[3]},
  };
  const float* q0 = cand[c];
  float n = sqrtf(fmaf(q0[3], q0[3], fmaf(q0[2], q0[2], fmaf(q0[1], q0[1], fmaf(q0[0], q0[0], 0.0f)))));
  float q[4];
  for (int k = 0; k < 4; k++) q[k] = q0[k] / n;
  float sg = q[0] < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 4; k++) q[k] = q[k] * sg;
  float n2 = sqrtf(fmaf(q[3], q[3], fmaf(q[2], q[2], fmaf(q[0], q[0], q[1] * q[1]))));
  float w = q[0] / n2, x = q[1] / n2, y = q[2] / n2, z = q[3] / n2;
  float r01 = fmaf(x, y, -(w * z)), r10 = fmaf(x, y, w * z);
  float r02 = fmaf(x, z, w * y), r20 = fmaf(x, z, -(w * y));
  float r12 = fmaf(y, z, -(w * x)), r21 = fmaf(y, z, w * x);
  out[0] = fmaf(-2.0f, fmaf(y, y, z * z), 1.0f);
  out[1] = r01 + r01;
  out[2] = r02 + r02;
  out[3] = r10 + r10;
  out[4] = fmaf(-2.0f, fmaf(x, x, z * z), 1.0f);
  out[5] = r12 + r12;
  out[6] = r20 + r20;
  out[7] = r21 + r21;
  out[8] = fmaf(-2.0f, fmaf(x, x, y * y), 1.0f);
}

/* H's monocular dot sum_k Jw2[k, i] J2[k, j] over K rows: 4 lanes (k % 4),
 * each a chain, the lanes added pairwise. */
static float h2_dot(const float* Jw2, const float* J2, int K, int i, int j) {
  float l4[4] = {0};
  for (int k = 0; k < K; k++) l4[k % 4] = fmaf(Jw2[6 * k + i], J2[6 * k + j], l4[k % 4]);
  return (l4[0] + l4[1]) + (l4[2] + l4[3]);
}

/* H's stereo dot sum_p J3w[p, i] J3r[p, j]: each block of rows one chain,
 * the blocks added in order. */
static float h3_dot(const float* J3w, const float* J3r, const int* blocks, int nb, int i,
                    int j) {
  float h3 = 0.0f;
  int p0 = 0;
  for (int bk = 0; bk < nb; bk++) {
    float s = 0.0f;
    for (int p = p0; p < p0 + blocks[bk]; p++) s = fmaf(J3w[6 * p + i], J3r[6 * p + j], s);
    h3 = bk == 0 ? s : h3 + s;
    p0 += blocks[bk];
  }
  return h3;
}

/* One Gauss-Newton system (H, g) of one pose, g = sum J^T W r: the normal
 * equations' four dots over the N rows. Work buffers: rows [N * 39] floats. */
static void normal_equations(const cam_t* c, int N, const float* R, const float* t,
                             const float* pts, const float* uv, const float* xr,
                             const float* isg, const uint8_t* use, const int* h3_blocks,
                             int n_h3_blocks, int single, float* H, float* g, float* work,
                             float* tr_chi2, float* tr_J3r, float* tr_Jw2) {
  float* J2 = work;              /* [N, 2, 6] */
  float* Jw2 = J2 + 12 * N;      /* [N, 2, 6] */
  float* J3r = Jw2 + 12 * N;     /* [N, 6] */
  float* J3w = J3r + 6 * N;      /* [N, 6] */
  float* ruv = J3w + 6 * N;      /* [N, 2] */
  float* rxr = ruv + 2 * N;      /* [N] */
  for (int p = 0; p < N; p++) {
    float pc[3];
    cam_point(R, t, pts + 3 * p, pc);
    float d0, d1, rx;
    residual(c, pc, uv + 2 * p, xr[p], &d0, &d1, &rx);
    ruv[2 * p] = d0;
    ruv[2 * p + 1] = d1;
    rxr[p] = rx;
    int st = xr[p] >= 0.0f;
    /* chi2 of lm_iter: the squares summed apart, the weight fused. */
    float chi2 = fmaf((0.0f + d0 * d0) + d1 * d1, isg[p], st ? (rx * rx) * isg[p] : 0.0f);
    if (tr_chi2) tr_chi2[p] = chi2;
    float sq = sqrtf(delta_sq(c, xr[p]) / fmax_xla(chi2, 1e-12f));
    float w = use[p] ? fmin_xla(sq, 1.0f) * isg[p] : 0.0f;
    float wst = st ? w : 0.0f;
    float sz = safe_z(pc[2]);
    float iz = 1.0f / sz, iz2 = iz * iz;
    float Juv[6] = {c->fx * iz, 0.0f, (pc[0] * -c->fx) * iz2,
                    0.0f, c->fy * iz, (pc[1] * -c->fy) * iz2};
    float Jxr[3] = {c->fx * iz, 0.0f, fmaf(c->fxb, iz2, (pc[0] * -c->fx) * iz2)};
    float dpc[18] = {1.0f, 0.0f, 0.0f, -0.0f, pc[2], -pc[1],
                     0.0f, 1.0f, 0.0f, -pc[2], -0.0f, pc[0],
                     0.0f, 0.0f, 1.0f, pc[1], -pc[0], -0.0f};
    for (int r = 0; r < 2; r++)
      for (int j = 0; j < 6; j++) {
        float v = dot_chain0(Juv + 3 * r, 1, dpc + j, 6, 3);
        J2[12 * p + 6 * r + j] = v;
        Jw2[12 * p + 6 * r + j] = v * w;
      }
    for (int j = 0; j < 6; j++) {
      float v = fmaf(Jxr[2], dpc[12 + j], fmaf(Jxr[1], dpc[6 + j], Jxr[0] * dpc[j]));
      J3r[6 * p + j] = v;
      J3w[6 * p + j] = v * wst;
    }
  }
  if (tr_J3r) memcpy(tr_J3r, J3r, sizeof(float) * 6 * N);
  if (tr_Jw2) memcpy(tr_Jw2, Jw2, sizeof(float) * 12 * N);
  int K = 2 * N;
  for (int i = 0; i < 6; i++) {
    if (!single) {
      /* g's monocular dot: 8 lanes over the 2N rows, reduced as an AVX
       * register; the stereo dot: one chain. */
      float lane[8] = {0};
      for (int k = 0; k < K; k++) lane[k % 8] = fmaf(Jw2[6 * k + i], ruv[k], lane[k % 8]);
      float v0 = lane[0] + lane[4], v1 = lane[1] + lane[5], v2 = lane[2] + lane[6],
            v3 = lane[3] + lane[7];
      float g2 = ((v0 + v2) + (v1 + v3)) + 0.0f;
      float g3 = J3w[i] * rxr[0];
      for (int p = 1; p < N; p++) g3 = fmaf(J3w[6 * p + i], rxr[p], g3);
      g[i] = g2 + g3;
    } else {
      /* The monocular dot in 4 accumulators of rows p % 4, each two lanes
       * (r = 0, 1), added ((1 + 0) + 2) + 3 and then the lanes; the stereo
       * chain continues from it. */
      float A[4][2] = {{0}};
      for (int p = 0; p < N; p++)
        for (int r = 0; r < 2; r++)
          A[p % 4][r] = fmaf(Jw2[12 * p + 6 * r + i], ruv[2 * p + r], A[p % 4][r]);
      float l[2];
      for (int r = 0; r < 2; r++) l[r] = ((A[1][r] + A[0][r]) + A[2][r]) + A[3][r];
      float acc = l[0] + l[1];
      for (int p = 0; p < N; p++) acc = fmaf(J3w[6 * p + i], rxr[p], acc);
      g[i] = acc;
    }
    for (int j = 0; j < 6; j++)
      H[6 * i + j] = h2_dot(Jw2, J2, K, i, j) + h3_dot(J3w, J3r, h3_blocks, n_h3_blocks, i, j);
  }
}

/* The normal matrix's two dots alone, [6, 6] each, for rows Jw2 / J2 [2N, 6]
 * and J3w / J3r [N, 6] (tests hold them against XLA's). */
void normal_dots_cpu(int N, const float* Jw2, const float* J2, const float* J3w,
                     const float* J3r, const int* h3_blocks, int n_h3_blocks, float* H2,
                     float* H3) {
  for (int i = 0; i < 6; i++)
    for (int j = 0; j < 6; j++) {
      H2[6 * i + j] = h2_dot(Jw2, J2, 2 * N, i, j);
      H3[6 * i + j] = h3_dot(J3w, J3r, h3_blocks, n_h3_blocks, i, j);
    }
}

/* Per-step trace layout (floats) of one pose, when trace != NULL:
 * chi2 [N], J3r [N*6], Jw2 [N*12], H [36], the right-hand side b = -g [6],
 * the clamped step [6], the step's robust cost, its acceptance. */
static long trace_step_size(int N) { return (long)N * 19 + 36 + 6 + 6 + 2; }

/* optimize_pose for B poses over N observation rows: single != 0 computes
 * the JAX tracker's stage-2 solve, else its vmapped stage-1 solve. camf =
 * (fx, fy, cx, cy, focal_x_baseline), then the ten constants of
 * models/pose_opt.py _lm_policy; R0 [B,3,3], t0 [B,3], pts [B,N,3],
 * valid [B,N]; uv [N,2], xr [N] (< 0: monocular), isg [N] shared by the
 * batch. h3_blocks: the stereo dot's row blocks (summing to N). Writes the
 * orthonormalized R, t, the inliers and their chi2 total per pose; work
 * holds 42 N floats. Returns 0, or 1 when the blocks do not sum to N. */
int pose_solve_cpu(int single, int B, int N, const float* camf, const float* R0, const float* t0,
                   const float* pts, const float* uv, const float* xr, const float* isg,
                   const uint8_t* valid, int num_trials, int num_iters, const int* h3_blocks,
                   int n_h3_blocks, float* R_out, float* t_out, uint8_t* inl_out,
                   float* chi2_out, float* work, float* trace) {
  cam_t c = {camf[0], camf[1],  camf[2],  camf[3],  camf[4],  camf[5], camf[6], camf[7],
             camf[8], camf[9], camf[10], camf[11], camf[12], camf[13], camf[14]};
  int sum = 0;
  for (int k = 0; k < n_h3_blocks; k++) sum += h3_blocks[k];
  if (sum != N) return 1;
  float* rho = work + 40L * N;
  uint8_t* use = (uint8_t*)(rho + N);
  for (int b = 0; b < B; b++) {
    const float* P = pts + 3L * N * b;
    const uint8_t* V = valid + (long)N * b;
    uint8_t* inl = inl_out + (long)N * b;
    float R[9], t[3];
    memcpy(R, R0 + 9 * b, sizeof R);
    memcpy(t, t0 + 3 * b, sizeof t);
    memcpy(inl, V, N);
    for (int tr = 0; tr < num_trials; tr++) {
      for (int p = 0; p < N; p++) use[p] = V[p] && inl[p];
      float lam = c.lam0;
      float cost = robust_cost(&c, N, R, t, P, uv, xr, isg, use, rho);
      for (int it = 0; it < num_iters; it++) {
        float* T = trace ? trace + trace_step_size(N) * (((long)b * num_trials + tr) * num_iters + it)
                         : NULL;
        float H[36], g[6], xi[6], xi_c[6], Rn[9], tn[3];
        normal_equations(&c, N, R, t, P, uv, xr, isg, use, h3_blocks, n_h3_blocks, single, H, g,
                         work, T, T ? T + N : NULL, T ? T + 7L * N : NULL);
        solve6(H, lam, c.diag_floor, g, xi);
        int ok = 1;
        for (int i = 0; i < 6; i++) ok &= isfinite(xi[i]) != 0;
        se3_step(c.max_rot, c.max_trans, xi, ok, R, t, Rn, tn, xi_c, 0);
        float new_cost = robust_cost(&c, N, Rn, tn, P, uv, xr, isg, use, rho);
        int accept = ok && new_cost < cost;
        if (T) {
          float* q = T + 19L * N;
          memcpy(q, H, sizeof H);
          for (int i = 0; i < 6; i++) q[36 + i] = -g[i];
          memcpy(q + 42, xi_c, sizeof xi_c);
          q[48] = new_cost;
          q[49] = (float)accept;
        }
        if (accept) {
          memcpy(R, Rn, sizeof R);
          memcpy(t, tn, sizeof t);
          cost = new_cost;
          lam = fmax_xla(lam * c.down, c.lam_min);
        } else {
          lam = fmin_xla(lam * c.up, c.lam_max);
        }
      }
      /* Re-classify the inliers for the next trial. */
      for (int p = 0; p < N; p++) {
        float pc[3];
        cam_point(R, t, P + 3 * p, pc);
        inl[p] = V[p] && chi2_cost(&c, pc, uv + 2 * p, xr[p], isg[p]) <= delta_sq(&c, xr[p]);
      }
    }
    orthonormalize(R, R_out + 9 * b);
    memcpy(t_out + 3 * b, t, sizeof t);
    for (int p = 0; p < N; p++) {
      float pc[3];
      cam_point(R_out + 9 * b, t, P + 3 * p, pc);
      rho[p] = inl[p] ? chi2_cost(&c, pc, uv + 2 * p, xr[p], isg[p]) : 0.0f;
    }
    chi2_out[b] = tree_sum(rho, 1, N);
  }
  return 0;
}
