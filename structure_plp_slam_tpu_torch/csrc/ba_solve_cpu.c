/* One Gauss-Newton iteration of the local bundle adjustment
 * (models/bundle_adjustment.py ba_solve) on the CPU, computed as XLA:CPU
 * compiles the JAX package's: the two-view init's jitted mapper.local_ba (C =
 * 8 window cameras) and the keyframe chain's (system.py _kf_chain, C = 32, or
 * 16 at 8 keyframes), each over M = 4096 (or 2048) landmarks and a dense
 * [C, Ng] observation grid. Both
 * programs compile the iteration into the same kernels, and so do the
 * monocular, RGB-D and stereo Systems' chains (the camera's focal_x_baseline
 * is a constant of the compile, 0 for a monocular camera); what the
 * vectorizer makes of a kernel follows its shapes, and the caller passes
 * those choices (the Schur product's block layout, the back-substitution's
 * accumulators).
 *
 * XLA fuses each element-wise expression into one kernel and LLVM turns a
 * product that feeds a sum into one fused multiply-add; the dots go to
 * kernels whose summation order follows the dot. Every operation below is the
 * one XLA's code performs, in its order; fmaf() is a fused multiply-add,
 * every other operator rounds to f32 (build with -ffp-contract=off). The
 * comments name the expression of structure_plp_slam_tpu/models/
 * bundle_adjustment.py each block computes.
 *
 *   the stereo row (an observation with obs_xr >= 0): its Jacobian's depth
 *     entry fma(fxb, iz^2, (x -fx) iz^2), its chi2 term (r_xr^2) isg added to
 *     the 2D one as fma(r_uv . r_uv, isg, term), and its term of each block
 *     fused into the two-row sum, fma(Jc3 w_st, Jc3, Jc2w^T Jc2) and so on;
 *     the monocular rows of the same program add the term with w_st = 0;
 *   the small dots (R X, the Jacobians, the per-observation blocks, Hll^-1
 *     times the back-substituted right-hand side): one fused multiply-add
 *     chain over the contracted index from its first, rounded product;
 *   W Hll^-1 ([M, C, 6, 3] x [M, 3, 3]): output columns 0 and 1 as three
 *     rounded products added in order from 0, column 2 a chain (the SLP
 *     vectorizer packs the first two);
 *   the sums over the observation grid (Hcc, bc): windows of 32 with the
 *     zero padding split around them (XLA's tree-reduction rewrite);
 *   the one-hot grid contraction (Hll, bl, W): each (landmark, camera) bin
 *     is the sum of its observations' blocks (one observation: the block
 *     itself; more, where a landmark sits twice in one keyframe: the library
 *     dot's order, the camera row in consecutive runs of gblock slots, each
 *     run summed in order, the runs added in order); Hll and bl then sum the
 *     bins over the cameras in order from 0;
 *   the Schur product sum_{m,k} WHinv W over the contraction index K = k M
 *     + m: consecutive blocks of K, each summed in interleaved lanes (entry
 *     K of a block into lane (K - block start) % lanes), each lane one chain
 *     from 0, the lanes added in order, the blocks added in order (the
 *     caller passes the shape's block length and lane count);
 *   the right-hand side's dot over the same K: 8 lanes (K % 8), each a chain,
 *     added ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7));
 *   W^T dx_c over the 6C camera entries: groups of 8 entries, each group's
 *     lanes fused into one of wt_accs accumulators of 8 lanes (group g into
 *     accumulator g % wt_accs, the groups in the caller's order), the
 *     accumulators added in order, then the 8 lanes as AVX reduces a vector
 *     register, ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7));
 *   the camera step's squared norms (the clamp's, the rotation angle's): a
 *     chain from 0, or, for the cameras a vector loop covers (the caller's
 *     vec_cams), the rounded squares added in order.
 * rsqrt is the CPU's approximate reciprocal root refined by two Newton steps,
 * as XLA:CPU lowers it on x86.
 *
 * The solver's policy (iterations, damping, chi2 gates, the step limits, the
 * cull schedule) stays in models/bundle_adjustment.py, which passes the
 * constants. The camera system's Cholesky solve runs between the two halves
 * of the iteration in ops/linalg.py (XLA's LAPACK routines).
 *
 * Pinhole projection of monocular and stereo (RGB-D) observations. x86-64
 * only: XLA:CPU's rsqrt is the SSE rsqrtss instruction.
 */
#include <stdlib.h>

#include "xla_cpu.h"

#define WT_ACCS_MAX 4

/* The camera and the solve's constants (models/bundle_adjustment.py
 * _ba_policy): fx, fy, cx, cy, focal_x_baseline, damping, the 2D and 3D chi2
 * gates, max rotation, max translation, max landmark step. */
typedef struct {
  float fx, fy, cx, cy, fxb, damping, chi2_2d, chi2_3d, max_rot, max_trans, max_lm;
} cam_t;

/* sum_k a[k * sa] * b[k * sb]: the first product rounded, then one chain. */
static float chain(const float* a, int sa, const float* b, int sb, int K) {
  float acc = a[0] * b[0];
  for (int k = 1; k < K; k++) acc = fmaf(a[k * sa], b[k * sb], acc);
  return acc;
}

/* pc = R X + t (_project_residuals). */
static void cam_point(const float* P, const float* X, float* pc) {
  for (int i = 0; i < 3; i++) pc[i] = chain(P + 4 * i, 1, X, 1, 3) + P[4 * i + 3];
}

/* r_uv, r_xr and the chi2 of one observation (_project_residuals,
 * _obs_chi2): the stereo term where xr >= 0, the 2D sum's product with isg
 * fused into it. */
static float residual_chi2(const cam_t* c, const float* pc, const float* uv, float xr,
                           float isg, float* d) {
  float sz = safe_z(pc[2]);
  float u = (pc[0] * c->fx) / sz + c->cx;
  d[0] = u - uv[0];
  d[1] = ((pc[1] * c->fy) / sz + c->cy) - uv[1];
  d[2] = (u - c->fxb / sz) - xr;
  float st = xr >= 0.0f ? (d[2] * d[2]) * isg : 0.0f;
  return fmaf(fmaf(d[1], d[1], d[0] * d[0]), isg, st);
}

/* The Schur product S_red[(c,i), (d,j)] = sum_K WH[m,c,i,k] W[m,d,j,k] over
 * K = k M + m for WH, W [M, C, 6, 3]: consecutive blocks of kblock entries of
 * K, entry K of a block into lane (K - block start) % klanes, each lane one
 * chain from 0, the lanes added in order, the blocks added in order. The
 * (landmark, camera) blocks with cam_nz[m * C + c] == 0 (W[m, c] all zero,
 * and so WH[m, c]) add exact zeros to the chains and are skipped (cam_nz
 * NULL: none). Returns 0, or 2 on allocation failure or klanes < 1. */
int ba_schur_cpu(int C, int M, int kblock, int klanes, const float* WH, const float* W,
                 const uint8_t* cam_nz, float* Sr) {
  const int D = 6 * C;
  if (klanes < 1) return 2;
  float* acc = malloc(sizeof(float) * (size_t)klanes * D * D);
  int* rows = malloc(sizeof(int) * (size_t)D);
  if (!acc || !rows) { free(acc); free(rows); return 2; }
  const long Ktot = 3L * M;
  for (long b0 = 0; b0 < Ktot; b0 += kblock) {
    long b1 = b0 + kblock < Ktot ? b0 + kblock : Ktot;
    memset(acc, 0, sizeof(float) * (size_t)klanes * D * D);
    for (long K = b0; K < b1; K++) {
      int k = (int)(K / M), m = (int)(K % M);
      float* lane = acc + (size_t)((K - b0) % klanes) * D * D;
      int nr = 0;
      for (int c = 0; c < C; c++)
        if (!cam_nz || cam_nz[(size_t)m * C + c])
          for (int i = 0; i < 6; i++) rows[nr++] = 6 * c + i;
      const float* wh = WH + (size_t)m * C * 18 + k;
      const float* w = W + (size_t)m * C * 18 + k;
      for (int a_i = 0; a_i < nr; a_i++) {
        int p = rows[a_i];
        float a = wh[3 * p];
        for (int b_i = 0; b_i < nr; b_i++) {
          int q = rows[b_i];
          lane[p * D + q] = fmaf(a, w[3 * q], lane[p * D + q]);
        }
      }
    }
    for (int p = 0; p < D * D; p++) {
      float t = acc[p];
      for (int l = 1; l < klanes; l++) t = t + acc[(size_t)l * D * D + p];
      Sr[p] = b0 == 0 ? t : Sr[p] + t;
    }
  }
  free(acc);
  free(rows);
  return 0;
}

/* sum_p w[3 p + j] dx[p] over p < D in wt_accs accumulators of 8 lanes: the
 * groups of 8 entries in the order wt_order (NULL: in order), group g into
 * accumulator g % wt_accs; entries past the last whole group into the first
 * accumulator's lanes p % 8. */
static float wt_dot(const float* w, int j, const float* dx, int D, int wt_accs,
                    const int* wt_order) {
  float acc[WT_ACCS_MAX][8];
  memset(acc, 0, sizeof acc);
  const int ng = D / 8;
  for (int gi = 0; gi < ng; gi++) {
    int g = wt_order ? wt_order[gi] : gi;
    float* a = acc[g % wt_accs];
    for (int l = 0; l < 8; l++) a[l] = fmaf(w[3 * (8 * g + l) + j], dx[8 * g + l], a[l]);
  }
  for (int p = 8 * ng; p < D; p++) acc[0][p % 8] = fmaf(w[3 * p + j], dx[p], acc[0][p % 8]);
  float l[8];
  for (int q = 0; q < 8; q++) {
    l[q] = acc[0][q];
    for (int k = 1; k < wt_accs; k++) l[q] = l[q] + acc[k][q];
  }
  return ((l[0] + l[4]) + (l[2] + l[6])) + ((l[1] + l[5]) + (l[3] + l[7]));
}

/* Per-observation trace layout (floats): pc [3], r_uv [2], chi2, w, Jc2 [12],
 * Jl2 [6], Hcc_o [36], Hll_o [9], Hcl_o [18], bc_o [6], bl_o [3], r_xr, Jc3
 * [6], Jl3 [3]. */
#define OBS_TRACE 107

/* The normal equations and their Schur complement (ba_solve's iteration up
 * to the camera solve). Inputs: camf (cam_t), the window's poses P [C, 3, 4]
 * and points X [M, 3], the observation grid (obs_lm [C * Ng], uv [C * Ng, 2],
 * xr [C * Ng] (< 0: monocular), isg, live), the free cameras; kblock and
 * klanes, the Schur product's block length and lane count.
 * Outputs: S [6C, 6C] and rhs [6C] of the camera system, and what the back-
 * substitution needs: Hll^-1 [M, 3, 3], W [M, C, 6, 3], bl [M, 3]; gblock,
 * the grid contraction's run length over a camera row. With
 * obs_tr, each observation's values (OBS_TRACE floats); with lm_tr, Hll [M, 9]
 * and W Hll^-1 [M, C, 6, 3]; with cam_tr, Hcc [C, 36], bc [C, 6] and the
 * Schur product [6C, 6C]. Returns 0, or 2 on allocation failure. */
int ba_normal_cpu(int C, int M, int Ng, const float* camf, const float* P, const float* X,
                  const int64_t* obs_lm, const float* uv, const float* xr, const float* isg,
                  const uint8_t* live, const uint8_t* freecam, int kblock, int klanes,
                  int gblock, float* S, float* rhs, float* Hinv, float* W, float* bl,
                  float* obs_tr, float* lm_tr, float* cam_tr) {
  const cam_t* c = (const cam_t*)camf;
  const int O = C * Ng, D = 6 * C;
  float* Hcc_o = malloc(sizeof(float) * (size_t)O * 42);
  float* Hll = calloc((size_t)M * 9, sizeof(float));
  float* WH = malloc(sizeof(float) * (size_t)M * C * 18);
  /* The (landmark, camera) bins of one run of a camera row and of the
   * whole row: Hll [9], bl [3], Hcl [18] (the contraction's column order),
   * with the landmarks each has touched. */
  float* run = malloc(sizeof(float) * (size_t)M * 30);
  float* row = malloc(sizeof(float) * (size_t)M * 30);
  int* run_lms = malloc(sizeof(int) * (size_t)Ng);
  int* row_lms = malloc(sizeof(int) * (size_t)Ng);
  uint8_t* in_run = calloc((size_t)M, 1);
  uint8_t* in_row = calloc((size_t)M, 1);
  uint8_t* cam_nz = calloc((size_t)M * C, 1); /* W[m, c] has a weighted observation */
  if (!Hcc_o || !Hll || !WH || !run || !row || !run_lms || !row_lms || !in_run || !in_row ||
      !cam_nz) {
    free(Hcc_o); free(Hll); free(WH); free(run); free(row); free(run_lms); free(row_lms);
    free(in_run); free(in_row); free(cam_nz);
    return 2;
  }
  float* bc_o = Hcc_o + (size_t)O * 36;
  int rc = 0;
  memset(W, 0, sizeof(float) * (size_t)M * C * 18);
  memset(bl, 0, sizeof(float) * (size_t)M * 3);
  int nrun = 0, nrow = 0;
  for (int o = 0; o < O; o++) {
    int cam = o / Ng;
    int64_t m = obs_lm[o];
    const float* Pc = P + 12 * cam;
    float pc[3], d[3];
    cam_point(Pc, X + 3 * m, pc);
    const int stereo = xr[o] >= 0.0f;
    float chi2 = residual_chi2(c, pc, uv + 2 * o, xr[o], isg[o], d);
    /* huber_weight(chi2, delta_sq) * inv_sigma_sq, gated by liveness and
     * cheirality; w_st, the stereo row's weight. */
    float hw = fmin_xla(sqrtf((stereo ? c->chi2_3d : c->chi2_2d) / fmax_xla(chi2, 1e-12f)), 1.0f);
    float w = live[o] ? hw * isg[o] : 0.0f;
    if (!(pc[2] > 1e-6f)) w = 0.0f;
    float w_st = stereo ? w : 0.0f;
    float iz = 1.0f / safe_z(pc[2]), iz2 = iz * iz;
    float Juv[6] = {c->fx * iz, 0.0f, (pc[0] * -c->fx) * iz2,
                    0.0f, c->fy * iz, (pc[1] * -c->fy) * iz2};
    float Jxr[3] = {c->fx * iz, 0.0f, fmaf(c->fxb, iz2, (pc[0] * -c->fx) * iz2)};
    /* d pc / d xi = [I | -hat(pc)]. */
    float dpc[18] = {1.0f, 0.0f, 0.0f, 0.0f, pc[2], -pc[1],
                     0.0f, 1.0f, 0.0f, -pc[2], 0.0f, pc[0],
                     0.0f, 0.0f, 1.0f, pc[1], -pc[0], 0.0f};
    float Jc2[12], Jl2[6], Jc2w[12], Jl2w[6], Jc3[6], Jl3[3], Jc3w[6], Jl3w[3];
    for (int r = 0; r < 2; r++) {
      for (int j = 0; j < 6; j++) Jc2[6 * r + j] = chain(Juv + 3 * r, 1, dpc + j, 6, 3);
      for (int j = 0; j < 3; j++) Jl2[3 * r + j] = chain(Juv + 3 * r, 1, Pc + j, 4, 3);
    }
    for (int j = 0; j < 6; j++) Jc3[j] = chain(Jxr, 1, dpc + j, 6, 3);
    for (int j = 0; j < 3; j++) Jl3[j] = chain(Jxr, 1, Pc + j, 4, 3);
    for (int k = 0; k < 12; k++) Jc2w[k] = Jc2[k] * w;
    for (int k = 0; k < 6; k++) Jl2w[k] = Jl2[k] * w;
    for (int k = 0; k < 6; k++) Jc3w[k] = Jc3[k] * w_st;
    for (int k = 0; k < 3; k++) Jl3w[k] = Jl3[k] * w_st;
    const float wr = w_st * d[2];
    /* The blocks: a chain over the two residual rows, the stereo row's term
     * fused onto it. */
    float* hcc = Hcc_o + (size_t)o * 36;
    float hll[9], hcl[18], bco[6], blo[3];
    for (int i = 0; i < 6; i++)
      for (int j = 0; j < 6; j++)
        hcc[6 * i + j] = fmaf(Jc3w[i], Jc3[j], fmaf(Jc2w[6 + i], Jc2[6 + j], Jc2w[i] * Jc2[j]));
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++)
        hll[3 * i + j] = fmaf(Jl3w[i], Jl3[j], fmaf(Jl2w[3 + i], Jl2[3 + j], Jl2w[i] * Jl2[j]));
    for (int i = 0; i < 6; i++)
      for (int j = 0; j < 3; j++)
        hcl[3 * i + j] = fmaf(Jc3w[i], Jl3[j], fmaf(Jc2w[6 + i], Jl2[3 + j], Jc2w[i] * Jl2[j]));
    for (int i = 0; i < 6; i++)
      bco[i] = -fmaf(Jc3[i], wr, fmaf(Jc2w[6 + i], d[1], Jc2w[i] * d[0]));
    for (int i = 0; i < 3; i++)
      blo[i] = -fmaf(Jl3[i], wr, fmaf(Jl2w[3 + i], d[1], Jl2w[i] * d[0]));
    memcpy(bc_o + (size_t)o * 6, bco, sizeof bco);
    /* The one-hot contraction into (landmark, camera) bins; an observation
     * of weight 0 (and so w_st 0) adds only zeros. */
    if (w != 0.0f) {
      float v[30];
      memcpy(v, hll, sizeof hll);
      memcpy(v + 9, blo, sizeof blo);
      memcpy(v + 12, hcl, sizeof hcl);
      float* b = run + 30 * m;
      if (!in_run[m]) {
        in_run[m] = 1;
        run_lms[nrun++] = (int)m;
        memcpy(b, v, sizeof v);
      } else {
        for (int k = 0; k < 30; k++) b[k] = b[k] + v[k];
      }
    }
    int n = o % Ng;
    if ((n + 1) % gblock == 0 || n + 1 == Ng) { /* the end of a run */
      for (int t = 0; t < nrun; t++) {
        int mm = run_lms[t];
        float *b = run + 30 * mm, *r = row + 30 * mm;
        in_run[mm] = 0;
        if (!in_row[mm]) {
          in_row[mm] = 1;
          row_lms[nrow++] = mm;
          memcpy(r, b, 30 * sizeof(float));
        } else {
          for (int k = 0; k < 30; k++) r[k] = r[k] + b[k];
        }
      }
      nrun = 0;
    }
    if (n + 1 == Ng) { /* the end of a camera row: W, and the sums over cameras */
      for (int t = 0; t < nrow; t++) {
        int mm = row_lms[t];
        const float* r = row + 30 * mm;
        in_row[mm] = 0;
        cam_nz[(size_t)mm * C + cam] = 1;
        memcpy(W + ((size_t)mm * C + cam) * 18, r + 12, 18 * sizeof(float));
        for (int k = 0; k < 9; k++) Hll[9 * mm + k] += r[k];
        for (int k = 0; k < 3; k++) bl[3 * mm + k] += r[9 + k];
      }
      nrow = 0;
    }
    if (obs_tr) {
      float* t = obs_tr + (size_t)o * OBS_TRACE;
      memcpy(t, pc, sizeof pc); memcpy(t + 3, d, sizeof d); t[5] = chi2; t[6] = w;
      memcpy(t + 7, Jc2, sizeof Jc2); memcpy(t + 19, Jl2, sizeof Jl2);
      memcpy(t + 25, hcc, 36 * sizeof(float)); memcpy(t + 61, hll, sizeof hll);
      memcpy(t + 70, hcl, sizeof hcl); memcpy(t + 88, bco, sizeof bco);
      memcpy(t + 94, blo, sizeof blo); t[97] = d[2];
      memcpy(t + 98, Jc3, sizeof Jc3); memcpy(t + 104, Jl3, sizeof Jl3);
    }
  }
  /* The grid sums per camera. */
  float* Hcc = malloc(sizeof(float) * (size_t)C * 42);
  if (!Hcc) { rc = 2; goto out; }
  float* bc = Hcc + (size_t)C * 36;
  for (int cam = 0; cam < C; cam++) {
    for (int k = 0; k < 36; k++) Hcc[36 * cam + k] = tree_sum(Hcc_o + (size_t)cam * Ng * 36 + k, 36, Ng);
    for (int k = 0; k < 6; k++) bc[6 * cam + k] = tree_sum(bc_o + (size_t)cam * Ng * 6 + k, 6, Ng);
  }
  /* Landmark damping and inverse; W Hll^-1 (zero where W is). */
  memset(WH, 0, sizeof(float) * (size_t)M * C * 18);
  for (int m = 0; m < M; m++) {
    float* H = Hll + 9 * m;
    float tr = ((0.0f + H[0]) + H[4]) + H[8];
    float lam = fmax_xla(tr * (1.0f / 3.0f), 1e-6f) * c->damping;
    float Hd[9], adj[9], inv_det;
    memcpy(Hd, H, sizeof Hd);
    for (int i = 0; i < 3; i++) Hd[4 * i] = Hd[4 * i] + lam;
    adj3x3(Hd, adj, &inv_det);
    float* Hi = Hinv + 9 * m;
    for (int k = 0; k < 9; k++) Hi[k] = adj[k] * inv_det;
    for (int q = 0; q < C * 6; q++) {
      if (!cam_nz[(size_t)m * C + q / 6]) continue;
      const float* w = W + (size_t)m * C * 18 + 3 * q;
      float* o = WH + (size_t)m * C * 18 + 3 * q;
      for (int k = 0; k < 2; k++)
        o[k] = ((0.0f + w[0] * Hi[k]) + w[1] * Hi[3 + k]) + w[2] * Hi[6 + k];
      o[2] = chain(w, 1, Hi + 2, 3, 3);
    }
  }
  /* The Schur product and the right-hand side's dot g[(c,i)] = sum_K WH bl
   * over the same K. */
  {
    float* Sr = malloc(sizeof(float) * (size_t)D * D);
    float lane[8][D];
    if (!Sr || ba_schur_cpu(C, M, kblock, klanes, WH, W, cam_nz, Sr)) {
      free(Sr);
      rc = 2;
      goto out_hcc;
    }
    memset(lane, 0, sizeof lane);
    const long Ktot = 3L * M;
    for (long K = 0; K < Ktot; K++) {
      int k = (int)(K / M), m = (int)(K % M);
      const float* wh = WH + (size_t)m * C * 18 + k;
      for (int p = 0; p < D; p++)
        if (cam_nz[(size_t)m * C + p / 6])
          lane[K % 8][p] = fmaf(wh[3 * p], bl[3 * m + k], lane[K % 8][p]);
    }
    /* S = Hcc (diagonal blocks) - S_red, fixed cameras replaced by identity
     * blocks, then the damping on the diagonal; rhs = (bc - g) on the free
     * cameras. */
    for (int ci = 0; ci < C; ci++) {
      float tr = 0.0f;
      for (int i = 0; i < 6; i++) {
        int p = 6 * ci + i;
        float g = ((lane[0][p] + lane[1][p]) + (lane[2][p] + lane[3][p])) +
                  ((lane[4][p] + lane[5][p]) + (lane[6][p] + lane[7][p]));
        rhs[p] = (bc[p] - g) * (freecam[ci] ? 1.0f : 0.0f);
        for (int dj = 0; dj < C; dj++)
          for (int j = 0; j < 6; j++) {
            int q = 6 * dj + j;
            float v = ci == dj ? Hcc[36 * ci + 6 * i + j] - Sr[p * D + q] : -Sr[p * D + q];
            v = v * (freecam[ci] ? 1.0f : 0.0f) * (freecam[dj] ? 1.0f : 0.0f);
            S[p * D + q] = v + (ci == dj && i == j && !freecam[ci] ? 1.0f : 0.0f);
          }
        tr = tr + S[p * D + p];
      }
      float ds = fmax_xla(tr * (1.0f / 6.0f), 1e-6f) * c->damping;
      for (int i = 0; i < 6; i++) S[(6 * ci + i) * D + 6 * ci + i] += ds;
    }
    if (cam_tr) {
      memcpy(cam_tr, Hcc, sizeof(float) * (size_t)C * 42);
      memcpy(cam_tr + (size_t)C * 42, Sr, sizeof(float) * (size_t)D * D);
    }
    free(Sr);
  }
  if (lm_tr) {
    memcpy(lm_tr, Hll, sizeof(float) * (size_t)M * 9);
    memcpy(lm_tr + (size_t)M * 9, WH, sizeof(float) * (size_t)M * C * 18);
  }
out_hcc:
  free(Hcc);
out:
  free(Hcc_o); free(Hll); free(WH); free(run); free(row); free(run_lms); free(row_lms);
  free(in_run); free(in_row); free(cam_nz);
  return rc;
}

/* The back-substitution and the update (the rest of ba_solve's
 * iteration): dx_l = Hll^-1 (bl - W^T dx_c); the camera step clamped and
 * applied to the free cameras, the landmark step clipped and added to the
 * valid landmarks (all steps zero unless every entry is finite). Writes the
 * new poses Pn [C, 3, 4] and points Xn [M, 3]; with dxl_tr, dx_l [M, 3]
 * after the clip. W^T dx_c sums in wt_accs accumulators, the groups of 8
 * entries in the order wt_order (wt_dot); the first vec_cams cameras' step
 * norms sum rounded squares (se3_step). Returns 0, or 2 on allocation
 * failure or wt_accs outside 1..WT_ACCS_MAX. */
int ba_update_cpu(int C, int M, const float* camf, const float* dxc, const float* Hinv,
                  const float* W, const float* bl, const float* P, const float* X,
                  const uint8_t* freecam, const uint8_t* lm_valid, int wt_accs,
                  const int* wt_order, int vec_cams, float* Pn, float* Xn, float* dxl_tr) {
  const cam_t* c = (const cam_t*)camf;
  const int D = 6 * C;
  int ok = 1;
  for (int p = 0; p < D; p++) ok &= isfinite(dxc[p]) != 0;
  if (wt_accs < 1 || wt_accs > WT_ACCS_MAX) return 2;
  float* dxl = malloc(sizeof(float) * (size_t)M * 3);
  if (!dxl) return 2;
  for (int m = 0; m < M; m++) {
    const float* w = W + (size_t)m * C * 18;
    float r[3];
    for (int j = 0; j < 3; j++) r[j] = bl[3 * m + j] - wt_dot(w, j, dxc, D, wt_accs, wt_order);
    for (int j = 0; j < 3; j++) {
      float v = chain(Hinv + 9 * m + 3 * j, 1, r, 1, 3);
      ok &= isfinite(v) != 0;
      dxl[3 * m + j] = v;
    }
  }
  for (int ci = 0; ci < C; ci++) {
    const float* Pc = P + 12 * ci;
    float* Po = Pn + 12 * ci;
    if (!freecam[ci]) {
      memcpy(Po, Pc, 48);
      continue;
    }
    float R[9], t[3], Rn[9], tn[3], xi_c[6];
    for (int i = 0; i < 3; i++) {
      for (int j = 0; j < 3; j++) R[3 * i + j] = Pc[4 * i + j];
      t[i] = Pc[4 * i + 3];
    }
    se3_step(c->max_rot, c->max_trans, dxc + 6 * ci, ok, R, t, Rn, tn, xi_c, ci < vec_cams);
    for (int i = 0; i < 3; i++) {
      for (int j = 0; j < 3; j++) Po[4 * i + j] = Rn[3 * i + j];
      Po[4 * i + 3] = tn[i];
    }
  }
  for (int m = 0; m < M; m++)
    for (int j = 0; j < 3; j++) {
      float v = ok ? fmin_xla(fmax_xla(dxl[3 * m + j], -c->max_lm), c->max_lm) : 0.0f;
      if (dxl_tr) dxl_tr[3 * m + j] = v;
      Xn[3 * m + j] = lm_valid[m] ? X[3 * m + j] + v : X[3 * m + j];
    }
  free(dxl);
  return 0;
}

/* lie.orthonormalize on every window pose (ba_solve's last step: the
 * quaternion round trip), as both programs compile it. Shepperd's candidate
 * row by the first largest score, normalized by the root of a fused
 * multiply-add chain of its squares; then sign-flipped to w >= 0 and
 * normalized again by the root of its rounded squares added in order; each
 * rotation entry with its first product fused (x y + w z, 1 - 2 (y y + z z)
 * as fma(-2, fma(y, y, z z), 1)). Writes Pn [C, 3, 4] (the translation
 * copied). */
void ba_orthonormalize_cpu(int C, const float* P, float* Pn) {
  for (int ci = 0; ci < C; ci++) {
    const float* m = P + 12 * ci;
    float* o = Pn + 12 * ci;
    float m00 = m[0], m01 = m[1], m02 = m[2], m10 = m[4], m11 = m[5], m12 = m[6],
          m20 = m[8], m21 = m[9], m22 = m[10];
    float s0 = ((m00 + m11) + m22) + 1.0f;
    float s1 = ((m00 + 1.0f) - m11) - m22;
    float s2 = ((1.0f - m00) + m11) - m22;
    float s3 = ((1.0f - m00) - m11) + m22;
    float cand[4][4] = {{s0, m21 - m12, m02 - m20, m10 - m01},
                        {m21 - m12, s1, m01 + m10, m02 + m20},
                        {m02 - m20, m01 + m10, s2, m12 + m21},
                        {m10 - m01, m02 + m20, m12 + m21, s3}};
    float sc[4] = {s0, s1, s2, s3};
    int k = 0;
    for (int i = 1; i < 4; i++)
      if (sc[i] > sc[k]) k = i;
    float q[4], n1 = 0.0f;
    for (int i = 0; i < 4; i++) n1 = fmaf(cand[k][i], cand[k][i], n1);
    n1 = sqrtf(n1);
    for (int i = 0; i < 4; i++) q[i] = cand[k][i] / n1;
    float n2 = sqrtf(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3]);
    float sg = q[0] < 0.0f ? -1.0f : 1.0f;
    float w = fmax_xla(-q[0], q[0]) / n2, x = (sg * q[1]) / n2, y = (sg * q[2]) / n2,
          z = (sg * q[3]) / n2;
    float R[9] = {fmaf(-2.0f, fmaf(y, y, z * z), 1.0f), 2.0f * fmaf(x, y, -(w * z)),
                  2.0f * fmaf(x, z, w * y),
                  2.0f * fmaf(x, y, w * z), fmaf(-2.0f, fmaf(x, x, z * z), 1.0f),
                  2.0f * fmaf(y, z, -(w * x)),
                  2.0f * fmaf(x, z, -(w * y)), 2.0f * fmaf(y, z, w * x),
                  fmaf(-2.0f, fmaf(x, x, y * y), 1.0f)};
    for (int i = 0; i < 3; i++) {
      for (int j = 0; j < 3; j++) o[4 * i + j] = R[3 * i + j];
      o[4 * i + 3] = m[4 * i + 3];
    }
  }
}

/* The chi2 of every observation (ba_solve's cull and final inlier test). */
void ba_chi2_cpu(int C, int Ng, const float* camf, const float* P, const float* X,
                 const int64_t* obs_lm, const float* uv, const float* xr, const float* isg,
                 float* chi2) {
  const cam_t* c = (const cam_t*)camf;
  for (int o = 0; o < C * Ng; o++) {
    float pc[3], d[3];
    cam_point(P + 12 * (o / Ng), X + 3 * obs_lm[o], pc);
    chi2[o] = residual_chi2(c, pc, uv + 2 * o, xr[o], isg[o], d);
  }
}
