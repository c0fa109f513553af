"""Line segment detection and description.

Port of structure_plp_slam_tpu/ops/lines.py, which replaces the
reference's LSD detector and LBD descriptor (feature/line_extractor.cc,
feature/line_descriptor/) with batched work:

Detection: Sobel gradients, ridge pixels (directional NMS), the strongest
edge points per cell; every edge point proposes the line through itself
perpendicular to its gradient, refit to its inliers (total least
squares) with majority polarity; the longest contiguous run of occupied
8 px bins along each line; greedy NMS over hypotheses in (angle, offset)
space picks up to ``max_lines`` segments.

Description: LBD-flavoured band statistics along the segment (means and
noise-deflated standard deviations of the gradient in the line frame at
two band spacings, band-relative intensities), the double-angle image
orientation, L2-normalized: ``[M, DESC_DIM]``.

The JAX package's occupancy bitmask (uint32 words OR-reduced over the
point axis) is computed here as a scatter of the same bits into a
[S, nbins] table, and its sequential longest-run scan as its closed form
(the run ending at bin b is b minus the last empty bin at or before b):
the same values. The JAX package's ``PLPSLAM_NO_BOX`` environment switch
is not ported; the descriptor always reads the box-filtered image, its
default.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from structure_plp_slam_tpu_torch.ops import fast as fast_ops
from structure_plp_slam_tpu_torch.ops import image as image_ops
from structure_plp_slam_tpu_torch.utils.types import nanmedian_mean

NUM_BANDS = 9
NUM_SAMPLES = 16
ANGLE_WEIGHT = 0.45
DESC_DIM = NUM_BANDS * 14 + 2
# Scale of the estimated gradient-noise floor subtracted from the band
# std statistics.
NOISE_DEFLATE = 1.0
BIN = 8.0  # px, contiguity bins along a line


@functools.lru_cache(maxsize=16)
def _linspace(start: float, stop: float, num: int, device):
    """``jnp.linspace`` in f32: start + i * step with the f32 step, the
    last value exactly ``stop`` (torch.linspace rounds some values the
    other way). Cached per device: a copy to the card waits for it."""
    step = torch.tensor((stop - start) / (num - 1), dtype=torch.float32)
    v = torch.tensor(start, dtype=torch.float32) + torch.arange(num, dtype=torch.float32) * step
    v[-1] = stop
    return v.to(device)


def _reflect_pad1(img):
    return F.pad(img[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]


def sobel_gradients(img):
    """f32 [H, W] -> (gx, gy): 3x3 Sobel with reflect padding, as shifted
    adds."""
    p = _reflect_pad1(img)
    tl, tc, tr = p[:-2, :-2], p[:-2, 1:-1], p[:-2, 2:]
    ml, mr = p[1:-1, :-2], p[1:-1, 2:]
    bl, bc, br = p[2:, :-2], p[2:, 1:-1], p[2:, 2:]
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return gx, gy


def _box3(img):
    """3x3 box blur (reflect padding) as shifted adds."""
    p = _reflect_pad1(img)
    return (
        p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:]
        + p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:]
        + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]
    ) * (1.0 / 9.0)


def _longest_runs(occ):
    """For each row of ``occ [S, B]`` the longest run of True and the bin
    where it first reaches that length (0, 0 for an empty row): the
    sequential scan's result."""
    B = occ.shape[1]
    b = torch.arange(B, device=occ.device)
    last_empty = torch.cummax(torch.where(occ, -1, b[None, :]), dim=1).values
    run = b[None, :] - last_empty
    best_end = torch.argmax(run, dim=1)  # first maximum
    best_len = torch.gather(run, 1, best_end[:, None])[:, 0]
    return best_len, best_end


def detect_line_segments(img, key=None, *, num_points: int = 2048, num_hypotheses: int = 2048,
                         max_lines: int = 64, min_length: float = 40.0,
                         inlier_dist: float = 1.5, grad_thr: float = 30.0):
    """Detect up to ``max_lines`` segments in ``img [H, W]``. Returns
    (seg [M, 4] (x1, y1, x2, y2), valid [M], strength [M]). ``key`` is
    not used: the hypotheses are deterministic (one per edge point)."""
    del key
    H, W = img.shape
    dev = img.device
    gx, gy = sobel_gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)

    # Ridge pixels: local maxima of |grad| along the dominant gradient axis.
    def shift(a, dy, dx):
        return torch.roll(a, (dy, dx), (0, 1))

    horiz = torch.abs(gx) >= torch.abs(gy)
    nms_x = (mag >= shift(mag, 0, 1)) & (mag >= shift(mag, 0, -1))
    nms_y = (mag >= shift(mag, 1, 0)) & (mag >= shift(mag, -1, 0))
    mag_nms = torch.where(torch.where(horiz, nms_x, nms_y), mag, torch.zeros_like(mag))

    # Edge points: the strongest ridge pixels per cell, then the top P.
    xy, resp, valid_p = fast_ops.select_keypoints(
        torch.where(mag_nms >= grad_thr, mag_nms, torch.zeros_like(mag_nms)),
        cell=8, per_cell=3, max_total=num_points, margin=4,
    )
    px, py = xy[:, 0], xy[:, 1]
    ix, iy = px.to(torch.int64), py.to(torch.int64)
    pgx, pgy = gx[iy, ix], gy[iy, ix]
    pmag = torch.clamp(mag[iy, ix], min=1e-6)

    # Hypotheses: each strong edge point proposes the line through itself
    # perpendicular to its gradient (the LSD principle).
    order = torch.argsort(torch.where(valid_p, -resp, torch.full_like(resp, math.inf)),
                          stable=True)
    ia = order[:num_hypotheses]
    ax, ay = px[ia], py[ia]
    ok_h = valid_p[ia]
    hgx, hgy = pgx[ia], pgy[ia]
    hmag = torch.clamp(torch.sqrt(hgx * hgx + hgy * hgy), min=1e-6)
    nx, ny = hgx / hmag, hgy / hmag
    dirx, diry = -ny, nx

    dist = torch.abs(nx[:, None] * (px[None, :] - ax[:, None])
                     + ny[:, None] * (py[None, :] - ay[:, None]))
    gdotn = torch.abs(pgx[None, :] * nx[:, None] + pgy[None, :] * ny[:, None]) / pmag[None, :]
    inl = (dist <= inlier_dist) & (gdotn >= 0.85) & valid_p[None, :]

    # Total-least-squares refit of each hypothesis to its inliers, then
    # re-gate with the refit line.
    w = inl.to(torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=1), min=1.0)
    mx = torch.sum(w * px[None, :], dim=1) / cnt
    my = torch.sum(w * py[None, :], dim=1) / cnt
    dxp = px[None, :] - mx[:, None]
    dyp = py[None, :] - my[:, None]
    sxx = torch.sum(w * dxp * dxp, dim=1)
    sxy = torch.sum(w * dxp * dyp, dim=1)
    syy = torch.sum(w * dyp * dyp, dim=1)
    theta = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    dirx2, diry2 = torch.cos(theta), torch.sin(theta)
    flip = torch.sign(dirx2 * dirx + diry2 * diry)  # keep the proposal's orientation
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    dirx, diry = dirx2 * flip, diry2 * flip
    nx, ny = -diry, dirx
    ax, ay = mx, my
    dist = torch.abs(nx[:, None] * (px[None, :] - ax[:, None])
                     + ny[:, None] * (py[None, :] - ay[:, None]))
    # Polarity-consistent support: keep the majority sign of the gradient
    # against the line normal.
    sdot = (pgx[None, :] * nx[:, None] + pgy[None, :] * ny[:, None]) / pmag[None, :]
    near = (dist <= inlier_dist) & valid_p[None, :]
    inl_pos = near & (sdot >= 0.85)
    inl_neg = near & (sdot <= -0.85)
    use_pos = torch.sum(inl_pos, dim=1) >= torch.sum(inl_neg, dim=1)
    inl = torch.where(use_pos[:, None], inl_pos, inl_neg)

    t = dirx[:, None] * (px[None, :] - ax[:, None]) + diry[:, None] * (py[None, :] - ay[:, None])

    # Contiguity: the longest run of occupied 8 px bins along the line
    # (1-bin gaps tolerated by dilation).
    T0 = float(math.hypot(H, W))
    nbins = int(2 * T0 / BIN) + 2
    S = t.shape[0]
    t_bin = torch.clamp(((t + T0) / BIN).to(torch.int64), 0, nbins - 1)
    flat = (torch.arange(S, device=dev)[:, None] * nbins + t_bin).reshape(-1)
    occ = torch.zeros((S * nbins,), dtype=torch.float32, device=dev)
    occ.index_add_(0, flat, inl.reshape(-1).to(torch.float32))
    occ = occ.reshape(S, nbins) > 0
    occ_d = occ | torch.roll(occ, 1, dims=1) | torch.roll(occ, -1, dims=1)
    best_len, best_end = _longest_runs(occ_d)
    t_lo = (best_end - best_len + 1).to(torch.float32) * BIN - T0 - BIN
    t_hi = (best_end + 1).to(torch.float32) * BIN - T0 + BIN
    in_run = inl & (t >= t_lo[:, None]) & (t <= t_hi[:, None])
    t_min = torch.amin(torch.where(in_run, t, torch.full_like(t, 1e9)), dim=1)
    t_max = torch.amax(torch.where(in_run, t, torch.full_like(t, -1e9)), dim=1)
    seg_len = t_max - t_min
    count = torch.sum(in_run, dim=1).to(torch.float32)
    # Density over the run: a real contour populates most of its bins.
    coverage = count / torch.clamp(seg_len / BIN, min=1.0)
    score = torch.where(ok_h & (seg_len >= min_length) & (coverage >= 0.8), count,
                        torch.zeros_like(count))

    # Greedy NMS over hypotheses (sequential, on the device; the picks are
    # read with gathers, as indexing with a 0-d device tensor would wait
    # for the card): suppress the near-duplicates in (normal, offset) of
    # each pick. Same line iff the normals align up to a joint sign flip
    # of (n, rho).
    rho = nx * ax + ny * ay
    idx = torch.arange(S, device=dev)
    picked, picked_score = [], []
    for _ in range(max_lines):
        best = torch.argmax(score).reshape(1)
        picked_score.append(score.gather(0, best))
        picked.append(best)
        ndot = nx * nx.gather(0, best) + ny * ny.gather(0, best)
        sgn = torch.where(ndot >= 0, 1.0, -1.0)
        rho_d = torch.abs(rho - sgn * rho.gather(0, best))
        dup = (torch.abs(ndot) > 0.985) & (rho_d < 6.0)
        score = torch.where(dup | (idx == best), torch.zeros_like(score), score)
    picked = torch.cat(picked)
    picked_score = torch.cat(picked_score)

    seg = torch.stack([
        ax[picked] + t_min[picked] * dirx[picked],
        ay[picked] + t_min[picked] * diry[picked],
        ax[picked] + t_max[picked] * dirx[picked],
        ay[picked] + t_max[picked] * diry[picked],
    ], dim=1)
    return seg, picked_score > 0.0, picked_score


def line_band_descriptors(img, seg, valid):
    """Band-gradient descriptors ``[M, DESC_DIM]`` (unit L2): per segment,
    NUM_SAMPLES points along it times NUM_BANDS offsets along its normal;
    per band the mean and noise-deflated std of the gradient in the line
    frame at spacings 2 and 5 px, band-relative mean intensities (whole
    line, per quarter, wide), and the double-angle orientation."""
    H, W = img.shape
    dev = img.device
    # The descriptor reads a 3x3-box-filtered image. The pixel noise
    # floor: median of the squared residual against the box (an even
    # count's two middle values averaged, as jnp.median does).
    img_box = _box3(img)
    resid = img - img_box
    r2 = (resid * resid).reshape(-1)
    med = nanmedian_mean(r2, torch.ones_like(r2, dtype=torch.bool))
    sigma2_px = med * (1.0 / (0.455 * 8.0 / 9.0))
    grad_noise_var = NOISE_DEFLATE * (16.0 / 9.0) * sigma2_px
    gx, gy = sobel_gradients(img_box)
    img = img_box
    x1, y1, x2, y2 = seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]

    # Canonical orientation: the mean on-line perpendicular gradient is
    # positive, so one physical edge always gives one band frame.
    dx0, dy0 = x2 - x1, y2 - y1
    len0 = torch.clamp(torch.sqrt(dx0 * dx0 + dy0 * dy0), min=1e-6)
    nx0, ny0 = -dy0 / len0, dx0 / len0
    tsf = _linspace(0.1, 0.9, 8, dev)
    fx = torch.clamp((x1[:, None] + tsf[None] * dx0[:, None]).to(torch.int64), 0, W - 1)
    fy = torch.clamp((y1[:, None] + tsf[None] * dy0[:, None]).to(torch.int64), 0, H - 1)
    gp0 = gx[fy, fx] * nx0[:, None] + gy[fy, fx] * ny0[:, None]
    flip = torch.sum(gp0, dim=1) < 0
    x1, x2 = torch.where(flip, x2, x1), torch.where(flip, x1, x2)
    y1, y2 = torch.where(flip, y2, y1), torch.where(flip, y1, y2)

    dx, dy = x2 - x1, y2 - y1
    inv = 1.0 / torch.clamp(torch.sqrt(dx * dx + dy * dy), min=1e-6)
    dirx, diry = dx * inv, dy * inv
    nx, ny = -diry, dirx
    ts = _linspace(0.05, 0.95, NUM_SAMPLES, dev)
    bands = torch.arange(NUM_BANDS, dtype=torch.float32, device=dev) - (NUM_BANDS - 1) / 2.0

    def band_stats(spacing):
        cx = (x1[:, None, None] + ts[None, :, None] * dx[:, None, None]
              + bands[None, None, :] * nx[:, None, None] * spacing)
        cy = (y1[:, None, None] + ts[None, :, None] * dy[:, None, None]
              + bands[None, None, :] * ny[:, None, None] * spacing)
        xi = torch.clamp(cx.to(torch.int64), 0, W - 1)
        yi = torch.clamp(cy.to(torch.int64), 0, H - 1)
        sgx, sgy = gx[yi, xi], gy[yi, xi]
        g_par = sgx * dirx[:, None, None] + sgy * diry[:, None, None]
        g_per = sgx * nx[:, None, None] + sgy * ny[:, None, None]

        def std_deflated(g):
            c = g - torch.mean(g, dim=1, keepdim=True)
            v = torch.mean(c * c, dim=1)
            return torch.sqrt(torch.clamp(v - grad_noise_var, min=0.0))

        stats = torch.cat([torch.mean(g_par, dim=1), torch.mean(g_per, dim=1),
                           std_deflated(g_par), std_deflated(g_per)], dim=1)
        return stats, img[yi, xi]

    g_tight, inten = band_stats(2.0)
    g_wide, inten_w = band_stats(5.0)
    band_mean = torch.mean(inten, dim=1)
    band_rel = band_mean - torch.mean(band_mean, dim=1, keepdim=True)
    q = NUM_SAMPLES // 4
    quarter_mean = torch.stack([torch.mean(inten[:, i * q:(i + 1) * q], dim=1)
                                for i in range(4)], dim=-1)          # [M, B, 4]
    quarter_rel = (quarter_mean - torch.mean(quarter_mean, dim=(1, 2), keepdim=True)
                   ).reshape(inten.shape[0], -1)
    band_mean_w = torch.mean(inten_w, dim=1)
    band_rel_w = band_mean_w - torch.mean(band_mean_w, dim=1, keepdim=True)
    feat = torch.cat([g_tight, g_wide * 0.7, band_rel * 0.5, quarter_rel * 0.35,
                      band_rel_w * 0.35], dim=1)
    n = torch.linalg.norm(feat, dim=1, keepdim=True)
    feat = feat / torch.where(n < 1e-6, torch.ones_like(n), n)
    # Image orientation, double-angle encoded (invariant to endpoint
    # order): the rotation-consistency prior (match/angle_checker.h).
    ang = torch.stack([dirx * dirx - diry * diry, 2.0 * dirx * diry], dim=1)
    feat = torch.cat([feat, ang * ANGLE_WEIGHT], dim=1)
    n2 = torch.linalg.norm(feat, dim=1, keepdim=True)
    feat = feat / torch.where(n2 < 1e-6, torch.ones_like(n2), n2)
    return torch.where(valid[:, None], feat, torch.zeros_like(feat))


def line_descriptor_distance_matrix(desc_a, desc_b, valid_a=None, valid_b=None):
    """Cosine distances between band descriptors (0 = identical); invalid
    rows and columns get 10."""
    d = 1.0 - desc_a @ desc_b.T
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, torch.full_like(d, 10.0))
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, torch.full_like(d, 10.0))
    return d


def _line_params(seg):
    d = seg[:, 2:4] - seg[:, 0:2]
    dirv = d / torch.clamp(torch.linalg.norm(d, dim=1), min=1e-6)[:, None]
    n = torch.stack([-dirv[:, 1], dirv[:, 0]], dim=1)
    return n, torch.sum(n * seg[:, 0:2], dim=1)


def detect_line_segments_multiscale(img, key=None, *, max_lines: int = 64,
                                    min_length: float = 40.0):
    """Two-scale detection (the LSD's scale pyramid,
    line_extractor.cc:130-136): three quarters of the budget at full
    resolution, one quarter from a half-resolution pass mapped back to
    level-0 pixels and deduplicated against the fine set in (angle,
    offset). Returns (seg [max_lines, 4], valid, strength)."""
    n_coarse = max(max_lines // 4, 4)
    n_fine = max_lines - n_coarse
    seg_f, val_f, str_f = detect_line_segments(img, max_lines=n_fine, min_length=min_length)
    H, W = img.shape
    half = image_ops.resize_bilinear(img, (H // 2, W // 2))
    seg_c, val_c, str_c = detect_line_segments(
        half, max_lines=n_coarse, min_length=min_length * 0.5,
        num_points=1024, num_hypotheses=1024,
    )
    seg_c = seg_c * 2.0
    nf, rf = _line_params(seg_f)
    nc, rc = _line_params(seg_c)
    ndot = nc @ nf.T
    sgn = torch.where(ndot >= 0, 1.0, -1.0)
    rho_d = torch.abs(rc[:, None] - sgn * rf[None, :])
    dup = (torch.abs(ndot) > 0.985) & (rho_d < 8.0) & val_f[None, :]
    val_c = val_c & ~torch.any(dup, dim=1)
    return (torch.cat([seg_f, seg_c]), torch.cat([val_f, val_c]),
            torch.cat([str_f, str_c]))
