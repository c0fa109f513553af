"""Image primitives: grayscale, resize pyramid, separable Gaussian blur.

Port of structure_plp_slam_tpu/ops/image.py. Images are f32 ``[H, W]``
tensors; the resize is the same pair of precomputed interpolation
matrices, the blur the same reflect-padded separable sum of shifted
copies, and the pyramid the same vertical atlas.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging import get_logger

_log = get_logger("torch.image")


def to_grayscale(img, device=None):
    """uint8/f32 ``[H, W]``, ``[H, W, 1]`` or ``[H, W, 3]`` (RGB) -> f32 ``[H, W]``."""
    img = torch.as_tensor(img, device=device)
    if img.ndim == 3 and img.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=img.device)
        return torch.tensordot(img.to(torch.float32), w, dims=([-1], [0]))
    if img.ndim == 3:
        img = img[..., 0]
    return img.to(torch.float32)


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` operator of jax.image.resize's antialiased
    bilinear (triangle-filter) weights along one axis."""
    scale = n_out / n_in
    x = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    j = np.arange(n_in, dtype=np.float64)
    inv_support = min(scale, 1.0)
    w = np.maximum(0.0, 1.0 - np.abs((j[None, :] - x[:, None]) * inv_support))
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


# XLA:CPU's f32 summation order for each resize product, keyed by the
# dot's shape ``(M, K, N)`` for ``[M, K] @ [K, N]``: the first product
# ``A @ img`` has ``(h, H, W)``, the second ``(A @ img) @ B.T`` has
# ``(h, W, w)``. XLA:CPU hands the dot to YNNPACK, which picks a kernel per
# shape, so no rule over the shape gives the order; these entries are
# measured, one per product of every pyramid level and half-resolution
# line pass the port's cameras and tests use, those that take
# ``_DEFAULT_ORDER`` too (``python -m
# tests.xla_dot_orders`` regenerates them, ``test_resize_summation_order``
# in tests/test_torch_frontend.py and tests/test_torch_dataset_cameras.py
# holds each against XLA). An order is
# ``(lanes, tree, split, tail)``: tap k goes to accumulator k % lanes,
# each accumulator one fused multiply-add chain in increasing k; the
# accumulators are added in pairs ((a0 + a1) + (a2 + a3)) when ``tree``,
# else left to right; with ``split`` > 0 each block of ``split``
# consecutive k is summed apart that way and the blocks' sums are added
# in increasing k. With ``tail`` the last K % lanes values of k (K odd
# under two lanes: k = K - 1 alone) stay out of the lanes and are summed
# in a chain of their own, added after the lanes and blocks are
# combined; without it they join the lanes like any other k (at K =
# 1241, KITTI's width, only some of the second products keep that k out
# of the lanes). Every entry matches XLA on every pixel of two random
# images. Measured with jax / jaxlib 0.9.0 on an x86-64 Xeon with AVX-512
# and AMX: another jaxlib, or a CPU on which YNNPACK picks other
# kernels, may sum in other orders; test_resize_summation_order then fails
# and tests.xla_dot_orders rewrites the table.
_DEFAULT_ORDER = (1, False, 512, False)
_XLA_DOT_ORDERS = {
    (43, 97, 131): (1, False, 512, False),
    (43, 131, 58): (1, False, 512, False),
    (65, 97, 131): (4, True, 0, False),
    (65, 131, 87): (2, False, 0, False),
    (67, 240, 320): (1, False, 512, False),
    (67, 320, 89): (2, False, 0, False),
    (71, 256, 512): (1, False, 512, False),
    (71, 512, 143): (4, True, 0, False),
    (80, 240, 320): (1, False, 512, False),
    (80, 320, 107): (4, True, 0, False),
    (86, 256, 512): (1, False, 512, False),
    (86, 512, 171): (4, True, 0, False),
    (96, 240, 320): (1, False, 512, False),
    (96, 320, 129): (4, True, 0, False),
    (103, 256, 512): (1, False, 512, False),
    (103, 512, 206): (4, True, 0, False),
    (105, 376, 1241): (2, False, 0, False),
    (105, 1241, 346): (2, False, 1024, True),
    (116, 240, 320): (1, False, 512, False),
    (116, 320, 154): (2, False, 0, False),
    (120, 240, 320): (1, False, 512, False),
    (120, 320, 160): (2, False, 0, False),
    (123, 256, 512): (1, False, 512, False),
    (123, 512, 247): (1, False, 512, False),
    (126, 376, 1241): (2, False, 0, False),
    (126, 1241, 416): (2, False, 1024, True),
    (128, 256, 512): (1, False, 512, False),
    (128, 512, 256): (1, False, 512, False),
    (134, 480, 640): (1, False, 512, False),
    (134, 480, 752): (4, True, 0, False),
    (134, 640, 179): (1, False, 512, False),
    (134, 752, 210): (2, False, 0, False),
    (139, 240, 320): (1, False, 512, False),
    (139, 320, 185): (1, False, 512, False),
    (143, 512, 1024): (1, False, 512, False),
    (143, 1024, 286): (2, False, 0, False),
    (148, 256, 512): (1, False, 512, False),
    (148, 512, 296): (4, True, 0, False),
    (151, 376, 1241): (2, False, 0, False),
    (151, 1241, 499): (1, False, 512, False),
    (161, 480, 640): (1, False, 512, False),
    (161, 480, 752): (4, True, 0, False),
    (161, 640, 214): (2, False, 0, False),
    (161, 752, 252): (1, False, 512, False),
    (167, 240, 320): (1, False, 512, False),
    (167, 320, 222): (2, False, 0, False),
    (171, 512, 1024): (1, False, 512, False),
    (171, 1024, 343): (2, False, 0, False),
    (178, 256, 512): (1, False, 512, False),
    (178, 512, 356): (4, True, 0, False),
    (181, 376, 1241): (2, False, 0, False),
    (181, 1241, 598): (2, False, 1024, True),
    (188, 376, 1241): (2, False, 0, False),
    (188, 1241, 620): (4, True, 0, False),
    (193, 480, 640): (1, False, 512, False),
    (193, 480, 752): (4, True, 0, False),
    (193, 640, 257): (4, True, 0, False),
    (193, 752, 302): (4, True, 0, False),
    (200, 240, 320): (1, False, 512, False),
    (200, 320, 267): (4, True, 0, False),
    (206, 512, 1024): (1, False, 512, False),
    (206, 1024, 412): (2, False, 0, False),
    (213, 256, 512): (1, False, 512, False),
    (213, 512, 427): (4, True, 0, False),
    (218, 376, 1241): (2, False, 0, False),
    (218, 1241, 718): (4, True, 0, False),
    (231, 480, 640): (1, False, 512, False),
    (231, 480, 752): (4, True, 0, False),
    (231, 640, 309): (1, False, 512, False),
    (231, 752, 363): (4, True, 0, False),
    (240, 480, 640): (1, False, 512, False),
    (240, 480, 752): (4, True, 0, False),
    (240, 640, 320): (1, False, 512, False),
    (240, 752, 376): (1, False, 512, False),
    (247, 512, 1024): (1, False, 512, False),
    (247, 1024, 494): (4, True, 0, False),
    (261, 376, 1241): (2, False, 0, False),
    (261, 1241, 862): (2, False, 1024, False),
    (268, 960, 1920): (1, False, 512, False),
    (268, 1920, 536): (2, False, 1024, False),
    (278, 480, 640): (1, False, 512, False),
    (278, 480, 752): (4, True, 0, False),
    (278, 640, 370): (1, False, 512, False),
    (278, 752, 435): (1, False, 512, False),
    (296, 512, 1024): (1, False, 512, False),
    (296, 1024, 593): (2, False, 0, False),
    (313, 376, 1241): (2, False, 0, False),
    (313, 1241, 1034): (4, True, 0, False),
    (322, 960, 1920): (1, False, 512, False),
    (322, 1920, 643): (4, True, 0, False),
    (333, 480, 640): (1, False, 512, False),
    (333, 480, 752): (4, True, 0, False),
    (333, 640, 444): (1, False, 512, False),
    (333, 752, 522): (4, True, 0, False),
    (356, 512, 1024): (1, False, 512, False),
    (356, 1024, 711): (4, True, 0, False),
    (386, 960, 1920): (1, False, 512, False),
    (386, 1920, 772): (4, True, 0, False),
    (400, 480, 640): (1, False, 512, False),
    (400, 480, 752): (4, True, 0, False),
    (400, 640, 533): (2, False, 0, False),
    (400, 752, 627): (1, False, 512, False),
    (427, 512, 1024): (1, False, 512, False),
    (427, 1024, 853): (2, False, 0, False),
    (463, 960, 1920): (1, False, 512, False),
    (463, 1920, 926): (2, False, 1024, False),
    (480, 960, 1920): (1, False, 512, False),
    (480, 1920, 960): (1, False, 512, False),
    (556, 960, 1920): (1, False, 512, False),
    (556, 1920, 1111): (2, False, 1024, False),
    (667, 960, 1920): (1, False, 512, False),
    (667, 1920, 1333): (1, False, 512, False),
    (800, 960, 1920): (1, False, 512, False),
    (800, 1920, 1600): (1, False, 512, False),
}


_UNMEASURED = set()  # the shapes _dot_order has warned about


def _dot_order(M: int, K: int, N: int):
    """The summation order of ``[M, K] @ [K, N]`` (``_XLA_DOT_ORDERS``,
    else ``_DEFAULT_ORDER``: one chain, blocks of 512). The resize equals
    XLA:CPU's bit for bit only for the shapes in the table, and only for
    the jaxlib and CPU it was measured with; another shape gets the
    default order, which XLA may not use, and logs one warning (once per
    shape) that the frontend may then part from the JAX package's in the
    last place."""
    order = _XLA_DOT_ORDERS.get((M, K, N))
    if order is None:
        order = _DEFAULT_ORDER
        if (M, K, N) not in _UNMEASURED:
            _UNMEASURED.add((M, K, N))
            _log.warning(
                "resize product %s has no measured XLA:CPU summation order; "
                "using the default, so the pyramid may differ from the JAX "
                "package's in the last place (add the camera to "
                "tests/xla_dot_orders.py and regenerate _XLA_DOT_ORDERS)",
                (M, K, N))
    return order


@functools.lru_cache(maxsize=256)
def _resize_taps(n_in: int, n_outs: tuple, order: tuple, device: str):
    """The nonzero taps of ``_resize_matrix(n_in, n_out)`` for each
    ``n_out`` of ``n_outs``, one after another along the output axis,
    grouped by the accumulator that sums them under ``order``: ``idx``
    int64 and ``w`` f64 ``[C, S, sum(n_outs)]`` (tap c of each of S =
    blocks x lanes accumulators, and one more for the tail when ``order``
    has one and K % lanes > 0; C taps each, padded with weight 0 on tap
    0 at the end of each chain, which adds an exact zero), on ``device``.
    The weights are f32 values held in f64: each product is then exact,
    and one f64 add rounded to f32 is a fused multiply-add."""
    lanes, _, split, tail = order
    tail0 = n_in - n_in % lanes if tail else n_in
    W = np.concatenate([_resize_matrix(n_in, n) for n in n_outs])
    groups = [[] for _ in range(W.shape[0])]
    nblk = 1
    for j in range(W.shape[0]):
        nz = np.nonzero(W[j])[0]
        blk0 = int(nz[0]) // split if split else 0
        per = {}
        for k in nz:
            if k >= tail0:
                per.setdefault((-1, 0), []).append(int(k))
                continue
            b = (int(k) // split - blk0) if split else 0
            nblk = max(nblk, b + 1)
            per.setdefault((b, int(k) % lanes), []).append(int(k))
        groups[j] = per
    S = nblk * lanes + (tail0 < n_in)
    C = max(len(v) for per in groups for v in per.values())
    idx = np.zeros((C, S, W.shape[0]), np.int64)
    w = np.zeros((C, S, W.shape[0]), np.float64)
    for j, per in enumerate(groups):
        for (b, lane), ks in per.items():
            s = S - 1 if b < 0 else b * lanes + lane
            idx[: len(ks), s, j] = ks
            w[: len(ks), s, j] = W[j, ks]
    dev = torch.device(device)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)


def _banded_dot(x, n_outs: tuple, dim: int, order):
    """``_resize_matrix`` for each of ``n_outs`` applied along ``dim`` of
    the f32 matrix ``x`` (the results one after another along ``dim``),
    every tap summed in ``order`` (see ``_XLA_DOT_ORDERS``). The same
    arithmetic on every device: f32 accumulators, each step one f64 add of
    an exact f64 product, rounded to f32. All taps are gathered and
    multiplied at once; only the rounding chain runs tap by tap."""
    lanes, tree, _, tail = order
    n_in = x.shape[dim]
    idx, w = _resize_taps(n_in, tuple(n_outs), order, str(x.device))
    x64 = x.to(torch.float64)
    if dim == 1:
        x64 = x64.T
    prod = x64[idx] * w[..., None]  # [C, S, sum(n_outs), cols], exact
    acc = prod[0].to(torch.float32)
    for c in range(1, idx.shape[0]):
        acc = (acc.to(torch.float64) + prod[c]).to(torch.float32)
    n_lane = acc.shape[0] - bool(tail and n_in % lanes)
    out = None
    for b in range(0, n_lane, lanes):
        part = acc[b : b + lanes]
        while tree and part.shape[0] > 1:
            part = part[0::2] + part[1::2]
        blk = part[0]
        for i in range(1, part.shape[0]):
            blk = blk + part[i]
        out = blk if out is None else out + blk
    if n_lane < acc.shape[0]:
        out = out + acc[-1]
    return out.T if dim == 1 else out


def resize_bilinear(img, out_hw):
    """Bilinear resize ``[H, W] -> out_hw``: the JAX package's two products
    ``(A @ img) @ B.T`` with the interpolation operators, each summed over
    its 2-8 nonzero taps in XLA:CPU's order for its shape, so the result
    is the JAX package's bit for bit on every device."""
    return _resize_many(img, [tuple(out_hw)])[0]


def _resize_many(img, shapes):
    """``resize_bilinear(img, hw)`` for each ``hw`` of ``shapes``; the first
    products of the shapes whose dots share an order run as one."""
    H, W = img.shape
    groups = {}
    for i, (h, _) in enumerate(shapes):
        groups.setdefault(_dot_order(h, H, W), []).append(i)
    out = [None] * len(shapes)
    for order, lvs in groups.items():
        hs = [shapes[i][0] for i in lvs]
        for i, rows in zip(lvs, _banded_dot(img, tuple(hs), 0, order).split(hs)):
            h, w = shapes[i]
            out[i] = _banded_dot(rows, (w,), 1, _dot_order(h, W, w))
    return out


@functools.lru_cache(maxsize=32)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _blur(img, ksize: int, sigma: float, fused: bool):
    """Separable Gaussian blur, reflect-101 padding, each pass's taps summed
    in increasing order. ``fused`` False: one f32 multiply and add per tap
    from zero (the JAX package's ``gaussian_blur`` called on its own).
    ``fused`` True: the order its jitted ORB extractor computes, the first
    two products joined in one fused multiply-add ``k0 * x0 + (k1 * x1)``
    and every later tap one more (emulated in f64, rounded to f32)."""
    k = _gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2

    def taps(x, dim):
        xs = x.unfold(dim, ksize, 1).movedim(-1, 0)  # tap i: [i] = x[j + i]
        if not fused:
            out = torch.zeros_like(img)
            for i in range(ksize):
                out = out + float(k[i]) * xs[i]
            return out
        out = float(k[1]) * xs[1]
        for i in [0] + list(range(2, ksize)):
            out = torch.add(out.to(torch.float64), xs[i].to(torch.float64),
                            alpha=float(k[i])).to(torch.float32)
        return out

    x = F.pad(img[None, None], (0, 0, half, half), mode="reflect")[0, 0]
    out = taps(x, 0)
    x = F.pad(out[None, None], (half, half, 0, 0), mode="reflect")[0, 0]
    return taps(x, 1)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur, reflect-101 padding (cv::BORDER_REFLECT_101),
    summed tap by tap in the JAX package's order."""
    return _blur(img, ksize, sigma, fused=False)


def pyramid_shapes(rows: int, cols: int, num_levels: int, scale_factor: float):
    """Static per-level (H, W) shapes for the image pyramid."""
    shapes = []
    for lv in range(num_levels):
        s = 1.0 / (scale_factor**lv)
        shapes.append((max(1, int(round(rows * s))), max(1, int(round(cols * s)))))
    return shapes


def build_pyramid(img, num_levels: int, scale_factor: float):
    """f32 ``[H, W]`` -> one f32 tensor per level, each resized from level
    0 with the cumulative scale (the frontend paints the same levels into
    the atlas, :func:`build_atlas`)."""
    shapes = pyramid_shapes(*img.shape, num_levels, scale_factor)
    return [img] + _resize_many(img, shapes[1:])


ATLAS_GAP = 24  # inter-level padding: > IC-angle patch radius (15) + blur


def atlas_layout(shapes, gap: int = ATLAS_GAP):
    """Vertical pyramid-atlas layout: per-level row offsets + atlas shape."""
    offsets = []
    y = 0
    W = 0
    for (h, w) in shapes:
        offsets.append(y)
        y += h + gap
        W = max(W, w)
    return offsets, y - gap, W


def build_atlas(img, shapes, offsets, atlas_h: int, atlas_w: int):
    """Resize ``img`` to every pyramid level and paint the levels into the
    vertical atlas (zero gaps between them)."""
    atlas = torch.zeros((atlas_h, atlas_w), dtype=img.dtype, device=img.device)
    levels = [img] + _resize_many(img, shapes[1:])
    for lv, ((h, w), y0) in enumerate(zip(shapes, offsets)):
        atlas[y0 : y0 + h, :w] = levels[lv]
    return atlas
