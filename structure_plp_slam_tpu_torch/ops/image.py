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


def resize_bilinear(img, out_hw):
    """Bilinear resize ``[H, W] -> out_hw`` as two matmuls."""
    H, W = img.shape
    A = torch.from_numpy(_resize_matrix(H, out_hw[0])).to(img.device)
    B = torch.from_numpy(_resize_matrix(W, out_hw[1])).to(img.device)
    return A @ img @ B.T


@functools.lru_cache(maxsize=32)
def _gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur, reflect-101 padding (cv::BORDER_REFLECT_101),
    summed tap by tap in the JAX package's order."""
    k = _gaussian_kernel_1d(ksize, sigma)
    half = ksize // 2
    H, W = img.shape
    x = F.pad(img[None, None], (0, 0, half, half), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + float(k[i]) * x[i : i + H, :]
    x = F.pad(out[None, None], (half, half, 0, 0), mode="reflect")[0, 0]
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + float(k[i]) * x[:, i : i + W]
    return out


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
    return [img if lv == 0 else resize_bilinear(img, shapes[lv]) for lv in range(num_levels)]


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
    for lv, ((h, w), y0) in enumerate(zip(shapes, offsets)):
        atlas[y0 : y0 + h, :w] = img if lv == 0 else resize_bilinear(img, (h, w))
    return atlas
