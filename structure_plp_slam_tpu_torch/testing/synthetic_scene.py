"""Synthetic renderable RGB-D scene (numpy + the port's own ops).

The port's copy of tests/synthetic_scene.py's make_texture, render,
render_fisheye, render_equirect, trajectory and make_sequence, built on
the port's gaussian_blur, so3_exp and camera functions so that it runs
without JAX: a textured background plane at z = PLANE_Z plus a foreground
patch at z = FG_Z, rendered through a perspective or fisheye camera with
exact depth and ground-truth poses, or a textured cube room around an
equirectangular camera.
"""

from __future__ import annotations

import numpy as np
import torch

from structure_plp_slam_tpu_torch.ops import image as image_ops
from structure_plp_slam_tpu_torch.ops import lie

PLANE_Z = 6.0
PLANE_HALF = 5.0  # plane spans [-5, 5]^2
FG_Z = 3.5
FG_X = (-1.1, 1.1)
FG_Y = (-0.9, 0.9)


def make_texture(rng, size=768, grid: bool = False):
    """A blurred noise texture with random flat squares; ``grid`` adds
    dark lines of irregular spacing, thickness and intensity (real 3D line
    structure on the planes, individually distinguishable)."""
    tex = rng.uniform(0, 255, size=(size, size)).astype(np.float32)
    tex = image_ops.gaussian_blur(torch.from_numpy(tex), 7, 1.5).numpy()
    for _ in range(int(size * 0.6)):
        cy, cx = rng.integers(10, size - 20, 2)
        s = rng.integers(4, 14)
        tex[cy : cy + s, cx : cx + s] = rng.uniform(0, 255)
    if grid:
        g = np.random.default_rng(7)
        pos = np.cumsum(g.integers(70, 190, size=12))
        for i, p in enumerate(pos[pos < size - 8]):
            w = 3 + (i % 3)
            tex[p : p + w, :] = 5.0 + 12.0 * (i % 4)
            q = int(pos[::-1][i % len(pos)] * 0.83) % (size - 8)
            tex[:, q : q + w] = 5.0 + 12.0 * ((i + 2) % 4)
    return tex


def render(camera, tex, R_cw, t_cw, plane_half: float = PLANE_HALF):
    """Render image + depth of the two textured planes."""
    H, W = camera.rows, camera.cols
    ys, xs = np.mgrid[0:H, 0:W]
    d = np.stack(
        [(xs - camera.cx) / camera.fx, (ys - camera.cy) / camera.fy,
         np.ones_like(xs, np.float64)],
        -1,
    )
    return _shade_planes(tex, R_cw, t_cw, d, plane_half)


def render_fisheye(camera, tex, R_cw, t_cw, plane_half: float = PLANE_HALF):
    """Render the two planes through a Kannala-Brandt fisheye camera
    (distorted image + depth). Each pixel's ray comes from the camera
    model's own undistortion, so the image is what the frontend undoes."""
    from structure_plp_slam_tpu_torch.camera import fisheye

    H, W = camera.rows, camera.cols
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    und = fisheye.undistort_keypoints(camera, torch.from_numpy(pix)).numpy()
    d = np.stack(
        [(und[:, 0] - camera.cx) / camera.fx, (und[:, 1] - camera.cy) / camera.fy,
         np.ones(len(und))],
        -1,
    ).reshape(H, W, 3)
    return _shade_planes(tex, R_cw, t_cw, d, plane_half)


def _shade_planes(tex, R_cw, t_cw, d, plane_half):
    """Image and z-depth of the rays ``d [H, W, 3]`` (camera frame) of a
    camera at pose (R_cw, t_cw) on the background plane and the
    foreground patch."""
    R_wc = R_cw.T
    C = -R_cw.T @ t_cw
    dw = d @ R_wc.T
    denom = np.where(np.abs(dw[..., 2]) < 1e-9, 1e-9, dw[..., 2])
    size = tex.shape[0]

    def hit_plane(z_plane):
        lam = (z_plane - C[2]) / denom
        return lam, C + lam[..., None] * dw

    _, pw_bg = hit_plane(PLANE_Z)
    lam_fg, pw_fg = hit_plane(FG_Z)
    fg_mask = (
        (lam_fg > 0)
        & (pw_fg[..., 0] >= FG_X[0]) & (pw_fg[..., 0] <= FG_X[1])
        & (pw_fg[..., 1] >= FG_Y[0]) & (pw_fg[..., 1] <= FG_Y[1])
    )
    pw = np.where(fg_mask[..., None], pw_fg, pw_bg)

    def sample(p, half, offset):
        u = (p[..., 0] + half) / (2 * half) * (size - 1)
        v = (p[..., 1] + half) / (2 * half) * (size - 1)
        ui = np.clip((u + offset).astype(int), 0, size - 1)
        vi = np.clip(v.astype(int), 0, size - 1)
        return tex[vi, ui]

    img = np.where(
        fg_mask, sample(pw_fg, 2.0, size // 3), sample(pw_bg, plane_half, 0)
    ).astype(np.float32)
    depth = ((pw - C) @ R_cw.T)[..., 2].astype(np.float32)
    return img, depth


def render_equirect(camera, tex, R_cw, t_cw, box_half: float = 6.0):
    """Render a 360 degree lat/long image from inside a textured cube
    room: every bearing hits a wall, behind the camera too. Returns
    (image, range map): the range is the ray length, the equirectangular
    depth convention."""
    from structure_plp_slam_tpu_torch.camera import equirectangular

    H, W = camera.rows, camera.cols
    ys, xs = np.mgrid[0:H, 0:W]
    pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], 1).astype(np.float32)
    b = equirectangular.bearings(camera, torch.from_numpy(pix)).numpy().reshape(H, W, 3)
    R_wc = R_cw.T
    C = -R_cw.T @ t_cw
    dw = b.astype(np.float64) @ R_wc.T
    size = tex.shape[0]
    best_lam = np.full((H, W), np.inf)
    img = np.zeros((H, W), np.float32)
    face = 0
    for ax, u_ax, v_ax in ((0, 1, 2), (1, 0, 2), (2, 0, 1)):
        for sign in (1.0, -1.0):
            denom = dw[..., ax]
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            lam = (sign * box_half - C[ax]) / denom
            pw_u = C[u_ax] + lam * dw[..., u_ax]
            pw_v = C[v_ax] + lam * dw[..., v_ax]
            hit = ((lam > 0.05) & (np.abs(pw_u) <= box_half + 1e-6)
                   & (np.abs(pw_v) <= box_half + 1e-6) & (lam < best_lam))
            u = (pw_u + box_half) / (2 * box_half) * (size - 1)
            v = (pw_v + box_half) / (2 * box_half) * (size - 1)
            off = (face * size) // 7  # a texture shift per face
            ui = (np.clip(u.astype(int), 0, size - 1) + off) % size
            vi = np.clip(v.astype(int), 0, size - 1)
            img = np.where(hit, tex[vi, ui], img)
            best_lam = np.where(hit, lam, best_lam)
            face += 1
    return img.astype(np.float32), best_lam.astype(np.float32)


def trajectory(num_frames, step=0.06, rot=0.004):
    """A gentle arc: translate along +x with slight yaw."""
    poses = []
    for i in range(num_frames):
        phi = torch.tensor([[0.0, rot * i, 0.0]], dtype=torch.float32)
        R = lie.so3_exp(phi)[0].numpy().astype(np.float64)
        C = np.array([step * i, 0.015 * np.sin(i * 0.4), 0.01 * i])
        poses.append((R, -R @ C))
    return poses


def make_sequence(rng, camera, num_frames=20, step=0.06, grid: bool = False):
    """``(frames, poses)``: frames are (image, depth, timestamp) at 30 fps,
    poses the ground-truth world->camera (R, t)."""
    tex = make_texture(rng, grid=grid)
    poses = trajectory(num_frames, step=step)
    frames = []
    for i, (R, t) in enumerate(poses):
        img, depth = render(camera, tex, R, t)
        frames.append((img, depth, float(i) / 30.0))
    return frames, poses
