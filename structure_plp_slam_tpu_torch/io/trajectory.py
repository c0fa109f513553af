"""Trajectory export in TUM and KITTI formats, and ATE.

The port's own copy of structure_plp_slam_tpu/io/trajectory.py (numpy
only). Reference: src/PLPSLAM/io/trajectory_io.cc:111-125 (frames) / :180-194
(keyframes) — poses are written as camera-to-world: TUM rows
``ts tx ty tz qx qy qz qw``, KITTI rows are the 3x4 cam-to-world matrix
row-major. Input poses here are world->camera (the internal convention);
inversion happens on write.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def _invert(R_cw: np.ndarray, t_cw: np.ndarray):
    R_wc = R_cw.T
    t_wc = -R_cw.T @ t_cw
    return R_wc, t_wc


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), numpy (host IO path)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def save_tum(path: str, poses: Sequence[Tuple[float, np.ndarray]]):
    """``poses``: iterable of (timestamp, pose_cw [3,4])."""
    with open(path, "w") as f:
        for ts, P in poses:
            R_wc, t_wc = _invert(P[:, :3], P[:, 3])
            q = _quat_wxyz(R_wc)
            f.write(
                f"{ts:.9f} {t_wc[0]:.9f} {t_wc[1]:.9f} {t_wc[2]:.9f} "
                f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
            )


def save_kitti(path: str, poses: Sequence[Tuple[float, np.ndarray]]):
    with open(path, "w") as f:
        for _, P in poses:
            R_wc, t_wc = _invert(P[:, :3], P[:, 3])
            M = np.concatenate([R_wc, t_wc[:, None]], axis=1)
            f.write(" ".join(f"{v:.9e}" for v in M.reshape(-1)) + "\n")


def load_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    """Load TUM-format trajectory -> list of (ts, pose_cw [3,4])."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            # quaternion (w,x,y,z) -> R_wc
            w, x, y, z = qw, qx, qy, qz
            R_wc = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ]
            )
            t_wc = np.array([tx, ty, tz])
            R_cw = R_wc.T
            t_cw = -R_wc.T @ t_wc
            out.append((ts, np.concatenate([R_cw, t_cw[:, None]], axis=1)))
    return out


def ate_rmse(est: Sequence[Tuple[float, np.ndarray]],
             gt: Sequence[Tuple[float, np.ndarray]],
             align_scale: bool = True) -> float:
    """Absolute trajectory error after Umeyama Sim3/SE3 alignment
    (the evo_ape protocol the reference README prescribes).

    Matches trajectories by nearest timestamp (<= 20 ms).
    """
    gt_ts = np.array([t for t, _ in gt])
    P, Q = [], []
    for ts, Pe in est:
        i = int(np.argmin(np.abs(gt_ts - ts)))
        if abs(gt_ts[i] - ts) > 0.02:
            continue
        Re, te = _invert(Pe[:, :3], Pe[:, 3])
        Rg, tg = _invert(gt[i][1][:, :3], gt[i][1][:, 3])
        P.append(te)
        Q.append(tg)
    P = np.stack(P)
    Q = np.stack(Q)
    # Umeyama alignment P -> Q.
    mu_p, mu_q = P.mean(0), Q.mean(0)
    Pc, Qc = P - mu_p, Q - mu_q
    S = Qc.T @ Pc / len(P)
    U, D, Vt = np.linalg.svd(S)
    W = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        W[2, 2] = -1
    R = U @ W @ Vt
    if align_scale:
        var_p = (Pc**2).sum() / len(P)
        s = np.trace(np.diag(D) @ W) / var_p
    else:
        s = 1.0
    t = mu_q - s * R @ mu_p
    res = Q - (s * (R @ P.T).T + t)
    return float(np.sqrt((res**2).sum(axis=1).mean()))
