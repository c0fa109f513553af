"""XLA:CPU's arithmetic for the JAX System's keyframe chain (ROADMAP C18).

The JAX System runs each keyframe's mapping chain as one jitted
``system._kf_chain``, on the CPU in two halves: insert, cull landmarks,
triangulate, fuse; then the local BA (C = 32 window cameras, M = 4096
landmarks, the observations a dense [C, Ng] grid), the keyframe cull and the
landmark statistics. The port's CPU route computes what that compile
computes: the BA iteration in ``ops/ba_cpu`` (``csrc/ba_solve_cpu.c``), the
triangulation's dots and the statistics' sums through ``ops/linalg``. This
module gives the tests their JAX side and regenerates the evidence:

    JAX_PLATFORMS=cpu python -m tests.xla_chain_ba [--dump DIR]

prints the Schur product's block length at the chain's shape (``SHAPES``)
and the grid contraction's run lengths (``GRID_SHAPES``), the entries of
``_SCHUR_BLOCKS`` and ``_GRID_BLOCKS`` in ops/ba_cpu.py, and raises if the
port's Schur product does not give XLA's dot on random rows of every seed.
With ``--dump DIR`` it first runs the JAX System at 640x480 to its first
keyframe chain under ``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text``
and lists, for the chain's BA loop body, each kernel's fused multiply-adds
(``tests/xla_init_ba.list_fused_multiply_adds``): the back-substitution
``W^T dx`` is ``bitcast_dot_fusion``, the camera step's norms
``maximum_rsqrt_fusion`` and ``multiply_reduce_fusion``, whose layout
``_UPDATE_LAYOUT`` records.
"""

from __future__ import annotations

import functools
import os
import resource
from pathlib import Path

import numpy as np

from tests import xla_init_ba as xo

# (6C, 3M) of the chain's Schur product: C = 16 + 16 window cameras, M = 4096.
SHAPES = ((192, 12288),)
# (C, Ng, M) of the grid contraction: the init's and the chain's windows at
# 640x480 (obs_cap 640) and 320x240 (616 keypoint slots).
GRID_SHAPES = ((8, 640, 4096), (32, 640, 4096), (8, 616, 4096), (32, 616, 4096))
_BIG = np.float32(2.0 ** 40)

# The monocular Systems the tests take their chains from: test_torch_mono.py's
# 320x240 camera and 640x480 camera (_full_width_systems), each with
# capacities that give the chain its full window (16 + 16 cameras, 4096
# landmark slots): 16 keyframes and 4096 landmarks at 320x240 (the smallest
# that do), _full_width_systems' 32 and 8192 at 640x480.
WIDTHS = {
    320: dict(cam=dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5,
                       cy=119.5, fps=30.0, focal_x_baseline=0.0, depth_threshold=400.0,
                       depthmap_factor=1.0),
              orb=dict(max_num_keypts=600, num_levels=4),
              sizes=dict(max_keyframes=16, max_landmarks=4096)),
    640: dict(cam=dict(name="b", cols=640, rows=480, fx=525.0, fy=525.0, cx=319.5, cy=239.5,
                       fps=30.0, focal_x_baseline=0.0, depth_threshold=40.0,
                       depthmap_factor=1.0),
              orb=dict(max_num_keypts=1000, num_levels=8),
              sizes=dict(max_keyframes=32, max_landmarks=8192)),
}


@functools.lru_cache(maxsize=None)
def _grid_dot(C: int, Ng: int, M: int):
    import jax
    import jax.numpy as jnp
    from jax import lax

    return jax.jit(lambda blk, oh: jnp.einsum("cnm,cnd->mcd", oh, blk,
                                              precision=lax.Precision.HIGHEST))


def probe_grid_block(C: int, Ng: int, M: int) -> int:
    """The length of the consecutive runs in which XLA's grid contraction
    (the BA's ``einsum("cnm,cnd->mcd", one-hot [C, Ng, M], blocks [C, Ng,
    30])``) sums a camera row. Column r of camera b carries +2^40 at slot 0
    and -2^40 at slot j, every other slot 1, against a one-hot of ones: the
    ones after j survive while 0 and j share a run, the runs after j's
    otherwise. Raises unless every probe fits runs of one length."""
    f = _grid_dot(C, Ng, M)
    R = 30
    res = np.zeros(Ng, np.int64)
    ones = np.ones((C, Ng, M), np.float32)
    for s in range(1, Ng, C * R):
        blk = np.ones((C, Ng, R), np.float32)
        js = []
        for b in range(C):
            for r in range(R):
                j = s + b * R + r
                if j < Ng:
                    blk[b, 0, r], blk[b, j, r] = _BIG, -_BIG
                    js.append((b, r, j))
        out = np.asarray(f(blk, ones))
        for b, r, j in js:
            res[j] = int(out[0, b, r])
    block = next((j for j in range(1, Ng) if res[j] != Ng - 1 - j), Ng)
    want = [max(Ng - 1 - j if j < block else Ng - (j // block + 1) * block, 0)
            for j in range(1, Ng)]
    if list(res[1:]) != want:
        raise RuntimeError(f"XLA's grid contraction {(C, Ng, M)} does not sum runs of {block}")
    return block


def measure() -> dict:
    """``{"schur": {(D, K): block}, "grid": {(C, Ng, M): run}}``; raises
    unless the port's Schur product with the measured block gives XLA's dot
    on random rows (``tests/xla_init_ba.measure``)."""
    return {"schur": xo.measure(SHAPES),
            "grid": {shape: probe_grid_block(*shape) for shape in GRID_SHAPES}}


def _raise_stack() -> None:
    # XLA:CPU's LLVM pipeline needs a deep stack to compile the chain
    # (tests/conftest.py).
    soft, hard = resource.getrlimit(resource.RLIMIT_STACK)
    want = 128 * 1024 * 1024
    if soft != resource.RLIM_INFINITY and soft < want:
        resource.setrlimit(resource.RLIMIT_STACK,
                           (want if hard == resource.RLIM_INFINITY else min(want, hard), hard))


def _host(x):
    """numpy copies of a JAX pytree of arrays (state, dicts, tuples)."""
    if hasattr(x, "_asdict"):
        return {f: np.array(v) for f, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: np.array(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return np.array(x)


def chain_call(width: int = 320, seed: int = 42, num_frames: int = 8):
    """The JAX System's first keyframe chain after its monocular init, on
    ``width``'s camera and capacities (``WIDTHS``) and the rendered sequence of
    numpy seed ``seed`` (0.08 m a frame): a dict with the JAX ``camera``,
    the chain's arguments ``args`` (state, slot, pose, timestamp, features,
    keypoint landmarks, next landmark slot, ..., inverse sigmas, indicator;
    as numpy) and static keywords ``kw`` of its first half, ``ba_in`` (the
    state the second half, which runs the local BA, starts from) and
    ``out`` (the second half's state, next landmark slot, next plane, next
    line and indicator)."""
    _raise_stack()
    import structure_plp_slam_tpu.system as jsys
    from structure_plp_slam_tpu.camera import Camera as JCamera
    from structure_plp_slam_tpu.camera import CameraModel as JModel
    from structure_plp_slam_tpu.camera import CameraSetup as JSetup
    from structure_plp_slam_tpu.config import Config as JConfig
    from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    cfg = WIDTHS[width]
    cam = Camera(setup=CameraSetup.MONOCULAR, model=CameraModel.PERSPECTIVE, **cfg["cam"])
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(seed), cam, num_frames,
                                              step=0.08)
    jcam = JCamera(setup=JSetup.MONOCULAR, model=JModel.PERSPECTIVE, **cfg["cam"])
    calls = []
    chain = jsys._kf_chain

    def record(*a, **k):
        out = chain(*a, **k)
        if k.get("do_ba") and len(calls) < 2:
            calls.append((_host(a[1:]), {n: v for n, v in k.items() if n != "planar"},
                          _host(out)))
        return out

    js = jsys.System(JConfig(camera=jcam, orb=JOrb(**cfg["orb"]), raw={}), **cfg["sizes"],
                     max_kf_interval=3, enable_loop_closing=False)
    jsys._kf_chain = record
    try:
        js.startup()
        for img, _, ts in frames:
            js.feed_monocular_frame(img, ts)
            if len(calls) == 2:
                break
        js.shutdown()
    finally:
        jsys._kf_chain = chain
    if len(calls) < 2:
        raise RuntimeError(f"no keyframe chain with a local BA within {num_frames} frames")
    (args, kw, _), (b_args, b_kw, out) = calls
    assert kw["part"] == "a" and b_kw["part"] == "b", (kw["part"], b_kw["part"])
    return dict(camera=jcam, args=args, kw=kw, ba_in=b_args[0], out=out)


def _rot(v, rng_angle):
    k = v / np.linalg.norm(v)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(rng_angle) * K + (1 - np.cos(rng_angle)) * K @ K


def synthetic_problem(C: int, seed: int, *, Ng: int = 640, M: int = 4096, n_lm: int = 3000,
                      repeats: int = 8):
    """A monocular BA window as the chain extracts one (``BAProblem``'s
    fields as numpy) at 640x480: ``C`` cameras along x, each observing up to
    ``Ng - 40`` of ``n_lm`` points with 1 px noise (3% of them 30 px
    outliers) on its grid row, the first and the second half's cameras
    fixed, 2 cm of noise on the points, 1 cm and 0.02 rad on the poses. Each row
    repeats ``repeats`` observed landmarks at its end, and every third row
    its first landmark twice more (a landmark seen two and three times by
    one keyframe)."""
    rng = np.random.default_rng(seed)
    cam = WIDTHS[640]["cam"]
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(5, 9, M)], 1)
    P = np.zeros((C, 3, 4))
    obs_lm = np.zeros((C, Ng), np.int64)
    uv = np.zeros((C, Ng, 2))
    valid = np.zeros((C, Ng), bool)
    isg = np.ones((C, Ng))
    for c in range(C):
        R = _rot(rng.normal(size=3), abs(rng.normal(0, 0.05)))
        t = -R @ np.array([0.15 * c - 1.0, rng.normal(0, 0.05), rng.normal(0, 0.05)])
        P[c] = np.concatenate([R, t[:, None]], 1)
        pc = X[:n_lm] @ R.T + t
        u = cam["fx"] * pc[:, 0] / pc[:, 2] + cam["cx"]
        v = cam["fy"] * pc[:, 1] / pc[:, 2] + cam["cy"]
        seen = np.flatnonzero((u > 0) & (u < cam["cols"]) & (v > 0) & (v < cam["rows"])
                              & (pc[:, 2] > 0.1))
        sel = np.sort(rng.permutation(seen)[:Ng - 40 - repeats])
        if repeats:
            sel = np.concatenate([sel, rng.choice(sel, repeats)])
            if c % 3 == 0:
                sel = np.concatenate([sel, [sel[0], sel[0]]])
        n = len(sel)
        obs_lm[c, :n], valid[c, :n] = sel, True
        noise = rng.normal(0, 1.0, (n, 2))
        noise[rng.random(n) < 0.03] *= 30
        uv[c, :n] = np.stack([u[sel], v[sel]], 1) + noise
        isg[c, :n] = 1.0 / 1.2 ** (2 * rng.integers(0, 8, n))
    for c in range(C):  # 1 cm and ~1 degree of noise on the window's poses
        P[c, :, :3] = _rot(rng.normal(size=3), 0.02) @ P[c, :, :3]
    P[:, :, 3] += rng.normal(0, 0.01, (C, 3))
    fixed = np.zeros(C, bool)
    fixed[0] = True
    fixed[C // 2:] = True
    return dict(cam_pose=P.astype(np.float32), cam_fixed=fixed, cam_valid=np.ones(C, bool),
                lm_pos=(X + rng.normal(0, 0.02, X.shape)).astype(np.float32),
                lm_valid=np.arange(M) < n_lm, obs_cam=np.repeat(np.arange(C), Ng),
                obs_lm=obs_lm.reshape(-1), obs_uv=uv.reshape(-1, 2).astype(np.float32),
                obs_xr=np.full(C * Ng, -1, np.float32),
                obs_inv_sigma_sq=isg.reshape(-1).astype(np.float32),
                obs_valid=valid.reshape(-1))


def main(argv=None) -> None:
    import argparse
    import platform

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", type=Path, help="dump the JAX chain's kernels here and list them")
    a = ap.parse_args(argv)
    if a.dump is not None:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_dump_to={a.dump} --xla_dump_hlo_as_text")
    import jax
    import jaxlib

    jax.config.update("jax_platforms", "cpu")
    if a.dump is not None:
        chain_call(640, seed=0)
        xo.list_fused_multiply_adds(a.dump, module="jit__kf_chain")
    print(f"# jaxlib {jaxlib.__version__}, {platform.machine()} {platform.processor()}, "
          f"{os.cpu_count()} CPUs")
    for name, table in measure().items():
        print(f"# {name}")
        for shape, block in table.items():
            print(f"    {shape}: {block},")


if __name__ == "__main__":
    main()
