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

prints the Schur product's block layout at the chain's shapes (``SHAPES``,
``TIER1_SHAPES``) and the grid contraction's run lengths (``GRID_SHAPES``,
``TIER1_GRID_SHAPES``), the entries of
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
# The shapes the other tier-1 Systems and chip paths reach: the window of C =
# 16 cameras that max_keyframes 8 gives, and the growth maps' M = 2048
# landmark slots (test_torch_chain_ba_xla_c16.py holds them).
TIER1_SHAPES = ((96, 12288), (96, 6144), (48, 6144), (192, 6144))
TIER1_GRID_SHAPES = ((16, 616, 4096), (16, 640, 4096), *(
    (C, Ng, 2048) for C in (8, 16, 32) for Ng in (616, 640)))
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
    return {"schur": xo.measure(SHAPES + TIER1_SHAPES),
            "grid": {shape: probe_grid_block(*shape) for shape in GRID_SHAPES + TIER1_GRID_SHAPES}}


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


# The baseline term fx * b of each setup's camera: the RGB-D Systems' at
# 320x240 (test_torch_system.py, the main path) and 640x480 (chip_smoke.py),
# the stereo Systems' 0.1 m baseline (test_torch_stereo.py).
FOCAL_X_BASELINE = {("rgbd", 320): 26.0, ("rgbd", 640): 40.0, ("stereo", 320): 26.0,
                    ("stereo", 640): 52.5}
SETUPS = ("mono", "rgbd", "stereo")
_STEREO_BASELINE = 0.1


def setup_camera(setup: str, width: int, package: str = "torch"):
    """The ``setup``'s camera at ``width`` (``WIDTHS``, ``FOCAL_X_BASELINE``)
    as the port's (``package="torch"``) or the JAX package's ``Camera``."""
    if package == "jax":
        from structure_plp_slam_tpu.camera import Camera, CameraModel, CameraSetup
    else:
        from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
    kw = dict(WIDTHS[width]["cam"])
    if setup != "mono":
        kw["focal_x_baseline"] = FOCAL_X_BASELINE[(setup, width)]
    member = {"mono": "MONOCULAR", "rgbd": "RGBD", "stereo": "STEREO"}[setup]
    return Camera(setup=getattr(CameraSetup, member), model=CameraModel.PERSPECTIVE, **kw)


def setup_frames(setup: str, width: int, seed: int, num_frames: int):
    """The rendered sequence of numpy seed ``seed`` a ``setup`` System is
    fed: ``(image, depth, ts)`` at 0.08 m a frame (monocular) or at
    ``make_sequence``'s 0.06 m (RGB-D); ``(left, right, ts)`` for stereo,
    the right image rendered at ``t - [0.1, 0, 0]``."""
    from structure_plp_slam_tpu_torch.testing import synthetic_scene

    cam = setup_camera(setup, width)
    rng = np.random.default_rng(seed)
    if setup == "mono":
        return synthetic_scene.make_sequence(rng, cam, num_frames, step=0.08)[0]
    if setup == "rgbd":
        return synthetic_scene.make_sequence(rng, cam, num_frames)[0]
    tex = synthetic_scene.make_texture(rng)
    pairs = []
    for i, (R, t) in enumerate(synthetic_scene.trajectory(num_frames)):
        left, _ = synthetic_scene.render(cam, tex, R, t)
        right, _ = synthetic_scene.render(cam, tex, R, t - np.array([_STEREO_BASELINE, 0, 0]))
        pairs.append((left, right, float(i) / 30.0))
    return pairs


def chain_call(width: int = 320, seed: int = 42, num_frames: int = 8, setup: str = "mono",
               max_keyframes: int | None = None):
    """The JAX System's first keyframe chain with a local BA (after its
    monocular init; or after the RGB-D or stereo System's first keyframe)
    on ``width``'s camera and capacities (``WIDTHS``; ``setup_camera``) and
    the rendered sequence of numpy seed ``seed`` (``setup_frames``): a dict
    with the JAX ``camera``, the chain's arguments ``args`` (state, slot,
    pose, timestamp, features, keypoint landmarks, next landmark slot, ...,
    inverse sigmas, indicator; as numpy) and static keywords ``kw`` of its
    first half, ``ba_in`` (the state the second half, which runs the local
    BA, starts from) and ``out`` (the second half's state, next landmark
    slot, next plane, next line and indicator). ``max_keyframes`` replaces
    the width's keyframe capacity: 8 gives the tier-1 Systems' window of C
    = 16 cameras."""
    _raise_stack()
    import structure_plp_slam_tpu.system as jsys
    from structure_plp_slam_tpu.config import Config as JConfig
    from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb

    cfg = WIDTHS[width]
    frames = setup_frames(setup, width, seed, num_frames)
    jcam = setup_camera(setup, width, "jax")
    calls = []
    chain = jsys._kf_chain

    def record(*a, **k):
        out = chain(*a, **k)
        if k.get("do_ba") and len(calls) < 2:
            calls.append((_host(a[1:]), {n: v for n, v in k.items() if n != "planar"},
                          _host(out)))
        return out

    sizes = dict(cfg["sizes"])
    if max_keyframes is not None:
        sizes["max_keyframes"] = max_keyframes
    js = jsys.System(JConfig(camera=jcam, orb=JOrb(**cfg["orb"]), raw={}), **sizes,
                     max_kf_interval=3, enable_loop_closing=False)
    feed = {"mono": lambda f: js.feed_monocular_frame(f[0], f[2]),
            "rgbd": lambda f: js.feed_RGBD_frame(*f),
            "stereo": lambda f: js.feed_stereo_frame(*f)}[setup]
    jsys._kf_chain = record
    try:
        js.startup()
        for f in frames:
            feed(f)
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
                      repeats: int = 8, width: int = 640, focal_x_baseline: float = 0.0,
                      stereo_share: float = 0.0):
    """A BA window as the chain extracts one (``BAProblem``'s fields as
    numpy) on ``width``'s camera (``WIDTHS``): ``C`` cameras along x, each
    observing up to ``Ng - 40`` of ``n_lm`` points with 1 px noise (3% of
    them 30 px outliers) on its grid row, the first and the second half's
    cameras fixed, 2 cm of noise on the points, 1 cm and 0.02 rad on the
    poses. Each row repeats ``repeats`` observed landmarks at its end, and
    every third row its first landmark twice more (a landmark seen two and
    three times by one keyframe). A share ``stereo_share`` of the observations
    has a stereo row where the right image sees the point: ``obs_xr``, its u
    there under ``focal_x_baseline`` with its own 1 px noise; the others are
    monocular (``obs_xr = -1``)."""
    rng = np.random.default_rng(seed)
    cam = WIDTHS[width]["cam"]
    X = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(5, 9, M)], 1)
    P = np.zeros((C, 3, 4))
    obs_lm = np.zeros((C, Ng), np.int64)
    uv = np.zeros((C, Ng, 2))
    xr = np.full((C, Ng), -1.0)
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
        if stereo_share:
            st = rng.random(n) < stereo_share
            xr_true = u[sel] - focal_x_baseline / pc[sel, 2] + rng.normal(0, 1.0, n)
            xr[c, :n] = np.where(st & (xr_true >= 0), xr_true, -1.0)
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
                obs_xr=xr.reshape(-1).astype(np.float32),
                obs_inv_sigma_sq=isg.reshape(-1).astype(np.float32),
                obs_valid=valid.reshape(-1))


# The values ``iterations_apart`` compares, per Gauss-Newton iteration.
OBS_FIELDS = ("pc", "r_uv", "r_xr", "chi2", "w", "Jc2", "Jl2", "Jc3", "Jl3", "Hcc_o", "Hll_o",
              "Hcl_o", "bc_o", "bl_o", "Hll", "WHinv", "Hcc", "bc", "S_red")
STEP_FIELDS = (*OBS_FIELDS, "S", "rhs", "Hll_inv", "W", "bl", "dx_l", "cam_pose", "lm_pos",
               "obs_live")


def port_camera(jcam):
    """The port's ``Camera`` equal to the JAX package's ``jcam``."""
    import dataclasses

    from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup

    return Camera(setup=CameraSetup(jcam.setup.value), model=CameraModel(jcam.model.value),
                  **{f.name: getattr(jcam, f.name) for f in dataclasses.fields(Camera)
                     if f.name not in ("setup", "model")})


def to_torch(x):
    """A torch tensor of a JAX-side numpy array (u32 as int32 bits, int32
    widened)."""
    import torch

    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if a.dtype == np.int32:
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def map_fields(state: dict) -> dict:
    """A map state's numpy fields with u32 fields as int32 bits."""
    return {f: (v.view(np.int32) if v.dtype == np.uint32 else v) for f, v in state.items()}


def port_chain(call: dict, tcam):
    """The port's ``_kf_chain`` on the JAX chain's arguments (``chain_call``):
    ``(state as numpy, next landmark slot, indicator)``."""
    from structure_plp_slam_tpu_torch import system as tsys
    from structure_plp_slam_tpu_torch.data import map_state as tms

    a, kw = call["args"], call["kw"]
    t = to_torch
    st, next_lm, _, _, ind, _, _ = tsys._kf_chain(
        tcam, tms.from_numpy(map_fields(a[0]), "cpu"), int(a[1]), t(a[2]), float(a[3]),
        {k: t(v) for k, v in a[4].items()}, t(a[5]), int(a[6]), t(a[12]), t(a[13]), None,
        do_ba=kw["do_ba"], do_cull_kf=kw["do_cull_kf"], stats_full=kw["stats_full"],
        do_detect=False, num_tri_neighbors=kw["num_tri_neighbors"],
        scale_factor=kw["scale_factor"], num_levels=kw["num_levels"],
        timer=tsys.StageTimer(device="cpu"))
    return tms.to_numpy(st), int(next_lm), ind.numpy()


def chain_window(call: dict, tcam):
    """The chain's BA window as the port extracts it (``mapper.local_ba``'s
    gathers, equal to the JAX package's) from the state the JAX BA starts
    from: a torch ``BAProblem``."""
    from structure_plp_slam_tpu_torch.data import map_state as tms
    from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
    from structure_plp_slam_tpu_torch.models import mapper as tmapper

    a = call["args"]
    seen = []
    solve = tba.ba_solve

    def record(camera, prob, *args, **k):
        seen.append(prob)
        return solve(camera, prob, *args, **k)

    tmapper.ba.ba_solve = record
    try:
        tmapper.local_ba(tcam, tms.from_numpy(map_fields(call["ba_in"]), "cpu"), int(a[1]),
                         to_torch(a[12]), ind=to_torch(call["out"][4]))
    finally:
        tmapper.ba.ba_solve = solve
    return seen[0]


def jax_problem(prob):
    """The JAX package's ``BAProblem`` of the port's ``prob``."""
    import jax.numpy as jnp
    import torch

    from structure_plp_slam_tpu.models import bundle_adjustment as jba

    return jba.BAProblem(**{f: jnp.asarray(v.numpy().astype(np.int32) if v.dtype == torch.int64
                                           else v.numpy()) for f, v in prob._asdict().items()})


def iterations_apart(tcam, prob, steps: dict, num_iters: int = 8, cull_at: int = 4):
    """Run the C iteration (``ops/ba_cpu``) from the window's start, each
    iteration on its own previous iterate, the cull after iteration
    ``cull_at``: the first iteration and its ``STEP_FIELDS`` that differ from
    the JAX trace's ``steps`` (``tests/xla_init_ba.ba_trace``), or None when
    every iteration is equal."""
    import torch

    from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
    from structure_plp_slam_tpu_torch.ops import ba_cpu, linalg, robust

    policy = tba._ba_policy(1e-4)
    free = (~prob.cam_fixed) & prob.cam_valid
    cam_pose, lm_pos = prob.cam_pose, prob.lm_pos
    live = prob.obs_valid & prob.cam_valid[prob.obs_cam] & prob.lm_valid[prob.obs_lm]
    gate = torch.where(prob.obs_xr >= 0, robust.CHI2_3D, robust.CHI2_2D).to(torch.float32)
    for it in range(num_iters):
        (S, rhs, Hinv, W, bl), st = ba_cpu.normal_equations(
            tcam, prob, cam_pose, lm_pos, live, free, policy=policy, trace=True)
        got = dict(st, S=S, rhs=rhs, Hll_inv=Hinv, W=W, bl=bl)
        dx_c = linalg.cho_solve(linalg.cho_factor(S), rhs)
        cam_pose, lm_pos, got["dx_l"] = ba_cpu.update(
            tcam, dx_c, Hinv, W, bl, cam_pose, lm_pos, free, prob.lm_valid, policy=policy,
            trace=True)
        if it == cull_at:
            live = live & (ba_cpu.obs_chi2(tcam, prob, cam_pose, lm_pos, policy=policy) <= gate)
        got.update(cam_pose=cam_pose, lm_pos=lm_pos, obs_live=live)
        apart = [k for k in STEP_FIELDS if not np.array_equal(got[k].numpy(), steps[k][it])]
        if apart:
            return it, apart
    return None


def main(argv=None) -> None:
    import argparse
    import platform

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", type=Path, help="dump the JAX chain's kernels here and list them")
    ap.add_argument("--setup", choices=SETUPS, default="mono",
                    help="the System whose chain --dump runs (default: mono)")
    ap.add_argument("--width", type=int, choices=sorted(WIDTHS), default=640,
                    help="its camera and capacities (default: 640)")
    ap.add_argument("--max-keyframes", type=int,
                    help="its keyframe capacity instead of the width's (8: a window of C = 16 "
                         "cameras, as the tier-1 Systems build)")
    a = ap.parse_args(argv)
    if a.dump is not None:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_dump_to={a.dump} --xla_dump_hlo_as_text")
    import jax
    import jaxlib

    jax.config.update("jax_platforms", "cpu")
    if a.dump is not None:
        chain_call(a.width, seed=0, setup=a.setup, max_keyframes=a.max_keyframes)
        xo.list_fused_multiply_adds(a.dump, module="jit__kf_chain")
    print(f"# jaxlib {jaxlib.__version__}, {platform.machine()} {platform.processor()}, "
          f"{os.cpu_count()} CPUs")
    for name, table in measure().items():
        print(f"# {name}")
        for shape, block in table.items():
            print(f"    {shape}: {block},")


if __name__ == "__main__":
    main()
