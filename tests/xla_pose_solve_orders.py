"""XLA:CPU's arithmetic for the JAX tracker's motion-only pose solve.

The port's ``ops/pose_cpu.py`` (``csrc/pose_solve_cpu.c``) computes the JAX
tracker's two pose solves on the CPU as XLA:CPU compiles them inside the
jitted ``track_frame``: the stage-1 solve vmapped over three association
strategies, the stage-2 solve alone. This module gives the tests their JAX
side and regenerates the evidence the C source was written from:

    JAX_PLATFORMS=cpu python -m tests.xla_pose_solve_orders [--dump DIR]

prints the normal matrix's stereo-dot blocks (``_H3_BLOCKS`` in
ops/pose_cpu.py), measured by probing XLA's dot at every shape of
``SHAPES`` in both the batched and the single layout, and raises if the
port's orders do not give XLA's dots on the random rows of every seed. With
``--dump DIR`` it first runs the JAX tracker on the organic out-and-back's
frame 1 (320x240) under ``XLA_FLAGS=--xla_dump_to=DIR
--xla_dump_hlo_as_text`` and lists, for every kernel of the two solves'
Gauss-Newton loops, the fused multiply-adds of its object file (``objdump
-d``; a dot without an object file of its own is handed to a library, whose
order only the probe measures). LLVM contracts a product into a sum while it
generates machine code, so the object file, not the LLVM IR, says which.
"""

from __future__ import annotations

import functools
import os
import re
import subprocess
from pathlib import Path

import numpy as np

# Observation rows of the port's frontends: 320x240 / 600 keypoints over 4
# levels, 640x480 and EuRoC 752x480 / 1000 over 8, KITTI 1241x376 / 2000.
SHAPES = (616, 1032, 2040)
# An order is kept only if it matches XLA on the random rows of every seed.
SEEDS = (0, 1)
_BIG = np.float32(2.0 ** 40)


def _dots(batched: bool):
    """XLA's two normal-matrix dots in the tracker's layouts: the monocular
    ``[6, 2N] x [2N, 6]`` with the rows contiguous, the stereo ``[N, 6] .
    [N, 6]`` contracted over the rows (a leading batch axis when
    ``batched``)."""
    import jax
    from jax import lax

    hi = lax.Precision.HIGHEST
    if batched:
        h2 = jax.jit(lambda a, b: lax.dot_general(a, b, (((2,), (1,)), ((0,), (0,))), precision=hi))
        h3 = jax.jit(lambda a, b: lax.dot_general(a, b, (((1,), (1,)), ((0,), (0,))), precision=hi))
    else:
        h2 = jax.jit(lambda a, b: lax.dot_general(a, b, (((1,), (0,)), ((), ())), precision=hi))
        h3 = jax.jit(lambda a, b: lax.dot_general(a, b, (((0,), (0,)), ((), ())), precision=hi))
    return h2, h3


def random_rows(n: int, seed: int, batch: int = 3):
    """``Jw2, J2 [batch, n, 2, 6]`` and ``J3w, J3r [batch, n, 6]`` f32 with
    magnitudes spread over several decades."""
    rng = np.random.default_rng(seed)

    def rows(*shape):
        return (rng.standard_normal(shape) * np.exp(2 * rng.standard_normal(shape))).astype(
            np.float32)

    return rows(batch, n, 2, 6), rows(batch, n, 2, 6), rows(batch, n, 6), rows(batch, n, 6)


def xla_normal_dots(Jw2, J2, J3w, J3r, batched: bool):
    """XLA's ``(sum Jw2^T J2, sum J3w^T J3r)`` per batch entry, numpy ``[B,
    6, 6]`` each, from rows as :func:`random_rows` gives them."""
    h2, h3 = _dots(batched)
    B, n = J3r.shape[:2]
    a = np.ascontiguousarray(Jw2.reshape(B, 2 * n, 6).transpose(0, 2, 1))
    b = np.ascontiguousarray(J2.reshape(B, 2 * n, 6))
    if batched:
        return np.asarray(h2(a, b)), np.asarray(h3(J3w, J3r))
    return (np.stack([np.asarray(h2(a[i], b[i])) for i in range(B)]),
            np.stack([np.asarray(h3(J3w[i], J3r[i])) for i in range(B)]))


def probe_blocks(n: int, batched: bool) -> tuple:
    """The blocks of rows XLA's stereo dot sums apart at ``n`` rows. Rows 0
    and j carry products +2^40 and -2^40, every other row 1: XLA returns n
    less the number of rows summed before 0 and j cancel, which is the size
    of the smallest block of the summation holding both. Rows that share
    row 0's chain give 2, 3, ... in order; a later block gives the running
    total of the blocks."""
    _, h3 = _dots(batched)
    sizes = []
    per = 18 if batched else 6
    js = list(range(1, n))
    for s in range(0, len(js), per):
        chunk = js[s:s + per]
        P = np.ones((per, n), np.float32)
        for r, j in enumerate(chunk):
            P[r, 0], P[r, j] = _BIG, -_BIG
        a = np.ascontiguousarray(P.reshape(-1, 6, n).transpose(0, 2, 1))
        ones = np.ones_like(a)
        res = np.asarray(h3(a, ones) if batched else np.stack([h3(x, y) for x, y in zip(a, ones)]))
        sizes += [n - int(v) for v in res[..., 0].reshape(-1)[:len(chunk)]]
    if sizes[:1] != [2]:
        raise RuntimeError(f"the stereo dot over {n} rows does not start with one chain: {sizes[:8]}")
    first = next((j for j, size in enumerate(sizes, start=1) if size != j + 1), n)
    blocks, total = [first], first
    for size in sorted(set(sizes[first - 1:])):
        blocks.append(size - total)
        total = size
    if total != n:
        raise RuntimeError(f"the stereo dot's blocks over {n} rows do not add up: {blocks}")
    return tuple(blocks)


def port_normal_dots(Jw2, J2, J3w, J3r):
    """The port's normal-matrix dots of one pose, ``(sum Jw2^T J2, sum J3w^T
    J3r)`` as torch ``[6, 6]``, for CPU rows ``Jw2, J2 [N, 2, 6]`` and
    ``J3w, J3r [N, 6]``: the C source's own dot functions
    (``normal_dots_cpu``), in the solve's summation orders."""
    import ctypes

    import torch

    from structure_plp_slam_tpu_torch.ops import pose_cpu

    fn = pose_cpu._load().normal_dots_cpu
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 2
    fn.restype = None
    N = J3r.shape[0]
    rows = [x.detach().to(torch.float32).contiguous() for x in (Jw2, J2, J3w, J3r)]
    blocks = torch.tensor(pose_cpu.h3_blocks(N), dtype=torch.int32)
    H2 = torch.empty((6, 6), dtype=torch.float32)
    H3 = torch.empty((6, 6), dtype=torch.float32)
    fn(N, *(pose_cpu._ptr(x) for x in rows), pose_cpu._ptr(blocks), len(blocks),
       pose_cpu._ptr(H2), pose_cpu._ptr(H3))
    return H2, H3


def measure(shapes=SHAPES, seeds=SEEDS) -> dict:
    """``{n: blocks}`` of the stereo dot, the same in the batched and the
    single layout; raises unless the port's orders give XLA's two dots on
    the random rows of every seed."""
    import torch

    from structure_plp_slam_tpu_torch.ops import pose_cpu

    table = {}
    for n in shapes:
        found = {probe_blocks(n, batched) for batched in (True, False)}
        if len(found) != 1:
            raise RuntimeError(f"{n} rows: the batched and single layouts differ: {found}")
        (blocks,) = found
        table[n] = blocks
        saved = pose_cpu._H3_BLOCKS.get(n)
        pose_cpu._H3_BLOCKS[n] = blocks
        try:
            for seed in seeds:
                rows = random_rows(n, seed)
                for batched in (True, False):
                    want = xla_normal_dots(*rows, batched)
                    for b in range(rows[0].shape[0]):
                        got = port_normal_dots(*(torch.from_numpy(x[b]) for x in rows))
                        for g, w, name in zip(got, want, ("monocular", "stereo")):
                            if not np.array_equal(g.numpy(), w[b]):
                                raise RuntimeError(f"{n} rows, seed {seed}: the {name} dot "
                                                   "differs from XLA's")
        finally:
            if saved is None:
                pose_cpu._H3_BLOCKS.pop(n)
            else:
                pose_cpu._H3_BLOCKS[n] = saved
    return table


@functools.lru_cache(maxsize=None)
def _trace_fn(camera, num_trials: int, num_iters: int, batched: bool):
    import jax
    import jax.numpy as jnp

    from structure_plp_slam_tpu.models import pose_opt as P
    from structure_plp_slam_tpu.ops import lie, robust
    from structure_plp_slam_tpu.ops import linalg as linalg_ops

    def solve(R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid):
        """structure_plp_slam_tpu/models/pose_opt.py's optimize_pose, line for
        line, with every Gauss-Newton step's values as scan outputs."""
        has_stereo = obs_xr >= 0.0

        def chi2_of(r_uv, r_xr):
            return robust.chi2_2d(r_uv, inv_sigma_sq) + jnp.where(
                has_stereo, r_xr * r_xr * inv_sigma_sq, 0.0)

        def robust_cost(R, t, inlier):
            _, r_uv, r_xr = P._residuals(camera, R, t, points_w, obs_uv, obs_xr)
            chi2 = chi2_of(r_uv, r_xr)
            delta_sq = jnp.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D)
            rho = jnp.where(chi2 <= delta_sq, chi2,
                            2.0 * jnp.sqrt(delta_sq * jnp.maximum(chi2, 1e-12)) - delta_sq)
            return jnp.sum(jnp.where(valid & inlier, rho, 0.0))

        def trial_body(carry, _):
            R, t, inlier = carry

            def lm_iter(carry2, _):
                R, t, lam, cost = carry2
                pc, r_uv, r_xr = P._residuals(camera, R, t, points_w, obs_uv, obs_xr)
                chi2 = chi2_of(r_uv, r_xr)
                delta_sq = jnp.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D)
                w = jnp.where(valid & inlier, robust.huber_weight(chi2, delta_sq) * inv_sigma_sq,
                              0.0)
                J_uv, J_xr_pc = P._point_jacobian_blocks(camera, pc)
                dpc = jnp.concatenate(
                    [jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (pc.shape[0], 3, 3)),
                     -lie.hat(pc)], axis=-1)
                J2 = J_uv @ dpc
                J3r = (J_xr_pc[:, None, :] @ dpc)[:, 0, :]
                w_st = jnp.where(has_stereo, w, 0.0)
                Jw2 = J2 * w[:, None, None]
                H = jnp.einsum("nri,nrj->ij", Jw2, J2) + jnp.einsum(
                    "ni,nj->ij", J3r * w_st[:, None], J3r)
                b = -(jnp.einsum("nri,nr->i", Jw2, r_uv)
                      + jnp.einsum("ni,n->i", J3r * w_st[:, None], r_xr))
                H_lm = H + lam * jnp.diag(jnp.maximum(jnp.diag(H), 1e-6))
                xi = linalg_ops.solve6_spd(H_lm, b)
                ok = jnp.all(jnp.isfinite(xi))
                xi = jnp.where(ok, lie.clamp_tangent(xi), 0.0)
                R_new, t_new = lie.se3_update(R, t, xi)
                new_cost = robust_cost(R_new, t_new, inlier)
                accept = ok & (new_cost < cost)
                step = dict(chi2=chi2, J3r=J3r, Jw2=Jw2, H=H, g=b, xi=xi, cost=new_cost,
                            accept=accept)
                R = jnp.where(accept, R_new, R)
                t = jnp.where(accept, t_new, t)
                cost = jnp.where(accept, new_cost, cost)
                lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7),
                                jnp.minimum(lam * 4.0, 1e4))
                return (R, t, lam, cost), step

            cost0 = robust_cost(R, t, inlier)
            (R, t, _, _), steps = jax.lax.scan(
                lm_iter, (R, t, jnp.float32(1e-3), cost0), None, length=num_iters)
            _, r_uv, r_xr = P._residuals(camera, R, t, points_w, obs_uv, obs_xr)
            thr = jnp.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D)
            return (R, t, valid & (chi2_of(r_uv, r_xr) <= thr)), steps

        (R, t, inlier), steps = jax.lax.scan(trial_body, (R0, t0, valid), None,
                                             length=num_trials)
        R = lie.orthonormalize(R)
        _, r_uv, r_xr = P._residuals(camera, R, t, points_w, obs_uv, obs_xr)
        total = jnp.sum(jnp.where(inlier, chi2_of(r_uv, r_xr), 0.0))
        return (R, t, inlier, total), steps

    if batched:
        return jax.jit(jax.vmap(solve, in_axes=(None, None, 0, None, None, None, 0)))
    return jax.jit(solve)


def pose_trace(camera, R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid, *,
               num_trials: int, num_iters: int):
    """The JAX package's pose solve with every Gauss-Newton step's values:
    ``((R, t, inliers, chi2), steps)`` as numpy, ``steps`` holding ``chi2``,
    ``J3r``, ``Jw2``, ``H``, ``g``, the clamped step ``xi``, the step's
    robust ``cost`` and ``accept``, each ``[(B,) num_trials, num_iters,
    ...]``. ``points_w [B, N, 3]`` / ``valid [B, N]`` run it vmapped, as the
    tracker's stage-1 solve; ``[N, 3]`` / ``[N]`` alone, as its stage 2."""
    fn = _trace_fn(camera, num_trials, num_iters, np.ndim(points_w) == 3)
    final, steps = fn(R0, t0, points_w, obs_uv, obs_xr, inv_sigma_sq, valid)
    return tuple(np.asarray(x) for x in final), {k: np.asarray(v) for k, v in steps.items()}


def out_and_back_frame1():
    """The JAX System's map after the organic out-and-back's frame 0 and the
    arguments of its tracker on frame 1: ``(camera, args, kwargs)`` for
    ``structure_plp_slam_tpu.models.tracker.track_frame``, as numpy."""
    import jax.numpy as jnp

    from tests import test_torch_loop_system as L

    frames, _ = L._out_and_back(L.TCAM, 42)
    js = L._jax_system(max_keyframes=64, max_landmarks=24576, max_kf_interval=2)
    js.startup()
    L.feed_all(js, frames[:1])
    img, depth, _ = frames[1]
    feats = js.frontend.rgbd(img, depth)
    (R, t), (Rv, tv) = js.pose, js.vel
    args = (js.state, feats, Rv @ R, Rv @ t + tv, js.last_kp_lm, js._ref_kf_dev,
            js.frontend.inv_sigma_sq, js._obs_indicator(), jnp.int32(1))
    js.shutdown()
    return L.JCAM, args, dict(num_levels=4, scale_factor=1.2)


def _computations(text: str) -> dict:
    comps, cur = {}, None
    for line in text.splitlines():
        if line and not line.startswith(" ") and line.rstrip().endswith("{"):
            cur = re.match(r"(?:ENTRY )?%?([\w.\-]+)", line).group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    return comps


def list_fused_multiply_adds(dump_dir: Path) -> None:
    """For each Gauss-Newton loop body of the dumped tracker (the while
    bodies that solve a 6x6 system), print each kernel and the fused
    multiply-adds of its object file."""
    (hlo,) = dump_dir.glob("*jit_track_frame.cpu_after_optimizations.txt")
    prefix = hlo.name.split(".cpu_after")[0]
    comps = _computations(hlo.read_text())
    bodies = []
    for lines in comps.values():
        for line in lines:
            m = re.search(r"while\(.*body=%([\w.\-]+)", line)
            if m and any("f32[6,6]" in ln or "f32[3,6,6]" in ln for ln in comps[m.group(1)]):
                bodies.append(m.group(1))
    objs = sorted(dump_dir.glob(f"{prefix}.obj-file.*.o"))
    symbols = {}
    for o in objs:
        nm = subprocess.run(["nm", str(o)], capture_output=True, text=True).stdout
        for line in nm.splitlines():
            parts = line.split()
            if len(parts) == 3 and parts[1] == "T":
                symbols[parts[2].removesuffix("_kernel")] = o
    for body in bodies:
        print(f"== loop body {body}")
        for line in comps[body]:
            m = re.match(r"\s+(?:ROOT )?%([\w.\-]+) = \S+ (fusion|dot)\(", line)
            if not m:
                continue
            name = m.group(1)
            obj = symbols.get(name)
            if obj is None:
                print(f"  {name}: no object file (a library call, or a kernel shared "
                      "with an identical fusion)")
                continue
            asm = subprocess.run(["objdump", "-d", "--no-show-raw-insn", str(obj)],
                                 capture_output=True, text=True).stdout
            fmas = [ln.split("\t")[-1].strip() for ln in asm.splitlines()
                    if re.search(r"\tvfn?m(add|sub)\d{3}[sp]s", ln)]
            print(f"  {name}: {len(fmas)} fused multiply-adds")
            for f in fmas[:12]:
                print(f"      {f}")


def dump_tracker(dump_dir: Path) -> None:
    """Run the JAX tracker on the out-and-back's frame 1 under the dump
    flags (set before JAX starts, in ``main``) and list its kernels."""
    from structure_plp_slam_tpu.models import tracker as jtracker

    cam, args, kw = out_and_back_frame1()
    jtracker.track_frame(cam, *args, **kw)
    list_fused_multiply_adds(dump_dir)


def main(argv=None) -> None:
    import argparse
    import platform

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", type=Path, help="dump the JAX tracker's kernels here and list them")
    a = ap.parse_args(argv)
    if a.dump is not None:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_dump_to={a.dump} --xla_dump_hlo_as_text")
    import jax
    import jaxlib

    jax.config.update("jax_platforms", "cpu")
    if a.dump is not None:
        dump_tracker(a.dump)
    print(f"# jaxlib {jaxlib.__version__}, {platform.machine()} {platform.processor()}, "
          f"{os.cpu_count()} CPUs")
    for n, blocks in measure().items():
        print(f"    {n}: {blocks},")


if __name__ == "__main__":
    main()
