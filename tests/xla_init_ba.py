"""XLA:CPU's arithmetic for the JAX System's two-view init BA.

The port's ``ops/ba_cpu.py`` (``csrc/ba_solve_cpu.c``) computes the init's
local BA (the System's ``mapper.local_ba`` after the monocular two-view
init: 8 window cameras, 4096 landmark slots) on the CPU as XLA:CPU compiles
the JAX package's. This module gives the tests their JAX side and
regenerates the evidence the C source was written from:

    JAX_PLATFORMS=cpu python -m tests.xla_init_ba [--dump DIR]

prints the Schur product's block layout (``_SCHUR_BLOCKS`` in
ops/ba_cpu.py), probed on XLA's dot at every shape of ``SHAPES``, and raises
if the port's Schur product does not give XLA's dot on random rows of every
seed. With ``--dump DIR`` it first runs the JAX System to its 320x240
monocular init under ``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text``
and lists, for every kernel of the init BA's Gauss-Newton loop, the fused
multiply-adds of its object file (``objdump -d``; a dot without an object
file of its own is handed to a library, whose order only a probe or the
values measure).
"""

from __future__ import annotations

import functools
import os
import re
import subprocess
from pathlib import Path

import numpy as np

# (6C, 3M) of the init's Schur product: C = 8 window cameras, M = 4096
# landmark slots (system.py's init: max_opt=4, max_fix=4, max_lms=4096).
SHAPES = ((48, 12288),)
SEEDS = (0, 1)
_BIG = np.float32(2.0 ** 40)


@functools.lru_cache(maxsize=None)
def _schur_dot():
    import jax
    from jax import lax

    return jax.jit(lambda a, b: lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                                                precision=lax.Precision.HIGHEST))


def _schur_response(D: int, K: int, block: int, lanes: int) -> np.ndarray:
    """What ``probe_schur_block``'s rows return for every j >= 1 if XLA's dot
    sums K in consecutive blocks of ``block``, each in ``lanes`` interleaved
    lanes (entry k of the first block in lane k % lanes), each lane a chain
    from its first entry, the lanes and then the blocks added in order: the
    ones of the cancelled lane after j, of the lanes added after the
    cancellation and of the blocks after j's survive; the rest meet 2^40."""
    j = np.arange(1, K)
    n0 = min(block, K)
    size = np.array([(n0 - lane + lanes - 1) // lanes for lane in range(lanes)])
    after = np.concatenate([np.cumsum(size[::-1])[::-1][1:], [0]])  # lanes after each
    rest = K - n0
    lane = j % lanes
    first = np.where(lane == 0, size[0] - (j // lanes + 1) + after[0], after[lane]) + rest
    later = np.maximum(K - (j // block + 1) * block, 0)
    return np.where(j < block, first, later)


def probe_schur_block(D: int, K: int) -> tuple:
    """The ``(block length, lanes)`` of XLA's ``[D, K] x [K, D]`` dot: it sums
    K in consecutive blocks of that length, each block in that many
    interleaved lanes (``_schur_response``). Row r carries products +2^40 at
    k = 0 and -2^40 at k = j, every other product 1: the ones that never
    share a partial sum with 2^40 survive the cancellation. Raises unless
    the probes fit exactly one layout."""
    f = _schur_dot()
    res = np.zeros(K, np.int64)
    ones = np.ones((K, D), np.float32)
    for s in range(1, K, D):
        js = list(range(s, min(s + D, K)))
        a = np.ones((D, K), np.float32)
        for r, j in enumerate(js):
            a[r, 0], a[r, j] = _BIG, -_BIG
        out = np.asarray(f(a, ones))[:, 0]
        res[js] = out[:len(js)].astype(np.int64)
    # A block boundary j starts the second block: the response steps there
    # to K - 2 j.
    starts = [j for j in range(1, K) if res[j] == max(K - 2 * j, 0) and res[j - 1] != res[j]]
    fits = [(block, lanes) for lanes in (1, 2, 4, 8, 16) for block in (*starts, K)
            if np.array_equal(res[1:], _schur_response(D, K, block, lanes))]
    if len(fits) != 1:
        raise RuntimeError(f"XLA's [{D}, {K}] dot fits {len(fits)} block layouts: {fits}")
    return fits[0]


def random_rows(M: int, C: int, seed: int):
    """``WHinv, W [M, C, 6, 3]`` f32 with magnitudes spread over several
    decades."""
    rng = np.random.default_rng(seed)

    def rows():
        shape = (M, C, 6, 3)
        return (rng.standard_normal(shape) * np.exp(2 * rng.standard_normal(shape))).astype(
            np.float32)

    return rows(), rows()


def xla_schur(WH, W):
    """XLA's Schur product ``sum_{m,k} WH[m,c,i,k] W[m,d,j,k]`` as ``[6C,
    6C]``, the contraction index laid out k-major (K = k M + m), as the
    init BA's compile lays it out."""
    M, C = W.shape[:2]
    a = np.ascontiguousarray(WH.reshape(M, 6 * C, 3).transpose(1, 2, 0).reshape(6 * C, 3 * M))
    b = np.ascontiguousarray(W.reshape(M, 6 * C, 3).transpose(2, 0, 1).reshape(3 * M, 6 * C))
    return np.asarray(_schur_dot()(a, b))


def port_schur(WH, W):
    """The C source's Schur product of the same rows (``ba_schur_cpu``,
    blocked as ``ba_cpu.normal_equations`` blocks it)."""
    from structure_plp_slam_tpu_torch.ops import ba_cpu

    M, C = W.shape[:2]
    WH, W = (np.ascontiguousarray(x, dtype=np.float32) for x in (WH, W))
    Sr = np.empty((6 * C, 6 * C), dtype=np.float32)
    rc = ba_cpu._load().ba_schur_cpu(C, M, *ba_cpu.schur_block(6 * C, 3 * M), WH.ctypes.data,
                                     W.ctypes.data, None, Sr.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"ba_schur_cpu returned {rc}")
    return Sr


def measure(shapes=SHAPES, seeds=SEEDS) -> dict:
    """``{(D, K): (block, lanes)}``; raises unless the port's Schur product
    with the measured layout gives XLA's dot on the random rows of every
    seed."""
    from structure_plp_slam_tpu_torch.ops import ba_cpu

    table = {}
    for D, K in shapes:
        block = table[(D, K)] = probe_schur_block(D, K)
        saved = ba_cpu._SCHUR_BLOCKS.get((D, K))
        ba_cpu._SCHUR_BLOCKS[(D, K)] = block
        try:
            for seed in seeds:
                WH, W = random_rows(K // 3, D // 6, seed)
                if not np.array_equal(port_schur(WH, W), xla_schur(WH, W)):
                    raise RuntimeError(f"[{D}, {K}], seed {seed}: the Schur product differs "
                                       "from XLA's")
        finally:
            if saved is None:
                ba_cpu._SCHUR_BLOCKS.pop((D, K))
            else:
                ba_cpu._SCHUR_BLOCKS[(D, K)] = saved
    return table


@functools.lru_cache(maxsize=None)
def _trace_fn(camera, num_iters: int, cull_at_iters: tuple, damping: float):
    import jax
    import jax.numpy as jnp

    from structure_plp_slam_tpu.camera import base as cam_base
    from structure_plp_slam_tpu.models import bundle_adjustment as B
    from structure_plp_slam_tpu.ops import lie, robust

    def solve(prob):
        """structure_plp_slam_tpu/models/bundle_adjustment.py's ba_solve
        (obs_grid=True, no lines), line for line, with every Gauss-Newton
        iteration's values as scan outputs."""
        C = prob.cam_pose.shape[0]
        M = prob.lm_pos.shape[0]
        has_stereo = prob.obs_xr >= 0.0
        obs_live0 = prob.obs_valid & prob.cam_valid[prob.obs_cam] & prob.lm_valid[prob.obs_lm]
        onehot_lm = (prob.obs_lm[:, None] == jnp.arange(M, dtype=prob.obs_lm.dtype)).astype(
            jnp.float32)
        O = prob.obs_lm.shape[0]
        Ng = O // C
        oh_grid = onehot_lm.reshape(C, Ng, M).astype(jnp.bfloat16)
        free = (~prob.cam_fixed) & prob.cam_valid

        def assemble(Hcc_o, Hll_o, Hcl_o, bc_o, bl_o):
            Hcc = jnp.sum(Hcc_o.reshape(C, Ng, 6, 6), axis=1)
            bc = jnp.sum(bc_o.reshape(C, Ng, 6), axis=1)
            blk = jnp.concatenate([Hll_o.reshape(C, Ng, 9), bl_o.reshape(C, Ng, 3),
                                   Hcl_o.reshape(C, Ng, 18)], axis=-1)
            out = jnp.einsum("cnm,cnd->mcd", oh_grid, blk)
            Hll = jnp.sum(out[:, :, 0:9], axis=1).reshape(M, 3, 3)
            bl = jnp.sum(out[:, :, 9:12], axis=1)
            W = out[:, :, 12:30].reshape(M, C, 6, 3)
            return Hcc, Hll, bc, bl, W

        def iteration(carry, it):
            cam_pose, lm_pos, obs_live = carry
            pc, r_uv, r_xr = B._project_residuals(camera, cam_pose, lm_pos, prob)
            chi2 = B._obs_chi2(prob, r_uv, r_xr, has_stereo)
            delta_sq = jnp.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D)
            w = jnp.where(obs_live, robust.huber_weight(chi2, delta_sq) * prob.obs_inv_sigma_sq,
                          0.0)
            w = jnp.where(cam_base.cheirality(camera, pc), w, 0.0)
            x, z = pc[:, 0], pc[:, 2]
            z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
            iz = 1.0 / z
            iz2 = iz * iz
            zero = jnp.zeros_like(z)
            J_uv_pc = cam_base.project_jacobian(camera, pc)
            J_xr_pc = jnp.stack([camera.fx * iz, zero,
                                 -camera.fx * x * iz2 + camera.focal_x_baseline * iz2], -1)
            R = cam_pose[prob.obs_cam, :, :3]
            dpc_dxi = jnp.concatenate(
                [jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (pc.shape[0], 3, 3)),
                 -lie.hat(pc)], axis=-1)
            Jc2 = J_uv_pc @ dpc_dxi
            Jl2 = J_uv_pc @ R
            Jc3 = (J_xr_pc[:, None, :] @ dpc_dxi)[:, 0]
            Jl3 = (J_xr_pc[:, None, :] @ R)[:, 0]
            w_st = jnp.where(has_stereo, w, 0.0)
            Hcc_o = jnp.einsum("ori,orj->oij", Jc2 * w[:, None, None], Jc2) + jnp.einsum(
                "oi,oj->oij", Jc3 * w_st[:, None], Jc3)
            Hll_o = jnp.einsum("ori,orj->oij", Jl2 * w[:, None, None], Jl2) + jnp.einsum(
                "oi,oj->oij", Jl3 * w_st[:, None], Jl3)
            Hcl_o = jnp.einsum("ori,orj->oij", Jc2 * w[:, None, None], Jl2) + jnp.einsum(
                "oi,oj->oij", Jc3 * w_st[:, None], Jl3)
            bc_o = -(jnp.einsum("ori,or->oi", Jc2 * w[:, None, None], r_uv)
                     + Jc3 * (w_st * r_xr)[:, None])
            bl_o = -(jnp.einsum("ori,or->oi", Jl2 * w[:, None, None], r_uv)
                     + Jl3 * (w_st * r_xr)[:, None])
            Hcc, Hll, bc, bl, W = assemble(Hcc_o, Hll_o, Hcl_o, bc_o, bl_o)
            lam_l = damping * jnp.maximum(
                jnp.trace(Hll, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6)
            Hll_inv = B.inv3x3(Hll + lam_l * jnp.eye(3, dtype=jnp.float32)[None])
            WHinv = jnp.einsum("mcij,mjk->mcik", W, Hll_inv)
            S_red = jnp.einsum("mcik,mdjk->cdij", WHinv, W)
            eye_cc = jnp.eye(C, dtype=jnp.float32)[:, :, None, None]
            S = -S_red + eye_cc * Hcc[:, None]
            rhs = bc - jnp.einsum("mcik,mk->ci", WHinv, bl)
            free_f = free.astype(jnp.float32)
            S = S * free_f[:, None, None, None] * free_f[None, :, None, None]
            eye6 = jnp.eye(6, dtype=jnp.float32)
            S = S + eye_cc * (jnp.where(free[:, None, None], 0.0, 1.0) * eye6[None])[:, None]
            diag_scale = damping * jnp.maximum(
                jnp.trace(jnp.einsum("ccij->cij", S), axis1=-2, axis2=-1) / 6.0, 1e-6)
            S = S + eye_cc * (diag_scale[:, None, None] * eye6[None])[:, None]
            rhs = rhs * free_f[:, None]
            S_dense = S.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C)
            L, low = jax.scipy.linalg.cho_factor(S_dense, lower=True)
            dx_c = jax.scipy.linalg.cho_solve((L, low), rhs.reshape(6 * C)).reshape(C, 6)
            dx_l = jnp.einsum("mij,mj->mi", Hll_inv, bl - jnp.einsum("mcij,ci->mj", W, dx_c))
            ok = jnp.all(jnp.isfinite(dx_c)) & jnp.all(jnp.isfinite(dx_l))
            dx_c = jnp.where(ok, lie.clamp_tangent(dx_c, 0.3, 5.0), 0.0)
            dx_l = jnp.where(ok, jnp.clip(dx_l, -5.0, 5.0), 0.0)
            R_new, t_new = lie.se3_update(cam_pose[:, :, :3], cam_pose[:, :, 3], dx_c)
            cam_pose_new = jnp.where(free[:, None, None], lie.pack_pose(R_new, t_new), cam_pose)
            lm_pos_new = jnp.where(prob.lm_valid[:, None], lm_pos + dx_l, lm_pos)

            def cull(live):
                _, r_uv2, r_xr2 = B._project_residuals(camera, cam_pose_new, lm_pos_new, prob)
                chi2n = B._obs_chi2(prob, r_uv2, r_xr2, has_stereo)
                return live & (chi2n <= jnp.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D))

            do_cull = jnp.zeros((), bool)
            for ci in cull_at_iters:
                do_cull = do_cull | (it == ci)
            obs_live = jax.lax.cond(do_cull, cull, lambda m: m, obs_live)
            step = dict(pc=pc, r_uv=r_uv, r_xr=r_xr, chi2=chi2, w=w, Jc2=Jc2, Jl2=Jl2, Jc3=Jc3,
                        Jl3=Jl3, Hcc_o=Hcc_o,
                        Hll_o=Hll_o, Hcl_o=Hcl_o, bc_o=bc_o, bl_o=bl_o, Hcc=Hcc, Hll=Hll, bc=bc,
                        bl=bl, W=W, Hll_inv=Hll_inv, WHinv=WHinv,
                        S_red=S_red.transpose(0, 2, 1, 3).reshape(6 * C, 6 * C), S=S_dense,
                        rhs=rhs.reshape(6 * C), dx_l=dx_l, cam_pose=cam_pose_new,
                        lm_pos=lm_pos_new, obs_live=obs_live)
            return (cam_pose_new, lm_pos_new, obs_live), step

        (cam_pose, lm_pos, obs_live), steps = jax.lax.scan(
            iteration, (prob.cam_pose, prob.lm_pos, obs_live0), jnp.arange(num_iters))
        cam_pose = lie.pack_pose(lie.orthonormalize(cam_pose[:, :, :3]), cam_pose[:, :, 3])
        cam_pose = jnp.where(free[:, None, None], cam_pose, prob.cam_pose)
        _, r_uv, r_xr = B._project_residuals(camera, cam_pose, lm_pos, prob)
        chi2 = B._obs_chi2(prob, r_uv, r_xr, has_stereo)
        inlier = obs_live & (chi2 <= jnp.where(has_stereo, robust.CHI2_3D, robust.CHI2_2D))
        return (cam_pose, lm_pos, inlier, jnp.sum(jnp.where(inlier, chi2, 0.0))), steps

    return jax.jit(solve)


def ba_trace(camera, prob, *, num_iters: int = 8, cull_at_iters: tuple = (4,),
             damping: float = 1e-4):
    """The JAX package's ``ba_solve(obs_grid=True)`` on the JAX ``BAProblem``
    ``prob`` with every Gauss-Newton iteration's values: ``((cam_pose,
    lm_pos, inliers, chi2), steps)`` as numpy, ``steps`` holding the
    per-observation ``pc``, ``r_uv``, ``r_xr``, ``chi2``, ``w``, ``Jc2``,
    ``Jl2``, ``Jc3``, ``Jl3`` and blocks ``Hcc_o``, ``Hll_o``, ``Hcl_o``,
    ``bc_o``, ``bl_o``; the sums
    ``Hcc``, ``Hll``, ``bc``, ``bl``, ``W``; ``Hll_inv``, ``WHinv``, the
    Schur product ``S_red`` and the camera system ``S``, ``rhs`` (``[6C,
    6C]`` / ``[6C]``, row (c, i)); the clipped landmark step ``dx_l``, and
    the iteration's ``cam_pose``, ``lm_pos`` and ``obs_live``, each with a
    leading ``[num_iters]`` axis."""
    fn = _trace_fn(camera, num_iters, tuple(cull_at_iters), float(damping))
    final, steps = fn(prob)
    return tuple(np.asarray(x) for x in final), {k: np.asarray(v) for k, v in steps.items()}


def init_ba_call():
    """The JAX System's init BA on test_torch_mono.py's 320x240 sequence
    (numpy seed 42, 600 keypoints over 4 levels): ``(camera, state, args,
    kwargs, out)`` of its ``mapper.local_ba`` call, the states as dicts of
    numpy arrays."""
    import jax

    import structure_plp_slam_tpu.models.mapper as jmapper
    from structure_plp_slam_tpu.config import Config as JConfig
    from structure_plp_slam_tpu.ops.orb import OrbParams as JOrb
    from structure_plp_slam_tpu.system import System as JSystem
    from tests import test_torch_mono as TM

    calls = []
    fn = jmapper.local_ba

    def record(camera, state, *a, **k):
        out = fn(camera, state, *a, **k)
        calls.append((camera, state, a, k, out[0]))
        return out

    js = JSystem(JConfig(camera=TM.JCAM, orb=JOrb(max_num_keypts=600, num_levels=4), raw={}),
                 **TM.SIZES)
    jmapper.local_ba = record
    try:
        js.startup()
        for img, _, ts in TM._frames()[0]:
            js.feed_monocular_frame(img, ts)
            if calls:
                break
        js.shutdown()
    finally:
        jmapper.local_ba = fn
    camera, state, a, k, out = calls[0]

    def host(st):
        return {f: np.asarray(v) for f, v in jax.tree.map(np.asarray, st)._asdict().items()}

    return camera, host(state), tuple(np.asarray(x) for x in a), k, host(out)


def _computations(text: str) -> dict:
    comps, cur = {}, None
    for line in text.splitlines():
        if line and not line.startswith(" ") and line.rstrip().endswith("{"):
            cur = re.match(r"(?:ENTRY )?%?([\w.\-]+)", line).group(1)
            comps[cur] = []
        elif cur is not None:
            comps[cur].append(line)
    return comps


def list_fused_multiply_adds(dump_dir: Path, module: str = "jit_local_ba") -> None:
    """For the BA's Gauss-Newton loop body (the while body that factors the
    camera system) in the first dumped program named ``module`` (the init's
    ``jit_local_ba``, the chain's ``jit__kf_chain``) that has one, print
    each kernel and the fused multiply-adds of its object file."""
    hlos = sorted(dump_dir.glob(f"*{module}.cpu_after_optimizations.txt"))
    hlo = next(h for h in hlos if "lapack_spotrf" in h.read_text())
    prefix = hlo.name.split(".cpu_after")[0]
    comps = _computations(hlo.read_text())
    bodies = []
    for lines in comps.values():
        for line in lines:
            m = re.search(r"while\(.*body=%([\w.\-]+)", line)
            if m and any("lapack_spotrf" in ln for ln in comps[m.group(1)]):
                bodies.append(m.group(1))
    symbols = {}
    for o in sorted(dump_dir.glob(f"{prefix}.obj-file.*.o")):
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
            obj = symbols.get(m.group(1))
            if obj is None:
                print(f"  {m.group(1)}: no object file (a library call, or a kernel shared "
                      "with an identical fusion)")
                continue
            asm = subprocess.run(["objdump", "-d", "--no-show-raw-insn", str(obj)],
                                 capture_output=True, text=True).stdout
            fmas = [ln.split("\t")[-1].strip() for ln in asm.splitlines()
                    if re.search(r"\tvfn?m(add|sub)\d{3}[sp]s", ln)]
            print(f"  {m.group(1)}: {len(fmas)} fused multiply-adds")
            for f in fmas[:12]:
                print(f"      {f}")


def main(argv=None) -> None:
    import argparse
    import platform

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", type=Path, help="dump the JAX init BA's kernels here and list them")
    a = ap.parse_args(argv)
    if a.dump is not None:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + f" --xla_dump_to={a.dump} --xla_dump_hlo_as_text")
    import jax
    import jaxlib

    jax.config.update("jax_platforms", "cpu")
    if a.dump is not None:
        init_ba_call()
        list_fused_multiply_adds(a.dump)
    print(f"# jaxlib {jaxlib.__version__}, {platform.machine()} {platform.processor()}, "
          f"{os.cpu_count()} CPUs")
    for shape, block in measure().items():
        print(f"    {shape}: {block},")


if __name__ == "__main__":
    main()
