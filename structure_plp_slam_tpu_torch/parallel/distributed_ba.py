"""Landmark-sharded Schur-complement bundle adjustment.

Port of structure_plp_slam_tpu/parallel/distributed_ba.py (the reference
has no distributed backend; the JAX package adds this one). The
partition follows BA's sparsity:

* landmark blocks (Hll, W, bl) are sharded over the landmark axis: each
  shard owns a disjoint set of landmarks (block-cyclic: landmark m on
  shard m % n) and all the observations of those landmarks;
* each shard forms its part of the reduced camera system
  S = Hcc - sum_m W_m Hll_m^-1 W_m^T from the co-observation pairs of its
  landmarks (a landmark's pairs never cross shards, so no halo exchange),
  and the parts are summed once per iteration;
* the small camera system is solved on every shard's device, and each
  shard back-substitutes its own landmarks.

The JAX package runs the shard body under ``shard_map`` on a one-process
``Mesh(devices, ("lm",))`` and sums with ``jax.lax.psum``: one Python
program drives every shard. The port keeps that model: a
:class:`LandmarkMesh` holds one ``torch.device`` per shard, this process
runs the shard bodies in turn, and :meth:`LandmarkMesh.psum` sums their
parts. Work on replicated values (the camera solve, the CG recurrence,
the chain preconditioner) runs once per distinct device of the mesh:
shards that share a device hold the same replicated values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from structure_plp_slam_tpu_torch.models import global_ba as gba
from structure_plp_slam_tpu_torch.models import pose_graph as pg


class LandmarkMesh:
    """The landmark axis ``lm`` of the JAX package's mesh: one
    ``torch.device`` per shard. Several shards may share a device:
    ``LandmarkMesh(["cpu"] * 8)`` stands in for the JAX tests' 8 virtual
    CPU devices, ``LandmarkMesh(["cuda:0"] * 4)`` puts four shards on one
    card, and a System with several visible cards builds one shard per
    card."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a LandmarkMesh needs at least one device")

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    def psum(self, parts):
        """``jax.lax.psum`` over the shards: the shards' partial tensors
        summed in shard order on the first shard's device (plain ``.to()``
        and ``+``), and the sum put on each shard's device. Returns one
        tensor per shard (the same tensor for shards on one device)."""
        total = parts[0]
        for part in parts[1:]:
            total = total + part.to(total.device)
        return [total.to(d) for d in self.devices]

    def split(self, flat):
        """A flat sharded array ``[n_shards * S, ...]`` as its ``n_shards``
        parts, part i on shard i's device."""
        parts = flat.reshape(self.n_shards, -1, *flat.shape[1:]).unbind(0)
        return [p.to(d) for p, d in zip(parts, self.devices)]

    def replicate(self, t):
        """A replicated value on every shard's device."""
        return [t.to(d) for d in self.devices]

    def replicated(self, fn, *per_shard):
        """``fn`` on each shard's copy of replicated values (``per_shard``:
        lists indexed by shard), run once per distinct device; returns the
        result per shard."""
        done, out = {}, []
        for i, d in enumerate(self.devices):
            if d not in done:
                done[d] = fn(*(a[i] for a in per_shard))
            out.append(done[d])
        return out


class ShardedBAProblem(NamedTuple):
    """The sharded arrays of a BA problem. Landmark arrays have a leading
    dimension of ``n_shards * M_shard``, observation arrays of
    ``n_shards * O_shard`` and pair arrays of ``n_shards * P_shard``
    (shard i's part is the i-th block); camera arrays are replicated.
    ``obs_lm`` indexes the shard's own landmarks, ``pair_o1`` / ``pair_o2``
    the shard's own observations."""

    cam_pose: torch.Tensor
    cam_fixed: torch.Tensor
    cam_valid: torch.Tensor
    lm_pos: torch.Tensor
    lm_valid: torch.Tensor
    obs_cam: torch.Tensor
    obs_lm: torch.Tensor
    obs_uv: torch.Tensor
    obs_xr: torch.Tensor
    obs_inv_sigma_sq: torch.Tensor
    obs_valid: torch.Tensor
    pair_o1: torch.Tensor
    pair_o2: torch.Tensor
    pair_valid: torch.Tensor


def shard_problem(prob, n_shards: int, return_map: bool = False, device=None):
    """Partition a BAProblem by landmark id (block-cyclic), as the JAX
    package does on the host. Observations move to the shard that owns
    their landmark; landmark and observation arrays are padded to equal
    sizes per shard. The arrays go to ``device`` (by default the
    problem's). ``return_map``: also return the ``[O, 2]`` (shard, slot)
    of every original observation (numpy, for :func:`shard_chain_pairs`).

    Only the valid observations are paired. The JAX package pairs every
    observation slot, those with ``obs_valid`` False too: those pairs add
    exact zeros to the camera system, but a padded problem's pad rows all
    name landmark 0 and so form one group of (pads)^2 pairs (ROADMAP C43:
    the 16,392 pads of the K = 1024 chain map make 2.7e8 pairs). The pair
    arrays here are the JAX package's with the dead rows' pairs left out,
    in the same order, and the solve is the same.

    The observation arrays are read to the host and partitioned in numpy;
    the landmark arrays are permuted by an index copy on the device, so a
    map on the card is not read back."""
    dev = prob.cam_pose.device if device is None else torch.device(device)
    M = int(prob.lm_pos.shape[0])
    O = int(prob.obs_cam.shape[0])
    M_shard = -(-M // n_shards)
    owner = np.arange(M) % n_shards
    local_id = np.arange(M) // n_shards
    flat_lm = torch.from_numpy(owner * M_shard + local_id).to(dev)
    lm_pos = torch.zeros((n_shards * M_shard, 3), dtype=prob.lm_pos.dtype, device=dev)
    lm_pos[flat_lm] = prob.lm_pos.to(dev)
    lm_valid = torch.zeros((n_shards * M_shard,), dtype=torch.bool, device=dev)
    lm_valid[flat_lm] = prob.lm_valid.to(dev)

    def host(t):
        return t.detach().cpu().numpy()

    obs_lm = host(prob.obs_lm)
    obs_owner = owner[obs_lm]
    counts = np.bincount(obs_owner, minlength=n_shards)
    O_shard = max(1, int(counts.max()))

    def alloc(shape_tail, dtype, fill=0):
        return np.full((n_shards, O_shard) + shape_tail, fill, dtype)

    s_cam = alloc((), np.int32)
    s_lm = alloc((), np.int32)
    s_uv = alloc((2,), np.float32)
    s_xr = alloc((), np.float32, -1.0)
    s_info = alloc((), np.float32)
    s_valid = alloc((), bool, False)

    # Each observation's slot is its rank within its owner shard (a
    # stable sort by owner).
    order_o = np.argsort(obs_owner, kind="stable")
    sh_of = obs_owner[order_o]
    first = np.searchsorted(sh_of, np.arange(n_shards))
    slot = np.arange(O) - first[sh_of]
    src = order_o
    s_cam[sh_of, slot] = host(prob.obs_cam)[src]
    s_lm[sh_of, slot] = local_id[obs_lm[src]]
    s_uv[sh_of, slot] = host(prob.obs_uv)[src]
    s_xr[sh_of, slot] = host(prob.obs_xr)[src]
    s_info[sh_of, slot] = host(prob.obs_inv_sigma_sq)[src]
    s_valid[sh_of, slot] = host(prob.obs_valid)[src]

    # Co-observation pairs: group the valid slots by (shard, local
    # landmark), then expand each group into its |g|^2 pairs. ``s_lm``
    # stays int32, as the JAX package's, so the grouping key (and the pair
    # order) is the same.
    sh_all, slot_all = np.nonzero(s_valid)
    key = sh_all.astype(np.int64) * (np.max(s_lm) + 2) + s_lm[sh_all, slot_all]
    order_p = np.argsort(key, kind="stable")
    key_s = key[order_p]
    sh_p = sh_all[order_p]
    slot_p = slot_all[order_p]
    change = np.r_[True, key_s[1:] != key_s[:-1]]
    gid = np.cumsum(change) - 1
    sizes = np.bincount(gid)
    off = np.concatenate([[0], np.cumsum(sizes)])
    counts_m = sizes[gid]
    p1_flat = np.repeat(slot_p, counts_m)
    p1_shard = np.repeat(sh_p, counts_m)
    cum = np.cumsum(counts_m)
    pos = np.arange(int(counts_m.sum())) - np.repeat(cum - counts_m, counts_m)
    p2_flat = slot_p[np.repeat(off[gid], counts_m) + pos]
    counts_p = np.bincount(p1_shard, minlength=n_shards)
    P_shard = max(1, int(counts_p.max()) if len(counts_p) else 1)
    s_p1 = np.zeros((n_shards, P_shard), np.int32)
    s_p2 = np.zeros((n_shards, P_shard), np.int32)
    s_pv = np.zeros((n_shards, P_shard), bool)
    order_ps = np.argsort(p1_shard, kind="stable")
    psh = p1_shard[order_ps]
    first_p = np.searchsorted(psh, np.arange(n_shards))
    pslot = np.arange(len(psh)) - first_p[psh]
    s_p1[psh, pslot] = p1_flat[order_ps]
    s_p2[psh, pslot] = p2_flat[order_ps]
    s_pv[psh, pslot] = True

    def dev_flat(a, *tail):
        a = a.reshape(-1, *tail)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a).to(dev)

    sp = ShardedBAProblem(
        cam_pose=prob.cam_pose.to(dev), cam_fixed=prob.cam_fixed.to(dev),
        cam_valid=prob.cam_valid.to(dev), lm_pos=lm_pos, lm_valid=lm_valid,
        obs_cam=dev_flat(s_cam), obs_lm=dev_flat(s_lm), obs_uv=dev_flat(s_uv, 2),
        obs_xr=dev_flat(s_xr), obs_inv_sigma_sq=dev_flat(s_info), obs_valid=dev_flat(s_valid),
        pair_o1=dev_flat(s_p1), pair_o2=dev_flat(s_p2), pair_valid=dev_flat(s_pv),
    )
    if not return_map:
        return sp
    obs_map = np.zeros((O, 2), np.int64)
    obs_map[src, 0] = sh_of
    obs_map[src, 1] = slot
    return sp, obs_map


class _Shard(NamedTuple):
    """One shard's arrays on its device: the replicated camera arrays, its
    landmarks' validity, its observations and pairs as the single-device
    solver's ``GlobalBAData``, which observations are live and which
    pairs are real."""

    cam_pose: torch.Tensor
    free: torch.Tensor
    lm_valid: torch.Tensor
    data: gba.GlobalBAData
    live: torch.Tensor
    pair_valid: torch.Tensor


def _shards(mesh: LandmarkMesh, sp: ShardedBAProblem):
    n = mesh.n_shards
    cols = {f: mesh.split(getattr(sp, f)) for f in (
        "lm_valid", "obs_cam", "obs_lm", "obs_uv", "obs_xr", "obs_inv_sigma_sq", "obs_valid",
        "pair_o1", "pair_o2", "pair_valid")}
    out = []
    for i, d in enumerate(mesh.devices):
        c = {f: v[i] for f, v in cols.items()}
        cam_valid = sp.cam_valid.to(d)
        data = gba.GlobalBAData(
            obs_cam=c["obs_cam"], obs_lm=c["obs_lm"], obs_uv=c["obs_uv"], obs_xr=c["obs_xr"],
            obs_info=c["obs_inv_sigma_sq"], pair_o1=c["pair_o1"], pair_o2=c["pair_o2"],
            num_obs=sp.obs_cam.shape[0] // n, num_pairs=sp.pair_o1.shape[0] // n)
        live = c["obs_valid"] & cam_valid[data.obs_cam] & c["lm_valid"][data.obs_lm]
        out.append(_Shard(cam_pose=sp.cam_pose.to(d), free=(~sp.cam_fixed.to(d)) & cam_valid,
                          lm_valid=c["lm_valid"], data=data, live=live,
                          pair_valid=c["pair_valid"]))
    return out


def _solve_sharded(mesh, camera, sp, num_iters, damping, camera_step):
    """The Gauss-Newton loop both mesh solvers share. Per iteration each
    shard linearizes its observations (the single-device solver's
    ``_normal_blocks``), ``camera_step(shards, blocks)`` returns the
    camera step per shard, and each shard back-substitutes and applies
    it (``global_ba._step``; a non-finite step is dropped per shard, as
    in the JAX shard body). Returns the replicated poses (shard 0's, on
    the first device) and the flat sharded landmarks."""
    shards = _shards(mesh, sp)
    cam = [s.cam_pose for s in shards]
    lm = mesh.split(sp.lm_pos)
    for _ in range(num_iters):
        blocks = [gba._normal_blocks(camera, cam[i], lm[i], s.data, damping, live=s.live)
                  for i, s in enumerate(shards)]
        dx_c = camera_step(shards, blocks)
        for i, (s, (U_o, _, _, Hll_inv, bl)) in enumerate(zip(shards, blocks)):
            cam[i], lm[i] = gba._step(cam[i], lm[i], s.lm_valid, s.free, s.data, U_o, Hll_inv,
                                      bl, dx_c[i])
    dev0 = mesh.devices[0]
    cam_pose = gba._finish(cam[0], shards[0].cam_pose, shards[0].free)
    return cam_pose, torch.cat([x.to(dev0) for x in lm])


def make_distributed_ba(mesh: LandmarkMesh, camera, *, num_iters: int = 10,
                        damping: float = 1e-4):
    """The landmark-sharded BA with the dense reduced camera system.
    Returns ``run(sp) -> (cam_pose, lm_pos)``: the replicated poses and
    the flat sharded landmarks, both on the mesh's first device."""

    def camera_step(shards, blocks):
        C = shards[0].cam_pose.shape[0]
        Hcc, S_red, rhs = [], [], []
        for s, (U_o, Hcc_s, bc, Hll_inv, bl) in zip(shards, blocks):
            red, _ = gba._schur_reduction(s.data, U_o, Hll_inv, bl, C)
            Hcc.append(Hcc_s)
            S_red.append(gba._pair_blocks(s.data, U_o, Hll_inv, C, s.pair_valid))
            rhs.append(bc - red)
        # The one reduction of the iteration: the camera system.
        return mesh.replicated(
            lambda S, H, r, free: gba._camera_solve(S, H, r, free, damping),
            mesh.psum(S_red), mesh.psum(Hcc), mesh.psum(rhs), [s.free for s in shards])

    def run(sp: ShardedBAProblem):
        return _solve_sharded(mesh, camera, sp, num_iters, damping, camera_step)

    return run


def shard_chain_pairs(c1, c2, obs_owner_map, n_shards: int, chain_pos, device="cpu"):
    """Map the global chain-pair observation indices
    (``global_ba.prepare_chain_pairs``) and their chain positions
    (``global_ba.chain_positions``, where the single-device ``solve_pcg``
    puts each pair's block; the JAX package gives the pair's index in the
    list there, ROADMAP C42) into the sharded layout. ``obs_owner_map``:
    ``[O, 2]`` (shard, slot) of every global observation
    (:func:`shard_problem` with ``return_map=True``). Both members of a
    chain pair observe one landmark, so they live on one shard. Returns
    ``(o1, o2, cpos)``: flat ``[n_shards * P_shard]`` local slots and
    chain positions, -1 padded, on ``device``."""
    c1 = np.asarray(c1)
    c2 = np.asarray(c2)
    live = c1 >= 0
    c1l, c2l = c1[live], c2[live]
    pos = np.asarray(chain_pos)[live]
    sh = obs_owner_map[c1l, 0]
    s1 = obs_owner_map[c1l, 1]
    s2 = obs_owner_map[c2l, 1]
    counts = (np.bincount(sh, minlength=n_shards) if len(sh)
              else np.zeros((n_shards,), np.int64))
    P_shard = 1 << max(8, int(max(counts.max() if len(counts) else 1, 1) - 1).bit_length())
    o1 = np.full((n_shards, P_shard), -1, np.int64)
    o2 = np.full((n_shards, P_shard), -1, np.int64)
    cpos = np.full((n_shards, P_shard), -1, np.int64)
    order = np.argsort(sh, kind="stable")
    shs = sh[order]
    first = np.searchsorted(shs, np.arange(n_shards))
    slot = np.arange(len(shs)) - first[shs]
    o1[shs, slot] = s1[order]
    o2[shs, slot] = s2[order]
    cpos[shs, slot] = pos[order]
    return tuple(torch.from_numpy(a.reshape(-1)).to(device) for a in (o1, o2, cpos))


def make_distributed_ba_pcg(mesh: LandmarkMesh, camera, *, num_iters: int = 10,
                            cg_iters: int = 40, damping: float = 1e-4):
    """The landmark-sharded BA with a matrix-free Schur solve, the mesh
    route past K = 512. The reduced camera system is never formed: each
    CG iteration's Schur product sums one ``[K, 6]`` part per shard, and
    the block-tridiagonal chain preconditioner (``pose_graph``'s block
    cyclic reduction) is factored on every device from the summed block
    diagonal and chain blocks. The CG state is replicated; every device
    runs the same scalar recurrence (``pose_graph.cg_step``). Each chain
    block is summed at its chain position ``chain_pos``
    (:func:`shard_chain_pairs`), as in the single-device ``solve_pcg``, so
    the preconditioner is that solve's. Returns
    ``run(sp, chain_o1, chain_o2, chain_pos, comp_idx, comp_ok)``."""

    def run(sp: ShardedBAProblem, chain_o1, chain_o2, chain_pos, comp_idx, comp_ok):
        K = sp.cam_pose.shape[0]
        chain = list(zip(*(mesh.split(a) for a in (chain_o1, chain_o2, chain_pos))))
        comp = list(zip(mesh.replicate(comp_idx), mesh.replicate(comp_ok)))

        def camera_step(shards, blocks):
            eye6 = [torch.eye(6, dtype=torch.float32, device=d) for d in mesh.devices]
            free_f = [s.free.to(torch.float32) for s in shards]
            red, UHinv, selfS, C_t = [], [], [], []
            for s, f, (U_o, _, _, Hll_inv, bl), (o1, o2, cpos) in zip(shards, free_f, blocks,
                                                                       chain):
                r, UH = gba._schur_reduction(s.data, U_o, Hll_inv, bl, K)
                red.append(r)
                UHinv.append(UH)
                selfS.append(gba._self_blocks(s.data, U_o, UH, K))
                C_t.append(gba._chain_blocks(s.data, U_o, UH, f, o1, o2, cpos, K))
            Hcc_d = mesh.replicated(lambda H: gba._damped(H, damping),
                                    mesh.psum([b[1] for b in blocks]))
            rhs = mesh.replicated(lambda b, r, f: (b - r) * f[:, None],
                                  mesh.psum([b[2] for b in blocks]), mesh.psum(red), free_f)
            precond = mesh.replicated(
                lambda H, S, C, s, cm, e: pg._chain_preconditioner(
                    torch.where(s.free[:, None, None], H - S, e), C, *cm),
                Hcc_d, mesh.psum(selfS), mesh.psum(C_t), shards, comp, eye6)

            def matvec(x):
                parts = [gba._offdiag_product(s.data, b[0], UH, xi * f[:, None],
                                              s.lm_valid.shape[0], K)
                         for s, b, UH, xi, f in zip(shards, blocks, UHinv, x, free_f)]
                # The one reduction of each CG iteration: [K, 6].
                return mesh.replicated(
                    lambda xx, off, H, s: gba._apply_reduced(H, xx, off, s.free),
                    x, mesh.psum(parts), Hcc_d, shards)

            cg = mesh.replicated(pg.cg_start, precond, rhs)
            for _ in range(cg_iters):
                Hp = matvec([c[2] for c in cg])
                cg = mesh.replicated(lambda c, h, pre: pg.cg_step(*c, h, pre), cg, Hp, precond)
            return [c[0] for c in cg]

        return _solve_sharded(mesh, camera, sp, num_iters, damping, camera_step)

    return run

