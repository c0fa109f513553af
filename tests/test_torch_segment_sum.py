"""The fixed-order segment sum (``utils/types.segment_sum``) and the
solvers that sum through it.

On the CPU the helper is ``index_add_``; on the card it sums each bin's
rows in one fixed order (a sorted gather and ``torch.segment_reduce``, or
a reshape for a dense camera grid), so one input gives one result on
every run (ROADMAP C20). Its card body runs here on CPU tensors with the
route patched (``types._index_add_route``):

* it equals a plain per-bin loop that adds each bin's rows in row order,
  bit for bit (empty bins, one bin, repeated ids, an overflow bin sliced
  off, left-out zero rows, a base), and never calls ``index_add_``;
* on the CPU the helper equals ``index_add_`` bit for bit;
* a plan reused for two value tensors gives what a fresh plan gives;
* every solver's card body stays within the tolerances of its own parity
  test against the JAX package (the pose graph's, the global BA's and the
  landmark statistics' tests run with the card route; the local BA, with
  and without lines, and the line refinement on synthetic windows and
  maps).

A source scan holds every scatter-add of the port inside the helper or on
an allowlist of sites whose sums are the same in any order.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.data import map_state as jms
from structure_plp_slam_tpu.models import bundle_adjustment as jba
from structure_plp_slam_tpu.models import line_ba as jline_ba
from structure_plp_slam_tpu.ops import line_geometry as jlg
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import line_ba as tline_ba
from structure_plp_slam_tpu_torch.utils import types
from tests import test_torch_distributed_ba as mesh_tests
from tests import test_torch_lines as line_tests
from tests import test_torch_loop as loop_tests
from tests import test_torch_reference_copies as reference_tests
from tests import xla_chain_ba as xc
from tests.test_torch_tracker import JCAM, TCAM, state_to_torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "structure_plp_slam_tpu_torch"


@pytest.fixture
def card_route(monkeypatch):
    """``segment_sum`` / ``segment_plan`` take their card body on CPU
    tensors; returns the ``torch.segment_reduce`` calls made since."""
    calls = []
    reduce = torch.segment_reduce

    def counted(*a, **k):
        calls.append(a[0].shape)
        return reduce(*a, **k)

    monkeypatch.setattr(types, "_index_add_route", lambda t: False)
    monkeypatch.setattr(torch, "segment_reduce", counted)
    return calls


def _per_bin_loop(ids, vals, n, keep=None, base=None):
    """Each bin's rows added one after another in row order, from zero;
    rows where ``keep`` is False left out; ``base`` added last."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype)
    for b in range(n):
        acc = torch.zeros(tuple(vals.shape[1:]), dtype=vals.dtype)
        for i in np.flatnonzero(ids.numpy() == b):
            if keep is None or bool(keep[i]):
                acc = acc + vals[i]
        out[b] = acc
    return out if base is None else base + out


def _case(name):
    """(ids, vals, n, keep, sliced n) of one bin layout."""
    rng = np.random.default_rng(7)
    keep = None
    if name == "empty_bins":     # most bins empty, a few crowded
        ids = rng.integers(0, 12, 400) * 5
        n, tail = 64, (3, 3)
    elif name == "one_bin":
        ids = np.zeros(300, np.int64)
        n, tail = 1, (6,)
    elif name == "repeated":     # long runs of one id, then others
        ids = np.concatenate([np.full(200, 3), rng.integers(0, 8, 200), np.full(50, 3)])
        n, tail = 8, ()
    elif name == "overflow":     # dead rows in an extra bin n, sliced off
        ids = rng.integers(0, 20, 500)
        ids[rng.random(500) < 0.3] = 20
        n, tail = 21, (2, 4)
    elif name == "left_out":     # zero rows the plan leaves out
        ids = rng.integers(0, 30, 500)
        keep = torch.from_numpy(rng.random(500) < 0.6)
        n, tail = 30, (6, 3)
    else:
        raise KeyError(name)
    ids = torch.from_numpy(ids.astype(np.int64))
    vals = torch.from_numpy((rng.standard_normal((ids.shape[0],) + tail) * 10.0
                             ** rng.integers(-3, 4, (ids.shape[0],) + tail)).astype(np.float32))
    if keep is not None:
        vals = torch.where(keep.reshape((-1,) + (1,) * len(tail)), vals, 0.0)
    return ids, vals, n, keep, (n - 1 if name == "overflow" else n)


CASES = ["empty_bins", "one_bin", "repeated", "overflow", "left_out"]


@pytest.mark.parametrize("name", CASES)
def test_card_body_equals_per_bin_loop(name, card_route, monkeypatch):
    ids, vals, n, keep, cut = _case(name)

    def no_index_add(*a, **k):
        raise AssertionError("the card body called index_add_")

    monkeypatch.setattr(torch.Tensor, "index_add_", no_index_add)
    want = _per_bin_loop(ids, vals, n, keep)[:cut]
    plan = types.segment_plan(ids, n, keep=keep)
    assert plan is not None and plan.grid == 0
    got = types.segment_sum(ids, vals, n, plan=plan)[:cut]
    assert torch.equal(got, want)
    base = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (n,) + tuple(vals.shape[1:])).astype(np.float32))
    got_b = types.segment_sum(ids, vals, n, plan=plan, base=base)
    assert torch.equal(got_b, _per_bin_loop(ids, vals, n, keep, base=base))
    if keep is None:  # without a plan the helper builds the same one
        assert torch.equal(types.segment_sum(ids, vals, n)[:cut], want)
    assert len(card_route) >= 2


@pytest.mark.parametrize("name", CASES)
def test_cpu_route_is_index_add(name):
    ids, vals, n, _, _ = _case(name)
    assert types.segment_plan(ids, n) is None
    want = torch.zeros((n,) + tuple(vals.shape[1:])).index_add_(0, ids, vals)
    assert torch.equal(types.segment_sum(ids, vals, n), want)
    base = torch.randn((n,) + tuple(vals.shape[1:]))
    assert torch.equal(types.segment_sum(ids, vals, n, base=base),
                       base.index_add(0, ids, vals))


def test_plan_reused_over_values(card_route):
    ids, vals, n, keep, _ = _case("left_out")
    plan = types.segment_plan(ids, n, keep=keep)
    other = torch.where(keep[:, None, None], torch.randn_like(vals), 0.0)
    for v in (vals, other, vals):
        assert torch.equal(types.segment_sum(ids, v, n, plan=plan),
                           types.segment_sum(ids, v, n, plan=types.segment_plan(ids, n, keep=keep)))


def test_grid_plan(card_route):
    """A dense [n, O / n] id grid is summed by a reshape: the bins' sums of
    the same rows, in torch.sum's order."""
    n, r = 32, 40
    ids = torch.arange(n).repeat_interleave(r)
    vals = torch.randn(n * r, 6, 6)
    plan = types.segment_plan(ids, n, grid=True)
    assert plan.grid == r and plan.perm is None
    got = types.segment_sum(ids, vals, n, plan=plan)
    assert torch.equal(got, vals.reshape(n, r, 6, 6).sum(1))
    np.testing.assert_allclose(got.numpy(), _per_bin_loop(ids, vals, n).numpy(),
                               rtol=1e-5, atol=1e-5)


def _mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("lm",))


def _line_scene(rng, poses, n_lines):
    """``n_lines`` 3D segments 5-8 m ahead of cameras ``poses [C, 3, 4]``
    (world->camera): their endpoints with 2 cm of noise, and each camera's
    observed segments (the true endpoints projected with 0.5 px of noise;
    valid where both land in the image)."""
    fx, fy, cx, cy = TCAM.fx, TCAM.fy, TCAM.cx, TCAM.cy
    p1 = np.stack([rng.uniform(-1.5, 1.5, n_lines), rng.uniform(-1.0, 1.0, n_lines),
                   rng.uniform(5.0, 8.0, n_lines)], 1)
    d = rng.normal(size=(n_lines, 3))
    p2 = p1 + rng.uniform(0.8, 1.5, (n_lines, 1)) * d / np.linalg.norm(d, axis=1, keepdims=True)
    noisy = np.concatenate([p1, p2], 1) + rng.normal(0, 0.02, (n_lines, 6))
    segs, ok = [], []
    for P in poses:
        uv = []
        for p in (p1, p2):
            pc = p @ P[:, :3].T + P[:, 3]
            uv.append(np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1)
                      + rng.normal(0, 0.5, (n_lines, 2)))
        seg = np.concatenate(uv, 1)
        segs.append(seg)
        ok.append((seg[:, 0::2] > 0).all(1) & (seg[:, 0::2] < TCAM.cols).all(1)
                  & (seg[:, 1::2] > 0).all(1) & (seg[:, 1::2] < TCAM.rows).all(1))
    return noisy.astype(np.float32), np.stack(segs).astype(np.float32), np.stack(ok)


def _pluck(eps):
    """Plücker [m, d] of endpoint pairs ``[n, 6]`` (d unit), in f32."""
    d = eps[:, 3:] - eps[:, :3]
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([np.cross(eps[:, :3], d), d], 1).astype(np.float32)


def _ba_window(rng, stereo_share, C=8, M=256, extra=32):
    """A local BA window in the chain's ``[C, O/C]`` layout (``BAProblem``'s
    fields as numpy): C cameras 0.4 m apart along x, each observing all M
    landmarks 4-7 m ahead with 1 px of noise (3% of rows 30 px outliers),
    ``extra / 2`` of them a second time and ``extra / 2`` dead rows (landmark
    0, not valid) at the end of its row; 1 cm of noise on the poses, 2 cm on
    the points; the first camera and the last two fixed. A share
    ``stereo_share`` of the rows carries a stereo coordinate (RGB-D)."""
    X = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1.0, 1.0, M),
                  rng.uniform(4.0, 7.0, M)], 1)
    Ng = M + extra
    P = np.zeros((C, 3, 4))
    obs_lm = np.zeros((C, Ng), np.int64)
    uv = np.zeros((C, Ng, 2))
    xr = np.full((C, Ng), -1.0)
    valid = np.zeros((C, Ng), bool)
    isg = np.ones((C, Ng))
    for c in range(C):
        P[c, :, :3] = np.eye(3)
        P[c, 0, 3] = 1.4 - 0.4 * c
        sel = np.concatenate([rng.permutation(M), rng.choice(M, extra // 2)])
        n = len(sel)
        pc = X[sel] + P[c, :, 3]
        u = TCAM.fx * pc[:, 0] / pc[:, 2] + TCAM.cx
        noise = rng.normal(0, 1.0, (n, 2))
        noise[rng.random(n) < 0.03] *= 30
        obs_lm[c, :n], valid[c, :n] = sel, True
        uv[c, :n] = np.stack([u, TCAM.fy * pc[:, 1] / pc[:, 2] + TCAM.cy], 1) + noise
        st = rng.random(n) < stereo_share
        xr[c, :n] = np.where(st, u - TCAM.focal_x_baseline / pc[:, 2] + rng.normal(0, 1.0, n),
                             -1.0)
        isg[c, :n] = 1.0 / 1.2 ** (2 * rng.integers(0, 4, n))
    P[:, :, 3] += rng.normal(0, 0.01, (C, 3))
    fixed = np.zeros(C, bool)
    fixed[[0, C - 2, C - 1]] = True
    return dict(cam_pose=P.astype(np.float32), cam_fixed=fixed, cam_valid=np.ones(C, bool),
                lm_pos=(X + rng.normal(0, 0.02, X.shape)).astype(np.float32),
                lm_valid=np.ones(M, bool), obs_cam=np.repeat(np.arange(C), Ng),
                obs_lm=obs_lm.reshape(-1), obs_uv=uv.reshape(-1, 2).astype(np.float32),
                obs_xr=xr.reshape(-1).astype(np.float32),
                obs_inv_sigma_sq=isg.reshape(-1).astype(np.float32), obs_valid=valid.reshape(-1))


def _local_ba_case(stereo_share, with_lines=False):
    """``ba_solve`` (8 iterations, the cull after 4, the chain's grid
    layout) on ``_ba_window`` in the JAX package and the port: poses
    within 1e-4, points within 1e-3 m, the inlier flags equal on >= 99% of
    rows (tests/test_torch_chain_ba_xla.py's card-body bounds); with
    ``with_lines`` the joint point + line window, 12 lines seen by the
    window's cameras, within the line tests' 1e-4."""
    rng = np.random.default_rng(11)
    arrays = _ba_window(rng, stereo_share)
    jcam = JCAM if stereo_share else dataclasses.replace(
        JCAM, setup=JSetup.MONOCULAR, focal_x_baseline=0.0)
    prob = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    jl = tl = None
    if with_lines:
        eps, segs, ok = _line_scene(rng, arrays["cam_pose"], 12)
        C, n = segs.shape[:2]
        U, w = jlg.plucker_to_orthonormal(jnp.asarray(_pluck(eps)))
        line = dict(ln_U=np.array(U), ln_w=np.array(w), ln_valid=ok.sum(0) >= 2,
                    lobs_cam=np.repeat(np.arange(C), n), lobs_line=np.tile(np.arange(n), C),
                    lobs_seg=segs.reshape(-1, 4), lobs_inv_sigma_sq=np.ones(C * n, np.float32),
                    lobs_valid=ok.reshape(-1))
        jl = jba.LineWindow(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                               for k, v in line.items()})
        tl = tba.LineWindow(**{k: torch.from_numpy(v) for k, v in line.items()})
    j = jba.ba_solve(jcam, xc.jax_problem(prob), jl, obs_grid=True, num_iters=8,
                     cull_at_iters=(4,))
    t = tba.ba_solve(xc.port_camera(jcam), prob, tl, obs_grid=True, num_iters=8,
                     cull_at_iters=(4,))
    np.testing.assert_allclose(t.cam_pose.numpy(), np.asarray(j.cam_pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.lm_pos.numpy(), np.asarray(j.lm_pos), rtol=0, atol=1e-3)
    assert (t.obs_inlier.numpy() == np.asarray(j.obs_inlier)).mean() >= 0.99
    assert np.abs(t.cam_pose.numpy() - arrays["cam_pose"]).max() > 1e-3  # the window moved
    if with_lines:
        for f in ("ln_U", "ln_w"):
            np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                       rtol=line_tests.MAP_TOL, atol=line_tests.MAP_TOL)


def _line_ba_case():
    """``line_ba.refine_lines`` on a synthetic map: 6 keyframes observing
    12 lines whose stored endpoints carry 2 cm of noise, the poses nudged
    by 4 mm (as tests/test_torch_lines.py's test_refine_lines); checked
    with that test's ``_assert_lines``."""
    rng = np.random.default_rng(8)
    C, n = 6, 12
    poses = np.zeros((C, 3, 4), np.float32)
    poses[:, :, :3] = np.eye(3)
    poses[:, 0, 3] = -(0.2 * np.arange(C) - 0.5)
    eps, segs, ok = _line_scene(rng, poses, n)
    poses[:, :, 3] += rng.normal(0, 0.004, (C, 3))
    st = jms.create(max_keyframes=8, max_kps=16, max_landmarks=16, max_lines_per_kf=16,
                    max_line_landmarks=32)
    ln_idx = np.full((8, 16), -1, np.int32)
    ln_idx[:C, :n] = np.where(ok, np.arange(n), -1)
    seg = np.zeros((8, 16, 4), np.float32)
    seg[:C, :n] = segs
    pad = np.zeros((32 - n, 6), np.float32)
    st = st._replace(
        kf_pose=st.kf_pose.at[:C].set(jnp.asarray(poses)),
        kf_valid=jnp.asarray(np.arange(8) < C), kf_seg=jnp.asarray(seg),
        kf_seg_valid=jnp.asarray(ln_idx >= 0), kf_line_idx=jnp.asarray(ln_idx),
        ln_pluck=jnp.asarray(np.concatenate([_pluck(eps), pad])),
        ln_endpoints=jnp.asarray(np.concatenate([eps, pad])),
        ln_valid=jnp.asarray(np.arange(32) < n), ln_ref_kf=jnp.asarray(
            np.where(np.arange(32) < n, 0, -1).astype(np.int32)))
    j = jline_ba.refine_lines(JCAM, st, num_iters=12)
    t = tline_ba.refine_lines(TCAM, state_to_torch(st), num_iters=12)
    line_tests._assert_lines(j, t)
    moved = np.abs(np.asarray(j.ln_pluck) - np.asarray(st.ln_pluck)).max(1) > 1e-6
    assert moved.sum() >= 3


# Each solver against the JAX package, run with the card's fixed-order
# sums, at the tolerances of its own parity test: the global solvers'
# tests themselves; the local BA and the line refinement on synthetic
# windows and maps (their own tests' inputs are whole Systems' maps).
SOLVERS = {
    "local_ba_mono": lambda mp: _local_ba_case(0.0),
    "local_ba_rgbd": lambda mp: _local_ba_case(0.7),
    "local_ba_line_window": lambda mp: _local_ba_case(0.7, with_lines=True),
    "landmark_stats": lambda mp: (
        reference_tests.test_windowed_refresh_partial_overlap_aggregates_all_observers()),
    "pose_graph_dense": lambda mp: loop_tests.test_pose_graph_dense_parity(),
    "pose_graph_pcg": lambda mp: loop_tests.test_pose_graph_pcg_parity(),
    "global_ba_dense": lambda mp: loop_tests.test_global_ba_dense_parity(),
    "global_ba_pcg": lambda mp: loop_tests.test_global_ba_pcg_parity(),
    "global_ba_mesh": lambda mp: loop_tests.test_global_ba_mesh_raises(),
    "global_ba_mesh_pcg": lambda mp: mesh_tests.test_pcg_mesh_matches_jax(_mesh8(), 12),
    "line_ba": lambda mp: _line_ba_case(),
}


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_solver_card_body_matches_jax(solver, card_route, monkeypatch):
    SOLVERS[solver](monkeypatch)
    assert card_route, "the solver never reached segment_sum's card body"


# ---------------------------------------------------------------------------
# The source scan.
# ---------------------------------------------------------------------------

# Calls that add into a tensor in an order the card does not fix.
ALWAYS = {"index_add_", "index_add", "scatter_add_", "scatter_add"}
WITH_ACCUMULATE = {"index_put_", "index_put", "put_", "put"}
WITH_REDUCE = {"scatter_reduce", "scatter_reduce_", "index_reduce", "index_reduce_"}
ORDER_FREE_REDUCE = {"amin", "amax"}

# (file, function): (calls, why the sum is the same in any order).
ALLOW = {
    ("models/tracker.py", "track_frame"): (
        1, "index_add_ of 0/1 floats (one per matched keypoint): exact below 2^24 in any order"),
    ("ops/lines.py", "detect_line_segments"): (
        1, "index_add_ of 0/1 floats (inlier flags): exact below 2^24 in any order"),
    ("ops/matching.py", "filter_by_rotation_histogram"): (1, "index_add_ of int64 counts"),
    ("models/planar_mapper.py", "detect_planes"): (1, "index_add_ of int64 counts"),
    ("models/mapper.py", "_line_window"): (1, "index_add_ of int64 counts"),
    ("models/line_mapper.py", "cull_lines"): (1, "index_add_ of int64 counts"),
    ("models/line_ba.py", "refine_lines"): (1, "index_add_ of int64 counts"),
    ("models/bundle_adjustment.py", "ba_solve"): (1, "index_add_ of int64 counts"),
}
HELPER = ("utils/types.py", "segment_sum")


def _arg(node, pos, name):
    if len(node.args) > pos:
        return node.args[pos]
    return next((k.value for k in node.keywords if k.arg == name), None)


def _scatter_adds(path):
    """(function, call, line) of every call in ``path`` that adds into a
    tensor (scatter_reduce / index_reduce with amin / amax excluded)."""
    found = []
    stack = []

    class Visit(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            stack.append(node.name)
            self.generic_visit(node)
            stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Call(self, node):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else None
            hit = name in ALWAYS or name == "segment_reduce"
            if name in WITH_ACCUMULATE:
                acc = _arg(node, 2, "accumulate")
                hit = not (acc is None or (isinstance(acc, ast.Constant) and not acc.value))
            if name in WITH_REDUCE:
                red = _arg(node, 3, "reduce")
                hit = not (isinstance(red, ast.Constant) and red.value in ORDER_FREE_REDUCE)
            if hit:
                found.append((".".join(stack), name, node.lineno))
            self.generic_visit(node)

    Visit().visit(ast.parse(path.read_text(), filename=str(path)))
    return found


def test_scatter_adds_are_fixed_order_or_order_free():
    seen, bad = {}, []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        for fn, call, line in _scatter_adds(path):
            key = (rel, fn)
            if key == HELPER:
                continue
            if key in ALLOW and call != "segment_reduce":
                seen[key] = seen.get(key, 0) + 1
                continue
            bad.append(f"{rel}:{line} {fn}: {call}")
    assert not bad, ("scatter-adds outside utils/types.segment_sum and the order-free "
                     f"allowlist: {bad}")
    want = {k: v[0] for k, v in ALLOW.items()}
    assert seen == want, f"allowlisted sites found {seen}, listed {want}"


def test_scan_finds_a_float_scatter(tmp_path):
    """The scan sees each form of a scatter-add."""
    src = tmp_path / "m.py"
    src.write_text(
        "def f(h, i, v, x):\n"
        "    h.index_add_(0, i, v)\n"
        "    h.index_put_((i,), v, accumulate=True)\n"
        "    h = h.index_put((i,), v, True)\n"
        "    h.index_put_((i,), v)\n"
        "    h.scatter_reduce_(0, i, v, 'sum')\n"
        "    h.scatter_reduce_(0, i, v, reduce='amax')\n"
        "    return torch.segment_reduce(x, 'sum')\n")
    assert [c for _, c, _ in _scatter_adds(src)] == [
        "index_add_", "index_put_", "index_put", "scatter_reduce_", "segment_reduce"]
