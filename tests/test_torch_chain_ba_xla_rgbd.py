"""The RGB-D and stereo keyframe chains on the CPU against XLA:CPU's (ROADMAP
C18).

The JAX RGB-D and stereo Systems compile their chain's local BA (C = 32
window cameras, M = 4096 landmark slots) into the monocular chain's kernels:
the camera's ``focal_x_baseline`` is a constant of the compile, and
``python -m tests.xla_chain_ba --dump DIR --setup rgbd|stereo`` lists the
same kernels with the same fused multiply-adds. What their windows add is
the stereo row: an RGB-D keypoint with depth, or a stereo match, observes
its landmark with a third residual ``r_xr`` (``obs_xr >= 0``), whose terms
XLA fuses onto the two-row sums. The port's System passes ``_xla="chain"``
from every chain, and on the CPU ``ops/ba_cpu`` (``csrc/ba_solve_cpu.c``)
computes those rows too. Held here on the first chain with a local BA of the
320x240 RGB-D System (``tests/xla_chain_ba.chain_call(320, setup="rgbd")``:
numpy seed 42, 16 keyframes, 4096 landmarks, every valid observation of the
window a stereo row), from the JAX System's own pre-chain state:

* the port's ``_kf_chain`` gives the JAX chain's output bit for bit: every
  map field, the next landmark slot and the observation indicator;
* every Gauss-Newton iteration of the chain's BA equals
  ``tests/xla_init_ba.ba_trace``, the stereo row's ``r_xr``, ``Jc3`` and
  ``Jl3`` included;
* a synthetic 32-camera window mixing monocular and stereo rows, with
  landmarks seen two and three times by one keyframe, equals the JAX solve
  in every iteration and in its result (an observation of weight 0 adds only
  zeros, so the C source skips it in both kinds of row);
* stereo rows are admitted under either program name, and an unknown name
  raises;
* the port's RGB-D System sends its chain's BA through the C source.

The slow case holds the 320x240 stereo System's first chain the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from structure_plp_slam_tpu_torch import system as tsys
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import mapper as tmapper
from structure_plp_slam_tpu_torch.ops import ba_cpu
from tests import xla_chain_ba as xc
from tests import xla_init_ba as xo

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _call(setup: str = "rgbd"):
    """The JAX ``setup`` System's first chain with a local BA and the port's
    camera."""
    call = xc.chain_call(320, setup=setup)
    return call, xc.port_camera(call["camera"])


@functools.lru_cache(maxsize=None)
def _trace(setup: str = "rgbd"):
    """The chain's BA window (the port's extraction) and its JAX trace."""
    call, tcam = _call(setup)
    prob = xc.chain_window(call, tcam)
    return prob, xo.ba_trace(call["camera"], xc.jax_problem(prob))


def _chain_equals_jax(setup):
    call, tcam = _call(setup)
    want = xc.map_fields(call["out"][0])
    got, next_lm, ind = xc.port_chain(call, tcam)
    apart = sorted(f for f, v in want.items() if not np.array_equal(got[f], v.astype(got[f].dtype)))
    assert not apart, apart
    assert next_lm == int(call["out"][1])
    assert np.array_equal(ind, call["out"][4])
    before = xc.map_fields(call["args"][0])
    # The chain moved the window's poses and points and refreshed statistics.
    assert not np.array_equal(got["kf_pose"], before["kf_pose"])
    assert not np.array_equal(got["lm_dist_max"], before["lm_dist_max"])


def _iterations_equal_jax(setup):
    call, tcam = _call(setup)
    prob, (final, steps) = _trace(setup)
    assert prob.cam_pose.shape[0] == 32 and prob.lm_pos.shape[0] == 4096
    stereo = (prob.obs_xr >= 0) & prob.obs_valid
    assert int(stereo.sum()) > 1000
    # The traced solve ends where the JAX chain does: the free window
    # cameras' poses in the chain's output.
    free = ((~prob.cam_fixed) & prob.cam_valid).numpy()
    assert free.sum() >= 2
    _, _, ba_cams = tmapper.local_ba(tcam, tms.from_numpy(xc.map_fields(call["ba_in"]), "cpu"),
                                     int(call["args"][1]), xc.to_torch(call["args"][12]),
                                     ind=xc.to_torch(call["out"][4]), return_cams=True)
    for c in np.flatnonzero(free):
        assert np.array_equal(final[0][c], call["out"][0]["kf_pose"][int(ba_cams[c])])
    assert xc.iterations_apart(tcam, prob, steps) is None
    res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,), _xla="chain")
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)


def test_rgbd_chain_equals_jax():
    _chain_equals_jax("rgbd")


def test_rgbd_chain_iterations_equal_jax():
    _iterations_equal_jax("rgbd")


def test_mixed_window_equals_jax():
    """A 32-camera window at the chain's shape (616 slots a row) with 70% of
    the observations stereo rows, the rest monocular, landmarks seen two and
    three times by one keyframe, every free camera stepping
    (``xla_chain_ba.synthetic_problem``)."""
    call, tcam = _call()
    arrays = xc.synthetic_problem(32, seed=2, Ng=616, width=320,
                                  focal_x_baseline=tcam.focal_x_baseline, stereo_share=0.7)
    prob = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    rows = prob.obs_valid & (prob.obs_xr >= 0)
    assert 0.6 < float(rows.sum()) / float(prob.obs_valid.sum()) < 0.75
    final, steps = xo.ba_trace(call["camera"], xc.jax_problem(prob))
    # Both kinds of row carry weight, and the cull drops some of each.
    live, rows, valid = steps["obs_live"][-1], rows.numpy(), prob.obs_valid.numpy()
    assert (live & rows).any() and (live & valid & ~rows).any()
    assert (valid & rows & ~live).any() and (valid & ~rows & ~live).any()
    assert xc.iterations_apart(tcam, prob, steps) is None
    res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,), _xla="chain")
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("program", ba_cpu.PROGRAMS)
def test_stereo_rows_admitted(program):
    """Either program name takes a window with stereo rows through the C
    iteration (``ops/ba_cpu.check`` admits them) and gives the JAX solve; an
    unknown program name raises."""
    _, tcam = _call()
    prob, (final, _) = _trace()
    calls = []
    normal = ba_cpu.normal_equations

    def count(*a, **k):
        calls.append(1)
        return normal(*a, **k)

    ba_cpu.normal_equations = count
    try:
        res = tba.ba_solve(tcam, prob, obs_grid=True, num_iters=8, cull_at_iters=(4,),
                           _xla=program)
    finally:
        ba_cpu.normal_equations = normal
    assert len(calls) == 8
    for g, w in zip(res, final):
        assert np.array_equal(g.numpy(), w)
    with pytest.raises(ValueError, match="_xla"):
        tba.ba_solve(tcam, prob, obs_grid=True, num_iters=1, _xla="loop")


def test_rgbd_chain_reaches_c_source(monkeypatch):
    """The port's RGB-D System passes ``_xla="chain"`` from its keyframe
    chain, and on the CPU the chain's BA runs the C iteration: every
    ``local_ba`` call names the chain, and each of its iterations calls
    ``ops/ba_cpu.normal_equations``."""
    from structure_plp_slam_tpu_torch.config import Config
    from structure_plp_slam_tpu_torch.ops.orb import OrbParams

    _, tcam = _call()
    frames = xc.setup_frames("rgbd", 320, 7, 3)
    programs, iterations = [], []
    local_ba = tmapper.local_ba
    normal = ba_cpu.normal_equations

    def record(*a, **k):
        programs.append(k.get("_xla"))
        return local_ba(*a, **k)

    def count(*a, **k):
        iterations.append(1)
        return normal(*a, **k)

    monkeypatch.setattr(tmapper, "local_ba", record)
    monkeypatch.setattr(ba_cpu, "normal_equations", count)
    slam = tsys.System(Config(camera=tcam, orb=OrbParams(**xc.WIDTHS[320]["orb"]), raw={}),
                       device="cpu", max_keyframes=8, max_landmarks=4096,
                       enable_loop_closing=False, max_kf_interval=1)
    slam.startup()
    for img, depth, ts in frames:
        slam.feed_RGBD_frame(img, depth, ts)
    slam.shutdown()
    assert programs and all(p == "chain" for p in programs), programs
    assert len(iterations) == 8 * len(programs)


@pytest.mark.slow
def test_stereo_chain_equals_jax():
    """The 320x240 stereo System's first chain (0.1 m baseline, a share of
    its observations monocular): its output and every iteration of its BA
    equal the JAX chain's."""
    _chain_equals_jax("stereo")
    _iterations_equal_jax("stereo")
