"""Port parity: the JAX package's public API in the port.

A walker over both packages' sources (``ast``) lists every public
function, method and property setter with its parameters and defaults,
and every public attribute a public class sets (``self.<name> = ...`` in
its methods, and dataclass / NamedTuple fields). The port must have, in
the module of the same path:

- every such function, with every parameter under the same name, the
  JAX package's positional parameters in the same order, and the same
  default value (both defaults evaluated in their own module);
- every such attribute.

The one JAX module with no module of the same path in the port is the
TPU kernel's, ``ops/pallas_matching.py``: its Hopper port is
``ops/fused_match.py``, whose kernel takes packed descriptors, not bit
planes (ROADMAP queue B). The walker skips private names (leading
underscore).

Then each parameter that changes behaviour runs at a non-default value
on the same inputs in both packages on the CPU, at small sizes, with the
tolerance of the existing parity test of that function, and one System
test sets ``loop_closer.min_gap`` and ``min_continuity`` on both Systems.
"""

import ast
import dataclasses
import enum
import functools
import importlib
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.camera import Camera as JCamera
from structure_plp_slam_tpu.camera import CameraModel as JModel
from structure_plp_slam_tpu.camera import CameraSetup as JSetup
from structure_plp_slam_tpu.data import bow as jbow
from structure_plp_slam_tpu.data import map_database as jmdb
from structure_plp_slam_tpu.data import map_state as jms
from structure_plp_slam_tpu.models import bundle_adjustment as jba
from structure_plp_slam_tpu.models import global_ba as jgba
from structure_plp_slam_tpu.models import initializer as jinit
from structure_plp_slam_tpu.models import relocalizer as jreloc
from structure_plp_slam_tpu.ops import matching as jmatching
from structure_plp_slam_tpu.ops import orb as jorb
from structure_plp_slam_tpu.ops import pnp as jpnp
from structure_plp_slam_tpu.ops import ransac as jransac
from structure_plp_slam_tpu.ops import sim3_solver as jsim3
from structure_plp_slam_tpu.ops import stereo as jstereo
from structure_plp_slam_tpu.utils import types as jtypes
from structure_plp_slam_tpu_torch.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu_torch.config import Config
from structure_plp_slam_tpu_torch.data import bow as tbow
from structure_plp_slam_tpu_torch.data import map_database as tmdb
from structure_plp_slam_tpu_torch.data import map_state as tms
from structure_plp_slam_tpu_torch.models import bundle_adjustment as tba
from structure_plp_slam_tpu_torch.models import global_ba as tgba
from structure_plp_slam_tpu_torch.models import initializer as tinit
from structure_plp_slam_tpu_torch.models import relocalizer as treloc
from structure_plp_slam_tpu_torch.ops import matching as tmatching
from structure_plp_slam_tpu_torch.ops import pnp as tpnp
from structure_plp_slam_tpu_torch.ops import ransac as transac
from structure_plp_slam_tpu_torch.ops import sim3_solver as tsim3
from structure_plp_slam_tpu_torch.ops import stereo as tstereo
from structure_plp_slam_tpu_torch.ops.orb import OrbParams
from structure_plp_slam_tpu_torch.system import StageTimer, System, TrackerState
from structure_plp_slam_tpu_torch.utils import prng
from structure_plp_slam_tpu_torch.utils import types as ttypes
from tests.test_bundle_adjustment import _make_problem
from tests.test_torch_ransac import T, _rel, _rel_up_to_sign, _views

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = "structure_plp_slam_tpu", "structure_plp_slam_tpu_torch"
NO_PORT_MODULE = {"ops/pallas_matching.py"}


# ---------------------------------------------------------------------------
# The walker.
# ---------------------------------------------------------------------------


def _signature(fn: ast.FunctionDef):
    """``[(name, default source or None, positional)]`` of a def."""
    a = fn.args
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = [(p.arg, None if d is None else ast.unparse(d), True) for p, d in zip(pos, defaults)]
    out += [(p.arg, None if d is None else ast.unparse(d), False)
            for p, d in zip(a.kwonlyargs, a.kw_defaults)]
    return out


def _is_setter(fn):
    return any(isinstance(d, ast.Attribute) and d.attr == "setter" for d in fn.decorator_list)


def _walk_module(path: pathlib.Path):
    """(functions {qualname: signature}, attributes {class: {names}})."""
    tree = ast.parse(path.read_text())
    funcs, attrs = {}, {}

    def visit(body, prefix, cls):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name.startswith("_") and node.name != "__init__":
                    continue
                name = prefix + node.name + (".setter" if _is_setter(node) else "")
                funcs[name] = _signature(node)
                if cls is not None:
                    for sub in ast.walk(node):
                        targets = (sub.targets if isinstance(sub, ast.Assign) else
                                   [sub.target] if isinstance(sub, ast.AnnAssign) else [])
                        for t in targets:
                            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                                    and t.value.id == "self" and not t.attr.startswith("_")):
                                attrs.setdefault(cls, set()).add(t.attr)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                for b in node.body:
                    if (isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)
                            and not b.target.id.startswith("_")):
                        attrs.setdefault(node.name, set()).add(b.target.id)
                visit(node.body, prefix + node.name + ".", node.name)

    visit(tree.body, "", None)
    return funcs, attrs


@functools.lru_cache(maxsize=1)
def _api():
    """{module path: (jax funcs, jax attrs, port funcs, port attrs)} for
    every JAX module with a port module of the same path."""
    out = {}
    for path in sorted((ROOT / JAX_PKG).rglob("*.py")):
        rel = path.relative_to(ROOT / JAX_PKG).as_posix()
        port = ROOT / PORT_PKG / rel
        if rel in NO_PORT_MODULE:
            assert not port.exists(), rel
            continue
        assert port.exists(), f"no port module {PORT_PKG}/{rel}"
        out[rel] = _walk_module(path) + _walk_module(port)
    return out


def _module(pkg, rel):
    return importlib.import_module(f"{pkg}." + rel[:-3].replace("/", ".").replace(".__init__", ""))


def _port_signature(rel, name, port_funcs):
    """The port's signature of ``name``: its own def, or (a name the port
    module imports, as ``bundle_adjustment.inv3x3``) the def it imports."""
    if name in port_funcs:
        return port_funcs[name]
    obj = getattr(_module(PORT_PKG, rel), name.split(".")[0], None)
    if obj is None or "." in name:
        return None
    src = pathlib.Path(importlib.import_module(obj.__module__).__file__)
    return _walk_module(src)[0].get(name)


def _value(expr, module):
    return eval(expr, vars(module)) if expr is not None else None  # noqa: S307


def _same_default(a, b):
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a).__name__ == type(b).__name__ and \
            dataclasses.asdict(a) == dataclasses.asdict(b)
    if isinstance(a, enum.Enum) or isinstance(b, enum.Enum):
        return getattr(a, "value", a) == getattr(b, "value", b)
    if a is None or b is None or isinstance(a, (str, tuple, list, dict)):
        return a == b
    return np.asarray(a).tolist() == np.asarray(b).tolist()


def test_every_public_function_parameter_and_default():
    missing, order, defaults = [], [], []
    for rel, (jf, _, tf, _) in _api().items():
        jmod, tmod = _module(JAX_PKG, rel), _module(PORT_PKG, rel)
        for name, jsig in jf.items():
            tsig = _port_signature(rel, name, tf)
            if tsig is None:
                missing.append(f"{rel} {name}")
                continue
            tparams = {p: (d, pos) for p, d, pos in tsig}
            for p, d, _ in jsig:
                if p not in tparams:
                    missing.append(f"{rel} {name}({p})")
                elif not _same_default(_value(d, jmod), _value(tparams[p][0], tmod)):
                    defaults.append(f"{rel} {name}({p}={d} / port {tparams[p][0]})")
            jpos = [p for p, _, pos in jsig if pos]
            tpos = [p for p, _, pos in tsig if pos]
            if tpos[:len(jpos)] != jpos:
                order.append(f"{rel} {name}: {jpos} / port {tpos}")
    assert not missing, missing
    assert not defaults, defaults
    assert not order, order


def test_every_public_attribute():
    missing = []
    for rel, (_, ja, _, ta) in _api().items():
        for cls, names in ja.items():
            gone = names - ta.get(cls, set())
            if gone:
                missing.append(f"{rel} {cls}: {sorted(gone)}")
    assert not missing, missing


def test_walker_sees_the_api():
    """The walker finds the functions, setters and attributes this slice
    added (a walker that saw nothing would pass the two tests above)."""
    api = _api()
    assert "LoopCloser.__init__" in api["models/loop_closer.py"][2]
    assert "System.tracking_state.setter" in api["system.py"][2]
    assert {"min_gap", "min_continuity", "min_inliers"} <= api["models/loop_closer.py"][3]["LoopCloser"]
    assert sum(len(v[0]) for v in api.values()) > 300


# ---------------------------------------------------------------------------
# Parameters at non-default values, against the JAX package.
# ---------------------------------------------------------------------------

_KW = dict(name="synt", cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5,
           fps=30.0, focal_x_baseline=26.0, depth_threshold=400.0, depthmap_factor=1.0)
JCAM = JCamera(setup=JSetup.RGBD, model=JModel.PERSPECTIVE, **_KW)
TCAM = Camera(setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE, **_KW)
ORB = dict(max_num_keypts=600, num_levels=4)


def N(t):
    return t.detach().cpu().numpy()


def test_essential_ransac_num_hypotheses():
    cam, K, R_gt, t_gt, uv1, uv2, b1, b2 = _views(False, 0.5, 0.2)
    valid = np.ones(len(b1), bool)
    valid[::17] = False
    kw = dict(num_hypotheses=64, inlier_thr=2e-6)
    Ej, inj, sj = jransac.essential_ransac(jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(valid),
                                           jax.random.PRNGKey(5), **kw)
    Et, int_, st = transac.essential_ransac(T(b1), T(b2), T(valid), prng.PRNGKey(5), **kw)
    assert _rel_up_to_sign(N(Et), Ej) < 1e-4
    assert (N(int_) == np.asarray(inj)).all()
    assert _rel(N(st), sj) < 1e-4
    E256, _, _ = transac.essential_ransac(T(b1), T(b2), T(valid), prng.PRNGKey(5))
    assert not torch.equal(E256, Et)  # the parameter reaches the sampler


def test_essential_ransac_coherent_knobs():
    """tests/test_torch_ransac.py's input and bounds. The coherent refit's
    f32 eigh resolves its vector to about 1e-3 (that test's note), and the
    mean-field sweeps can carry such a gap onto a label: at 4 or 6
    neighbours the packages' masks differ on 0.5-1% of the matches. The
    knobs here sit where the refit is well conditioned."""
    cam, K, R_gt, t_gt, uv1, uv2, b1, b2 = _views(False, 0.5, 0.2)
    valid = np.ones(len(b1), bool)
    valid[::17] = False
    kw = dict(num_hypotheses=200, num_neighbors=12, num_sweeps=2, smoothness=1.0)
    Ej, inj, sj = jransac.essential_ransac_coherent(
        jnp.asarray(b1), jnp.asarray(b2), jnp.asarray(uv1, jnp.float32), jnp.asarray(valid),
        jax.random.PRNGKey(5), **kw)
    Et, int_, st = transac.essential_ransac_coherent(
        T(b1), T(b2), T(uv1, torch.float32), T(valid), prng.PRNGKey(5), **kw)
    # tests/test_torch_ransac.py's bounds for the coherent refit.
    assert _rel_up_to_sign(N(Et), Ej) < 5e-3
    assert (N(int_) == np.asarray(inj)).all()
    assert _rel(N(st), sj) < 1e-2


@pytest.mark.parametrize("coherent", [False, True])
def test_homography_ransac_knobs(coherent):
    cam, K, R_gt, t_gt, uv1, uv2, b1, b2 = _views(True, 0.3, 0.1)
    valid = np.ones(len(b1), bool)
    valid[::13] = False
    p1, p2 = uv1.astype(np.float32), uv2.astype(np.float32)
    kw = dict(num_hypotheses=48, inlier_thr=6.0)
    if coherent:
        kw.update(num_neighbors=6, num_sweeps=3, smoothness=3.0)
    fj = jransac.homography_ransac_coherent if coherent else jransac.homography_ransac
    ft = transac.homography_ransac_coherent if coherent else transac.homography_ransac
    Hj, inj, sj = fj(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                     jax.random.PRNGKey(9), **kw)
    Ht, int_, st = ft(T(p1), T(p2), T(valid), prng.PRNGKey(9), **kw)
    assert _rel(N(Ht), Hj) < 1e-4
    assert (N(int_) == np.asarray(inj)).all()
    assert _rel(N(st), sj) < 1e-4


def test_select_pose_min_parallax():
    cam, K, R_gt, t_gt, uv1, uv2, b1, b2 = _views(False, 0.5, 0.2)
    Ej, inj, _ = jransac.essential_ransac(jnp.asarray(b1), jnp.asarray(b2),
                                          jnp.ones(len(b1), bool), jax.random.PRNGKey(5))
    Rs, ts = jransac.decompose_essential(Ej)
    counts = []
    for deg in (1.0, 4.0):
        Rj, tj, pj, gj, cj = jransac.select_pose_by_cheirality(
            Rs, ts, jnp.asarray(b1), jnp.asarray(b2), inj, min_parallax_deg=deg)
        Rt, tt, pt, gt, ct = transac.select_pose_by_cheirality(
            T(np.asarray(Rs)), T(np.asarray(ts)), T(b1), T(b2), T(np.asarray(inj)),
            min_parallax_deg=deg)
        assert np.abs(N(Rt) - np.asarray(Rj)).max() < 1e-4
        assert (N(gt) == np.asarray(gj)).all() and int(ct) == int(cj)
        counts.append(int(ct))
    assert counts[1] < counts[0]


def _rigid_problem(rng, n=150, n_out=30):
    """tests/test_torch_loop.py's Sim3 problem with scale 1: points in
    camera 1, their rigid image in camera 2, both projected, ``n_out``
    camera-2 points moved off."""
    from structure_plp_slam_tpu_torch.ops import lie as tlie
    from tests.helpers import create_random_landmarks

    pts1 = create_random_landmarks(rng, n).astype(np.float32)
    R = N(tlie.so3_exp(T((rng.normal(size=3) * 0.1).astype(np.float32))))
    pts2 = (pts1 @ R.T + np.array([0.4, -0.2, 0.6])).astype(np.float32)

    def proj(p):
        return np.stack([JCAM.fx * p[:, 0] / p[:, 2] + JCAM.cx,
                         JCAM.fy * p[:, 1] / p[:, 2] + JCAM.cy], 1).astype(np.float32)

    uv1, uv2 = proj(pts1), proj(pts2)
    out = rng.choice(n, n_out, replace=False)
    pts2[out] += rng.normal(scale=2.0, size=(n_out, 3)).astype(np.float32)
    sig = rng.choice(np.array([1.0, 1.44, 2.0736], np.float32), (2, n))
    return pts1, pts2, uv1, uv2, sig[0], sig[1]


def test_sim3_ransac_fix_scale_and_refine_iters():
    """tests/test_torch_loop.py's bounds: counts and masks equal, R / t / s
    within 1e-4."""
    rng = np.random.default_rng(0)
    pts1, pts2, uv1, uv2, sig1, sig2 = _rigid_problem(rng)
    valid = rng.uniform(size=len(pts1)) < 0.9
    args = (pts1, pts2, uv1, uv2, sig1, sig2, valid)
    kw = dict(num_hypotheses=64, fix_scale=True)
    Rj, tj, sj, inj, nj = jsim3.sim3_ransac(JCAM, *(jnp.asarray(a) for a in args),
                                            jax.random.PRNGKey(2), **kw)
    Rt, tt, st, int_, nt = tsim3.sim3_ransac(TCAM, *(T(a) for a in args), prng.PRNGKey(2),
                                             **kw)
    assert float(st) == float(sj) == 1.0
    assert int(nt) == int(nj) > 100 and (N(int_) == np.asarray(inj)).all()
    for a, b in ((Rj, Rt), (tj, tt)):
        np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-4, rtol=1e-4)
    rj = jsim3.refine_sim3(JCAM, Rj, tj, sj, *(jnp.asarray(a) for a in args[:4]), inj,
                           num_iters=3)
    rt = tsim3.refine_sim3(TCAM, Rt, tt, st, *(T(a) for a in args[:4]), int_, num_iters=3)
    assert (N(rt[3]) == np.asarray(rj[3])).all() and int(rt[4]) == int(rj[4])
    for a, b in zip(rj[:3], rt[:3]):
        np.testing.assert_allclose(N(b), np.asarray(a), atol=1e-4, rtol=1e-4)
    # Without fix_scale the fit takes a scale off 1.
    assert float(tsim3.sim3_ransac(TCAM, *(T(a) for a in args), prng.PRNGKey(2))[2]) != 1.0


@functools.lru_cache(maxsize=1)
def _stereo_inputs():
    from tests.test_torch_stereo import ORB as SORB
    from tests.test_torch_stereo import TCAM as STCAM
    from tests.test_torch_stereo import _pairs

    left, right, _ = _pairs()[2]
    ext = jorb.OrbExtractor(240, 320, jorb.OrbParams(**SORB))
    fl, fr = ext(jnp.asarray(left)), ext(jnp.asarray(right))
    sf = np.asarray(jorb.OrbParams(**SORB).scale_factors(), np.float32)
    return STCAM, left, right, {k: np.asarray(v) for k, v in fl.items()}, \
        {k: np.asarray(v) for k, v in fr.items()}, sf


@pytest.mark.parametrize("kw", [dict(window=7, patch=3),
                                dict(min_disparity=4.0, max_hamming=40)])
def test_match_stereo_knobs(kw):
    """tests/test_torch_stereo.py's bounds: ``ok`` equal, x_right within
    1e-3 px, depth within 1e-4 relative."""
    cam, left, right, fl, fr, sf = _stereo_inputs()

    def args(conv, bits):
        return (conv(left), conv(right), conv(fl["xy"]), conv(fl["level"]), bits(fl["desc"]),
                conv(fl["valid"]), conv(fr["xy"]), conv(fr["level"]), bits(fr["desc"]),
                conv(fr["valid"]), conv(sf))

    xj, dj, okj = (np.asarray(a) for a in jstereo.match_stereo(
        *args(jnp.asarray, lambda d: jmatching.unpack_desc_bits(jnp.asarray(d))),
        focal_x_baseline=cam.focal_x_baseline, **kw))
    xt, dt, okt = (N(a) for a in tstereo.match_stereo(
        *args(T, lambda d: tmatching.unpack_desc_bits(desc_u32=T(d))),
        focal_x_baseline=cam.focal_x_baseline, **kw))
    assert (okt == okj).all() and okj.sum() > 100
    assert np.abs(xt - xj).max() < 1e-3
    assert (np.abs(dt - dj)[okj] / dj[okj]).max() < 1e-4
    _, _, ok_default = tstereo.match_stereo(
        *args(T, lambda d: tmatching.unpack_desc_bits(T(d))),
        focal_x_baseline=cam.focal_x_baseline)
    assert not np.array_equal(N(ok_default), okt) or "window" in kw


def test_pnp_ransac_num_hypotheses():
    rng = np.random.default_rng(3)
    n = 200
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)],
                   -1).astype(np.float32)
    t = np.array([0.3, -0.1, 0.2], np.float32)
    pc = pts + t
    uv = np.stack([TCAM.fx * pc[:, 0] / pc[:, 2] + TCAM.cx,
                   TCAM.fy * pc[:, 1] / pc[:, 2] + TCAM.cy], -1).astype(np.float32)
    out = rng.uniform(size=n) < 0.3
    uv[out] = rng.uniform([0, 0], [320, 240], (out.sum(), 2)).astype(np.float32)
    valid = np.ones(n, bool)
    info = np.ones(n, np.float32)
    Rj, tj, inj, nj = jpnp.pnp_ransac(JCAM, jnp.asarray(pts), jnp.asarray(uv),
                                      jnp.asarray(info), jnp.asarray(valid),
                                      jax.random.PRNGKey(4), num_hypotheses=32)
    Rt, tt, int_, nt = tpnp.pnp_ransac(TCAM, T(pts), T(uv), T(info), T(valid),
                                       prng.PRNGKey(4), num_hypotheses=32)
    assert np.abs(N(Rt) - np.asarray(Rj)).max() < 1e-4
    assert np.abs(N(tt) - np.asarray(tj)).max() < 1e-4
    assert (N(int_) == np.asarray(inj)).all() and int(nt) == int(nj) > 30


@functools.lru_cache(maxsize=1)
def _jax_map():
    """The JAX System's map after tests/test_torch_reloc.py's 8 frames and
    the JAX features of frame 4, from a System of the loop test's sizes
    (``_LOOP_SIZES``), so that that test reuses its compiled functions."""
    from tests.test_torch_loop_system import _jax_system
    from tests.test_torch_reloc import _frames

    js = _jax_system(**_LOOP_SIZES)
    js.startup()
    for img, depth, ts in _frames()[0][:8]:
        js.feed_RGBD_frame(img, depth, ts)
    js.shutdown()
    st = js.state
    arrays = {f: np.asarray(getattr(st, f)) for f in st._fields}
    img, depth, _ = _frames()[0][4]
    feats = js.frontend.rgbd(jnp.asarray(img), jnp.asarray(depth))
    return js, arrays, {k: np.asarray(v) for k, v in feats.items()}


@pytest.mark.parametrize("max_hamming", [20, 45])
def test_bow_max_hamming(max_hamming):
    _, arrays, feats = _jax_map()
    st = tms.from_numpy(arrays, "cpu")
    sj = np.asarray(jbow.BowIndex(max_hamming=max_hamming).scores(
        jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        jnp.asarray(feats["desc"]), jnp.asarray(feats["valid"])))
    bow = tbow.BowIndex(max_hamming=max_hamming)
    s = N(bow.scores(st, query_desc_u32=T(feats["desc"]), query_valid=T(feats["valid"])))
    assert (s == sj).all()
    slot = int(np.nonzero(arrays["kf_valid"])[0][-1])
    jslot = np.asarray(jbow.BowIndex(max_hamming=max_hamming).scores_for_slot(
        jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}), slot))
    assert (N(bow.scores_for_slot(st, slot)) == jslot).all()
    assert not (s == N(tbow.BowIndex().scores(st, T(feats["desc"]), T(feats["valid"])))).all()


@pytest.mark.parametrize("kw,call", [
    (dict(min_inliers=30), dict()),
    (dict(min_inliers=10_000), dict()),  # no candidate passes: None in both
    (dict(min_candidates_matches=25, min_pnp_inliers=20), dict(max_candidates=2)),
])
def test_relocalizer_thresholds(kw, call):
    js, arrays, feats = _jax_map()
    oj = jreloc.Relocalizer(JCAM, jbow.BowIndex(), **kw).relocalize(
        jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}),
        {k: jnp.asarray(v) for k, v in feats.items()}, js.frontend.inv_sigma_sq,
        jax.random.PRNGKey(11), num_levels=4, scale_factor=1.2, **call)
    reloc = treloc.Relocalizer(TCAM, tbow.BowIndex(), **kw)
    assert (reloc.min_matches, reloc.min_pnp_inliers, reloc.min_inliers) == (
        kw.get("min_candidates_matches", 20), kw.get("min_pnp_inliers", 15),
        kw.get("min_inliers", 50))
    ot = reloc.relocalize(
        tms.from_numpy(arrays, "cpu"), {k: T(v) for k, v in feats.items()},
        torch.from_numpy(np.array(js.frontend.inv_sigma_sq)), prng.PRNGKey(11),
        num_levels=4, scale_factor=1.2, **call)
    assert (oj is None) == (ot is None)
    if kw.get("min_inliers") == 10_000:
        assert ot is None
        return
    assert ot is not None
    Rj, tj, kpj, kfj = oj
    Rt, tt, kpt, kft = ot
    # tests/test_torch_reloc.py's bounds.
    assert kft == kfj
    assert np.abs(N(Rt) - np.asarray(Rj)).max() < 1e-3
    assert np.abs(N(tt) - np.asarray(tj)).max() < 1e-3
    assert (N(kpt) == np.asarray(kpj)).mean() >= 0.99


def test_relocalizer_reads_its_attributes():
    """``relocalizer.min_inliers`` set after construction takes effect, as
    in the JAX package (read at every call)."""
    js, arrays, feats = _jax_map()
    reloc = treloc.Relocalizer(TCAM, tbow.BowIndex())
    args = (tms.from_numpy(arrays, "cpu"), {k: T(v) for k, v in feats.items()},
            torch.from_numpy(np.array(js.frontend.inv_sigma_sq)), prng.PRNGKey(11))
    assert reloc.relocalize(*args, num_levels=4, scale_factor=1.2) is not None
    reloc.min_inliers = 10_000
    assert reloc.relocalize(*args, num_levels=4, scale_factor=1.2) is None


def test_grow_factor():
    sj = jms.create(max_keyframes=4, max_kps=16, max_landmarks=32, max_lines_per_kf=4,
                    max_line_landmarks=8, max_planes=2)
    arrays = {f: np.array(getattr(sj, f)) for f in sj._fields}
    rng = np.random.default_rng(2)
    arrays["lm_pos"] = rng.normal(size=arrays["lm_pos"].shape).astype(np.float32)
    arrays["kf_valid"][:3] = True
    kw = dict(grow_kf=True, grow_lm=True, grow_pl=True, factor=3)
    gj = jmdb.grow(jms.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()}), **kw)
    out = tms.to_numpy(tmdb.grow(tms.from_numpy(arrays, "cpu"), **kw))
    for name in sj._fields:
        assert (out[name] == np.asarray(getattr(gj, name))).all(), name
    assert out["kf_pose"].shape[0] == 12 and out["lm_pos"].shape[0] == 96


def test_global_ba_max_obs_per_lm():
    from tests.test_torch_loop import _ba_state

    cam, jst, tst, _, _ = _ba_state()
    table = np.array([1.0, 0.7, 0.5, 0.3, 0.2, 0.1, 0.1, 0.1], np.float32)
    dj = jgba.prepare(jst, table, max_obs_per_lm=3)
    dt = tgba.prepare(tst, table, max_obs_per_lm=3)
    assert dt.num_obs == dj.num_obs and dt.num_pairs == dj.num_pairs
    assert dt.num_pairs < tgba.prepare(tst, table).num_pairs
    for f in ("obs_cam", "obs_lm", "obs_uv", "obs_xr", "obs_info", "pair_o1", "pair_o2"):
        assert (N(getattr(dt, f)) == np.asarray(getattr(dj, f))).all(), f


def test_ba_solve_obs_grid_is_a_layout_promise():
    """``obs_grid=True`` on a dense [C, O/C] layout: the port's solve is the
    same as without it; the JAX package's (its bf16 one-hot contraction)
    within tests/test_torch_distributed_ba.py's 5e-3 / 2e-2."""
    cam, prob, _, _ = _make_problem(np.random.default_rng(1), C=4, M=64, noise=0.3)
    tcam = Camera(setup=CameraSetup(cam.setup.value), model=CameraModel(cam.model.value),
                  **{f.name: getattr(cam, f.name) for f in dataclasses.fields(Camera)
                     if f.name not in ("setup", "model")})
    tprob = tba.BAProblem(**{f: T(np.asarray(getattr(prob, f))) for f in prob._fields})
    a = tba.ba_solve(tcam, tprob, num_iters=4, cull_at_iters=(), obs_grid=True)
    b = tba.ba_solve(tcam, tprob, num_iters=4, cull_at_iters=())
    assert torch.equal(a.cam_pose, b.cam_pose) and torch.equal(a.lm_pos, b.lm_pos)
    j = jba.ba_solve(cam, prob, num_iters=4, cull_at_iters=(), obs_grid=True)
    np.testing.assert_allclose(N(a.cam_pose), np.asarray(j.cam_pose), atol=5e-3)
    np.testing.assert_allclose(N(a.lm_pos), np.asarray(j.lm_pos), atol=2e-2)


@functools.lru_cache(maxsize=1)
def _mono_pair():
    from tests.test_torch_mono import jax_feats

    return jax_feats(0), jax_feats(3)


def _to_torch(f):
    return {k: T(v) for k, v in f.items()}


def test_try_initialize_mono_min_triangulated():
    from tests.test_torch_mono import JCAM as MJCAM
    from tests.test_torch_mono import TCAM as MTCAM

    f1, f2 = _mono_pair()
    rt = tinit.try_initialize_mono(MTCAM, _to_torch(f1), _to_torch(f2), prng.PRNGKey(0))
    n = int(rt.num_points)
    assert bool(rt.success) and n > 50
    for need in (n, n + 1):
        rj = jinit.try_initialize_mono(MJCAM, f1, f2, jax.random.PRNGKey(0),
                                       min_triangulated=need)
        rt = tinit.try_initialize_mono(MTCAM, _to_torch(f1), _to_torch(f2), prng.PRNGKey(0),
                                       min_triangulated=need)
        assert bool(rt.success) == bool(rj.success) == (need == n)
        assert int(rt.num_points) == int(rj.num_points)


def test_scale_to_median_depth_target():
    rng = np.random.default_rng(4)
    pts = rng.uniform([-2, -2, 3], [2, 2, 9], (100, 3)).astype(np.float32)
    ok = rng.uniform(size=100) < 0.8
    t = np.array([0.3, 0.0, 0.1], np.float32)
    pj, tj, sj = jinit.scale_to_median_depth(jnp.asarray(pts), jnp.asarray(ok), jnp.asarray(t),
                                             target=2.5)
    pt, tt, st = tinit.scale_to_median_depth(T(pts), T(ok), T(t), target=2.5)
    np.testing.assert_array_equal(N(st), np.asarray(sj))
    np.testing.assert_array_equal(N(pt), np.asarray(pj))
    np.testing.assert_array_equal(N(tt), np.asarray(tj))


def test_match_in_area_orientation_and_bins():
    f1, f2 = _mono_pair()
    t1, t2 = _to_torch(f1), _to_torch(f2)
    kw = dict(window=100.0, max_hamming=50, ratio=0.9, check_orientation=False)
    mj = np.asarray(jmatching.match_in_area(
        f1["xy"], f1["angle"], jmatching.unpack_desc_bits(f1["desc"]), f1["valid"],
        f2["xy"], f2["angle"], jmatching.unpack_desc_bits(f2["desc"]), f2["valid"], **kw))
    mt = N(tmatching.match_in_area(
        t1["xy"], t1["angle"], tmatching.unpack_desc_bits(t1["desc"]), t1["valid"],
        t2["xy"], t2["angle"], tmatching.unpack_desc_bits(t2["desc"]), t2["valid"], **kw))
    assert (mt == mj).all()
    for bins in (1, 5):
        hj = np.asarray(jmatching.filter_by_rotation_histogram(
            jnp.asarray(mj), jnp.asarray(f1["angle"]), jnp.asarray(f2["angle"]), keep_bins=bins))
        ht = N(tmatching.filter_by_rotation_histogram(
            T(mj), t1["angle"], t2["angle"], keep_bins=bins))
        assert (ht == hj).all()
    assert (hj >= 0).sum() > (np.asarray(jmatching.filter_by_rotation_histogram(
        jnp.asarray(mj), jnp.asarray(f1["angle"]), jnp.asarray(f2["angle"]))) >= 0).sum()


def test_types_axis_and_keepdims():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 7)).astype(np.float32)
    mask = rng.uniform(size=(5, 7)) < 0.7
    for axis in (0, 1):
        ij, vj = jtypes.masked_argmin(jnp.asarray(x), jnp.asarray(mask), axis=axis)
        it, vt = ttypes.masked_argmin(T(x), T(mask), axis=axis)
        assert (N(it) == np.asarray(ij)).all() and (N(vt) == np.asarray(vj)).all()
        for keep in (False, True):
            nj = np.asarray(jtypes.safe_norm(jnp.asarray(x), axis=axis, keepdims=keep))
            nt = N(ttypes.safe_norm(T(x), axis=axis, keepdims=keep))
            assert nt.shape == nj.shape
            np.testing.assert_allclose(nt, nj, rtol=1e-6)
        np.testing.assert_allclose(N(ttypes.normalize(T(x), axis=axis)),
                                   np.asarray(jtypes.normalize(jnp.asarray(x), axis=axis)),
                                   rtol=1e-6, atol=1e-7)
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(ttypes.pad_to(a, 5, axis=1, fill=-1),
                                  jtypes.pad_to(a, 5, axis=1, fill=-1))


def test_stage_timer_sync_on_and_tracking_state_setter():
    timer = StageTimer()
    x = torch.ones(3)
    with timer.stage("a", sync_on=lambda: x):
        x = x + 1
    with timer.stage("a", sync_on=x):
        pass
    assert timer.summary()["a"]["count"] == 2
    slam = System(Config(camera=TCAM, orb=OrbParams(**ORB), raw={}), device="cpu")
    slam.tracking_state = TrackerState.LOST
    assert slam.tracking_state is TrackerState.LOST


def test_loop_closer_signature():
    """``max_keyframes`` is the second positional parameter, as in the JAX
    package; ``device`` is keyword-only."""
    from structure_plp_slam_tpu_torch.models import loop_closer as tloop

    lc = tloop.LoopCloser(TCAM, 64, min_continuity=2, min_inliers=25, min_gap=4)
    assert (lc.min_continuity, lc.min_inliers, lc.min_gap) == (2, 25, 4)
    with pytest.raises(TypeError):
        tloop.LoopCloser(TCAM, 64, "cpu")


# ---------------------------------------------------------------------------
# The System reads the loop closer's attributes where the JAX System does.
# ---------------------------------------------------------------------------


def _loop_calls(slam):
    """Record every (kf_cur, candidate) the System sends to validation."""
    lc = slam.loop_closer
    calls, validate = [], lc.validate_dispatch

    def record(state, kf_cur, cand, key):
        calls.append((int(kf_cur), int(cand)))
        return validate(state, kf_cur, cand, key)

    lc.validate_dispatch = record
    return calls


def test_system_loop_closer_attributes():
    """tests/test_torch_loop_system.py's out-and-back (320x240, 0.4 m a
    frame) cut to 8 frames out and 8 back, drift injected at the turn
    (the organic loop test's surgery), a keyframe every 2 frames. Both
    Systems get ``loop_closer.min_gap = 3``, ``min_continuity = 1`` and
    ``min_inliers`` out of reach after construction: the same (keyframe,
    candidate) goes to validation in both, a pair the default gap of 10
    keyframes would not allow, and validation rejects it in both."""
    from structure_plp_slam_tpu_torch.models import loop_closer as tloop
    from tests.test_torch_loop_system import (_jax_system, _out_and_back, _port_system,
                                              feed_all, inject_drift)

    frames, _ = _out_and_back(TCAM, 42, out_frames=8)
    out = []
    for slam, to_tensor in ((_jax_system(**_LOOP_SIZES), jnp.asarray),
                            (_port_system(**_LOOP_SIZES), torch.from_numpy)):
        lc = slam.loop_closer
        lc.min_gap, lc.min_continuity, lc.min_inliers = 3, 1, 10**6
        calls = _loop_calls(slam)
        slam.startup()
        feed_all(slam, frames[:8])
        inject_drift(slam, to_tensor, consistent=True)
        feed_all(slam, frames[8:])
        slam.shutdown()
        out.append((calls, slam.metrics()["loops_closed"], slam.next_kf))
    (cj, lj, kj), (ct, lt, kt) = out
    assert ct == cj and lt == lj == 0 and kt == kj
    assert ct and all(3 <= cur - cand < tloop.MIN_GAP for cur, cand in ct), ct


_LOOP_SIZES = dict(max_keyframes=32, max_landmarks=8192, max_kf_interval=2)
