"""Port parity: ``triangulation.check_triangulation``.

The same numpy-seeded two-view geometry goes through the JAX function
and the port's on the CPU; the masks are exactly equal. The inputs mix
good points with points behind either camera, points whose bearing is
off their triangulated ray, and a camera pair whose baseline is too
short for parallax. tests/test_triangulation.py's two cases also run on
the port.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from structure_plp_slam_tpu.ops import lie as jlie
from structure_plp_slam_tpu.ops import triangulation as jtri
from structure_plp_slam_tpu_torch.ops import triangulation as ttri
from tests.helpers import create_random_landmarks

torch.set_num_threads(2)


def _normalize(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _both(pts_c1, b1, b2, R_21, t_21, **kw):
    j = np.asarray(jtri.check_triangulation(*(jnp.asarray(a) for a in (pts_c1, b1, b2, R_21,
                                                                         t_21)), **kw))
    t = ttri.check_triangulation(*(torch.from_numpy(np.array(a, np.float32))
                                   for a in (pts_c1, b1, b2, R_21, t_21)), **kw).numpy()
    np.testing.assert_array_equal(t, j)
    return t


@pytest.mark.parametrize("baseline", [0.3, 1e-5])
def test_check_triangulation_matches_jax(baseline):
    rng = np.random.default_rng(9)
    n = 400
    X = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(0.5, 12, (n, 1))], -1)
    X[:40, 2] *= -1.0  # behind camera 1
    R_21 = np.asarray(jlie.so3_exp(jnp.asarray([[0.01, 0.04, -0.02]], jnp.float32)))[0]
    t_21 = np.array([-baseline, 0.01 * baseline, 0.1 * baseline], np.float32)
    X2 = X @ R_21.T + t_21
    b1, b2 = _normalize(X), _normalize(X2)
    b2[40:80] = _normalize(X2[40:80] + rng.normal(size=(40, 3)) * 0.5)  # off the ray
    pts = X.astype(np.float32)
    pts[80:100] = (X[80:100] + rng.normal(size=(20, 3)) * 1e-3).astype(np.float32)
    _both(pts, b1, b2, R_21, t_21, min_parallax_cos=0.99999)
    ok = _both(pts, b1, b2, R_21, t_21)
    if baseline > 1e-3:
        assert not ok[:40].any() and not ok[40:80].all() and ok[100:].mean() > 0.5
    else:
        assert not ok.any()

def test_check_triangulation_cases_on_port(rng):
    """tests/test_triangulation.py's cases: a point behind camera 2, and
    low parallax from a 1e-5 m baseline, both rejected (and equal to
    JAX's)."""
    pts = np.array([[0.0, 0.0, 5.0]], np.float32)
    t_21 = np.array([0.0, 0.0, -10.0], np.float32)
    ok = _both(pts, _normalize(pts), _normalize(pts + t_21), np.eye(3, dtype=np.float32), t_21)
    assert not ok[0]
    pts = create_random_landmarks(rng, 20).astype(np.float32)
    t_21 = np.array([1e-5, 0.0, 0.0], np.float32)
    ok = _both(pts, _normalize(pts), _normalize(pts + t_21), np.eye(3, dtype=np.float32), t_21)
    assert not ok.any()
