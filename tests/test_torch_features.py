"""Port parity: the ORB and matching functions outside the frontend's
fused path: ``hamming.mutual_best_matches``, ``orb.ic_angles``,
``orb.brief_descriptors`` and ``image.build_pyramid``.

The same numpy-seeded inputs go through the JAX functions and the port's
on the CPU. Tolerances:

- match indices and descriptors: exact (descriptors compared as the
  int32 bit patterns of the JAX package's uint32 words);
- ``build_pyramid``: exact at every level (the resize sums its taps in
  XLA:CPU's order for the shape, ROADMAP C8);
- ``ic_angles``: exact from the same moment maps and from the image
  against the JAX function called on its own (glibc's ``atan2f``, the
  prefix sums in XLA:CPU's blocked order); 1e-3 rad from the moment maps
  of ``jax.jit(ic_moment_maps)``, which XLA fuses in another order.

The cases of tests/test_features.py that call these functions
(test_descriptor_matches_under_translation,
test_ic_angle_gradient_direction) also run on the port at their bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from structure_plp_slam_tpu.ops import hamming as jham
from structure_plp_slam_tpu.ops import image as jimg
from structure_plp_slam_tpu.ops import orb as jorb
from structure_plp_slam_tpu_torch.ops import hamming as tham
from structure_plp_slam_tpu_torch.ops import image as timg
from structure_plp_slam_tpu_torch.ops import orb as torb
from tests.test_features import textured_image

torch.set_num_threads(2)


def _keypoints(rng, n, h, w, margin=torb.EDGE_MARGIN):
    """Keypoint coordinates with a fractional part (truncated by both
    packages), ``margin`` pixels from the borders, and a few on and past
    the border (clamped)."""
    xy = np.stack([rng.uniform(margin, w - margin, n), rng.uniform(margin, h - margin, n)], 1)
    xy[:3] = [[0.0, 0.0], [w - 0.5, h - 0.5], [w + 5.0, -3.0]]
    return xy.astype(np.float32)


@pytest.mark.parametrize("ratio", [None, 0.8])
def test_mutual_best_matches_matches_jax(ratio):
    """Random descriptors with near copies (so most rows have a mutual
    best), masked rows and columns, and exact ties in the distances."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 2**32, (300, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (260, 8), dtype=np.uint32)
    b[:200] = a[rng.permutation(300)[:200]] ^ rng.integers(0, 2**32, (200, 8),
                                                             dtype=np.uint32) & np.uint32(
        0x01010101)
    b[200:210] = b[190:200]  # duplicate columns: ties go to the lower index
    va, vb = rng.uniform(size=300) < 0.9, rng.uniform(size=260) < 0.9
    dj = jham.distance_matrix(jnp.asarray(a), jnp.asarray(b), jnp.asarray(va), jnp.asarray(vb))
    dt = tham.distance_matrix(torch.from_numpy(a.view(np.int32)),
                              torch.from_numpy(b.view(np.int32)), torch.from_numpy(va),
                              torch.from_numpy(vb))
    for max_dist in (0, 50, 1024):
        mj = np.asarray(jham.mutual_best_matches(dj, max_dist, ratio))
        mt = tham.mutual_best_matches(dt, max_dist, ratio).numpy()
        np.testing.assert_array_equal(mt, mj)
    assert (mt >= 0).sum() > 100


def test_descriptor_matches_under_translation(rng):
    """tests/test_features.py's case on the port: an image shifted by 6 px
    keeps its descriptors; the port's matches equal JAX's on the same
    distance matrix."""
    img = textured_image(rng)
    img2 = np.roll(img, 6, axis=1)
    ext = torb.OrbExtractor(240, 320, torb.OrbParams(max_num_keypts=400, num_levels=1))
    fa, fb = ext(torch.from_numpy(img)), ext(torch.from_numpy(img2))
    dist = tham.distance_matrix(fa["desc"], fb["desc"], fa["valid"], fb["valid"])
    m = tham.mutual_best_matches(dist, max_dist=60).numpy()
    np.testing.assert_array_equal(
        m, np.asarray(jham.mutual_best_matches(jnp.asarray(dist.numpy()), max_dist=60)))
    va, xa, xb = fa["valid"].numpy(), fa["xy"].numpy(), fb["xy"].numpy()
    matched = [(i, j) for i, j in enumerate(m) if j >= 0 and va[i]]
    assert len(matched) > 30
    dx = np.array([xb[j, 0] - xa[i, 0] for i, j in matched])
    assert np.mean(np.abs(dx - 6) < 2.0) > 0.6


def test_ic_angles_matches_jax(rng):
    """From JAX's moment maps (passed as ``moments``): exact. From the
    image: exact against the JAX function called on its own; within 1e-3
    rad of the angles from ``jax.jit(ic_moment_maps)``, whose fusion sums
    in another order (the extractor's jitted order is held exactly by
    tests/test_torch_frontend.py)."""
    img = textured_image(rng)
    xy = _keypoints(rng, 400, *img.shape)
    jm = jax.jit(jorb.ic_moment_maps)(jnp.asarray(img))
    ja = np.asarray(jorb.ic_angles(jnp.asarray(img), jnp.asarray(xy), moments=jm))
    ta = torb.ic_angles(torch.from_numpy(img), torch.from_numpy(xy),
                        moments=tuple(torch.from_numpy(np.array(m)) for m in jm)).numpy()
    np.testing.assert_array_equal(ta, ja)
    ta = torb.ic_angles(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-3)
    je = np.asarray(jorb.ic_angles(jnp.asarray(img), jnp.asarray(xy)))
    np.testing.assert_array_equal(ta, je)


def test_ic_angle_gradient_direction():
    """tests/test_features.py's case on the port: a patch brighter on the
    right has an angle near 0."""
    img = torch.from_numpy(np.tile(np.linspace(0, 255, 64, dtype=np.float32), (64, 1)))
    ang = float(torb.ic_angles(img, torch.tensor([[32.0, 32.0]]))[0])
    assert abs(ang) < 0.1


def test_brief_descriptors_matches_jax(rng):
    """Exact on one blurred level, the same angles in both packages (all
    around the circle), samples past the border clamped."""
    img = textured_image(rng)
    blurred = np.array(jimg.gaussian_blur(jnp.asarray(img), 7, 2.0))
    xy = _keypoints(rng, 400, *img.shape)
    ang = rng.uniform(-np.pi, np.pi, 400).astype(np.float32)
    ang[3:7] = [0.0, np.pi / 2, -np.pi / 2, np.pi]
    jd = np.asarray(jorb.brief_descriptors(jnp.asarray(blurred), jnp.asarray(xy),
                                           jnp.asarray(ang)))
    td = torb.brief_descriptors(torch.from_numpy(blurred), torch.from_numpy(xy),
                                torch.from_numpy(ang)).numpy()
    assert td.dtype == np.int32 and td.shape == (400, 8)
    np.testing.assert_array_equal(td, jd.view(np.int32))


@pytest.mark.parametrize("shape,levels,scale", [((240, 320), 4, 1.2), ((480, 640), 8, 1.2),
                                               ((97, 131), 3, 1.5)])
def test_build_pyramid_matches_jax(rng, shape, levels, scale):
    img = rng.uniform(0, 255, shape).astype(np.float32)
    jl = jimg.build_pyramid(jnp.asarray(img), levels, scale)
    tl = timg.build_pyramid(torch.from_numpy(img), levels, scale)
    assert len(tl) == len(jl) == levels
    assert [tuple(t.shape) for t in tl] == timg.pyramid_shapes(*shape, levels, scale)
    np.testing.assert_array_equal(tl[0].numpy(), img)
    for j, t in zip(jl[1:], tl[1:]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
