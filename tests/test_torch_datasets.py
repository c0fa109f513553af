"""The port's dataset parsers on fabricated directory layouts: copies of
tests/test_datasets.py against structure_plp_slam_tpu_torch/io/datasets.py,
each layout also parsed by the JAX package for the same records, and the
image readers and PrefetchReader on frames of tests/synthetic_scene.py
(320x240, numpy seed 42) written to disk (reference:
example/util/{tum_rgbd,euroc,kitti,image}_util.h behaviors)."""

import dataclasses
import os

import numpy as np
import pytest

from structure_plp_slam_tpu.camera import Camera, CameraModel, CameraSetup
from structure_plp_slam_tpu.io import datasets as jdatasets
from structure_plp_slam_tpu_torch.io import datasets
from tests import synthetic_scene


def _same_records(recs, jrecs):
    assert [dataclasses.asdict(r) for r in recs] == [dataclasses.asdict(r) for r in jrecs]


def test_tum_association_nearest_within_maxdiff(tmp_path):
    (tmp_path / "rgb.txt").write_text(
        "# header\n1.00 rgb/a.png\n1.50 rgb/b.png\n2.00 rgb/c.png\n"
    )
    # depth for frame b is 0.3 s away -> unassociated (monocular record).
    (tmp_path / "depth.txt").write_text(
        "1.01 depth/a.png\n1.99 depth/c.png\n"
    )
    recs = datasets.load_tum_rgbd(str(tmp_path))
    assert [r.timestamp for r in recs] == [1.0, 1.5, 2.0]
    assert recs[0].depth_path.endswith("depth/a.png")
    assert recs[1].depth_path is None
    assert recs[2].depth_path.endswith("depth/c.png")
    _same_records(recs, jdatasets.load_tum_rgbd(str(tmp_path)))


def test_euroc_layout_and_stereo_pairing(tmp_path):
    for cam in ("cam0", "cam1"):
        os.makedirs(tmp_path / "mav0" / cam / "data")
    csv = "#ts,name\n1403636579763555584,1403636579763555584.png\n" \
          "1403636579813555456,1403636579813555456.png\n"
    (tmp_path / "mav0" / "cam0" / "data.csv").write_text(csv)
    # Only the FIRST frame has a right image on disk.
    (tmp_path / "mav0" / "cam1" / "data" / "1403636579763555584.png").touch()
    recs = datasets.load_euroc(str(tmp_path))
    assert len(recs) == 2
    assert abs(recs[0].timestamp - 1403636579.7635556) < 1e-5
    assert recs[0].right_img_path is not None
    assert recs[1].right_img_path is None
    mono = datasets.load_euroc(str(tmp_path), use_stereo=False)
    assert mono[0].right_img_path is None
    _same_records(recs, jdatasets.load_euroc(str(tmp_path)))
    _same_records(mono, jdatasets.load_euroc(str(tmp_path), use_stereo=False))


def test_kitti_layout(tmp_path):
    os.makedirs(tmp_path / "image_0")
    os.makedirs(tmp_path / "image_1")
    (tmp_path / "times.txt").write_text("0.0\n0.1\n0.2\n")
    for i in range(3):
        (tmp_path / "image_0" / f"{i:06d}.png").touch()
    (tmp_path / "image_1" / "000001.png").touch()
    recs = datasets.load_kitti(str(tmp_path))
    assert len(recs) == 3
    assert np.allclose([r.timestamp for r in recs], [0.0, 0.1, 0.2])
    assert recs[0].right_img_path is None
    assert recs[1].right_img_path.endswith("image_1/000001.png")
    _same_records(recs, jdatasets.load_kitti(str(tmp_path)))


def test_image_dir_with_masks(tmp_path):
    imgs = tmp_path / "imgs"
    masks = tmp_path / "masks"
    os.makedirs(imgs)
    os.makedirs(masks)
    for n in ("b.jpg", "a.png", "notes.txt"):
        (imgs / n).touch()
    (masks / "a.png").touch()
    recs = datasets.load_image_dir(str(imgs), fps=10.0, mask_dir=str(masks))
    # Sorted order, non-images skipped, timestamps at fps spacing.
    assert [os.path.basename(r.img_path) for r in recs] == ["a.png", "b.jpg"]
    assert np.allclose([r.timestamp for r in recs], [0.0, 0.1])
    assert recs[0].mask_path is not None and recs[1].mask_path is None
    _same_records(recs, jdatasets.load_image_dir(str(imgs), fps=10.0, mask_dir=str(masks)))


@pytest.fixture
def tum_frames(tmp_path):
    """Four frames of the synthetic scene written as a TUM RGB-D layout
    (uint8 PNG images, uint16 PNG depth at 5000 per metre, a mask)."""
    cv2 = pytest.importorskip("cv2")
    cam = Camera(name="synth", setup=CameraSetup.RGBD, model=CameraModel.PERSPECTIVE,
                 cols=320, rows=240, fx=260.0, fy=260.0, cx=159.5, cy=119.5, fps=30.0)
    frames, _ = synthetic_scene.make_sequence(np.random.default_rng(42), cam, num_frames=4)
    for sub in ("rgb", "depth", "mask"):
        os.makedirs(tmp_path / sub)
    rgb, dep = [], []
    for i, (img, depth, ts) in enumerate(frames):
        cv2.imwrite(str(tmp_path / "rgb" / f"{i}.png"), img.astype(np.uint8))
        cv2.imwrite(str(tmp_path / "depth" / f"{i}.png"), (depth * 5000.0).astype(np.uint16))
        cv2.imwrite(str(tmp_path / "mask" / f"{i}.png"),
                    np.where(depth < 4.5, 1, 2).astype(np.uint8))
        rgb.append(f"{ts:.6f} rgb/{i}.png")
        dep.append(f"{ts:.6f} depth/{i}.png")
    (tmp_path / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (tmp_path / "depth.txt").write_text("\n".join(dep) + "\n")
    return tmp_path, frames


def test_image_readers_match_jax(tum_frames):
    root, frames = tum_frames
    for i, (img, depth, _) in enumerate(frames):
        g = datasets.imread_gray(str(root / "rgb" / f"{i}.png"))
        d = datasets.imread_depth(str(root / "depth" / f"{i}.png"))
        assert g.dtype == np.uint8 and g.shape == (240, 320)
        assert d.dtype == np.uint16
        np.testing.assert_array_equal(g, img.astype(np.uint8))
        np.testing.assert_array_equal(d, (depth * 5000.0).astype(np.uint16))
        np.testing.assert_array_equal(g, jdatasets.imread_gray(str(root / "rgb" / f"{i}.png")))
    with pytest.raises(IOError):
        datasets.imread_gray(str(root / "missing.png"))


def test_prefetch_reader_matches_jax(tum_frames):
    """PrefetchReader yields every record in order with the same decoded
    image, raw depth (float32, depthmap units) and mask as the JAX
    package's."""
    root, frames = tum_frames
    recs = datasets.attach_masks(datasets.load_tum_rgbd(str(root)), str(root / "mask"))
    jrecs = jdatasets.attach_masks(jdatasets.load_tum_rgbd(str(root)), str(root / "mask"))
    got = list(datasets.PrefetchReader(recs, depth=True))
    want = list(jdatasets.PrefetchReader(jrecs, depth=True))
    assert len(got) == len(want) == len(frames)
    for (rec, img, d, r, m), (jrec, jimg, jd, jr, jm) in zip(got, want):
        assert dataclasses.asdict(rec) == dataclasses.asdict(jrec)
        assert r is None and jr is None
        assert d.dtype == np.float32 and m.dtype == np.int32
        for a, b in ((img, jimg), (d, jd), (m, jm)):
            np.testing.assert_array_equal(a, b)
