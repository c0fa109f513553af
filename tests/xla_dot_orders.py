"""XLA:CPU's summation order for the pyramid resize's two products.

The port's ``ops/image.py`` sums each resize product over its nonzero taps
in the order XLA:CPU uses for the product's shape (``_XLA_DOT_ORDERS``).
XLA:CPU gives the dot to YNNPACK, which picks its kernel per shape, so the
orders are measured here: for each product of each pyramid level, the
candidate orders are tried against XLA on a random image and the first
that matches every pixel is kept.

    JAX_PLATFORMS=cpu python -m tests.xla_dot_orders

prints the table (every measured shape, those that take the default order
too: ``ops/image.py`` warns about a shape only when it is missing), and
``tests/test_torch_frontend.py::test_resize_summation_order`` holds each
entry of the port's table against XLA.
"""

from __future__ import annotations

import numpy as np
import torch

# Preference order: the port's default first; the order with a tail
# (``ops/image.py``), which some K = 1241 products take, last.
CANDIDATES = [
    (1, False, 512, False), (2, False, 0, False), (4, True, 0, False),
    (2, False, 1024, False), (1, False, 1024, False), (2, False, 512, False),
    (4, True, 512, False), (1, False, 256, False), (4, False, 0, False),
    (8, True, 0, False), (16, True, 0, False), (2, False, 1024, True),
]

# (rows, cols, levels, scale): every pyramid the port's cameras and tests
# build, and (rows, cols) of each half-resolution line pass. The dataset
# cameras are those of run.py's euroc and kitti subcommands: EuRoC's 752x480
# (tests/test_rectify.py's YAML) and KITTI odometry's 1241x376.
DATASET_PYRAMIDS = [(480, 752, 8, 1.2), (376, 1241, 8, 1.2)]
DATASET_HALVES = [(480, 752), (376, 1241)]
PYRAMIDS = [(240, 320, 8, 1.2), (480, 640, 8, 1.2), (960, 1920, 8, 1.2),
            (256, 512, 8, 1.2), (512, 1024, 8, 1.2), (97, 131, 3, 1.5),
            *DATASET_PYRAMIDS]
HALVES = [(240, 320), (480, 640), (960, 1920), (256, 512), *DATASET_HALVES]

# An order is kept for a shape only if it matches XLA on every pixel of
# the random images of all these seeds.
SEEDS = (0, 1)


def resize_shapes(pyramids=PYRAMIDS, halves=HALVES):
    """Every ``((H, W), (h, w))`` resize of ``pyramids`` and of the
    half-resolution line passes of ``halves`` (by default all the port's
    cameras and tests run)."""
    from structure_plp_slam_tpu_torch.ops import image as timg

    out = []
    for rows, cols, levels, scale in pyramids:
        for hw in timg.pyramid_shapes(rows, cols, levels, scale)[1:]:
            out.append(((rows, cols), hw))
    out += [((r, c), (r // 2, c // 2)) for r, c in halves]
    return list(dict.fromkeys(out))


def xla_products(img, hw):
    """XLA:CPU's ``A @ img`` and ``(A @ img) @ B.T`` (the JAX package's
    ``resize_bilinear``) as numpy arrays."""
    import jax.numpy as jnp
    from structure_plp_slam_tpu.ops import image as jimg

    H, W = img.shape
    A = jnp.asarray(jimg._resize_matrix(H, hw[0]))
    B = jnp.asarray(jimg._resize_matrix(W, hw[1]))
    first = A @ jnp.asarray(img)
    return np.asarray(first), np.asarray(first @ B.T)


def matching_orders(img, hw):
    """For both products of one resize: ``(shape, [orders that give XLA's
    result on every pixel])``, ``shape`` being the dot's ``(M, K, N)``."""
    from structure_plp_slam_tpu_torch.ops import image as timg

    H, W = img.shape
    h, w = hw
    first, second = xla_products(img, hw)
    out = []
    for shape, x, n_out, dim, ref in (((h, H, W), img, h, 0, first),
                                      ((h, W, w), first, w, 1, second)):
        t = torch.from_numpy(np.array(x))
        ok = [o for o in CANDIDATES
              if np.array_equal(timg._banded_dot(t, (n_out,), dim, o).numpy(), ref)]
        out.append((shape, ok))
    return out


def measure(seeds=SEEDS):
    """``{dot shape: order}`` for every resize of ``resize_shapes()``: the
    first candidate that matches XLA on the random image of every seed;
    raises if no candidate matches a shape."""
    table = {}
    for (H, W), hw in resize_shapes():
        ok = {}
        for seed in seeds:
            img = np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(np.float32)
            for shape, orders in matching_orders(img, hw):
                ok[shape] = [o for o in ok.get(shape, orders) if o in orders]
        for shape, orders in ok.items():
            if not orders:
                raise RuntimeError(f"no candidate order gives XLA's {shape}")
            table[shape] = orders[0]
    return table


if __name__ == "__main__":
    import jax

    import platform

    import jaxlib

    jax.config.update("jax_platforms", "cpu")
    print(f"    # jaxlib {jaxlib.__version__}, {platform.machine()} {platform.processor()}")
    for shape, order in sorted(measure().items()):
        print(f"    {shape}: {order},")
