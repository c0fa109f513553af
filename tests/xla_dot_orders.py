"""XLA:CPU's summation order for the pyramid resize's two products.

The port's ``ops/image.py`` sums each resize product over its nonzero taps
in the order XLA:CPU uses for the product's shape (``_XLA_DOT_ORDERS``).
XLA:CPU gives the dot to YNNPACK, which picks its kernel per shape, so the
orders are measured here: for each product of each pyramid level, the
candidate orders are tried against XLA on a random image and the first
that matches every pixel is kept.

    JAX_PLATFORMS=cpu python -m tests.xla_dot_orders

prints the table (entries equal to the default order are left out), and
``tests/test_torch_frontend.py::test_resize_summation_order`` holds each
entry of the port's table against XLA.
"""

from __future__ import annotations

import numpy as np
import torch

# Preference order: the port's default first, so a shape that needs no
# entry gets none.
CANDIDATES = [
    (1, False, 512), (2, False, 0), (4, True, 0), (2, False, 1024),
    (1, False, 1024), (2, False, 512), (4, True, 512), (1, False, 256),
    (4, False, 0), (8, True, 0), (16, True, 0),
]

# (rows, cols, levels, scale): every pyramid the port's cameras and tests
# build, and (rows, cols) of each half-resolution line pass.
PYRAMIDS = [(240, 320, 8, 1.2), (480, 640, 8, 1.2), (960, 1920, 8, 1.2),
            (256, 512, 8, 1.2), (512, 1024, 8, 1.2), (97, 131, 3, 1.5)]
HALVES = [(240, 320), (480, 640), (960, 1920), (256, 512)]


def resize_shapes():
    """Every ``((H, W), (h, w))`` resize the port's pyramids and line
    passes run."""
    from structure_plp_slam_tpu_torch.ops import image as timg

    out = []
    for rows, cols, levels, scale in PYRAMIDS:
        for hw in timg.pyramid_shapes(rows, cols, levels, scale)[1:]:
            out.append(((rows, cols), hw))
    out += [((r, c), (r // 2, c // 2)) for r, c in HALVES]
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


def measure(seed: int = 0):
    """``{dot shape: order}`` for every resize of ``resize_shapes()``, the
    default order left out; raises if no candidate matches a shape."""
    from structure_plp_slam_tpu_torch.ops import image as timg

    rng = np.random.default_rng(seed)
    table = {}
    for (H, W), hw in resize_shapes():
        img = rng.uniform(0, 255, (H, W)).astype(np.float32)
        for shape, ok in matching_orders(img, hw):
            if not ok:
                raise RuntimeError(f"no candidate order gives XLA's {shape}")
            if ok[0] != timg._DEFAULT_ORDER:
                table[shape] = ok[0]
    return table


if __name__ == "__main__":
    import jax

    import platform

    import jaxlib

    jax.config.update("jax_platforms", "cpu")
    print(f"    # jaxlib {jaxlib.__version__}, {platform.machine()} {platform.processor()}")
    for shape, order in sorted(measure().items()):
        print(f"    {shape}: {order},")
