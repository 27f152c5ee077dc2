"""Helpers shared by the port's parity tests (not a test module)."""

import jax
import jax.numpy as jnp
import numpy as np


def random_variables(model, in_shape, seed):
    """numpy weights for a flax model, drawn from a seed in the shapes of
    its init (``jax.eval_shape``, so nothing is compiled): conv kernels
    normal with std 1/sqrt(fan_in), biases, BatchNorm parameters and
    statistics uniform; in every DCN block the offset kernel is scaled by
    1.5 and the offset and mask biases are uniform in +-1, so that offsets
    reach a few cells and some samples leave the map."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros(in_shape), train=False))
    draw = {
        "kernel": lambda s: rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])),
        "weight": lambda s: rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])),
        "bias": lambda s: rng.uniform(-0.1, 0.1, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "mean": lambda s: rng.uniform(-0.3, 0.3, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
    }

    def fill(node):
        out = {k: fill(v) if isinstance(v, dict)
               else draw[k](v.shape).astype(np.float32) for k, v in node.items()}
        if "offset" in out and "weight" in out:
            out["offset"]["kernel"] *= 1.5
            for name in ("offset", "mask"):
                n = out[name]["bias"].shape
                out[name]["bias"] = rng.uniform(-1, 1, n).astype(np.float32)
        return out

    return fill(shapes)
