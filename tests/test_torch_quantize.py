"""The port's calibration against the JAX package's.

On the small YOLACT of ``tests/test_quantize_chain.py`` with shared
weights (``torch_parity.yolact_pair``):

- ``yolact_flax_path`` inverts the port's module naming, so scales are
  keyed by the JAX paths;
- ``calibrate``, per tensor and per input channel, records the same 36
  convs as the JAX ``calibrate`` (none of them a transposed conv) with
  values within rtol 1e-5, plus, per channel, atol 1e-5 of the layer's
  largest value.  An absmax is as exact as the f32 activations it is
  taken of: conv sums in another order, through up to 20 layers, whose
  errors scale with the layer's magnitude, not the channel's.  Measured:
  1.1e-6 relative per tensor (``fpn/downsample_1``); per channel, 2.0e-6
  of the layer's largest value, and up to 2.7e-4 of a quiet channel's
  own value;
- ``strip_scales`` and the weight quantizer ``_wq`` equal the JAX ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.serving.quantize import calibrate as jax_calibrate
from tauv_vision_tpu.serving.quantize import strip_scales as jax_strip_scales
from tauv_vision_tpu.serving.quantize_chain import _wq as jax_wq
from tauv_vision_tpu_torch.configs import YolactModelConfig, yolact_config
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import _wq
from tauv_vision_tpu_torch.weights import _yolact_name, yolact_flax_path
from torch_parity import SMALL_YOLACT, yolact_pair


@pytest.fixture(scope="module")
def small():
    _, jax_model, variables, port = yolact_pair(YolactModelConfig(**SMALL_YOLACT), 0)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, 3)).astype(np.float32)
    return jax_model, variables, port, x


def _flax_modules(tree, prefix=()):
    leaves = [k for k, v in tree.items() if not isinstance(v, dict)]
    if leaves:
        yield "/".join(prefix)
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_modules(v, prefix + (k,))


def test_torch_yolact_flax_path_inverts_names(small):
    _, variables, port, _ = small
    names = [n for n, m in port.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.BatchNorm2d))]
    paths = [yolact_flax_path(n) for n in names]
    for name, path in zip(names, paths):
        assert _yolact_name(tuple(path.split("/"))) == name, (name, path)
    assert sorted(paths) == sorted(_flax_modules(variables["params"]))
    full = Yolact(yolact_config(), device="cpu")
    for name, m in full.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.BatchNorm2d)):
            assert _yolact_name(tuple(yolact_flax_path(name).split("/"))) == name


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
def test_torch_calibrate_matches_jax(small, per_channel):
    jax_model, variables, port, x = small
    want = jax_calibrate(lambda b: jax_model.apply(variables, b, train=False),
                         [jnp.asarray(x)], per_channel=per_channel)
    got = calibrate(port, [torch.from_numpy(x).permute(0, 3, 1, 2)], per_channel=per_channel)
    assert set(got) == set(want) and len(got) == 36
    assert not any("upsample" in path for path in got)
    for path, value in want.items():
        value = np.asarray(value, np.float64)
        assert np.asarray(got[path]).shape == value.shape, path
        atol = 1e-5 * value.max() if per_channel else 0.0
        np.testing.assert_allclose(got[path], value, rtol=1e-5, atol=atol, err_msg=path)


def test_torch_strip_scales_and_wq_match_jax():
    rng = np.random.default_rng(2)
    scales = {"backbone/layer1_0/conv1": 0.1, "prediction_head/box": 0.2,
              "protonet/output": rng.uniform(0.01, 0.1, 8), "fpn/lateral_0": 0.3}
    tail = ("prediction_head", "protonet/output")
    assert strip_scales(scales, tail).keys() == jax_strip_scales(scales, tail).keys() == {
        "backbone/layer1_0/conv1", "fpn/lateral_0"}
    kernel = rng.normal(size=(3, 3, 16, 24)).astype(np.float32)
    in_scale = rng.uniform(1e-3, 1e-1, 16)
    for s in (None, in_scale):
        q, scale = _wq(torch.from_numpy(kernel), in_scale=s)
        jq, jscale = jax_wq(jnp.asarray(kernel), in_scale=s)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
