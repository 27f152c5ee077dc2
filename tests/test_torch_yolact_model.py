"""The pieces of the port's YOLACT training that sit under the loss and the
step, against the JAX package's.

- ``YolactTrainConfig``: the same fields and defaults as JAX's; the JSON
  round trip of both YOLACT configs and of ``ClassConfigSet``, and JAX's
  loaders read the port's files (the training CLI's manifest).
- ``box_encode``, ``resize_nearest`` (torch's legacy nearest rule, not
  ``jax.image.resize``'s) and ``resize_bilinear`` on the loss's
  [B, M, H, W] instance masks: bit-equal to JAX's.
- ``leaky_relu`` in bf16 and f32 and its gradient at 0; ``clip``'s
  gradient at its bounds (1/2, as ``jnp.clip``'s): equal to JAX's.
- ``Yolact(dtype=bf16)``: every conv and transposed conv computes in bf16,
  every BatchNorm outputs f32, the outputs are f32; the state dict is the
  f32 model's, so ``yolact_state_dict_from_flax`` carries JAX's weights.
- ``init="flax"`` is JAX's init in distribution: each weight's standard
  deviation and range against the JAX ``Yolact``'s own ``init`` (the
  ResNet's convs LeCun truncated normal, the rest xavier-uniform),
  biases zero, BatchNorm at identity; the default init is unchanged.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu import configs as jax_configs
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.ops.boxes import box_encode as jax_box_encode
from tauv_vision_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from tauv_vision_tpu.ops.image import resize_nearest as jax_resize_nearest
from tauv_vision_tpu_torch.configs import (
    ClassConfigSet,
    YolactModelConfig,
    YolactTrainConfig,
    yolact_config,
)
from tauv_vision_tpu_torch.models.layers import BatchNorm2d, leaky_relu
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.ops.boxes import box_encode
from tauv_vision_tpu_torch.ops.image import resize_bilinear, resize_nearest
from tauv_vision_tpu_torch.ops.losses import clip
from tauv_vision_tpu_torch.scripts import train_yolact
from tauv_vision_tpu_torch.weights import yolact_flax_path, yolact_state_dict_from_flax
from torch_parity import SMALL_YOLACT, jax_yolact_config, random_variables, torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def test_torch_yolact_train_config_matches_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(YolactTrainConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jax_configs.YolactTrainConfig)]
    assert port == want
    tc = train_yolact.train_config
    assert dataclasses.asdict(tc) == dataclasses.asdict(
        jax_configs.YolactTrainConfig(**dataclasses.asdict(tc)))
    assert (tc.batch_size, tc.max_objects, tc.max_positive_anchors) == (24, 16, 64)


def test_torch_yolact_configs_json_round_trip(tmp_path):
    from tauv_vision_tpu.scripts import train_yolact as jax_cli

    for port, jax_class in ((train_yolact.model_config, jax_configs.YolactModelConfig),
                            (train_yolact.train_config, jax_configs.YolactTrainConfig)):
        path = tmp_path / "config.json"
        port.save(path)
        assert type(port).load(path) == port
        assert type(port).from_dict(port.to_dict()) == port
        assert dataclasses.asdict(jax_class.load(path)) == port.to_dict()
    assert train_yolact.model_config.to_dict() == jax_cli.model_config.to_dict()
    assert train_yolact.train_config.to_dict() == jax_cli.train_config.to_dict()
    path = tmp_path / "classes.json"
    train_yolact.class_config.save(path)
    assert ClassConfigSet.load(path) == train_yolact.class_config
    assert json.loads(path.read_text()) == jax_cli.class_config.to_dict()
    assert jax_configs.ClassConfigSet.load(path) == jax_cli.class_config


def test_torch_box_encode_matches_jax():
    rng = np.random.default_rng(0)
    box = np.concatenate([rng.uniform(0.1, 0.9, (64, 2)), rng.uniform(0.01, 0.5, (64, 2))],
                         -1).astype(np.float32)
    anchor = np.concatenate([rng.uniform(0.1, 0.9, (64, 2)), rng.uniform(0.01, 0.5, (64, 2))],
                            -1).astype(np.float32)
    got = box_encode(torch.from_numpy(box), torch.from_numpy(anchor), (0.1, 0.2)).numpy()
    want = np.asarray(jax.jit(jax_box_encode, static_argnums=2)(box, anchor, (0.1, 0.2)))
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)   # an ulp: XLA's log


@pytest.mark.parametrize("in_hw,out_hw", [((64, 96), (32, 48)), ((360, 640), (90, 160)),
                                          ((45, 70), (32, 48)), ((7, 9), (20, 3))])
def test_torch_resizes_match_jax(in_hw, out_hw):
    rng = np.random.default_rng(1)
    valid = rng.uniform(size=(2, *in_hw)) > 0.3
    got = resize_nearest(torch.from_numpy(valid.astype(np.float32)), out_hw).numpy()
    assert np.array_equal(got, np.asarray(jax_resize_nearest(jnp.asarray(valid, jnp.float32),
                                                             out_hw)))
    seg = rng.integers(0, 5, (2, *in_hw))
    inst = (seg[:, None] == np.arange(4)[None, :, None, None]).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(inst), out_hw).numpy()
    want = jax.jit(jax.vmap(lambda m: jax_resize_bilinear(m, out_hw)))(jnp.asarray(inst))
    assert np.array_equal(got, np.asarray(want))


def test_torch_leaky_relu_and_clip_match_jax():
    x = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    x[:8] = 0.0
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jax.nn.leaky_relu(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
        got = leaky_relu(torch.from_numpy(x).to(tdt)).float().numpy()
        assert np.array_equal(got, want), tdt
    t = torch.from_numpy(x).requires_grad_()
    y = leaky_relu(t)   # the gradient's form; without one, f32 takes F.leaky_relu
    assert np.array_equal(y.detach().numpy(), leaky_relu(torch.from_numpy(x)).numpy())
    y.sum().backward()
    assert np.array_equal(t.grad.numpy(), np.asarray(jax.grad(
        lambda v: jax.nn.leaky_relu(v).sum())(jnp.asarray(x))))
    p = np.float32([1e-4, 0.5, 1 - 1e-4, 2.0, -1.0, 1e-5])
    t = torch.from_numpy(p).requires_grad_()
    clip(t, 1e-4, 1 - 1e-4).sum().backward()
    want = jax.grad(lambda v: jnp.clip(v, 1e-4, 1 - 1e-4).sum())(jnp.asarray(p))
    assert t.grad.tolist() == np.asarray(want).tolist() == [0.5, 1.0, 0.5, 0.0, 0.0, 0.0]


def test_torch_batch_norm_eval_under_autograd():
    """On running statistics with a bf16 input, the forward that autograd
    records (out of place) equals the served one bit for bit, and its
    gradients reach the input, the scale and the bias."""
    rng = np.random.default_rng(3)
    bn = BatchNorm2d(6, out_dtype=torch.bfloat16).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.standard_normal(6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 6).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 7)).astype(np.float32)).bfloat16()
    with torch.no_grad():
        served = bn(x)
    xg = x.clone().requires_grad_()
    y = bn(xg)
    assert y.dtype == served.dtype == torch.bfloat16 and torch.equal(y, served)
    y.float().sum().backward()
    assert xg.grad is not None and bn.weight.grad.abs().sum() > 0
    assert torch.equal(bn.bias.grad, torch.full((6,), 70.0))


def _yolact_cfg():
    return YolactModelConfig(**dict(SMALL_YOLACT, in_w=96))


def test_torch_yolact_dtype_plumbing():
    cfg = _yolact_cfg()
    model = Yolact(cfg, dtype=torch.bfloat16, device="cpu")
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d,
                                                           torch.nn.ConvTranspose2d))]
    assert len(convs) == 41 and all(m.compute_dtype == torch.bfloat16 for m in convs)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    assert len(bns) == 24 and all(m.out_dtype == torch.float32 for m in bns)
    assert model.state_dict().keys() == Yolact(cfg, device="cpu").state_dict().keys()
    variables = random_variables(JaxYolact(jax_yolact_config(cfg)), (1, 64, 96, 3), 0)
    model.load_state_dict(yolact_state_dict_from_flax(variables), strict=True)
    for training in (False, True):
        model.train(training)
        with torch.set_grad_enabled(training):
            out = model(torch.rand(2, 3, 64, 96))
        for name in ("classification", "box_encoding", "mask_coeff", "mask_prototype"):
            assert getattr(out, name).dtype == torch.float32, name


def test_torch_yolact_flax_init_matches_jax_in_distribution():
    """Each weight tensor of 256 elements or more: its standard deviation
    within 10% of the JAX init's and its range within the JAX init's
    bound (xavier-uniform's sqrt(6 / (fan_in + fan_out)), or the truncated
    normal's 2 standard deviations); biases zero; BatchNorm at identity."""
    cfg = yolact_config(64, 96, feature_depth=64)
    jax_vars = JaxYolact(jax_yolact_config(cfg)).init(jax.random.key(0),
                                                     jnp.zeros((1, 64, 96, 3)))
    want = yolact_state_dict_from_flax(jax.device_get(jax_vars))
    model = Yolact(cfg, init="flax", generator=torch.Generator().manual_seed(0), device="cpu")
    compared = 0
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                assert torch.equal(getattr(m, leaf), want[f"{name}.{leaf}"]), name
            continue
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            continue
        if m.bias is not None:
            assert not m.bias.any() and not want[f"{name}.bias"].any(), name
        p, w = m.weight.detach(), want[f"{name}.weight"]
        assert yolact_flax_path(name).startswith("backbone/") == name.startswith("_backbone.")
        if p.numel() < 256:
            continue
        compared += 1
        assert abs(p.std().item() / w.std().item() - 1) < 0.1, name
        assert p.abs().max() <= w.abs().max() * 1.02 + 1e-6, name
    assert compared == 41


def test_torch_yolact_default_init_unchanged():
    """``init="lecun"`` (the default, the served paths' draw) draws every
    conv in module order, LeCun normal, from the generator."""
    cfg = _yolact_cfg()
    model = Yolact(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(3)
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            fan_in = (m.weight.shape[0] if isinstance(m, torch.nn.ConvTranspose2d)
                      else m.weight.shape[1]) * m.weight.shape[2] * m.weight.shape[3]
            want = torch.empty_like(m.weight).normal_(0.0, fan_in ** -0.5, generator=gen)
            assert torch.equal(m.weight, want), name


def test_torch_yolact_trains_after_serving_in_inference_mode():
    """The resizes' cached taps are made outside inference mode: a served
    forward at the training shapes, then a training forward and backward."""
    from tauv_vision_tpu_torch.ops import image

    image._taps.cache_clear()
    cfg = _yolact_cfg()
    model = Yolact(cfg, device="cpu")
    x = torch.rand(2, 3, 64, 96)
    with torch.inference_mode():
        model.eval()(x)
    out = model.train()(x)
    (out.classification.sum() + out.mask_prototype.sum()).backward()
    assert all(p.grad is not None for p in model._feature_pyramid._lateral_layers.parameters())
