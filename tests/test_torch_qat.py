"""Quantization-aware distillation (``serving/qat.py``) in the PyTorch port
against the JAX package's ``serving/qat.py``, on the CPU.

- ``ste_round``: round half to even, with the identity as its gradient.
- One fake-quantized conv (``qat._FakeQuantConv`` against JAX
  ``_fake_quant_conv``) on the same kernel, bias and input, per tensor and
  per input channel, stride 1 and 2, in f32 and with the bf16 cast of the
  served CenterNet: the forward bit-equal (its f32 conv sums integer grids
  below 2^24, exact in any order), the gradients to the kernel, the bias
  and the input within ``GRAD_RTOL`` of their largest magnitude.  Every
  output channel's largest weight lands on +-127 after the straight-through
  rounding, and the input is planted with values on +-127 times their
  scale: there JAX's ``jnp.clip`` passes half the gradient, and so does
  the port (``torch.clamp`` would pass all of it: checked).
- The distillation loss (``qat.distillation_loss`` against JAX's
  ``loss_fn`` in ``qat_distill``: ``_default_leaf_loss`` over the
  prediction's pytree leaves, weighted by name) on the same outputs:
  within ``LOSS_RTOL``, its gradients to the student's outputs too, and
  the leaf names JAX's pytree path names.
- The whole f32 plain-IDA DLA-34 CenterNet at 64x128, batch 2, on the
  JAX package's weights drawn with numpy, with per-channel scales of its
  convs stripped of ``head_`` (the JAX default ``--qat-strip``), through
  ``qat_distill`` against JAX's ``qat_distill`` (its raw gradients, leaf
  losses and each fake-quantized conv's input taken inside its own jitted
  step), toward a teacher whose weights are the student's moved by
  ``TEACHER_SHIFT`` (so that the loss is the distance between two nets,
  not quantization noise).  Each rounding of the fake quantization turns
  on the last bits of its input, which the two stacks sum in another
  order, and a flipped code moves every later layer: on their own inputs
  the gradients move by up to a fifth of their norm when the input is
  scaled by 1 + 1e-6.  So each of the port's fake-quantized convs is fed
  JAX's input of the same path (the value JAX's, the gradient passed on
  to the port's own input), which holds which convs are swapped and with
  which scale (JAX's set, less the two projections it discards), the loss
  within ``LOSS_RTOL`` and every parameter's gradient within
  ``GRAD_RTOL`` relative L2.  The step itself is held on JAX's raw
  gradients (``ReplayingOptimizer``): the parameters after it within the
  bar of the port's optimizer against optax.  The bf16 net's whole
  forward is not held here; the bf16 cast is held on the one conv above.
"""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tauv_vision_tpu.models.centernet import Prediction as JaxPrediction
from tauv_vision_tpu.models.centerpoint_dla import CenterpointDLA34 as JaxCenterpointDLA34
from tauv_vision_tpu.serving import qat as jax_qat
from tauv_vision_tpu_torch.configs import centernet_config
from tauv_vision_tpu_torch.models.centernet import Prediction
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.layers import Conv2d
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving import qat
from tauv_vision_tpu_torch.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_state_dict_from_flax,
)
from torch_parity import (
    DISCARDED_PROJECTIONS,
    jax_object_config,
    random_variables,
    torch_threads,
)

GRAD_RTOL = 1e-5
LOSS_RTOL = 1e-6
H, W, BATCH = 64, 128, 2
STRIP = ("head_",)          # quantize_accuracy_check.py's --qat-strip default
LEAF_WEIGHTS = {"size": 4.0}  # its --qat-size-weight, here not 1 so that it is held
ADAM_TOL = 1e-7             # the port's optimizer against optax (test_torch_train_loop.py)
LR = 2e-5                   # qat_distill's default
TEACHER_SHIFT = 0.1         # the teacher's weights: the student's times 1 + 0.1 N(0, 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rel_l2(port, want) -> float:
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30))


def max_rel(port, want) -> float:
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return float(np.abs(port - want).max() / max(np.abs(want).max(), 1e-30))


def test_torch_ste_round_matches_jax():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, -127.49, 0.3, 99.7], np.float32)
    t = torch.from_numpy(x).requires_grad_(True)
    y = qat.ste_round(t)
    y.backward(torch.arange(len(x), dtype=torch.float32))
    want, vjp = jax.vjp(jax_qat.ste_round, jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.asarray(vjp(jnp.arange(len(x), dtype=jnp.float32))[0]))


# ------------------------------------------------------ one fake-quant conv


CONV_CASES = {
    "per_tensor_f32": (False, 1, jnp.float32),
    "per_channel_f32": (True, 1, jnp.float32),
    "per_channel_bf16_stride2": (True, 2, jnp.bfloat16),
    "per_tensor_bf16_stride2": (False, 2, jnp.bfloat16),
}


def _conv_case(per_channel, seed=0, n=2, hw=(9, 12), c_in=24, c_out=16):
    """Kernel HWIO, bias, NHWC f32 input and its scale (powers of two, so
    that a planted value times 1/scale is exactly +-127 or beyond)."""
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((3, 3, c_in, c_out)) / np.sqrt(9 * c_in)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, c_out).astype(np.float32)
    scale = (2.0 ** -rng.integers(4, 8, c_in)).astype(np.float32) if per_channel \
        else np.float32(2.0 ** -5)
    x = (rng.standard_normal((n,) + hw + (c_in,)) * 127 * scale / 2.5).astype(np.float32)
    # Plant values on the grid's ends and past them.
    flat = x.reshape(-1, c_in)
    s = np.broadcast_to(scale, (c_in,))
    for k, c in enumerate(range(0, c_in, 3)):
        flat[7 * k, c] = 127 * s[c] * (1 if k % 2 else -1)
        flat[7 * k + 1, c] = 130 * s[c]
    return kernel, bias, scale, x


def _port_conv(kernel, bias, stride, dtype):
    c_in, c_out = kernel.shape[2], kernel.shape[3]
    conv = Conv2d(c_in, c_out, 3, stride, 1, compute_dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(bias))
    return conv


def _port_fake_quant(conv, scale, x, cotangent):
    fq = qat._FakeQuantConv(conv, scale)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    conv.zero_grad(set_to_none=True)
    out = fq(xt)
    out.backward(torch.from_numpy(cotangent).permute(0, 3, 1, 2).to(out.dtype))
    return (out.detach().float().permute(0, 2, 3, 1).numpy(),
            conv.weight.grad.permute(2, 3, 1, 0).numpy(), conv.bias.grad.numpy(),
            xt.grad.permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_torch_fake_quant_conv_matches_jax(case, record_property):
    per_channel, stride, dtype = CONV_CASES[case]
    kernel, bias, scale, x = _conv_case(per_channel)
    module = flax_nn.Conv(kernel.shape[-1], (3, 3), strides=(stride, stride),
                          padding=((1, 1), (1, 1)), dtype=dtype)

    def fn(k, b, xx):
        return jax_qat._fake_quant_conv(module, xx, jnp.asarray(scale), k, b)

    want, vjp = jax.vjp(fn, jnp.asarray(kernel), jnp.asarray(bias), jnp.asarray(x))
    cotangent = np.random.default_rng(1).standard_normal(want.shape).astype(np.float32)
    want_grads = [np.asarray(g, np.float32)
                  for g in vjp(jnp.asarray(cotangent).astype(want.dtype))]
    torch_dtype = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    conv = _port_conv(kernel, bias, stride, torch_dtype)
    out, *grads = _port_fake_quant(conv, scale, x, cotangent)
    np.testing.assert_array_equal(out, np.asarray(want.astype(jnp.float32)))
    errs = {}
    for name, g, w in zip(("kernel", "bias", "input"), grads, want_grads):
        errs[name] = max_rel(g, w)
        assert errs[name] <= GRAD_RTOL, (name, errs[name])
    record_property("grad_max_err_of_largest", errs)

    # The planted ends: each output channel's largest folded weight and
    # the planted inputs on +-127 pass half the gradient, as JAX's clip.
    folded = kernel * (scale.reshape(1, 1, -1, 1) if per_channel else 1.0)
    tops = np.abs(folded).reshape(-1, folded.shape[-1]).argmax(axis=0)
    at_top = (tops, np.arange(folded.shape[-1]))
    q_x = x / np.broadcast_to(scale, (x.shape[-1],))
    on_end = np.abs(q_x) == 127
    assert on_end.sum() >= 8
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qat, "clip", lambda t, lo, hi: torch.clamp(t, lo, hi))
        _, k_clamp, _, x_clamp = _port_fake_quant(_port_conv(kernel, bias, stride, torch_dtype),
                                                  scale, x, cotangent)
    flat = (grads[0].reshape(-1, folded.shape[-1]), want_grads[0].reshape(-1, folded.shape[-1]),
            k_clamp.reshape(-1, folded.shape[-1]))
    for g in flat[:2]:
        np.testing.assert_allclose(g[at_top], 0.5 * flat[2][at_top], rtol=0,
                                   atol=GRAD_RTOL * np.abs(g).max())
    for g in (grads[2], want_grads[2]):
        np.testing.assert_allclose(g[on_end], 0.5 * x_clamp[on_end], rtol=0,
                                   atol=GRAD_RTOL * np.abs(g).max())


# ------------------------------------------------------ distillation loss


def _predictions(full: bool, seed=3):
    """(port student, port teacher, JAX student, JAX teacher) of random
    leaves shaped as a CenterNet prediction; without ``full`` the served
    CenterNet's three."""
    rng = np.random.default_rng(seed)
    b, h, w = 2, 4, 6
    shapes = {"heatmap": (4,), "size": (2,), "offset": (2,), "depth": (1,)}
    if full:
        shapes.update(keypoint_heatmap=(3,), keypoint_affinity=(3, 2),
                      **{f"{a}_{k}": (4,) for a in ("roll", "pitch", "yaw")
                         for k in ("bin", "offset")})
    else:
        shapes.pop("depth")
    pair = []
    for _ in range(2):
        leaves = {k: (rng.standard_normal((b, h, w) + s) * 3).astype(np.float32)
                  for k, s in shapes.items()}
        pair.append(leaves)
    out = []
    for cls, conv in ((Prediction, torch.from_numpy), (JaxPrediction, jnp.asarray)):
        for leaves in pair:
            out.append(cls(**{f.name: conv(leaves[f.name]) if f.name in leaves else None
                              for f in dataclasses.fields(cls)}))
    return out


def jax_distillation_loss(student, teacher, weights):
    """JAX ``qat_distill``'s ``loss_fn`` after the student's forward (its
    lines, on given outputs)."""
    losses = jax.tree_util.tree_map_with_path(jax_qat._default_leaf_loss, student, teacher)
    total, names = 0.0, []
    for path, value in jax.tree_util.tree_flatten_with_path(losses)[0]:
        name = "/".join(str(getattr(q, "name", q)) for q in path)
        names.append(name)
        w = 1.0
        for key, wv in weights.items():
            if key in name:
                w = wv
        total = total + w * value
    return total, names


@pytest.mark.parametrize("full", [True, False], ids=["all_leaves", "served_leaves"])
def test_torch_distillation_loss_matches_jax(full, record_property):
    student, teacher, j_student, j_teacher = _predictions(full)
    weights = {"size": 4.0, "bin": 0.5, "offset": 2.0}
    leaves = [f.name for f in dataclasses.fields(student) if getattr(student, f.name) is not None]
    for f in leaves:
        getattr(student, f).requires_grad_(True)
    got = qat.distillation_loss(student, teacher, weights)
    got.backward()

    def total(s):
        return jax_distillation_loss(s, j_teacher, weights)[0]

    want, grads = jax.value_and_grad(total)(j_student)
    assert jax_distillation_loss(j_student, j_teacher, weights)[1] == leaves
    err = abs(got.item() / float(want) - 1)
    record_property("loss_rel_err", err)
    assert err <= LOSS_RTOL
    for name in leaves:
        g = getattr(student, name).grad.numpy()
        assert max_rel(g, np.asarray(getattr(grads, name))) <= LOSS_RTOL, name


# ------------------------------------------------------ the whole CenterNet


class ReplayingOptimizer:
    """``qat_distill``'s optimizer, which keeps the step's own gradients in
    ``run["grads"]`` and then steps on ``grads`` (JAX's) in their place."""

    def __init__(self, inner, names, grads, run):
        self.inner, self.names, self.grads, self.run = inner, names, grads, run

    def zero_grad(self, set_to_none=True):
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self):
        params = [p for group in self.inner.param_groups for p in group["params"]]
        assert len(params) == len(self.names)
        self.run["grads"] = {n: p.grad for n, p in zip(self.names, params)}
        for n, p in zip(self.names, params):
            p.grad = self.grads[n].clone()
        self.inner.step()


@pytest.fixture(scope="module")
def distilled():
    return distill()


def distill():
    """JAX's and the port's loss, raw gradients and parameters after one
    ``qat_distill`` step toward a teacher apart from the student, the
    port's fake-quantized convs fed JAX's inputs."""
    oc, _ = centernet_config(H, W)
    jax_model = JaxCenterpointDLA34(object_config=jax_object_config(oc), deform=False)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    port = CenterpointDLA34(oc, device="cpu").eval()
    port.load_state_dict(centerpoint_state_dict_from_flax(variables))
    frames = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (BATCH, H, W, 3),
                                                                np.uint8))
    img = preprocess(frames, (H, W), IMAGENET_MEAN, IMAGENET_STDDEV)
    scales = strip_scales(calibrate(port, [img], per_channel=True,
                                    paths_of=centerpoint_calibration_paths), STRIP)
    j_img = jnp.asarray(img.permute(0, 2, 3, 1).numpy())
    # A teacher apart from the student, so that the loss and its gradients
    # are the distance between the two nets and not quantization noise.
    rng = np.random.default_rng(5)
    teacher_variables = {**variables, "params": jax.tree_util.tree_map(
        lambda p: (p * (1 + TEACHER_SHIFT * rng.standard_normal(p.shape))).astype(np.float32),
        variables["params"])}
    teacher = CenterpointDLA34(oc, device="cpu").eval()
    teacher.load_state_dict(centerpoint_state_dict_from_flax(teacher_variables))

    # JAX's own qat_distill, its raw gradients, leaf losses and each
    # fake-quantized conv's input recorded inside its jitted step.
    raw, leaf_values, jax_inputs = [], {}, {}
    clip_by_global_norm, leaf_loss = optax.clip_by_global_norm, jax_qat._default_leaf_loss
    fake_quant_conv = jax_qat._fake_quant_conv

    def recording_clip(max_norm):
        inner = clip_by_global_norm(max_norm)

        def update(grads, state, params=None):
            jax.debug.callback(lambda g: raw.append(jax.device_get(g)), grads)
            return inner.update(grads, state, params)

        return optax.GradientTransformation(inner.init, update)

    def recording_leaf_loss(path, s, t):
        value = leaf_loss(path, s, t)
        name = "/".join(str(getattr(q, "name", q)) for q in path)
        jax.debug.callback(lambda v: leaf_values.__setitem__(name, float(v)), value)
        return value

    def recording_fake_quant_conv(module, x, *args):
        path = "/".join(module.path)
        jax.debug.callback(lambda v: jax_inputs.setdefault(path, np.asarray(v)), x)
        return fake_quant_conv(module, x, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "clip_by_global_norm", recording_clip)
        mp.setattr(jax_qat, "_default_leaf_loss", recording_leaf_loss)
        mp.setattr(jax_qat, "_fake_quant_conv", recording_fake_quant_conv)
        after = jax_qat.qat_distill(jax_model, variables, scales, iter([j_img]), steps=1,
                                    leaf_weights=LEAF_WEIGHTS,
                                    teacher_variables=teacher_variables, log_fn=lambda s: None)
    jax.effects_barrier()
    assert len(raw) == 1
    jax_loss = sum(LEAF_WEIGHTS.get(name, 1.0) * v for name, v in leaf_values.items())

    jax_grads = centerpoint_state_dict_from_flax(
        {"params": raw[0], "batch_stats": variables["batch_stats"]})
    names = [n for n, _ in port.named_parameters()]

    # The port's qat_distill with each fake-quantized conv fed JAX's input
    # of the same path: (x - x) + JAX's is JAX's bit for bit and passes the
    # gradient on to x unchanged.
    run, conv_paths, input_errs = {}, {}, {}
    loss_fn, adam, fake_quant_call = (qat.distillation_loss, qat.adam_with_clip,
                                      qat.fake_quant_call)
    conv_call = qat._FakeQuantConv.__call__

    def recording_loss(*args, **kwargs):
        run["loss"] = loss_fn(*args, **kwargs)
        return run["loss"]

    def replaying_adam(params, lr, max_norm):
        run["adam"] = (lr, max_norm)
        return ReplayingOptimizer(adam(params, lr, max_norm), names, jax_grads, run)

    def mapping_fake_quant_call(model, scales, paths_of):
        for name, m in model.named_modules():
            paths = paths_of(name)
            conv_paths[m] = paths if paths is None or isinstance(paths, str) else paths[0]
        return fake_quant_call(model, scales, paths_of=paths_of)

    def from_jax(self, x):
        path = conv_paths[self.conv]
        want = torch.from_numpy(np.array(jax_inputs[path])).permute(0, 3, 1, 2)
        assert want.shape == x.shape, path
        input_errs[path] = max_rel(x.detach(), want)
        return conv_call(self, (x - x.detach()) + want)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(qat, "distillation_loss", recording_loss)
        mp.setattr(qat, "adam_with_clip", replaying_adam)
        mp.setattr(qat, "fake_quant_call", mapping_fake_quant_call)
        mp.setattr(qat._FakeQuantConv, "__call__", from_jax)
        stepped = qat.qat_distill(port, scales, iter([img]), 1, leaf_weights=LEAF_WEIGHTS,
                                  teacher=teacher, paths_of=centerpoint_calibration_paths,
                                  log_every=0)
    return dict(variables=variables, scales=scales, jax_loss=jax_loss, jax_grads=jax_grads,
                jax_after=centerpoint_state_dict_from_flax(jax.device_get(after)),
                leaves=sorted(leaf_values), jax_convs=set(jax_inputs),
                port_convs=set(input_errs), input_errs=input_errs,
                port=dict(loss=run["loss"].item(), grads=run["grads"], adam=run["adam"],
                          after=stepped.state_dict()))


def test_torch_qat_loss_matches_jax(distilled, record_property):
    """JAX's fake-quantized convs are the port's, less the projections JAX
    computes and discards, and the loss is JAX's within ``LOSS_RTOL``."""
    assert distilled["leaves"] == ["heatmap", "offset", "size"]
    scales = distilled["scales"]
    assert len(scales) > 40 and not any("head_" in p for p in scales)
    assert distilled["jax_convs"] <= set(scales)
    assert distilled["port_convs"] == distilled["jax_convs"] - {
        "model/base/level3/project_conv", "model/base/level4/project_conv"}
    err = abs(distilled["port"]["loss"] / distilled["jax_loss"] - 1)
    record_property("loss_rel_err", err)
    record_property("own_inputs_max_err_of_largest", max(distilled["input_errs"].values()))
    assert err <= LOSS_RTOL


def test_torch_qat_grads_match_jax(distilled, record_property):
    port, want = distilled["port"]["grads"], distilled["jax_grads"]
    errs, bad = {}, {}
    for name, g in port.items():
        w = want[name]
        if g is None:
            # The projections that JAX computes and discards: 0 in JAX,
            # never run in the port.
            assert name.startswith(DISCARDED_PROJECTIONS) and not w.any(), name
            continue
        assert torch.isfinite(g).all(), name
        if not w.any():
            assert not g.any(), name
            continue
        errs[name] = rel_l2(g, w)
        if errs[name] > GRAD_RTOL:
            bad[name] = errs[name]
    record_property("grads", len(errs))
    record_property("median_rel_l2", float(np.median(list(errs.values()))))
    record_property("max_rel_l2", max(errs.values()))
    assert len(errs) >= 190
    assert not bad, bad


def test_torch_qat_step_matches_jax(distilled, record_property):
    """``qat_distill``'s step on JAX's raw gradients lands on JAX's
    parameters: its optimizer (``adam_with_clip(2e-5, 1.0)``), every
    parameter trained, the BatchNorm statistics frozen.  On its own
    gradients the step is not held element by element: Adam's first update
    is ~lr sign(gradient), and the gradients above part by up to a quarter
    of their norm (as under the port's own input nudge), so many small
    elements step the other way."""
    before = centerpoint_state_dict_from_flax(distilled["variables"])
    port, want = distilled["port"]["after"], distilled["jax_after"]
    assert distilled["port"]["adam"] == (LR, 1.0)
    moved, worst = 0, 0.0
    for name, p in port.items():
        if name.endswith("num_batches_tracked"):
            continue
        w = want[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(p, before[name]), name
            continue
        moved += int(not torch.equal(p, before[name]))
        worst = max(worst, float(np.abs(p.numpy() - w).max()))
        np.testing.assert_allclose(p.numpy(), w, rtol=ADAM_TOL, atol=ADAM_TOL, err_msg=name)
    record_property("params_moved", moved)
    record_property("max_abs_err", worst)
    assert moved >= 190
