"""One YOLACT train step of the port against the JAX package's, in f32; the
eval step; the gradients with running statistics.

A narrow YOLACT (the full ResNet-18 trunk, a 16-wide FPN, 4 prototypes,
2 classes) at 64x96, batch 2, on the JAX package's weights drawn with
numpy (``torch_parity.random_variables``: BatchNorm scales and statistics
random) carried over by ``weights.yolact_state_dict_from_flax``, on
``generate_square_seg_batch``'s squares; the mask loss capped at 16
positives.  The JAX side is the package's own: the loss function of
``make_yolact_train_step`` under a jitted ``value_and_grad`` for the raw
gradients and the batch statistics, ``make_yolact_train_step`` itself
(``watch=True``, which also gives each step's global gradient norm) for
three Adam steps, ``make_yolact_eval_step`` for the eval step.  64x96 and
not 64x64: at 64x64 the last FPN level's stride-2 conv reads a 1x1 map,
where torch's CPU bf16 convolution backward returns garbage (the bf16
steps share this set-up, ``test_torch_yolact_bf16.py``).

The train step is chaotic at this size: BatchNorm on batch statistics
over the deepest levels (1x1 to 2x3 maps at batch 2) and ReLU kinks move
the port's own gradients by ~1e-5 (median over the parameters) when the
input moves by 1e-6 relative, and JAX sums in another order.  So, as in
``test_torch_train_step.py``, each quantity is held to the larger of a bar
and YARDSTICK times its own largest move in the port when the input image
is scaled by 1 +- 1e-6, measured in the same run:

- every ``YolactLosses`` term: 1e-5 relative (``mask_clipped`` equal);
- every parameter's gradient, by relative L2: 1e-4;
- the BatchNorm running statistics after the step: 1e-5;
- the parameters after an Adam step with global-norm clipping at 0.5
  (below every step's norm, so the clip bites): each parameter's update,
  by relative L2: 1e-4.  Adam's first update is ~lr sign(gradient), so an
  element whose gradient is near 0 may step the other way.

Past the first step the two stacks' trajectories part (an update of
another sign moves the next step's gradient), so three steps are held on
JAX's own gradients: the port's optimizer fed JAX's raw gradients of
each of JAX's three steps lands on JAX's parameters within 1e-7
(``test_torch_train_loop.py``'s bar for the optimizer against optax).

With running statistics (BatchNorm in eval mode) the same gradients are
well conditioned: each within 1e-4 relative L2 or 8x its move, the median
within 1e-5.  The eval step's losses: within 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.train.state import TrainState as JaxTrainState
from tauv_vision_tpu.train.state import adam_with_clip as jax_adam_with_clip
from tauv_vision_tpu.train.steps import make_yolact_eval_step as jax_make_yolact_eval_step
from tauv_vision_tpu.train.steps import make_yolact_train_step as jax_make_yolact_train_step
from tauv_vision_tpu.train.yolact_task import YolactTruth as JaxTruth
from tauv_vision_tpu.train.yolact_task import yolact_loss as jax_yolact_loss
from tauv_vision_tpu_torch.configs import YolactModelConfig, YolactTrainConfig
from tauv_vision_tpu_torch.data.synthetic import (
    SquareDatasetConfig,
    generate_square_seg_batch,
    seg_truth,
)
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_yolact_eval_step, make_yolact_train_step
from tauv_vision_tpu_torch.train.yolact_task import yolact_loss
from tauv_vision_tpu_torch.weights import yolact_state_dict_from_flax
from torch_parity import (
    SMALL_YOLACT,
    jax_yolact_config,
    jax_yolact_train_config,
    random_variables,
    torch_threads,
)

H, W, BATCH = 64, 96, 2
CFG = YolactModelConfig(**dict(SMALL_YOLACT, in_w=W, iou_pos_threshold=0.4,
                               iou_neg_threshold=0.3))
MAX_NORM = 0.5
N_ADAM = 3
LOSS_FIELDS = ("total", "classification", "box", "mask")
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_BARS = dict(loss=1e-5, grad=1e-4, stats=1e-5, update=1e-4)
YARDSTICK = 4.0
ADAM_TOL = 1e-7
F32_NUDGES = (1e-6, -1e-6)
# The two extra FPN levels (1x2 and 1x1 maps) carry anchors of 96 and 192
# pixels, which no square of the batch matches and OHEM does not pick: the
# convs that make those levels have a gradient of 0 in both stacks.
UNTRAINED = "_feature_pyramid._downsample_layers."


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def train_config(max_norm=MAX_NORM):
    return YolactTrainConfig(lr=1e-3, momentum=0.9, weight_decay=0.0, grad_max_norm=max_norm,
                             n_epochs=1, batch_size=BATCH, epoch_n_batches=1, max_objects=4,
                             max_positive_anchors=16)


def batch():
    img, fields = generate_square_seg_batch(np.random.default_rng(0), BATCH, SquareDatasetConfig(
        in_h=H, in_w=W, max_objects=4, min_side=10, max_side=24))
    return img, seg_truth(fields)


def rel_l2(port, want):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30)


def jax_truth(truth):
    return JaxTruth(**{f.name: jnp.asarray(getattr(truth, f.name))
                       for f in dataclasses.fields(truth)})


def step_setup(name, nudges):
    """JAX's steps (the raw losses, gradients and statistics of each of
    N_ADAM steps, the state after each), and the port's raw step and one
    Adam step at the input and at each nudged input (x (1 + nudge))."""
    jdt, tdt = DTYPES[name]
    img, truth = batch()
    jcfg, jtc = jax_yolact_config(CFG), jax_yolact_train_config(train_config())
    jax_model = JaxYolact(jcfg, dtype=jdt)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    jt = jax_truth(truth)

    def loss_fn(params, batch_stats):   # make_yolact_train_step's
        prediction, mutated = jax_model.apply(
            {"params": params, "batch_stats": batch_stats}, jnp.asarray(img), train=True,
            mutable=["batch_stats"])
        losses = jax_yolact_loss(prediction, jt, jcfg, jtc)
        return losses.total, (losses, mutated["batch_stats"])

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    state = JaxTrainState.create(apply_fn=jax_model.apply, params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 tx=jax_adam_with_clip(jtc.lr, MAX_NORM))
    step = jax_make_yolact_train_step(jax_model, jcfg, jtc, watch=True)
    steps = []
    for _ in range(N_ADAM):
        (_, (losses, new_stats)), grads = value_and_grad(state.params, state.batch_stats)
        state, _, watch = step(state, jnp.asarray(img), jt)
        steps.append(dict(
            losses=jax.device_get(losses),
            grads=yolact_state_dict_from_flax({"params": jax.device_get(grads),
                                               "batch_stats": jax.device_get(new_stats)}),
            after=yolact_state_dict_from_flax(jax.device_get(
                {"params": state.params, "batch_stats": state.batch_stats})),
            norm=float(watch["watch/global_grad_norm"])))

    start = yolact_state_dict_from_flax(variables)
    model = Yolact(CFG, dtype=tdt, device="cpu")
    port_step = make_yolact_train_step(CFG, train_config())
    port_truth = truth.to("cpu")
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    runs = []
    for nudge in (0.0,) + tuple(nudges):
        xi = x * (1 + nudge) if nudge else x
        model.load_state_dict(start)
        # A clip that never bites leaves the raw gradients in .grad.
        raw = TrainState(model, adam_with_clip(model.parameters(), 1e-3, float("inf")))
        _, raw_losses = port_step(raw, xi, port_truth)
        run = dict(losses=raw_losses,
                   grads={n: p.grad.clone() for n, p in model.named_parameters()},
                   stats={n: b.clone() for n, b in model.named_buffers()
                          if n.endswith(("running_mean", "running_var"))})
        model.load_state_dict(start)
        port_step(TrainState(model, adam_with_clip(model.parameters(), 1e-3, MAX_NORM)), xi,
                  port_truth)
        run["after"] = {k: v.clone() for k, v in model.state_dict().items()}
        runs.append(run)

    # The port's optimizer fed JAX's own gradients, step after step.
    model.load_state_dict(start)
    optimizer = adam_with_clip(model.parameters(), 1e-3, MAX_NORM)
    replay = []
    for jax_step in steps:
        for n, p in model.named_parameters():
            p.grad = jax_step["grads"][n].clone()
        optimizer.step()
        replay.append({n: p.detach().clone() for n, p in model.named_parameters()})
    return dict(jax=steps, port=runs[0], nudged=runs[1:], start=start, replay=replay)


def check_step(setup, bars, hold_update=True):
    """Every quantity of the first step within the larger of its bar and
    YARDSTICK times the port's largest move under the nudges (the update
    of the port's own Adam step where ``hold_update``); the optimizer on
    JAX's gradients within ADAM_TOL of JAX's parameters."""
    want, port, nudged = setup["jax"][0], setup["port"], setup["nudged"]

    def bar(base, get):
        return max(base, YARDSTICK * max(rel_l2(get(n), get(port)) for n in nudged))

    assert int(port["losses"].mask_clipped) == int(want["losses"].mask_clipped)
    for field in LOSS_FIELDS:
        got, w = getattr(port["losses"], field), getattr(want["losses"], field)
        err = rel_l2(got, w)
        assert err <= bar(bars["loss"], lambda r: getattr(r["losses"], field)), (field, err)

    bad, compared = {}, 0
    for name, g in port["grads"].items():
        w = want["grads"][name]
        if name.startswith(UNTRAINED):
            assert not w.any() and not g.any(), name
            continue
        compared += 1
        err = rel_l2(g, w)
        if err > bar(bars["grad"], lambda r: r["grads"][name]):
            bad[name] = err
    assert compared == 103
    assert not bad, ("gradients", bad)

    stats = port["stats"]
    assert len(stats) == 48
    for name in stats:
        err = rel_l2(stats[name], want["grads"][name])
        assert err <= bar(bars["stats"], lambda r: r["stats"][name]), (name, err)

    start, after = setup["start"], port["after"]
    bad = {}
    for name in port["grads"] if hold_update else ():
        moved = want["after"][name] - start[name]
        if name.startswith(UNTRAINED):
            assert not moved.any() and torch.equal(after[name], start[name]), name
            continue
        err = rel_l2(after[name] - start[name], moved)
        if err > bar(bars["update"], lambda r: r["after"][name] - start[name]):
            bad[name] = err
    assert not bad, ("updates", bad)

    assert all(s["norm"] > MAX_NORM for s in setup["jax"])
    for jax_step, params in zip(setup["jax"], setup["replay"]):
        for name, p in params.items():
            torch.testing.assert_close(p, jax_step["after"][name], rtol=ADAM_TOL, atol=ADAM_TOL,
                                       msg=name)


@pytest.fixture(scope="module")
def f32_setup():
    return step_setup("f32", F32_NUDGES)


def test_torch_yolact_train_step_f32_matches_jax(f32_setup):
    check_step(f32_setup, F32_BARS)


def eval_losses(name):
    """(JAX's make_yolact_eval_step losses, the port's) on the set-up's
    weights and batch, BatchNorm on its running statistics."""
    jdt, tdt = DTYPES[name]
    img, truth = batch()
    jcfg = jax_yolact_config(CFG)
    jax_model = JaxYolact(jcfg, dtype=jdt)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    state = JaxTrainState.create(apply_fn=jax_model.apply, params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 tx=jax_adam_with_clip(1e-3, MAX_NORM))
    want = jax_make_yolact_eval_step(jax_model, jcfg, jax_yolact_train_config(train_config()))(
        state, jnp.asarray(img), jax_truth(truth))
    model = Yolact(CFG, dtype=tdt, device="cpu")
    model.load_state_dict(yolact_state_dict_from_flax(variables))
    port_state = TrainState(model, adam_with_clip(model.parameters(), 1e-3, MAX_NORM))
    got = make_yolact_eval_step(CFG, train_config())(
        port_state, torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(), truth.to("cpu"))
    assert model.training   # the step gives the model its mode back
    return jax.device_get(want), got


def test_torch_yolact_eval_step_f32_matches_jax():
    want, got = eval_losses("f32")
    assert int(got.mask_clipped) == int(want.mask_clipped)
    for field in LOSS_FIELDS:
        w, g = float(getattr(want, field)), float(getattr(got, field))
        assert abs(g - w) <= 1e-6 * abs(w), (field, g, w)


def test_torch_yolact_grads_running_stats_match_jax():
    """The backward itself, well conditioned: BatchNorm on running
    statistics, f32."""
    img, truth = batch()
    jcfg, jtc = jax_yolact_config(CFG), jax_yolact_train_config(train_config())
    jax_model = JaxYolact(jcfg)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    jt = jax_truth(truth)

    def loss_fn(params):
        prediction = jax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                     jnp.asarray(img), train=False)
        return jax_yolact_loss(prediction, jt, jcfg, jtc).total

    want = yolact_state_dict_from_flax({"params": jax.device_get(jax.jit(jax.grad(loss_fn))(
        variables["params"])), "batch_stats": variables["batch_stats"]})
    model = Yolact(CFG, device="cpu")
    start = yolact_state_dict_from_flax(variables)

    def grads(x):
        model.load_state_dict(start)
        model.zero_grad(set_to_none=True)
        yolact_loss(model.eval()(x), truth.to("cpu"), CFG, train_config()).total.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    got = grads(x)
    moves = [grads(x * (1 + n)) for n in F32_NUDGES]
    errs = {}
    for name, g in got.items():
        if name.startswith(UNTRAINED):
            assert not want[name].any() and not g.any(), name
            continue
        errs[name] = rel_l2(g, want[name])
        move = max(rel_l2(m[name], g) for m in moves)
        assert errs[name] <= max(1e-4, 8 * move), (name, errs[name], move)
    assert len(errs) == 103 and np.median(list(errs.values())) <= 1e-5
