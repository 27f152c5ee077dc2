"""One train step of the DCN DLA-34 in the port against the JAX package's.

The reference's deployed net at full width, ``CenterpointDLA34(deform=
True)``, in f32 at 64x96 and batch 2, on the JAX package's weights drawn
with numpy (``torch_parity.random_variables``: offsets reach a few cells,
fractional, some samples leave the map) and carried over by
``weights.centerpoint_state_dict_from_flax``.  The JAX side is its own
training loss (``model.apply(train=True)``, ``centernet_loss`` and
``dcn_offset_penalty``, as ``train/steps.py`` builds it) under one jitted
``value_and_grad``, with ``dcn_impl="gather"``: the port's DCN samples
without a window, as gather does, and these offsets leave ``shift``'s
3-cell window here and there.  The data are the synthetic squares with
their corners as keypoints; samples_torpedo's lambdas, with the DCN
offset penalty on (lambda 0.1, range 1) so that it is held too.

The step is chaotic at this size: BatchNorm on batch statistics of the
deepest levels (2x3 maps, 12 values a channel), ReLU kinks and the DCN
make the gradients move by ~1% (median over the parameters, 64x96) when
the input moves by 1e-6 relative, in the port alone, and JAX sums in
another order than the port.  (In inference mode the same gradients
move by 2e-7: ``test_torch_train_grads.py`` holds them to JAX's at 1e-4.)
So each quantity is held to the larger of a bar and YARDSTICK times its
own move in the port when the input image is scaled by 1 + 1e-6, the
yardstick measured in the same run:

- every ``CenternetLosses`` field: 1e-5 relative;
- every parameter's gradient, by relative L2 (the norm of the
  difference over the norm of JAX's): 1e-4; a conv bias just before a
  BatchNorm on batch statistics has a gradient of 0 in exact arithmetic,
  so it is held by its size: below 1e-4 of its conv weight's gradient
  in both stacks;
- the BatchNorm running statistics after the step (but those of the two
  projections that JAX computes and discards and the port does not run,
  ``torch_parity.DISCARDED_PROJECTIONS``): 1e-5, with flax's
  biased batch variance (torch's unbiased one would be off by n / (n - 1)
  of the deepest levels' 12 values: 9%);
- the parameters after 3 Adam steps with global-norm clipping at 0.5
  (below every step's norm, so the clip bites): the update of each
  parameter, by relative L2: 1e-4.  Adam's first steps are close to
  lr * sign(gradient), so an element whose gradient is near 0 may step
  the other way on a small difference of its gradient.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import CenterpointDLA34 as JaxCenterpointDLA34
from tauv_vision_tpu.train.centernet_task import CenternetTruth as JaxTruth
from tauv_vision_tpu.train.centernet_task import centernet_loss as jax_centernet_loss
from tauv_vision_tpu.train.state import adam_with_clip as jax_adam_with_clip
from tauv_vision_tpu.train.steps import dcn_offset_penalty as jax_dcn_offset_penalty
from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip
from tauv_vision_tpu_torch.train.steps import make_centernet_train_step
from tauv_vision_tpu_torch.weights import centerpoint_state_dict_from_flax
from torch_parity import (
    DISCARDED_PROJECTIONS,
    jax_centernet_config,
    jax_object_config,
    jax_train_config,
    random_variables,
    square_configs,
    torch_threads,
)

H, W, BATCH = 64, 96, 2
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_TOL = 1e-5
# Nudged offsets: up to ~2 cells, 0.3 on average (see the docstring).
OFFSET_GAIN, OFFSET_BIAS = 0.3, 0.5
MAX_NORM = 0.5
N_ADAM = 3
UPDATE_RTOL = 1e-4
YARDSTICK = 4.0
NUDGE = 1 + 1e-6       # the yardstick's input perturbation


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rel_l2(port, want):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def setup():
    oc, mc = square_configs(H, W)
    tc = dataclasses.replace(samples_torpedo.train_config, loss_lambda_dcn_offset=0.1,
                             dcn_offset_range=1.0, grad_max_norm=MAX_NORM)
    jax_oc, jax_mc, jax_tc = jax_object_config(oc), jax_centernet_config(mc), jax_train_config(tc)
    jax_model = JaxCenterpointDLA34(object_config=jax_oc, deform=True, dcn_impl="gather")
    variables = random_variables(jax_model, (1, 32, 32, 3), 0, offset_gain=OFFSET_GAIN,
                                 offset_bias=OFFSET_BIAS)
    img, truth = generate_square_batch(np.random.default_rng(0), BATCH, SquareDatasetConfig(
        in_h=H, in_w=W, max_objects=4, min_side=8, max_side=16, keypoints=True))
    jax_truth = JaxTruth(**{f.name: None if getattr(truth, f.name) is None
                            else jnp.asarray(getattr(truth, f.name))
                            for f in dataclasses.fields(truth)})

    def loss_fn(params, batch_stats):
        prediction, mutated = jax_model.apply(
            {"params": params, "batch_stats": batch_stats}, jnp.asarray(img), train=True,
            mutable=["batch_stats", "intermediates"])
        losses = jax_centernet_loss(prediction, jax_truth, jax_mc, jax_tc, jax_oc)
        penalty = jax_dcn_offset_penalty(mutated["intermediates"], tc.dcn_offset_range)
        losses = losses.replace(dcn_offset=penalty,
                                total=losses.total + tc.loss_lambda_dcn_offset * penalty)
        return losses.total, (losses, mutated["batch_stats"])

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = jax_adam_with_clip(tc.lr, tc.grad_max_norm)
    # The optimizer compiled, as the JAX package's jitted train step runs it
    # (op by op it compiles each op of every parameter's shape, ~40 s here).
    update, apply_updates = jax.jit(tx.update), jax.jit(optax.apply_updates)
    global_norm = jax.jit(optax.global_norm)
    params, stats = variables["params"], variables["batch_stats"]
    opt_state = jax.jit(tx.init)(params)
    jax_steps = []
    for _ in range(N_ADAM):
        (_, (losses, new_stats)), grads = value_and_grad(params, stats)
        jax_steps.append((jax.device_get(losses), jax.device_get(grads),
                          jax.device_get(new_stats), float(global_norm(grads))))
        updates, opt_state = update(grads, opt_state, params)
        params, stats = apply_updates(params, updates), new_stats
    after = jax.device_get({"params": params, "batch_stats": stats})

    state_dict = centerpoint_state_dict_from_flax(variables)

    def port_state(max_norm):
        model = CenterpointDLA34(oc, deform=True, device="cpu")
        model.load_state_dict(state_dict, strict=True)
        return TrainState(model, adam_with_clip(model.parameters(), tc.lr, max_norm))

    def raw_step(state, x):
        """The first Adam step, and a copy of the model as a step whose clip
        never bites leaves it: its BatchNorm statistics, and the raw
        gradients in ``.grad`` (the clip scales them in place)."""
        model, grads = state.model, {}
        hook = state.optimizer.register_step_pre_hook(lambda *_: grads.update(
            {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}))
        try:
            state, losses = step(state, x, port_truth)
        finally:
            hook.remove()
        raw = copy.deepcopy(model)
        for name, p in raw.named_parameters():
            p.grad = grads.get(name)
        return state, losses, raw

    port_img = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    port_truth = truth.to("cpu")
    step = make_centernet_train_step(mc, tc, oc)
    port = {}
    for key, x in (("port", port_img), ("nudged", port_img * NUDGE)):
        state, losses, raw = raw_step(port_state(MAX_NORM), x)
        for _ in range(N_ADAM - 1):
            state, _ = step(state, x, port_truth)
        port[key] = dict(raw=raw, losses=losses, adam=state)
    return dict(variables=variables, jax_steps=jax_steps, after=after, **port)


def bar(base, port, nudged):
    """The larger of ``base`` and YARDSTICK times the port's own relative
    move under the input nudge."""
    return max(base, YARDSTICK * rel_l2(nudged, port))


def test_torch_train_step_losses_match_jax(setup):
    port, nudged = setup["port"]["losses"], setup["nudged"]["losses"]
    want = setup["jax_steps"][0][0]
    assert float(want.dcn_offset) > 0 and float(want.keypoint_heatmap) > 0
    for field in dataclasses.fields(port):
        p, w = getattr(port, field.name), np.asarray(getattr(want, field.name))
        if not w.any():
            assert not p.any(), field.name
            continue
        err = rel_l2(p, w)
        assert err <= bar(LOSS_RTOL, p, getattr(nudged, field.name)), (field.name, err)


def test_torch_train_step_grads_match_jax(setup):
    _, grads, new_stats, _ = setup["jax_steps"][0]
    want = centerpoint_state_dict_from_flax({"params": grads, "batch_stats": new_stats})
    named = dict(setup["port"]["raw"].named_parameters())
    nudged = dict(setup["nudged"]["raw"].named_parameters())
    assert set(named) <= set(want)
    errs, bad = {}, {}
    for name, p in named.items():
        if name.endswith("conv.bias"):   # a DCN conv's bias, before its BatchNorm
            weight = name[:-len("bias")] + "weight"
            for g, gw in ((p.grad, named[weight].grad), (want[name], want[weight])):
                assert g.norm() <= GRAD_RTOL * gw.norm(), name
            continue
        if not want[name].any():
            # Read by nothing, or by a zero lambda: 0 in both.
            assert p.grad is None or not p.grad.any(), name
            continue
        errs[name] = rel_l2(p.grad, want[name])
        if errs[name] > bar(GRAD_RTOL, p.grad, nudged[name].grad):
            bad[name] = errs[name]
    assert len(errs) > 230
    assert not bad, bad


def test_torch_train_step_batch_stats_match_jax(setup):
    _, _, new_stats, _ = setup["jax_steps"][0]
    want = centerpoint_state_dict_from_flax({"params": setup["variables"]["params"],
                                             "batch_stats": new_stats})
    buffers = dict(setup["port"]["raw"].named_buffers())
    nudged = dict(setup["nudged"]["raw"].named_buffers())
    stats = [n for n in buffers if n.endswith(("running_mean", "running_var"))
             and not n.startswith(DISCARDED_PROJECTIONS)]
    assert len(stats) == 106
    bad = {}
    for name in stats:
        err = rel_l2(buffers[name], want[name])
        if err > bar(STATS_TOL, buffers[name], nudged[name]):
            bad[name] = err
    assert not bad, bad


def test_torch_adam_steps_match_jax(setup):
    assert all(norm > MAX_NORM for _, _, _, norm in setup["jax_steps"])
    state, nudged = setup["port"]["adam"], setup["nudged"]["adam"].model.state_dict()
    assert state.step == N_ADAM
    before = centerpoint_state_dict_from_flax(setup["variables"])
    want = centerpoint_state_dict_from_flax(setup["after"])
    port = state.model.state_dict()
    errs, bad = {}, {}
    for name, p in state.model.named_parameters():
        moved = want[name] - before[name]
        if not moved.any():
            assert torch.equal(p.detach(), before[name]), name
            continue
        errs[name] = rel_l2(p.detach() - before[name], moved)
        if errs[name] > bar(UPDATE_RTOL, p.detach() - before[name], nudged[name] - before[name]):
            bad[name] = errs[name]
    assert len(errs) > 250
    assert not bad, bad
    for name in port:
        if (name.endswith(("running_mean", "running_var"))
                and not name.startswith(DISCARDED_PROJECTIONS)):
            err = rel_l2(port[name], want[name])
            assert err <= bar(STATS_TOL, port[name], nudged[name]), (name, err)
