"""The port's gradients against JAX autodiff with BatchNorm on running
statistics, where the function is far better conditioned than with batch
statistics.

The DCN DLA-34 (``deform=True``, full width, f32, 64x96, batch 2): the
gradient of the training loss (samples_torpedo's lambdas, the DCN offset
penalty on) with respect to every parameter against JAX's
``value_and_grad`` (``dcn_impl="gather"``, the port's DCN semantics), on
the JAX package's weights with nudged offsets.  This holds the backward
itself: kernels C and E under autograd, the f32 casts, the DCN's plain
backward and the heads.  Most gradients barely move when the input moves
by 1e-6 relative; a few on the deepest levels (4x6 maps and smaller,
where one ReLU or max-pool decision weighs on a sum of a few dozen
terms) move far more.  So each is held to the larger of 1e-4
relative L2 and YARDSTICK times its own move in the port when the input
is scaled by 1 +- 1e-6; the median over the parameters to 1e-5.  (With
batch statistics the gradients move by ~1%: ``test_torch_train_step.py``.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import CenterpointDLA34 as JaxCenterpointDLA34
from tauv_vision_tpu.train.centernet_task import CenternetTruth as JaxTruth
from tauv_vision_tpu.train.centernet_task import centernet_loss as jax_centernet_loss
from tauv_vision_tpu.train.steps import dcn_offset_penalty as jax_dcn_offset_penalty
from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data.synthetic import SquareDatasetConfig, generate_square_batch
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34, sow_dcn_offsets
from tauv_vision_tpu_torch.train.centernet_task import centernet_loss
from tauv_vision_tpu_torch.train.steps import dcn_offset_penalty
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
GRAD_RTOL = 1e-4
MEDIAN_RTOL = 1e-5
YARDSTICK = 8.0
NUDGE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rel_l2(port, want):
    port, want = np.asarray(port, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(port - want) / max(np.linalg.norm(want), 1e-30)


def test_torch_inference_mode_grads_match_jax():
    oc, mc = square_configs(H, W)
    tc = dataclasses.replace(samples_torpedo.train_config, loss_lambda_dcn_offset=0.1,
                             dcn_offset_range=0.25)
    jax_oc, jax_mc, jax_tc = jax_object_config(oc), jax_centernet_config(mc), jax_train_config(tc)
    jax_model = JaxCenterpointDLA34(object_config=jax_oc, deform=True, dcn_impl="gather")
    variables = random_variables(jax_model, (1, 32, 32, 3), 1, offset_gain=0.3,
                                 offset_bias=0.5)
    img, truth = generate_square_batch(np.random.default_rng(1), BATCH, SquareDatasetConfig(
        in_h=H, in_w=W, max_objects=4, min_side=8, max_side=16, keypoints=True))
    jax_truth = JaxTruth(**{f.name: None if getattr(truth, f.name) is None
                            else jnp.asarray(getattr(truth, f.name))
                            for f in dataclasses.fields(truth)})

    def loss_fn(params):
        prediction, mutated = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(img),
            train=False, mutable=["intermediates"])
        losses = jax_centernet_loss(prediction, jax_truth, jax_mc, jax_tc, jax_oc)
        penalty = jax_dcn_offset_penalty(mutated["intermediates"], tc.dcn_offset_range)
        return losses.total + tc.loss_lambda_dcn_offset * penalty

    value, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = centerpoint_state_dict_from_flax(
        {"params": jax.device_get(grads), "batch_stats": variables["batch_stats"]})

    port_img = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()

    def port_grads(x):
        model = CenterpointDLA34(oc, deform=True, device="cpu").eval()
        model.load_state_dict(centerpoint_state_dict_from_flax(variables), strict=True)
        with sow_dcn_offsets(model) as offsets:
            losses = centernet_loss(model(x), truth.to("cpu"), mc, tc, oc)
        penalty = dcn_offset_penalty(offsets, tc.dcn_offset_range)
        assert len(offsets) == 16 and float(penalty.detach()) > 0
        total = losses.total + tc.loss_lambda_dcn_offset * penalty
        total.backward()
        return total.detach(), model

    total, model = port_grads(port_img)
    nudged = [dict(port_grads(port_img * (1 + sign * NUDGE))[1].named_parameters())
              for sign in (1, -1)]
    assert rel_l2(total, value) < 1e-5

    errs, bad = {}, {}
    for name, p in model.named_parameters():
        if not want[name].any():
            # Read by nothing, or by a zero lambda: 0 in both.
            assert p.grad is None or not p.grad.any(), name
            continue
        errs[name] = rel_l2(p.grad, want[name])
        move = max(rel_l2(n[name].grad, p.grad) for n in nudged)
        if errs[name] > max(GRAD_RTOL, YARDSTICK * move):
            bad[name] = (errs[name], move)
    assert len(errs) == 281 - 4 - sum(n.startswith(DISCARDED_PROJECTIONS)
                                      for n, _ in model.named_parameters())
    assert not bad, bad
    assert np.median(list(errs.values())) < MEDIAN_RTOL
