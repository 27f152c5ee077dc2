"""The bf16 YOLACT (the JAX CLI's ``Yolact(dtype=jnp.bfloat16)``) of the port
against the JAX package's: the eval forward, the eval step and one train
step, on ``test_torch_yolact_step.py``'s set-up (64x96, batch 2, the JAX
package's weights drawn with numpy, the squares).  The backward on running
statistics: ``test_torch_yolact_bf16_grads.py``.

- **Forward** (BatchNorm on running statistics): each head of the port's
  forward against JAX's run op by op, by relative L2, within JAX's own
  spread, its compiled forward against its op-by-op one (XLA fuses casts
  away and sums in another order: ~0.6-1.1% here, with random BatchNorm
  scales).  The port rounds op by op as JAX's op-by-op graph does, but its
  convs sum in another order, so 50-70% of the outputs differ by a few
  bf16 ulps.
- **Eval step**: the losses within 2e-3 relative of JAX's compiled
  ``make_yolact_eval_step`` (half a bf16 step of 2^-8).
- **Train step**, chaotic in bf16: a 1e-6 input scale moves the port's
  own gradients by ~35% (median over the parameters), through bf16
  roundings that flip (ReLU and max-pool kinks, BatchNorm on batch
  statistics of 1x1 to 2x3 maps, background-confidence ties in OHEM's
  ranking).  So the yardstick is the port's largest move under input
  scales of 1 +- 1e-6, 1e-5 and 1e-4 (each below the 2^-8 resolution of a
  bf16 input), and each quantity is held to the larger of its bar and
  YARDSTICK (4) times that move: losses 1e-3 relative, gradients 1e-2 by
  relative L2, the BatchNorm statistics 1e-3; ``mask_clipped`` equal.
  These bars are loose (a gradient's can pass 1), so the backward is
  held where it is well conditioned, on running statistics
  (``test_torch_yolact_bf16_grads.py``).  The update of the port's own Adam
  step is not held in bf16: Adam's first update is ~lr sign(gradient),
  and the signs of elements near 0 flip between any two executions (on
  running statistics JAX's compiled update lies 27% (median) and up to
  71% from its op-by-op one).  The optimizer itself is held: fed JAX's
  own gradients, it lands on JAX's parameters within 1e-7, three steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.weights import yolact_state_dict_from_flax
from test_torch_yolact_step import (
    CFG,
    LOSS_FIELDS,
    H,
    W,
    batch,
    check_step,
    eval_losses,
    rel_l2,
    step_setup,
)
from torch_parity import jax_yolact_config, random_variables, torch_threads

BF16_BARS = dict(loss=1e-3, grad=1e-2, stats=1e-3)
BF16_NUDGES = (1e-6, -1e-6, 1e-5, -1e-5, 1e-4, -1e-4)
EVAL_RTOL = 2e-3
HEADS = ("classification", "box_encoding", "mask_coeff", "mask_prototype")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def test_torch_yolact_bf16_forward_matches_jax():
    img, _ = batch()
    jax_model = JaxYolact(jax_yolact_config(CFG), dtype=jnp.bfloat16)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    op_by_op = jax_model.apply(variables, jnp.asarray(img), train=False)
    compiled = jax.jit(lambda v, x: jax_model.apply(v, x, train=False))(variables,
                                                                        jnp.asarray(img))
    model = Yolact(CFG, dtype=torch.bfloat16, device="cpu").eval()
    model.load_state_dict(yolact_state_dict_from_flax(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(img).permute(0, 3, 1, 2).contiguous())
    for head in HEADS:
        port = getattr(got, head)
        assert port.dtype == torch.float32, head
        want = np.asarray(getattr(op_by_op, head), np.float32)
        spread = rel_l2(np.asarray(getattr(compiled, head), np.float32), want)
        err = rel_l2(port.numpy(), want)
        assert 0 < err <= spread, (head, err, spread)


def test_torch_yolact_bf16_eval_step_matches_jax():
    want, got = eval_losses("bf16")
    assert int(got.mask_clipped) == int(want.mask_clipped)
    for field in LOSS_FIELDS:
        w, g = float(getattr(want, field)), float(getattr(got, field))
        assert abs(g - w) <= EVAL_RTOL * abs(w), (field, g, w)


def test_torch_yolact_train_step_bf16_matches_jax():
    check_step(step_setup("bf16", BF16_NUDGES), BF16_BARS, hold_update=False)
