"""The backward of the port's bf16 YOLACT against the JAX package's, where
it is well conditioned: BatchNorm on running statistics, on
``test_torch_yolact_step.py``'s set-up (64x96, batch 2, the JAX package's
weights drawn with numpy, the squares, the mask loss capped at 16).

Each parameter's gradient is held against JAX's ``jax.grad`` of
``Yolact(dtype=jnp.bfloat16)`` run op by op (the net's VJP eager, fed the
compiled gradient of the f32 loss), by relative L2, within GRAD_SPREADS
(3) times JAX's own spread: its compiled gradient against that one
(median 7%, 0.01-16.5% here).  Every such bar is below 0.5, so that no
zero or halved gradient passes.  The port's median error is no more than
JAX's median spread (4% against 7%).

Past its bar a gradient passes only if it is a bias and lies nearer
JAX's f32 gradient than JAX's bf16 one does.  The protonet's biases sum
their gradient over the whole prototype map, and there JAX's bf16 sum
lies 2-9x farther from the f32 gradient than the port's (the output
layer's: 8.3% against 0.96%, while JAX's two executions agree within
0.01%).  Three biases take that way.

With BatchNorm on batch statistics the bf16 step is chaotic and held by
the port's own move (``test_torch_yolact_bf16.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu.train.yolact_task import yolact_loss as jax_yolact_loss
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.train.yolact_task import yolact_loss
from tauv_vision_tpu_torch.weights import yolact_state_dict_from_flax
from test_torch_yolact_step import (
    CFG,
    UNTRAINED,
    H,
    W,
    batch,
    jax_truth,
    rel_l2,
    train_config,
)
from torch_parity import (
    jax_yolact_config,
    jax_yolact_train_config,
    random_variables,
    torch_threads,
)

GRAD_SPREADS = 3.0
MAX_BAR = 0.5
NEARER_BIASES = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def jax_grads():
    """JAX's bf16 YOLACT on the set-up's weights and batch, BatchNorm on
    running statistics: its parameter gradients op by op (the net's VJP
    eager, fed the compiled gradient of the f32 loss) and compiled, and
    the f32 model's compiled gradients, as the port's state dicts; the
    variables, frames and truth."""
    img, truth = batch()
    jcfg, jtc = jax_yolact_config(CFG), jax_yolact_train_config(train_config())
    jax_model = JaxYolact(jcfg, dtype=jnp.bfloat16)
    variables = random_variables(jax_model, (1, H, W, 3), 0)
    jt = jax_truth(truth)

    def net(params, model=jax_model):
        return model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(img), train=False)

    def loss(prediction):
        return jax_yolact_loss(prediction, jt, jcfg, jtc).total

    def state_dict(grads):
        return yolact_state_dict_from_flax({"params": jax.device_get(grads),
                                            "batch_stats": variables["batch_stats"]})

    op_by_op, vjp = jax.vjp(net, variables["params"])
    (grads,) = vjp(jax.jit(jax.grad(loss))(op_by_op))
    compiled = jax.jit(jax.grad(lambda p: loss(net(p))))(variables["params"])
    f32_model = JaxYolact(jcfg)
    f32 = jax.jit(jax.grad(lambda p: loss(net(p, f32_model))))(variables["params"])
    return (state_dict(grads), state_dict(compiled), state_dict(f32)), variables, img, truth


def test_torch_yolact_bf16_grads_running_stats_match_jax():
    (want, compiled, f32), variables, img, truth = jax_grads()
    model = Yolact(CFG, dtype=torch.bfloat16, device="cpu").eval()
    model.load_state_dict(yolact_state_dict_from_flax(variables))
    x = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    yolact_loss(model(x), truth.to("cpu"), CFG, train_config()).total.backward()
    errs, spreads, nearer = {}, {}, []
    for name, p in model.named_parameters():
        if name.startswith(UNTRAINED):
            assert not want[name].any() and not p.grad.any(), name
            continue
        spreads[name] = rel_l2(compiled[name], want[name])
        errs[name] = rel_l2(p.grad, want[name])
        assert GRAD_SPREADS * spreads[name] < MAX_BAR, (name, spreads[name])
        if errs[name] > GRAD_SPREADS * spreads[name]:
            assert name.endswith(".bias") and (
                rel_l2(p.grad, f32[name]) < rel_l2(want[name], f32[name])), (
                name, errs[name], spreads[name])
            nearer.append(name)
    assert len(errs) == 103 and len(nearer) <= NEARER_BIASES, nearer
    assert np.median(list(errs.values())) <= np.median(list(spreads.values()))
