"""Depthwise upsample of the PyTorch port against the JAX package.

The port's plain ``depthwise_upsample`` (``F.conv_transpose2d``, NCHW,
torch weight ``[C, 1, 2f, 2f]``) is held to ``DepthwiseUpsample(impl=
"dilated")`` and to the Pallas kernel in interpret mode (NHWC, kernel
``[2f, 2f, 1, C]``) within 1e-5 at f=2 and f=4, on random weights (the
reference trains them) and on the bilinear init.  In bf16, the served
dtype of the bf16 CenterNet, the plain version (the f32 one on the
upcast values, rounded once) is held to the dilated lowering in bf16
(input and kernel cast to bf16) and to the Pallas kernel in interpret
mode on a bf16 input with the kernel's weights rounded to bf16 (the
Pallas kernel keeps f32 weights; the bilinear init is exact in bf16):
equal or one bf16 ulp apart, the share that differs recorded.  The CUDA
kernel itself is compared on the card by test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.centerpoint_dla import (
    DepthwiseUpsample as JaxDepthwiseUpsample,
    _bilinear_kernel,
)
from tauv_vision_tpu.ops.pallas.depthwise_upsample import depthwise_upsample_pallas
from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.models.centerpoint_dla import DepthwiseUpsample
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_cuda,
)

CASES = [  # f, h, w, c, weight
    (2, 5, 7, 8, "random"),
    (4, 3, 5, 16, "random"),
    (2, 6, 10, 8, "bilinear"),
    (4, 6, 10, 64, "bilinear"),
]


def _inputs(f, h, w, c, weight, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, c)).astype(np.float32)  # NHWC
    if weight == "random":
        kern = rng.standard_normal((2 * f, 2 * f, 1, c)).astype(np.float32)
    else:
        kern = np.ascontiguousarray(np.broadcast_to(
            _bilinear_kernel(2 * f)[:, :, None, None], (2 * f, 2 * f, 1, c)
        ))
    return x, kern


def _port(x, kern, f, dtype=torch.float32):
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dtype)
    wt = torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous().to(dtype)  # [C,1,k,k]
    out = depthwise_upsample(xt, wt, f)
    assert out.dtype == dtype
    return out.float().permute(0, 2, 3, 1).numpy()


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_within_one_bf16_ulp(got, want, record_property):
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    record_property("share_differ", float((got != want).mean()))
    assert np.all(np.abs(got - want) <= ulp), float(np.max(np.abs(got - want) / ulp))


@pytest.mark.parametrize("f,h,w,c,weight", CASES)
def test_torch_depthwise_upsample_matches_dilated(f, h, w, c, weight):
    x, kern = _inputs(f, h, w, c, weight)
    want = JaxDepthwiseUpsample(f).apply({"params": {"kernel": jnp.asarray(kern)}},
                                         jnp.asarray(x))
    got = _port(x, kern, f)
    assert got.shape == (2, f * h, f * w, c)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,h,w,c,weight", CASES)
def test_torch_depthwise_upsample_matches_pallas_interpret(f, h, w, c, weight):
    x, kern = _inputs(f, h, w, c, weight, seed=1)
    want = depthwise_upsample_pallas(jnp.asarray(x), jnp.asarray(kern), f,
                                     interpret=True)
    np.testing.assert_allclose(_port(x, kern, f), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,h,w,c,weight", CASES)
def test_torch_depthwise_upsample_bf16_matches_dilated(f, h, w, c, weight, record_property):
    x, kern = _inputs(f, h, w, c, weight, seed=2)
    want = JaxDepthwiseUpsample(f, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jnp.asarray(kern)}}, jnp.asarray(x).astype(jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = _port(_bf16(x), kern, f, torch.bfloat16)
    _assert_within_one_bf16_ulp(got, np.asarray(want.astype(jnp.float32)), record_property)


@pytest.mark.parametrize("f,h,w,c,weight", CASES)
def test_torch_depthwise_upsample_bf16_matches_pallas_interpret(f, h, w, c, weight,
                                                                record_property):
    x, kern = _inputs(f, h, w, c, weight, seed=3)
    x, kern = _bf16(x), _bf16(kern)
    want = depthwise_upsample_pallas(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(kern), f,
                                     interpret=True)
    assert want.dtype == jnp.bfloat16
    got = _port(x, kern, f, torch.bfloat16)
    _assert_within_one_bf16_ulp(got, np.asarray(want.astype(jnp.float32)), record_property)


@pytest.mark.parametrize("f", [2, 4])
def test_torch_depthwise_upsample_module_init_is_bilinear(f):
    module = DepthwiseUpsample(16, f)
    want = np.broadcast_to(_bilinear_kernel(2 * f), (16, 1, 2 * f, 2 * f))
    np.testing.assert_array_equal(module.weight.detach().numpy(), want)
    x = torch.from_numpy(_inputs(f, 4, 6, 16, "bilinear")[0]).permute(0, 3, 1, 2)
    assert module(x.contiguous()).shape == (2, 16, 4 * f, 6 * f)


def test_torch_depthwise_upsample_wrapper_takes_plain_on_cpu():
    x, kern = _inputs(2, 5, 7, 8, "random")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    wt = torch.from_numpy(kern).permute(3, 2, 0, 1).contiguous()
    before = dict(kernels.LAUNCHES)
    got = depthwise_upsample_cuda(xt, wt, 2)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, depthwise_upsample(xt, wt, 2))
    with pytest.raises(ValueError):
        depthwise_upsample_cuda(xt, wt, 4)

