"""Probe P1's plain versions against the JAX probe's kernel bodies.

The bodies are closures inside ``tauv_vision_tpu/scripts/mosaic_op_probe
.main()``, so each is restated here, line for line, with the lines it
copies cited, and run through ``pl.pallas_call(..., interpret=True)`` on
the same inputs at a few iterations.  Copies, decimations and the
transpose must be bit-equal (the slice copy on buffer rows 3-15: the JAX
kernel never writes rows 0-2, which the port zeroes); the dot within 1e-4
(f32 sums of the same exact bf16 products in another order).  The CUDA
kernels are held to these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.scripts import op_probe

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _jax(t: torch.Tensor):
    """The same values as a JAX array (bf16 through its exact f32)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _call(kernel, out_shape, scratch, *args):
    return pl.pallas_call(kernel, out_shape=out_shape, in_specs=[VMEM] * len(args),
                          out_specs=VMEM, scratch_shapes=[scratch], interpret=True)(*args)


def jax_dot(w, x, n_iter, banks=4):
    """mosaic_op_probe.py:100-115 (``matmul_kernel``'s body)."""
    m, k = w.shape

    def kernel(w_ref, x_ref, out_ref, acc_ref):
        def body(i, _):
            off = (i % 2) * k
            rhs = x_ref[pl.ds(off, k), :]
            d = jax.lax.dot_general(w_ref[:, :], rhs, dimension_numbers=(((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            slot = (i % banks) * m
            acc_ref[pl.ds(slot, m), :] += d
            return 0

        acc_ref[:, :] = jnp.zeros_like(acc_ref)
        jax.lax.fori_loop(0, n_iter, body, 0)
        out_ref[:, :] = acc_ref[pl.ds(0, m), :]

    n = x.shape[1]
    return _call(kernel, jax.ShapeDtypeStruct((m, n), jnp.float32),
                 pltpu.VMEM((banks * m, n), jnp.float32), w, x)


def jax_slice_copy(x, n_iter):
    """mosaic_op_probe.py:172-182 (``copy_kernel``'s body)."""
    def kernel(x_ref, out_ref, buf_ref):
        def body(i, _):
            j = i % 16
            buf_ref[pl.ds(3, 16), :] = x_ref[j, :, :]
            buf_ref[pl.ds(21, 16), :] = x_ref[j + 1, :, :]
            buf_ref[pl.ds(40, 16), :] = x_ref[j + 2, :, :]
            return 0

        jax.lax.fori_loop(0, n_iter, body, 0)
        out_ref[:, :] = buf_ref[pl.ds(0, 16), :]

    return _call(kernel, jax.ShapeDtypeStruct((16, 642), jnp.bfloat16),
                 pltpu.VMEM((160, 642), jnp.bfloat16), x)


def jax_lane_shift(x, n_iter):
    """mosaic_op_probe.py:211-219 (``shift_kernel``'s body)."""
    def kernel(x_ref, out_ref, buf_ref):
        def body(i, _):
            j = i % 16
            buf_ref[pl.ds(0, 16), :] = x_ref[j, :, 1:641]
            buf_ref[pl.ds(16, 16), :] = x_ref[j, :, 2:642]
            return 0

        jax.lax.fori_loop(0, n_iter, body, 0)
        out_ref[:, :] = buf_ref[pl.ds(0, 16), :]

    return _call(kernel, jax.ShapeDtypeStruct((16, 640), jnp.bfloat16),
                 pltpu.VMEM((32, 640), jnp.bfloat16), x)


def jax_decimate(x, n_iter, variant):
    """mosaic_op_probe.py:248-261 (``decim_kernel``'s body)."""
    def kernel(x_ref, out_ref, buf_ref):
        def body(i, _):
            j = i % 8
            if variant == "strided":
                buf_ref[:, :] = x_ref[j, :, ::2]
            elif variant == "reshape_minor":
                buf_ref[:, :] = x_ref[j].reshape(32, 320, 2)[:, :, 0]
            else:  # transpose_first: [640,32]->[320,2,32]->[:,0,:]
                t = x_ref[j].T
                buf_ref[:, :] = t.reshape(320, 2, 32)[:, 0, :].T
            return 0

        jax.lax.fori_loop(0, n_iter, body, 0)
        out_ref[:, :] = buf_ref[:, :]

    return _call(kernel, jax.ShapeDtypeStruct((32, 320), jnp.float32),
                 pltpu.VMEM((32, 320), jnp.float32), x)


def jax_transpose(x, n_iter):
    """mosaic_op_probe.py:294-301 (``transpose_kernel``'s body)."""
    def kernel(x_ref, out_ref, buf_ref):
        def body(i, _):
            j = i % 8
            buf_ref[:, :] = x_ref[j].T.astype(jnp.bfloat16)
            return 0

        jax.lax.fori_loop(0, n_iter, body, 0)
        out_ref[:, :] = buf_ref[:, :]

    return _call(kernel, jax.ShapeDtypeStruct((320, 32), jnp.bfloat16),
                 pltpu.VMEM((320, 32), jnp.bfloat16), x)


@pytest.mark.parametrize("k,m,n", [(16, 16, 640), (144, 32, 640), (256, 128, 640)])
@pytest.mark.parametrize("n_iter", [1, 6])
def test_torch_op_probe_dot_matches_jax(k, m, n, n_iter, record_property):
    w, x = op_probe.dot_inputs(m, k, n)
    got = op_probe.dot(w, x, n_iter)
    want = _np(jax_dot(_jax(w), _jax(x), n_iter))
    record_property("max_abs_err", float(np.abs(got.numpy() - want).max()))
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_iter", [1, 5, 8])
def test_torch_op_probe_copies_match_jax(n_iter):
    x = op_probe.copy_input()
    got = op_probe.slice_copy(x, n_iter).float().numpy()
    want = _np(jax_slice_copy(_jax(x), n_iter))
    np.testing.assert_array_equal(got[3:], want[3:])
    np.testing.assert_array_equal(got[:3], 0.0)
    got = op_probe.lane_shift(x, n_iter).float().numpy()
    np.testing.assert_array_equal(got, _np(jax_lane_shift(_jax(x), n_iter)))


@pytest.mark.parametrize("variant", op_probe.DECIMATE_VARIANTS)
def test_torch_op_probe_decimate_matches_jax(variant):
    x = op_probe.decimate_input()
    got = op_probe.decimate(x, 7, variant).numpy()
    np.testing.assert_array_equal(got, _np(jax_decimate(_jax(x), 7, variant)))
    np.testing.assert_array_equal(got, x[6, :, ::2].numpy())


def test_torch_op_probe_transpose_matches_jax():
    x = op_probe.transpose_input()
    got = op_probe.transpose(x, 5)
    assert got.dtype == torch.bfloat16 and got.shape == (320, 32)
    np.testing.assert_array_equal(got.float().numpy(), _np(jax_transpose(_jax(x), 5)))


def test_torch_op_probe_wrappers_take_plain_on_cpu():
    before = dict(kernels.LAUNCHES)
    w, x = op_probe.dot_inputs(16, 16, 640)
    assert torch.equal(op_probe.dot_cuda(w, x, 3), op_probe.dot(w, x, 3))
    xc = op_probe.copy_input()
    assert torch.equal(op_probe.slice_copy_cuda(xc, 2), op_probe.slice_copy(xc, 2))
    assert torch.equal(op_probe.lane_shift_cuda(xc, 2), op_probe.lane_shift(xc, 2))
    xd = op_probe.decimate_input()
    assert torch.equal(op_probe.decimate_cuda(xd, 2, "transpose_first"), op_probe.decimate(xd, 2))
    xt = op_probe.transpose_input()
    assert torch.equal(op_probe.transpose_cuda(xt, 2), op_probe.transpose(xt, 2))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        op_probe.decimate(xd, 1, "gather")
