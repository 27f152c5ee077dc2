"""``bench.py --host-io`` in the port (``serving/host_io.py``,
``ops.masks.pack_masks``, ``configs.HOST_IO``), on the CPU.

- ``pack_masks`` equals ``jnp.packbits(x > 0.5, axis=-1)`` bit for bit at
  widths 320 (the served prototypes'), 13 and 8, with values planted at
  0.5 and one f32 ulp either side of it.
- ``raw_source`` and ``png_source`` yield the frames that ``write_frames``
  wrote, byte for byte (PNG is lossless), in order, pass after pass.
- ``HOST_IO``'s pair, the chain-int8 CenterNet (the full-width DLA-34) and
  a narrow chain-int8 YOLACT at 72x104, through the executor from the raw
  ring: every output, packed masks included, equal to the sequential call
  of the same pipeline on the same batch, and the bitmaps unpack to
  ``mask > 0.5`` of the unpacked pipeline's masks.
- The port's plain decode, packed, equals ``jnp.packbits`` of the JAX
  decode's masks on one shared prediction.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tauv_vision_tpu.models.yolact import YolactPrediction as JaxYolactPrediction
from tauv_vision_tpu.serving.yolact_decode import decode_yolact as jax_decode_yolact
from tauv_vision_tpu_torch.configs import CHAIN_INT8, HOST_IO, centernet_config, yolact_config
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact, YolactPrediction
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.ops.masks import pack_masks
from tauv_vision_tpu_torch.serving.executor import ServingExecutor, tree_map
from tauv_vision_tpu_torch.serving.host_io import (
    host_io_pipeline,
    png_source,
    raw_source,
    write_frames,
)
from tauv_vision_tpu_torch.serving.pipeline import IMAGENET_MEAN, IMAGENET_STDDEV, DecodeKnobs
from tauv_vision_tpu_torch.serving.quantize import calibrate, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import (
    make_centernet_chain_pipeline,
    make_yolact_chain_pipeline,
)
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact
from tauv_vision_tpu_torch.weights import centerpoint_calibration_paths
from torch_parity import jax_yolact_config, torch_threads

H, W = 72, 104
ALL_SLOTS = DecodeKnobs(score_threshold=0.0, confidence_threshold=0.0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("width", [320, 13, 8])
def test_torch_pack_masks_matches_packbits(width):
    rng = np.random.default_rng(width)
    x = rng.random((2, 5, 7, width)).astype(np.float32)
    half = np.float32(0.5)
    for i, v in enumerate((half, np.nextafter(half, np.float32(0)),
                           np.nextafter(half, np.float32(1)))):
        x[..., i::3][..., ::2] = v
    want = np.asarray(jnp.packbits(jnp.asarray(x) > 0.5, axis=-1))
    got = pack_masks(torch.from_numpy(x))
    assert got.dtype == torch.uint8 and got.shape == want.shape == (2, 5, 7, -(-width // 8))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.unpackbits(got.numpy(), axis=-1)[..., :width], (x > 0.5).astype(np.uint8))
    np.testing.assert_array_equal(pack_masks(torch.from_numpy(x), threshold=0.25).numpy(),
                                  np.packbits(x > 0.25, axis=-1))


def test_torch_host_io_sources_yield_the_written_frames(tmp_path):
    frames = np.random.default_rng(0).integers(0, 256, (7, 12, 20, 3), np.uint8)
    raw_path, png_dir = write_frames(tmp_path, frames)
    assert sorted(p.name for p in png_dir.iterdir())[:2] == ["000000.png", "000001.png"]
    want = [frames[i:i + 2] for i in (0, 2, 4)] * 2   # the short last batch dropped
    for source in (raw_source(raw_path, 2, reps=2), png_source(png_dir, 2, reps=2)):
        got = list(source)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def chain_pair():
    """(CenterNet chain pipeline, YOLACT chain pipeline) of ``HOST_IO``'s
    recipe on the CPU at 72x104: per-tensor scales of 2 frames."""
    recipe = HOST_IO.pair
    assert recipe == CHAIN_INT8
    oc, cn_cfg = centernet_config(H, W)
    cn = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(0), device="cpu",
                          up_impl="plain", **recipe.centernet_kwargs()).eval()
    yl = Yolact(yolact_config(H, W, feature_depth=32),
                generator=torch.Generator().manual_seed(1), device="cpu").eval()
    cal = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 80, 96, 3), np.uint8))
    with torch.inference_mode():
        cn_img = preprocess(cal, (H, W), IMAGENET_MEAN, IMAGENET_STDDEV, recipe.input_dtype)
        yl_img = preprocess(cal, (H, W), yl.config.img_mean, yl.config.img_stddev)
    cn_scales = calibrate(cn, [cn_img], paths_of=centerpoint_calibration_paths)
    yl_scales = strip_scales(calibrate(yl, [yl_img], per_channel=recipe.yolact.per_channel),
                             recipe.yolact.float_paths)
    return (make_centernet_chain_pipeline(cn, cn_cfg, cn_scales, "cpu", ALL_SLOTS,
                                          dtype=recipe.input_dtype, impl="plain"),
            make_yolact_chain_pipeline(yl, yl_scales, "cpu", ALL_SLOTS, dtype=recipe.yolact.dtype,
                                       join_dtype=recipe.yolact.join_dtype, impl="plain"))


def test_torch_host_io_pair_through_executor_equals_sequential(chain_pair, tmp_path):
    cn_pipe, yl_pipe = chain_pair
    frames = np.random.default_rng(3).integers(0, 256, (4, 80, 96, 3), np.uint8)
    raw_path, _ = write_frames(tmp_path, frames)
    pipeline = host_io_pipeline(cn_pipe, yl_pipe)
    executor = ServingExecutor(pipeline, prefetch=HOST_IO.prefetch, device="cpu")
    got = list(executor.run(raw_source(raw_path, 2)))
    assert len(got) == 2
    for i, (cn_out, yl_out) in enumerate(got):
        batch = torch.from_numpy(frames[2 * i:2 * i + 2])
        want = tree_map(torch.Tensor.numpy, pipeline(batch))
        for g, w in zip((cn_out, yl_out), want):
            for name, value in vars(w).items():
                if value is None:
                    assert getattr(g, name) is None
                else:
                    np.testing.assert_array_equal(getattr(g, name), value, err_msg=name)
        assert yl_out.mask.dtype == np.uint8 and yl_out.mask.shape[-1] == -(-(W // 2) // 8)
        unpacked = yl_pipe(batch).mask.numpy()
        assert 0 < (unpacked > 0.5).mean() < 1
        np.testing.assert_array_equal(
            np.unpackbits(yl_out.mask, axis=-1)[..., :unpacked.shape[-1]],
            (unpacked > HOST_IO.mask_threshold).astype(np.uint8))
        assert cn_out.score.shape == (2, ALL_SLOTS.n_detections)


def test_torch_packed_decode_matches_jax_packbits():
    cfg = yolact_config(H, W, feature_depth=32)
    rng = np.random.default_rng(6)
    b, n, p, c = 2, 60, cfg.n_prototype_masks, cfg.n_classes + 1
    arrays = dict(
        classification=rng.normal(size=(b, n, c)).astype(np.float32) * 2,
        box_encoding=rng.normal(size=(b, n, 4)).astype(np.float32),
        mask_coeff=np.tanh(rng.normal(size=(b, n, p))).astype(np.float32),
        anchor=np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))],
                              -1).astype(np.float32),
        mask_prototype=rng.normal(size=(b, H // 2, W // 2, p)).astype(np.float32),
    )
    want = jax_decode_yolact(JaxYolactPrediction(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                             jax_yolact_config(cfg), 8, 0.5, 0.2)
    got = decode_yolact(YolactPrediction(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                        cfg, 8, 0.5, 0.2, impl="plain")
    got = dataclasses.replace(got, mask=pack_masks(got.mask))
    mask = np.asarray(want.mask)
    assert 0 < (mask > 0.5).mean() < 1
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jnp.packbits(want.mask > 0.5,
                                                                             axis=-1)))
