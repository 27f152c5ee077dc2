"""The pair's int8 profiles of ``bench.py``: ``--parity-int8`` (with its
``--mse``, ``--bias-correct`` and ``--seq-correct`` options) and
``--per-layer-int8`` (``configs.PARITY_INT8``, ``configs.PER_LAYER_INT8``).

``calibrate_pair`` calibrates the CenterNet and the YOLACT of a recipe on
uint8 frames as ``bench.py`` does (``bench.py:1412-1511``): each net's own
image of the first frames, ``calibrate`` per tensor or per channel, the
recipe's float paths stripped, then the options in ``bench.py``'s order
(MSE-refined scales, bias corrections, sequential fits that replace
them).  ``make_int8_pair_pipelines`` serves the two requests that
``bench.py`` times on the same frames: the CenterNet and the YOLACT as
int8 chains (``serving/quantize_chain.py``) or through ``quantized_call``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from tauv_vision_tpu_torch.configs import (
    CALIBRATION_FRAMES,
    SEQ_FRAMES,
    CenternetModelConfig,
    Int8PairRecipe,
    Int8Scales,
)
from tauv_vision_tpu_torch.device import DEFAULT_DEVICE
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.ops.image import preprocess
from tauv_vision_tpu_torch.serving.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STDDEV,
    SERVING_DECODE,
    DecodeKnobs,
    make_centernet_pipeline,
    make_yolact_pipeline,
)
from tauv_vision_tpu_torch.serving.quantize import (
    calibrate,
    calibrate_bias_correction,
    quantized_call,
    refine_scales_mse,
    strip_scales,
)
from tauv_vision_tpu_torch.serving.quantize_chain import (
    calibrate_sequential,
    dla34_chain_forward,
    make_centernet_chain_pipeline,
    make_yolact_chain_pipeline,
    yolact_chain_forward,
)
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_flax_path,
    yolact_flax_path,
)


@dataclass
class NetCalibration:
    """One net's calibration: its scales, and the chain's gains and
    corrections (None where the recipe makes none)."""

    scales: Dict[str, Any]
    gains: Optional[Dict[str, Any]] = None
    corrections: Optional[Dict[str, Any]] = None


def _images(frames: torch.Tensor, out_hw, mean, stddev, dtype) -> torch.Tensor:
    with torch.inference_mode():
        return preprocess(frames, out_hw, mean, stddev, dtype)


def _calibrate_net(recipe: Int8PairRecipe, chain: Int8Scales, model, frames, out_hw, mean,
                   stddev, paths_of, path_of, chain_forward, impl) -> NetCalibration:
    dtype = recipe.input_dtype
    img = _images(frames[:CALIBRATION_FRAMES], out_hw, mean, stddev, dtype)
    cal = NetCalibration(strip_scales(
        calibrate(model, [img], per_channel=chain.per_channel, paths_of=paths_of),
        chain.float_paths))
    if recipe.per_layer:
        return cal
    if recipe.mse:
        cal.scales = refine_scales_mse(model, [img], cal.scales, paths_of=paths_of)
    if recipe.bias_correct:
        cal.corrections = calibrate_bias_correction(model, [img], cal.scales,
                                                    paths_of=paths_of)
    if recipe.seq_correct:
        def build_forward(ctx):
            forward = chain_forward(ctx)
            return lambda f: forward(_images(f, out_hw, mean, stddev, dtype))

        cal.gains, cal.corrections = calibrate_sequential(
            build_forward, model, cal.scales, frames[:SEQ_FRAMES], dtype=dtype,
            path_of=path_of, impl=impl)
    return cal


def calibrate_pair(recipe: Int8PairRecipe, cn: CenterpointDLA34,
                   cn_config: CenternetModelConfig, yl: Yolact, frames: torch.Tensor,
                   impl: str = "kernel") -> Tuple[NetCalibration, NetCalibration]:
    """(the CenterNet's calibration, the YOLACT's) of ``recipe`` on uint8
    NHWC ``frames`` on the nets' device: ``cn`` is the model of
    ``recipe.centernet``, ``yl`` the YOLACT in ``recipe.input_dtype``.
    ``impl`` picks the kernels or their plain versions for the
    sequential passes."""
    cn_cal = _calibrate_net(recipe, recipe.centernet_scales, cn, frames,
                            (cn_config.in_h, cn_config.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                            centerpoint_calibration_paths, centerpoint_flax_path,
                            dla34_chain_forward, impl)
    yl_cfg = yl.config
    yl_cal = _calibrate_net(recipe, recipe.yolact_scales, yl, frames,
                            (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean, yl_cfg.img_stddev,
                            yolact_flax_path, yolact_flax_path, yolact_chain_forward, impl)
    return cn_cal, yl_cal


def make_int8_pair_pipelines(recipe: Int8PairRecipe, cn: CenterpointDLA34,
                             cn_config: CenternetModelConfig, yl: Yolact,
                             calibration: Tuple[NetCalibration, NetCalibration],
                             device=DEFAULT_DEVICE, knobs: DecodeKnobs = SERVING_DECODE,
                             impl: str = "kernel"):
    """(CenterNet pipeline, YOLACT pipeline): uint8 frames -> detections,
    the two requests of ``recipe`` on ``calibrate_pair``'s
    ``calibration``, each preprocessing its own image in
    ``recipe.input_dtype``: the int8 chains
    (``make_centernet_chain_pipeline``, ``make_yolact_chain_pipeline``,
    with f32 joins) or, on ``PER_LAYER_INT8``, the models through
    ``quantized_call``.  ``impl`` picks kernels A, B and C or their plain
    versions (through ``quantized_call`` kernel C is ``cn``'s own)."""
    cn_cal, yl_cal = calibration
    dtype = recipe.input_dtype
    if recipe.per_layer:
        cn_fwd = quantized_call(cn, cn_cal.scales, paths_of=centerpoint_calibration_paths)
        return (make_centernet_pipeline(cn_fwd, cn_config, device, knobs, impl=impl, dtype=dtype),
                make_yolact_pipeline(quantized_call(yl, yl_cal.scales), yl.config, device, knobs,
                                     impl=impl, dtype=dtype))
    return (make_centernet_chain_pipeline(cn, cn_config, cn_cal.scales, device, knobs,
                                          dtype=dtype, impl=impl, gains=cn_cal.gains,
                                          corrections=cn_cal.corrections),
            make_yolact_chain_pipeline(yl, yl_cal.scales, device, knobs, dtype=dtype,
                                       join_dtype=None, impl=impl, gains=yl_cal.gains,
                                       corrections=yl_cal.corrections))
