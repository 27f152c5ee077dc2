"""Model configurations (``centernet``, ``yolact``: copies of the JAX
package's dataclasses) and the served configurations built from them.

``centernet_config`` and ``yolact_config`` are the configurations that
``bench.py`` serves with no flags: the deployed CenterpointDLA34 (4
classes, heatmap/size/offset heads) and the production YOLACT (ResNet-18,
256-wide FPN, 8 prototypes, 7 classes), both at their native 640x360
input.  ``NORTH_STAR`` is the precision recipe it serves them in, and
the only place that recipe is written; ``DCN_NORTH_STAR`` is the same
recipe with DCNv2 in the CenterNet's 16 IDA blocks (``bench.py --deform
--north-star``); ``INT8_CHAIN_YOLACT`` is its YOLACT with the int8
protonet upsamples of ``bench.py --int8-transpose pallas`` (kernel D).
``keypoints_config`` and ``KEYPOINTS`` are the CenterNet node's full
configuration that ``bench.py --keypoints`` serves (keypoint heatmaps,
affinity and depth heads, the matcher and PnP), as a bf16 net or as an
int8 chain.  ``CHAIN_INT8`` and ``DCN_CHAIN_INT8`` are the int8-chain
pairs of ``bench.py --chain-int8`` and ``--deform``; ``PARITY_INT8`` (with
its ``--mse``, ``--bias-correct`` and ``--seq-correct`` options) and
``PER_LAYER_INT8`` are the pair's two other int8 profiles,
``--parity-int8`` and ``--per-layer-int8``.  ``BENCH_YOLO_POSE``
is the YOLO-Pose net, object points and camera of ``bench.py
--yolo-pose``, served in bf16, with the recipe of its int8 rungs (the
chain and ``--per-layer-int8``).  ``HOST_IO`` is ``bench.py --host-io``
(``CHAIN_INT8`` through the serving executor, from disk, with packed
masks); ``BF16_PAIR`` is the float pair of ``bench.py --bf16``, and
``bf16_pair`` builds its ladder (``--bn-bf16``, ``--f32-from``,
``--fused``); ``NORTH_STAR_EXACT`` is ``--exact-flow``; and
``KEYPOINTS_PER_LAYER_INT8`` is ``bench.py --keypoints --per-layer-int8``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from math import pi
from typing import Optional, Tuple

import torch

from tauv_vision_tpu_torch.configs.centernet import (
    AngleConfig,
    CenternetModelConfig,
    CenternetTrainConfig,
    ObjectConfig,
    ObjectConfigSet,
    get_head_channels,
)
from tauv_vision_tpu_torch.configs.yolact import (
    ClassConfig,
    ClassConfigSet,
    YolactModelConfig,
    YolactTrainConfig,
)
from tauv_vision_tpu_torch.configs.yolo_pose import YoloPoseModelConfig

__all__ = [
    "AngleConfig",
    "BENCH_YOLO_POSE",
    "BF16_PAIR",
    "CHAIN_INT8",
    "CenternetModelConfig",
    "CenternetTrainConfig",
    "ClassConfig",
    "CALIBRATION_FRAMES",
    "ClassConfigSet",
    "DCN_CHAIN_INT8",
    "DCN_NORTH_STAR",
    "FloatPairRecipe",
    "HOST_IO",
    "HostIoRecipe",
    "INT8_CHAIN_YOLACT",
    "KEYPOINTS",
    "KEYPOINTS_PER_LAYER_INT8",
    "ObjectConfig",
    "NORTH_STAR",
    "NORTH_STAR_EXACT",
    "ObjectConfigSet",
    "PARITY_INT8",
    "PER_LAYER_INT8",
    "SEQ_FRAMES",
    "Int8PairRecipe",
    "Int8Scales",
    "PerLayerInt8Recipe",
    "ServedCenternetRecipe",
    "ServedRecipe",
    "ServedYoloPose",
    "YolactModelConfig",
    "YolactTrainConfig",
    "YoloPoseModelConfig",
    "bf16_pair",
    "centernet_config",
    "get_head_channels",
    "keypoints_config",
    "yolact_config",
]

CENTERNET_LABELS = ("sample_24_coral", "sample_24_nautilus", "torpedo_24",
                    "torpedo_24_octagon")


def centernet_config(in_h: int = 360, in_w: int = 640
                     ) -> Tuple[ObjectConfigSet, CenternetModelConfig]:
    def angle():
        return AngleConfig(train=False, modulo=2 * pi)

    object_config = ObjectConfigSet(configs=tuple(
        ObjectConfig(id=name, yaw=angle(), pitch=angle(), roll=angle(),
                     train_depth=False, train_keypoints=False, keypoints=None)
        for name in CENTERNET_LABELS
    ))
    model_config = CenternetModelConfig(
        in_h=in_h, in_w=in_w,
        backbone_heights=(2, 2, 2, 2, 2),
        backbone_channels=(128, 128, 128, 128, 128, 128),
        downsamples=2, angle_bin_overlap=pi / 3,
    )
    return object_config, model_config


def keypoints_config(in_h: int = 360, in_w: int = 640):
    """(object config, model config, projection matrix) of ``bench.py
    --keypoints`` (``build_centernet_keypoints``, ``bench.py:385-441``):
    one class, ``torpedo_24``, with 8 keypoints and a depth head, its
    angles untrained, the DLA-34 geometry of ``centernet_config``, and a
    [3, 4] projection with f = 520 px centred on the 640x360 input."""
    def angle():
        return AngleConfig(train=False, modulo=2 * pi)

    keypoints = tuple(
        (0.1 * (i % 2) - 0.05, 0.1 * (i // 4) - 0.05, 0.02 * i) for i in range(8)
    )
    object_config = ObjectConfigSet(configs=(
        ObjectConfig(id="torpedo_24", yaw=angle(), pitch=angle(), roll=angle(),
                     train_depth=True, train_keypoints=True, keypoints=keypoints),
    ))
    _, model_config = centernet_config(in_h, in_w)
    projection = ((520.0, 0.0, 320.0, 0.0), (0.0, 520.0, 180.0, 0.0), (0.0, 0.0, 1.0, 0.0))
    return object_config, model_config, projection


def yolact_config(in_h: int = 360, in_w: int = 640,
                  feature_depth: int = 256) -> YolactModelConfig:
    return YolactModelConfig(
        in_w=in_w, in_h=in_h, feature_depth=feature_depth, n_classes=7,
        n_prototype_masks=8,
        n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
        n_prediction_head_layers=1, n_classification_layers=0,
        n_box_layers=0, n_mask_layers=0, n_fpn_downsample_layers=2,
        anchor_scales=(24, 48, 96, 192, 384), anchor_aspect_ratios=(1.0,),
        box_variances=(0.1, 0.2), iou_pos_threshold=0.4,
        iou_neg_threshold=0.3, negative_example_ratio=3,
    )


@dataclass(frozen=True)
class CenternetRecipe:
    """``CenterpointDLA34``'s precision knobs and DCN window (its keyword
    arguments)."""

    dtype: torch.dtype
    bn_out: torch.dtype
    f32_stages: Tuple[str, ...]
    deform: bool
    dcn_max_offset: Optional[float] = None


@dataclass(frozen=True)
class YolactChainRecipe:
    """An int8 chain's recipe (the YOLACT's, and the YOLO-Pose's, which
    shares its trunk): per-channel or per-tensor ``calibrate`` scales with
    ``float_paths`` stripped (they run in ``dtype``), residual joins and
    feature taps rounded to ``join_dtype`` (None keeps f32), and the
    protonet's two transposed convs int8 in and out (kernel D) when
    ``int8_transposes`` adds their scales."""

    per_channel: bool
    float_paths: Tuple[str, ...]
    dtype: torch.dtype
    join_dtype: Optional[torch.dtype]
    int8_transposes: bool


@dataclass(frozen=True)
class ServedCenternetRecipe:
    """A served CenterNet: its precision (``CenterpointDLA34``'s keyword
    arguments) and the type its normalised input is rounded to."""

    centernet: CenternetRecipe
    input_dtype: torch.dtype

    def centernet_kwargs(self) -> dict:
        return asdict(self.centernet)


@dataclass(frozen=True)
class ServedRecipe(ServedCenternetRecipe):
    """A served pair: a CenterNet beside the int8-chain YOLACT of
    ``yolact``, both fed images normalised to ``input_dtype``."""

    yolact: YolactChainRecipe


# What ``bench.py`` serves with no flags (its ``north-star`` profile,
# ``bench.py:1276-1305,1391-1454,1578-1610``): the float CenterNet in bf16
# with bf16 BatchNorm outputs and an f32 stem, plain-conv IDA, beside the
# int8-chain YOLACT whose protonet upsamples stay bf16 transposed convs
# (``bench.py`` leaves ``int8_transpose`` None, and ``calibrate`` records
# no scale for them), both behind one combined pipeline whose normalised
# input is ``input_dtype`` (see ``serving.pipeline.make_combined_pipeline``).
NORTH_STAR = ServedRecipe(
    centernet=CenternetRecipe(dtype=torch.bfloat16, bn_out=torch.bfloat16,
                              f32_stages=("stem",), deform=False),
    yolact=YolactChainRecipe(per_channel=True,
                             float_paths=("prediction_head", "protonet/output"),
                             dtype=torch.bfloat16, join_dtype=torch.bfloat16,
                             int8_transposes=False),
    input_dtype=torch.float32,
)

# The int8 chain with the two protonet upsamples int8 in and out through
# kernel D, their scales added to the calibrated ones: the rung of
# ``bench.py --int8-transpose pallas``, served by the ``int8_chain`` path.
INT8_CHAIN_YOLACT = replace(NORTH_STAR.yolact, int8_transposes=True)

# ``bench.py --deform --north-star`` (``bench.py:1350,1358,1578-1596``):
# the north-star pair with the CenterNet's IDA blocks deformable, served
# in bf16 through kernel E's bf16 entry point, which rounds as the JAX
# graph's Pallas kernel (``dcn_max_offset=3``, variant "full") does, with
# its 3-cell window (``bench.py:1223-1236``).  ``replace(...,
# dcn_max_offset=None)`` serves the deployed reference's torchvision
# semantics instead (unbounded offsets), as the ``dcn_ida`` path does.
DCN_NORTH_STAR = replace(NORTH_STAR, centernet=replace(NORTH_STAR.centernet, deform=True,
                                                       dcn_max_offset=3.0))


# ``bench.py --keypoints``'s bf16 net (its ``bf16_fps``): bf16 convs with
# f32 BatchNorm outputs and no f32 stem (the JAX model's defaults), plain
# IDA (``deform=False``), fed the bf16 image of the JAX pipeline's default
# ``dtype``; served through ``make_centernet_keypoint_pipeline`` on
# ``keypoints_config`` with ``SERVING_DECODE`` (10 detections at 0.6, 50
# keypoint peaks at 0.3).  Its ``int8_fps`` is the int8 chain of the same
# net (``make_centernet_keypoint_chain_pipeline``, ``bench.py:1136-1154``):
# per-tensor scales, f32 joins, the bf16 image.
KEYPOINTS = ServedCenternetRecipe(
    centernet=CenternetRecipe(dtype=torch.bfloat16, bn_out=torch.float32,
                              f32_stages=(), deform=False),
    input_dtype=torch.bfloat16,
)



# ``bench.py --chain-int8``, its throughput profile (``bench.py:1355-1357,
# 1412-1440,1578-1627``), served by ``serving/quantize_chain.py``'s
# ``make_centernet_chain_pipeline`` and ``make_yolact_chain_pipeline`` as
# two requests: both nets int8 chains with per-tensor scales
# (``per_channel=parity``, False here) and no float tail (every conv with 16
# input channels or more int8, heads included), f32 joins (``yl_join_dtype``
# is None off north-star), the protonet upsamples bf16 (``int8_transpose``
# None).  The CenterNet is calibrated on, and reads the weights of, the
# bf16 model with f32 BatchNorm outputs and no f32 stage (the profile is
# not north-star), and each net preprocesses its own bf16 image.
CHAIN_INT8 = ServedRecipe(
    centernet=CenternetRecipe(dtype=torch.bfloat16, bn_out=torch.float32, f32_stages=(),
                              deform=False),
    yolact=YolactChainRecipe(per_channel=False, float_paths=(), dtype=torch.bfloat16,
                             join_dtype=None, int8_transposes=False),
    input_dtype=torch.bfloat16,
)


@dataclass(frozen=True)
class Int8Scales:
    """One net's ``calibrate`` scales in an int8 profile of the pair: per
    input channel or per tensor, ``float_paths`` (by substring) stripped,
    so that those convs run in the profile's float dtype."""

    per_channel: bool
    float_paths: Tuple[str, ...] = ()


# ``bench.py``'s calibration frames: ``calibrate``, ``refine_scales_mse``
# and ``calibrate_bias_correction`` read the first 2 frames
# (``bench.py:280,310,335``), ``calibrate_sequential`` the first 4
# (``bench.py:362``).
CALIBRATION_FRAMES = 2
SEQ_FRAMES = 4


@dataclass(frozen=True)
class Int8PairRecipe(ServedCenternetRecipe):
    """An int8 profile of the pair that ``bench.py`` times as two requests
    on the same frames (``bench.py:1620-1627``): the CenterNet of
    ``centernet`` and the YOLACT built in ``input_dtype``, each calibrated
    by ``calibrate`` on its own image in ``input_dtype`` of the first
    ``CALIBRATION_FRAMES`` frames, with the scales of ``centernet_scales``
    and ``yolact_scales``.  With ``per_layer`` both nets run through
    ``quantize.quantized_call``; else as int8 chains
    (``make_*_chain_pipeline``) whose float ops run in ``input_dtype``
    with f32 joins (``yl_join_dtype`` is None off north-star) and the
    protonet's upsamples bf16 (``int8_transpose`` None,
    ``bench.py:1399-1402``), where ``mse`` refines the scales
    (``refine_scales_mse``), ``bias_correct`` adds
    ``calibrate_bias_correction``'s corrections, and ``seq_correct`` fits
    ``calibrate_sequential``'s gains and corrections on the first
    ``SEQ_FRAMES`` frames, which replace ``bias_correct``'s
    (``bench.py:1465-1511``)."""

    centernet_scales: Int8Scales
    yolact_scales: Int8Scales
    per_layer: bool = False
    mse: bool = False
    bias_correct: bool = False
    seq_correct: bool = False


# ``bench.py --parity-int8``'s CenterNet tail: the paths (by substring)
# whose convs stay bf16 (``bench.py:1373``).
PARITY_BF16_TAIL = ("head_", "level0_", "level1_", "ida_up", "dla_up")

# ``bench.py --parity-int8`` (``bench.py:1331-1339,1373-1526``): both nets
# int8 chains with per-channel scales (``calibrate(per_channel=parity)``).
# The CenterNet is ``CHAIN_INT8``'s (the bf16 model with f32 BatchNorm
# outputs and no f32 stage: the profile is not north-star,
# ``bench.py:1293-1305``) with the bf16 tail stripped; the YOLACT strips
# its parity tail, the whole shared prediction head and the protonet's
# output conv (``bench.py:1433-1450``); each net on its own bf16 image.
# Its options: ``replace(PARITY_INT8, mse=True, bias_correct=True)`` is
# ``--mse --bias-correct``, ``replace(PARITY_INT8, mse=True,
# seq_correct=True)`` ``--mse --seq-correct`` (``bench.py:1456-1511``).
PARITY_INT8 = Int8PairRecipe(
    centernet=CHAIN_INT8.centernet,
    input_dtype=torch.bfloat16,
    centernet_scales=Int8Scales(per_channel=True, float_paths=PARITY_BF16_TAIL),
    yolact_scales=Int8Scales(per_channel=True,
                             float_paths=("prediction_head", "protonet/output")),
)

# ``bench.py --per-layer-int8`` on the pair (``bench.py:371-382,1536-1546``):
# the bf16 CenterNet of ``CHAIN_INT8`` and the bf16 YOLACT, each with
# per-tensor scales of its own bf16 image and every conv of 16 input
# channels or more computed in int8 by ``quantized_call``, heads included.
PER_LAYER_INT8 = replace(PARITY_INT8, per_layer=True,
                         centernet_scales=Int8Scales(per_channel=False),
                         yolact_scales=Int8Scales(per_channel=False))

# ``bench.py --deform``, which selects the chain-int8 profile
# (``bench.py:1288-1289,1514-1519``): the same pair with the CenterNet's 16
# IDA blocks deformable in bf16 inside its int8 trunk
# (``dla34_chain_forward(deform=True)``, ``dcn_max_offset=3``, no
# ``offset_bound``), through kernel E's bf16 entry point with the same
# 3-cell window as the JAX graph's Pallas kernel.
DCN_CHAIN_INT8 = replace(CHAIN_INT8, centernet=replace(CHAIN_INT8.centernet, deform=True,
                                                       dcn_max_offset=3.0))


@dataclass(frozen=True)
class ServedYoloPose:
    """A served YOLO-Pose: the net's configuration, the type its convs
    compute in (``YoloPose(dtype=)``) and its normalised input is rounded
    to, the object's model points ([Kp, 3], metres) and the camera ([3, 3]
    intrinsics) that PnP recovers its pose with, and ``chain``, the recipe
    of its int8 rungs."""

    model: YoloPoseModelConfig
    dtype: torch.dtype
    input_dtype: torch.dtype
    object_points: Tuple[Tuple[float, float, float], ...]
    camera_matrix: Tuple[Tuple[float, float, float], ...]
    chain: YolactChainRecipe


# ``bench.py --yolo-pose``'s bf16 rung (``build_yolo_pose``,
# ``bench.py:443-493``): the reference training recipe's YOLO-Pose
# (``yolo_pose/scripts/train.py:54-120``) at 480x960, ResNet-18, a 64-wide
# FPN, 21 classes, 16 mask prototypes, two Pointnet stages (7, 5, 64), 9
# keypoints on 16 belief prototypes, 18 affinities on 16, anchors 24-384
# at aspect ratio 1; ``YoloPose(dtype=bf16)`` fed the bf16 image of
# ``make_yolo_pose_pipeline``'s default, and PnP on 9 model points seen by
# a 700 px camera centred on the input.  Its int8 rungs (``bench.py:258-287,
# 371-382,1139-1170``) read the bf16 net with per-tensor scales that
# ``calibrate`` takes from it on the bf16 images of the first 2 frames, no
# path stripped (every conv with 16 input channels or more int8, heads
# included): the chain (``make_yolo_pose_chain_pipeline``, the bench's
# ``value``) with f32 joins, its float ops in bf16 on the bf16 image and
# the protonet's transposed convs in bf16 (the JAX chain takes no int8
# transpose), and ``--per-layer-int8`` (``quantized_call`` on the net).
BENCH_YOLO_POSE = ServedYoloPose(
    model=YoloPoseModelConfig(
        in_w=960, in_h=480, feature_depth=64, n_classes=21,
        n_prototype_masks=16,
        n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
        pointnet_layers=((7, 5, 64), (7, 5, 64)),
        pointnet_feature_depth=64,
        prototype_belief_depth=16, prototype_affinity_depth=16,
        belief_depth=9, affinity_depth=18,
        n_prediction_head_layers=1, n_fpn_downsample_layers=2,
        belief_sigma=2.0, affinity_radius=6.0,
        anchor_scales=(24, 48, 96, 192, 384), anchor_aspect_ratios=(1.0,),
        box_variances=(0.1, 0.2), iou_pos_threshold=0.5,
        iou_neg_threshold=0.4, negative_example_ratio=3,
    ),
    dtype=torch.bfloat16,
    input_dtype=torch.bfloat16,
    object_points=tuple((0.1 * (i % 3) - 0.1, 0.1 * (i // 3) - 0.1, 0.05 * (i % 2))
                        for i in range(9)),
    camera_matrix=((700.0, 0.0, 480.0), (0.0, 700.0, 240.0), (0.0, 0.0, 1.0)),
    chain=YolactChainRecipe(per_channel=False, float_paths=(), dtype=torch.bfloat16,
                            join_dtype=None, int8_transposes=False),
)


# ``bench.py --north-star --exact-flow`` (``bench.py:1270,1293,1305,
# 1412-1417``): ``NORTH_STAR`` with the flax-exact flow, the CenterNet's
# BatchNorm outputs f32 and no f32 stem, the YOLACT chain's joins f32
# (``join_dtype`` None), both behind one ``make_combined_pipeline``.  The
# image is bf16, the JAX function's default: with no f32 stem the
# CenterNet's first conv rounds its input to bf16 in any case, and so does
# the YOLACT chain's float stem.
NORTH_STAR_EXACT = replace(
    NORTH_STAR, centernet=replace(NORTH_STAR.centernet, bn_out=torch.float32, f32_stages=()),
    yolact=replace(NORTH_STAR.yolact, join_dtype=None), input_dtype=torch.bfloat16)


@dataclass(frozen=True)
class FloatPairRecipe(ServedCenternetRecipe):
    """A float profile of the pair: the CenterNet of ``centernet`` fed its
    normalised image in ``input_dtype``, beside the float YOLACT
    ``Yolact(dtype=yolact_dtype)`` fed its own image in ``yolact_dtype``;
    served as two requests on the same frames (``bench.py:1620-1627``), or
    with ``fused`` through one ``make_combined_pipeline`` that shares the
    resize (``bench.py:1564-1612``; its one image is in ``input_dtype``,
    which the bf16 YOLACT's stem rounds to bf16 as its own image is)."""

    yolact_dtype: torch.dtype
    fused: bool = False


# ``bench.py --bf16`` (``bench.py:1276-1320,1548-1550``), the float pair
# that the reference-parity suite covers: the bf16 CenterNet with f32
# BatchNorm outputs and no f32 stage (the profile is not north-star,
# ``bench.py:1293,1305``), plain IDA, beside the bf16 YOLACT
# (``bench.py:131``), no int8 in either net; each net on its own bf16
# image, the JAX ``make_*_pipeline`` functions' default ``dtype``; two
# requests, unfused (``bench.py:1620-1624``).
BF16_PAIR = FloatPairRecipe(
    centernet=CenternetRecipe(dtype=torch.bfloat16, bn_out=torch.float32, f32_stages=(),
                              deform=False),
    input_dtype=torch.bfloat16,
    yolact_dtype=torch.bfloat16,
)

# The stages whose f32 convs read the image itself: a rung that names one
# is fed the f32 image, the choice ``NORTH_STAR`` made for its f32 stem
# (where the JAX pipeline rounds the image to bf16 first: ROADMAP, "Known
# defects on the reference side", item 1).
F32_IMAGE_STAGES = ("stem", "early")


def bf16_pair(bn_bf16: bool = False, f32_stages: Tuple[str, ...] = (),
              fused: bool = False) -> FloatPairRecipe:
    """``BF16_PAIR`` with ``bench.py``'s ladder knobs: ``--bn-bf16`` (bf16
    BatchNorm outputs), ``--f32-from S1,...`` (the CenterNet stages that
    compute in f32, ``bench.py:1306-1317``; an unknown name raises, as
    there) and ``--fused``.  A rung with ``stem`` or ``early`` in
    ``f32_stages`` feeds the CenterNet the f32 image
    (``F32_IMAGE_STAGES``); every other rung the bf16 image, as JAX
    does."""
    from tauv_vision_tpu_torch.models.centerpoint_dla import check_f32_stages

    stages = check_f32_stages(f32_stages)
    f32_image = any(s in F32_IMAGE_STAGES for s in stages)
    return replace(
        BF16_PAIR,
        centernet=replace(BF16_PAIR.centernet,
                          bn_out=torch.bfloat16 if bn_bf16 else torch.float32,
                          f32_stages=stages),
        input_dtype=torch.float32 if f32_image else torch.bfloat16, fused=fused)


@dataclass(frozen=True)
class HostIoRecipe:
    """``bench.py --host-io`` (``bench.py:535-682``): the int8-chain pair
    ``pair`` served through ``serving/executor.ServingExecutor`` with
    ``prefetch`` batches ahead, on ``n_batches`` batches of ``batch`` uint8
    frames of ``frame_hw`` read from disk (a memory-mapped raw ring, timed
    over ``raw_reps`` passes after a warm one, and PNG files over
    ``png_reps``), the YOLACT's masks packed into bitmaps of
    ``mask > mask_threshold`` on the device, every output brought back as
    numpy."""

    pair: ServedRecipe
    batch: int
    n_batches: int
    prefetch: int
    raw_reps: int
    png_reps: int
    mask_threshold: float
    frame_hw: Tuple[int, int]


# ``bench.py --host-io``: ``CHAIN_INT8`` (per-tensor scales of 2 frames,
# ``bench.py:585-600``) with packed masks (``bench.py:606-620``), 8 batches
# (``:589``), prefetch 2 (``:624``), 4 raw passes and 1 PNG pass
# (``:658-661``) of 640x480 frames.  ``bench.py`` defaults to batch 128
# (``bench.py:1196-1201``); the port serves and times it at 32, as every
# pair path is timed: a cut of the batch, not of width.
HOST_IO = HostIoRecipe(pair=CHAIN_INT8, batch=32, n_batches=8, prefetch=2, raw_reps=4,
                       png_reps=1, mask_threshold=0.5, frame_hw=(480, 640))


@dataclass(frozen=True)
class PerLayerInt8Recipe(ServedCenternetRecipe):
    """A CenterNet whose convs ``quantized_call`` computes in int8, with
    ``calibrate``'s scales of ``scales`` on the first
    ``CALIBRATION_FRAMES`` frames of its image in ``input_dtype``."""

    scales: Int8Scales


# ``bench.py --keypoints --per-layer-int8`` (``bench.py:371-382,
# 1138-1143``): ``KEYPOINTS``' bf16 net (f32 BatchNorm outputs, no f32
# stage, plain IDA) through ``quantized_call`` with per-tensor scales of 2
# frames keyed by ``weights.centerpoint_calibration_paths``, every conv of
# 16 input channels or more int8, heads included; fed the bf16 image of the
# JAX keypoint pipeline's default ``dtype``.
KEYPOINTS_PER_LAYER_INT8 = PerLayerInt8Recipe(centernet=KEYPOINTS.centernet,
                                              input_dtype=KEYPOINTS.input_dtype,
                                              scales=Int8Scales(per_channel=False))
