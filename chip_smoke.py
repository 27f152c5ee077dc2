#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths and training once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Twenty-four served paths: seven pair a CenterNet with a YOLACT through
``make_combined_pipeline``, eleven serve the CenterNet and the YOLACT as
two requests, as ``bench.py`` times them (six of them in int8, four in
bf16, and one through the serving executor from disk), three serve the
CenterNet node's full configuration alone, and three serve YOLO-Pose:

- ``plain_ida``: the CenterpointDLA34 with plain-conv IDA (the IDA that
  ``bench.py`` serves with no flags), all f32, beside the f32 YOLACT;
- ``dcn_ida``: the reference's deployed CenterpointDLA34 with DCNv2 in
  its 16 IDA blocks (``deform=True``, kernel E), f32, beside the f32
  YOLACT;
- ``int8_chain``: the f32 plain-IDA CenterNet beside the int8-chain
  YOLACT (per-channel scales calibrated on 2 frames, the prediction head
  and ``protonet/output`` in bf16, bf16 joins and float convs), with the
  protonet's two upsamples' scales added so both run int8 through kernel
  D (``configs.INT8_CHAIN_YOLACT``);
- ``north_star``: what ``bench.py`` serves with no flags
  (``configs.NORTH_STAR``): the plain-IDA CenterNet in bf16 with bf16
  BatchNorm outputs and an f32 stem (kernel C in bf16), on the same
  weights, beside the int8-chain YOLACT with its protonet upsamples in
  bf16 (cuDNN transposed convs, no kernel D), normalised in f32;
- ``dcn_north_star``: ``bench.py --deform --north-star``
  (``configs.DCN_NORTH_STAR``): the same pair with DCNv2 in the
  CenterNet's 16 IDA blocks, on ``dcn_ida``'s weights, its offset and
  mask convs and kernel E in bf16 (E's bf16 entry point);
- ``keypoints``: ``bench.py --keypoints`` (``configs.KEYPOINTS`` on
  ``configs.keypoints_config``): the CenterpointDLA34 with keypoint
  heatmap, affinity and depth heads in bf16 (f32 BatchNorm outputs, no
  f32 stem, kernel C in bf16) through ``make_centernet_keypoint_pipeline``
  at batch 16: kernel A on the object heatmap (K = 10) and on the
  keypoint heatmap (K = 50), the greedy matcher and LM PnP on the card;
- ``chain_int8``: ``bench.py --chain-int8`` (``configs.CHAIN_INT8``): the
  CenterNet as an int8 chain (``make_centernet_chain_pipeline``: every
  conv with 16 input channels or more int8, heads included, per-tensor
  scales of its bf16 model on 2 frames, f32 joins, kernel C in bf16) on
  ``plain_ida``'s weights, and the YOLACT as an int8 chain at the same
  recipe (``make_yolact_chain_pipeline``, prediction head int8), each
  request preprocessing its own bf16 image;
- ``dcn_chain_int8``: ``bench.py --deform`` (``configs.DCN_CHAIN_INT8``):
  the same with the CenterNet's 16 IDA blocks deformable in bf16 (kernel
  E's bf16 entry point) on ``dcn_ida``'s weights;
- ``keypoints_int8``: the ``int8_fps`` of ``bench.py --keypoints``: the
  ``keypoints`` net as an int8 chain
  (``make_centernet_keypoint_chain_pipeline``), calibrated per tensor on
  its rescaled keypoint head.
- ``yolo_pose``: ``bench.py --yolo-pose``'s bf16 rung
  (``configs.BENCH_YOLO_POSE``): the bf16 YOLO-Pose at 480x960 through
  ``make_yolo_pose_pipeline`` at batch 16: Fast-NMS, the belief maps
  through kernel B without the crop, their peaks and PnP on the card;
- ``yolo_pose_int8``: ``bench.py --yolo-pose``'s ``value``, the same net
  and decode over the int8 chain (``make_yolo_pose_chain_pipeline``:
  per-tensor scales of the bf16 net on 2 frames, every conv with 16 input
  channels or more int8, heads included, f32 joins, the protonet's
  transposed convs in bf16, ``configs.BENCH_YOLO_POSE.chain``);
- ``yolo_pose_per_layer_int8``: its ``--per-layer-int8`` rung, the bf16
  net with each calibrated conv computed in int8 (``quantized_call``);
- ``parity_int8``: ``bench.py --parity-int8`` (``configs.PARITY_INT8``,
  ``serving/int8_pair.py``): ``chain_int8``'s bf16 CenterNet as an int8
  chain with per-channel scales of 2 frames and its bf16 tail
  (``head_``, ``level0_``, ``level1_``, ``ida_up``, ``dla_up``) in bf16,
  and the bf16 YOLACT as an int8 chain with per-channel scales, its
  prediction head and ``protonet/output`` in bf16, f32 joins, bf16
  protonet upsamples; ``parity_int8_corrected`` adds ``--mse
  --bias-correct`` (MSE-refined scales, bias corrections) and
  ``parity_int8_seq`` ``--mse --seq-correct`` (the sequential fits' gains
  and corrections on 4 frames);
- ``per_layer_int8``: ``bench.py --per-layer-int8`` on the pair
  (``configs.PER_LAYER_INT8``): both bf16 nets with every conv of 16
  input channels or more in int8 through ``quantized_call``, per-tensor
  scales, kernel C inside the CenterNet;
- ``host_io``: ``bench.py --host-io`` (``configs.HOST_IO``):
  ``chain_int8``'s two requests on each batch through
  ``serving/executor.ServingExecutor`` (upload, dispatch and download on
  three threads and three CUDA streams, pinned buffers), frames read from
  a memory-mapped raw ring or from PNG files, the YOLACT's masks
  bit-packed on the card, every output back as numpy;
- ``bf16_pair``: ``bench.py --bf16`` (``configs.BF16_PAIR``): the bf16
  CenterNet with f32 BatchNorm outputs beside the bf16 YOLACT, no int8,
  two requests; its rungs ``bf16_pair_fused`` (``--fused``, one
  ``make_combined_pipeline``), ``bf16_pair_bn_bf16`` (``--bn-bf16``),
  ``bf16_pair_f32_early`` (``--f32-from early``, the f32 image) and
  ``bf16_pair_f32_level3`` (``--f32-from level3,level4,level5,dla_up,
  ida_up,heads``: kernel C in f32), built by ``configs.bf16_pair``; and
  ``north_star_exact`` (``--exact-flow``, ``configs.NORTH_STAR_EXACT``):
  ``north_star`` with f32 BatchNorm outputs, no f32 stem and f32 joins in
  the YOLACT chain;
- ``keypoints_per_layer_int8``: ``bench.py --keypoints --per-layer-int8``
  (``configs.KEYPOINTS_PER_LAYER_INT8``): the ``keypoints`` net with every
  conv of 16 input channels or more int8 through ``quantized_call``.

Phases, each fatal on failure (exit code != 0, no result line):

1. device: require CUDA, print the card and its power limit, and turn
   TF32 off (the f32 paths are f32);
2. build: compile the port's CUDA kernels from ``tauv_vision_tpu_torch/
   csrc`` (one nvcc a source, in parallel) and print the build time and
   each kernel's registers and spills;
3. check: each kernel against its plain PyTorch version on the card at
   the served shapes (batch 8), tolerances printed beside each result:
   kernel A on random, planted-tie (across tile bands), sparse (fewer
   than K peaks), flat and the net's own heatmaps, K = 1, 10 and 128,
   and a map two column tiles wide, and the keypoint net's own object
   and keypoint heatmaps at batch 16 ([16,1,90,160] K = 10, [16,8,90,160]
   K = 50); kernel B with the crop and without,
   on NCHW and NHWC-view prototypes, P = 8 and 32, and a ragged width;
   kernel C in f32 and in bf16 at the 8 upsamples of a forward;
   kernel E, f32 on ``dcn_ida``'s and bf16 on ``dcn_north_star``'s
   calls, at each distinct shape of the 16 DCN calls of one forward, with
   the net's offsets, offsets planted in +-40 cells, no mask, and the
   first 7 images (a pixel count no tile divides);
   kernel D bit-equal at both protonet upsamples (int8 and bf16 out,
   leaky/relu/none, and one odd width); the chain's integer convolution
   core (im2col + ``torch._int_mm``) bit-equal to the float64 cuDNN
   convolution at every distinct calibrated conv shape; probe P2 exact;
   probe P1's kernels at the JAX probe's shapes (copies, decimations and
   the transpose exact, the dots within 1e-4); and at the int8-chain
   paths' own calls: kernel A on ``chain_int8``'s heatmap and the keypoint
   chain's two, kernel B on the chain-int8 YOLACT's prototypes, kernel C
   in bf16 at the chains' 8 upsamples (batch 8, 16 and 1), kernel E in
   bf16 at each distinct DCN shape of ``dcn_chain_int8``, and the integer
   core at the CenterNet chains' integer convs (heads of 2 and 4 output
   channels, padded to 8 for ``torch._int_mm``);
4. serve: for each path, the served pair at full width on seeded random
   weights answers 4 requests of 8 random 640x480 uint8 frames; outputs
   must be finite and well shaped, the launch counters (zeroed just
   before the path) must show every kernel of the path on every
   request, and the same frames through the plain versions must decode
   the same (for ``int8_chain`` the int8 protonet maps bit-equal too,
   and on ``north_star`` ``make_yolact_chain_pipeline``, YOLACT alone on
   its defaults, the served recipe, launches what the pair's YOLACT does
   and decodes as it); then one batch-1 request (one camera frame, as a
   vehicle's node serves it) on ``north_star``, ``dcn_north_star`` and
   ``int8_chain``,
   through every kernel of the path and decoded as the plain path does;
   the chain's decode against the f32 YOLACT's is printed, not gated
   (random weights), as is the bf16 CenterNet's against the f32 one;
   ``keypoints`` answers 2 requests of 16 frames and one of 1 frame,
   counted as the others, then is held to its plain path at threshold 0
   (detections as the bf16 pairs are), and ``decode_keypoints`` on the
   kernel and on the plain peak decode is held slot for slot on one
   forward's heads, and ``solve_pnp_batch`` recovers 160 synthetic poses
   (random weights validate few) within 1e-2;
   the chain pairs answer 4 requests of 8 frames and one of 1 through
   every kernel of the path, counted as the others, held to their plain
   versions (``chain_int8``: every int8 code of the CenterNet chain equal;
   ``dcn_chain_int8``: the trunk's codes equal; both: decodes 100% matched,
   CenterNet p95 <= 1e-3), and ``keypoints_int8`` 2 requests of 16 frames
   and one of 1 (codes equal, detections 100% matched, the same keypoints
   claimed and poses valid); their decodes against the float nets on the
   same weights are printed, not gated;
   the node servers: ``CenternetServer`` on the keypoint net and
   ``YolactServer`` on the f32 YOLACT, each on one 640x480 colour frame
   and a depth plane at 2 m with invalid cells, an identity pose: every
   published position finite, and the count the drop rule implies;
5. time: each kernel against its plain version (CUDA events, after
   warm-up, back to back as a path issues them: ``ms``), and each kernel
   on the device alone, its calls queued behind a spin of the card so
   that the host's launch cost is out (``device_ms``; null for the
   probes, whose own timing is in the kernel); an empty kernel queued the
   same way, the device's cost of a launch; kernel C per call in GB/s,
   kernel D per call in TOP/s and kernel E per shape in TFLOP/s (f32 and
   bf16) on the device beside their bounds; probe
   P2's rates, the integer core against cuDNN's bf16 convolution per
   calibrated shape, probe P1's rows beside their bounds and the
   early-trunk convs in cuDNN they are weighed against, each path's
   frames/s at batch 32, and its stages one by one; kernel A at
   [16,8,90,160] K = 50, and the ``keypoints`` request's frames/s at
   batch 16 with its stages (preprocess, forward, decode, keypoint peaks,
   matcher, PnP); the chain pairs' frames/s at batch 32 (the batch over
   the sum of their two requests' times), their stages, the CenterNet
   chain forward's device split from ``torch.profiler`` (im2col, ``_int_mm``,
   kernels C and E, cuDNN, the rest) and the device's idle share, and
   ``keypoints_int8`` at batch 16 beside ``keypoints`` in the same run;
6. train: the DCN CenterNet as the JAX package trains it (bf16, the
   3-cell DCN window, the flax init) on the synthetic squares at batch 32
   and 360x640: the kernel path's train step against the plain path's
   (f32 at batch 8, bf16 at 32), 6 overfit steps through ``Trainer``,
   kernels C and E at the trained net's calls, a checkpoint round trip,
   two steps from one checkpoint run twice (with cuDNN's default and its
   deterministic algorithms: which gradients repeat bit for bit, and the
   step's time), the timed step and its ``torch.profiler`` split;
7. train_cli: the training CLI (``scripts/train_centernet.py``) on two
   dataset directories of 32 train and 16 val 640x360 PNGs each (the
   squares with ``samples_torpedo``'s four classes, written by the port's
   writer), ``samples_torpedo`` at full width and batch 32: two epochs of
   2 batches with watch lines every 2 steps, then a warm start from its
   checkpoint for one epoch; every loss finite, the restored parameters
   and Adam moments equal to the saved ones, the watch lines covering
   every trained parameter, 8 C and 16 E launches a forward; the CLI's
   images/s, the loader's host ms a batch, the device's idle share over
   the steps and the peak memory;
8. train_yolact: the YOLACT as the JAX package trains it
   (``scripts/train_yolact.py``'s configuration: bf16, the flax init,
   640x360, batch 24, the mask loss capped at 64 positives), on the
   synthetic squares: ``yolact_loss`` on the card against the CPU on one
   forward's predictions with ties planted in the background confidence
   and the match IoUs (identical anchor sets, each loss within 1e-5),
   every gradient of a step finite and non-zero (but the FPN levels no
   anchor trains), 60 overfit steps through ``Trainer`` below 0.6 of the
   first loss, a checkpoint round trip, two steps from one checkpoint run
   twice (both losses and every gradient bit-equal), the timed step
   with its ``torch.profiler`` split; then the CLI on four directories of
   24 train and 12 val 640x360 PNGs with seg maps, 8 loader threads: two
   epochs of 4 batches with watch lines, a warm start, the CLI's images/s
   with host reading included, the loader's host ms a batch and the
   device's idle share.  JAX's YOLACT training reaches no Pallas kernel,
   so the phase launches none of the port's;
9. yolo_pose: ``bench.py --yolo-pose``'s bf16 rung
   (``configs.BENCH_YOLO_POSE``, ``make_yolo_pose_pipeline``): the bf16
   YOLO-Pose (ResNet-18, FPN, protonet, a two-stage Pointnet) at 480x960
   with the flax init from a seed, decoded with Fast-NMS (top 10), its
   belief maps through kernel B (no crop) and their peaks, then PnP on
   the card.  Kernel B at the decode's call on the net's own prototypes
   and coefficients ([16,16,30,60] x [16,90,16], NCHW and the NHWC view,
   batch 16 and 1) against its plain version within 1e-5; 2 requests of
   16 frames and one of 1, kernel B launched once a request (counted
   from 0 before the requests) and nothing else; the decode on the kernel
   and on the plain version at confidence 0 on each request's one
   forward, slot for slot (detections equal, keypoints equal but on maps
   whose top two values lie within 1e-5, counted; poses of slots whose
   keypoints agree within 1e-5), and the two whole pipelines the same
   way; PnP on the card against planted poses (1e-2) and the CPU solve
   of the same keypoints (1e-3); then kernel B's row at that call, the
   request's frames/s at batch 16 with and without PnP (kernels and
   plain), its device kernels, busy time and idle share, and its stages
   (upload, preprocess, forward, NMS + belief peaks, PnP);
10. yolo_pose_int8: ``bench.py --yolo-pose``'s two int8 rungs on the
   same net: ``calibrate`` on 2 frames (64 convs, printed as the bench's
   ``quantized_convs``); the integer core (im2col + ``torch._int_mm``)
   int32-equal to the float64 conv at every distinct integer conv of the
   chain at batch 16 and 1 (the Pointnet's 7x7 convs at C = 64 and 96,
   the heads' 22 and 4 outputs padded to 24 and 8, batch 1's 32-row
   level) and at the 7x7 shapes on random and saturated codes; each rung
   answers 2 requests of 16 frames and one of 1, kernel B (no crop)
   launched once a request and nothing else; kernel against plain at
   confidence 0 on each request's one forward and the whole pipelines,
   slot for slot as in phase 9; each rung's decode against the bf16
   rung's, printed, not gated (random weights); then both rungs' and the
   bf16 rung's requests at batch 16 with and without PnP (frames/s,
   kernels and copies a request, idle share), each rung's stages and its
   forward's device split from ``torch.profiler`` (im2col, ``_int_mm``,
   cuDNN, the rest);
11. train_yolo_pose: YOLO-Pose as the JAX package trains it
   (``scripts/train_yolo_pose.py``'s configuration: bf16, the flax init,
   960x480, batch 4, the warm-up Adam) on ``write_square_fat_dataset``'s
   Falling Things frames (projected cubes, 960x540): ``yolo_pose_loss``
   on the card against the CPU on one forward's predictions at batch 4
   with ties planted in the background confidence and the match IoUs
   (identical anchor sets, each loss within 1e-5), every gradient of a
   step finite and non-zero (but the FPN levels no anchor trains), 60
   overfit steps through ``Trainer`` below 0.6 of the first loss (the
   recipe's lr, a 5-step warm-up: the recipe's 2,000 would hardly move), a
   checkpoint round trip (parameters, Adam moments and the warm-up count
   equal, the next loss bit-equal), two steps from one checkpoint run
   twice (bit-equal), the timed step at batch 4 and 16 with its
   ``torch.profiler`` split and peak memory; then the CLI on a tree of two
   environments of 24 frames, 4 loader threads: two epochs of 4 batches
   with watch lines, then a profiled epoch; the CLI's images/s with host
   reading included, the loader's host ms a batch and the device's idle
   share.  JAX's YOLO-Pose training reaches no Pallas kernel, so the phase
   launches none of the port's;
12. int8_pair: the four paths above: each calibrated on the card as
   ``bench.py`` calibrates it (``int8_pair.calibrate_pair``: the convs
   counted, the gains and corrections finite); 4 requests of 8 frames,
   kernels A, B and C counted from 0 (one A, one B and 8 bf16 C a
   request, nothing else), held to the plain versions (decodes 100%
   matched, CenterNet p95 <= 1e-3, masks within 1e-5); ``parity_int8``,
   ``parity_int8_seq`` and ``per_layer_int8`` at batch 32 as the chain
   pairs (frames/s, kernels and plain; busy time and idle share), and each
   net's forward with its device split (im2col, ``_int_mm``, C, cuDNN,
   the rest);
13. qat: ``qat.qat_distill`` on ``parity_int8``'s bf16 CenterNet at
   360x640 on a fixed batch of 8 synthetic squares
   (``generate_square_batch``), per-channel scales stripped of ``head_``
   (the JAX default ``--qat-strip``): 10 steps at the recipe's lr 2e-5,
   timed (ms a step, peak memory), their losses printed; 10 steps at
   1e-6, gated: the distillation loss finite and lower after than before,
   every fake-quantized conv's weight gradient finite and non-zero, 8
   bf16 C launches a forward of the student and of the teacher; then the
   distilled weights served through a fresh ``parity_int8`` pair
   (calibrated anew, 2 requests, kernels against plain as in phase 12);
14. host_io: ``chain_int8``'s chains and scales through the executor on 8
   batches of 32 seeded 640x480 frames written to a raw ring and to PNGs:
   every output, packed masks included, equal bit for bit to the
   sequential call of the same pipeline, in order; the bitmaps unpack to
   ``mask > 0.5`` of that call's masks; A 1, B 1 and C 8 bf16 launches a
   batch; a generator closed after 2 batches leaves no executor thread
   after 2 s; a source failing at batch 3 yields 3 outputs, then raises.
   Then frames/s from the raw ring (a warm pass, then 4 passes) and from
   the PNGs (1 pass), the same raw batches without the executor, PIL's
   decode alone on one thread, the host's cores, the bytes up and down a
   batch, and one raw pass traced: the device time in which a
   host-to-device copy ran beside a kernel, and the idle share;
15. bf16_pair: each rung above and ``north_star_exact`` on ``int8_pair``'s
   bf16 nets (new CenterNets on the same weights where the rung's
   precision differs): one request of 8 frames, A 1, B 1 and C 8 launches
   counted from 0, held to its plain versions (the bf16 CenterNet's bars,
   the YOLACT 100% matched); fused equal bit for bit to unfused;
   ``decode_yolact(mask_hw=(360, 640), crop_masks=False)`` through B's
   "no crop" entry against its plain version within 1e-5; each rung's
   requests at batch 32, 3 repetitions;
16. keypoints_per_layer_int8: calibrated on the card (per tensor, 2
   frames), 2 requests of 16 frames, A at K = 10 and K = 50 and C 8 bf16
   launches a request, held to its plain versions at threshold 0 on the
   requests and a frame (the bf16 CenterNet's bars), ``decode_keypoints``
   on one forward's heads kernel A against plain, equal; its request at
   batch 16 beside the bf16 ``keypoints`` request.

Each phase prints its seconds, and the script its total.

Prints one JSON line describing the kernels, with each kernel's bound
(the larger of its bytes over 3.35 TB/s and its operations over the
peak rate of their type, H100 SXM data sheet at 700 W; P1's copies
against shared memory, 132 SMs x 128 bytes a clock), then, as the last
line, ``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes a
``torch.profiler`` table of three batch-32 requests of each path into DIR.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.configs import (
    BENCH_YOLO_POSE,
    BF16_PAIR,
    CALIBRATION_FRAMES,
    CHAIN_INT8,
    DCN_CHAIN_INT8,
    DCN_NORTH_STAR,
    HOST_IO,
    INT8_CHAIN_YOLACT,
    KEYPOINTS,
    KEYPOINTS_PER_LAYER_INT8,
    NORTH_STAR,
    NORTH_STAR_EXACT,
    PARITY_INT8,
    PER_LAYER_INT8,
    SEQ_FRAMES,
    ClassConfig,
    ClassConfigSet,
    bf16_pair,
    centernet_config,
    keypoints_config,
    yolact_config,
)
from tauv_vision_tpu_torch.configs import samples_torpedo
from tauv_vision_tpu_torch.data.dataset_dir import Split
from tauv_vision_tpu_torch.data.image_io import read_image
from tauv_vision_tpu_torch.data.falling_things import (
    FallingThingsDataset,
    FallingThingsEnvironment,
    FallingThingsObject,
    FallingThingsVariant,
)
from tauv_vision_tpu_torch.data.pose_dataset import PoseDataset, collate_pose_samples
from tauv_vision_tpu_torch.data.segmentation_dataset import (
    SegmentationDataset,
    collate_segmentation_samples,
)
from tauv_vision_tpu_torch.data.synthetic import (
    FAT_SIZE,
    SquareDatasetConfig,
    generate_square_batch,
    generate_square_seg_batch,
    seg_truth,
    square_object_config,
    write_square_fat_dataset,
    write_square_pose_dataset,
    write_square_seg_dataset,
)
from tauv_vision_tpu_torch.models.centerpoint_dla import CenterpointDLA34
from tauv_vision_tpu_torch.models.yolact import Yolact, YolactPrediction
from tauv_vision_tpu_torch.models.yolo_pose import YoloPose, YoloPosePrediction
from tauv_vision_tpu_torch.ops.anchors import fpn_level_sizes, get_all_anchors
from tauv_vision_tpu_torch.ops.conv_transpose import (
    depthwise_upsample,
    depthwise_upsample_cuda,
)
from tauv_vision_tpu_torch.ops import conv_transpose, deform_conv
from tauv_vision_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_cuda
from tauv_vision_tpu_torch.ops.image import normalize_image, preprocess, resize_frames
from tauv_vision_tpu_torch.ops.int8_conv import conv2d_int8_f64, conv2d_int8_im2col
from tauv_vision_tpu_torch.ops.masks import assemble_mask_batch, assemble_mask_cuda
from tauv_vision_tpu_torch.ops.peaks import peak_decode, peak_decode_cuda
from tauv_vision_tpu_torch.ops.pnp import solve_pnp_batch
from tauv_vision_tpu_torch.ops.se3 import so3_exp
from tauv_vision_tpu_torch.ops.transpose_conv import (
    transpose_conv2x_int8,
    transpose_conv2x_int8_cuda,
)
from tauv_vision_tpu_torch.scripts import (
    int8_dot_probe,
    kernel_times,
    op_probe,
    train_centernet,
    train_yolact,
    train_yolo_pose,
)
from tauv_vision_tpu_torch.scripts.kernel_times import queued_ms, time_ms
from tauv_vision_tpu_torch.serving import quantize_chain
from tauv_vision_tpu_torch.serving.centernet_decode import (
    decode,
    decode_keypoints,
    keypoint_peaks,
    keypoint_poses,
    match_keypoints,
)
from tauv_vision_tpu_torch.serving.compare import detection_deltas
from tauv_vision_tpu_torch.serving.nodes import YOLACT_INPUT_DTYPE, CenternetServer, YolactServer
from tauv_vision_tpu_torch.serving.pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STDDEV,
    SERVING_DECODE,
    YOLO_POSE_DECODE,
    make_centernet_keypoint_pipeline,
    make_centernet_pipeline,
    make_combined_pipeline,
    make_float_pair_pipeline,
    make_yolact_pipeline,
    make_yolo_pose_pipeline,
)
from tauv_vision_tpu_torch.serving import executor, host_io, qat, quantize
from tauv_vision_tpu_torch.serving.executor import ServingExecutor
from tauv_vision_tpu_torch.serving.host_io import host_io_pipeline
from tauv_vision_tpu_torch.serving.int8_pair import (
    calibrate_pair,
    calibrate_per_layer,
    make_int8_pair_pipelines,
    make_keypoints_per_layer_pipeline,
)
from tauv_vision_tpu_torch.serving.quantize import calibrate, quantized_call, strip_scales
from tauv_vision_tpu_torch.serving.quantize_chain import (
    ChainCtx,
    dla34_chain_forward,
    make_centernet_chain_pipeline,
    make_centernet_keypoint_chain_pipeline,
    make_yolact_chain_pipeline,
    make_yolo_pose_chain_pipeline,
    yolact_chain_forward,
    yolo_pose_chain_forward,
)
from tauv_vision_tpu_torch.serving.yolact_decode import decode_yolact
from tauv_vision_tpu_torch.serving.yolo_pose_decode import (
    MIN_KEYPOINTS,
    YoloPoseDetections,
    attach_pnp,
    decode_yolo_pose,
    select_detections,
)
from tauv_vision_tpu_torch.train import steps as train_steps
from tauv_vision_tpu_torch.train.checkpoint import CheckpointManager
from tauv_vision_tpu_torch.train.metrics import MultiWriter, StdoutWriter
from tauv_vision_tpu_torch.train.state import TrainState, adam_with_clip, warmup_adam
from tauv_vision_tpu_torch.train.steps import (
    make_centernet_train_step,
    make_yolact_train_step,
    make_yolo_pose_train_step,
    model_mode,
)
from tauv_vision_tpu_torch.train.trainer import Trainer, TrainerConfig
from tauv_vision_tpu_torch.train.yolact_task import match_anchor_sets, match_anchors, yolact_loss
from tauv_vision_tpu_torch.train.yolo_pose_task import yolo_pose_loss
from tauv_vision_tpu_torch.weights import (
    centerpoint_calibration_paths,
    centerpoint_flax_path,
    yolo_pose_flax_path,
)

FRAME_H, FRAME_W = 480, 640
CHECK_BATCH = 8
N_REQUESTS = 4
FPS_BATCH = 32
N_CALIBRATION = 2     # frames, as bench.py calibrates
KP_BATCH = 16         # bench.py --keypoints' default batch
KP_REQUESTS = 2
# Every slot decoded: random weights put nothing above the served
# thresholds (0.6 for objects, 0.3 for keypoints).
ALL_SLOTS = dataclasses.replace(SERVING_DECODE, score_threshold=0.0,
                                keypoint_score_threshold=0.0)
# decode_keypoints on kernel A and on the plain peak decode, same heads:
# peaks equal slot for slot, so PnP gets equal inputs and its poses are
# expected bit-equal; the bar leaves room for a reduction whose order
# follows the launch configuration.
POSE_ATOL = 1e-5
DEPTH_M = 2.0         # the node check's depth plane
# The node check's camera: f = 520 px, centred on the 640x480 frame.
FRAME_INTRINSICS = np.asarray([[520.0, 0.0, 320.0], [0.0, 520.0, 240.0], [0.0, 0.0, 1.0]])

PEAK_ATOL = 1e-6      # score; index and label exact
MASK_ATOL = 1e-5      # sigmoid of an 8-term dot, summed in another order
UPSAMPLE_TOL = 1e-5   # rtol and atol: 4 f32 taps in another order than cuDNN
HEAD_ATOL = {         # raw heads, kernel path against the plain path
    "plain_ida": 1e-4,   # kernel C against cuDNN inside the net
    # kernels C and E: a sample position that moves by one ulp moves every
    # later DCN block's samples, through 16 blocks; the bound the CPU
    # tests hold this net to against the JAX package
    "dcn_ida": 2e-4,
    "int8_chain": 1e-4,  # the same CenterNet as plain_ida
}
# north_star's bf16 CenterNet: kernel C and its plain version round a few
# bf16 sums one ulp apart, and a bf16 net spreads that; raw heads within
# this many bf16 ulps of the largest head value (the CPU tests measured
# 2 against the JAX package), decoded sizes within 2 ulps of the largest
# size, centres and scores within 1e-3.
NS_HEAD_ULPS = 4
NS_SIZE_ULPS = 2
P1_ITERS = (1, 6, 17)  # iterations of probe P1's copy checks (17: j wraps)
P1_DOT_ITERS = (1, 6)  # of its dots: 2 sums into bank 0, each |.| < ~30
P1_DOT_ATOL = 1e-4    # f32 sums of exact bf16 products in another order
DCN_TOL = 1e-4        # f32 rtol and atol: 9 C (up to 4,608) 3xTF32
                      # products an output, summed in another order than
                      # the plain version's per-tap GEMMs
# bf16: the samples round as the plain version's do, so outputs differ by
# the f32 sums of the same exact bf16 products taken in another order,
# then rounded once: one bf16 ulp of the larger output plus 9 C 2^-24
# max|plain| (the accumulation-order term).
PLANTED_OFFSET = 40.0  # cells: past the map edge, as torch-trained offsets go
DCN_WINDOW = 3.0      # the served and trained DCN window (bench.py, the JAX CLI)
WINDOW_REACH = 6.0    # cells the window check scales the net's offsets to
N_DCN = 16            # DeformConv2d calls of one DCN-IDA forward
N_DCN_SHAPES = 7      # distinct (x shape, O) among them
UPSAMPLES = ("protonet/upsample_1", "protonet/upsample_2")
D_NEXT = {"protonet/upsample_1": "protonet/mid_0", "protonet/upsample_2": "protonet/post_0"}

# H100 SXM data sheet, dense, at the 700 W power limit; "tf32" is the
# tensor cores' TF32 rate, which kernel E's 3xTF32 f32 products run at.
PEAK = {"bytes": 3.35e12, "f32": 67e12, "tf32": 495e12, "bf16": 989e12, "int8": 1979e12}

KERNELS = {
    "peak_decode": ("tauv_vision_tpu_torch/csrc/peak_decode.cu",
                    "tauv_vision_tpu/ops/pallas/peak_decode.py:99"),
    "mask_assembly": ("tauv_vision_tpu_torch/csrc/mask_assembly.cu",
                      "tauv_vision_tpu/ops/pallas/mask_assembly.py:62"),
    "depthwise_upsample": ("tauv_vision_tpu_torch/csrc/depthwise_upsample.cu",
                           "tauv_vision_tpu/ops/pallas/depthwise_upsample.py:81"),
    "deform_conv": ("tauv_vision_tpu_torch/csrc/deform_conv.cu",
                    "tauv_vision_tpu/ops/pallas/deform_conv.py:409"),
    "transpose_conv": ("tauv_vision_tpu_torch/csrc/transpose_conv.cu",
                       "tauv_vision_tpu/ops/pallas/transpose_conv.py:85"),
    "int8_dot_probe": ("tauv_vision_tpu_torch/csrc/int8_dot_probe.cu",
                       "tauv_vision_tpu/scripts/mosaic_int8_dot_probe.py:64"),
    "op_probe": ("tauv_vision_tpu_torch/csrc/op_probe.cu",
                 "tauv_vision_tpu/scripts/mosaic_op_probe.py:126"),
}
# The kernels line's rows: {row: (kernel, entry point whose launches the
# row reports, None for all of the kernel's)}.  Kernel C has a row for
# each dtype; P1 a row for each of the JAX probe's sites.
ROWS = {
    "peak_decode": ("peak_decode", None),
    "peak_decode_k50": ("peak_decode", None),
    "mask_assembly": ("mask_assembly", None),
    "mask_assembly_belief": ("mask_assembly", None),
    "depthwise_upsample": ("depthwise_upsample", "tauv_depthwise_upsample_f32"),
    "depthwise_upsample_bf16": ("depthwise_upsample", "tauv_depthwise_upsample_bf16"),
    "deform_conv": ("deform_conv", "tauv_deform_conv_f32"),
    "deform_conv_bf16": ("deform_conv", "tauv_deform_conv_bf16"),
    "transpose_conv": ("transpose_conv", None),
    "int8_dot_probe": ("int8_dot_probe", None),
    "op_probe/dot": ("op_probe", "tauv_op_probe_dot"),
    "op_probe/slice_copy": ("op_probe", "tauv_op_probe_copy"),
    "op_probe/lane_shift": ("op_probe", "tauv_op_probe_copy"),
    "op_probe/decimate": ("op_probe", "tauv_op_probe_decimate"),
    "op_probe/transpose": ("op_probe", "tauv_op_probe_transpose"),
}
# Rows that report one variant of their kernel's launches (kernel A at
# K = 50: the keypoint heatmap's calls; kernel B without the crop: the
# YOLO-Pose belief maps).
ROW_VARIANTS = {"peak_decode_k50": ("peak_decode", "K=50"),
                "mask_assembly_belief": ("mask_assembly", "no crop")}
# P1: the JAX site each row replaces, and the probe row it reports.
P1_ROWS = {
    "op_probe/dot": (126, "dot[32x144xN640]"),
    "op_probe/slice_copy": (190, "slice_copy 3x[16,642]"),
    "op_probe/lane_shift": (227, "lane-shift copy 2x[16,640]"),
    "op_probe/decimate": (269, "decimate/strided [32,640]->[32,320]"),
    "op_probe/transpose": (309, "transpose [32,320]->[320,32]+bf16"),
}
PATHS = ("plain_ida", "dcn_ida", "int8_chain", "north_star", "dcn_north_star")
# The int8-chain pairs: {path: (recipe, the f32 path whose CenterNet weights
# it serves)}.  bench.py times the CenterNet chain and the YOLACT chain as
# two requests on the same frames (bench.py:1620-1627), and so do these.
CHAIN_PAIRS = {"chain_int8": (CHAIN_INT8, "plain_ida"), "dcn_chain_int8": (DCN_CHAIN_INT8, "dcn_ida")}
KP_INT8 = "keypoints_int8"
# The paths whose launches the kernels line reports: the served paths and
# the trainer's run.
YP_INT8, YP_PER_LAYER = "yolo_pose_int8", "yolo_pose_per_layer_int8"
ALL_PATHS = PATHS + ("keypoints",) + tuple(CHAIN_PAIRS) + (KP_INT8, "train", "train_cli",
                                                             "train_yolact", "yolo_pose",
                                                             YP_INT8, YP_PER_LAYER,
                                                             "train_yolo_pose", "parity_int8",
                                                             "parity_int8_corrected",
                                                             "parity_int8_seq", "per_layer_int8",
                                                             "qat", "host_io", "bf16_pair",
                                                             "bf16_pair_fused", "bf16_pair_bn_bf16",
                                                             "bf16_pair_f32_early",
                                                             "bf16_pair_f32_level3",
                                                             "north_star_exact",
                                                             "keypoints_per_layer_int8")
PAIR_ITERS = 3        # timed repetitions of a pair path's request at batch 32
CHAIN_ITERS = 2       # of each of a chain pair's two requests
# Kernel E's 16 calls of a forward at the path's window, and at the other
# (the plain version takes ~0.2 s a forward).
DCN_ITERS = 5
DCN_OTHER_ITERS = 3
# The paths beside an int8-chain YOLACT, and its recipe on each.
CHAIN_RECIPES = {"int8_chain": INT8_CHAIN_YOLACT, "north_star": NORTH_STAR.yolact,
                 "dcn_north_star": DCN_NORTH_STAR.yolact}
BF16_PATHS = ("north_star", "dcn_north_star")   # the bf16 CenterNet's
# The chain pairs' decoded CenterNet, kernels against plain versions:
# 100% matched and every p95 within this (the PARITY.md bar).  On
# dcn_chain_int8 kernel E sums in another order than its plain version, so
# codes after the DCN blocks may differ by one or two, and the heads by
# what that moves them.
CHAIN_P95 = 1e-3
DCN_PATHS = ("dcn_ida", "dcn_north_star")
# The bf16 CenterNets: {path: (recipe, the f32 path whose weights it serves)}.
BF16_NETS = {"north_star": (NORTH_STAR, "plain_ida"), "dcn_north_star": (DCN_NORTH_STAR, "dcn_ida")}


def lap(label: str, since: float) -> float:
    """Print the seconds since ``since`` as a section of a phase; returns
    now."""
    now = time.perf_counter()
    print(f"section {label}: {now - since:.1f} s")
    return now


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def bound(n_bytes: float, ops: float, peak_ops: float):
    """(least ms, "bytes" or "operations") for moving n_bytes and doing ops."""
    t_bytes, t_ops = n_bytes / PEAK["bytes"], ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bf16_ulp(magnitude):
    """One bf16 ulp at ``magnitude`` (a tensor or a float)."""
    m = torch.as_tensor(magnitude, dtype=torch.float32).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


# ---- phase 1 ------------------------------------------------------------

def device_phase() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return smi.splitlines()[0]


# ---- phase 2 ------------------------------------------------------------

def build_phase() -> None:
    path, seconds, log = kernels.build(("-Xptxas", "-v"))
    kernels.library()
    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    print(f"build: {path.name} in {seconds:.1f} s "
          f"({'cached' if seconds == 0 else 'compiled'}), {len(sources)} kernel "
          f"sources {sources}, entry points {sorted(kernels._SIGNATURES)}")
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas: " + line.split("ptxas info    : ")[-1].strip())


# ---- models -------------------------------------------------------------

def request_frames(seed: int, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape, np.uint8))


def upsample_scales(yl, img):
    """Per-input-channel scales of the protonet's two transposed convs by
    ``calibrate``'s rule (max(absmax, 1e-6) / 127 of the f32 forward's
    input), which ``calibrate`` itself does not record."""
    absmax = {}
    hooks = [getattr(yl._masknet, f"_upsample_layer_{i}").register_forward_pre_hook(
        lambda m, args, i=i: absmax.__setitem__(
            f"protonet/upsample_{i}", args[0].abs().amax(dim=(0, 2, 3)).double().cpu().numpy()))
        for i in (1, 2)]
    with torch.inference_mode():
        yl(img)
    for h in hooks:
        h.remove()
    return {path: np.maximum(v, 1e-6) / 127.0 for path, v in absmax.items()}


def build_models(device):
    """{path: (CenterNet on the kernels, the same weights on the plain
    versions)}, the CenterNet config, YOLACT, its config and the int8
    chains of that YOLACT: {chain path: {"kernel": (ctx, forward),
    "plain": (ctx, forward)}}."""
    oc, cn_cfg = centernet_config()
    yl_cfg = yolact_config()
    nets = {}
    for path, seed, deform in (("plain_ida", 0, False), ("dcn_ida", 2, True)):
        cn = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(seed),
                              device=device, deform=deform).eval()
        cn_plain = CenterpointDLA34(oc, up_impl="plain", device=device,
                                    deform=deform, dcn_impl="plain").eval()
        cn_plain.load_state_dict(cn.state_dict())
        nets[path] = (cn, cn_plain)
    nets["int8_chain"] = nets["plain_ida"]
    # The served recipes' bf16 CenterNets, on the f32 paths' weights.
    for path, (recipe, f32_path) in BF16_NETS.items():
        state = nets[f32_path][0].state_dict()
        bf16 = []
        for impl in ("kernel", "plain"):
            cn = CenterpointDLA34(oc, up_impl=impl, dcn_impl=impl, device=device,
                                  **recipe.centernet_kwargs()).eval()
            cn.load_state_dict(state)
            bf16.append(cn)
        nets[path] = tuple(bf16)
    yl = Yolact(yl_cfg, generator=torch.Generator().manual_seed(1), device=device).eval()

    # bench.py's int8 YOLACT rung (CHAIN_RECIPES): per-channel scales on
    # the first 2 frames, head and protonet output stripped, bf16 with
    # bf16 joins (ChainCtx's defaults); on int8_chain the two upsample
    # scales added.
    cal = request_frames(0, (N_CALIBRATION, FRAME_H, FRAME_W, 3)).to(device)
    img = preprocess(cal, (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean, yl_cfg.img_stddev)
    chains = {}
    for path, recipe in CHAIN_RECIPES.items():
        same = [p for p in chains if CHAIN_RECIPES[p] == recipe]
        if same:   # dcn_north_star's YOLACT is north_star's
            chains[path] = chains[same[0]]
            continue
        scales = strip_scales(calibrate(yl, [img], per_channel=recipe.per_channel),
                              recipe.float_paths)
        served = {**scales, **(upsample_scales(yl, img) if recipe.int8_transposes else {})}
        chains[path] = {}
        for impl in ("kernel", "plain"):
            ctx = ChainCtx(yl, served, dtype=recipe.dtype, join_dtype=recipe.join_dtype,
                           impl=impl)
            chains[path][impl] = (ctx, yolact_chain_forward(ctx))
        print(f"int8 chain of {path}: {len(served)} calibrated convs ({len(scales)} by "
              f"calibrate, {sorted(set(served) - set(scales))} added), bf16 head and joins")
    return nets, cn_cfg, yl, yl_cfg, chains


def build_chain_nets(nets, cn_cfg, yl, yl_cfg, kp_net, device):
    """The int8-chain paths' nets, calibrated as ``bench.py`` calibrates
    them (per-tensor scales on the first 2 frames; the CenterNet's of its
    bf16 model with f32 BatchNorm outputs, keyed by
    ``centerpoint_calibration_paths``): ({chain pair: {"model", "scales",
    "kernel": (ctx, forward), "plain": (ctx, forward)}}, the pairs'
    YOLACT scales, the keypoint chain's scales).  The CenterNets serve
    the f32 paths' weights; the keypoint chain the ``keypoints`` net, its
    keypoint head rescaled."""
    cal = request_frames(0, (N_CALIBRATION, FRAME_H, FRAME_W, 3)).to(device)
    oc, _ = centernet_config()
    chains = {}
    for path, (recipe, f32_path) in CHAIN_PAIRS.items():
        cn = CenterpointDLA34(oc, device=device, **recipe.centernet_kwargs()).eval()
        cn.load_state_dict(nets[f32_path][0].state_dict())
        img = preprocess(cal, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                         recipe.input_dtype)
        scales = calibrate(cn, [img], paths_of=centerpoint_calibration_paths)
        chains[path] = {"model": cn, "scales": scales}
        for impl in ("kernel", "plain"):
            ctx = ChainCtx(cn, scales, dtype=recipe.input_dtype, join_dtype=None, impl=impl,
                           path_of=centerpoint_flax_path)
            chains[path][impl] = (ctx, dla34_chain_forward(ctx))
        print(f"int8 chain CenterNet of {path}: {len(scales)} calibrated convs, per-tensor, "
              f"{len(cn.deform_convs())} bf16 DCN blocks, f32 joins")
    recipe = CHAIN_INT8.yolact
    img = preprocess(cal, (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean, yl_cfg.img_stddev)
    yl_scales = strip_scales(calibrate(yl, [img], per_channel=recipe.per_channel),
                             recipe.float_paths)
    kp, _, _, kp_cfg, _ = kp_net
    img = preprocess(cal, (kp_cfg.in_h, kp_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                     KEYPOINTS.input_dtype)
    kp_scales = calibrate(kp, [img], paths_of=centerpoint_calibration_paths)
    print(f"int8 chain YOLACT of the chain pairs: {len(yl_scales)} calibrated convs, "
          f"per-tensor, prediction head int8, f32 joins; keypoint chain: {len(kp_scales)}")
    return chains, yl_scales, kp_scales


def chain_pair_pipelines(path, chains, cn_cfg, yl, yl_scales, knobs=SERVING_DECODE):
    """{impl: (CenterNet chain pipeline, YOLACT chain pipeline)} of a chain
    pair: the two requests ``bench.py`` times, each preprocessing its own
    bf16 image."""
    recipe, device = CHAIN_PAIRS[path][0], torch.device("cuda")
    net = chains[path]
    return {impl: (
        make_centernet_chain_pipeline(net["model"], cn_cfg, net["scales"], device, knobs,
                                      dtype=recipe.input_dtype, impl=impl),
        make_yolact_chain_pipeline(yl, yl_scales, device, knobs, dtype=recipe.yolact.dtype,
                                   join_dtype=recipe.yolact.join_dtype, impl=impl))
        for impl in ("kernel", "plain")}


def keypoint_chain_pipelines(kp_net, kp_scales, knobs=SERVING_DECODE):
    """(the keypoint chain's pipeline on the kernels, on the plain versions)."""
    kp, _, _, cfg, projection = kp_net
    return tuple(make_centernet_keypoint_chain_pipeline(
        kp, cfg, kp_scales, projection, torch.device("cuda"), knobs, dtype=KEYPOINTS.input_dtype,
        impl=impl) for impl in ("kernel", "plain"))


def keypoint_chain_forward(kp, kp_scales, impl, with_ctx=False):
    """The keypoint net's chain forward on ``impl`` (with its context)."""
    ctx = ChainCtx(kp, kp_scales, dtype=KEYPOINTS.input_dtype, join_dtype=None, impl=impl,
                   path_of=centerpoint_flax_path)
    forward = dla34_chain_forward(ctx)
    return (ctx, forward) if with_ctx else forward


def chain_upsample_calls(forward, img):
    """(x, weight, factor) of every depthwise upsample of one chain forward
    on the plain versions (kernel C's inputs: the f32 BatchNorm output
    cast to bf16)."""
    calls, plain = [], quantize_chain.depthwise_upsample

    def record(x, w, f):
        calls.append((x.clone(), w, f))
        return plain(x, w, f)

    quantize_chain.depthwise_upsample = record
    try:
        forward(img)
    finally:
        quantize_chain.depthwise_upsample = plain
    return calls


def chain_codes(ctx, forward, img):
    """{path: int8 output} of every layer of one chain forward that emits
    int8."""
    return chain_calls(ctx, forward, img)["codes"]


def build_keypoint_nets(device):
    """(the keypoint CenterNet on the kernels, the same weights on the
    plain versions, its object config, model config, projection)."""
    oc, cfg, projection = keypoints_config()
    kp = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(3), device=device,
                          **KEYPOINTS.centernet_kwargs()).eval()
    # Seeded random weights give the 8 keypoint channels different means
    # and tails of logits, and the top 50 peaks then come from one to three
    # of them: a detection claims two or three keypoints and no PnP has
    # work.  The keypoint head's output conv is rescaled channel by
    # channel, on 4 seeded frames, to logits of mean 0 whose 99.95th
    # percentile (about the 50 peaks of an image over 8 channels) is 1, so
    # that every channel peaks and detections claim up to 8 keypoints.
    with torch.inference_mode():
        img = preprocess(request_frames(9, (4, FRAME_H, FRAME_W, 3)).to(device),
                         (cfg.in_h, cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                         KEYPOINTS.input_dtype)
        logits = kp(img).keypoint_heatmap.float().reshape(-1, oc.n_keypoints)
        mean, top = logits.mean(dim=0), torch.quantile(logits, 0.9995, dim=0)
    head = getattr(kp.model, "1")[2]
    with torch.no_grad():
        scale = 1.0 / (top - mean)
        head.weight *= scale[:, None, None, None]
        head.bias.copy_((head.bias - mean) * scale)
    kp_plain = CenterpointDLA34(oc, up_impl="plain", device=device,
                                **KEYPOINTS.centernet_kwargs()).eval()
    kp_plain.load_state_dict(kp.state_dict())
    return kp, kp_plain, oc, cfg, projection


def keypoint_heatmaps(kp_plain, cfg, gen):
    """The keypoint net's object and keypoint heatmaps, batch 16."""
    img = torch.randn((KP_BATCH, 3, cfg.in_h, cfg.in_w), generator=gen, device="cuda")
    with torch.inference_mode():
        pred = kp_plain(img)
    return pred.heatmap_nchw().contiguous(), pred.keypoint_heatmap_nchw().contiguous()


def hooked_calls(cn_plain, modules, img, record):
    """``record(module, args)`` of every call of ``modules`` in one forward."""
    calls = []
    hooks = [m.register_forward_pre_hook(lambda m, args: calls.append(record(m, args)))
             for m in modules]
    with torch.inference_mode():
        cn_plain(img)
    for h in hooks:
        h.remove()
    return calls


def upsample_calls(cn_plain, img):
    """(x, weight, factor) of every DepthwiseUpsample call of one forward,
    x and the weight in the dtype the module computes in (its kernel's
    inputs)."""
    return hooked_calls(cn_plain, cn_plain.depthwise_upsamples(), img, lambda m, args: (
        args[0].to(m.dtype).clone(), m.weight.detach().to(m.dtype), m.factor))


def dcn_calls(cn_plain, img):
    """(x, offset, mask, weight, bias) of every DeformConv2d call of one
    forward: the net's own offsets and masks, the weight in x's dtype."""
    return hooked_calls(cn_plain, cn_plain.deform_convs(), img, lambda m, args: (
        *(a.clone() for a in args), m.weight.detach().to(args[0].dtype), m.bias.detach()))


def dcn_shapes(calls):
    """{(x shape, O): (the first call of that shape, how many calls)}."""
    shapes = {}
    for call in calls:
        key = (tuple(call[0].shape), call[3].shape[0])
        first, n = shapes.get(key, (call, 0))
        shapes[key] = (first, n + 1)
    return shapes


def dcn_flop(calls) -> int:
    """Multiply-adds x 2 of the DCN products (the sampling not counted)."""
    return sum(2 * 9 * x.numel() * w.shape[0] for x, _, _, w, _ in calls)


def dcn_bound(calls):
    """(least ms, by) of kernel E's calls: each input read once, each
    output written once, and the products at the card's fastest rate for
    their type.  bf16 runs on the tensor cores; f32 takes the lesser of
    its two routes, the CUDA cores' f32 rate and the tensor cores' TF32
    rate at 3 products each (the 3xTF32 split kernel E uses)."""
    x = calls[0][0]
    n_bytes = sum(nbytes(*c) + x.element_size() * c[0].shape[0] * c[3].shape[0]
                  * c[0].shape[2] * c[0].shape[3] for c in calls)
    flop = dcn_flop(calls)
    if x.dtype == torch.bfloat16:
        return bound(n_bytes, flop, PEAK["bf16"])
    return min(bound(n_bytes, flop, PEAK["f32"]), bound(n_bytes, 3 * flop, PEAK["tf32"]))


def dcn_plan(shape, o, dtype):
    """Kernel E's launch plan for a call on this card."""
    return deform_conv.plan(*shape, o, dtype,
                            torch.cuda.get_device_properties(0).multi_processor_count)


def chain_calls(ctx, forward, img):
    """One chain forward of ``img``: {"transpose": [(x_q, qk, deq, bias,
    out_scale, act, out_dtype, taps)] of kernel D's two calls, "int8_conv":
    [(q, qk, stride, padding)] of every integer conv, "maps": {path:
    output} of the protonet's layers, "codes": {path: output} of every
    layer that emits int8}."""
    record = {"transpose": [], "int8_conv": [], "maps": {}, "codes": {}}
    run_layer, conv = ctx.run_layer, quantize_chain.conv2d_int8

    def run(inp, path, **kwargs):
        y = run_layer(inp, path, **kwargs)
        if path.startswith("protonet/"):
            record["maps"][path] = y
        if y.dtype == torch.int8:
            record["codes"][path] = y
        if path in UPSAMPLES and path in ctx.scales:   # kernel D's calls
            qk, deq, bias, out_scale, taps = ctx.transpose_args(path, D_NEXT[path])
            record["transpose"].append((inp, qk, deq, bias, out_scale, "leaky", torch.int8, taps))
        return y

    def int8_conv(q, qk, stride, padding):
        record["int8_conv"].append((q, qk, stride, padding))
        return conv(q, qk, stride, padding)

    ctx.run_layer, quantize_chain.conv2d_int8 = run, int8_conv
    try:
        forward(img)
    finally:
        del ctx.run_layer
        quantize_chain.conv2d_int8 = conv
    return record


# ---- phase 3 ------------------------------------------------------------

def planted_ties(shape, gen):
    """Saturated cells (sigmoid == 1.0 exactly in f32) and plateaus on
    both sides of kernel A's band edges (rows 16, 48, 80) and in several
    channels, so equal scores meet in the merge from different tiles."""
    x = torch.randn(shape, generator=gen, device="cuda") * 3 - 6
    x[:, 2, 15, 4] = 20.0
    x[:, 0, 16, 100] = 25.0
    x[:, 1, 79, 7] = 30.0
    x[:, 3, 80, 60] = 40.0
    x[:, 3, 47:49, 120] = 12.0    # a 2-cell plateau across a band edge
    x[:, 1, 63, 30:32] = 12.0     # and one along a row
    return x


def sparse_peaks(shape):
    """Fewer than K positive cells: sigmoid(-200) is 0 in f32, so all but
    3 cells are zeros, which tie and go to the smallest flat index."""
    x = torch.full(shape, -200.0, device="cuda")
    x[:, 1, 0, 0] = 2.0
    x[:, 2, 16, 159] = 3.0
    x[:, 0, 89, 80] = 1.0
    return x


def peak_cases(b, hh, ww, gen, net_heatmap):
    """(name, logits, K) of kernel A's checks."""
    shape = (b, 4, hh, ww)
    random = torch.randn(shape, generator=gen, device="cuda") * 3
    ties = planted_ties(shape, gen)
    wide = torch.randn((2, 3, 37, 300), generator=gen, device="cuda") * 3
    return [("random", random, 10), ("random", random, 1), ("random", random, 128),
            ("planted_ties", ties, 10), ("planted_ties", ties, 128),
            ("sparse", sparse_peaks(shape), 10), ("sparse", sparse_peaks(shape), 128),
            ("flat", torch.zeros(shape, device="cuda"), 128),
            ("net_heatmap", net_heatmap, 10),
            ("two_column_tiles", wide, 10), ("two_column_tiles", wide, 128)]


def mask_cases(gen, net_proto):
    """(name, prototypes [B, P, H, W]) of kernel B's checks: the chain's own
    NHWC-view prototypes and their NCHW copy, P = 32, a ragged width."""
    cases = [("net_nhwc", net_proto), ("net_nchw", net_proto.contiguous())]
    for name, (b, p, h, w) in (("p32", (2, 32, 45, 80)), ("ragged_w78", (2, 8, 45, 78))):
        proto = torch.randn((b, h, w, p), generator=gen, device="cuda").permute(0, 3, 1, 2)
        cases += [(f"{name}_nhwc", proto), (f"{name}_nchw", proto.contiguous())]
    return cases


def check_phase(nets, cn_cfg, yl_cfg, chains, yl_img, kp_net, kp_maps):
    cn_plain = nets["plain_ida"][1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    b = CHECK_BATCH
    hh, ww = cn_cfg.out_h, cn_cfg.out_w
    k = SERVING_DECODE.n_detections
    img = torch.randn((b, 3, cn_cfg.in_h, cn_cfg.in_w), generator=gen, device="cuda")
    with torch.inference_mode():
        real_heatmap = cn_plain(img).heatmap_nchw().contiguous()
    # scripts/kernel_times.py times A and B at the nets' shapes.
    require((tuple(real_heatmap.shape), k) == kernel_times.A_CALL,
            "kernel A's call is not kernel_times.A_CALL")
    # The keypoints path's two calls: its object heatmap at K = 10 and its
    # keypoint heatmap at K = 50 (also on random logits of that shape).
    require([(tuple(m.shape), kk) for m, kk in zip(kp_maps, (10, 50))] ==
            [((KP_BATCH, 1, hh, ww), SERVING_DECODE.n_detections),
             ((KP_BATCH, 8, hh, ww), SERVING_DECODE.keypoint_n_detections)],
            f"keypoint heatmaps {[tuple(m.shape) for m in kp_maps]}")
    keypoint_cases = [
        ("keypoints_net_heatmap", kp_maps[0], 10),
        ("keypoints_net_keypoint_heatmap", kp_maps[1], 50),
        ("random_keypoint_shape", torch.randn(kp_maps[1].shape, generator=gen, device="cuda") * 3,
         50)]
    err, err_k50 = 0.0, 0.0
    for name, x, kk in peak_cases(b, hh, ww, gen, real_heatmap) + keypoint_cases:
        got, want = peak_decode_cuda(x, kk), peak_decode(x, kk)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]), f"peak_decode {name} K={kk}: index differs")
        require(torch.equal(got[1], want[1]), f"peak_decode {name} K={kk}: label differs")
        e = (got[2] - want[2]).abs().max().item()
        require(e <= PEAK_ATOL, f"peak_decode {name} K={kk}: score err {e}")
        err = max(err, e)
        print(f"check peak_decode {name} {tuple(x.shape)} K={kk}: index/label "
              f"exact, score max_abs_err {e:.3g} (atol {PEAK_ATOL}), "
              f"{int((want[2] > 0).sum())} of {want[2].numel()} slots positive")
        if kk == 50:
            err_k50 = max(err_k50, e)
    errs["peak_decode"] = err
    errs["peak_decode_k50"] = err_k50

    kk = SERVING_DECODE.top_k
    with torch.inference_mode():
        net_proto = chains["north_star"]["kernel"][1](yl_img).mask_prototype.permute(0, 3, 1, 2)
    require((tuple(net_proto.shape), kk) == kernel_times.B_CALL,
            "kernel B's call is not kernel_times.B_CALL")
    err = 0.0
    for name, proto in mask_cases(gen, net_proto):
        bb, p = proto.shape[:2]
        coeff = torch.tanh(torch.randn((bb, kk, p), generator=gen, device="cuda"))
        box = torch.cat([torch.rand((bb, kk, 2), generator=gen, device="cuda"),
                         torch.rand((bb, kk, 2), generator=gen, device="cuda") * 0.6], -1)
        for crop in (True, False):
            bx = box if crop else None
            got, want = assemble_mask_cuda(proto, coeff, bx), assemble_mask_batch(proto, coeff, bx)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            require(e <= MASK_ATOL, f"mask_assembly {name} crop={crop}: err {e}")
            err = max(err, e)
            print(f"check mask_assembly {name} proto {tuple(proto.shape)} strides "
                  f"{proto.stride()} K={kk} crop={crop}: max_abs_err {e:.3g} (atol {MASK_ATOL})")
    errs["mask_assembly"] = err

    err = 0.0
    seen = set()
    for x, w, f in upsample_calls(cn_plain, img):
        shape = (tuple(x.shape), f)
        if shape in seen:
            continue
        seen.add(shape)
        for wname, weight in (("bilinear", w),
                              ("random", torch.randn(w.shape, generator=gen, device="cuda"))):
            got, want = depthwise_upsample_cuda(x, weight, f), depthwise_upsample(x, weight, f)
            torch.cuda.synchronize()
            require(got.shape == want.shape, f"depthwise_upsample shape {got.shape}")
            bad = (got - want).abs() > UPSAMPLE_TOL + UPSAMPLE_TOL * want.abs()
            e = (got - want).abs().max().item()
            require(not bad.any().item(), f"depthwise_upsample {shape}: err {e}")
            err = max(err, e)
            print(f"check depthwise_upsample f={f} {tuple(x.shape)} {wname}: "
                  f"max_abs_err {e:.3g} (rtol=atol={UPSAMPLE_TOL})")
    errs["depthwise_upsample"] = err

    # Kernel C in bf16 at the 8 upsamples of a north_star forward and at
    # those of the keypoints path's forwards on its own frames (batch 16 and
    # batch 1): equal or one bf16 ulp apart (4 exact products summed in f32
    # in another order than cuDNN's, then rounded once).
    err, differ, total = 0.0, 0, 0
    kp_plain, kp_cfg = kp_net[1], kp_net[3]
    kp_img = preprocess(request_frames(4, (KP_REQUESTS, KP_BATCH, FRAME_H, FRAME_W, 3))[0].cuda(),
                        (kp_cfg.in_h, kp_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                        KEYPOINTS.input_dtype)
    for tag, net, frames in (("north_star", nets["north_star"][1], img),
                             ("keypoints", kp_plain, kp_img),
                             ("keypoints_b1", kp_plain, kp_img[:1])):
        calls = upsample_calls(net, frames)
        require(len(calls) == 8 and all(x.dtype == torch.bfloat16 for x, _, _ in calls),
                f"{tag}: expected 8 bf16 upsamples")
        for i, (x, w, f) in enumerate(calls):
            line = []
            for wname, weight in (("net", w), ("random", torch.randn(
                    w.shape, generator=gen, device="cuda").to(torch.bfloat16))):
                got = depthwise_upsample_cuda(x, weight, f)
                want = depthwise_upsample(x, weight, f)
                torch.cuda.synchronize()
                require(got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape,
                        f"depthwise_upsample bf16 {tuple(x.shape)}: {got.dtype} {tuple(got.shape)}")
                diff = (got.float() - want.float()).abs()
                ulps = (diff / bf16_ulp(torch.maximum(got.float().abs(),
                                                      want.float().abs()))).max().item()
                require(ulps <= 1.0,
                        f"depthwise_upsample bf16 {tag} {tuple(x.shape)} {wname}: {ulps} ulps")
                n = int((got != want).sum().item())
                differ, total = differ + n, total + got.numel()
                err = max(err, diff.max().item())
                line.append(f"{wname} weight {n} of {got.numel()} one ulp apart, "
                            f"max_abs_err {diff.max().item():.3g}")
            print(f"check depthwise_upsample_bf16 {tag} call {i} f={f} {tuple(x.shape)}: "
                  f"{'; '.join(line)} (tolerance one bf16 ulp)")
    print(f"check depthwise_upsample_bf16: {differ / total:.3g} of all elements differ")
    errs["depthwise_upsample_bf16"] = err

    # Kernel E: f32 at dcn_ida's calls, bf16 at dcn_north_star's (the
    # net's own bf16 offsets and masks), each distinct shape once, at the
    # path's window (dcn_ida: none; dcn_north_star: 3 cells); then the
    # net's offsets scaled to reach WINDOW_REACH cells, so that a share of
    # them lies past the 3-cell window, at R = 3 and at no window (the
    # f32 calls' R = 3 is the window set on a copy of dcn_ida's call).
    for row, path in (("deform_conv", "dcn_ida"), ("deform_conv_bf16", "dcn_north_star")):
        calls = dcn_calls(nets[path][1], img)
        require(len(calls) == N_DCN, f"{path}: {len(calls)} DCN calls a forward, expected {N_DCN}")
        by_shape = dcn_shapes(calls)
        require(len(by_shape) == N_DCN_SHAPES,
                f"{path}: {len(by_shape)} distinct DCN shapes, expected {N_DCN_SHAPES}")
        path_window = nets[path][1].deform_convs()[0].max_offset
        require(path_window == {"dcn_ida": None, "dcn_north_star": DCN_WINDOW}[path],
                f"{path}: DCN window {path_window}")
        err, differ, total = 0.0, 0, 0
        past, n_offsets, window_errs = 0, 0, {DCN_WINDOW: 0.0, None: 0.0}
        for (shape, o), ((x, offset, mask, w, bias), _) in by_shape.items():
            planted = (torch.rand(offset.shape, generator=gen, device="cuda") * 2 - 1
                       ) * PLANTED_OFFSET
            reach = offset.abs().max().item()
            scaled = offset * (WINDOW_REACH / reach)
            past += int((scaled.abs() > DCN_WINDOW).sum().item())
            n_offsets += scaled.numel()
            for case, args, window in (
                    ("net", (x, offset, mask, w, bias), path_window),
                    ("planted_40", (x, planted, mask, w, bias), path_window),
                    ("no_mask", (x, offset, None, w, bias), path_window),
                    ("batch_7", (x[:7], offset[:7], mask[:7], w, bias), path_window),
                    (f"scaled_R{DCN_WINDOW:g}", (x, scaled, mask, w, bias), DCN_WINDOW),
                    ("scaled_no_window", (x, scaled, mask, w, bias), None)):
                got = deform_conv2d_cuda(*args, max_offset=window)
                want = deform_conv2d(*args, max_offset=window)
                torch.cuda.synchronize()
                require(got.dtype == want.dtype == x.dtype and
                        got.shape == want.shape == (args[0].shape[0], o) + shape[2:],
                        f"deform_conv {got.dtype} shape {tuple(got.shape)}")
                require(bool(torch.isfinite(got).all()), f"deform_conv {shape} {case}: non-finite")
                diff = (got.float() - want.float()).abs()
                if x.dtype == torch.float32:
                    bar = DCN_TOL + DCN_TOL * want.abs()
                    tol = f"rtol=atol={DCN_TOL}"
                else:
                    big = torch.maximum(got.float().abs(), want.float().abs())
                    bar = bf16_ulp(big) + 9 * shape[1] * 2.0 ** -24 * want.float().abs().max()
                    tol = "one bf16 ulp + 9 C 2^-24 max|plain|"
                e = diff.max().item()
                require(not (diff > bar).any().item(), f"{row} {shape}->{o} {case}: err {e}")
                n = int((got != want).sum().item())
                differ, total = differ + n, total + got.numel()
                err = max(err, e)
                if case.startswith("scaled"):
                    window_errs[window] = max(window_errs[window], e)
                print(f"check {row} {shape} -> O={o} {case} (window {window})"
                      f"{f' (net |offset| <= {reach:.2f})' if case == 'net' else ''}: "
                      f"max_abs_err {e:.3g}, {n} of {got.numel()} outputs differ, "
                      f"max |plain| {want.abs().max().item():.3g} ({tol}), "
                      f"plan {dcn_plan(args[0].shape, o, x.dtype)}")
        print(f"check {row}: {differ / total:.3g} of all outputs differ from the plain version; "
              f"offsets scaled to reach {WINDOW_REACH:g} cells: {past / n_offsets:.3g} of them "
              f"past +-{DCN_WINDOW:g}, E against the plain version max_abs_err "
              f"{window_errs[DCN_WINDOW]:.3g} at R={DCN_WINDOW:g} and "
              f"{window_errs[None]:.3g} with no window")
        require(past > 0, f"{row}: no scaled offset past the window")
        errs[row] = err

    # Kernel D: bit-equal, at both served shapes with the net's codes,
    # weights and epilogue, each activation, int8 and bf16 out.
    ctx, forward = chains["int8_chain"]["kernel"]
    record = chain_calls(ctx, forward, yl_img)
    require(len(record["transpose"]) == 2, f"{len(record['transpose'])} kernel D calls")
    cases = []
    for x_q, qk, deq, bias_, scale, _, _, taps in record["transpose"]:
        for act in ("leaky", "relu", "none"):
            for out_dtype in (torch.int8, torch.bfloat16):
                cases.append((x_q, qk, deq, bias_, scale, act, out_dtype, taps))
    x_q, qk, deq, bias_, scale, _, _, taps = record["transpose"][0]
    odd = x_q[:, :, :x_q.shape[2] - 1].contiguous()
    cases.append((odd, qk, deq, bias_, scale, "leaky", torch.int8, taps))
    err = 0.0
    for x_q, qk, deq, bias_, scale, act, out_dtype, taps in cases:
        got = transpose_conv2x_int8_cuda(x_q, qk, deq, bias_, scale, act=act,
                                         out_dtype=out_dtype, taps=taps)
        want = transpose_conv2x_int8(x_q, qk, deq, bias_, scale, act=act, out_dtype=out_dtype)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        require(torch.equal(got, want), f"transpose_conv {tuple(x_q.shape)} {act} "
                                        f"{out_dtype}: not bit-equal, max_abs_err {e}")
        err = max(err, e)
        print(f"check transpose_conv {tuple(x_q.shape)} -> {tuple(got.shape)} {act} "
              f"{str(out_dtype).split('.')[-1]}: bit-equal (|code| = 127 in "
              f"{(want.float().abs() == 127).float().mean().item():.4f})")
    errs["transpose_conv"] = err

    # The integer core: bit-equal to the float64 convolution at every
    # distinct calibrated shape of one forward.
    shapes = {}
    for q, qk, stride, padding in record["int8_conv"]:
        shapes.setdefault((tuple(q.shape), tuple(qk.shape), tuple(stride), padding),
                          (q, qk, stride, padding))
    for key, (q, qk, stride, padding) in shapes.items():
        got = quantize_chain.conv2d_int8(q, qk, stride, padding)
        want = conv2d_int8_f64(q, qk, stride, padding)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"conv2d_int8 {key}: differs from float64")
    print(f"check conv2d_int8: im2col + torch._int_mm bit-equal to the float64 cuDNN "
          f"conv at all {len(shapes)} distinct calibrated shapes "
          f"({len(record['int8_conv'])} integer convs a forward)")

    err = 0.0
    for dtype in (torch.int8, torch.bfloat16):
        a, bb = int8_dot_probe.inputs(dtype, "cuda")
        got, want = int8_dot_probe.dot_probe_cuda(a, bb), int8_dot_probe.dot_probe(a, bb)
        torch.cuda.synchronize()
        require(torch.equal(got.to(torch.int64), want), f"int8_dot_probe {dtype}: not exact")
        err = max(err, (got.to(torch.int64) - want).abs().max().item())
        print(f"check int8_dot_probe {dtype} [{int8_dot_probe.M},{int8_dot_probe.K}]@"
              f"[{int8_dot_probe.K},{int8_dot_probe.N}] x{int8_dot_probe.REPS}: exact")
    errs["int8_dot_probe"] = err
    errs.update(check_op_probe())
    return errs, record, shapes


def check_chain_kernels(chains, cn_cfg, yl, yl_cfg, yl_scales, kp_net, kp_scales, errs):
    """Kernels A, B, C bf16 and E bf16 at the int8-chain paths' own calls,
    each against its plain version on the same inputs, and the integer
    core at the CenterNet chains' integer convs (heads of 1, 2 and 4
    channels among them).  Updates ``errs``; returns the CenterNet chain's
    {shape: (q, qk, stride, padding)} of its distinct integer convs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    frames = request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[0].cuda()
    img = preprocess(frames, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                     CHAIN_INT8.input_dtype)
    kp, _, _, kp_cfg, _ = kp_net
    kp_frames = request_frames(4, (KP_REQUESTS, KP_BATCH, FRAME_H, FRAME_W, 3))[0].cuda()
    kp_img = preprocess(kp_frames, (kp_cfg.in_h, kp_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                        KEYPOINTS.input_dtype)
    kp_forward = {impl: keypoint_chain_forward(kp, kp_scales, impl) for impl in ("kernel", "plain")}

    # Kernel A on the chains' own heatmaps: chain_int8's [8,4,90,160] at
    # K = 10, the keypoint chain's [16,1,90,160] K = 10 and [16,8,90,160]
    # K = 50.
    with torch.inference_mode():
        heads = chains["chain_int8"]["plain"][1](img)
        kp_heads = kp_forward["plain"](kp_img)
    cases = [("chain_int8_heatmap", heads.heatmap_nchw(), SERVING_DECODE.n_detections),
             ("keypoints_int8_heatmap", kp_heads.heatmap_nchw(), SERVING_DECODE.n_detections),
             ("keypoints_int8_keypoint_heatmap", kp_heads.keypoint_heatmap_nchw(),
              SERVING_DECODE.keypoint_n_detections)]
    for name, x, kk in cases:
        require(x.is_contiguous(), f"{name}: the chain's heatmap is not contiguous NCHW")
        got, want = peak_decode_cuda(x, kk), peak_decode(x, kk)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"peak_decode {name} K={kk}: index or label differs")
        e = (got[2] - want[2]).abs().max().item()
        require(e <= PEAK_ATOL, f"peak_decode {name} K={kk}: score err {e}")
        row = "peak_decode_k50" if kk == 50 else "peak_decode"
        errs[row] = max(errs[row], e)
        print(f"check peak_decode {name} {tuple(x.shape)} K={kk}: index/label exact, score "
              f"max_abs_err {e:.3g} (atol {PEAK_ATOL})")

    # Kernel B on the chain-int8 YOLACT's prototypes (the NHWC view).
    recipe = CHAIN_INT8.yolact
    yl_img = preprocess(frames, (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean, yl_cfg.img_stddev,
                        recipe.dtype)
    with torch.inference_mode():
        proto = yolact_chain_forward(ChainCtx(yl, yl_scales, dtype=recipe.dtype,
                                              join_dtype=recipe.join_dtype, impl="plain"))(
            yl_img).mask_prototype.permute(0, 3, 1, 2)
    kk = SERVING_DECODE.top_k
    coeff = torch.tanh(torch.randn((proto.shape[0], kk, proto.shape[1]), generator=gen,
                                   device="cuda"))
    box = torch.cat([torch.rand((proto.shape[0], kk, 2), generator=gen, device="cuda"),
                     torch.rand((proto.shape[0], kk, 2), generator=gen, device="cuda") * 0.6], -1)
    got, want = assemble_mask_cuda(proto, coeff, box), assemble_mask_batch(proto, coeff, box)
    torch.cuda.synchronize()
    e = (got - want).abs().max().item()
    require(e <= MASK_ATOL, f"mask_assembly chain_int8 prototypes: err {e}")
    errs["mask_assembly"] = max(errs["mask_assembly"], e)
    print(f"check mask_assembly chain_int8 proto {tuple(proto.shape)} strides {proto.stride()} "
          f"K={kk} crop: max_abs_err {e:.3g} (atol {MASK_ATOL})")

    # Kernel C in bf16 at the chains' 8 upsamples a forward: the f32
    # BatchNorm output cast to bf16, batch 8 (chain pairs) and 16 and 1
    # (keypoint chain); equal or one bf16 ulp apart.
    differ, total = 0, 0
    for tag, forward, x_in in (("chain_int8", chains["chain_int8"]["plain"][1], img),
                               ("dcn_chain_int8", chains["dcn_chain_int8"]["plain"][1], img),
                               (KP_INT8, kp_forward["plain"], kp_img),
                               (f"{KP_INT8}_b1", kp_forward["plain"], kp_img[:1])):
        with torch.inference_mode():
            calls = chain_upsample_calls(forward, x_in)
        require(len(calls) == 8 and all(x.dtype == torch.bfloat16 for x, _, _ in calls),
                f"{tag}: expected 8 bf16 upsamples, got {len(calls)}")
        for i, (x, w, f) in enumerate(calls):
            got, want = depthwise_upsample_cuda(x, w, f), depthwise_upsample(x, w, f)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            ulps = (diff / bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).max()
            require(got.dtype == want.dtype and ulps.item() <= 1.0,
                    f"depthwise_upsample bf16 {tag} call {i}: {ulps.item()} ulps")
            n = int((got != want).sum().item())
            differ, total = differ + n, total + got.numel()
            errs["depthwise_upsample_bf16"] = max(errs["depthwise_upsample_bf16"],
                                                  diff.max().item())
        print(f"check depthwise_upsample_bf16 {tag}: 8 calls {[tuple(c[0].shape) for c in calls]}"
              f", {differ} of {total} elements one ulp apart so far (tolerance one bf16 ulp)")

    # Kernel E in bf16 at the DCN chain's calls: its bf16 input, f32
    # offsets and bf16 masks, each distinct shape once.
    cn = chains["dcn_chain_int8"]["model"]
    calls = hooked_calls(chains["dcn_chain_int8"]["plain"][1], cn.deform_convs(), img,
                         lambda m, args: (*(a.clone() for a in args),
                                          m.weight.detach().to(args[0].dtype), m.bias.detach()))
    require(len(calls) == N_DCN, f"dcn_chain_int8: {len(calls)} DCN calls a forward")
    by_shape = dcn_shapes(calls)
    require(len(by_shape) == N_DCN_SHAPES, f"dcn_chain_int8: {len(by_shape)} DCN shapes")
    differ, total = 0, 0
    for (shape, o), ((x, offset, mask, w, bias), _) in by_shape.items():
        require(x.dtype == mask.dtype == torch.bfloat16 and offset.dtype == torch.float32
                and x.is_contiguous(), f"dcn_chain_int8 DCN inputs {x.dtype} {offset.dtype}")
        window = DCN_CHAIN_INT8.centernet.dcn_max_offset
        got = deform_conv2d_cuda(x, offset, mask, w, bias, max_offset=window)
        want = deform_conv2d(x, offset, mask, w, bias, max_offset=window)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        big = torch.maximum(got.float().abs(), want.float().abs())
        bar = bf16_ulp(big) + 9 * shape[1] * 2.0 ** -24 * want.float().abs().max()
        require(not (diff > bar).any().item(), f"deform_conv_bf16 dcn_chain_int8 {shape}: "
                                               f"err {diff.max().item()}")
        n = int((got != want).sum().item())
        differ, total = differ + n, total + got.numel()
        errs["deform_conv_bf16"] = max(errs["deform_conv_bf16"], diff.max().item())
        print(f"check deform_conv_bf16 dcn_chain_int8 {shape} -> O={o} window {window} (net "
              f"|offset| <= "
              f"{offset.abs().max().item():.2f}): max_abs_err {diff.max().item():.3g}, {n} of "
              f"{got.numel()} outputs differ (one bf16 ulp + 9 C 2^-24 max|plain|)")
    print(f"check deform_conv_bf16 dcn_chain_int8: {differ / total:.3g} of all outputs differ")

    # The integer core at the CenterNet chains' integer convs.
    shapes = {}
    for path in CHAIN_PAIRS:
        record = chain_calls(*chains[path]["plain"], img)
        for q, qk, stride, padding in record["int8_conv"]:
            shapes.setdefault((tuple(q.shape), tuple(qk.shape), tuple(stride), padding),
                              (q, qk, stride, padding))
    for key, (q, qk, stride, padding) in shapes.items():
        got = quantize_chain.conv2d_int8(q, qk, stride, padding)
        want = conv2d_int8_f64(q, qk, stride, padding)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"conv2d_int8 CenterNet chain {key}: differs from float64")
    narrow = sorted({k[1][3] for k in shapes if k[1][3] % 8})
    print(f"check conv2d_int8: the CenterNet chains' {len(shapes)} distinct integer convs "
          f"bit-equal to the float64 conv (output widths {narrow} padded to 8)")
    require(narrow == [2, 4], f"CenterNet chain narrow convs {narrow}")
    return shapes


def check_op_probe():
    """Probe P1's kernels against their plain versions at the JAX probe's
    shapes: the dots within P1_DOT_ATOL, the rest exact."""
    errs = dict.fromkeys(P1_ROWS, 0.0)
    for n_iter in P1_DOT_ITERS:
        for k, m, n in op_probe.DOT_SHAPES:
            w, x = op_probe.dot_inputs(m, k, n, "cuda")
            got, want = op_probe.dot_cuda(w, x, n_iter), op_probe.dot(w, x, n_iter)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            require(e <= P1_DOT_ATOL, f"op_probe dot [{m}x{k}xN{n}] x{n_iter}: err {e}")
            errs["op_probe/dot"] = max(errs["op_probe/dot"], e)
    for n_iter in P1_ITERS:
        xc, xd, xt = op_probe.copy_input("cuda"), op_probe.decimate_input("cuda"), \
            op_probe.transpose_input("cuda")
        cases = [("op_probe/slice_copy", op_probe.slice_copy_cuda(xc, n_iter),
                  op_probe.slice_copy(xc, n_iter)),
                 ("op_probe/lane_shift", op_probe.lane_shift_cuda(xc, n_iter),
                  op_probe.lane_shift(xc, n_iter)),
                 ("op_probe/transpose", op_probe.transpose_cuda(xt, n_iter),
                  op_probe.transpose(xt, n_iter))]
        cases += [("op_probe/decimate", op_probe.decimate_cuda(xd, n_iter, v),
                   op_probe.decimate(xd, n_iter, v)) for v in op_probe.DECIMATE_VARIANTS]
        torch.cuda.synchronize()
        for name, got, want in cases:
            require(got.dtype == want.dtype and torch.equal(got, want),
                    f"{name} x{n_iter}: differs from its plain version")
    print(f"check op_probe: {len(op_probe.DOT_SHAPES)} dots within {P1_DOT_ATOL} (max_abs_err "
          f"{errs['op_probe/dot']:.3g}), slice copy, lane shift, 3 decimations and the "
          f"transpose exact, at n_iter {P1_DOT_ITERS} and {P1_ITERS}")
    return errs


# ---- phase 4 ------------------------------------------------------------

def finite(*ts):
    return all(torch.isfinite(t.float()).all().item() for t in ts)


def pipelines(path, cn, cn_plain, cn_cfg, yl, yl_cfg, chains):
    """(the path's pair on the kernels, the same on the plain versions)."""
    device = torch.device("cuda")
    if path in CHAIN_RECIPES:
        yl_fwd, yl_plain = chains[path]["kernel"][1], chains[path]["plain"][1]
    else:
        yl_fwd = yl_plain = yl
    dtype = BF16_NETS[path][0].input_dtype if path in BF16_NETS else torch.float32
    return (make_combined_pipeline(cn, cn_cfg, yl_fwd, yl_cfg, device, dtype=dtype),
            make_combined_pipeline(cn_plain, cn_cfg, yl_plain, yl_cfg, device, impl="plain",
                                   dtype=dtype))


def expected_launches(path, cn):
    """Each kernel's launches in one request of ``path``."""
    recipe = CHAIN_RECIPES.get(path)
    return {"peak_decode": 1, "mask_assembly": 1,
            "depthwise_upsample": len(cn.depthwise_upsamples()),
            "deform_conv": len(cn.deform_convs()),
            "transpose_conv": 2 if recipe is not None and recipe.int8_transposes else 0,
            "int8_dot_probe": 0, "op_probe": 0}


def check_answers(path, answers, plain_answers, batch):
    """Hold a path's decoded requests on the kernels to the same requests
    on the plain versions; returns (CenterNet slots swapped at ties, worst
    CenterNet p95s, worst mask difference)."""
    b, k, kk = batch, SERVING_DECODE.n_detections, SERVING_DECODE.top_k
    bf16 = path in BF16_PATHS or path in BF16_RUNGS
    for cn_d, yl_d in answers:
        require(all(t.shape == (b, k) for t in
                    (cn_d.valid, cn_d.score, cn_d.label, cn_d.y, cn_d.x, cn_d.h, cn_d.w)),
                "CenterNet detection shapes")
        require(finite(cn_d.score, cn_d.y, cn_d.x, cn_d.h, cn_d.w), "CenterNet non-finite")
        require(bool(((cn_d.label >= 0) & (cn_d.label < 4)).all()), "CenterNet labels")
        require(yl_d.box.shape == (b, kk, 4) and yl_d.score.shape == (b, kk)
                and yl_d.mask.shape[:2] == (b, kk), "YOLACT shapes")
        require(finite(yl_d.score, yl_d.box, yl_d.mask), "YOLACT non-finite")
        require(bool(((yl_d.mask >= 0) & (yl_d.mask <= 1)).all()), "YOLACT mask range")

    mask_err, cn_p95, swaps = 0.0, {}, 0
    for (cn_d, yl_d), (cn_p, yl_p) in zip(answers, plain_answers):
        for name, got, ref in (("CenterNet", cn_d, cn_p), ("YOLACT", yl_d, yl_p)):
            stats = detection_deltas(ref, got, score_threshold=0.0)
            if bf16 and name == "CenterNet":
                swaps += check_bf16_centernet(path, stats, ref)
            else:
                require(stats["matched_fraction"] == 1.0,
                        f"{path}: {name} decode kernel vs plain: {stats}")
            if name == "CenterNet":
                for what in ("center", "score", "size"):
                    key = f"{what}_delta_p95"
                    cn_p95[key] = max(cn_p95.get(key, 0.0), stats[key])
        require(torch.equal(yl_d.valid, yl_p.valid), "YOLACT keep masks differ")
        mask_err = max(mask_err, (yl_d.mask - yl_p.mask).abs().max().item())
    require(mask_err <= MASK_ATOL, f"served masks differ by {mask_err}")
    return swaps, cn_p95, mask_err


def check_bf16_centernet(path, stats, ref) -> int:
    """Hold a bf16 CenterNet's decode on the kernels (``stats`` of
    ``detection_deltas`` against ``ref``, its plain decode); returns the
    top-K slots swapped.  A bf16 net may swap a slot where two logits tie
    within an ulp: counted, and held to 99% matched."""
    size_atol = NS_SIZE_ULPS * bf16_ulp(max(ref.h.abs().max().item(),
                                            ref.w.abs().max().item())).item()
    require(stats["matched_fraction"] >= 0.99
            and stats["center_delta_p95"] <= 1e-3
            and stats["score_delta_p95"] <= 1e-3
            and stats["size_delta_p95"] <= size_atol,
            f"{path}: CenterNet decode kernel vs plain: {stats} (size atol {size_atol})")
    return stats["total"] - round(stats["matched_fraction"] * stats["total"])


def serve_phase(path, cn, cn_plain, cn_cfg, yl, yl_cfg, chains, f32_cn):
    """Serve the path's 4 requests and check them; returns (launches by
    kernel, launches by entry point) of the served run.  ``f32_cn`` is the
    f32 CenterNet on the same weights, which the bf16 one is reported
    against."""
    device = torch.device("cuda")
    requests = [request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(N_REQUESTS)]
    bf16 = path in BF16_PATHS
    pipe, plain = pipelines(path, cn, cn_plain, cn_cfg, yl, yl_cfg, chains)
    n_up, n_dcn = len(cn.depthwise_upsamples()), len(cn.deform_convs())
    require(n_dcn == (N_DCN if path in DCN_PATHS else 0),
            f"{path}: {n_dcn} DeformConv2d modules")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [pipe(r) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    up_entry = "tauv_depthwise_upsample_" + ("bf16" if bf16 else "f32")
    dcn_entry = "tauv_deform_conv_" + ("bf16" if bf16 else "f32")
    print(f"serve {path}: {N_REQUESTS} requests x {CHECK_BATCH} frames, launches "
          f"{launches} (kernel C: {entries[up_entry]} by {up_entry}, kernel E: "
          f"{entries[dcn_entry]} by {dcn_entry}), {n_up} "
          f"DepthwiseUpsample and {n_dcn} DeformConv2d modules")
    per_request = expected_launches(path, cn)
    want = {name: N_REQUESTS * n for name, n in per_request.items()}
    require(launches == want, f"{path}: launch counts {launches}, expected {want}")
    require(entries[up_entry] == N_REQUESTS * n_up,
            f"{path}: kernel C launched {entries[up_entry]} times by {up_entry}")
    require(entries[dcn_entry] == N_REQUESTS * n_dcn,
            f"{path}: kernel E launched {entries[dcn_entry]} times by {dcn_entry}")
    mask_hw = (yl_cfg.in_h // 2, yl_cfg.in_w // 2)
    require(all(a[1].mask.shape[2:] == mask_hw for a in answers), "YOLACT mask size")

    head_err, head_max = 0.0, 0.0
    for r in requests:
        with torch.inference_mode():
            img = resize_frames(r.to(device), (cn_cfg.in_h, cn_cfg.in_w))
            cn_in = normalize_image(img, IMAGENET_MEAN, IMAGENET_STDDEV)
            got, ref = cn(cn_in), cn_plain(cn_in)
        for name in ("heatmap", "size", "offset"):
            head_err = max(head_err, (getattr(got, name) - getattr(ref, name)).abs().max().item())
            head_max = max(head_max, getattr(ref, name).abs().max().item())
    atol = NS_HEAD_ULPS * bf16_ulp(head_max).item() if bf16 else HEAD_ATOL[path]
    print(f"serve {path}: CenterNet raw heads kernel vs plain max_abs_err "
          f"{head_err:.3g} (atol {atol:.3g}, max |head| {head_max:.3g})")
    require(head_err <= atol, f"{path}: raw heads differ by {head_err}")

    if path == "int8_chain":
        with torch.inference_mode():
            yl_in = preprocess(requests[0].to(device), (yl_cfg.in_h, yl_cfg.in_w),
                               yl_cfg.img_mean, yl_cfg.img_stddev)
        maps = {impl: chain_calls(*chains[path][impl], yl_in)["maps"]
                for impl in ("kernel", "plain")}
        require(maps["kernel"].keys() == maps["plain"].keys(), "protonet layers differ")
        for layer, y in maps["kernel"].items():
            require(torch.equal(y, maps["plain"][layer]),
                    f"int8_chain: protonet {layer} differs between kernel D and plain D")
        layers = ", ".join(f"{name} {y.dtype}" for name, y in maps["kernel"].items())
        print(f"serve {path}: protonet maps bit-equal with kernel D and with its plain "
              f"version ({layers})")

    swaps, cn_p95, mask_err = check_answers(path, answers, [plain(r) for r in requests],
                                            CHECK_BATCH)
    matched = (f"CenterNet {swaps} top-K slots swapped at ties of "
               f"{N_REQUESTS * CHECK_BATCH * SERVING_DECODE.n_detections}, YOLACT 100%"
               if bf16 else "100%")
    print(f"serve {path}: decoded kernel vs plain {matched} matched (score threshold 0), "
          f"CenterNet p95 {cn_p95}, mask max_abs_err {mask_err:.3g}; "
          f"{sum(int(a[0].valid.sum()) for a in answers)} CenterNet and "
          f"{sum(int(a[1].valid.sum()) for a in answers)} YOLACT detections valid "
          f"at the served thresholds")

    if path in CHAIN_RECIPES:
        # One camera frame, the batch a vehicle's node serves: the int8
        # chain's last FPN levels then have 16 or fewer pixels, so its
        # integer convs pad their rows for torch._int_mm.
        frame = request_frames(3, (1, FRAME_H, FRAME_W, 3)).pin_memory()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        one = pipe(frame)
        torch.cuda.synchronize()
        require(kernels.LAUNCHES == per_request,
                f"{path} batch 1: launch counts {dict(kernels.LAUNCHES)}, expected {per_request}")
        swaps1, p95_1, mask_err1 = check_answers(path, [one], [plain(frame)], 1)
        print(f"serve {path} batch 1: launches {dict(kernels.LAUNCHES)}, decoded kernel vs "
              f"plain: YOLACT valid equal and 100% matched, CenterNet {swaps1} slots swapped "
              f"of {SERVING_DECODE.n_detections}, p95 {p95_1}, mask max_abs_err {mask_err1:.3g}")

    if bf16:
        f32 = make_centernet_pipeline(f32_cn, cn_cfg, device)
        stats = [detection_deltas(f32(r), a[0], score_threshold=0.0)
                 for r, a in zip(requests, answers)]
        total = sum(s["total"] for s in stats)
        worst = {key: max(s.get(key, 0.0) for s in stats)
                 for key in ("center_delta_p95", "score_delta_p95", "size_delta_p95")}
        print(f"report {path}: bf16 CenterNet decode against the f32 CenterNet on the same "
              f"weights and frames (random weights, not gated): "
              f"{sum(s['matched_fraction'] * s['total'] for s in stats) / max(total, 1):.4f} "
              f"of {total} matched at score threshold 0, worst request p95 {worst}")

    if path == "north_star":
        # The chain's own entry point, YOLACT alone, on its defaults (the
        # served recipe on the kernels): the same launches a request and
        # the same decode as the pair's YOLACT.
        alone = make_yolact_chain_pipeline(yl, chains[path]["kernel"][0].scales, device)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        alone_answers = [alone(r) for r in requests]
        torch.cuda.synchronize()
        alone_want = {**{name: 0 for name in KERNELS}, "mask_assembly": N_REQUESTS,
                      "transpose_conv": N_REQUESTS * per_request["transpose_conv"]}
        require(kernels.LAUNCHES == alone_want,
                f"make_yolact_chain_pipeline: launch counts {dict(kernels.LAUNCHES)}, "
                f"expected {alone_want}")
        for got, (_, yl_d) in zip(alone_answers, answers):
            stats = detection_deltas(yl_d, got, score_threshold=0.0)
            require(stats["matched_fraction"] == 1.0 and torch.equal(got.valid, yl_d.valid),
                    f"make_yolact_chain_pipeline against the pair's YOLACT: {stats}")
        print(f"serve {path}: make_yolact_chain_pipeline (YOLACT alone, served defaults) "
              f"launches {dict(kernels.LAUNCHES)}, decode 100% matched with the pair's YOLACT")

    if path in ("int8_chain", "north_star"):
        f32 = make_yolact_pipeline(yl, yl_cfg, device)
        stats = [detection_deltas(f32(r), a[1], score_threshold=0.0)
                 for r, a in zip(requests, answers)]
        total = sum(s["total"] for s in stats)
        matched = sum(s["matched_fraction"] * s["total"] for s in stats) / max(total, 1)
        worst = {key: max(s.get(key, 0.0) for s in stats)
                 for key in ("center_delta_p95", "score_delta_p95", "size_delta_p95")}
        print(f"report {path}: int8-chain YOLACT decode against the f32 YOLACT on the "
              f"same weights and frames (random weights, not gated): {matched:.4f} of "
              f"{total} matched at score threshold 0, worst request p95 {worst}")
    return launches, entries, variants


def chain_launches(cn):
    """Each kernel's launches in one chain pair request: kernel A in the
    CenterNet's decode, B in the YOLACT's, C at every upsample and E at
    every DCN block of the CenterNet chain (both bf16), nothing else."""
    return {**{name: 0 for name in KERNELS}, "peak_decode": 1, "mask_assembly": 1,
            "depthwise_upsample": len(cn.depthwise_upsamples()),
            "deform_conv": len(cn.deform_convs())}


def check_chain_launches(path, cn, n_requests, by_kernel, by_entry):
    want = {name: n_requests * n for name, n in chain_launches(cn).items()}
    require(by_kernel == want, f"{path}: launch counts {by_kernel}, expected {want}")
    for entry, n in (("tauv_depthwise_upsample_bf16", len(cn.depthwise_upsamples())),
                     ("tauv_deform_conv_bf16", len(cn.deform_convs()))):
        require(by_entry[entry] == n_requests * n,
                f"{path}: {entry} launched {by_entry[entry]} times, expected {n_requests * n}")


def serve_chain_pair(path, chains, nets, cn_cfg, yl, yl_cfg, yl_scales):
    """Serve a chain pair's 4 requests of 8 frames (its CenterNet chain and
    its YOLACT chain as two requests each) and one of 1 frame, and hold
    them to the plain versions: decodes matched (on ``chain_int8`` the
    CenterNet chain's int8 codes equal too); returns (launches by kernel,
    by entry point, by variant) of the served run."""
    device = torch.device("cuda")
    requests = [request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(N_REQUESTS)]
    pipes = chain_pair_pipelines(path, chains, cn_cfg, yl, yl_scales)
    (cn_pipe, yl_pipe), (cn_plain, yl_plain) = pipes["kernel"], pipes["plain"]
    cn = chains[path]["model"]
    deform = CHAIN_PAIRS[path][0].centernet.deform
    require(len(cn.depthwise_upsamples()) == 8 and len(cn.deform_convs()) == (N_DCN if deform
                                                                               else 0),
            f"{path}: {len(cn.deform_convs())} DCN blocks")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [(cn_pipe(r), yl_pipe(r)) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    print(f"serve {path}: {N_REQUESTS} requests x {CHECK_BATCH} frames, each the CenterNet "
          f"chain and the YOLACT chain, launches {launches} (kernel C: "
          f"{entries['tauv_depthwise_upsample_bf16']} bf16, kernel E: "
          f"{entries['tauv_deform_conv_bf16']} bf16)")
    check_chain_launches(path, cn, N_REQUESTS, launches, entries)

    with torch.inference_mode():
        img = preprocess(requests[0].to(device), (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN,
                         IMAGENET_STDDEV, CHAIN_PAIRS[path][0].input_dtype)
    codes = {impl: chain_codes(*chains[path][impl], img) for impl in ("kernel", "plain")}
    require(codes["kernel"].keys() == codes["plain"].keys(), f"{path}: int8 layers differ")
    differ, total, worst = 0, 0, 0
    for layer, q in codes["kernel"].items():
        diff = (q.int() - codes["plain"][layer].int()).abs()
        differ, total = differ + int((diff > 0).sum()), total + diff.numel()
        worst = max(worst, int(diff.max()))
    if deform:
        trunk = [layer for layer in codes["kernel"] if layer.startswith("model/base/")]
        require(all(torch.equal(codes["kernel"][t], codes["plain"][t]) for t in trunk),
                f"{path}: trunk codes differ between kernel and plain")
        print(f"serve {path}: CenterNet chain int8 codes kernel vs plain: the trunk's "
              f"{len(trunk)} maps equal; after the DCN blocks {differ} of {total} codes differ "
              f"(at most by {worst}); decoded detections compared below")
    else:
        require(differ == 0, f"{path}: {differ} of {total} int8 codes differ kernel vs plain")
        print(f"serve {path}: CenterNet chain int8 codes kernel vs plain: all {total} codes of "
              f"{len(codes['kernel'])} int8 maps equal")

    plain_answers = [(cn_plain(r), yl_plain(r)) for r in requests]
    _, cn_p95, mask_err = check_answers(path, answers, plain_answers, CHECK_BATCH)
    print(f"serve {path}: decoded kernel vs plain (score threshold 0): CenterNet and YOLACT "
          f"100% matched, CenterNet p95 {cn_p95} (bar {CHAIN_P95}), mask max_abs_err "
          f"{mask_err:.3g}; "
          f"{sum(int(a[0].valid.sum()) for a in answers)} CenterNet and "
          f"{sum(int(a[1].valid.sum()) for a in answers)} YOLACT detections valid at the "
          f"served thresholds")
    require(all(v <= CHAIN_P95 for v in cn_p95.values()),
            f"{path}: CenterNet decode kernel vs plain p95 {cn_p95} (bar {CHAIN_P95})")

    frame = request_frames(3, (1, FRAME_H, FRAME_W, 3)).pin_memory()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    one = (cn_pipe(frame), yl_pipe(frame))
    torch.cuda.synchronize()
    check_chain_launches(f"{path} batch 1", cn, 1, dict(kernels.LAUNCHES),
                         dict(kernels.ENTRY_LAUNCHES))
    _, p95_1, mask_err1 = check_answers(path, [one], [(cn_plain(frame), yl_plain(frame))],
                                             1)
    require(all(v <= CHAIN_P95 for v in p95_1.values()), f"{path} batch 1: p95 {p95_1}")
    print(f"serve {path} batch 1: launches {dict(kernels.LAUNCHES)}, decoded kernel vs plain: "
          f"CenterNet and YOLACT 100% matched, CenterNet p95 {p95_1}, mask max_abs_err "
          f"{mask_err1:.3g}")

    # The chains against the float nets on the same weights (random
    # weights: reported, not gated).
    f32_cn = nets[CHAIN_PAIRS[path][1]][0]
    f32 = make_centernet_pipeline(f32_cn, cn_cfg, device)
    f32_yl = make_yolact_pipeline(yl, yl_cfg, device)
    for name, ref, i in (("CenterNet", f32, 0), ("YOLACT", f32_yl, 1)):
        stats = [detection_deltas(ref(r), a[i], score_threshold=0.0)
                 for r, a in zip(requests, answers)]
        total = sum(st["total"] for st in stats)
        worst = {key: max(st.get(key, 0.0) for st in stats)
                 for key in ("center_delta_p95", "score_delta_p95", "size_delta_p95")}
        print(f"report {path}: int8-chain {name} decode against the f32 {name} on the same "
              f"weights and frames (random weights, not gated): "
              f"{sum(st['matched_fraction'] * st['total'] for st in stats) / max(total, 1):.4f}"
              f" of {total} matched at score threshold 0, worst request p95 {worst}")
    return launches, entries, variants


def report_flax_init(cn_cfg):
    """The ``report`` lines of ``dcn_north_star`` and ``dcn_chain_int8``
    (the bf16 and the int8-chain DCN CenterNets' decodes against the f32
    DCN CenterNet's on the same weights and frames, at score threshold 0,
    not gated) on weights drawn by the JAX package's initialisers
    (``init="flax"``: offset and mask convs zero), beside the served
    paths' LeCun-normal draw, whose offsets reach many cells."""
    device = torch.device("cuda")
    oc, _ = centernet_config()
    f32_cn = CenterpointDLA34(oc, generator=torch.Generator().manual_seed(2), device=device,
                              deform=True, init="flax").eval()
    bf16 = CenterpointDLA34(oc, device=device, **DCN_NORTH_STAR.centernet_kwargs()).eval()
    chain = CenterpointDLA34(oc, device=device, **DCN_CHAIN_INT8.centernet_kwargs()).eval()
    for net in (bf16, chain):
        net.load_state_dict(f32_cn.state_dict())
    cal = request_frames(0, (N_CALIBRATION, FRAME_H, FRAME_W, 3)).to(device)
    scales = calibrate(chain, [preprocess(cal, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN,
                                          IMAGENET_STDDEV, DCN_CHAIN_INT8.input_dtype)],
                       paths_of=centerpoint_calibration_paths)
    requests = [request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[i]
                for i in range(N_REQUESTS)]
    f32 = make_centernet_pipeline(f32_cn, cn_cfg, device)
    for path, pipe in (
            ("dcn_north_star", make_centernet_pipeline(bf16, cn_cfg, device,
                                                       dtype=DCN_NORTH_STAR.input_dtype)),
            ("dcn_chain_int8", make_centernet_chain_pipeline(chain, cn_cfg, scales, device,
                                                             dtype=DCN_CHAIN_INT8.input_dtype))):
        stats = [detection_deltas(f32(r), pipe(r), score_threshold=0.0) for r in requests]
        total = sum(st["total"] for st in stats)
        worst = {key: max(st.get(key, 0.0) for st in stats)
                 for key in ("center_delta_p95", "score_delta_p95", "size_delta_p95")}
        print(f"report {path}, init=\"flax\": its CenterNet decode against the f32 CenterNet "
              f"on the same weights and frames (random weights, offset and mask convs zero, "
              f"not gated): "
              f"{sum(st['matched_fraction'] * st['total'] for st in stats) / max(total, 1):.4f}"
              f" of {total} matched at score threshold 0, worst request p95 {worst}")
    del f32_cn, bf16, chain
    torch.cuda.empty_cache()


def serve_keypoints_int8(kp_net, kp_scales):
    """Serve the keypoint chain's 2 requests of 16 frames and one of 1 frame,
    and hold them to the plain versions: int8 codes equal, detections 100%
    matched, the same keypoints claimed and poses valid; returns the served
    run's launches (by kernel, by entry point, by variant)."""
    device = torch.device("cuda")
    kp, _, oc, cfg, _ = kp_net
    n_slots = max(len(c.keypoints) for c in oc.configs)
    requests = [request_frames(4, (KP_REQUESTS, KP_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(KP_REQUESTS)]
    pipe, _ = keypoint_chain_pipelines(kp_net, kp_scales)
    per_request = keypoint_launches(kp)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [pipe(r) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    print(f"serve {KP_INT8}: {KP_REQUESTS} requests x {KP_BATCH} frames, launches {launches} "
          f"(kernel A by K: {variants}, kernel C: {entries['tauv_depthwise_upsample_bf16']} bf16)")
    require(launches == {name: KP_REQUESTS * n for name, n in per_request.items()},
            f"{KP_INT8}: launch counts {launches}")
    require(entries["tauv_depthwise_upsample_bf16"] == KP_REQUESTS * 8,
            f"{KP_INT8}: kernel C's bf16 launches")
    require(variants == {("peak_decode", "K=10"): KP_REQUESTS,
                         ("peak_decode", "K=50"): KP_REQUESTS}, f"{KP_INT8}: kernel A by K")
    for out in answers:
        check_keypoint_outputs(out, KP_BATCH, n_slots)

    with torch.inference_mode():
        img = preprocess(requests[0].to(device), (cfg.in_h, cfg.in_w), IMAGENET_MEAN,
                         IMAGENET_STDDEV, KEYPOINTS.input_dtype)
    codes = {impl: chain_codes(*keypoint_chain_forward(kp, kp_scales, impl, with_ctx=True), img)
             for impl in ("kernel", "plain")}
    require(codes["kernel"].keys() == codes["plain"].keys() and all(
        torch.equal(q, codes["plain"][layer]) for layer, q in codes["kernel"].items()),
        f"{KP_INT8}: int8 codes differ kernel vs plain")

    pipe0, plain0 = keypoint_chain_pipelines(kp_net, kp_scales, ALL_SLOTS)
    claimed, posed = [0, 0], [0, 0]
    for r in requests + [request_frames(5, (1, FRAME_H, FRAME_W, 3)).pin_memory()]:
        got, ref = pipe0(r), plain0(r)
        stats = detection_deltas(ref.detections, got.detections, score_threshold=0.0)
        require(stats["matched_fraction"] == 1.0, f"{KP_INT8}: decode kernel vs plain {stats}")
        for name in ("keypoint_valid", "pose_valid"):
            require(torch.equal(getattr(got, name), getattr(ref, name)),
                    f"{KP_INT8}: {name} differs kernel vs plain")
        for i, out in enumerate((got, ref)):
            claimed[i] += int(out.keypoint_valid.sum())
            posed[i] += int(out.pose_valid.sum())
    print(f"serve {KP_INT8}: int8 codes kernel vs plain equal ({len(codes['kernel'])} maps); "
          f"decoded at threshold 0 over {KP_REQUESTS} x {KP_BATCH} + 1 frames 100% matched, "
          f"keypoints claimed {claimed[0]} (plain {claimed[1]}), PnP solves valid {posed[0]} "
          f"(plain {posed[1]})")

    frame = request_frames(5, (1, FRAME_H, FRAME_W, 3)).pin_memory()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    one = pipe(frame)
    torch.cuda.synchronize()
    require(dict(kernels.LAUNCHES) == per_request and kernels.VARIANT_LAUNCHES == {
        ("peak_decode", "K=10"): 1, ("peak_decode", "K=50"): 1},
        f"{KP_INT8} batch 1: launch counts {dict(kernels.LAUNCHES)}")
    check_keypoint_outputs(one, 1, n_slots)
    print(f"serve {KP_INT8} batch 1: launches {dict(kernels.LAUNCHES)}")
    return launches, entries, variants


def keypoint_launches(kp):
    """Each kernel's launches in one ``keypoints`` request: kernel A on both
    heatmaps, kernel C at every upsample, nothing else."""
    return {**{name: 0 for name in KERNELS}, "peak_decode": 2,
            "depthwise_upsample": len(kp.depthwise_upsamples())}


def check_keypoint_outputs(out, batch, n_slots):
    d = out.detections
    k = SERVING_DECODE.n_detections
    require(all(t.shape == (batch, k) for t in
                (d.valid, d.score, d.label, d.y, d.x, d.h, d.w, d.depth, out.pose_valid,
                 out.pose_error)), "keypoints: detection shapes")
    require(out.keypoint_valid.shape == out.keypoint_score.shape == (batch, k, n_slots)
            and out.keypoint_affinity.shape == (batch, k, n_slots, 2)
            and out.pose_rotation.shape == (batch, k, 3, 3)
            and out.pose_translation.shape == (batch, k, 3), "keypoints: keypoint shapes")
    require(finite(d.score, d.y, d.x, d.h, d.w, d.depth, out.keypoint_y, out.keypoint_x,
                   out.keypoint_score, out.keypoint_affinity), "keypoints: non-finite")
    require(bool((d.label == 0).all()) and bool((d.depth >= 0).all()),
            "keypoints: labels or depths")
    valid = out.pose_valid
    require(finite(out.pose_rotation[valid], out.pose_translation[valid]),
            "keypoints: a valid pose is not finite")


def keypoint_pipelines(kp_net, device, knobs):
    """(the keypoint pipeline on the kernels, on the plain versions)."""
    kp, kp_plain, oc, cfg, projection = kp_net
    return tuple(make_centernet_keypoint_pipeline(net, cfg, oc, projection, device, knobs=knobs,
                                                  impl=impl, dtype=KEYPOINTS.input_dtype)
                 for net, impl in ((kp, "kernel"), (kp_plain, "plain")))


def serve_keypoints(kp_net):
    """Serve the ``keypoints`` path's requests and check them; returns the
    served run's launches (by kernel, by entry point, by variant)."""
    device = torch.device("cuda")
    kp, kp_plain, oc, cfg, projection = kp_net
    n_slots = max(len(c.keypoints) for c in oc.configs)
    requests = [request_frames(4, (KP_REQUESTS, KP_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(KP_REQUESTS)]
    pipe, _ = keypoint_pipelines(kp_net, device, SERVING_DECODE)
    n_up = len(kp.depthwise_upsamples())
    require(n_up == 8 and not kp.deform_convs(), f"keypoints: {n_up} upsamples")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [pipe(r) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    per_request = keypoint_launches(kp)
    want = {name: KP_REQUESTS * n for name, n in per_request.items()}
    print(f"serve keypoints: {KP_REQUESTS} requests x {KP_BATCH} frames, launches {launches} "
          f"(kernel A by K: {variants}, kernel C: {entries['tauv_depthwise_upsample_bf16']} "
          f"by tauv_depthwise_upsample_bf16)")
    require(launches == want, f"keypoints: launch counts {launches}, expected {want}")
    require(entries["tauv_depthwise_upsample_bf16"] == KP_REQUESTS * n_up,
            "keypoints: kernel C's bf16 launches")
    require(variants == {("peak_decode", "K=10"): KP_REQUESTS,
                         ("peak_decode", "K=50"): KP_REQUESTS},
            f"keypoints: kernel A by K {variants}")
    for out in answers:
        check_keypoint_outputs(out, KP_BATCH, n_slots)
    print(f"serve keypoints: at the served thresholds "
          f"{sum(int(a.detections.valid.sum()) for a in answers)} detections valid, "
          f"{sum(int(a.keypoint_valid.sum()) for a in answers)} keypoints claimed, "
          f"{sum(int(a.pose_valid.sum()) for a in answers)} poses valid (random weights)")

    # The whole request on the kernels and on the plain versions, every
    # slot decoded.
    pipe0, plain0 = keypoint_pipelines(kp_net, device, ALL_SLOTS)
    swaps, claimed, posed = 0, [0, 0], [0, 0]
    for r in requests:
        got, ref = pipe0(r), plain0(r)
        check_keypoint_outputs(got, KP_BATCH, n_slots)
        swaps += check_bf16_centernet("keypoints", detection_deltas(
            ref.detections, got.detections, score_threshold=0.0), ref.detections)
        for i, out in enumerate((got, ref)):
            claimed[i] += int(out.keypoint_valid.sum())
            posed[i] += int(out.pose_valid.sum())
    print(f"serve keypoints: decoded kernel vs plain at threshold 0: CenterNet {swaps} top-K "
          f"slots swapped of {KP_REQUESTS * KP_BATCH * SERVING_DECODE.n_detections}; "
          f"keypoints claimed {claimed[0]} (plain {claimed[1]}), PnP solves valid {posed[0]} "
          f"(plain {posed[1]})")

    # decode_keypoints on one forward's heads, kernel A against the plain
    # peak decode.
    with torch.inference_mode():
        img = preprocess(requests[0].to(device), (cfg.in_h, cfg.in_w), IMAGENET_MEAN,
                         IMAGENET_STDDEV, KEYPOINTS.input_dtype)
        pred = kp(img)
        proj = torch.tensor(projection, dtype=torch.float32, device=device)
        args = (pred, cfg, oc, proj, ALL_SLOTS.n_detections, ALL_SLOTS.keypoint_n_detections,
                0.0, 0.0)
        dk, dp = decode_keypoints(*args, impl="kernel"), decode_keypoints(*args, impl="plain")
    torch.cuda.synchronize()
    for name in ("valid", "label", "y", "x", "h", "w", "depth"):
        require(torch.equal(getattr(dk.detections, name), getattr(dp.detections, name)),
                f"keypoints same heads: detections.{name} differs")
    for name in ("keypoint_valid", "keypoint_y", "keypoint_x", "keypoint_affinity", "pose_valid"):
        require(torch.equal(getattr(dk, name), getattr(dp, name)),
                f"keypoints same heads: {name} differs")
    score_err = max((dk.detections.score - dp.detections.score).abs().max().item(),
                    (dk.keypoint_score - dp.keypoint_score).abs().max().item())
    require(score_err <= PEAK_ATOL, f"keypoints same heads: score err {score_err}")
    # Every slot's pose, valid or not: PnP ran on the same claimed points.
    pose_err = max((getattr(dk, n) - getattr(dp, n)).abs().max().item()
                   for n in ("pose_rotation", "pose_translation"))
    require(pose_err <= POSE_ATOL, f"keypoints same heads: pose err {pose_err}")
    n_claimed = dk.keypoint_valid.sum(-1)
    print(f"serve keypoints: decode_keypoints on the same heads, kernel A vs plain: indices, "
          f"labels, keypoint_valid and slots exact, scores max_abs_err {score_err:.3g} (atol "
          f"{PEAK_ATOL}), {int(dk.keypoint_valid.sum())} of {dk.keypoint_valid.numel()} "
          f"keypoint slots claimed (a detection claims {torch.bincount(n_claimed.flatten(), minlength=9).tolist()} "
          f"times 0..8), {int(dk.pose_valid.sum())} of {dk.pose_valid.numel()} PnP solves "
          f"valid, every slot's pose max_abs_err {pose_err:.3g} (atol {POSE_ATOL})")
    check_pnp_on_card(proj)

    # One camera frame, the batch a vehicle's node serves.
    frame = request_frames(5, (1, FRAME_H, FRAME_W, 3)).pin_memory()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    one = pipe(frame)
    torch.cuda.synchronize()
    one_launches = dict(kernels.LAUNCHES)
    require(one_launches == per_request and kernels.VARIANT_LAUNCHES == {
        ("peak_decode", "K=10"): 1, ("peak_decode", "K=50"): 1},
        f"keypoints batch 1: launch counts {one_launches}")
    check_keypoint_outputs(one, 1, n_slots)
    got, ref = pipe0(frame), plain0(frame)
    swaps1 = check_bf16_centernet("keypoints batch 1", detection_deltas(
        ref.detections, got.detections, score_threshold=0.0), ref.detections)
    print(f"serve keypoints batch 1: launches {one_launches}, decoded kernel vs plain "
          f"at threshold 0: {swaps1} slots swapped of {SERVING_DECODE.n_detections}, "
          f"{int(got.keypoint_valid.sum())} keypoints claimed, {int(got.pose_valid.sum())} "
          f"poses valid")
    return launches, entries, variants


def check_pnp_on_card(camera):
    """``solve_pnp_batch`` on the card on as many problems as a batch-16
    request solves, each 8 exact correspondences of a known pose (the
    cases of ``tests/test_se3_pnp.py``, at the keypoint projection), a
    sixth of them with only 5 points: random weights validate no pose, so
    this is where a valid one is held to the truth, within the JAX
    tests' 1e-2."""
    n = KP_BATCH * SERVING_DECODE.n_detections
    rng = np.random.default_rng(8)
    obj = rng.uniform(-0.2, 0.2, (n, 8, 3)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32) * 0.4)
    t = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(1.0, 3.0, n)], -1).astype(np.float32)
    with torch.inference_mode():
        r = so3_exp(w).numpy()
        cam = camera.double().cpu().numpy()
        pts = np.einsum("nij,npj->npi", r, obj) + t[:, None]
        uv = np.stack([cam[0, 0] * pts[..., 0] / pts[..., 2] + cam[0, 2],
                       cam[1, 1] * pts[..., 1] / pts[..., 2] + cam[1, 2]], -1).astype(np.float32)
        mask = np.ones((n, 8), bool)
        mask[::6, 5:] = False
        got = solve_pnp_batch(*(torch.from_numpy(a).cuda() for a in (obj, uv)), camera,
                              torch.from_numpy(mask).cuda())
    want_valid = mask.sum(-1) >= 6
    valid = got.valid.cpu().numpy()
    require(np.array_equal(valid, want_valid), f"PnP on the card: valid {valid.sum()} of {n}, "
                                               f"expected {want_valid.sum()}")
    t_err = np.abs(got.translation.cpu().numpy() - t)[valid].max()
    r_err = np.abs(got.rotation.cpu().numpy() - r)[valid].max()
    require(t_err <= 1e-2 and r_err <= 1e-2, f"PnP on the card: err t {t_err} r {r_err}")
    print(f"check PnP on the card: {n} problems, {int(valid.sum())} valid as expected, "
          f"translation max_abs_err {t_err:.3g}, rotation {r_err:.3g} against the truth (atol "
          f"1e-2), largest mean squared reprojection error "
          f"{got.error.cpu().numpy()[valid].max():.3g} px^2")


def window_has_depth(depth, cy, cx, window=5):
    """Whether the clipped window around (cy, cx) holds a valid depth, as
    ``depth_window_z`` reads it."""
    h, w = depth.shape
    half = window // 2
    ys = np.clip(np.arange(cy - half, cy + half + 1), 0, h - 1)
    xs = np.clip(np.arange(cx - half, cx + half + 1), 0, w - 1)
    vals = depth[np.ix_(ys, xs)]
    return bool((np.isfinite(vals) & (vals > 0)).any())


def node_phase(kp_net, yl, yl_cfg):
    """Both node servers on the card, one 640x480 colour frame and a depth
    image each: a plane at DEPTH_M with 1% of cells 0 and a NaN square over
    one detection, an identity pose.  Every published position must be
    finite and the count must be the one the drop rule implies.  Returns
    kernel B's error against its plain version at the YOLACT server's call."""
    device = torch.device("cuda")
    kp, _, oc, cfg, projection = kp_net
    frame = request_frames(6, (1, FRAME_H, FRAME_W, 3)).numpy()
    rng = np.random.default_rng(0)

    def plane():
        depth = np.full((1, FRAME_H, FRAME_W), DEPTH_M, np.float32)
        depth[rng.random(depth.shape) < 0.01] = 0.0
        return depth

    server = CenternetServer(kp, cfg, oc, projection, score_threshold=0.0,
                             keypoint_score_threshold=0.0, device=device)
    out = server.pipeline(frame)
    valid = out.detections.valid[0].cpu().numpy()
    pose_valid = out.pose_valid[0].cpu().numpy()
    cy = np.clip(out.detections.y[0].cpu().numpy() * FRAME_H, 0, FRAME_H - 1).astype(np.int32)
    cx = np.clip(out.detections.x[0].cpu().numpy() * FRAME_W, 0, FRAME_W - 1).astype(np.int32)
    depth = plane()
    unposed = np.flatnonzero(valid & ~pose_valid)
    if len(unposed):   # its window loses all depth: dropped
        i = unposed[0]
        depth[0, max(cy[i] - 8, 0): cy[i] + 9, max(cx[i] - 8, 0): cx[i] + 9] = np.nan
    placed = [valid[i] and (pose_valid[i] or window_has_depth(depth[0], cy[i], cx[i]))
              for i in range(len(valid))]
    published = []
    kernels.reset_launch_counts()
    results = server.process(frame, depth, pose_lookup=lambda: np.eye(4),
                             publish=published.append)
    torch.cuda.synchronize()
    node_launches = dict(kernels.LAUNCHES)
    require(len(published) == 1 and len(results[0]) == sum(placed),
            f"CenternetServer published {[len(r) for r in results]}, expected {sum(placed)}")
    require(all(np.isfinite(d.position).all() and d.tag == "torpedo_24" for d in results[0]),
            "CenternetServer: a published position is not finite")
    n_pose = sum(d.orientation is not None for d in results[0])
    require(n_pose == int((valid & pose_valid).sum()), "CenternetServer: PnP poses published")
    require(not len(unposed) or sum(placed) < int(valid.sum()),
            "CenternetServer: the detection without depth or pose was not dropped")
    require(node_launches == keypoint_launches(kp),
            f"CenternetServer.process launches {node_launches}")
    print(f"node CenternetServer.process: {int(valid.sum())} detections valid (threshold 0), "
          f"{len(results[0])} published ({n_pose} placed by PnP, the rest at the depth "
          f"window's z), {int(valid.sum()) - len(results[0])} dropped (no depth, no pose), "
          f"launches {node_launches}")

    classes = ClassConfigSet(tuple(ClassConfig("background" if i == 0 else f"class_{i}", i)
                                   for i in range(yl_cfg.n_classes + 1)))
    yserver = YolactServer(yl, yl_cfg, classes, FRAME_INTRINSICS, confidence_threshold=0.0,
                           device=device)
    # Kernel B at the node's own call: one frame's NCHW prototypes from the
    # f32 YOLACT, decoded through the kernel and through the plain version
    # on the same heads (the same Fast-NMS picks, so the masks compare slot
    # for slot).
    with torch.inference_mode():
        pred = yl(preprocess(torch.from_numpy(frame).to(device), (yl_cfg.in_h, yl_cfg.in_w),
                             yl_cfg.img_mean, yl_cfg.img_stddev, YOLACT_INPUT_DTYPE))
        proto = pred.mask_prototype.permute(0, 3, 1, 2)
        args = (pred, yl_cfg, SERVING_DECODE.top_k, SERVING_DECODE.iou_threshold, 0.0)
        dk, dp = decode_yolact(*args, impl="kernel"), decode_yolact(*args, impl="plain")
    torch.cuda.synchronize()
    require(proto.shape[0] == 1 and proto.is_contiguous(),
            f"YolactServer prototypes {tuple(proto.shape)} strides {proto.stride()}")
    require(torch.equal(dk.valid, dp.valid) and torch.equal(dk.box, dp.box),
            "YolactServer decode: kernel and plain picks differ")
    mask_err = (dk.mask - dp.mask).abs().max().item()
    require(mask_err <= MASK_ATOL, f"mask_assembly on YolactServer's call: err {mask_err}")
    print(f"check mask_assembly node_yolact_b1 proto {tuple(proto.shape)} strides "
          f"{proto.stride()} K={dk.mask.shape[1]} ({int(dk.valid.sum())} slots valid): "
          f"max_abs_err {mask_err:.3g} (atol {MASK_ATOL})")
    out = yserver.pipeline(frame)
    valid = out.valid[0].cpu().numpy()
    box = out.box[0].cpu().numpy()
    masks = out.mask[0].cpu().numpy()
    depth = plane()
    first = np.flatnonzero(valid)
    if len(first):     # NaN over the first detection's box (and a margin): dropped
        y, x, h, w = box[first[0]] * (FRAME_H, FRAME_W, FRAME_H, FRAME_W)
        depth[0, max(int(y - h / 2) - 8, 0): int(y + h / 2) + 9,
              max(int(x - w / 2) - 8, 0): int(x + w / 2) + 9] = np.nan
    mh, mw = masks.shape[1:]
    ys = (np.arange(mh) * (FRAME_H / mh)).astype(np.int32)
    xs = (np.arange(mw) * (FRAME_W / mw)).astype(np.int32)
    small = depth[0][np.ix_(ys, xs)]
    has = ((masks > 0.5) & np.isfinite(small) & (small > 0)).any(axis=(1, 2))
    want = int((valid & has).sum())
    kernels.reset_launch_counts()
    results = yserver.process(frame, depth, pose_lookup=lambda: np.eye(4))
    torch.cuda.synchronize()
    node_launches = dict(kernels.LAUNCHES)
    require(len(results[0]) == want,
            f"YolactServer published {len(results[0])}, expected {want}")
    require(all(np.isfinite(d.position).all() and d.tag.startswith("class_")
                for d in results[0]), "YolactServer: a published position is not finite")
    require(not len(first) or want < int(valid.sum()),
            "YolactServer: the detection without depth was not dropped")
    require(node_launches["mask_assembly"] == 1, f"YolactServer.process launches {node_launches}")
    print(f"node YolactServer.process: {int(valid.sum())} detections valid (confidence 0), "
          f"{len(results[0])} published, {int(valid.sum()) - len(results[0])} dropped (no "
          f"depth inside the mask), latency {yserver.last_latency * 1e3:.1f} ms, launches "
          f"{node_launches}")
    return mask_err


# ---- phase 5 ------------------------------------------------------------

def abba(kernel_fn, plain_fn, iters: int, warmup: int = 3, timer=time_ms):
    """Mean ms per call of (kernel, plain), timed kernel, plain, plain,
    kernel, each by ``timer`` (back to back by default)."""
    for _ in range(warmup):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    k1 = timer(kernel_fn, iters)
    p1 = timer(plain_fn, iters)
    p2 = timer(plain_fn, iters)
    k2 = timer(kernel_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_phase(nets, cn_cfg, yl, yl_cfg, chains, record, int8_shapes, card, profile_dir,
               kp_net, kp_maps):
    t_start = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b = CHECK_BATCH
    times, bounds, device = {}, {}, {}

    def timed(name, kernel_fn, plain_fn, iters):
        times[name] = abba(kernel_fn, plain_fn, iters)
        device[name] = queued_ms(kernel_fn, iters)

    logits = torch.randn((b, 4, cn_cfg.out_h, cn_cfg.out_w), generator=gen, device="cuda") * 3
    k = SERVING_DECODE.n_detections
    timed("peak_decode", lambda: peak_decode_cuda(logits, k),
          lambda: peak_decode(logits, k), 50)
    # sigmoid (4 flops), 3x3 max (8 compares) and the peak test (1) an
    # element; out: index (8 bytes), label and score (4 each) a slot
    bounds["peak_decode"] = bound(nbytes(logits) + b * k * 16, 13 * logits.numel(), PEAK["f32"])
    # The keypoints path's keypoint-heatmap call, on the net's own map.
    kp_logits, kk50 = kp_maps[1], SERVING_DECODE.keypoint_n_detections
    timed("peak_decode_k50", lambda: peak_decode_cuda(kp_logits, kk50),
          lambda: peak_decode(kp_logits, kk50), 50)
    bounds["peak_decode_k50"] = bound(nbytes(kp_logits) + kp_logits.shape[0] * kk50 * 16,
                                      13 * kp_logits.numel(), PEAK["f32"])
    # Kernel B on the prototypes as the int8 chain (north_star) makes them:
    # the NHWC view, read in place.
    p, kk = yl_cfg.n_prototype_masks, SERVING_DECODE.top_k
    proto = torch.randn((b, yl_cfg.in_h // 2, yl_cfg.in_w // 2, p), generator=gen,
                        device="cuda").permute(0, 3, 1, 2)
    coeff = torch.tanh(torch.randn((b, kk, p), generator=gen, device="cuda"))
    box = torch.cat([torch.rand((b, kk, 2), generator=gen, device="cuda"),
                     torch.rand((b, kk, 2), generator=gen, device="cuda") * 0.6], -1)
    timed("mask_assembly", lambda: assemble_mask_cuda(proto, coeff, box),
          lambda: assemble_mask_batch(proto, coeff, box), 50)
    n_out = b * kk * proto.shape[2] * proto.shape[3]
    # the P-term dot, the sigmoid (4) and the crop's multiply an output
    bounds["mask_assembly"] = bound(nbytes(proto, coeff, box) + 4 * n_out,
                                    (2 * p + 5) * n_out, PEAK["f32"])
    img = torch.randn((b, 3, cn_cfg.in_h, cn_cfg.in_w), generator=gen, device="cuda")
    calls = upsample_calls(nets["plain_ida"][1], img)
    calls16 = upsample_calls(nets["north_star"][1], img)
    # scripts/kernel_times.py times C and D at these calls' shapes.
    for cs in (calls, calls16):
        require([(tuple(x.shape), f) for x, _, f in cs] == kernel_times.C_CALLS,
                "kernel C's calls are not kernel_times.C_CALLS")
    require([(*c[0].shape, c[1].shape[-1]) for c in record["transpose"]] == kernel_times.D_CALLS,
            "kernel D's calls are not kernel_times.D_CALLS")
    timed("depthwise_upsample",
          lambda: [depthwise_upsample_cuda(x, w, f) for x, w, f in calls],
          lambda: [depthwise_upsample(x, w, f) for x, w, f in calls], 50)
    outs = [depthwise_upsample(x, w, f) for x, w, f in calls]
    bounds["depthwise_upsample"] = bound(
        sum(nbytes(x, w) for x, w, _ in calls) + nbytes(*outs),
        sum(8 * o.numel() for o in outs), PEAK["f32"])
    library = {"depthwise_upsample": time_ms(lambda: [F.conv_transpose2d(
        x, w, stride=f, padding=f // 2, groups=x.shape[1]) for x, w, f in calls], 50)}
    # Kernel C in bf16: the 8 upsamples of a north_star forward; its 4
    # taps are f32 multiply-adds off the tensor cores.
    timed("depthwise_upsample_bf16",
          lambda: [depthwise_upsample_cuda(x, w, f) for x, w, f in calls16],
          lambda: [depthwise_upsample(x, w, f) for x, w, f in calls16], 50)
    outs16 = [depthwise_upsample(x, w, f) for x, w, f in calls16]
    bounds["depthwise_upsample_bf16"] = bound(
        sum(nbytes(x, w) for x, w, _ in calls16) + nbytes(*outs16),
        sum(8 * o.numel() for o in outs16), PEAK["f32"])
    library["depthwise_upsample_bf16"] = time_ms(lambda: [F.conv_transpose2d(
        x, w, stride=f, padding=f // 2, groups=x.shape[1]) for x, w, f in calls16], 50)
    # Kernel E: f32 at dcn_ida's 16 calls, bf16 at dcn_north_star's, at
    # the path's window (none; 3 cells), the weights laid out once as
    # DeformConv2d keeps them; the NCHW input's NHWC copy is in the time.
    # The same calls at the other window are timed beside them (the
    # bound is the same: the products do not change).
    dcn_rows = {}
    for row, path in (("deform_conv", "dcn_ida"), ("deform_conv_bf16", "dcn_north_star")):
        dcns = dcn_calls(nets[path][1], img)
        require([(tuple(x.shape), o, n) for (x_shape, o), ((x, *_), n)
                 in dcn_shapes(dcns).items()] == kernel_times.E_CALLS,
                f"{path}: kernel E's calls are not kernel_times.E_CALLS")
        taps = [deform_conv.kernel_weights(c[3]) for c in dcns]
        window = nets[path][1].deform_convs()[0].max_offset
        timed(row, lambda: [deform_conv2d_cuda(*c, taps=t, max_offset=window)
                            for c, t in zip(dcns, taps)],
              lambda: [deform_conv2d(*c, max_offset=window) for c in dcns], DCN_ITERS)
        bounds[row] = dcn_bound(dcns)
        dcn_rows[row] = (dcns, taps, window)
        other = None if window is not None else DCN_WINDOW
        o_ms, o_plain = abba(lambda: [deform_conv2d_cuda(*c, taps=t, max_offset=other)
                                      for c, t in zip(dcns, taps)],
                             lambda: [deform_conv2d(*c, max_offset=other) for c in dcns],
                             DCN_OTHER_ITERS)
        o_dev = queued_ms(lambda: [deform_conv2d_cuda(*c, taps=t, max_offset=other)
                                   for c, t in zip(dcns, taps)], DCN_OTHER_ITERS)
        print(f"time {row} at window {other} (the row's own: {window}), all {N_DCN} calls of "
              f"one batch-{b} {path} forward: kernel {o_ms:.4f} ms ({o_dev:.4f} ms on the "
              f"device), plain {o_plain:.4f} ms, bound {bounds[row][0]:.4f} ms "
              f"({bounds[row][1]}) ({card})")
    d_calls = record["transpose"]
    timed("transpose_conv",
          lambda: [transpose_conv2x_int8_cuda(*c[:5], act=c[5], out_dtype=c[6], taps=c[7])
                   for c in d_calls],
          lambda: [transpose_conv2x_int8(*c[:5], act=c[5], out_dtype=c[6]) for c in d_calls], 10)
    d_ops = sum(2 * 9 * c[0].numel() * c[1].shape[-1] for c in d_calls)
    bounds["transpose_conv"] = bound(
        sum(nbytes(c[0], c[1]) + 12 * c[1].shape[-1] + 4 * c[0].numel() // c[0].shape[-1]
            * c[1].shape[-1] for c in d_calls), d_ops, PEAK["int8"])
    probe = int8_dot_probe.measure()
    row = probe["rows"]["int8->int32"]
    times["int8_dot_probe"] = (row["ms"], row["plain_ms"])
    m, kd, n = probe["m"], probe["k"], probe["n"]
    bounds["int8_dot_probe"] = bound(m * kd + kd * n + 4 * m * n, probe["ops"], PEAK["int8"])
    p1 = op_probe.measure()
    p1_rows = {r["op"]: r for r in p1["rows"]}
    for name, (_, op) in P1_ROWS.items():
        r = p1_rows[op]
        times[name] = (r["ns"] / 1e6, r["plain_ns"] / 1e6)
        bounds[name] = (r["bound_ns"] / 1e6, r["bound_by"])
    what = {
        "peak_decode": f"[{b},4,{cn_cfg.out_h},{cn_cfg.out_w}] K={k}",
        "peak_decode_k50": f"{list(kp_logits.shape)} K={kk50}, the keypoint net's keypoint "
                           f"heatmap",
        "mask_assembly": f"proto [{b},{p},{yl_cfg.in_h // 2},{yl_cfg.in_w // 2}] (NHWC view) "
                         f"K={kk} crop",
        "depthwise_upsample": f"all {len(calls)} calls of one batch-{b} forward",
        "deform_conv": f"all {N_DCN} calls of one batch-{b} DCN-IDA forward, f32",
        "deform_conv_bf16": f"all {N_DCN} calls of one batch-{b} dcn_north_star forward, bf16, "
                            f"window {DCN_WINDOW:g}",
        "transpose_conv": f"both calls of one batch-{b} int8-chain forward, int8 in and out",
        "int8_dot_probe": f"[{m},{kd}]@[{kd},{n}] x{probe['reps']} int8->int32",
        "depthwise_upsample_bf16": f"all {len(calls16)} calls of one batch-{b} north_star "
                                   f"forward, bf16",
        **{name: f"{op}, one iteration" for name, (_, op) in P1_ROWS.items()},
    }
    for name, (k_ms, p_ms) in times.items():
        b_ms, by = bounds[name]
        d_ms = device.get(name)
        on_device = "" if d_ms is None else f" ({d_ms:.4f} ms on the device)"
        print(f"time {name} {what[name]}: kernel {k_ms:.4f} ms{on_device}, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), library "
              f"{library.get(name, float('nan')):.4f} ms ({card})")
        times[name] = {"ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": by, "library_ms": library.get(name), "timed": what[name]}
    for row, (dcns, _, window) in dcn_rows.items():
        gflop = dcn_flop(dcns) / 1e9
        print(f"time {row}: {gflop:.2f} GFLOP in the products for {b} frames, kernel "
              f"{gflop / times[row]['device_ms']:.2f} TFLOP/s on the device, plain "
              f"{gflop / times[row]['plain_ms']:.2f} TFLOP/s ({card})")
        for (shape, o), (c, n_calls) in dcn_shapes(dcns).items():
            t = deform_conv.kernel_weights(c[3])
            k_ms, p_ms = abba(lambda: deform_conv2d_cuda(*c, taps=t, max_offset=window),
                              lambda: deform_conv2d(*c, max_offset=window), 5, timer=queued_ms)
            print(f"time {row} {shape} -> O={o} window {window} (x{n_calls} a forward, plan "
                  f"{dcn_plan(shape, o, c[0].dtype)}): kernel {k_ms:.4f} ms on the "
                  f"device = {dcn_flop([c]) / 1e9 / k_ms:.2f} TFLOP/s, plain {p_ms:.4f} ms "
                  f"({card})")
    # The device's cost of one launch, queued as the rows' device times are.
    empty_us = queued_ms(lambda: torch.cuda._sleep(0), 200) * 1e3
    print(f"time an empty kernel (torch.cuda._sleep(0), one thread) on the device: "
          f"{empty_us:.2f} us a launch ({card})")
    for tag, cs in (("", calls), ("_bf16", calls16)):
        for x, w, f in cs:
            k_ms, p_ms = abba(lambda: depthwise_upsample_cuda(x, w, f),
                              lambda: depthwise_upsample(x, w, f), 50, timer=queued_ms)
            o = depthwise_upsample(x, w, f)
            n_bytes = nbytes(x, w, o)
            b_ms, by = bound(n_bytes, 8 * o.numel(), PEAK["f32"])
            print(f"time depthwise_upsample{tag} f={f} {tuple(x.shape)} -> {tuple(o.shape[2:])}: "
                  f"kernel {k_ms:.4f} ms on the device = {n_bytes / k_ms / 1e6:.1f} GB/s, "
                  f"plain {p_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({by}, {PEAK['bytes'] / 1e9:.0f} GB/s) ({card})")
    for c in d_calls:
        k_ms, p_ms = abba(lambda: transpose_conv2x_int8_cuda(*c[:5], act=c[5], out_dtype=c[6],
                                                             taps=c[7]),
                          lambda: transpose_conv2x_int8(*c[:5], act=c[5], out_dtype=c[6]), 10,
                          timer=queued_ms)
        ops = 2 * 9 * c[0].numel() * c[1].shape[-1]
        print(f"time transpose_conv {tuple(c[0].shape)}: kernel {k_ms:.4f} ms on the device = "
              f"{ops / k_ms / 1e9:.2f} TOP/s, plain {p_ms:.4f} ms, bound "
              f"{ops / PEAK['int8'] * 1e3:.4f} ms at 1979 TOP/s int8 ({card})")
    for tag, r in probe["rows"].items():
        print(f"time int8_dot_probe {tag}: {r['ms'] * 1e3:.2f} us = {r['tops']:.1f} TOP/s "
              f"(exact {r['exact']}); one torch library call of the same [M,K]@[K,N] "
              f"{r['library_ms_one_product'] * 1e3:.2f} us = {r['library_tops']:.1f} TOP/s ({card})")
    print(f"time op_probe: (t(2N) - t(N)) / N, N = {p1['n_iter']}, max SM clock "
          f"{p1['max_sm_clock_mhz']:.0f} MHz, shared memory {p1['smem_tb_per_s']:.2f} TB/s "
          f"over 132 SMs ({card})")
    for r in p1["rows"]:
        rate = (f"{r['eff_tflops']:.2f} TFLOP/s" if "eff_tflops" in r
                else f"{r['gel_per_s']:.2f} Gel/s")
        print(f"time op_probe {r['op']}: {r['ns']:.1f} ns = {rate} on {r['blocks']} blocks, "
              f"bound {r['bound_ns']:.2f} ns ({r['bound_by']}), plain {r['plain_ns']:.0f} ns")

    # The integer core per distinct calibrated shape (batch 8): im2col +
    # _int_mm against cuDNN's bf16 convolution of the same shape.
    for (q_shape, k_shape, stride, padding), (q, qk, _, _) in int8_shapes.items():
        xb = q.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = qk.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
        i_ms, c_ms = abba(lambda: quantize_chain.conv2d_int8(q, qk, stride, padding),
                          lambda: F.conv2d(xb, wb, stride=stride, padding=padding), 10)
        ho = (q.shape[1] + 2 * padding - k_shape[0]) // stride[0] + 1
        wo = (q.shape[2] + 2 * padding - k_shape[1]) // stride[1] + 1
        ops = 2 * q.shape[0] * ho * wo * k_shape[0] * k_shape[1] * k_shape[2] * k_shape[3]
        print(f"time conv2d_int8 {q_shape} k{k_shape[0]}x{k_shape[1]} {k_shape[2]}->"
              f"{k_shape[3]} s{stride[0]}: im2col+_int_mm {i_ms:.4f} ms = {ops / i_ms / 1e9:.1f} "
              f"TOP/s, cuDNN bf16 {c_ms:.4f} ms = {ops / c_ms / 1e9:.1f} TFLOP/s ({card})")

    p1_verdict(p1_rows, early_convs(cn_cfg, card), card)

    device = torch.device("cuda")
    t_sec = lap("time kernels", t_start)
    frames = request_frames(1, (FPS_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    pipes = {}
    for path, (cn, cn_plain) in nets.items():
        pipe, plain = pipelines(path, cn, cn_plain, cn_cfg, yl, yl_cfg, chains)
        k_ms, p_ms = abba(lambda: pipe(frames), lambda: plain(frames), PAIR_ITERS)
        print(f"time pipeline {path} batch {FPS_BATCH} (upload + resize + both nets + "
              f"decode): kernels {k_ms:.3f} ms = {FPS_BATCH * 1000 / k_ms:.2f} "
              f"frames/s, plain {p_ms:.3f} ms = {FPS_BATCH * 1000 / p_ms:.2f} frames/s "
              f"({card})")
        pipes[path] = pipe
    t_sec = lap("time pair paths", t_sec)

    # The request's stages one by one, on device-resident frames.
    knobs = SERVING_DECODE
    cn, dcn, dcn_plain = nets["plain_ida"][0], *nets["dcn_ida"]
    with torch.inference_mode():
        on_card = frames.to(device)
        img = resize_frames(on_card, (cn_cfg.in_h, cn_cfg.in_w))
        cn_in = normalize_image(img, IMAGENET_MEAN, IMAGENET_STDDEV)
        yl_in = normalize_image(img, yl_cfg.img_mean, yl_cfg.img_stddev)
        cn_pred, yl_pred = cn(cn_in), yl(yl_in)
        chain_pred = chains["int8_chain"]["kernel"][1](yl_in)

        def preprocess_both():
            x = resize_frames(on_card, (cn_cfg.in_h, cn_cfg.in_w))
            return (normalize_image(x, IMAGENET_MEAN, IMAGENET_STDDEV),
                    normalize_image(x, yl_cfg.img_mean, yl_cfg.img_stddev))

        stages = {
            "upload": lambda: frames.to(device, non_blocking=True),
            "resize + normalise": preprocess_both,
            "CenterNet forward": lambda: cn(cn_in),
            "CenterNet forward, bf16 (north_star)": lambda: nets["north_star"][0](cn_in),
            "CenterNet DCN-IDA forward": lambda: dcn(cn_in),
            "CenterNet DCN-IDA forward, plain DCN": lambda: dcn_plain(cn_in),
            "CenterNet DCN-IDA forward, bf16 (dcn_north_star)":
                lambda: nets["dcn_north_star"][0](cn_in),
            "YOLACT forward, f32": lambda: yl(yl_in),
            "YOLACT int8 chain forward, kernel D (int8_chain)":
                lambda: chains["int8_chain"]["kernel"][1](yl_in),
            "YOLACT int8 chain forward, plain D": lambda: chains["int8_chain"]["plain"][1](yl_in),
            "YOLACT int8 chain forward, bf16 cuDNN transposes (north_star)":
                lambda: chains["north_star"]["kernel"][1](yl_in),
            "CenterNet decode": lambda: decode(cn_pred, cn_cfg, knobs.n_detections,
                                               knobs.score_threshold),
            "YOLACT decode": lambda: decode_yolact(yl_pred, yl_cfg, knobs.top_k,
                                                   knobs.iou_threshold,
                                                   knobs.confidence_threshold),
            "YOLACT decode, int8 chain": lambda: decode_yolact(
                chain_pred, yl_cfg, knobs.top_k, knobs.iou_threshold,
                knobs.confidence_threshold),
        }
        for fn in stages.values():
            fn()
        stage_ms = {name: time_ms(fn, 3) for name, fn in stages.items()}
    print(f"time stages batch {FPS_BATCH}: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in stage_ms.items()) + f" ({card})")
    t_sec = lap("time pair stages", t_sec)
    time_keypoints(kp_net, card)
    lap("time keypoints", t_sec)
    print(f"peak memory allocated: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    if profile_dir is not None:
        from torch.profiler import ProfilerActivity, profile

        out = pathlib.Path(profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        for path, pipe in pipes.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    pipe(frames)
                torch.cuda.synchronize()
            table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            (out / f"pipeline_profile_{path}.txt").write_text(f"{card}\n{table}\n")
            print(f"profile {path} (3 batch-32 requests), top kernels by device time:")
            print("\n".join(table.splitlines()[:22]))
    return times


def device_busy(fn, reps: int = 3):
    """(device ms a call, summed over its kernels and copies, and their
    count a call) from ``torch.profiler``, or (None, None) where the
    profiler records no device activity.  A launch-bound call issues more
    launches than the card queues, so a spin ahead of it (``queued_ms``)
    cannot keep the host's cost out; the trace's own durations can."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not device:
        return None, None
    return (round(sum(e.self_device_time_total for e in device) / 1e3 / reps, 3),
            round(sum(e.count for e in device) / reps))


def time_keypoints(kp_net, card):
    """The ``keypoints`` request at batch 16 (kernels and plain), and its
    stages one by one on device-resident frames, at the served knobs."""
    device = torch.device("cuda")
    kp, _, oc, cfg, projection = kp_net
    knobs = SERVING_DECODE
    frames = request_frames(7, (KP_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    pipe, plain = keypoint_pipelines(kp_net, device, knobs)
    k_ms, p_ms = abba(lambda: pipe(frames), lambda: plain(frames), 5)
    busy_ms, n_kernels = device_busy(lambda: pipe(frames), reps=1)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / k_ms:.1%}"
    print(f"time pipeline keypoints batch {KP_BATCH} (upload + resize + bf16 CenterNet + "
          f"decode + matcher + PnP): kernels {k_ms:.3f} ms = {KP_BATCH * 1000 / k_ms:.2f} "
          f"frames/s, plain {p_ms:.3f} ms = {KP_BATCH * 1000 / p_ms:.2f} frames/s; the "
          f"kernels' request: {n_kernels} device kernels and copies, busy {busy_ms} ms, the "
          f"device idle {idle} of the request ({card})")
    with torch.inference_mode():
        on_card = frames.to(device)
        proj = torch.tensor(projection, dtype=torch.float32, device=device)
        img = preprocess(on_card, (cfg.in_h, cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                         KEYPOINTS.input_dtype)
        pred = kp(img)
        dets = decode(pred, cfg, knobs.n_detections, knobs.score_threshold)
        peaks = keypoint_peaks(pred, cfg, knobs.keypoint_n_detections,
                               knobs.keypoint_score_threshold)
        slots_y, slots_x, _, _, claimed = match_keypoints(dets, peaks, oc)
        stages = {
            "upload": lambda: frames.to(device, non_blocking=True),
            "resize + normalise (bf16)": lambda: preprocess(
                on_card, (cfg.in_h, cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                KEYPOINTS.input_dtype),
            "forward": lambda: kp(img),
            "decode (objects, kernel A K=10)": lambda: decode(
                pred, cfg, knobs.n_detections, knobs.score_threshold),
            "keypoint peaks (kernel A K=50)": lambda: keypoint_peaks(
                pred, cfg, knobs.keypoint_n_detections, knobs.keypoint_score_threshold),
            "matcher": lambda: match_keypoints(dets, peaks, oc),
            "PnP": lambda: keypoint_poses(dets, slots_y, slots_x, claimed, cfg, oc, proj),
            "decode_keypoints (all of the decode)": lambda: decode_keypoints(
                pred, cfg, oc, proj, knobs.n_detections, knobs.keypoint_n_detections,
                knobs.score_threshold, knobs.keypoint_score_threshold),
        }
        for fn in stages.values():
            fn()
        stage_ms = {name: time_ms(fn, 3) for name, fn in stages.items()}
        busy = {name: device_busy(fn, reps=1) for name, fn in stages.items()}
    print(f"time stages keypoints batch {KP_BATCH} (ms back to back; device kernels and "
          f"copies a call, ms busy): " + ", ".join(
              f"{name} {ms:.3f} ({busy[name][1]}, {busy[name][0]})"
              for name, ms in stage_ms.items()) + f" ({card})")


def chain_split(forward, img, reps: int = 3):
    """{part: device ms} of one chain forward, from ``torch.profiler``:
    the integer convs' im2col side (padding, the strided copy, the
    weight's layout; their annotated range less ``_int_mm``), ``_int_mm``,
    kernel C, kernel E, the cuDNN convs (the float stem, the DCN blocks'
    offset and mask conv), the rest (epilogues, quantization, BatchNorms,
    joins, pools, casts), and "busy" (every kernel and copy); None where
    the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    conv = quantize_chain.conv2d_int8

    def annotated(*args):
        with record_function("chain.int8_conv"):
            return conv(*args)

    # The chain's integer convs, and quantized_call's (the per-layer path).
    quantize_chain.conv2d_int8 = quantize.conv2d_int8 = annotated
    try:
        forward(img)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                forward(img)
            torch.cuda.synchronize()
    finally:
        quantize_chain.conv2d_int8 = quantize.conv2d_int8 = conv
    rows = prof.key_averages()
    # The annotated range also appears on the device's timeline: not a kernel.
    kernel_rows = [e for e in rows
                   if e.device_type == DeviceType.CUDA and e.key != "chain.int8_conv"]
    if not kernel_rows:
        return None, prof

    def cpu_total(name):
        return sum(e.device_time_total for e in rows
                   if e.device_type == DeviceType.CPU and e.key == name) / 1e3 / reps

    def kernels_named(*parts):
        return sum(e.self_device_time_total for e in kernel_rows
                   if any(p in e.key for p in parts)) / 1e3 / reps

    split = {"busy": sum(e.self_device_time_total for e in kernel_rows) / 1e3 / reps,
             "int_mm": cpu_total("aten::_int_mm"),
             "C": kernels_named("depthwise_upsample_kernel"),
             "E": kernels_named("deform_conv_kernel", "deform_conv_reduce", "nchw_to_nhwc"),
             "cudnn_conv": cpu_total("aten::cudnn_convolution")}
    split["im2col"] = cpu_total("chain.int8_conv") - split["int_mm"]
    split["other"] = split["busy"] - sum(split[k] for k in ("im2col", "int_mm", "C", "E",
                                                            "cudnn_conv"))
    return {k: round(v, 3) for k, v in split.items()}, prof


def time_chain_paths(chains, nets, cn_cfg, yl, yl_cfg, yl_scales, kp_net, kp_scales, card,
                     profile_dir):
    """The int8-chain paths' requests (kernels and plain): each chain pair
    at batch 32 as bench.py times it (frames/s = batch over the sum of its
    two requests), the keypoint chain at batch 16; their stages and the
    CenterNet chain forward's split from torch.profiler."""
    device = torch.device("cuda")
    frames = request_frames(1, (FPS_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    for path in CHAIN_PAIRS:
        pipes = chain_pair_pipelines(path, chains, cn_cfg, yl, yl_scales)
        (cn_k, yl_k), (cn_p, yl_p) = pipes["kernel"], pipes["plain"]
        cn_ms, cn_plain_ms = abba(lambda: cn_k(frames), lambda: cn_p(frames), CHAIN_ITERS)
        yl_ms, yl_plain_ms = abba(lambda: yl_k(frames), lambda: yl_p(frames), CHAIN_ITERS)
        busy_ms, n_kernels = device_busy(lambda: (cn_k(frames), yl_k(frames)))
        wall = cn_ms + yl_ms
        idle = "not measured" if busy_ms is None else f"{1 - busy_ms / wall:.1%}"
        print(f"time pipeline {path} batch {FPS_BATCH} (bench.py's two requests, each upload + "
              f"bf16 preprocess + int8 chain + decode): CenterNet {cn_ms:.3f} ms, YOLACT "
              f"{yl_ms:.3f} ms, kernels {FPS_BATCH * 1000 / wall:.2f} frames/s, plain "
              f"CenterNet {cn_plain_ms:.3f} ms, YOLACT {yl_plain_ms:.3f} ms = "
              f"{FPS_BATCH * 1000 / (cn_plain_ms + yl_plain_ms):.2f} frames/s; the kernels' "
              f"pair: {n_kernels} device kernels and copies, busy {busy_ms} ms, the device idle "
              f"{idle} ({card})")

    knobs = SERVING_DECODE
    recipe = CHAIN_INT8
    with torch.inference_mode():
        on_card = frames.to(device)
        cn_in = preprocess(on_card, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                           recipe.input_dtype)
        yl_in = preprocess(on_card, (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean,
                           yl_cfg.img_stddev, recipe.yolact.dtype)
        yl_fwd = yolact_chain_forward(ChainCtx(yl, yl_scales, dtype=recipe.yolact.dtype,
                                               join_dtype=recipe.yolact.join_dtype))
        cn_fwd = chains["chain_int8"]["kernel"][1]
        dcn_fwd = chains["dcn_chain_int8"]["kernel"][1]
        cn_pred, yl_pred = cn_fwd(cn_in), yl_fwd(yl_in)
        stages = {
            "upload": lambda: frames.to(device, non_blocking=True),
            "preprocess to bf16 (CenterNet)": lambda: preprocess(
                on_card, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                recipe.input_dtype),
            "CenterNet int8 chain forward (chain_int8)": lambda: cn_fwd(cn_in),
            "CenterNet int8 chain forward, DCN IDA (dcn_chain_int8)": lambda: dcn_fwd(cn_in),
            "CenterNet bf16 forward (north_star), same frames": lambda: nets["north_star"][0](
                cn_in.float()),
            "YOLACT int8 chain forward, chain-int8 recipe": lambda: yl_fwd(yl_in),
            "CenterNet decode": lambda: decode(cn_pred, cn_cfg, knobs.n_detections,
                                               knobs.score_threshold),
            "YOLACT decode": lambda: decode_yolact(yl_pred, yl_cfg, knobs.top_k,
                                                   knobs.iou_threshold,
                                                   knobs.confidence_threshold),
        }
        for fn in stages.values():
            fn()
        stage_ms = {name: time_ms(fn, 3) for name, fn in stages.items()}
        print(f"time stages chain pairs batch {FPS_BATCH}: " + ", ".join(
            f"{name} {ms:.3f} ms" for name, ms in stage_ms.items()) + f" ({card})")
        for tag, fwd, wall in (("chain_int8", cn_fwd,
                                stage_ms["CenterNet int8 chain forward (chain_int8)"]),
                               ("dcn_chain_int8", dcn_fwd, stage_ms[
                                   "CenterNet int8 chain forward, DCN IDA (dcn_chain_int8)"])):
            split, prof = chain_split(fwd, cn_in)
            if split is None:
                print(f"time split {tag} CenterNet chain forward: not measured (the profiler "
                      f"recorded no device activity)")
                continue
            print(f"time split {tag} CenterNet chain forward batch {FPS_BATCH} (device ms from "
                  f"torch.profiler, 3 forwards): {split}; im2col "
                  f"{split['im2col'] / split['busy']:.1%} of device time, _int_mm "
                  f"{split['int_mm'] / split['busy']:.1%}; busy {split['busy']:.3f} of "
                  f"{wall:.3f} ms back to back, the device idle {1 - split['busy'] / wall:.1%} "
                  f"({card})")
            if profile_dir is not None:
                out = pathlib.Path(profile_dir)
                out.mkdir(parents=True, exist_ok=True)
                table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=50)
                (out / f"chain_profile_{tag}.txt").write_text(f"{card}\n{table}\n")

    kp_frames = request_frames(7, (KP_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    pipe, plain = keypoint_chain_pipelines(kp_net, kp_scales)
    bf16_pipe, _ = keypoint_pipelines(kp_net, device, knobs)
    k_ms, p_ms = abba(lambda: pipe(kp_frames), lambda: plain(kp_frames), 3)
    b_ms, _ = abba(lambda: bf16_pipe(kp_frames), lambda: pipe(kp_frames), 3)
    busy_ms, n_kernels = device_busy(lambda: pipe(kp_frames), reps=1)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / k_ms:.1%}"
    kp = kp_net[0]
    img = preprocess(kp_frames.to(device), (kp_net[3].in_h, kp_net[3].in_w), IMAGENET_MEAN,
                     IMAGENET_STDDEV, KEYPOINTS.input_dtype)
    kp_fwd = keypoint_chain_forward(kp, kp_scales, "kernel")
    with torch.inference_mode():
        kp_fwd(img)
        fwd_ms, bf16_fwd_ms = abba(lambda: kp_fwd(img), lambda: kp(img), 3)
    print(f"time pipeline {KP_INT8} batch {KP_BATCH} (upload + bf16 preprocess + int8 chain + "
          f"decode + matcher + PnP): kernels {k_ms:.3f} ms = {KP_BATCH * 1000 / k_ms:.2f} "
          f"frames/s, plain {p_ms:.3f} ms = {KP_BATCH * 1000 / p_ms:.2f} frames/s, the bf16 "
          f"keypoints request in the same call {b_ms:.3f} ms = {KP_BATCH * 1000 / b_ms:.2f} "
          f"frames/s; forward: int8 chain {fwd_ms:.3f} ms, bf16 net {bf16_fwd_ms:.3f} ms; "
          f"the chain's request: {n_kernels} device kernels and copies, busy {busy_ms} ms, the "
          f"device idle {idle} ({card})")


# ---- phase 6: train ----------------------------------------------------

TRAIN_BATCH = 32          # samples_torpedo's batch, at its 360x640
TRAIN_F32_BATCH = 8
TRAIN_OBJECTS = 16        # squares a frame at most: 64 keypoint slots, max_keypoints' default
OVERFIT_STEPS = 6
TRAIN_TIMED_STEPS = 1
# A train step is sensitive to its last bits (training BatchNorm on the
# deepest levels, ReLU kinks, the DCN): the kernel path is held to the
# plain path within the larger of a bar and YARDSTICK times the plain
# path's own move when the input is scaled by 1 +- NUDGE (the larger of
# the two moves); tests/test_torch_train_step.py does the same against
# JAX.  Bars (losses relative, gradients relative L2): f32 as the CPU
# tests against JAX; bf16 at ~1/4 and ~2.5 of its 2^-8 step.
NUDGE = 1e-6
YARDSTICK = 8.0
TRAIN_BARS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-3, 1e-2)}
# Parameters with no gradient by construction: the projections that the
# JAX model computes and discards and the port never runs, and the heads
# whose loss lambda is 0 (samples_torpedo's offset head).
DISCARDED = ("model.base.level3.project.", "model.base.level4.project.")
# The same step without the DCN window, as PERF.md section 6 records it
# (NVIDIA H100 80GB HBM3, 700 W).
UNWINDOWED_E_BACKWARD_MS, UNWINDOWED_STEP_MS, UNWINDOWED_PEAK_GIB = 813.3, 1057.0, 25.79


def train_setup():
    """(object, model and train configs; numpy frames and truth of the
    synthetic squares at 360x640, batch 32)."""
    oc = square_object_config()
    mc, tc = samples_torpedo.model_config, samples_torpedo.train_config
    img, truth = generate_square_batch(np.random.default_rng(0), TRAIN_BATCH, SquareDatasetConfig(
        in_h=mc.in_h, in_w=mc.in_w, max_objects=TRAIN_OBJECTS, keypoints=True))
    return oc, mc, tc, img, truth


def train_model(oc, dtype, impl="kernel", seed=0):
    """The DCN CenterpointDLA34 as the JAX package trains it (dtype, f32
    BatchNorm outputs, bf16 stem, the 3-cell DCN window), with the flax
    init from a seed."""
    return CenterpointDLA34(oc, up_impl=impl, dcn_impl=impl, deform=True, dtype=dtype,
                            dcn_max_offset=DCN_WINDOW, init="flax",
                            generator=torch.Generator().manual_seed(seed), device="cuda")


def on_card(img, truth, batch):
    return (torch.from_numpy(img[:batch]).cuda().permute(0, 3, 1, 2).contiguous(),
            dataclasses.replace(truth, **{f.name: getattr(truth, f.name)[:batch]
                                          for f in dataclasses.fields(truth)
                                          if getattr(truth, f.name) is not None}).to("cuda"))


def zero_grad_by_construction(name, tc):
    # The heads: heatmap, keypoint heatmap and affinity, size, offset, ...
    offset_head = "model.4."
    return name.startswith(DISCARDED) or (tc.loss_lambda_offset == 0
                                          and name.startswith(offset_head))


def step_grads(model, img, truth, mc, tc, oc):
    """(losses, {name: gradient}) of one train step from ``model``, whose
    clip never bites (max norm inf), so that .grad keeps the raw
    gradients."""
    state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, float("inf")))
    _, losses = make_centernet_train_step(mc, tc, oc)(state, img, truth)
    return losses, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def rel(a, b) -> float:
    """|a - b| / |b| by L2, in f64."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return (a - b).norm().item() / max(b.norm().item(), 1e-30)


def check_train_step(dtype, batch, data):
    """The kernel path's train step against the plain path's from the same
    weights and batch (see NUDGE), the launches of its forward, and every
    trained parameter's gradient finite and non-zero.  The two paths'
    backwards are the same code (the plain versions recomputed), so what
    differs is C's and E's forward outputs, carried through the step."""
    oc, mc, tc, img_np, truth_np = data
    img, truth = on_card(img_np, truth_np, batch)
    entry = "bf16" if dtype == torch.bfloat16 else "f32"
    loss_bar, grad_bar = TRAIN_BARS[dtype]
    failures = []
    kernel = train_model(oc, dtype)
    plain = train_model(oc, dtype, "plain")
    start = {k: v.clone() for k, v in plain.state_dict().items()}
    kernels.reset_launch_counts()
    k_losses, k_grads = step_grads(kernel, img, truth, mc, tc, oc)
    torch.cuda.synchronize()
    counts = (kernels.ENTRY_LAUNCHES[f"tauv_depthwise_upsample_{entry}"],
              kernels.ENTRY_LAUNCHES[f"tauv_deform_conv_{entry}"])
    require(counts == (8, N_DCN) and sum(kernels.LAUNCHES.values()) == 8 + N_DCN,
            f"train step {entry}: launches {dict(kernels.LAUNCHES)}, expected C 8 and E {N_DCN}")
    p_losses, p_grads = step_grads(plain, img, truth, mc, tc, oc)
    nudged = []
    for sign in (1, -1):
        model = train_model(oc, dtype, "plain")
        model.load_state_dict(start)
        nudged.append(step_grads(model, img * (1 + sign * NUDGE), truth, mc, tc, oc))
        del model

    def held(what, k, p, ns, base):
        err = rel(k, p)
        yard = max(rel(n, p) for n in ns)
        if err > max(base, YARDSTICK * yard):
            failures.append(f"{what} {err:.3g} > max({base}, {YARDSTICK} x {yard:.3g})")
        return err, yard

    for field in dataclasses.fields(k_losses):
        k, p = getattr(k_losses, field.name), getattr(p_losses, field.name)
        require(bool(torch.isfinite(k)), f"train {entry}: loss {field.name} not finite")
        if not p.any():
            require(not k.any(), f"train {entry}: loss {field.name} {k.item()} where plain is 0")
            continue
        held(f"loss {field.name}", k, p, [getattr(n[0], field.name) for n in nudged], loss_bar)
    errs, yards, zero = [], [], []
    for name in p_grads.keys() | k_grads.keys() | dict(plain.named_parameters()).keys():
        kg, pg = k_grads.get(name), p_grads.get(name)
        if zero_grad_by_construction(name, tc):
            require(kg is None or not kg.any(), f"train {entry}: {name} has a gradient")
            zero.append(name)
            continue
        require(kg is not None and bool(torch.isfinite(kg).all()) and bool(kg.any()),
                f"train {entry}: {name}'s gradient is missing, not finite or zero")
        if name.endswith("conv.bias"):
            # A DCN's bias, just before its BatchNorm on batch statistics: 0
            # in exact arithmetic, so held by its size against its weight's.
            weight = name[:-len("bias")] + "weight"
            for g, w in ((kg, k_grads[weight]), (pg, p_grads[weight])):
                if g.double().norm().item() > grad_bar * w.double().norm().item():
                    failures.append(f"{name} {g.norm().item():.3g} against its weight's "
                                    f"{w.norm().item():.3g}")
            continue
        err, yard = held(f"gradient of {name}", kg, pg, [n[1][name] for n in nudged], grad_bar)
        errs.append(err)
        yards.append(yard)
    moved = np.asarray(yards) > 0
    ratio = np.asarray(errs)[moved] / np.asarray(yards)[moved]
    print(f"train check {entry} batch {batch}, one train step (training BatchNorm), kernel "
          f"path against plain path from the same weights and batch: total loss "
          f"{float(k_losses.total):.7g} against {float(p_losses.total):.7g}; {len(errs)} "
          f"gradients finite and non-zero (upsamples and DCN weights included; {len(zero)} "
          f"zero by construction: {DISCARDED} and the zero-lambda offset head), relative L2 "
          f"median {np.median(errs):.3g} max {max(errs):.3g}; the plain path's own move under "
          f"the input x(1 +- {NUDGE}): median {np.median(yards):.3g} max {max(yards):.3g}; "
          f"err / move median {np.median(ratio):.3g} max {ratio.max():.3g} where it moved "
          f"({int(moved.sum())}) (bars: losses "
          f"{loss_bar}, gradients {grad_bar}, or {YARDSTICK}x the move); forward launches "
          f"C {counts[0]}, E {counts[1]}")
    require(not failures, f"train {entry} batch {batch}: {len(failures)} outside their bars: "
                          f"{failures}")
    del kernel, plain, nudged, k_grads, p_grads
    torch.cuda.empty_cache()


def check_train_kernel_calls(errs, data, state_dict):
    """Kernels C and E bf16 against their plain versions at the 8 and 16
    calls of one training forward at batch 32 of a model holding
    ``state_dict`` (phase 3's tolerances); the worst errors join ``errs``."""
    oc, _, _, img_np, truth_np = data
    img, _ = on_card(img_np, truth_np, TRAIN_BATCH)
    probe = train_model(oc, torch.bfloat16, "plain")
    probe.load_state_dict(state_dict)
    ups, dcns = [], []
    hooks = [m.register_forward_pre_hook(lambda m, a: ups.append(
                 (a[0].to(m.dtype).clone(), m.weight.detach().to(m.dtype), m.factor)))
             for m in probe.depthwise_upsamples()]
    hooks += [m.register_forward_pre_hook(lambda m, a: dcns.append(
                  (*(t.clone() for t in a), m.weight.detach().to(a[0].dtype), m.bias.detach())))
              for m in probe.deform_convs()]
    with torch.no_grad(), model_mode(probe, True):
        probe(img)
    for h in hooks:
        h.remove()
    del probe
    require(len(ups) == 8 and len(dcns) == N_DCN, f"train calls: {len(ups)} C, {len(dcns)} E")
    c_err = e_err = 0.0
    for x, w, f in ups:
        got, want = depthwise_upsample_cuda(x, w, f), depthwise_upsample(x, w, f)
        diff = (got.float() - want.float()).abs()
        ulps = (diff / bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))).max()
        require(ulps.item() <= 1.0, f"train C {tuple(x.shape)}: {ulps.item()} ulps")
        c_err = max(c_err, diff.max().item())
    for x, offset, mask, w, bias in dcns:
        got = deform_conv2d_cuda(x, offset, mask, w, bias, max_offset=DCN_WINDOW)
        want = deform_conv2d(x, offset, mask, w, bias, max_offset=DCN_WINDOW)
        diff = (got.float() - want.float()).abs()
        big = torch.maximum(got.float().abs(), want.float().abs())
        bar = bf16_ulp(big) + 9 * x.shape[1] * 2.0 ** -24 * want.float().abs().max()
        require(not (diff > bar).any().item(), f"train E {tuple(x.shape)}: err "
                                               f"{diff.max().item()}")
        e_err = max(e_err, diff.max().item())
    torch.cuda.synchronize()
    print(f"check train calls at batch {TRAIN_BATCH} (training BatchNorm): "
          f"depthwise_upsample_bf16 x8 max_abs_err {c_err:.3g} (one bf16 ulp), "
          f"deform_conv_bf16 x{N_DCN} (offsets |.| <= "
          f"{max(c[1].abs().max().item() for c in dcns):.3g}) max_abs_err {e_err:.3g} (one "
          f"bf16 ulp + 9 C 2^-24 max|plain|)")
    errs["depthwise_upsample_bf16"] = max(errs["depthwise_upsample_bf16"], c_err)
    errs["deform_conv_bf16"] = max(errs["deform_conv_bf16"], e_err)
    del ups, dcns
    torch.cuda.empty_cache()


class _Totals:
    """A metric writer that keeps each step's total loss."""

    def __init__(self):
        self.totals = []

    def log(self, metrics, step):
        self.totals.append(metrics["train/total"])

    def close(self):
        pass


def train_phase(errs, card):
    """Train the DCN CenterNet on the card (see the module docstring);
    returns the trainer run's launch counts (by kernel, by entry point, by
    variant)."""
    t0 = time.perf_counter()
    data = train_setup()
    oc, mc, tc, img_np, truth_np = data
    n_objects = int(truth_np.valid.sum())
    print(f"train data: {TRAIN_BATCH} synthetic 360x640 frames, {n_objects} squares, "
          f"{int(truth_np.keypoint_valid.sum())} keypoints ({time.perf_counter() - t0:.1f} s)")
    check_train_step(torch.float32, TRAIN_F32_BATCH, data)
    check_train_step(torch.bfloat16, TRAIN_BATCH, data)
    t_sec = lap("train kernel vs plain steps", t0)

    # The overfit: Trainer on one batch, as the CLI's --overfit runs it.
    model = train_model(oc, torch.bfloat16)
    state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, tc.grad_max_norm))
    totals = _Totals()
    trainer = Trainer(make_centernet_train_step(mc, tc, oc), None,
                      state, TrainerConfig(n_epochs=1, epoch_n_batches=OVERFIT_STEPS,
                                           overfit_single_batch=True),
                      writer=MultiWriter(StdoutWriter("train "), totals))
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    state = trainer.fit(lambda: itertools.repeat((img_np, truth_np), OVERFIT_STEPS))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    launches = (dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES),
                dict(kernels.VARIANT_LAUNCHES))
    want = {"depthwise_upsample": 8 * OVERFIT_STEPS, "deform_conv": N_DCN * OVERFIT_STEPS}
    require({k: v for k, v in launches[0].items() if v} == want,
            f"train: launch counts {launches[0]}, expected {want}")
    t = totals.totals
    require(len(t) == OVERFIT_STEPS and all(np.isfinite(t)), f"train: losses {t}")
    require(t[-1] < 0.5 * t[0], f"train: the overfit's last loss {t[-1]} is not below half "
                                f"its first {t[0]}: {t}")
    print(f"train overfit: {OVERFIT_STEPS} bf16 steps at batch {TRAIN_BATCH} through Trainer, "
          f"loss {t[0]:.6g} -> {t[-1]:.6g} ({t[-1] / t[0]:.3f} of the first), {fit_s:.1f} s, "
          f"launches {want}")
    # The kernels at the trained net's calls, whose offsets have moved off 0.
    check_train_kernel_calls(errs, data, state.model.state_dict())
    t_sec = lap("train overfit and kernel calls", t_sec)

    # Checkpoint: save, restore into a fresh model and optimizer (the same
    # parameters, statistics, moments and count), and the next step's loss
    # equals the uninterrupted run's.  Then two steps from the checkpoint,
    # twice: whether both steps' losses and the first step's gradients
    # repeat bit for bit, and which gradients do not.
    img, truth = on_card(img_np, truth_np, TRAIN_BATCH)
    step = make_centernet_train_step(mc, tc, oc)
    saved_model = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_opt = state.optimizer.state_dict()
    saved_opt = {"count": saved_opt["param_groups"][0]["count"],
                 "state": {i: {k: v.clone() for k, v in s.items()}
                           for i, s in saved_opt["state"].items()}}
    with tempfile.TemporaryDirectory() as directory:
        manager = CheckpointManager(pathlib.Path(directory))
        manager.save_configs({"model_config": mc, "train_config": tc})
        manager.save(state.step, state, metrics={"loss": t[-1]})
        going = float(step(state, img, truth)[1].total)

        def restored():
            model = train_model(oc, torch.bfloat16, seed=1)
            return manager.restore(TrainState(model, adam_with_clip(
                model.parameters(), tc.lr, tc.grad_max_norm)))

        fresh = restored()
        restored_opt, restored_at = fresh.optimizer.state_dict(), fresh.step
        require(restored_at == OVERFIT_STEPS
                and all(torch.equal(v, saved_model[k])
                        for k, v in fresh.model.state_dict().items())
                and restored_opt["param_groups"][0]["count"] == saved_opt["count"]
                and all(torch.equal(v, saved_opt["state"][i][k])
                        for i, s in restored_opt["state"].items() for k, v in s.items()),
                "train checkpoint: the restored state differs from the saved one")
        resumed = float(step(fresh, img, truth)[1].total)
        require(resumed == going, f"train checkpoint: next loss {resumed} against {going}")
        print(f"train checkpoint: restored step {restored_at} into a fresh model and "
              f"optimizer (parameters, statistics, Adam's moments and count equal the saved "
              f"ones); the next loss {resumed!r} equals the uninterrupted run's")
        del fresh
        torch.cuda.empty_cache()
        repeat_steps(restored, step, img, truth, card)
    t_sec = lap("train checkpoint and repeats", t_sec)
    time_train(state, img, truth, step, card)
    lap("train timed step and split", t_sec)
    print(f"train phase {time.perf_counter() - t0:.1f} s")
    return launches


def two_steps(restored, step, img, truth):
    """([both steps' total losses], {name: gradient after the first step})
    of two train steps from a freshly restored checkpoint."""
    state = restored()
    first = float(step(state, img, truth)[1].total)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    second = float(step(state, img, truth)[1].total)
    del state
    torch.cuda.empty_cache()
    return [first, second], grads


def repeat_steps(restored, step, img, truth, card):
    """Two steps from the same checkpoint, twice, as the port runs them and
    with cuDNN held to its deterministic algorithms: whether the losses
    and gradients repeat bit for bit, which parameters' gradients do not
    (the ops that still sum in another order each run), and what the
    deterministic cuDNN costs a step."""
    for deterministic in (False, True):
        torch.backends.cudnn.deterministic = deterministic
        try:
            runs = [two_steps(restored, step, img, truth) for _ in range(2)]
            state = restored()
            step(state, img, truth)
            ms = time_ms(lambda: step(state, img, truth), TRAIN_TIMED_STEPS)
            del state
            torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = False
        (l1, g1), (l2, g2) = runs
        differ = sorted(n for n in g1 if not torch.equal(g1[n], g2[n]))
        print(f"train repeat (cudnn.deterministic={deterministic}): two steps from one "
              f"checkpoint, twice: losses {l1} and {l2}, bit-equal: step 1 {l1[0] == l2[0]}, "
              f"step 2 {l1[1] == l2[1]}; {len(g1) - len(differ)} of {len(g1)} gradients after "
              f"step 1 bit-equal, differing: {differ[:12]}{' ...' if len(differ) > 12 else ''}; "
              f"a step {ms:.3f} ms ({card})")


def time_train(state, img, truth, step, card):
    """Steps/s, images/s and peak memory of the bf16 train step at batch 32
    (CUDA events, after warm-up), and its device split from
    ``torch.profiler``: forward, E's and C's recomputed backward, the rest
    of the backward, the optimizer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step(state, img, truth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(state, img, truth), TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"time train step bf16 batch {TRAIN_BATCH}: {ms:.3f} ms a step = {1000 / ms:.4f} "
          f"steps/s = {TRAIN_BATCH * 1000 / ms:.2f} images/s; peak memory allocated "
          f"{peak:.2f} GiB ({card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, img, truth)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    ranges = (train_steps.FORWARD, train_steps.OPTIMIZER, deform_conv.BACKWARD_RANGE,
              conv_transpose.BACKWARD_RANGE)
    kernel_rows = [e for e in rows if e.device_type == DeviceType.CUDA and e.key not in ranges]
    if not kernel_rows:
        print("time train split: not measured (the profiler recorded no device activity)")
        return

    def range_ms(name):
        return sum(e.device_time_total for e in rows
                   if e.device_type == DeviceType.CPU and e.key == name) / 1e3

    def kernels_ms(*parts):
        return sum(e.self_device_time_total for e in kernel_rows
                   if any(p in e.key for p in parts)) / 1e3

    busy = sum(e.self_device_time_total for e in kernel_rows) / 1e3
    split = {"forward": range_ms(train_steps.FORWARD),
             "E forward": kernels_ms("deform_conv_kernel", "deform_conv_reduce", "nchw_to_nhwc"),
             "C forward": kernels_ms("depthwise_upsample_kernel"),
             "E backward (plain, recomputed)": range_ms(deform_conv.BACKWARD_RANGE),
             "C backward (plain, recomputed)": range_ms(conv_transpose.BACKWARD_RANGE),
             "optimizer": range_ms(train_steps.OPTIMIZER)}
    split["rest of backward"] = busy - sum(split[k] for k in (
        "forward", "E backward (plain, recomputed)", "C backward (plain, recomputed)",
        "optimizer"))
    print(f"time train split (torch.profiler, one step, device ms): "
          f"{ {k: round(v, 3) for k, v in split.items()} }, device busy {busy:.3f} of the "
          f"step's {ms:.3f} ms back to back; E backward is "
          f"{split['E backward (plain, recomputed)'] / busy:.1%} of the busy time; the "
          f"step without the window (PERF.md, NVIDIA H100 80GB HBM3, 700 W): E backward "
          f"{UNWINDOWED_E_BACKWARD_MS} ms of a {UNWINDOWED_STEP_MS} ms step, peak "
          f"{UNWINDOWED_PEAK_GIB} GiB "
          f"({card})")


# ---- phase 7: train_cli -------------------------------------------------

CLI_TRAIN, CLI_VAL = 32, 16   # samples of each of the two dataset directories
CLI_DATASETS = 2
CLI_BATCHES = 2               # --epoch-n-batches
CLI_WATCH_EVERY = 2
CLI_SIDES = (24.0, 96.0)      # the squares' sides in pixels, at 360x640
CLI_CONFIG = """
import dataclasses
from tauv_vision_tpu_torch.configs import samples_torpedo as base
model_config = base.model_config
train_config = dataclasses.replace(base.train_config, n_epochs={epochs}, weight_save_interval=1)
object_config = base.object_config
"""


def cli_records(results):
    with open(results / "metrics.jsonl") as fp:
        return [json.loads(line) for line in fp]


@contextlib.contextmanager
def train_epoch_times():
    """Yields a list that gains (epoch, wall seconds, steps, seconds to
    the first batch) for each ``Trainer.run_train_epoch`` run inside: the
    whole epoch, the wait for each batch from the loader included (its
    first batch too).  The epoch ends on its last loss read back to the
    host."""
    times = []
    run = Trainer.run_train_epoch

    def timed(self, batches, epoch):
        start, t0 = self.global_step, time.perf_counter()
        first = []

        def arrivals():
            for batch in batches:
                if not first:
                    first.append(time.perf_counter() - t0)
                yield batch

        feed = arrivals()
        try:
            loss = run(self, feed, epoch)
        finally:
            feed.close()
        times.append((epoch, time.perf_counter() - t0, self.global_step - start,
                      first[0] if first else float("nan")))
        return loss

    Trainer.run_train_epoch = timed
    try:
        yield times
    finally:
        Trainer.run_train_epoch = run


def cli_images_per_s(epochs, batch, after_first=False):
    """Images/s of the CLI's training, host reading included: every train
    image of a run's epochs but its first (warm-up) over those epochs' wall
    time, the loader's waits at each epoch's start included; with
    ``after_first``, the images after each epoch's first batch over the
    time from its arrival to the epoch's end (the start-up wait left
    out)."""
    later = [(s - f if after_first else s, n) for e, s, n, f in epochs if e > 0]
    return batch * sum(n for _, n in later) / sum(s for s, _ in later) if later else float("nan")


def steps_idle_share(prof):
    """The device's idle share from the first train step's forward to the
    last optimizer step, from a ``torch.profiler`` run; None when the
    profiler recorded no device activity."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = (train_steps.FORWARD, train_steps.LOSS, train_steps.OPTIMIZER,
              deform_conv.BACKWARD_RANGE, conv_transpose.BACKWARD_RANGE)
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    starts = [e.time_range.start for e in cpu if e.name == train_steps.FORWARD]
    ends = [e.time_range.end for e in cpu if e.name == train_steps.OPTIMIZER]
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in ranges]
    if not starts or not ends or not device:
        return None
    t0, t1 = min(starts), max(ends)
    busy = sum(min(e.time_range.end, t1) - e.time_range.start for e in device
               if t0 <= e.time_range.start < t1)
    return 1 - busy / (t1 - t0)


def loader_host_ms(ds, collate, batch):
    """The loader's host work for one batch on one thread (decode,
    augment, collate), ms: the mean of two batches."""
    t0 = time.perf_counter()
    for j in range(2):
        collate([ds[(j * batch + i) % len(ds)] for i in range(batch)])
    return (time.perf_counter() - t0) / 2 * 1e3


def check_cli_runs(label, base, state, warm, batches, watch_every, fresh_state):
    """The checks both training CLIs share, on ``base / "run"`` (two epochs
    of ``batches`` steps, watch lines every ``watch_every``, ``state`` its
    result) and ``base / "warm"`` (one epoch from the run's last
    checkpoint, ``warm`` its result): the restore into ``fresh_state()``
    gives the saved parameters, statistics and Adam moments bit for bit;
    the record counts; every train and val loss of both runs finite; the
    last checkpoint's and the warm start's steps; watch lines covering
    every trained parameter.  Returns (train, val, warm train records,
    watch lines, checkpoint steps, trained parameter names)."""
    manager = CheckpointManager(base / "run" / "checkpoints")
    steps = manager.all_steps()
    saved = torch.load(base / "run" / "checkpoints" / str(steps[-1]) / "state.pt",
                       map_location="cuda", weights_only=True)
    restored = manager.restore(fresh_state())
    moments = restored.optimizer.state_dict()["state"]
    require(all(torch.equal(v, saved["model"][k])
                for k, v in restored.model.state_dict().items())
            and len(moments) == len(saved["optimizer"]["state"])
            and all(torch.equal(moments[i][k], s[k]) for i, s in
                    saved["optimizer"]["state"].items() for k in ("mu", "nu")),
            f"{label}: the restored parameters or moments differ from the saved ones")
    del restored, saved

    records, warm_records = cli_records(base / "run"), cli_records(base / "warm")
    n_train = 2 * batches
    train = [r for r in records if "train/total" in r]
    val = [r for r in records if "val/total" in r]
    watch = [r for r in records if "watch/global_grad_norm" in r]
    warm_train = [r for r in warm_records if "train/total" in r]
    warm_val = [r for r in warm_records if "val/total" in r]
    require(len(train) == n_train and len(val) == 2 and len(warm_train) == batches
            and len(warm_val) == 1,
            f"{label}: {len(train)} train, {len(val)} val, {len(warm_train)} warm train, "
            f"{len(warm_val)} warm val records")
    require(all(math.isfinite(v) for r in train + val + warm_train + warm_val
                for k, v in r.items() if k.startswith(("train/", "val/"))),
            f"{label}: a loss is not finite")
    require(steps[-1] == n_train and warm_train[0]["step"] == n_train
            and warm.step == n_train + batches,
            f"{label}: checkpoints {steps}, warm start at {warm_train[0]['step']}")
    trained = {n.replace(".", "/") for n, p in state.model.named_parameters()
               if p.grad is not None}
    require([r["step"] for r in watch] == list(range(0, n_train, watch_every)) and all(
        {k[len("watch/"):-len("/grad_norm")] for k in r if k.endswith("/grad_norm")} == trained
        for r in watch), f"{label}: the watch lines do not cover every trained parameter")
    return train, val, warm_train, watch, steps, trained


def print_cli_time(label, epochs, batch, host_ms, workers, prof, batches, peak, card,
                   profiled="warm start's"):
    """The CLI's ``time`` line: images/s with host reading included
    (``cli_images_per_s``), the loader's host ms a batch on one thread,
    the device's idle share over the ``profiled`` run's steps, peak
    memory."""
    idle = steps_idle_share(prof)
    print(f"time {label}: {cli_images_per_s(epochs, batch):.2f} images/s (host reading "
          f"included: the train images of epoch 1 over its wall time, the loader's waits "
          f"included; {cli_images_per_s(epochs, batch, after_first=True):.2f} after the epoch's "
          f"first batch; epochs (epoch, s, steps, s to the first batch) "
          f"{[(e, round(t, 3), n, round(f, 3)) for e, t, n, f in epochs]}), "
          f"the loader's host work {host_ms:.1f} ms a batch of {batch} on one thread (decode, "
          f"augment, collate; {workers} threads in the CLI), the device idle "
          f"{'not measured' if idle is None else f'{idle:.1%}'} over the {profiled} "
          f"{batches} steps, peak memory allocated {peak:.2f} GiB ({card})")


def train_cli_phase(card):
    """The training CLI on PNG dataset directories (see the module
    docstring); returns its launch counts (by kernel, by entry point, by
    variant)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    mc, tc, oc = samples_torpedo.model_config, samples_torpedo.train_config, \
        samples_torpedo.object_config
    labels = [c.id for c in oc.configs]
    with tempfile.TemporaryDirectory() as directory:
        base = pathlib.Path(directory)
        roots = [base / f"dataset_{i}" for i in range(CLI_DATASETS)]

        def write(i):
            write_square_pose_dataset(roots[i], np.random.default_rng(20 + i), CLI_TRAIN,
                                      CLI_VAL, mc.in_h, mc.in_w, labels,
                                      min_side=CLI_SIDES[0], max_side=CLI_SIDES[1])

        with concurrent.futures.ThreadPoolExecutor(CLI_DATASETS) as pool:
            list(pool.map(write, range(CLI_DATASETS)))
        t_data = time.perf_counter() - t0
        # The loader's host work, one thread: decode, augment, collate.
        ds = PoseDataset(roots[0], Split.TRAIN, oc.label_id_to_index, oc,
                         train_centernet.build_train_transform(mc, tc))
        host_ms = loader_host_ms(ds, lambda b: collate_pose_samples(
            b, tc.max_objects, tc.max_keypoints), tc.batch_size)
        for name, epochs in (("cli_config", 2), ("cli_warm", 1)):
            (base / f"{name}.py").write_text(CLI_CONFIG.format(epochs=epochs))
        sys.path.insert(0, str(base))
        try:
            common = ["--dataset-roots", *map(str, roots), "--no-figures",
                      "--epoch-n-batches", str(CLI_BATCHES)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t2 = time.perf_counter()
            with train_epoch_times() as epochs:
                state = train_centernet.main(common + [
                    "--results-dir", str(base / "run"), "--config", "cli_config",
                    "--watch-every", str(CLI_WATCH_EVERY)])
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t2
            t3 = lap("train_cli data, loader and first run", t0)
            launches = (dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES),
                        dict(kernels.VARIANT_LAUNCHES))
            peak = torch.cuda.max_memory_allocated() / 2**30
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                warm = train_centernet.main(common + [
                    "--results-dir", str(base / "warm"), "--config", "cli_warm",
                    "--checkpoint", str(base / "run" / "checkpoints")])
                torch.cuda.synchronize()
            t3 = lap("train_cli profiled warm start", t3)
        finally:
            sys.path.remove(str(base))
            for name in ("cli_config", "cli_warm"):
                sys.modules.pop(name, None)

        def fresh_state():
            model = CenterpointDLA34(oc, deform=True, dcn_max_offset=DCN_WINDOW,
                                     dtype=torch.bfloat16, init="flax", device="cuda")
            return TrainState(model, adam_with_clip(model.parameters(), tc.lr,
                                                    tc.grad_max_norm))

        train, val, warm_train, watch, steps, trained = check_cli_runs(
            "train_cli", base, state, warm, CLI_BATCHES, CLI_WATCH_EVERY, fresh_state)
        lap("train_cli checks", t3)

    n_train = 2 * CLI_BATCHES
    n_val = 2 * (CLI_DATASETS * CLI_VAL // tc.batch_size)
    require(steps == [CLI_BATCHES, n_train], f"train_cli: checkpoints {steps}")
    forwards = n_train + n_val
    want = {"depthwise_upsample": 8 * forwards, "deform_conv": N_DCN * forwards}
    require({k: v for k, v in launches[0].items() if v} == want,
            f"train_cli: launches {launches[0]}, expected {want} (8 C and {N_DCN} E a forward)")
    print(f"train_cli: {CLI_DATASETS} dataset directories of {CLI_TRAIN} train and {CLI_VAL} "
          f"val {mc.in_w}x{mc.in_h} PNGs written in {t_data:.1f} s on {CLI_DATASETS} threads; "
          f"the CLI (samples_torpedo, "
          f"batch {tc.batch_size}, the bf16 DCN DLA-34 at full width with the "
          f"{DCN_WINDOW:g}-cell window) trained {n_train} steps over 2 epochs with "
          f"--epoch-n-batches {CLI_BATCHES} --watch-every {CLI_WATCH_EVERY} in {run_s:.1f} s: "
          f"losses {[round(r['train/total'], 4) for r in train]}, val "
          f"{[round(r['val/total'], 4) for r in val]}; {len(watch)} watch lines over "
          f"{len(trained)} parameters; launches {want} ({forwards} forwards: 8 C and {N_DCN} E "
          f"each); checkpoints {steps}; warm start from step {n_train}: losses "
          f"{[round(r['train/total'], 4) for r in warm_train]}, restored parameters and Adam "
          f"moments bit-equal to the saved ones")
    print_cli_time("train_cli", epochs, tc.batch_size, host_ms, tc.n_workers or 4, prof,
                   CLI_BATCHES, peak, card)
    print(f"train_cli phase {time.perf_counter() - t0:.1f} s")
    del state, warm
    torch.cuda.empty_cache()
    return launches


# ---- phase 8: train_yolact ----------------------------------------------

YL_BATCH = 24             # the YOLACT CLI's batch, at its 360x640
YL_SIDES = (24.0, 96.0)   # the squares' sides in pixels: anchors 24-384
YL_OVERFIT_STEPS = 60
YL_OVERFIT_BAR = 0.6      # tests/test_integration_train.py:207
YL_TIMED_STEPS = 3
YL_LOSS_RTOL = 1e-5       # card against CPU, each loss on the same predictions
YL_OHEM_TIES = 400        # negatives a sample given one classification row
YL_CLI_DATASETS = 4      # directories, written on as many threads
YL_CLI_TRAIN, YL_CLI_VAL = 24, 12   # samples of each: epochs of 4 batches, val 2
YL_CLI_WORKERS = 8
YL_CLI_WATCH_EVERY = 2


def yolact_train_setup():
    """(model and train configs of the CLI; numpy frames and truth of the
    synthetic squares at 360x640, batch 24)."""
    mc, tc = train_yolact.model_config, train_yolact.train_config
    img, fields = generate_square_seg_batch(np.random.default_rng(0), YL_BATCH, SquareDatasetConfig(
        in_h=mc.in_h, in_w=mc.in_w, max_objects=tc.max_objects, min_side=YL_SIDES[0],
        max_side=YL_SIDES[1]))
    return mc, tc, img, seg_truth(fields)


def yolact_model(mc, seed=0):
    """The YOLACT as the CLI trains it: bf16, the flax init from a seed."""
    return Yolact(mc, dtype=torch.bfloat16, init="flax",
                  generator=torch.Generator().manual_seed(seed), device="cuda")


def yolact_on_card(img, truth):
    return torch.from_numpy(img).cuda().permute(0, 3, 1, 2).contiguous(), truth.to("cuda")


def planted_yolact_ties(mc, tc):
    """(frames, truth) with IoU ties planted, and for each sample
    YL_OHEM_TIES of its negatives (on the CPU's match) that will share one
    classification row of low background confidence, more than OHEM
    takes, so that its cut falls inside the tie.  The frames hold up to 16
    squares of 24-96 px; 16 more truth slots take copies of level-0
    anchors, the first twice (an argmax tie across objects), painted into
    the seg map where it shows background: ~5 positives each, so that the
    cap of 64 binds in most samples, with equal IoUs across its cut in
    some."""
    n = tc.max_objects
    img, fields = generate_square_seg_batch(np.random.default_rng(1), YL_BATCH, SquareDatasetConfig(
        in_h=mc.in_h, in_w=mc.in_w, max_objects=n, min_side=YL_SIDES[0], max_side=YL_SIDES[1]))
    truth = seg_truth(fields)
    pad = ((0, 0), (0, n))
    truth = dataclasses.replace(truth, valid=np.pad(truth.valid, pad),
                                classification=np.pad(truth.classification, pad),
                                box=np.pad(truth.box, pad + ((0, 0),)))
    anchor = torch.from_numpy(get_all_anchors(mc.in_h, mc.in_w, mc.n_fpn_levels,
                                              mc.anchor_scales, mc.anchor_aspect_ratios))
    h0, w0 = fpn_level_sizes(mc.in_h, mc.in_w, mc.n_fpn_levels)[0]
    rng = np.random.default_rng(2)
    ys, xs = np.meshgrid(np.arange(mc.in_h), np.arange(mc.in_w), indexing="ij")
    for b in range(YL_BATCH):
        picks = rng.integers(h0 * w0, size=n)
        picks[1] = picks[0]
        truth.box[b, n:] = anchor[picks].numpy()
        truth.valid[b, n:] = True
        truth.classification[b, n:] = rng.integers(1, mc.n_classes + 1, n)
        for i, (cy, cx, h, w) in enumerate(truth.box[b, n:], start=n):
            inside = ((np.abs(ys - cy * mc.in_h) <= h * mc.in_h / 2)
                      & (np.abs(xs - cx * mc.in_w) <= w * mc.in_w / 2))
            truth.seg_map[b][inside & (truth.seg_map[b] == 255)] = i
    stub = YolactPrediction(classification=torch.zeros(YL_BATCH, len(anchor), mc.n_classes + 1),
                            box_encoding=None, mask_coeff=None, anchor=anchor,
                            mask_prototype=None)
    sets = match_anchors(stub, truth.to("cpu"), mc, tc)
    negative = sets.match_iou <= mc.iou_neg_threshold
    tied = [torch.from_numpy(rng.choice(torch.nonzero(negative[b])[:, 0].numpy(), YL_OHEM_TIES,
                                        replace=False)) for b in range(YL_BATCH)]
    return img, truth, tied


def plant_ohem_ties(prediction, tied, bg_logit=-4.0):
    """Every tied anchor of a sample gets one classification row: the
    background's logit ``bg_logit`` below the rest (hard negatives)."""
    cls = prediction.classification.clone()
    for b, anchors in enumerate(tied):
        row = torch.zeros(cls.shape[-1], device=cls.device)
        row[0] = bg_logit
        cls[b, anchors.to(cls.device)] = row
    return dataclasses.replace(prediction, classification=cls)


def check_yolact_loss_card_vs_cpu(mc, tc):
    """``yolact_loss`` on the card and on the CPU, on the same f32 prediction
    tensors (one bf16 training-mode forward of the net, ties planted):
    identical positive, OHEM-selected and top-64 anchor sets, each loss
    within YL_LOSS_RTOL relative, ``mask_clipped`` equal."""
    img_np, truth_np, tied = planted_yolact_ties(mc, tc)
    img, truth = yolact_on_card(img_np, truth_np)
    model = yolact_model(mc)
    with torch.no_grad(), model_mode(model, True):
        prediction = plant_ohem_ties(model(img), tied)
    del model
    cpu = dataclasses.replace(prediction, **{f.name: getattr(prediction, f.name).cpu()
                                             for f in dataclasses.fields(prediction)})
    t0 = time.perf_counter()
    card_sets = match_anchors(prediction, truth, mc, tc)
    card = yolact_loss(prediction, truth, mc, tc)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_sets = match_anchors(cpu, truth_np.to("cpu"), mc, tc)
    ref = yolact_loss(cpu, truth_np.to("cpu"), mc, tc)
    cpu_s = time.perf_counter() - t0
    for f in dataclasses.fields(card_sets):
        require(torch.equal(getattr(card_sets, f.name).cpu(), getattr(cpu_sets, f.name)),
                f"train_yolact loss: {f.name} differs between the card and the CPU")
    errs = {}
    for name in ("total", "classification", "box", "mask"):
        got, want = float(getattr(card, name)), float(getattr(ref, name))
        require(want > 0, f"train_yolact loss: {name} is {want!r}")
        errs[name] = abs(got - want) / want
        require(errs[name] <= YL_LOSS_RTOL, f"train_yolact loss: {name} {got!r} on the card, "
                                            f"{want!r} on the CPU")
    clipped = int(card.mask_clipped)
    require(clipped == int(ref.mask_clipped) and clipped > 0,
            f"train_yolact loss: mask_clipped {clipped} on the card, {int(ref.mask_clipped)} "
            f"on the CPU (the cap must bind)")
    # Ties that span the cuts: OHEM's (planted), the cap's and argmax's.
    bg = torch.softmax(cpu.classification, -1)[..., 0]
    ohem_ties = cap_ties = 0
    for b in range(YL_BATCH):
        neg = cpu_sets.match_iou[b] <= mc.iou_neg_threshold
        chosen, dropped = cpu_sets.selected[b] & neg, neg & ~cpu_sets.selected[b]
        ohem_ties += bool(set(bg[b][chosen].tolist()) & set(bg[b][dropped].tolist()))
        kept = torch.zeros_like(cpu_sets.positive[b])
        kept[cpu_sets.top_anchor[b][cpu_sets.top_valid[b]]] = True
        iou = cpu_sets.match_iou[b]
        cap_ties += bool(set(iou[kept].tolist()) & set(iou[cpu_sets.positive[b] & ~kept].tolist()))
    require(ohem_ties > 0 and cap_ties > 0,
            f"train_yolact loss: OHEM's cut falls in a tie in {ohem_ties} of {YL_BATCH} samples, "
            f"the cap's in {cap_ties}")
    n_pos = cpu_sets.positive.sum(1)
    print(f"train_yolact loss, card against CPU on one bf16 forward's f32 predictions at batch "
          f"{YL_BATCH} ({len(cpu.anchor)} anchors, ties planted): positive, OHEM-selected and "
          f"top-{tc.max_positive_anchors} sets identical ({int(n_pos.sum())} positives, "
          f"{int(n_pos.min())}-{int(n_pos.max())} a sample, {int(cpu_sets.selected.sum())} "
          f"selected); OHEM's cut inside a tie in {ohem_ties} samples, the cap's in {cap_ties}; "
          f"relative error {({k: float(f'{v:.3g}') for k, v in errs.items()})} (bar "
          f"{YL_LOSS_RTOL}); mask_clipped {clipped} on both; loss {card_s * 1e3:.1f} ms on the "
          f"card, {cpu_s * 1e3:.1f} ms on the CPU")
    del prediction, cpu, card_sets
    torch.cuda.empty_cache()


def yolact_zero_by_construction(sets, mc):
    """The FPN's extra levels are made by its downsample convs, level 3 by
    the first, level 4 by the second from level 3: a conv has no gradient
    when no anchor of its levels is trained (positive or OHEM's)."""
    sizes = fpn_level_sizes(mc.in_h, mc.in_w, mc.n_fpn_levels)
    starts = np.cumsum([0] + [h * w * mc.n_anchors_per_cell for h, w in sizes])
    trained = [bool(sets.selected[:, starts[i]:starts[i + 1]].any()) for i in range(len(sizes))]
    zero = set()
    for k in range(mc.n_fpn_downsample_layers):
        if not any(trained[3 + k:]):
            zero |= {f"_feature_pyramid._downsample_layers.{k}.{leaf}"
                     for leaf in ("weight", "bias")}
    return zero


def yolact_grads(mc, tc, img, truth):
    """One train step from the flax init, its clip never biting: every
    gradient finite, and non-zero but where no anchor of a level trains."""
    model = yolact_model(mc)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad(), model_mode(model, True):
        sets = match_anchors(model(img), truth, mc, tc)
    model.load_state_dict(start)   # that forward moved the running statistics
    state = TrainState(model, adam_with_clip(model.parameters(), tc.lr, float("inf")))
    _, losses = make_yolact_train_step(mc, tc)(state, img, truth)
    zero = yolact_zero_by_construction(sets, mc)
    for name, p in model.named_parameters():
        g = p.grad
        if name in zero:
            require(g is None or not g.any(), f"train_yolact: {name} has a gradient")
            continue
        require(g is not None and bool(torch.isfinite(g).all()) and bool(g.any()),
                f"train_yolact: {name}'s gradient is missing, not finite or zero")
    n = sum(1 for _ in model.parameters())
    print(f"train_yolact step: {n - len(zero)} of {n} gradients finite and non-zero, "
          f"{len(zero)} zero by construction {sorted(zero)}; losses "
          f"{ {k: round(float(v), 5) for k, v in dataclasses.asdict(losses).items()} }")
    del state, model
    torch.cuda.empty_cache()


def yolact_state(mc, tc, seed=0):
    model = yolact_model(mc, seed)
    return TrainState(model, adam_with_clip(model.parameters(), tc.lr, tc.grad_max_norm))


def train_yolact_phase(card):
    """Train the YOLACT on the card (see the module docstring); returns the
    phase's launch counts (by kernel, by entry point, by variant)."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    mc, tc, img_np, truth_np = yolact_train_setup()
    print(f"train_yolact data: {YL_BATCH} synthetic {mc.in_w}x{mc.in_h} frames, "
          f"{int(truth_np.valid.sum())} squares of {YL_SIDES[0]:g}-{YL_SIDES[1]:g} px "
          f"({time.perf_counter() - t0:.1f} s)")
    check_yolact_loss_card_vs_cpu(mc, tc)
    img, truth = yolact_on_card(img_np, truth_np)
    yolact_grads(mc, tc, img, truth)

    # The overfit, through Trainer on one batch, as the JAX integration
    # test's bar: 60 steps, the last loss below 0.6 of the first.
    state = yolact_state(mc, tc)
    totals = _Totals()
    trainer = Trainer(make_yolact_train_step(mc, tc), None, state,
                      TrainerConfig(n_epochs=1, epoch_n_batches=YL_OVERFIT_STEPS,
                                    overfit_single_batch=True),
                      writer=MultiWriter(totals))
    t1 = time.perf_counter()
    state = trainer.fit(lambda: itertools.repeat((img_np, truth_np), YL_OVERFIT_STEPS))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    t = totals.totals
    require(len(t) == YL_OVERFIT_STEPS and all(np.isfinite(t)), f"train_yolact: losses {t}")
    require(t[-1] < YL_OVERFIT_BAR * t[0], f"train_yolact: the overfit's last loss {t[-1]} is "
                                           f"not below {YL_OVERFIT_BAR} of its first {t[0]}")
    print(f"train_yolact overfit: {YL_OVERFIT_STEPS} bf16 steps at batch {YL_BATCH} through "
          f"Trainer, loss {t[0]:.6g} -> {t[-1]:.6g} ({t[-1] / t[0]:.3f} of the first; bar "
          f"{YL_OVERFIT_BAR}), {fit_s:.1f} s")

    # Checkpoint: the next loss after a restore into a fresh model and
    # optimizer equals the uninterrupted run's; then two steps from the
    # checkpoint, twice, bit for bit.
    step = make_yolact_train_step(mc, tc)
    with tempfile.TemporaryDirectory() as directory:
        manager = CheckpointManager(pathlib.Path(directory))
        manager.save(state.step, state, metrics={"loss": t[-1]})
        going = float(step(state, img, truth)[1].total)

        def restored():
            return manager.restore(yolact_state(mc, tc, seed=1))

        fresh = restored()
        resumed = float(step(fresh, img, truth)[1].total)
        require(fresh.step == YL_OVERFIT_STEPS + 1 and resumed == going,
                f"train_yolact checkpoint: next loss {resumed!r} against {going!r}")
        print(f"train_yolact checkpoint: restored step {YL_OVERFIT_STEPS} into a fresh model "
              f"and optimizer; the next loss {resumed!r} equals the uninterrupted run's")
        del fresh
        torch.cuda.empty_cache()
        runs = [two_steps(restored, step, img, truth) for _ in range(2)]
    (l1, g1), (l2, g2) = runs
    differ = sorted(n for n in g1 if not torch.equal(g1[n], g2[n]))
    print(f"train_yolact repeat: two steps from one checkpoint, twice: losses {l1} and {l2}, "
          f"bit-equal: step 1 {l1[0] == l2[0]}, step 2 {l1[1] == l2[1]}; {len(g1) - len(differ)} "
          f"of {len(g1)} gradients after step 1 bit-equal, differing: {differ}")
    require(l1 == l2 and not differ, "train_yolact repeat: two runs of two steps from one "
                                     f"checkpoint differ (gradients {differ})")
    time_yolact_step(state, img, truth, step, tc, card)
    del state, trainer
    torch.cuda.empty_cache()
    train_yolact_cli(card)
    launches = (dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES),
                dict(kernels.VARIANT_LAUNCHES))
    require(not any(launches[0].values()), f"train_yolact: port kernels launched "
                                           f"{launches[0]}; JAX's YOLACT training reaches none")
    print(f"train_yolact launches: {sum(launches[0].values())} port-kernel launches in the phase "
          f"(JAX's YOLACT training reaches no Pallas kernel)")
    print(f"train_yolact phase {time.perf_counter() - t0:.1f} s")
    return launches


def time_yolact_step(state, img, truth, step, tc, card):
    """``time_train_step`` at batch 24, with the step's ``mask_clipped``."""
    clipped = int(step(state, img, truth)[1].mask_clipped)
    time_train_step("train_yolact", state, img, truth, step, YL_TIMED_STEPS, card,
                    f"; mask_clipped {clipped} (cap {tc.max_positive_anchors})")


def time_train_step(label, state, img, truth, step, iters, card, note=""):
    """Images/s and peak memory of a bf16 train step with a loss range
    (CUDA events after warm-up), and its device split from
    ``torch.profiler``: the forward with the loss, the loss alone, the
    backward, the optimizer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = img.shape[0]
    step(state, img, truth)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(state, img, truth), iters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"time {label} step bf16 batch {batch}: {ms:.3f} ms a step = "
          f"{batch * 1000 / ms:.2f} images/s; peak memory allocated {peak:.2f} GiB{note} "
          f"({card})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, img, truth)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    ranges = (train_steps.FORWARD, train_steps.LOSS, train_steps.OPTIMIZER)
    kernel_rows = [e for e in rows if e.device_type == DeviceType.CUDA and e.key not in ranges]
    if not kernel_rows:
        print(f"time {label} split: not measured (the profiler recorded no device activity)")
        return

    def range_ms(name):
        return sum(e.device_time_total for e in rows
                   if e.device_type == DeviceType.CPU and e.key == name) / 1e3

    busy = sum(e.self_device_time_total for e in kernel_rows) / 1e3
    split = {"forward (with the loss)": range_ms(train_steps.FORWARD),
             "loss": range_ms(train_steps.LOSS), "optimizer": range_ms(train_steps.OPTIMIZER)}
    split["backward"] = busy - split["forward (with the loss)"] - split["optimizer"]
    print(f"time {label} split batch {batch} (torch.profiler, one step, device ms): "
          f"{ {k: round(v, 3) for k, v in split.items()} }, device busy {busy:.3f} of the step's "
          f"{ms:.3f} ms back to back ({card})")


@contextlib.contextmanager
def yolact_cli_config(**changes):
    """The YOLACT CLI's module-literal train config with ``changes`` inside
    the ``with`` (the CLI has no flag for them)."""
    saved = train_yolact.train_config
    train_yolact.train_config = dataclasses.replace(saved, **changes)
    try:
        yield train_yolact.train_config
    finally:
        train_yolact.train_config = saved


def train_yolact_cli(card):
    """The YOLACT CLI on PNG dataset directories at its full configuration:
    two epochs of 4 batches with watch lines, then a warm start."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    mc = train_yolact.model_config
    labels = [c.id for c in train_yolact.class_config.configs]
    class_map = {c.id: c.index for c in train_yolact.class_config.configs}
    with tempfile.TemporaryDirectory() as directory:
        base = pathlib.Path(directory)
        roots = [base / f"seg_{i}" for i in range(YL_CLI_DATASETS)]

        def write(i):
            write_square_seg_dataset(roots[i], np.random.default_rng(30 + i), YL_CLI_TRAIN,
                                     YL_CLI_VAL, mc.in_h, mc.in_w, labels, max_objects=8,
                                     min_side=YL_SIDES[0], max_side=YL_SIDES[1])

        with concurrent.futures.ThreadPoolExecutor(YL_CLI_DATASETS) as pool:
            list(pool.map(write, range(YL_CLI_DATASETS)))
        t_data = time.perf_counter() - t0
        tc = train_yolact.train_config
        ds = SegmentationDataset(roots[0], Split.TRAIN, class_map,
                                 train_yolact.build_train_transform(mc, tc))
        host_ms = loader_host_ms(ds, lambda b: collate_segmentation_samples(
            b, tc.max_objects), tc.batch_size)
        common = ["--dataset-roots", *map(str, roots), "--no-figures"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        with yolact_cli_config(n_epochs=2, n_workers=YL_CLI_WORKERS), \
                train_epoch_times() as epochs:
            state = train_yolact.main(common + [
                "--results-dir", str(base / "run"), "--watch-every", str(YL_CLI_WATCH_EVERY)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t2
        peak = torch.cuda.max_memory_allocated() / 2**30
        with yolact_cli_config(n_epochs=1, n_workers=YL_CLI_WORKERS), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            warm = train_yolact.main(common + ["--results-dir", str(base / "warm"),
                                               "--checkpoint", str(base / "run" / "checkpoints")])
            torch.cuda.synchronize()
        batches = YL_CLI_DATASETS * YL_CLI_TRAIN // tc.batch_size
        train, val, warm_train, watch, steps, trained = check_cli_runs(
            "train_yolact cli", base, state, warm, batches, YL_CLI_WATCH_EVERY,
            lambda: yolact_state(mc, tc, seed=1))
        manager = CheckpointManager(base / "run" / "checkpoints")
        manifest = {name: manager.load_config(name)
                    for name in ("model_config", "train_config", "class_config")}

    require(manifest["model_config"] == json.loads(json.dumps(mc.to_dict()))
            and manifest["class_config"] == train_yolact.class_config.to_dict()
            and manifest["train_config"]["batch_size"] == YL_BATCH,
            "train_yolact cli: the configuration manifest differs from the CLI's")
    print(f"train_yolact cli: {YL_CLI_DATASETS} dataset directories of {YL_CLI_TRAIN} train "
          f"and {YL_CLI_VAL} val {mc.in_w}x{mc.in_h} PNGs with seg maps (squares of the CLI's 7 "
          f"classes) written in {t_data:.1f} s on {YL_CLI_DATASETS} threads; the CLI (its "
          f"module-literal configs: bf16, batch {YL_BATCH}, cap {tc.max_positive_anchors}, "
          f"n_epochs 2, {YL_CLI_WORKERS} loader threads) trained {2 * batches} steps over 2 "
          f"epochs with --watch-every {YL_CLI_WATCH_EVERY} in {run_s:.1f} s: losses "
          f"{[round(r['train/total'], 4) for r in train]}, mask_clipped "
          f"{[int(r['train/mask_clipped']) for r in train]}, val "
          f"{[round(r['val/total'], 4) for r in val]}; {len(watch)} watch lines over "
          f"{len(trained)} parameters; checkpoints {steps} and the 3-config manifest; warm start "
          f"from step {2 * batches}: losses {[round(r['train/total'], 4) for r in warm_train]}, "
          f"restored parameters and Adam moments bit-equal to the saved ones")
    print_cli_time("train_yolact cli", epochs, YL_BATCH, host_ms, YL_CLI_WORKERS, prof, batches,
                   peak, card)
    print(f"train_yolact cli {time.perf_counter() - t0:.1f} s")
    del state, warm
    torch.cuda.empty_cache()


# ---- phase 9 ------------------------------------------------------------

YP_BATCH = 16             # bench.py --yolo-pose's batch
YP_REQUESTS = 2
YP_ITERS = 3              # timed requests of each kind
YP_SEED = 11
YP_POSE_ATOL = 1e-3       # PnP on the card against the CPU, same keypoints
YP_TIE = 1e-5             # a belief map's top two values this close: a near-tie


def yolo_pose_net():
    """``bench.py --yolo-pose``'s net on the card: bf16, the flax init from
    a seed."""
    serve = BENCH_YOLO_POSE
    return YoloPose(serve.model, torch.Generator().manual_seed(YP_SEED), device="cuda",
                    dtype=serve.dtype, init="flax").eval()


def yolo_pose_pipelines(net, knobs=YOLO_POSE_DECODE, pnp=True):
    """(the served pipeline on kernel B, on its plain version)."""
    serve = BENCH_YOLO_POSE
    points = (serve.object_points, serve.camera_matrix) if pnp else (None, None)
    return tuple(make_yolo_pose_pipeline(net, serve.model, *points, torch.device("cuda"),
                                         knobs=knobs, impl=impl, dtype=serve.input_dtype)
                 for impl in ("kernel", "plain"))


def yolo_pose_image(frames):
    serve = BENCH_YOLO_POSE
    with torch.inference_mode():
        return preprocess(frames.to("cuda"), (serve.model.in_h, serve.model.in_w),
                          IMAGENET_MEAN, IMAGENET_STDDEV, serve.input_dtype)


def yolo_pose_belief_call(pred, knobs=YOLO_POSE_DECODE):
    """The decode's kernel B call on a forward's outputs: the last Pointnet
    stage's prototypes [B, Pb, bh, bw] (from their NHWC view) and the
    coefficients [B, K * Kp, Pb] of Fast-NMS's picks."""
    with torch.inference_mode():
        coeff = select_detections(pred, BENCH_YOLO_POSE.model, knobs.top_k, knobs.iou_threshold,
                                  knobs.confidence_threshold)[3]
    return pred.belief_prototypes[-1].permute(0, 3, 1, 2), coeff


def check_yolo_pose_outputs(out, batch, pnp=True):
    cfg, k = BENCH_YOLO_POSE.model, YOLO_POSE_DECODE.top_k
    n_kp = cfg.belief_depth
    require(all(t.shape == (batch, k) for t in (out.valid, out.score, out.label))
            and out.box.shape == (batch, k, 4)
            and out.belief.shape == (batch, k, n_kp, cfg.in_h // 16, cfg.in_w // 16)
            and all(t.shape == (batch, k, n_kp) for t in
                    (out.keypoint_y, out.keypoint_x, out.keypoint_score)),
            "yolo_pose: detection shapes")
    require(all(t.is_cuda for t in (out.valid, out.belief, out.keypoint_x)),
            "yolo_pose: an output left the card")
    require(finite(out.score, out.box, out.belief, out.keypoint_y, out.keypoint_x,
                   out.keypoint_score), "yolo_pose: non-finite")
    require(bool(((out.label >= 1) & (out.label <= cfg.n_classes)).all()), "yolo_pose: labels")
    if pnp:
        require(out.pose_rotation.shape == (batch, k, 3, 3)
                and out.pose_translation.shape == (batch, k, 3)
                and not bool((out.pose_valid & ~out.valid).any()), "yolo_pose: pose shapes")
        valid = out.pose_valid
        require(finite(out.pose_rotation[valid], out.pose_translation[valid]),
                "yolo_pose: a valid pose is not finite")


def yolo_pose_near_ties(belief):
    """bool [...] of [..., h, w] maps: the top two values within YP_TIE."""
    top = belief.flatten(-2).topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]) <= YP_TIE


def compare_yolo_pose_decodes(got, ref, tag="yolo_pose"):
    """Kernel against plain decode of the same forward, slot for slot:
    detections equal, belief maps within MASK_ATOL, keypoints equal but on
    the plain maps' near-ties, and a slot whose keypoints all agree posed
    within POSE_ATOL.  Returns (belief err, near-ties, keypoints moved,
    worst pose err)."""
    for name in ("valid", "label", "box", "score"):
        require(torch.equal(getattr(got, name), getattr(ref, name)),
                f"{tag} kernel vs plain: {name} differs")
    err = (got.belief - ref.belief).abs().max().item()
    require(err <= MASK_ATOL, f"{tag} kernel vs plain: belief maps err {err}")
    tie = yolo_pose_near_ties(ref.belief)
    moved = (got.keypoint_y != ref.keypoint_y) | (got.keypoint_x != ref.keypoint_x)
    require(not bool((moved & ~tie).any()),
            f"{tag} kernel vs plain: {int((moved & ~tie).sum())} keypoints moved off a tie")
    same = ~moved.any(-1)
    require(torch.equal(got.pose_valid[same], ref.pose_valid[same]),
            f"{tag} kernel vs plain: pose_valid differs on equal keypoints")
    pose_err = max((getattr(got, n)[same] - getattr(ref, n)[same]).abs().max().item()
                   for n in ("pose_rotation", "pose_translation")) if bool(same.any()) else 0.0
    require(pose_err <= POSE_ATOL, f"{tag} kernel vs plain: pose err {pose_err}")
    return err, int(tie.sum()), int(moved.sum()), pose_err


def check_yolo_pose_pnp():
    """``attach_pnp`` on the card against planted poses and against the CPU
    on the same keypoints: a batch-16 request's 160 slots, the bench's
    object points seen by its camera, with 9, 5, 4 and 3 keypoints above
    the threshold (3 are too few) and every fifth slot not kept.  Random
    weights validate poses on random correspondences, so this is where a
    pose is held to the truth."""
    serve = BENCH_YOLO_POSE
    cfg, k, n_kp = serve.model, YOLO_POSE_DECODE.top_k, len(serve.object_points)
    n = YP_BATCH * k
    rng = np.random.default_rng(9)
    obj = np.asarray(serve.object_points, np.float64)
    cam = np.asarray(serve.camera_matrix, np.float64)
    with torch.inference_mode():
        r = so3_exp(torch.from_numpy(rng.normal(size=(n, 3)) * 0.4)).numpy()
    t = np.stack([rng.uniform(-0.2, 0.2, n), rng.uniform(-0.1, 0.1, n),
                  rng.uniform(1.0, 3.0, n)], -1)
    pts = np.einsum("nij,pj->npi", r, obj) + t[:, None]
    counts = np.resize([9, 5, 4, 3], n)
    keep = np.arange(n) % 5 != 4
    fields = {
        "keypoint_y": (cam[1, 1] * pts[..., 1] / pts[..., 2] + cam[1, 2]) / cfg.in_h,
        "keypoint_x": (cam[0, 0] * pts[..., 0] / pts[..., 2] + cam[0, 2]) / cfg.in_w,
        "keypoint_score": np.where(np.arange(n_kp)[None] < counts[:, None], 0.9, 0.1)}
    fields = {name: torch.from_numpy(a.astype(np.float32).reshape(YP_BATCH, k, n_kp))
              for name, a in fields.items()}
    fields["valid"] = torch.from_numpy(keep.reshape(YP_BATCH, k))
    rest = dict(score=torch.zeros(YP_BATCH, k), label=torch.ones(YP_BATCH, k, dtype=torch.int32),
                box=torch.zeros(YP_BATCH, k, 4), belief=torch.zeros(YP_BATCH, k, n_kp, 1, 1))
    out = {}
    for device in ("cuda", "cpu"):
        dets = YoloPoseDetections(**{name: v.to(device) for name, v in {**fields,
                                                                        **rest}.items()})
        with torch.inference_mode():
            out[device] = attach_pnp(dets, cfg, torch.tensor(serve.object_points, device=device),
                                     torch.tensor(serve.camera_matrix, device=device),
                                     YOLO_POSE_DECODE.keypoint_score_threshold)
    card, cpu = out["cuda"], out["cpu"]
    valid = card.pose_valid.cpu().numpy().reshape(-1)
    require(np.array_equal(valid, (counts >= 4) & keep),
            f"yolo_pose PnP: valid {valid.sum()} of {n}, expected {((counts >= 4) & keep).sum()}")
    require(torch.equal(card.pose_valid.cpu(), cpu.pose_valid), "yolo_pose PnP: card vs CPU valid")
    errs = {}
    for name, truth in (("pose_rotation", r), ("pose_translation", t)):
        got = getattr(card, name).cpu().reshape(n, -1).numpy()[valid]
        errs[name] = (np.abs(got - getattr(cpu, name).reshape(n, -1).numpy()[valid]).max(),
                      np.abs(got - truth.reshape(n, -1)[valid]).max())
    require(all(c <= YP_POSE_ATOL and e <= 1e-2 for c, e in errs.values()),
            f"yolo_pose PnP: (card vs CPU, card vs truth) errs {errs}")
    print(f"check yolo_pose PnP on the card: {n} slots, {int(valid.sum())} valid as expected "
          f"(min {MIN_KEYPOINTS} keypoints, kept); card vs CPU rotation "
          f"{errs['pose_rotation'][0]:.3g}, translation {errs['pose_translation'][0]:.3g} (atol "
          f"{YP_POSE_ATOL}); against the planted poses {errs['pose_rotation'][1]:.3g}, "
          f"{errs['pose_translation'][1]:.3g} (atol 1e-2)")


def yolo_pose_phase(card):
    """Serve ``bench.py --yolo-pose``'s bf16 rung (see the module
    docstring); returns (the served run's launches by kernel, by entry
    point, by variant; kernel B's error at the belief call; its timing
    row)."""
    t0 = time.perf_counter()
    serve = BENCH_YOLO_POSE
    cfg, knobs = serve.model, YOLO_POSE_DECODE
    net = yolo_pose_net()
    requests = [request_frames(12, (YP_REQUESTS, YP_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(YP_REQUESTS)]
    frame = request_frames(13, (1, FRAME_H, FRAME_W, 3)).pin_memory()

    # Kernel B at the decode's call, on the net's own prototypes and
    # coefficients: NCHW (as the net makes them) and the NHWC view, at
    # batch 16 and 1.
    with torch.inference_mode():
        pred = net(yolo_pose_image(requests[0]))
    proto, coeff = yolo_pose_belief_call(pred)
    require(tuple(proto.shape) == (YP_BATCH, 16, 30, 60) and proto.is_contiguous()
            and tuple(coeff.shape) == (YP_BATCH, 90, 16), f"yolo_pose: kernel B's call "
            f"{tuple(proto.shape)} {tuple(coeff.shape)}")
    b_err = 0.0
    for name, p, c in (("b16_nchw", proto, coeff),
                       ("b16_nhwc", proto.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
                        coeff),
                       ("b1_nchw", proto[:1].contiguous(), coeff[:1].contiguous()),
                       ("b1_nhwc", proto[:1].permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2),
                        coeff[:1].contiguous())):
        got, want = assemble_mask_cuda(p, c), assemble_mask_batch(p, c)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        require(e <= MASK_ATOL, f"mask_assembly yolo_pose {name}: err {e}")
        b_err = max(b_err, e)
        print(f"check mask_assembly yolo_pose_belief_{name} proto {tuple(p.shape)} strides "
              f"{p.stride()} K={c.shape[1]} no crop: max_abs_err {e:.3g} (atol {MASK_ATOL})")

    # The served requests, every launch counted.
    pipe, plain = yolo_pose_pipelines(net)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [pipe(r) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    per_request = {**{name: 0 for name in KERNELS}, "mask_assembly": 1}
    print(f"serve yolo_pose: {YP_REQUESTS} requests x {YP_BATCH} frames, launches {launches} "
          f"(kernel B by variant: {variants})")
    require(launches == {name: YP_REQUESTS * n for name, n in per_request.items()}
            and variants == {("mask_assembly", "no crop"): YP_REQUESTS},
            f"yolo_pose: launch counts {launches} {variants}")
    for out in answers:
        check_yolo_pose_outputs(out, YP_BATCH)
    print(f"serve yolo_pose: at the served thresholds "
          f"{sum(int(a.valid.sum()) for a in answers)} detections valid, "
          f"{sum(int(a.pose_valid.sum()) for a in answers)} poses valid (random weights)")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    one = pipe(frame)
    torch.cuda.synchronize()
    require(dict(kernels.LAUNCHES) == per_request,
            f"yolo_pose batch 1: launch counts {dict(kernels.LAUNCHES)}")
    check_yolo_pose_outputs(one, 1)
    print(f"serve yolo_pose batch 1: launches {dict(kernels.LAUNCHES)}")

    # Kernel against plain, every slot decoded (confidence 0), on each
    # request's one forward; then the two whole pipelines.
    all_slots = dataclasses.replace(knobs, confidence_threshold=0.0)
    pose_args = (cfg, torch.tensor(serve.object_points, device="cuda"),
                 torch.tensor(serve.camera_matrix, device="cuda"), knobs.keypoint_score_threshold)
    worst, n_slots = (0.0, 0, 0, 0.0), 0
    for r in requests + [frame]:
        with torch.inference_mode():
            pred = net(yolo_pose_image(r))
            got, ref = (attach_pnp(decode_yolo_pose(pred, cfg, all_slots.top_k,
                                                    all_slots.iou_threshold, 0.0, impl=impl),
                                   *pose_args) for impl in ("kernel", "plain"))
        e, ties, moved, pose_e = compare_yolo_pose_decodes(got, ref)
        worst = (max(worst[0], e), worst[1] + ties, worst[2] + moved, max(worst[3], pose_e))
        n_slots += got.valid.numel()
    pipe0, plain0 = yolo_pose_pipelines(net, all_slots)
    whole = [compare_yolo_pose_decodes(pipe0(r), plain0(r)) for r in requests]
    print(f"serve yolo_pose: decoded kernel vs plain at confidence 0 on one forward each, "
          f"{YP_REQUESTS} x {YP_BATCH} + 1 frames ({n_slots} slots): valid, labels, boxes and "
          f"scores equal, belief maps max_abs_err {worst[0]:.3g} (atol {MASK_ATOL}), "
          f"{worst[1]} of {n_slots * cfg.belief_depth} maps near-tied (top two within "
          f"{YP_TIE:g}), {worst[2]} keypoints moved (each on a near-tie), poses of "
          f"slots with equal keypoints max_abs_err {worst[3]:.3g} (atol {POSE_ATOL}); the "
          f"whole pipelines: {sum(w[2] for w in whole)} keypoints moved")
    check_yolo_pose_pnp()
    row = time_yolo_pose(net, proto, coeff, card)
    print(f"yolo_pose phase {time.perf_counter() - t0:.1f} s")
    del net, pred
    torch.cuda.empty_cache()
    return (launches, entries, variants), max(b_err, worst[0]), row


def time_yolo_pose(net, proto, coeff, card):
    """Kernel B at the belief call against its plain version (the kernels
    line's row), the request at batch 16 with and without PnP (kernels
    and plain), its device busy time and idle share, and its stages one
    by one."""
    serve = BENCH_YOLO_POSE
    cfg, knobs = serve.model, YOLO_POSE_DECODE
    k_ms, p_ms = abba(lambda: assemble_mask_cuda(proto, coeff),
                      lambda: assemble_mask_batch(proto, coeff), 50)
    d_ms = queued_ms(lambda: assemble_mask_cuda(proto, coeff), 50)
    n_out = coeff.shape[0] * coeff.shape[1] * proto.shape[2] * proto.shape[3]
    # the P-term dot and the sigmoid (4) an output
    b_ms, by = bound(nbytes(proto, coeff) + 4 * n_out, (2 * proto.shape[1] + 4) * n_out,
                     PEAK["f32"])
    timed = (f"proto {list(proto.shape)} K={coeff.shape[1]} (10 detections x 9 keypoints) "
             f"no crop, the yolo_pose decode's call")
    print(f"time mask_assembly_belief {timed}: kernel {k_ms:.4f} ms ({d_ms:.4f} ms on the "
          f"device), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), library none ({card})")
    row = {"ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": None, "timed": timed}

    frames = request_frames(14, (YP_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    for pnp in (True, False):
        pipe, plain = yolo_pose_pipelines(net, pnp=pnp)
        k_ms, p_ms = abba(lambda: pipe(frames), lambda: plain(frames), YP_ITERS)
        busy_ms, n_kernels = device_busy(lambda: pipe(frames), reps=1)
        idle = "not measured" if busy_ms is None else f"{1 - busy_ms / k_ms:.1%}"
        what = "with PnP" if pnp else "without PnP"
        print(f"time pipeline yolo_pose {what} batch {YP_BATCH} (upload + resize + bf16 "
              f"YOLO-Pose + decode + belief peaks{' + PnP' if pnp else ''}): kernels "
              f"{k_ms:.3f} ms = {YP_BATCH * 1000 / k_ms:.2f} frames/s, plain {p_ms:.3f} ms = "
              f"{YP_BATCH * 1000 / p_ms:.2f} frames/s; the kernels' request: {n_kernels} device "
              f"kernels and copies, busy {busy_ms} ms, the device idle {idle} of the request "
              f"({card})")
    pose_args = (cfg, torch.tensor(serve.object_points, device="cuda"),
                 torch.tensor(serve.camera_matrix, device="cuda"), knobs.keypoint_score_threshold)
    with torch.inference_mode():
        on_card = frames.to("cuda")
        img = yolo_pose_image(on_card)
        pred = net(img)
        dets = decode_yolo_pose(pred, cfg, knobs.top_k, knobs.iou_threshold,
                                knobs.confidence_threshold)
        stages = {
            "upload": lambda: frames.to("cuda", non_blocking=True),
            "resize + normalise (bf16)": lambda: yolo_pose_image(on_card),
            "forward": lambda: net(img),
            "NMS + belief peaks (kernel B)": lambda: decode_yolo_pose(
                pred, cfg, knobs.top_k, knobs.iou_threshold, knobs.confidence_threshold),
            "PnP": lambda: attach_pnp(dets, *pose_args),
        }
        for fn in stages.values():
            fn()
        stage_ms = {name: time_ms(fn, YP_ITERS) for name, fn in stages.items()}
        busy = {name: device_busy(fn, reps=1) for name, fn in stages.items()}
    print(f"time stages yolo_pose batch {YP_BATCH} (ms back to back; device kernels and copies "
          f"a call, ms busy): " + ", ".join(f"{name} {ms:.3f} ({busy[name][1]}, "
                                            f"{busy[name][0]})"
                                            for name, ms in stage_ms.items()) + f" ({card})")
    return row


# ---- phase 10 -----------------------------------------------------------

YP_INT8_ITERS = 2         # timed requests of each kind
YP_RUNGS = (YP_INT8, YP_PER_LAYER)
# The Pointnet's 7x7 convs at the bench's call (30x60 maps, 64 out): the
# stage-0 convs read 64 channels, stage 1's first (belief, affinity, FPN
# level 1) = 96; at batch 16 and 1.
POINTNET_7X7 = ((16, 64), (16, 96), (1, 64), (1, 96))


def yolo_pose_int8_forwards(net, scales):
    """{rung: fn(img) -> YoloPosePrediction}: the chain forward and the
    per-layer net (``quantized_call``), at the recipe's dtypes."""
    recipe = BENCH_YOLO_POSE.chain
    ctx = ChainCtx(net, scales, dtype=recipe.dtype, join_dtype=recipe.join_dtype,
                   path_of=yolo_pose_flax_path)
    return {YP_INT8: yolo_pose_chain_forward(ctx),
            YP_PER_LAYER: quantized_call(net, scales, paths_of=yolo_pose_flax_path)}, ctx


def yolo_pose_int8_pipelines(net, scales, knobs=YOLO_POSE_DECODE, pnp=True):
    """{rung: (the served pipeline on kernel B, on its plain version)}."""
    serve, device = BENCH_YOLO_POSE, torch.device("cuda")
    points = (serve.object_points, serve.camera_matrix) if pnp else (None, None)
    per_layer = quantized_call(net, scales, paths_of=yolo_pose_flax_path)
    return {
        YP_INT8: tuple(make_yolo_pose_chain_pipeline(net, scales, *points, device, knobs,
                                                     impl=impl) for impl in ("kernel", "plain")),
        YP_PER_LAYER: tuple(make_yolo_pose_pipeline(per_layer, serve.model, *points, device,
                                                    knobs, impl=impl, dtype=serve.input_dtype)
                            for impl in ("kernel", "plain")),
    }


def check_yolo_pose_int8_convs(ctx, forward, images):
    """The integer core at the YOLO-Pose chain's own calls (every distinct
    integer conv of a forward of each image batch) and at the Pointnet's
    7x7 convs on full-range random codes and on saturated ones (the
    largest accumulator, 127^2 49 96): im2col + ``torch._int_mm`` against
    the float64 conv, int32 for int32.  Returns the distinct shapes."""
    shapes = {}
    for img in images:
        with torch.inference_mode():
            record = chain_calls(ctx, forward, img)
        for q, qk, stride, padding in record["int8_conv"]:
            shapes.setdefault((tuple(q.shape), tuple(qk.shape), tuple(stride), padding),
                              (q, qk, stride, padding))
        del record
    gen = torch.Generator(device="cuda").manual_seed(16)
    cases = dict(shapes)
    for b, c in POINTNET_7X7:
        q = torch.randint(-127, 128, (b, 30, 60, c), generator=gen, device="cuda",
                          dtype=torch.int8)
        qk = torch.randint(-127, 128, (7, 7, c, 64), generator=gen, device="cuda",
                           dtype=torch.int8)
        cases[("random", b, c)] = (q, qk, (1, 1), 3)
    cases[("saturated", 1, 96)] = (torch.full((1, 30, 60, 96), 127, dtype=torch.int8,
                                              device="cuda"),
                                   torch.full((7, 7, 96, 64), 127, dtype=torch.int8,
                                              device="cuda"), (1, 1), 3)
    rows = set()
    for key, (q, qk, stride, padding) in cases.items():
        got = conv2d_int8_im2col(q, qk, stride, padding)
        want = conv2d_int8_f64(q, qk, stride, padding)
        torch.cuda.synchronize()
        require(got.dtype == want.dtype == torch.int32 and torch.equal(got, want),
                f"conv2d_int8 YOLO-Pose chain {key}: differs from float64")
        rows.add(got.shape[0] * got.shape[1] * got.shape[2])
    big = sorted({(k[0][0], k[0][3]) for k in shapes if k[1][:2] == (7, 7)})
    narrow = sorted({k[1][3] for k in shapes if k[1][3] % 8})
    small_rows = sorted(r for r in rows if r <= 64)
    print(f"check conv2d_int8 yolo_pose_int8: the chain's {len(shapes)} distinct integer convs "
          f"at batch {sorted({k[0][0] for k in shapes})} bit-equal to the float64 conv, int32 "
          f"(7x7 Pointnet convs at (batch, C) {big}, K up to {max(49 * c for _, c in big)}; "
          f"output widths {narrow} padded to 8; maps of <= 64 rows {small_rows}); and at the "
          f"7x7 shapes on random and saturated codes ({len(cases) - len(shapes)} cases)")
    require(big == sorted(POINTNET_7X7, key=lambda t: (t[0], t[1])) and narrow == [4, 22],
            f"yolo_pose_int8: the chain's 7x7 convs {big}, narrow widths {narrow}")
    return shapes


def decode_distance(got, ref):
    """(slots whose validity, label or box (beyond 1e-3) differ, keypoints
    that differ, the largest score difference, the largest belief-map
    difference) of two decodes of the same frames."""
    box_far = (got.box - ref.box).abs().amax(-1) > 1e-3
    slots = (got.valid != ref.valid) | (got.label != ref.label) | box_far
    keypoints = (got.keypoint_y != ref.keypoint_y) | (got.keypoint_x != ref.keypoint_x)
    return (int(slots.sum()), int(keypoints.sum()), (got.score - ref.score).abs().max().item(),
            (got.belief - ref.belief).abs().max().item())


def yolo_pose_int8_phase(card):
    """Serve ``bench.py --yolo-pose``'s two int8 rungs (see the module
    docstring); returns ({rung: the served run's launches by kernel, by
    entry point, by variant}, kernel B's error on their decodes)."""
    t0 = time.perf_counter()
    serve = BENCH_YOLO_POSE
    cfg, knobs, recipe = serve.model, YOLO_POSE_DECODE, serve.chain
    net = yolo_pose_net()
    cal = request_frames(15, (N_CALIBRATION, FRAME_H, FRAME_W, 3))
    scales = strip_scales(calibrate(net, [yolo_pose_image(cal)], per_channel=recipe.per_channel,
                                    paths_of=yolo_pose_flax_path), recipe.float_paths)
    # ResNet 19, FPN 8, protonet 4, Pointnet 24, head 9: every conv with 16
    # or more input channels but the stem's and the transposed convs'.
    require(len(scales) == 64 and not any("upsample" in p for p in scales),
            f"yolo_pose_int8: {len(scales)} calibrated convs")
    print(f"int8 yolo_pose: quantized_convs {len(scales)} (per-tensor scales of the bf16 net on "
          f"{N_CALIBRATION} frames, nothing stripped, f32 joins, bf16 transposes)")
    requests = [request_frames(12, (YP_REQUESTS, YP_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(YP_REQUESTS)]
    frame = request_frames(13, (1, FRAME_H, FRAME_W, 3)).pin_memory()
    forwards, ctx = yolo_pose_int8_forwards(net, scales)
    check_yolo_pose_int8_convs(ctx, forwards[YP_INT8],
                               [yolo_pose_image(requests[0]), yolo_pose_image(frame)])
    sections = {"calibrate + integer core": time.perf_counter() - t0}

    # The served requests of each rung, every launch counted.
    served = {}
    per_request = {**{name: 0 for name in KERNELS}, "mask_assembly": 1}
    pipes = yolo_pose_int8_pipelines(net, scales)
    for rung, (pipe, _) in pipes.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        answers = [pipe(r) for r in requests]
        torch.cuda.synchronize()
        served[rung] = (dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES),
                        dict(kernels.VARIANT_LAUNCHES))
        launches, _, variants = served[rung]
        print(f"serve {rung}: {YP_REQUESTS} requests x {YP_BATCH} frames, launches {launches} "
              f"(kernel B by variant: {variants})")
        require(launches == {name: YP_REQUESTS * n for name, n in per_request.items()}
                and variants == {("mask_assembly", "no crop"): YP_REQUESTS},
                f"{rung}: launch counts {launches} {variants}")
        for out in answers:
            check_yolo_pose_outputs(out, YP_BATCH)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        one = pipe(frame)
        torch.cuda.synchronize()
        require(dict(kernels.LAUNCHES) == per_request
                and kernels.VARIANT_LAUNCHES == {("mask_assembly", "no crop"): 1},
                f"{rung} batch 1: launch counts {dict(kernels.LAUNCHES)}")
        check_yolo_pose_outputs(one, 1)
        print(f"serve {rung}: at the served thresholds "
              f"{sum(int(a.valid.sum()) for a in answers)} detections valid, "
              f"{sum(int(a.pose_valid.sum()) for a in answers)} poses valid (random weights); "
              f"batch 1 launches {dict(kernels.LAUNCHES)}")

    sections["serve"] = time.perf_counter() - t0 - sum(sections.values())
    # Kernel against plain at confidence 0 on each request's one forward,
    # then the two whole pipelines; each rung's decode against the bf16
    # rung's on the same weights and frames, printed, not gated.
    all_slots = dataclasses.replace(knobs, confidence_threshold=0.0)
    pose_args = (cfg, torch.tensor(serve.object_points, device="cuda"),
                 torch.tensor(serve.camera_matrix, device="cuda"), knobs.keypoint_score_threshold)
    bf16_pipe, _ = yolo_pose_pipelines(net, all_slots)
    b_err = 0.0
    for rung, forward in forwards.items():
        worst, n_slots = (0.0, 0, 0, 0.0), 0
        for r in requests + [frame]:
            with torch.inference_mode():
                pred = forward(yolo_pose_image(r))
                got, ref = (attach_pnp(decode_yolo_pose(pred, cfg, all_slots.top_k,
                                                        all_slots.iou_threshold, 0.0,
                                                        impl=impl), *pose_args)
                            for impl in ("kernel", "plain"))
            e, ties, moved, pose_e = compare_yolo_pose_decodes(got, ref, rung)
            worst = (max(worst[0], e), worst[1] + ties, worst[2] + moved, max(worst[3], pose_e))
            n_slots += got.valid.numel()
        pipe0, plain0 = yolo_pose_int8_pipelines(net, scales, all_slots)[rung]
        answers = [pipe0(r) for r in requests]
        whole = [compare_yolo_pose_decodes(a, plain0(r), rung) for a, r in zip(answers, requests)]
        b_err = max(b_err, worst[0], *(w[0] for w in whole))
        print(f"serve {rung}: decoded kernel vs plain at confidence 0 on one forward each, "
              f"{YP_REQUESTS} x {YP_BATCH} + 1 frames ({n_slots} slots): valid, labels, boxes "
              f"and scores equal, belief maps max_abs_err {worst[0]:.3g} (atol {MASK_ATOL}), "
              f"{worst[1]} of {n_slots * cfg.belief_depth} maps near-tied (top two within "
              f"{YP_TIE:g}), {worst[2]} keypoints moved (each on a near-tie), poses of slots "
              f"with equal keypoints max_abs_err {worst[3]:.3g} (atol {POSE_ATOL}); the whole "
              f"pipelines: {sum(w[2] for w in whole)} keypoints moved")
        far = [decode_distance(a, bf16_pipe(r)) for a, r in zip(answers, requests)]
        print(f"report {rung} against the bf16 yolo_pose decode, same weights and frames, "
              f"confidence 0 ({YP_REQUESTS} x {YP_BATCH} frames, "
              f"{YP_REQUESTS * YP_BATCH * all_slots.top_k} slots, "
              f"{YP_REQUESTS * YP_BATCH * all_slots.top_k * cfg.belief_depth} keypoints; random "
              f"weights, not gated): slots differing {sum(f[0] for f in far)}, keypoints "
              f"differing {sum(f[1] for f in far)}, max score diff "
              f"{max(f[2] for f in far):.3g}, max belief-map diff {max(f[3] for f in far):.3g}")
    sections["kernel vs plain, against bf16"] = time.perf_counter() - t0 - sum(sections.values())
    time_yolo_pose_int8(net, scales, forwards, card)
    sections["time"] = time.perf_counter() - t0 - sum(sections.values())
    print(f"yolo_pose_int8 phase {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in sections.items()) + ")")
    del net, forwards, ctx, pipes
    torch.cuda.empty_cache()
    return served, b_err


def time_yolo_pose_int8(net, scales, forwards, card):
    """Each int8 rung's request at batch 16, with and without PnP, beside
    the bf16 rung's in the same run: frames/s, device kernels and copies
    a request, busy time and idle share; its stages one by one; and each
    int8 forward's device split from torch.profiler."""
    serve = BENCH_YOLO_POSE
    cfg, knobs = serve.model, YOLO_POSE_DECODE
    frames = request_frames(14, (YP_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    for pnp in (True, False):
        pipes = {"yolo_pose (bf16)": yolo_pose_pipelines(net, pnp=pnp)[0],
                 **{rung: p[0] for rung, p in yolo_pose_int8_pipelines(
                     net, scales, pnp=pnp).items()}}
        for pipe in pipes.values():
            pipe(frames)
            pipe(frames)
        ms = {name: time_ms(lambda: pipe(frames), YP_INT8_ITERS) for name, pipe in pipes.items()}
        what = "with PnP" if pnp else "without PnP"
        for name, pipe in pipes.items():
            # one profiled request: a request with PnP is ~9,000 events
            busy_ms, n_kernels = device_busy(lambda: pipe(frames), reps=1)
            idle = "not measured" if busy_ms is None else f"{1 - busy_ms / ms[name]:.1%}"
            print(f"time pipeline {name} {what} batch {YP_BATCH} (upload + resize + "
                  f"forward + decode + belief peaks{' + PnP' if pnp else ''}): {ms[name]:.3f} "
                  f"ms = {YP_BATCH * 1000 / ms[name]:.2f} frames/s; {n_kernels} device kernels "
                  f"and copies a request, kernel B launched once, busy {busy_ms} ms, the device "
                  f"idle {idle} of the request ({card})")
    pose_args = (cfg, torch.tensor(serve.object_points, device="cuda"),
                 torch.tensor(serve.camera_matrix, device="cuda"), knobs.keypoint_score_threshold)
    with torch.inference_mode():
        on_card = frames.to("cuda")
        img = yolo_pose_image(on_card)
        for rung, forward in forwards.items():
            pred = forward(img)
            dets = decode_yolo_pose(pred, cfg, knobs.top_k, knobs.iou_threshold,
                                    knobs.confidence_threshold)
            stages = {
                "upload": lambda: frames.to("cuda", non_blocking=True),
                "resize + normalise (bf16)": lambda: yolo_pose_image(on_card),
                "forward": lambda: forward(img),
                "NMS + belief peaks (kernel B)": lambda: decode_yolo_pose(
                    pred, cfg, knobs.top_k, knobs.iou_threshold, knobs.confidence_threshold),
                "PnP": lambda: attach_pnp(dets, *pose_args),
            }
            for fn in stages.values():
                fn()
            stage_ms = {name: time_ms(fn, YP_INT8_ITERS) for name, fn in stages.items()}
            busy = {name: device_busy(fn, reps=1) for name, fn in stages.items()}
            print(f"time stages {rung} batch {YP_BATCH} (ms back to back; device kernels and "
                  f"copies a call, ms busy): " + ", ".join(
                      f"{name} {ms:.3f} ({busy[name][1]}, {busy[name][0]})"
                      for name, ms in stage_ms.items()) + f" ({card})")
            split, _ = chain_split(forward, img)
            if split is None:
                print(f"time split {rung} forward: not measured (the profiler recorded no "
                      f"device activity)")
                continue
            wall = stage_ms["forward"]
            print(f"time split {rung} forward batch {YP_BATCH} (device ms from torch.profiler, 3 "
                  f"forwards): {split}; im2col {split['im2col'] / split['busy']:.1%} of device "
                  f"time, _int_mm {split['int_mm'] / split['busy']:.1%}, cuDNN "
                  f"{split['cudnn_conv'] / split['busy']:.1%}, the rest (epilogues, quantize, "
                  f"BatchNorms, joins, pools, casts) {split['other'] / split['busy']:.1%}; busy "
                  f"{split['busy']:.3f} of {wall:.3f} ms back to back, the device idle "
                  f"{1 - split['busy'] / wall:.1%} ({card})")


# ---- phase 11: train_yolo_pose ----------------------------------------------

YP_TRAIN_BATCH = 4        # the YOLO-Pose CLI's --batch-size
YP_TRAIN_BATCHES = (YP_TRAIN_BATCH, 16)   # timed: the recipe's, and bench.py --yolo-pose's
YP_TRAIN_LR = 1e-4        # the CLI's --lr
# The recipe warms the learning rate up over 10 epochs of 200 batches: a
# short run would hardly move, so the phase's own steps warm up over 5.
YP_WARMUP = 5
YP_OVERFIT_STEPS = 60
YP_OVERFIT_BAR = 0.6      # tests/test_integration_train.py:207, as train_yolact's
YP_TRAIN_TIMED = 3
YP_LOSS_RTOL = 1e-5       # card against CPU, each loss on the same predictions
YP_OHEM_TIES = 400        # negatives a sample given one classification row
# Their background logit: below any of the random net's 21-class rows, so
# that OHEM's 3 x n_pos hardest negatives all come from the tie.
YP_TIED_BG_LOGIT = -30.0
YP_COPIES = 20            # truth slots added to a sample, copies of level-0 anchors
YP_CLI_FRAMES = 24        # frames in each of the CLI's two environments
YP_CLI_ENVIRONMENTS = (FallingThingsEnvironment.Kitchen0, FallingThingsEnvironment.Temple3)
YP_CLI_BATCHES = 4        # --epoch-n-batches
YP_CLI_WATCH_EVERY = 2
YP_CLI_WORKERS = 4        # the CLI's BatchLoader threads


def fat_batches(root, seed, n):
    """(reader, numpy (img, truth) of its first ``n`` frames collated at the
    CLI's 960x480) over ``write_square_fat_dataset``'s frames at Falling
    Things' 960x540, 1-3 cubes each, written to ``root``."""
    mc = train_yolo_pose.model_config
    write_square_fat_dataset(root, np.random.default_rng(seed), n, *FAT_SIZE, max_objects=3)
    ds = FallingThingsDataset(root, FallingThingsVariant.SINGLE, list(FallingThingsEnvironment),
                              objects=[FallingThingsObject.MustardBottle])
    return ds, train_yolo_pose.collate_fat([ds[i] for i in range(n)], mc.in_h, mc.in_w)


def yolo_pose_train_model(seed=0):
    """The YOLO-Pose as the CLI trains it: bf16, the flax init from a
    seed."""
    return YoloPose(train_yolo_pose.model_config, torch.Generator().manual_seed(seed),
                    device="cuda", dtype=torch.bfloat16, init="flax")


def yolo_pose_train_state(seed=0):
    model = yolo_pose_train_model(seed)
    return TrainState(model, warmup_adam(model.parameters(), YP_TRAIN_LR, YP_WARMUP, 1.0))


def to_card(img, truth):
    return torch.from_numpy(img).cuda().permute(0, 3, 1, 2).contiguous(), truth.to("cuda")


def pose_prediction_on(prediction, device):
    def move(v):
        return tuple(t.to(device) for t in v) if isinstance(v, tuple) else v.to(device)

    return dataclasses.replace(prediction, **{f.name: move(getattr(prediction, f.name))
                                              for f in dataclasses.fields(prediction)})


def plant_yolo_pose_ties(img, truth):
    """(truth with IoU ties planted, YP_OHEM_TIES negatives a sample to tie
    in OHEM): YP_COPIES slots added after the collated ones take copies of
    level-0 anchors (the first twice: an argmax tie across objects),
    painted into the seg map where it shows background, with keypoints at
    the box's centre and its corners: more anchors of an IoU of 1 (or
    equal ones) than the cap of 16 keeps."""
    mc = train_yolo_pose.model_config
    slots = truth.valid.shape[1]

    def pad(a):
        return np.pad(a, [(0, 0), (0, YP_COPIES)] + [(0, 0)] * (a.ndim - 2))

    truth = dataclasses.replace(truth, **{f.name: pad(getattr(truth, f.name))
                                          for f in dataclasses.fields(truth)
                                          if f.name != "seg_map"},
                                seg_map=truth.seg_map.copy())
    anchor = get_all_anchors(mc.in_h, mc.in_w, mc.n_fpn_levels, mc.anchor_scales,
                             mc.anchor_aspect_ratios)
    h0, w0 = fpn_level_sizes(mc.in_h, mc.in_w, mc.n_fpn_levels)[0]
    rng = np.random.default_rng(2)
    ys, xs = np.meshgrid(np.arange(mc.in_h), np.arange(mc.in_w), indexing="ij")
    corners = np.asarray([(0, 0)] + [(y, x) for y in (-0.5, 0.5) for x in (-0.5, 0.5)] * 2,
                         np.float32)
    for b in range(len(img)):
        picks = rng.choice(h0 * w0, size=YP_COPIES, replace=False)
        picks[1] = picks[0]
        for slot, j in enumerate(picks, start=slots):
            cy, cx, h, w = anchor[j]
            truth.box[b, slot] = anchor[j]
            truth.valid[b, slot] = True
            truth.classification[b, slot] = truth.classification[b, 0]
            inside = ((np.abs(ys - cy * mc.in_h) <= h * mc.in_h / 2)
                      & (np.abs(xs - cx * mc.in_w) <= w * mc.in_w / 2))
            truth.seg_map[b][inside & (truth.seg_map[b] == 255)] = slot
            scale = np.asarray([mc.in_h, mc.in_w], np.float32)
            truth.keypoints[b, slot] = (np.asarray([cy, cx]) + corners * np.asarray([h, w])) * scale
            truth.keypoint_valid[b, slot] = True
            truth.centers[b, slot] = truth.keypoints[b, slot, 0]
    stub = YoloPosePrediction(
        classification=torch.zeros(len(img), len(anchor), mc.n_classes + 1), box_encoding=None,
        mask_coeff=None, belief_coeff=None, affinity_coeff=None,
        anchor=torch.from_numpy(anchor), mask_prototype=None, belief_prototypes=None,
        affinity_prototypes=None)
    sets = match_anchor_sets(stub, truth.to("cpu"), mc, 16)
    negative = sets.match_iou <= mc.iou_neg_threshold
    tied = [torch.from_numpy(rng.choice(torch.nonzero(negative[b])[:, 0].numpy(), YP_OHEM_TIES,
                                        replace=False)) for b in range(len(img))]
    return truth, tied


def check_yolo_pose_loss_card_vs_cpu(img_np, truth_np):
    """``yolo_pose_loss`` on the card and on the CPU on the same f32
    predictions (one bf16 training-mode forward of the net, ties planted):
    identical positive, OHEM-selected and capped anchor sets, each loss
    within YP_LOSS_RTOL relative."""
    mc = train_yolo_pose.model_config
    truth_np, tied = plant_yolo_pose_ties(img_np, truth_np)
    img, truth = to_card(img_np, truth_np)
    model = yolo_pose_train_model()
    with torch.no_grad(), model_mode(model, True):
        prediction = plant_ohem_ties(model(img), tied, YP_TIED_BG_LOGIT)
    del model
    cpu = pose_prediction_on(prediction, "cpu")
    t0 = time.perf_counter()
    card_sets = match_anchor_sets(prediction, truth, mc, 16)
    card = yolo_pose_loss(prediction, truth, mc)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_sets = match_anchor_sets(cpu, truth_np.to("cpu"), mc, 16)
    ref = yolo_pose_loss(cpu, truth_np.to("cpu"), mc)
    cpu_s = time.perf_counter() - t0
    for f in dataclasses.fields(card_sets):
        require(torch.equal(getattr(card_sets, f.name).cpu(), getattr(cpu_sets, f.name)),
                f"train_yolo_pose loss: {f.name} differs between the card and the CPU")
    errs = {}
    for f in dataclasses.fields(ref):
        got, want = float(getattr(card, f.name)), float(getattr(ref, f.name))
        require(want > 0, f"train_yolo_pose loss: {f.name} is {want!r}")
        errs[f.name] = abs(got - want) / want
        require(errs[f.name] <= YP_LOSS_RTOL, f"train_yolo_pose loss: {f.name} {got!r} on the "
                                               f"card, {want!r} on the CPU")
    bg = torch.softmax(cpu.classification, -1)[..., 0]
    ohem_ties = cap_ties = 0
    for b in range(len(img_np)):
        neg = cpu_sets.match_iou[b] <= mc.iou_neg_threshold
        chosen, dropped = cpu_sets.selected[b] & neg, neg & ~cpu_sets.selected[b]
        ohem_ties += bool(set(bg[b][chosen].tolist()) & set(bg[b][dropped].tolist()))
        kept = torch.zeros_like(cpu_sets.positive[b])
        kept[cpu_sets.top_anchor[b][cpu_sets.top_valid[b]]] = True
        iou = cpu_sets.match_iou[b]
        cap_ties += bool(set(iou[kept].tolist()) & set(iou[cpu_sets.positive[b] & ~kept].tolist()))
    n_pos = cpu_sets.positive.sum(1)
    require(ohem_ties > 0 and cap_ties > 0 and int(n_pos.max()) > 16,
            f"train_yolo_pose loss: OHEM's cut falls in a tie in {ohem_ties} of {len(img_np)} "
            f"samples, the cap's in {cap_ties}; at most {int(n_pos.max())} positives a sample")
    print(f"train_yolo_pose loss, card against CPU on one bf16 forward's f32 predictions at batch "
          f"{len(img_np)} ({len(cpu.anchor)} anchors, ties planted): positive, OHEM-selected and "
          f"top-16 sets identical ({int(n_pos.sum())} positives, {int(n_pos.min())}-"
          f"{int(n_pos.max())} a sample, {int(cpu_sets.selected.sum())} selected); OHEM's cut "
          f"inside a tie in {ohem_ties} samples, the cap's in {cap_ties}; relative error "
          f"{ {k: float(f'{v:.3g}') for k, v in errs.items()} } (bar {YP_LOSS_RTOL}); loss "
          f"{card_s * 1e3:.1f} ms on the card, {cpu_s * 1e3:.1f} ms on the CPU")
    del prediction, cpu, card_sets
    torch.cuda.empty_cache()


def yolo_pose_zero_by_construction(sets):
    """FPN level 3 is the first downsample conv of level 2's output, level
    4 the second's of level 3: the downsample conv k has no gradient when
    no anchor from level 3 + k on is trained (positive or OHEM's), level
    2's output conv none when no anchor from level 2 on is."""
    mc = train_yolo_pose.model_config
    sizes = fpn_level_sizes(mc.in_h, mc.in_w, mc.n_fpn_levels)
    starts = np.cumsum([0] + [h * w * mc.n_anchors_per_cell for h, w in sizes])
    trained = [bool(sets.selected[:, starts[i]:starts[i + 1]].any()) for i in range(len(sizes))]
    zero = set()
    if not any(trained[2:]):
        zero |= {f"fpn._prediction_layers.2.{leaf}" for leaf in ("weight", "bias")}
    for k in range(mc.n_fpn_downsample_layers):
        if not any(trained[3 + k:]):
            zero |= {f"fpn._downsample_layers.{k}.{leaf}" for leaf in ("weight", "bias")}
    return zero


def yolo_pose_grads(img, truth):
    """One train step from the flax init: every gradient finite, and
    non-zero but where no anchor of a level trains."""
    mc = train_yolo_pose.model_config
    state = yolo_pose_train_state()
    model = state.model
    start = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad(), model_mode(model, True):
        sets = match_anchor_sets(model(img), truth, mc, 16)
    model.load_state_dict(start)   # that forward moved the running statistics
    _, losses = make_yolo_pose_train_step(mc)(state, img, truth)
    zero = yolo_pose_zero_by_construction(sets)
    for name, p in model.named_parameters():
        g = p.grad
        if name in zero:
            require(g is None or not g.any(), f"train_yolo_pose: {name} has a gradient")
            continue
        require(g is not None and bool(torch.isfinite(g).all()) and bool(g.any()),
                f"train_yolo_pose: {name}'s gradient is missing, not finite or zero")
    n = sum(1 for _ in model.parameters())
    print(f"train_yolo_pose step: {n - len(zero)} of {n} gradients finite and non-zero, "
          f"{len(zero)} zero by construction {sorted(zero)}; losses "
          f"{ {k: round(float(v), 5) for k, v in dataclasses.asdict(losses).items()} }")
    del state, model
    torch.cuda.empty_cache()


def train_yolo_pose_phase(card):
    """Train YOLO-Pose on the card (see the module docstring); returns the
    phase's launch counts (by kernel, by entry point, by variant)."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    mc = train_yolo_pose.model_config
    with tempfile.TemporaryDirectory() as directory:
        _, (img16_np, truth16_np) = fat_batches(pathlib.Path(directory), 40, 16)
    img_np, truth_np = img16_np[:YP_TRAIN_BATCH], dataclasses.replace(truth16_np, **{
        f.name: getattr(truth16_np, f.name)[:YP_TRAIN_BATCH]
        for f in dataclasses.fields(truth16_np)})
    print(f"train_yolo_pose data: 16 synthetic Falling Things frames at {FAT_SIZE[1]}x"
          f"{FAT_SIZE[0]} collated at {mc.in_w}x{mc.in_h}, {int(truth16_np.valid.sum())} cubes "
          f"({time.perf_counter() - t0:.1f} s)")
    check_yolo_pose_loss_card_vs_cpu(img_np, truth_np)
    img, truth = to_card(img_np, truth_np)
    yolo_pose_grads(img, truth)

    state = yolo_pose_train_state()
    step = make_yolo_pose_train_step(mc)
    totals = _Totals()
    trainer = Trainer(step, None, state,
                      TrainerConfig(n_epochs=1, epoch_n_batches=YP_OVERFIT_STEPS,
                                    overfit_single_batch=True),
                      writer=MultiWriter(totals))
    t1 = time.perf_counter()
    state = trainer.fit(lambda: itertools.repeat((img_np, truth_np), YP_OVERFIT_STEPS))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t1
    t = totals.totals
    require(len(t) == YP_OVERFIT_STEPS and all(np.isfinite(t)), f"train_yolo_pose: losses {t}")
    require(t[-1] < YP_OVERFIT_BAR * t[0], f"train_yolo_pose: the overfit's last loss {t[-1]} "
                                           f"is not below {YP_OVERFIT_BAR} of its first {t[0]}")
    print(f"train_yolo_pose overfit: {YP_OVERFIT_STEPS} bf16 steps at batch {YP_TRAIN_BATCH} "
          f"through Trainer (lr {YP_TRAIN_LR}, warm-up {YP_WARMUP} steps), loss {t[0]:.6g} -> "
          f"{t[-1]:.6g} ({t[-1] / t[0]:.3f} of the first; bar {YP_OVERFIT_BAR}), {fit_s:.1f} s")

    # Checkpoint: the parameters, Adam moments and warm-up count restore
    # equal into a fresh model and optimizer, and the next loss equals the
    # uninterrupted run's; then two steps from the checkpoint, twice.
    with tempfile.TemporaryDirectory() as directory:
        manager = CheckpointManager(pathlib.Path(directory))
        manager.save(state.step, state, metrics={"loss": t[-1]})
        saved = torch.load(pathlib.Path(directory) / str(state.step) / "state.pt",
                           map_location="cuda", weights_only=True)
        going = float(step(state, img, truth)[1].total)

        def restored():
            return manager.restore(yolo_pose_train_state(seed=1))

        fresh = restored()
        moments = fresh.optimizer.state_dict()
        require(all(torch.equal(v, saved["model"][k]) for k, v in fresh.model.state_dict().items())
                and all(torch.equal(moments["state"][i][k], s[k])
                        for i, s in saved["optimizer"]["state"].items() for k in ("mu", "nu"))
                and moments["param_groups"][0]["count"] == YP_OVERFIT_STEPS,
                "train_yolo_pose checkpoint: the restore differs from the saved state")
        resumed = float(step(fresh, img, truth)[1].total)
        require(fresh.step == YP_OVERFIT_STEPS + 1 and resumed == going,
                f"train_yolo_pose checkpoint: next loss {resumed!r} against {going!r}")
        print(f"train_yolo_pose checkpoint: restored step {YP_OVERFIT_STEPS} into a fresh model "
              f"and optimizer, parameters, Adam moments and warm-up count "
              f"{YP_OVERFIT_STEPS} equal to the saved ones; the next loss {resumed!r} equals the "
              f"uninterrupted run's")
        del fresh, saved
        torch.cuda.empty_cache()
        runs = [two_steps(restored, step, img, truth) for _ in range(2)]
    (l1, g1), (l2, g2) = runs
    differ = sorted(n for n in g1 if not torch.equal(g1[n], g2[n]))
    print(f"train_yolo_pose repeat: two steps from one checkpoint, twice: losses {l1} and {l2}, "
          f"bit-equal: step 1 {l1[0] == l2[0]}, step 2 {l1[1] == l2[1]}; {len(g1) - len(differ)} "
          f"of {len(g1)} gradients after step 1 bit-equal, differing: {differ}")
    require(l1 == l2 and not differ, "train_yolo_pose repeat: two runs of two steps from one "
                                     f"checkpoint differ (gradients {differ})")
    time_train_step("train_yolo_pose", state, img, truth, step, YP_TRAIN_TIMED, card)
    img16, truth16 = to_card(img16_np, truth16_np)
    time_train_step("train_yolo_pose", state, img16, truth16, step, YP_TRAIN_TIMED, card)
    del state, trainer, img16, truth16
    torch.cuda.empty_cache()
    train_yolo_pose_cli(card)
    launches = (dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES),
                dict(kernels.VARIANT_LAUNCHES))
    require(not any(launches[0].values()), f"train_yolo_pose: port kernels launched "
                                           f"{launches[0]}; JAX's YOLO-Pose training reaches none")
    print(f"train_yolo_pose launches: {sum(launches[0].values())} port-kernel launches in the "
          f"phase (JAX's YOLO-Pose training reaches no Pallas kernel)")
    print(f"train_yolo_pose phase {time.perf_counter() - t0:.1f} s")
    return launches


def train_yolo_pose_cli(card):
    """The YOLO-Pose CLI on a Falling Things tree of two environments at its
    full configuration: two epochs of YP_CLI_BATCHES batches with watch
    lines, then one profiled epoch in a second run."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    mc = train_yolo_pose.model_config
    with tempfile.TemporaryDirectory() as directory:
        base = pathlib.Path(directory)
        write_square_fat_dataset(base / "fat", np.random.default_rng(50), YP_CLI_FRAMES,
                                 *FAT_SIZE, environments=YP_CLI_ENVIRONMENTS, max_objects=3)
        t_data = time.perf_counter() - t0
        ds = FallingThingsDataset(base / "fat", FallingThingsVariant.SINGLE,
                                  list(FallingThingsEnvironment),
                                  objects=[FallingThingsObject.MustardBottle])
        host_ms = loader_host_ms(ds, lambda b: train_yolo_pose.collate_fat(b, mc.in_h, mc.in_w),
                                 YP_TRAIN_BATCH)
        common = ["--fat-root", str(base / "fat"), "--epoch-n-batches", str(YP_CLI_BATCHES),
                  "--warmup-epochs", "1", "--no-figures"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        with train_epoch_times() as epochs:
            state = train_yolo_pose.main(common + [
                "--results-dir", str(base / "run"), "--n-epochs", "2",
                "--watch-every", str(YP_CLI_WATCH_EVERY)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t2
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            train_yolo_pose.main(common + ["--results-dir", str(base / "again"),
                                           "--n-epochs", "1"])
            torch.cuda.synchronize()
        records = cli_records(base / "run")
        manager = CheckpointManager(base / "run" / "checkpoints")
        steps, manifest = manager.all_steps(), manager.load_config("model_config")
    n_train = 2 * YP_CLI_BATCHES
    train = [r for r in records if "train/total" in r]
    watch = [r for r in records if "watch/global_grad_norm" in r]
    require(len(train) == n_train and state.step == n_train
            and all(math.isfinite(v) for r in train for k, v in r.items()
                    if k.startswith("train/")),
            f"train_yolo_pose cli: {len(train)} train records, step {state.step}")
    trained = {n.replace(".", "/") for n, p in state.model.named_parameters()
               if p.grad is not None}
    require([r["step"] for r in watch] == list(range(0, n_train, YP_CLI_WATCH_EVERY)) and all(
        {k[len("watch/"):-len("/grad_norm")] for k in r if k.endswith("/grad_norm")} == trained
        for r in watch), "train_yolo_pose cli: the watch lines do not cover every trained "
                         "parameter")
    require(steps == [YP_CLI_BATCHES] and manifest == json.loads(json.dumps(mc.to_dict())),
            f"train_yolo_pose cli: checkpoints {steps}, or the model_config manifest differs "
            f"from the CLI's")
    print(f"train_yolo_pose cli: a Falling Things tree of {len(YP_CLI_ENVIRONMENTS)} "
          f"environments x {YP_CLI_FRAMES} {FAT_SIZE[1]}x{FAT_SIZE[0]} frames of 1-3 cubes "
          f"written in {t_data:.1f} s; the CLI (its module-literal config: bf16, batch "
          f"{YP_TRAIN_BATCH}, {YP_CLI_WORKERS} loader threads, --warmup-epochs 1) trained "
          f"{n_train} steps over 2 epochs with --watch-every {YP_CLI_WATCH_EVERY} in {run_s:.1f} "
          f"s: losses {[round(r['train/total'], 4) for r in train]}; {len(watch)} watch lines "
          f"over {len(trained)} parameters; checkpoint {steps} (every 5 epochs) and "
          f"model_config.json")
    print_cli_time("train_yolo_pose cli", epochs, YP_TRAIN_BATCH, host_ms, YP_CLI_WORKERS, prof,
                   YP_CLI_BATCHES, peak, card, profiled="second run's")
    print(f"train_yolo_pose cli {time.perf_counter() - t0:.1f} s")
    del state
    torch.cuda.empty_cache()


# The north_star CenterNet's early trunk at batch 32, each conv alone in
# cuDNN: (name, C_in, C_out, kernel, stride, input H, W, dtype).
EARLY_CONVS = (
    ("stem 7x7 3->16", 3, 16, 7, 1, 360, 640, torch.float32),
    ("level0 3x3 16->16", 16, 16, 3, 1, 360, 640, torch.bfloat16),
    ("level1 3x3 16->32 s2", 16, 32, 3, 2, 360, 640, torch.bfloat16),
    # not a DLA-34 layer (its level1 has one conv): the 32-channel case
    ("3x3 32->32 at 180x320", 32, 32, 3, 1, 180, 320, torch.bfloat16),
)


def early_convs(cn_cfg, card):
    """{name: (cuDNN ms, multiply-adds, bytes in and out, C_in, C_out, k)}
    of EARLY_CONVS at batch FPS_BATCH."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for name, cin, cout, k, stride, h, w, dtype in EARLY_CONVS:
        x = torch.randn((FPS_BATCH, cin, h, w), generator=gen, device="cuda").to(dtype)
        wt = torch.randn((cout, cin, k, k), generator=gen, device="cuda").to(dtype)
        fn = lambda: F.conv2d(x, wt, stride=stride, padding=k // 2)  # noqa: E731
        y = fn()
        ms = time_ms(fn, 10)
        macs = y.numel() * cin * k * k
        n_bytes = nbytes(x, wt, y)
        peak = PEAK["bf16"] if dtype == torch.bfloat16 else PEAK["f32"]
        b_ms, by = bound(n_bytes, 2 * macs, peak)
        print(f"time early conv {name} [{FPS_BATCH},{cin},{h},{w}] "
              f"{str(dtype).split('.')[-1]}: cuDNN {ms:.4f} ms = "
              f"{2 * macs / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms ({by}) ({card})")
        out[name] = (ms, macs, n_bytes, cin, cout, k)
    return out


def p1_verdict(rows, early, card):
    """Probe P1's answer for each early conv, from its rows: an estimate,
    not a measurement.  The probe's dot block is one warp; a conv would
    run 4 an SM (one a tensor-core quarter) on 132 SMs, so a row's rate a
    warp x 528 (capped at the bf16 peak) is the card's rate at that K.
    Tap accumulation: K = C_in rounded up to a 16-deep mma step, 9 (or 49)
    taps, its operands read shifted from shared memory (aligned when a
    pixel is a multiple of 16 bytes, as NHWC C_in = 16 and 32 are; shifted
    by 6 bytes for C_in = 3); im2col: one K = k k C_in dot (rounded up to
    16) after an aligned patch copy in shared memory.  Each time is the
    largest of device-memory bytes, the dot and the build (perfect
    overlap), so cuDNN / the better of the two is the most a hand-written
    conv could gain."""
    def per_warp(op):
        return rows[op]["eff_tflops"] / rows[op]["blocks"]

    def card_rate(op):
        return min(per_warp(op) * 4 * 132, PEAK["bf16"] / 1e12) * 1e12

    def copy_rate(op):   # elements a second, all SMs
        return rows[op]["gel_per_s"] * 1e9 / rows[op]["blocks"] * 132

    tap_dot, im2col_dot = "dot[16x16xN640]", "dot[16x144xN640]"
    aligned, shifted = "slice_copy 3x[16,642]", "lane-shift copy 2x[16,640]"
    print(f"verdict op_probe: a warp's dot rate at K=16 {per_warp(tap_dot):.3f} TFLOP/s, "
          f"at K=144 {per_warp(im2col_dot):.3f} TFLOP/s (x528 for the card: "
          f"{card_rate(tap_dot) / 1e12:.0f} and {card_rate(im2col_dot) / 1e12:.0f}); "
          f"shared-memory copy an SM aligned {copy_rate(aligned) / 132 / 1e9:.1f} Gel/s, "
          f"shifted by 1-2 elements {copy_rate(shifted) / 132 / 1e9:.1f} Gel/s ({card})")
    for name, (cudnn_ms, macs, n_bytes, cin, cout, k) in early.items():
        pixels = macs // (cin * k * k * cout)
        hbm_ms = n_bytes / PEAK["bytes"] * 1e3
        k_tap, k_im2col = -(-cin // 16) * 16, -(-cin * k * k // 16) * 16
        tap_dot_ms = 2 * pixels * cout * k * k * k_tap / card_rate(tap_dot) * 1e3
        tap_build_ms = pixels * k * k * cin / copy_rate(
            aligned if cin * 2 % 16 == 0 else shifted) * 1e3
        im_dot_ms = 2 * pixels * cout * k_im2col / card_rate(im2col_dot) * 1e3
        im_build_ms = pixels * k_im2col / copy_rate(aligned) * 1e3
        tap_ms = max(hbm_ms, tap_dot_ms, tap_build_ms)
        im_ms = max(hbm_ms, im_dot_ms, im_build_ms)
        print(f"verdict op_probe {name}: cuDNN {cudnn_ms:.4f} ms, device-memory bound "
              f"{hbm_ms:.4f} ms; tap accumulation (K={k_tap}) dot {tap_dot_ms:.4f} + build "
              f"{tap_build_ms:.4f} ms -> at best {tap_ms:.4f} ms; im2col (K={k_im2col}) dot "
              f"{im_dot_ms:.4f} + build {im_build_ms:.4f} ms -> at best {im_ms:.4f} ms; "
              f"a hand-written conv at most {cudnn_ms / min(tap_ms, im_ms):.2f}x cuDNN "
              f"(estimate) ({card})")


# ---- phase 12: int8_pair ------------------------------------------------

# The pair's two other int8 profiles of bench.py, each its CenterNet and
# its YOLACT as two requests (bench.py:1620-1627): --parity-int8 plain,
# with --mse --bias-correct and with --mse --seq-correct, and
# --per-layer-int8.
PAIR_INT8 = {"parity_int8": PARITY_INT8,
             "parity_int8_corrected": dataclasses.replace(PARITY_INT8, mse=True,
                                                          bias_correct=True),
             "parity_int8_seq": dataclasses.replace(PARITY_INT8, mse=True, seq_correct=True),
             "per_layer_int8": PER_LAYER_INT8}
PAIR_INT8_TIMED = ("parity_int8", "parity_int8_seq", "per_layer_int8")
# Calibrated convs of the CenterNet and the YOLACT: the parity chains
# strip the bf16 tail (bench.py:1373) and the YOLACT's head and protonet
# output; per layer, every conv of 16 input channels or more, the two
# projections the JAX forward discards included (their keys come from the
# tree's own projection).
PAIR_INT8_CONVS = {"parity": (36, 30), "per_layer": (60, 38)}


def int8_pair_nets(nets, yl, yl_cfg):
    """({impl: the recipe's bf16 CenterNet with f32 BatchNorm outputs on
    ``plain_ida``'s weights, kernel C or its plain version}, the bf16
    YOLACT on ``yl``'s weights), as ``bench.py`` builds them for these
    profiles."""
    device = torch.device("cuda")
    oc, _ = centernet_config()
    cns = {}
    for impl in ("kernel", "plain"):
        cn = CenterpointDLA34(oc, up_impl=impl, device=device,
                              **PARITY_INT8.centernet_kwargs()).eval()
        cn.load_state_dict(nets["plain_ida"][0].state_dict())
        cns[impl] = cn
    yl_bf16 = Yolact(yl_cfg, device=device, dtype=PARITY_INT8.input_dtype).eval()
    yl_bf16.load_state_dict(yl.state_dict())
    return cns, yl_bf16


def int8_pair_pipes(recipe, cns, cn_cfg, yl_bf16, cal, knobs=SERVING_DECODE):
    """{impl: (CenterNet pipeline, YOLACT pipeline)} of a recipe."""
    return {impl: make_int8_pair_pipelines(recipe, cns[impl], cn_cfg, yl_bf16, cal,
                                           torch.device("cuda"), knobs, impl=impl)
            for impl in ("kernel", "plain")}


def serve_int8_pair(path, recipe, cns, cn_cfg, yl_bf16, cal, n_requests=N_REQUESTS, seed=0):
    """Serve ``n_requests`` requests of 8 frames of a pair profile (its two
    requests each), every launch counted from 0, and hold them to the same
    requests on the plain versions: decodes 100% matched, CenterNet p95 <=
    1e-3; returns (launches by kernel, by entry point, by variant)."""
    requests = [request_frames(seed, (n_requests, CHECK_BATCH, FRAME_H, FRAME_W, 3))[i]
                .pin_memory() for i in range(n_requests)]
    pipes = int8_pair_pipes(recipe, cns, cn_cfg, yl_bf16, cal)
    (cn_pipe, yl_pipe), (cn_plain, yl_plain) = pipes["kernel"], pipes["plain"]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [(cn_pipe(r), yl_pipe(r)) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    check_chain_launches(path, cns["kernel"], n_requests, launches, entries)
    plain_answers = [(cn_plain(r), yl_plain(r)) for r in requests]
    _, cn_p95, mask_err = check_answers(path, answers, plain_answers, CHECK_BATCH)
    require(all(v <= CHAIN_P95 for v in cn_p95.values()),
            f"{path}: CenterNet decode kernel vs plain p95 {cn_p95} (bar {CHAIN_P95})")
    print(f"serve {path}: {n_requests} requests x {CHECK_BATCH} frames, each the CenterNet and "
          f"the YOLACT, launches {launches} (kernel C: "
          f"{entries['tauv_depthwise_upsample_bf16']} bf16); decoded kernel vs plain (score "
          f"threshold 0): CenterNet and YOLACT 100% matched, CenterNet p95 {cn_p95} (bar "
          f"{CHAIN_P95}), mask max_abs_err {mask_err:.3g}")
    return launches, entries, variants


def calibrate_int8_pair(path, recipe, cn, cn_cfg, yl_bf16, frames):
    """``calibrate_pair`` on the card, its convs counted, and what its
    options made printed."""
    cal = calibrate_pair(recipe, cn, cn_cfg, yl_bf16, frames)
    want = PAIR_INT8_CONVS["per_layer" if recipe.per_layer else "parity"]
    got = tuple(len(c.scales) for c in cal)
    require(got == want, f"{path}: {got} calibrated convs (CenterNet, YOLACT), expected {want}")
    for name, c in zip(("CenterNet", "YOLACT"), cal):
        for what in ("gains", "corrections"):
            table = getattr(c, what)
            if table is None:
                continue
            values = np.concatenate([np.asarray(v).ravel() for v in table.values()])
            require(np.isfinite(values).all(), f"{path}: {name} {what} not finite")
            print(f"calibrate {path} {name}: {len(table)} {what}, range "
                  f"[{values.min():.4g}, {values.max():.4g}]")
    return cal


def time_int8_pair(path, recipe, cns, cn_cfg, yl_bf16, yl_cfg, cal, card):
    """A pair profile at batch 32 as bench.py times it (the batch over
    the sum of its two requests), kernels and plain; the device's busy
    time and idle share; each net's forward and its device split."""
    device = torch.device("cuda")
    frames = request_frames(1, (FPS_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    pipes = int8_pair_pipes(recipe, cns, cn_cfg, yl_bf16, cal)
    (cn_k, yl_k), (cn_p, yl_p) = pipes["kernel"], pipes["plain"]
    cn_ms, cn_plain_ms = abba(lambda: cn_k(frames), lambda: cn_p(frames), CHAIN_ITERS)
    yl_ms, yl_plain_ms = abba(lambda: yl_k(frames), lambda: yl_p(frames), CHAIN_ITERS)
    busy_ms, n_kernels = device_busy(lambda: (cn_k(frames), yl_k(frames)))
    wall = cn_ms + yl_ms
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / wall:.1%}"
    print(f"time pipeline {path} batch {FPS_BATCH} (bench.py's two requests, each upload + bf16 "
          f"preprocess + int8 forward + decode): CenterNet {cn_ms:.3f} ms, YOLACT {yl_ms:.3f} "
          f"ms, kernels {FPS_BATCH * 1000 / wall:.2f} frames/s, plain CenterNet "
          f"{cn_plain_ms:.3f} ms, YOLACT {yl_plain_ms:.3f} ms = "
          f"{FPS_BATCH * 1000 / (cn_plain_ms + yl_plain_ms):.2f} frames/s; the kernels' pair: "
          f"{n_kernels} device kernels and copies, busy {busy_ms} ms, the device idle {idle} "
          f"({card})")
    cn_fwd, yl_fwd = cn_k.forward, yl_k.forward
    with torch.inference_mode():
        on_card = frames.to(device)
        images = {
            "CenterNet": (cn_fwd, preprocess(on_card, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN,
                                             IMAGENET_STDDEV, recipe.input_dtype)),
            "YOLACT": (yl_fwd, preprocess(on_card, (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean,
                                          yl_cfg.img_stddev, recipe.input_dtype))}
        for name, (fwd, img) in images.items():
            fwd(img)
            fwd_ms = time_ms(lambda: fwd(img), CHAIN_ITERS)
            split, _ = chain_split(fwd, img)
            if split is None:
                print(f"time split {path} {name} forward: {fwd_ms:.3f} ms; split not measured "
                      f"(the profiler recorded no device activity)")
                continue
            print(f"time split {path} {name} forward batch {FPS_BATCH}: {fwd_ms:.3f} ms back "
                  f"to back; device ms from torch.profiler, 3 forwards: {split}; im2col "
                  f"{split['im2col'] / split['busy']:.1%} of device time, _int_mm "
                  f"{split['int_mm'] / split['busy']:.1%}; the device idle "
                  f"{1 - split['busy'] / fwd_ms:.1%} ({card})")


def int8_pair_phase(nets, cn_cfg, yl, yl_cfg, card):
    """Calibrate, serve and time the pair's int8 profiles (see the module
    docstring); returns ({path: the served run's launches by kernel, by
    entry point, by variant}, the bf16 CenterNets, the bf16 YOLACT)."""
    cns, yl_bf16 = int8_pair_nets(nets, yl, yl_cfg)
    frames = request_frames(0, (SEQ_FRAMES, FRAME_H, FRAME_W, 3)).cuda()
    served = {}
    for path, recipe in PAIR_INT8.items():
        t0 = time.perf_counter()
        cal = calibrate_int8_pair(path, recipe, cns["kernel"], cn_cfg, yl_bf16, frames)
        t1 = time.perf_counter()
        served[path] = serve_int8_pair(path, recipe, cns, cn_cfg, yl_bf16, cal)
        t2 = time.perf_counter()
        if path in PAIR_INT8_TIMED:
            time_int8_pair(path, recipe, cns, cn_cfg, yl_bf16, yl_cfg, cal, card)
        print(f"int8_pair {path}: calibrate {t1 - t0:.1f} s, serve {t2 - t1:.1f} s, time "
              f"{time.perf_counter() - t2:.1f} s")
    return served, cns, yl_bf16


# ---- phase 13: qat ------------------------------------------------------

QAT_BATCH = 8
QAT_STEPS = 10
QAT_STRIP = ("head_",)      # quantize_accuracy_check.py's --qat-strip default
QAT_LR = 2e-5               # its --qat-lr default, sized for trained weights
# On random weights the recipe's lr overshoots: Adam's first update moves
# every weight by ~lr, which moves the student's heads far more than its
# quantization noise (the distillation loss rose ~100x after one step on
# the CPU at 64x128, JAX's qat_distill alike).  The gate's run takes a
# step that stays below the noise.
QAT_GATE_LR = 1e-6


def qat_phase(cns, cn_cfg, yl_bf16, card):
    """``qat_distill`` on the bf16 plain-IDA CenterNet at 360x640 (see the
    module docstring); returns the phase's launches (by kernel, by entry
    point, by variant)."""
    t0 = time.perf_counter()
    teacher = cns["kernel"]
    img, _ = generate_square_batch(np.random.default_rng(2027), QAT_BATCH, SquareDatasetConfig(
        in_h=cn_cfg.in_h, in_w=cn_cfg.in_w, max_objects=TRAIN_OBJECTS))
    frames = torch.from_numpy((np.clip(img, 0, 1) * 255).astype(np.uint8)).cuda()
    with torch.inference_mode():
        x = preprocess(frames, (cn_cfg.in_h, cn_cfg.in_w), IMAGENET_MEAN, IMAGENET_STDDEV,
                       PARITY_INT8.input_dtype)
    x = x.clone()
    scales = strip_scales(calibrate(teacher, [x], per_channel=True,
                                    paths_of=centerpoint_calibration_paths), QAT_STRIP)

    def loss_of(model):
        with torch.no_grad():
            return qat.distillation_loss(
                qat.fake_quant_call(model, scales, paths_of=centerpoint_calibration_paths)(x),
                teacher(x)).item()

    def distill(lr, logs):
        return qat.qat_distill(teacher, scales, itertools.repeat(x), QAT_STEPS, lr=lr,
                               paths_of=centerpoint_calibration_paths, log_every=1,
                               log_fn=logs.append)

    first = loss_of(teacher)
    qat.qat_distill(teacher, scales, iter([x]), 1, lr=QAT_LR,
                    paths_of=centerpoint_calibration_paths, log_every=0)   # warm-up
    recipe_logs, gate_logs = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    distill(QAT_LR, recipe_logs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1000 / QAT_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    student = distill(QAT_GATE_LR, gate_logs)
    torch.cuda.synchronize()
    trained = (dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES))
    launches = trained[1]
    last = loss_of(student)
    c_calls = len(teacher.depthwise_upsamples())
    require(launches["tauv_depthwise_upsample_bf16"] == 2 * 2 * c_calls * QAT_STEPS,
            f"qat: kernel C launched {launches['tauv_depthwise_upsample_bf16']} times in "
            f"{2 * QAT_STEPS} steps, expected {4 * c_calls * QAT_STEPS} (student and teacher)")
    require(math.isfinite(first) and math.isfinite(last) and last < first,
            f"qat: distillation loss {first} -> {last} on the fixed batch at lr {QAT_GATE_LR}")
    quantized = {n: m for n, m in student.named_modules()
                 if isinstance(m, torch.nn.Conv2d) and m.in_channels >= quantize.MIN_IN_CHANNELS
                 and _first_path(centerpoint_calibration_paths(n)) in scales}
    # The two projections that JAX computes and discards have scales, and
    # the port's model holds them but never runs them: no gradient.
    dead = [n for n, m in quantized.items()
            if not (n + ".").startswith(DISCARDED) and (
                m.weight.grad is None or not torch.isfinite(m.weight.grad).all()
                or not m.weight.grad.any())]
    unrun = [n for n in quantized if (n + ".").startswith(DISCARDED)]
    require(len(quantized) == len(scales) and len(unrun) == 2 and not dead
            and all(quantized[n].weight.grad is None for n in unrun),
            f"qat: {len(quantized)} fake-quantized convs for {len(scales)} scales, never run "
            f"{unrun}; gradients missing, zero or not finite: {dead}")
    moved = sum(int(not torch.equal(p, q)) for p, q in zip(student.parameters(),
                                                          teacher.parameters()))
    print(f"qat: qat_distill (Adam clipped at 1.0) on one fixed batch of {QAT_BATCH} synthetic "
          f"squares at {cn_cfg.in_h}x{cn_cfg.in_w}, {len(scales)} fake-quantized convs "
          f"(per-channel scales, {QAT_STRIP} stripped); {QAT_STEPS} steps at the recipe's lr "
          f"{QAT_LR} (not gated), losses {[line.split()[-1] for line in recipe_logs]}; "
          f"{QAT_STEPS} steps at lr {QAT_GATE_LR}: distillation loss {first:.6g} -> {last:.6g} "
          f"({last / first:.3f} of the first), losses {[line.split()[-1] for line in gate_logs]}; "
          f"kernel C {launches['tauv_depthwise_upsample_bf16']} bf16 launches ({c_calls} a "
          f"forward, student and teacher); {len(quantized) - len(unrun)} int8-conv weight "
          f"gradients finite and non-zero (the discarded projections {unrun} never run); "
          f"{moved} parameter tensors moved")
    print(f"time qat step bf16 batch {QAT_BATCH} at {cn_cfg.in_h}x{cn_cfg.in_w}: {step_ms:.3f} ms "
          f"a step (teacher forward, fake-quantized forward and backward, Adam; the loss read each "
          f"step) = {QAT_BATCH * 1000 / step_ms:.2f} images/s; peak memory allocated {peak:.2f} "
          f"GiB ({card})")

    # The QAT weights through a fresh parity_int8 pair.
    cal_frames = request_frames(0, (CALIBRATION_FRAMES, FRAME_H, FRAME_W, 3)).cuda()
    qat_cns = {}
    for impl in ("kernel", "plain"):
        oc, _ = centernet_config()
        cn = CenterpointDLA34(oc, up_impl=impl, device=torch.device("cuda"),
                              **PARITY_INT8.centernet_kwargs()).eval()
        cn.load_state_dict(student.state_dict())
        qat_cns[impl] = cn
    cal = calibrate_int8_pair("qat", PARITY_INT8, qat_cns["kernel"], cn_cfg, yl_bf16, cal_frames)
    by_kernel, by_entry, by_variant = serve_int8_pair("qat parity_int8", PARITY_INT8, qat_cns,
                                                      cn_cfg, yl_bf16, cal, n_requests=2, seed=5)
    print(f"qat phase {time.perf_counter() - t0:.1f} s")
    # The phase's launches: the distillation steps', then the served pair's.
    return ({k: n + trained[0][k] for k, n in by_kernel.items()},
            {k: n + trained[1][k] for k, n in by_entry.items()}, by_variant)


# ---- phase 14: host_io --------------------------------------------------

HOST_IO_ERROR_AT = 3        # the failing source's batch
THREADS_GONE_S = 2.0
CODEC_FILES = 128           # bench.py's PIL-only rate reads 128 files


def executor_threads():
    return [t for t in threading.enumerate() if t.name.startswith(executor.THREAD_PREFIX)]


def merged(intervals):
    """The union of [start, end) intervals as a sorted disjoint list."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def covered(intervals) -> float:
    return sum(end - start for start, end in intervals)


def overlap(a, b) -> float:
    """Length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_activity(fn):
    """(fn's wall ms, {"kernel", "HtoD", "DtoH", "all": merged device
    intervals in us}) from a ``torch.profiler`` trace of the card's
    activity; the intervals are None where it records none."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text()).get("traceEvents", [])
    spans = {"kernel": [], "HtoD": [], "DtoH": [], "all": []}
    for e in events:
        cat, dur = e.get("cat", ""), e.get("dur")
        if dur is None or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(dur))
        spans["all"].append(span)
        if cat == "kernel":
            spans["kernel"].append(span)
        for way in ("HtoD", "DtoH"):
            if cat == "gpu_memcpy" and way in e.get("name", ""):
                spans[way].append(span)
    if not spans["kernel"]:
        return wall_ms, None
    return wall_ms, {k: merged(v) for k, v in spans.items()}


def write_host_io_frames(root):
    """``HOST_IO``'s frames (seeded) as a raw ring and PNGs under ``root``;
    returns (the ring, the PNG directory, seconds)."""
    n, (h, w) = HOST_IO.n_batches * HOST_IO.batch, HOST_IO.frame_hw
    frames = np.random.default_rng(14).integers(0, 256, (n, h, w, 3), np.uint8)
    t0 = time.perf_counter()
    raw_path, png_dir = host_io.write_frames(root, frames)
    return raw_path, png_dir, time.perf_counter() - t0


def host_io_phase(chains, cn_cfg, yl, yl_scales, card):
    """``bench.py --host-io`` (``configs.HOST_IO``) on ``chain_int8``'s
    chains and scales (see the module docstring); returns the served run's
    launches (by kernel, by entry point, by variant)."""
    t0 = time.perf_counter()
    batch, n_batches = HOST_IO.batch, HOST_IO.n_batches
    assert HOST_IO.pair == CHAIN_PAIRS["chain_int8"][0]
    cn_pipe, yl_pipe = chain_pair_pipelines("chain_int8", chains, cn_cfg, yl, yl_scales)["kernel"]
    unpacked = []

    def yl_kept(frames):
        out = yl_pipe(frames)
        unpacked[:] = [out.mask]
        return out

    pipeline = host_io_pipeline(cn_pipe, yl_pipe)
    ex = ServingExecutor(pipeline, prefetch=HOST_IO.prefetch, device="cuda")

    def to_numpy(out):
        return executor.tree_map(lambda t: t.cpu().numpy(), out)

    with tempfile.TemporaryDirectory(prefix="tauv_hostio_") as tmp:
        raw_path, png_dir, write_s = write_host_io_frames(tmp)

        def raw(reps=1):
            return host_io.raw_source(raw_path, batch, reps)

        # Warm, then the served pass with every launch counted from 0.
        for _ in ex.run(raw()):
            pass
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        served = list(ex.run(raw()))
        torch.cuda.synchronize()
        launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
        variants = dict(kernels.VARIANT_LAUNCHES)
        check_chain_launches("host_io", chains["chain_int8"]["model"], n_batches, launches, entries)
        t1 = lap("host_io write and served pass", t0)

        # The same pipeline called in order on one thread, the unpacked
        # masks kept.
        sequential = host_io_pipeline(cn_pipe, yl_kept)
        require(len(served) == n_batches, f"host_io: {len(served)} outputs of {n_batches}")
        for i, (out, batch_frames) in enumerate(zip(served, raw())):
            want = to_numpy(sequential(torch.from_numpy(batch_frames.copy())))
            for got_d, want_d in zip(out, want):
                for name, value in vars(want_d).items():
                    got_v = getattr(got_d, name)
                    require((value is None and got_v is None) or (
                        got_v.dtype == value.dtype and np.array_equal(got_v, value)),
                        f"host_io: batch {i} {type(want_d).__name__}.{name} differs from the "
                        f"sequential call")
            mask = unpacked[-1].cpu().numpy()
            bits = np.unpackbits(out[1].mask, axis=-1)[..., :mask.shape[-1]]
            require(out[1].mask.dtype == np.uint8 and np.array_equal(
                bits, (mask > HOST_IO.mask_threshold).astype(np.uint8)),
                f"host_io: batch {i}: packed masks do not unpack to mask > 0.5")
        mask_bytes = served[0][1].mask.nbytes
        print(f"serve host_io: {n_batches} batches x {batch} frames through ServingExecutor "
              f"(prefetch {HOST_IO.prefetch}) from the raw ring, in order, every output equal "
              f"bit for bit to the sequential call of the same pipeline, packed masks "
              f"{list(served[0][1].mask.shape)} uint8 ({mask_bytes} B, unpacked f32 "
              f"{mask.nbytes} B) unpacking to mask > {HOST_IO.mask_threshold}; launches "
              f"{launches} (kernel C: {entries['tauv_depthwise_upsample_bf16']} bf16)")

        # Closed early, and a source that fails.
        gen = ex.run(raw())
        next(gen)
        next(gen)
        gen.close()
        start = time.perf_counter()
        while executor_threads() and time.perf_counter() - start < THREADS_GONE_S:
            time.sleep(0.01)
        gone_s = time.perf_counter() - start
        require(not executor_threads(), f"host_io: executor threads alive {THREADS_GONE_S} s "
                                        f"after close: {executor_threads()}")

        def failing():
            for i, batch_frames in enumerate(raw()):
                if i == HOST_IO_ERROR_AT:
                    raise RuntimeError("host_io source failure")
                yield batch_frames

        got = []
        try:
            for out in ex.run(failing()):
                got.append(out)
            fail("host_io: the failing source's error was not raised")
        except RuntimeError as e:
            require(str(e) == "host_io source failure", f"host_io: raised {e!r}")
        require(len(got) == HOST_IO_ERROR_AT,
                f"host_io: {len(got)} outputs before the error, expected {HOST_IO_ERROR_AT}")
        print(f"serve host_io: closed after 2 batches, its threads gone in {gone_s:.2f} s; a "
              f"source failing at batch {HOST_IO_ERROR_AT} yielded {len(got)} outputs, then "
              f"raised")
        t2 = lap("host_io checks", t1)

        # Frames/s: the raw ring (warm above), the PNGs, and the raw batches
        # without the executor.
        def rate(source):
            t = time.perf_counter()
            n = sum(batch for _ in ex.run(source))
            return n / (time.perf_counter() - t)

        raw_fps = rate(raw(HOST_IO.raw_reps))
        png_fps = rate(host_io.png_source(png_dir, batch, HOST_IO.png_reps))
        t = time.perf_counter()
        for batch_frames in raw():
            to_numpy(pipeline(torch.from_numpy(batch_frames.copy())))
        seq_fps = n_batches * batch / (time.perf_counter() - t)
        names = sorted(png_dir.iterdir())[:CODEC_FILES]
        t = time.perf_counter()
        for p in names:
            read_image(p)
        codec_fps = len(names) / (time.perf_counter() - t)
        up_bytes = batch * HOST_IO.frame_hw[0] * HOST_IO.frame_hw[1] * 3
        down_bytes = sum(v.nbytes for d in served[0] for v in vars(d).values()
                         if isinstance(v, np.ndarray))
        t3 = lap("host_io rates", t2)

        # One raw pass traced: the device time in which a host-to-device
        # copy ran beside a kernel, and the device's idle share.
        wall_ms, spans = device_activity(lambda: [None for _ in ex.run(raw())])
        if spans is None:
            trace = "copy/kernel overlap and idle share not measured (no device activity traced)"
        else:
            busy = covered(spans["all"]) / 1e3
            trace = (f"one raw pass traced: {wall_ms:.1f} ms, device busy {busy:.1f} ms (idle "
                     f"{1 - busy / wall_ms:.1%}), kernels {covered(spans['kernel']) / 1e3:.1f} "
                     f"ms, host-to-device copies {covered(spans['HtoD']) / 1e3:.1f} ms of which "
                     f"{overlap(spans['HtoD'], spans['kernel']) / 1e3:.2f} ms beside a kernel, "
                     f"device-to-host {covered(spans['DtoH']) / 1e3:.1f} ms of which "
                     f"{overlap(spans['DtoH'], spans['kernel']) / 1e3:.2f} ms beside a kernel")
        lap("host_io trace", t3)
    print(f"time host_io batch {batch} (bench.py --host-io, chain_int8 with packed masks, "
          f"outputs to numpy): raw ring {raw_fps:.2f} frames/s ({HOST_IO.raw_reps} passes of "
          f"{n_batches} batches after a warm one), PNG {png_fps:.2f} frames/s ({HOST_IO.png_reps} "
          f"pass, decoded by PIL on the upload thread), the same raw batches without the "
          f"executor (upload, both requests, download on one thread) {seq_fps:.2f} frames/s; PIL "
          f"decode alone {codec_fps:.2f} frames/s on one thread; {os.cpu_count()} host cores; "
          f"{up_bytes} B up and {down_bytes} B down a batch; {trace}; frames written in "
          f"{write_s:.1f} s ({card})")
    return launches, entries, variants


# ---- phase 15: bf16_pair -------------------------------------------------

BF16_ITERS = 3      # timed repetitions of each rung's requests at batch 32
# The float pair's rungs: {path: (recipe, the YOLACT chain's recipe or
# None for the bf16 YOLACT)}.
BF16_RUNGS = {
    "bf16_pair": (BF16_PAIR, None),
    "bf16_pair_fused": (bf16_pair(fused=True), None),
    "bf16_pair_bn_bf16": (bf16_pair(bn_bf16=True), None),
    "bf16_pair_f32_early": (bf16_pair(f32_stages=("early",)), None),
    "bf16_pair_f32_level3": (bf16_pair(f32_stages=("level3", "level4", "level5", "dla_up",
                                                   "ida_up", "heads")), None),
    "north_star_exact": (NORTH_STAR_EXACT, NORTH_STAR_EXACT.yolact),
}
MASK_HW = (360, 640)   # decode_yolact(mask_hw=): the prototypes' 180x320 at the input's size


def bf16_rung_pipes(path, cns, cn_cfg, yl_bf16, yl, yl_scales):
    """{impl: the rung's pipeline}: the float pair (``make_float_pair_pipeline``),
    or ``NORTH_STAR_EXACT``'s combined pipeline with its int8-chain YOLACT."""
    recipe, chain = BF16_RUNGS[path]
    device = torch.device("cuda")
    pipes = {}
    for impl in ("kernel", "plain"):
        if chain is None:
            pipes[impl] = make_float_pair_pipeline(recipe, cns[impl], cn_cfg, yl_bf16, device,
                                                   impl=impl)
        else:
            ctx = ChainCtx(yl, yl_scales, dtype=chain.dtype, join_dtype=chain.join_dtype,
                           impl=impl)
            pipes[impl] = make_combined_pipeline(cns[impl], cn_cfg, yolact_chain_forward(ctx),
                                                 yl.config, device, impl=impl,
                                                 dtype=recipe.input_dtype)
    return pipes


def bf16_rung_nets(path, pair_cns, f32_state):
    """{impl: the rung's CenterNet}: ``int8_pair``'s bf16 CenterNets where
    the rung's CenterNet is theirs, else new ones on the same weights."""
    recipe = BF16_RUNGS[path][0]
    if recipe.centernet == BF16_PAIR.centernet:
        return pair_cns
    oc, _ = centernet_config()
    cns = {}
    for impl in ("kernel", "plain"):
        cn = CenterpointDLA34(oc, up_impl=impl, device=torch.device("cuda"),
                              **recipe.centernet_kwargs()).eval()
        cn.load_state_dict(f32_state)
        cns[impl] = cn
    return cns


def bf16_pair_phase(nets, pair_cns, cn_cfg, yl, yl_bf16, chains, card):
    """The float pair of ``bench.py --bf16`` with its ladder and
    ``NORTH_STAR_EXACT`` (see the module docstring); returns {path: the
    checked request's launches (by kernel, by entry point, by variant)}."""
    t0 = time.perf_counter()
    require(BF16_PAIR.centernet == PARITY_INT8.centernet
            and yl_bf16.dtype == BF16_PAIR.yolact_dtype, "bf16_pair: int8_pair's nets differ")
    f32_state = nets["plain_ida"][0].state_dict()
    ns_scales = chains["north_star"]["kernel"][0].scales
    request = request_frames(15, (CHECK_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    frames = request_frames(16, (FPS_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    served, answers, timed = {}, {}, {}
    for path, (recipe, chain) in BF16_RUNGS.items():
        cns = bf16_rung_nets(path, pair_cns, f32_state)
        pipes = bf16_rung_pipes(path, cns, cn_cfg, yl_bf16, yl, ns_scales)
        pipes["kernel"](request)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = pipes["kernel"](request)
        torch.cuda.synchronize()
        launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
        served[path] = launches, entries, dict(kernels.VARIANT_LAUNCHES)
        answers[path] = got
        want = {**{name: 0 for name in KERNELS}, "peak_decode": 1, "mask_assembly": 1,
                "depthwise_upsample": 8}
        require(launches == want and len(cns["kernel"].depthwise_upsamples()) == 8,
                f"{path}: launch counts {launches}, expected {want}")
        f32_up = "ida_up" in recipe.centernet.f32_stages
        _, cn_p95, mask_err = check_answers(path, [got], [pipes["plain"](request)], CHECK_BATCH)
        print(f"serve {path}: 1 request x {CHECK_BATCH} frames, launches {launches} (kernel C "
              f"bf16 {entries['tauv_depthwise_upsample_bf16']}, f32 "
              f"{entries['tauv_depthwise_upsample_f32']}{', ida_up and dla_up in f32' if f32_up else ''}); "
              f"decoded kernel vs plain: CenterNet p95 {cn_p95}, YOLACT 100% matched, mask "
              f"max_abs_err {mask_err:.3g}; CenterNet image {recipe.input_dtype}")
        # Timed at batch 32: the two requests as bench.py sums them, or
        # the one fused request.
        requests = getattr(pipes["kernel"], "requests", (pipes["kernel"],))
        for fn in requests:
            fn(frames)
        torch.cuda.synchronize()
        timed[path] = [time_ms(lambda fn=fn: fn(frames), BF16_ITERS) for fn in requests]
        if cns is not pair_cns:
            del cns, pipes
            torch.cuda.empty_cache()
    t1 = lap("bf16_pair rungs", t0)

    for got_d, want_d in zip(answers["bf16_pair_fused"], answers["bf16_pair"]):
        for name, value in vars(want_d).items():
            other = getattr(got_d, name)
            require((value is None and other is None) or torch.equal(other, value),
                    f"bf16_pair: fused {type(want_d).__name__}.{name} differs from unfused")
    print("serve bf16_pair: fused decode equal bit for bit to the unfused pair's (batch "
          f"{CHECK_BATCH}, kernels)")

    # decode_yolact(mask_hw=, crop_masks=False) on the bf16 YOLACT's
    # prediction, kernel B's "no crop" entry against its plain version.
    with torch.inference_mode():
        img = preprocess(request.cuda(), (yl.config.in_h, yl.config.in_w), yl.config.img_mean,
                         yl.config.img_stddev, BF16_PAIR.yolact_dtype)
        pred = yl_bf16(img)
        knobs = SERVING_DECODE
        args = (pred, yl.config, knobs.top_k, knobs.iou_threshold, knobs.confidence_threshold)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = decode_yolact(*args, mask_hw=MASK_HW, crop_masks=False, impl="kernel")
        torch.cuda.synchronize()
        no_crop = dict(kernels.VARIANT_LAUNCHES)
        ref = decode_yolact(*args, mask_hw=MASK_HW, crop_masks=False, impl="plain")
    err = (got.mask - ref.mask).abs().max().item()
    require(no_crop == {("mask_assembly", "no crop"): 1}, f"decode_yolact no crop: {no_crop}")
    require(got.mask.shape == (CHECK_BATCH, knobs.top_k) + MASK_HW and torch.equal(
        got.valid, ref.valid) and err <= MASK_ATOL,
        f"decode_yolact(mask_hw={MASK_HW}, crop_masks=False): mask err {err}")
    print(f"serve bf16_pair: decode_yolact(mask_hw={MASK_HW}, crop_masks=False) kernel B's "
          f"'no crop' entry ({no_crop}) against its plain version: masks "
          f"{list(got.mask.shape)} max_abs_err {err:.3g} (atol {MASK_ATOL}), keep masks equal")
    print(f"time bf16_pair batch {FPS_BATCH} ({BF16_ITERS} repetitions; unfused: the "
          f"CenterNet's and the YOLACT's requests as bench.py sums them): " + ", ".join(
              f"{path} {' + '.join(f'{ms:.3f}' for ms in ms_list)} ms = "
              f"{FPS_BATCH * 1000 / sum(ms_list):.2f} frames/s"
              for path, ms_list in timed.items()) + f" ({card})")
    lap("bf16_pair checks", t1)
    return served


# ---- phase 16: keypoints_per_layer_int8 ---------------------------------

KP_PER_LAYER = "keypoints_per_layer_int8"


def keypoints_per_layer_phase(kp_net, kp_scales, card):
    """``bench.py --keypoints --per-layer-int8``
    (``configs.KEYPOINTS_PER_LAYER_INT8``; see the module docstring);
    returns the served run's launches (by kernel, by entry point, by
    variant)."""
    device = torch.device("cuda")
    kp, kp_plain, oc, cfg, projection = kp_net
    n_slots = max(len(c.keypoints) for c in oc.configs)
    cal = request_frames(0, (N_CALIBRATION, FRAME_H, FRAME_W, 3)).to(device)
    scales = calibrate_per_layer(KEYPOINTS_PER_LAYER_INT8, kp, cfg, cal)
    require(scales.keys() == kp_scales.keys(),
            f"{KP_PER_LAYER}: {len(scales)} calibrated convs, the keypoint chain's "
            f"{len(kp_scales)}")
    scale_rel = max(abs(scales[k] / kp_scales[k] - 1) for k in scales)

    def pipes(knobs):
        return tuple(make_keypoints_per_layer_pipeline(net, cfg, scales, projection, device,
                                                       knobs, impl=impl)
                     for net, impl in ((kp, "kernel"), (kp_plain, "plain")))

    pipe, _ = pipes(SERVING_DECODE)
    requests = [request_frames(4, (KP_REQUESTS, KP_BATCH, FRAME_H, FRAME_W, 3))[i].pin_memory()
                for i in range(KP_REQUESTS)]
    pipe(requests[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    answers = [pipe(r) for r in requests]
    torch.cuda.synchronize()
    launches, entries = dict(kernels.LAUNCHES), dict(kernels.ENTRY_LAUNCHES)
    variants = dict(kernels.VARIANT_LAUNCHES)
    per_request = keypoint_launches(kp)
    require(launches == {name: KP_REQUESTS * n for name, n in per_request.items()},
            f"{KP_PER_LAYER}: launch counts {launches}")
    require(entries["tauv_depthwise_upsample_bf16"] == KP_REQUESTS * 8,
            f"{KP_PER_LAYER}: kernel C's bf16 launches")
    require(variants == {("peak_decode", "K=10"): KP_REQUESTS,
                         ("peak_decode", "K=50"): KP_REQUESTS}, f"{KP_PER_LAYER}: kernel A by K")
    for out in answers:
        check_keypoint_outputs(out, KP_BATCH, n_slots)

    pipe0, plain0 = pipes(ALL_SLOTS)
    swaps, claimed, posed = 0, [0, 0], [0, 0]
    for r in requests + [request_frames(5, (1, FRAME_H, FRAME_W, 3)).pin_memory()]:
        got, ref = pipe0(r), plain0(r)
        swaps += check_bf16_centernet(KP_PER_LAYER, detection_deltas(
            ref.detections, got.detections, score_threshold=0.0), ref.detections)
        for i, out in enumerate((got, ref)):
            claimed[i] += int(out.keypoint_valid.sum())
            posed[i] += int(out.pose_valid.sum())

    # decode_keypoints on one per-layer forward's heads, kernel A against
    # the plain peak decode.
    with torch.inference_mode():
        img = preprocess(requests[0].to(device), (cfg.in_h, cfg.in_w), IMAGENET_MEAN,
                         IMAGENET_STDDEV, KEYPOINTS_PER_LAYER_INT8.input_dtype)
        pred = quantized_call(kp, scales, paths_of=centerpoint_calibration_paths)(img)
        proj = torch.tensor(projection, dtype=torch.float32, device=device)
        args = (pred, cfg, oc, proj, ALL_SLOTS.n_detections, ALL_SLOTS.keypoint_n_detections,
                0.0, 0.0)
        dk, dp = decode_keypoints(*args, impl="kernel"), decode_keypoints(*args, impl="plain")
    for name in ("valid", "label", "y", "x"):
        require(torch.equal(getattr(dk.detections, name), getattr(dp.detections, name)),
                f"{KP_PER_LAYER} same heads: detections.{name} differs")
    for name in ("keypoint_valid", "keypoint_y", "keypoint_x", "pose_valid"):
        require(torch.equal(getattr(dk, name), getattr(dp, name)),
                f"{KP_PER_LAYER} same heads: {name} differs")
    print(f"serve {KP_PER_LAYER}: {len(scales)} convs int8 through quantized_call (per-tensor "
          f"scales calibrated on the card, within {scale_rel:.3g} relative of the keypoint "
          f"chain's of phase 1), {KP_REQUESTS} requests x "
          f"{KP_BATCH} frames, launches {launches} (kernel A by K: {variants}, kernel C "
          f"{entries['tauv_depthwise_upsample_bf16']} bf16); decoded kernel vs plain at threshold "
          f"0 over {KP_REQUESTS} x {KP_BATCH} + 1 frames: CenterNet {swaps} top-K slots swapped, "
          f"keypoints claimed {claimed[0]} (plain {claimed[1]}), PnP solves valid {posed[0]} "
          f"(plain {posed[1]}); decode_keypoints on one forward's heads kernel A vs plain equal")

    frames = request_frames(7, (KP_BATCH, FRAME_H, FRAME_W, 3)).pin_memory()
    plain = pipes(SERVING_DECODE)[1]
    bf16_pipe, _ = keypoint_pipelines(kp_net, device, SERVING_DECODE)
    k_ms, p_ms = abba(lambda: pipe(frames), lambda: plain(frames), 3, warmup=1)
    b_ms = time_ms(lambda: bf16_pipe(frames), 3)
    busy_ms, n_kernels = device_busy(lambda: pipe(frames), reps=1)
    idle = "not measured" if busy_ms is None else f"{1 - busy_ms / k_ms:.1%}"
    print(f"time pipeline {KP_PER_LAYER} batch {KP_BATCH} (upload + bf16 preprocess + the bf16 "
          f"net with its convs int8 + decode + matcher + PnP): kernels {k_ms:.3f} ms = "
          f"{KP_BATCH * 1000 / k_ms:.2f} frames/s, plain {p_ms:.3f} ms = "
          f"{KP_BATCH * 1000 / p_ms:.2f} frames/s, the bf16 keypoints request in the same phase "
          f"{b_ms:.3f} ms = {KP_BATCH * 1000 / b_ms:.2f} frames/s; the request: {n_kernels} "
          f"device kernels and copies, busy {busy_ms} ms, the device idle {idle} ({card})")
    return launches, entries, variants


def _first_path(paths):
    return paths if paths is None or isinstance(paths, str) else paths[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="also write a torch.profiler table into DIR")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    phase_s = {}

    @contextlib.contextmanager
    def phase(name):
        start = time.perf_counter()
        yield
        phase_s[name] = round(time.perf_counter() - start, 1)
        print(f"phase {name}: {phase_s[name]} s")

    with phase("device, build, models"):
        card = device_phase()
        build_phase()
        nets, cn_cfg, yl, yl_cfg, chains = build_models(torch.device("cuda"))
        kp_net = build_keypoint_nets(torch.device("cuda"))
        kp_maps = keypoint_heatmaps(kp_net[1], kp_net[3],
                                    torch.Generator(device="cuda").manual_seed(3))
        yl_img = preprocess(request_frames(0, (N_REQUESTS, CHECK_BATCH, FRAME_H, FRAME_W, 3))[0]
                            .cuda(), (yl_cfg.in_h, yl_cfg.in_w), yl_cfg.img_mean,
                            yl_cfg.img_stddev)
        cn_chains, chain_yl_scales, kp_scales = build_chain_nets(nets, cn_cfg, yl, yl_cfg,
                                                                 kp_net, torch.device("cuda"))
    with phase("check"):
        errs, record, int8_shapes = check_phase(nets, cn_cfg, yl_cfg, chains, yl_img, kp_net,
                                                kp_maps)
        int8_shapes.update(check_chain_kernels(cn_chains, cn_cfg, yl, yl_cfg, chain_yl_scales,
                                               kp_net, kp_scales, errs))
    with phase("serve"):
        served = {path: serve_phase(path, *nets[path], cn_cfg, yl, yl_cfg, chains,
                                    nets[BF16_NETS.get(path, (None, "plain_ida"))[1]][0])
                  for path in PATHS}
        served["keypoints"] = serve_keypoints(kp_net)
        for path in CHAIN_PAIRS:
            served[path] = serve_chain_pair(path, cn_chains, nets, cn_cfg, yl, yl_cfg,
                                            chain_yl_scales)
        served[KP_INT8] = serve_keypoints_int8(kp_net, kp_scales)
        errs["mask_assembly"] = max(errs["mask_assembly"], node_phase(kp_net, yl, yl_cfg))
        report_flax_init(cn_cfg)
    for name in ("peak_decode", "mask_assembly", "depthwise_upsample", "deform_conv",
                 "transpose_conv"):
        require(any(served[path][0][name] for path in served), f"{name} never launched")
    for path, entry in (("dcn_ida", "tauv_deform_conv_f32"),
                        ("dcn_north_star", "tauv_deform_conv_bf16"),
                        ("dcn_chain_int8", "tauv_deform_conv_bf16")):
        require(served[path][1][entry] == N_REQUESTS * N_DCN, f"{path}: {entry} launches")
    with phase("time"):
        times = time_phase(nets, cn_cfg, yl, yl_cfg, chains, record, int8_shapes, card,
                           args.profile, kp_net, kp_maps)
    with phase("time_chains"):
        time_chain_paths(cn_chains, nets, cn_cfg, yl, yl_cfg, chain_yl_scales, kp_net,
                         kp_scales, card, args.profile)
    with phase("train"):
        served["train"] = train_phase(errs, card)
    with phase("train_cli"):
        served["train_cli"] = train_cli_phase(card)
    with phase("train_yolact"):
        served["train_yolact"] = train_yolact_phase(card)
    with phase("yolo_pose"):
        served["yolo_pose"], errs["mask_assembly_belief"], times["mask_assembly_belief"] = (
            yolo_pose_phase(card))
    with phase("yolo_pose_int8"):
        int8_served, b_err = yolo_pose_int8_phase(card)
    served.update(int8_served)
    errs["mask_assembly_belief"] = max(errs["mask_assembly_belief"], b_err)
    with phase("train_yolo_pose"):
        served["train_yolo_pose"] = train_yolo_pose_phase(card)
    with phase("int8_pair"):
        pair_served, pair_cns, yl_bf16 = int8_pair_phase(nets, cn_cfg, yl, yl_cfg, card)
    served.update(pair_served)
    with phase("qat"):
        served["qat"] = qat_phase(pair_cns, cn_cfg, yl_bf16, card)
    with phase("host_io"):
        served["host_io"] = host_io_phase(cn_chains, cn_cfg, yl, chain_yl_scales, card)
    with phase("bf16_pair"):
        served.update(bf16_pair_phase(nets, pair_cns, cn_cfg, yl, yl_bf16, chains, card))
    with phase("keypoints_per_layer_int8"):
        served[KP_PER_LAYER] = keypoints_per_layer_phase(kp_net, kp_scales, card)

    def launches(path, row):
        kernel, entry = ROWS[row]
        by_kernel, by_entry, by_variant = served[path]
        if row in ROW_VARIANTS:
            return by_variant.get(ROW_VARIANTS[row], 0)
        return by_kernel[kernel] if entry is None else by_entry[entry]

    # ``launches``: the served runs of all paths, each counted from 0;
    # ``launches_by_path``: each path's own run.  A row with an entry point
    # counts that entry's launches (kernel C's by dtype), a row with a
    # variant that variant's (kernel A's K = 50 row).
    report = {"kernels": [
        {"name": row, "route": "cuda", "source": KERNELS[ROWS[row][0]][0],
         "replaces": (f"tauv_vision_tpu/scripts/mosaic_op_probe.py:{P1_ROWS[row][0]}"
                      if row in P1_ROWS else KERNELS[ROWS[row][0]][1]),
         "launches": sum(launches(path, row) for path in ALL_PATHS),
         "launches_by_path": {path: launches(path, row) for path in ALL_PATHS},
         "max_abs_err": errs[row], **times[row]}
        for row in ROWS
    ]}
    print(f"phases (s): {json.dumps(phase_s)}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
