"""``python -m tauv_vision_tpu_torch.scripts.dryrun_multichip --ranks 2
--device cpu``, the port's counterpart of ``__graft_entry__.dryrun_multichip``
without its 2-D mesh, and its DLA-34 steps held to the port's
single-process steps.

- (f) ``main`` prints ``dryrun_multichip(2): ok, dla34_dp_loss=...,
  dla34_dcn_dp_loss=..., yolact_dp_loss=..., dp_infer_checksum=...
  (single-device ...)``: each DP loss within 1e-4 of the single-process
  loss on the global batch and the DP inference checksum within 1e-3 of
  the single-process one (its own checks; it raises otherwise).
- (d) The plain-IDA and DCN ``CenterpointDLA34`` at 64x64 (the dryrun's
  flagship: one class, yaw and depth trained; the DCN with the offset
  penalty on, lambda 1 and range 1) on 2 ranks at global batch 2: every
  loss term within 1e-5 relative of the single-process step's, every
  rank's losses equal, and the summed gradients and the BatchNorm running
  statistics by ``test_torch_data_parallel.py``'s yardstick (1e-4 and
  1e-5, or 4x the single-process step's own move under an input scale of
  1 + 1e-6, reversed rows or convs off oneDNN).  The DLA-34 at 64x64 in
  training is chaotic: BatchNorm on batch statistics over 2x2 maps at
  its deepest level; with the DCN's offsets a few cells long, the single
  step's gradients move by ~1e-1 (median) under the input scale, ~2e-2
  in DP.  The dryrun's DCN offsets are 0 at the
  flax init, so its penalty is 0; the test runs the DCN step once more
  with offset convs drawn so that the offsets reach a few cells (LeCun
  normal x 1.5, biases uniform in +-1, as ``torch_parity.random_variables``
  draws JAX's), where the penalty is positive and its element count is
  the global batch's.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from tauv_vision_tpu_torch.parallel.distributed import spawn
from tauv_vision_tpu_torch.scripts import dryrun_multichip
from test_torch_data_parallel import assert_grads_and_stats, assert_losses, single
from torch_parity import torch_threads

RANKS = 2
OFFSET_GAIN, OFFSET_BIAS = 1.5, 1.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def dryrun():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = dryrun_multichip.main(["--ranks", str(RANKS), "--device", "cpu"], grads=True)
    return out.getvalue(), result


def test_torch_dryrun_multichip_prints_its_ok_line(dryrun):
    printed, result = dryrun
    lines = printed.strip().splitlines()
    assert lines[-1] == result["line"]
    assert lines[-1].startswith(f"dryrun_multichip({RANKS}): ok, dla34_dp_loss=")
    for key in ("dla34_dcn_dp_loss=", "yolact_dp_loss=", "dp_infer_checksum=",
                "(single-device "):
        assert key in lines[-1]
    values = [float(v.split("=")[1].rstrip(",")) for v in lines[-1].split() if "=" in v]
    assert len(values) == 4 and np.isfinite(values).all()


def with_offsets(job):
    """``job`` with its DCN blocks' offsets reaching a few cells."""
    rng = np.random.default_rng(0)
    weights = dict(job.state_dict)
    for key, value in job.state_dict.items():
        if ".offset." not in key:
            continue
        if key.endswith("weight"):
            fan_in = value[0].numel()
            draw = rng.normal(0.0, OFFSET_GAIN / np.sqrt(fan_in), tuple(value.shape))
        else:
            draw = rng.uniform(-OFFSET_BIAS, OFFSET_BIAS, tuple(value.shape))
        weights[key] = torch.from_numpy(draw.astype(np.float32))
    return dataclasses.replace(job, name=job.name + "_offsets", state_dict=weights)


def test_torch_dryrun_plain_dla34_step_matches_one_process(dryrun):
    _, result = dryrun
    i = [job.name for job in result["jobs"]].index("dla34_dp_loss")
    job, dp = result["jobs"][i], result["dp"][i]
    one, moved = single(job)
    assert one["losses"] == result["single"][i]["losses"]
    assert_losses(None, [dp], one, moved)
    assert_grads_and_stats(dp, one, moved)


def test_torch_dryrun_dcn_dla34_step_matches_one_process(dryrun):
    _, result = dryrun
    i = [job.name for job in result["jobs"]].index("dla34_dcn_dp_loss")
    assert result["dp"][i]["losses"]["dcn_offset"] == 0.0
    job = with_offsets(result["jobs"][i])
    assert job.configs[1].loss_lambda_dcn_offset == 1.0
    ranks = [r[0] for r in spawn(dryrun_multichip.rank_jobs, RANKS, [job])]
    one, moved = single(job)
    assert one["losses"]["dcn_offset"] > 0
    assert_losses(None, ranks, one, moved)
    assert_grads_and_stats(ranks[0], one, moved)
