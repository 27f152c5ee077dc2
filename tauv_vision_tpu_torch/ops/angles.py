"""Two-bin angle codec (counterpart of ``tauv_vision_tpu/ops/angles.py``).

An angle, reduced modulo the per-class ``theta_range``, is mapped to
[0, 2 pi) and classified into two overlapping half-circle bins, and
regressed as (sin, cos) offsets from each bin centre.  Predictions carry
4 bin logits ([outside, inside] per bin) and 4 offsets ([sin0, cos0,
sin1, cos1]).  JAX's ``%`` is a floored modulo: ``torch.remainder``, not
``torch.fmod``.
"""

from __future__ import annotations

from math import pi
from typing import Tuple

import torch


def angle_get_bins(bin_overlap: float):
    """((centre, min, max) of bin 0, of bin 1).  Bin 0 spans the upper half
    circle, bin 1 the lower, each widened by ``bin_overlap``."""
    bin_0 = (pi / 2, -bin_overlap / 2, pi + bin_overlap / 2)
    bin_1 = (-pi / 2, -pi - bin_overlap / 2, bin_overlap / 2)
    return bin_0, bin_1


def angle_in_range(angles: torch.Tensor, range_min: float, range_max: float) -> torch.Tensor:
    """Elementwise test that an angle lies in [range_min, range_max] mod 2 pi."""
    two_pi = 2 * pi
    range_min = range_min % two_pi
    range_max = range_max % two_pi
    angles = torch.remainder(angles, two_pi)
    if range_min < range_max:
        return (range_min <= angles) & (angles <= range_max)
    return (range_min <= angles) | (angles <= range_max)


def angle_encode(truth: torch.Tensor, theta_range: torch.Tensor,
                 bin_overlap: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Targets of the two-bin codec.

    Args:
      truth: [...] angles (radians).
      theta_range: [...] the modulo of each element (2 pi, or pi/2 for a
        square-symmetric object).
    Returns:
      inside: [..., 2] int32 {0, 1} bin membership,
      offsets: [..., 2, 2] (sin, cos) offsets from each bin centre.
    """
    truth = torch.remainder(truth, theta_range)
    truth = truth * (2 * pi / theta_range)
    (c0, lo0, hi0), (c1, lo1, hi1) = angle_get_bins(bin_overlap)
    inside = torch.stack((angle_in_range(truth, lo0, hi0),
                          angle_in_range(truth, lo1, hi1)), dim=-1).to(torch.int32)
    offsets = torch.stack((
        torch.stack((torch.sin(truth - c0), torch.cos(truth - c0)), dim=-1),
        torch.stack((torch.sin(truth - c1), torch.cos(truth - c1)), dim=-1),
    ), dim=-2)
    return inside, offsets


def angle_loss(predicted_bin: torch.Tensor, predicted_offset: torch.Tensor,
               truth: torch.Tensor, theta_range: torch.Tensor,
               bin_overlap: float) -> torch.Tensor:
    """Per-element two-bin loss: cross entropy on each bin's [outside,
    inside] logits, plus L1 on the (sin, cos) offsets of the bins that hold
    the truth.

    Args:
      predicted_bin: [..., 4] logits.
      predicted_offset: [..., 4] offsets.
      truth, theta_range: [...].
    Returns:
      [...] loss.
    """
    inside, offsets = angle_encode(truth, theta_range, bin_overlap)

    def bin_ce(logits2, label):
        logp = torch.log_softmax(logits2, dim=-1)
        return -torch.gather(logp, -1, label[..., None].long())[..., 0]

    ce0 = bin_ce(predicted_bin[..., 0:2], inside[..., 0])
    ce1 = bin_ce(predicted_bin[..., 2:4], inside[..., 1])
    l1_0 = torch.abs(predicted_offset[..., 0:2] - offsets[..., 0, :]).sum(dim=-1)
    l1_1 = torch.abs(predicted_offset[..., 2:4] - offsets[..., 1, :]).sum(dim=-1)
    return ce0 + ce1 + inside[..., 0].float() * l1_0 + inside[..., 1].float() * l1_1


def angle_decode(
    predicted_bin: torch.Tensor,
    predicted_offset: torch.Tensor,
    theta_range: float,
    bin_overlap: float,
) -> torch.Tensor:
    """Pick the more confident bin, recover the angle as ``bin_centre +
    atan2(sin, cos)``, then rescale to [0, theta_range)."""
    (c0, _, _), (c1, _, _) = angle_get_bins(bin_overlap)

    score0 = torch.softmax(predicted_bin[..., 0:2], dim=-1)[..., 1]
    score1 = torch.softmax(predicted_bin[..., 2:4], dim=-1)[..., 1]
    use_bin_1 = score1 > score0

    angle0 = c0 + torch.atan2(predicted_offset[..., 0], predicted_offset[..., 1])
    angle1 = c1 + torch.atan2(predicted_offset[..., 2], predicted_offset[..., 3])

    angle = torch.where(use_bin_1, angle1, angle0)
    angle = torch.remainder(angle, 2 * pi)
    return angle * (theta_range / (2 * pi))
