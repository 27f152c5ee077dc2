"""Two-bin angle codec, the decode half (counterpart of ``angle_get_bins``,
``angle_in_range`` and ``angle_decode`` in ``tauv_vision_tpu/ops/angles.py``).

An angle, reduced modulo the per-class ``theta_range``, is mapped to
[0, 2 pi) and classified into two overlapping half-circle bins, and
regressed as (sin, cos) offsets from each bin centre.  Predictions carry
4 bin logits ([outside, inside] per bin) and 4 offsets ([sin0, cos0,
sin1, cos1]).  JAX's ``%`` is a floored modulo: ``torch.remainder``, not
``torch.fmod``.  The encode and the loss go with training.
"""

from __future__ import annotations

from math import pi

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
