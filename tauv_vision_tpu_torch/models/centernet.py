"""CenterNet prediction container (counterpart of ``Prediction`` in
``tauv_vision_tpu/models/centernet.py``).

Fields are NHWC like the JAX package's, so tests compare like with like.
The model fills them with NHWC views of its NCHW head outputs, so
``heatmap_nchw()`` gives back the contiguous NCHW tensor at no cost.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Prediction:
    heatmap: torch.Tensor                       # [B, H, W, n_labels] logits
    keypoint_heatmap: Optional[torch.Tensor]    # [B, H, W, n_keypoints]
    keypoint_affinity: Optional[torch.Tensor]   # [B, H, W, n_keypoints, 2]

    size: torch.Tensor                          # [B, H, W, 2]
    offset: torch.Tensor                        # [B, H, W, 2]

    roll_bin: Optional[torch.Tensor] = None     # [B, H, W, 4]
    roll_offset: Optional[torch.Tensor] = None
    pitch_bin: Optional[torch.Tensor] = None
    pitch_offset: Optional[torch.Tensor] = None
    yaw_bin: Optional[torch.Tensor] = None
    yaw_offset: Optional[torch.Tensor] = None

    depth: Optional[torch.Tensor] = None        # [B, H, W, 1]

    def heatmap_nchw(self) -> torch.Tensor:
        return self.heatmap.permute(0, 3, 1, 2)

    def keypoint_heatmap_nchw(self) -> torch.Tensor:
        return self.keypoint_heatmap.permute(0, 3, 1, 2)
