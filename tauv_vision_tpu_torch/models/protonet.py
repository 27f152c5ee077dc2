"""Prototype mask network (counterpart of ``tauv_vision_tpu/models/protonet.py``).

Conv stacks around two 2x transposed-conv upsamples
(``ConvTranspose2d(k=3, s=2, p=1, output_padding=1)``), leaky-relu after
every layer including the 1x1 output layer.  Reference ``_masknet`` names.
Every layer computes in ``dtype``; the prototypes come out f32, as JAX's.
"""

from __future__ import annotations

import torch
from torch import nn

from tauv_vision_tpu_torch.models.layers import Conv2d, ConvTranspose2d, LeakyReLU


def _conv_stack(depth: int, count: int, dtype) -> nn.ModuleList:
    return nn.ModuleList(
        nn.Sequential(Conv2d(depth, depth, 3, padding=1, compute_dtype=dtype), LeakyReLU())
        for _ in range(count)
    )


class Protonet(nn.Module):
    def __init__(self, feature_depth: int, n_prototype_masks: int,
                 n_layers_pre_upsample: int = 1, n_layers_post_upsample: int = 1,
                 dtype=torch.float32):
        super().__init__()
        d = feature_depth
        self._layers_1 = _conv_stack(d, n_layers_pre_upsample, dtype)
        self._upsample_layer_1 = ConvTranspose2d(d, d, 3, 2, 1, output_padding=1,
                                                 compute_dtype=dtype)
        self._layers_2 = _conv_stack(d, n_layers_post_upsample, dtype)
        self._upsample_layer_2 = ConvTranspose2d(d, d, 3, 2, 1, output_padding=1,
                                                 compute_dtype=dtype)
        self._layers_3 = _conv_stack(d, n_layers_post_upsample, dtype)
        self._output_layer = Conv2d(d, n_prototype_masks, 1, compute_dtype=dtype)
        self.act = LeakyReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, d, h, w] -> [B, P, 4h, 4w] f32 prototypes (NCHW)."""
        for layer in self._layers_1:
            x = layer(x)
        x = self.act(self._upsample_layer_1(x))
        for layer in self._layers_2:
            x = layer(x)
        x = self.act(self._upsample_layer_2(x))
        for layer in self._layers_3:
            x = layer(x)
        return self.act(self._output_layer(x)).to(torch.float32)
