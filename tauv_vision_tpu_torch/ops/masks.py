"""YOLACT mask assembly: sigmoid(coefficients @ prototypes), optional crop.

Counterpart of ``tauv_vision_tpu/ops/masks.py`` (plain version) and of
``tauv_vision_tpu/ops/pallas/mask_assembly.py`` (``assemble_mask_cuda``,
the wrapper of ``csrc/mask_assembly.cu``).  ``pack_masks`` binarises
masks into bitmaps as ``bench.py --host-io`` publishes them
(``jnp.packbits(mask > 0.5, axis=-1)``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tauv_vision_tpu_torch import kernels
from tauv_vision_tpu_torch.ops.boxes import box_to_mask

MAX_PROTOTYPES = 32
# A byte's bits, most significant first: numpy's ``packbits`` order.
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def assemble_mask_batch(
    mask_prototype: torch.Tensor,
    mask_coeff: torch.Tensor,
    box: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version.

    Args:
      mask_prototype: [B, P, H, W], any strides
      mask_coeff: [B, K, P]
      box: optional [B, K, 4] normalised (y, x, h, w) crop boxes.
    Returns:
      [B, K, H, W] masks in [0, 1].
    """
    b, p, h, w = mask_prototype.shape
    logits = torch.bmm(mask_coeff, mask_prototype.reshape(b, p, h * w))
    mask = torch.sigmoid(logits).reshape(b, -1, h, w)
    if box is not None:
        mask = mask * box_to_mask(box, (h, w))
    return mask


def assemble_mask_cuda(
    mask_prototype: torch.Tensor,
    mask_coeff: torch.Tensor,
    box: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B: ``assemble_mask_batch`` as one CUDA op.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  All inputs f32; ``box=None`` skips the crop.  The
    prototypes are [B, P, H, W] NCHW-contiguous, or the NHWC view
    ``x.permute(0, 3, 1, 2)`` of a contiguous [B, H, W, P] ``x``, which
    the kernel reads in place.  A launch also counts under the variant
    "crop" or "no crop" (``kernels.VARIANT_LAUNCHES``)."""
    b, p, h, w = mask_prototype.shape
    k = mask_coeff.shape[1]
    if tuple(mask_coeff.shape) != (b, k, p):
        raise ValueError(
            f"mask_coeff must be [B, K, P] = [{b}, K, {p}], got "
            f"{tuple(mask_coeff.shape)}"
        )
    if box is not None and tuple(box.shape) != (b, k, 4):
        raise ValueError(f"box must be [{b}, {k}, 4], got {tuple(box.shape)}")
    if mask_prototype.device.type == "cpu":
        return assemble_mask_batch(mask_prototype, mask_coeff, box)
    if p > MAX_PROTOTYPES:
        raise ValueError(f"at most {MAX_PROTOTYPES} prototypes, got {p}")
    nhwc = not mask_prototype.is_contiguous()
    kernels.check_cuda_tensor(mask_prototype.permute(0, 2, 3, 1) if nhwc else mask_prototype,
                              "mask_prototype (NCHW, or the NHWC view)", torch.float32, 4)
    kernels.check_cuda_tensor(mask_coeff, "mask_coeff", torch.float32, 3)
    if box is not None:
        kernels.check_cuda_tensor(box, "box", torch.float32, 3)
    out = torch.empty((b, k, h, w), dtype=torch.float32,
                      device=mask_prototype.device)
    kernels.launch(
        "tauv_mask_assembly_f32", "mask_assembly",
        mask_prototype.data_ptr(), mask_coeff.data_ptr(),
        None if box is None else box.data_ptr(), out.data_ptr(),
        b, p, k, h, w, int(nhwc),
        variant="no crop" if box is None else "crop",
    )
    return out


def pack_masks(mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """``mask > threshold`` bit-packed along the last axis into uint8, as
    ``jnp.packbits`` / ``np.packbits`` do: the first element in the most
    significant bit, and the last byte zero-padded when the width is not a
    multiple of 8.  [..., W] -> [..., ceil(W / 8)], on ``mask``'s device."""
    bits = (mask > threshold).to(torch.uint8)
    pad = -bits.shape[-1] % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=mask.device)
    return (bits.unflatten(-1, (-1, 8)) * weights).sum(-1, dtype=torch.uint8)
