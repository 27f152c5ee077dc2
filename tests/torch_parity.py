"""Helpers shared by the port's parity tests (not a test module)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tauv_vision_tpu.configs import YolactModelConfig as JaxYolactModelConfig
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu_torch.configs import YolactModelConfig
from tauv_vision_tpu_torch.models.yolact import Yolact
from tauv_vision_tpu_torch.weights import yolact_state_dict_from_flax

# The small YOLACT of tests/test_quantize_chain.py.
SMALL_YOLACT = dict(
    in_w=64, in_h=64, feature_depth=16, n_classes=2, n_prototype_masks=4,
    n_masknet_layers_pre_upsample=1, n_masknet_layers_post_upsample=1,
    n_prediction_head_layers=1, n_classification_layers=0,
    n_box_layers=0, n_mask_layers=0, n_fpn_downsample_layers=2,
    anchor_scales=(12, 24, 48, 96, 192), anchor_aspect_ratios=(1.0,),
    box_variances=(0.1, 0.2), iou_pos_threshold=0.5,
    iou_neg_threshold=0.4, negative_example_ratio=3,
)


def yolact_pair(cfg: YolactModelConfig, seed: int):
    """(JAX config, JAX model, numpy variables, port Yolact on the CPU
    holding the same weights, eval mode)."""
    jax_cfg = JaxYolactModelConfig(**dataclasses.asdict(cfg))
    jax_model = JaxYolact(jax_cfg)
    variables = random_variables(jax_model, (1, cfg.in_h, cfg.in_w, 3), seed)
    port = Yolact(cfg, device="cpu").eval()
    port.load_state_dict(yolact_state_dict_from_flax(variables))
    return jax_cfg, jax_model, variables, port


def upsample_scales(port, batches):
    """Per-input-channel scales of the protonet's two transposed convs,
    by ``calibrate``'s rule (max(absmax, 1e-6) / 127 over the batches of
    the f32 forward), which ``calibrate`` itself does not record."""
    absmax = {}

    def recorder(path):
        def hook(module, args):
            value = args[0].abs().amax(dim=(0, 2, 3)).double().cpu().numpy()
            absmax[path] = np.maximum(absmax.get(path, value), value)
        return hook

    hooks = [getattr(port._masknet, f"_upsample_layer_{i}").register_forward_pre_hook(
        recorder(f"protonet/upsample_{i}")) for i in (1, 2)]
    try:
        with torch.inference_mode():
            for batch in batches:
                port(batch)
    finally:
        for h in hooks:
            h.remove()
    return {path: np.maximum(v, 1e-6) / 127.0 for path, v in absmax.items()}


def random_variables(model, in_shape, seed):
    """numpy weights for a flax model, drawn from a seed in the shapes of
    its init (``jax.eval_shape``, so nothing is compiled): conv kernels
    normal with std 1/sqrt(fan_in), biases, BatchNorm parameters and
    statistics uniform; in every DCN block the offset kernel is scaled by
    1.5 and the offset and mask biases are uniform in +-1, so that offsets
    reach a few cells and some samples leave the map."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros(in_shape), train=False))
    draw = {
        "kernel": lambda s: rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])),
        "weight": lambda s: rng.standard_normal(s) / np.sqrt(np.prod(s[:-1])),
        "bias": lambda s: rng.uniform(-0.1, 0.1, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "mean": lambda s: rng.uniform(-0.3, 0.3, s),
        "var": lambda s: rng.uniform(0.5, 1.5, s),
    }

    def fill(node):
        out = {k: fill(v) if isinstance(v, dict)
               else draw[k](v.shape).astype(np.float32) for k, v in node.items()}
        if "offset" in out and "weight" in out:
            out["offset"]["kernel"] *= 1.5
            for name in ("offset", "mask"):
                n = out[name]["bias"].shape
                out[name]["bias"] = rng.uniform(-1, 1, n).astype(np.float32)
        return out

    return fill(shapes)
