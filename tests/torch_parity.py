"""Helpers shared by the port's parity tests (not a test module)."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tauv_vision_tpu import configs as jax_configs
from tauv_vision_tpu.configs import YolactModelConfig as JaxYolactModelConfig
from tauv_vision_tpu.models.yolact import Yolact as JaxYolact
from tauv_vision_tpu_torch import configs as port_configs
from tauv_vision_tpu_torch.configs import YolactModelConfig
from tauv_vision_tpu_torch.models.centernet import Prediction
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


def jax_yolact_config(cfg: YolactModelConfig) -> JaxYolactModelConfig:
    """The JAX package's copy of a port YOLACT config."""
    return JaxYolactModelConfig(**dataclasses.asdict(cfg))


def jax_yolact_train_config(tc):
    """The JAX package's copy of a port ``YolactTrainConfig``."""
    return jax_configs.YolactTrainConfig(**dataclasses.asdict(tc))


def jax_object_config(oc):
    """The JAX package's copy of a port ``ObjectConfigSet``."""
    return _convert_object_config(oc, jax_configs)


def port_object_config(oc):
    """The port's copy of a JAX ``ObjectConfigSet``."""
    return _convert_object_config(oc, port_configs)


def _convert_object_config(oc, to):
    def angle(a):
        return to.AngleConfig(train=a.train, modulo=a.modulo)

    return to.ObjectConfigSet(configs=tuple(
        to.ObjectConfig(id=c.id, yaw=angle(c.yaw), pitch=angle(c.pitch), roll=angle(c.roll),
                        train_depth=c.train_depth, train_keypoints=c.train_keypoints,
                        keypoints=c.keypoints)
        for c in oc.configs))


def jax_centernet_config(mc):
    return jax_configs.CenternetModelConfig(**dataclasses.asdict(mc))


@contextlib.contextmanager
def dcn_window(model, max_offset):
    """Every DCN of the port's ``model`` at the window ``max_offset`` inside
    the ``with``; their own windows afterwards."""
    dcns = model.deform_convs()
    saved = [m.max_offset for m in dcns]
    for m in dcns:
        m.max_offset = max_offset
    try:
        yield
    finally:
        for m, r in zip(dcns, saved):
            m.max_offset = r


@contextlib.contextmanager
def torch_threads(n):
    """torch's intra-op threads set to ``n`` inside the ``with``.  The suite
    runs one worker process a core, and torch's default of one thread a
    core in each of them oversubscribes the cores: a small op then waits
    on threads the other workers have descheduled (a CPU train step slows
    ~50x)."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# The port's CenterpointDLA34 modules that the JAX model computes and
# discards (a depth-2 tree's own projection, which its tree1 projects
# anew) and the port never runs: their gradients are 0 in both stacks, and
# in training only JAX updates their BatchNorm's running statistics, which
# no forward reads.
DISCARDED_PROJECTIONS = ("model.base.level3.project.", "model.base.level4.project.")


def jax_train_config(tc):
    """The JAX package's copy of a port ``CenternetTrainConfig``."""
    return jax_configs.CenternetTrainConfig(**dataclasses.asdict(tc))


def square_configs(in_h, in_w, all_terms=False):
    """(port ObjectConfigSet, port CenternetModelConfig) of the synthetic
    squares (``data.synthetic.square_object_config``: one class, yaw modulo
    pi/2, the 4 corners as keypoints) at in_h x in_w.  ``all_terms`` also
    trains roll (modulo 2 pi), pitch (no modulo, so 2 pi) and depth."""
    from math import pi

    from tauv_vision_tpu_torch.data.synthetic import square_object_config

    oc = square_object_config()
    if all_terms:
        oc = port_configs.ObjectConfigSet(configs=(dataclasses.replace(
            oc.configs[0], pitch=port_configs.AngleConfig(train=True, modulo=None),
            roll=port_configs.AngleConfig(train=True, modulo=2 * pi), train_depth=True),))
    mc = port_configs.CenternetModelConfig(
        in_h=in_h, in_w=in_w, backbone_heights=(2,) * 5, backbone_channels=(128,) * 6,
        downsamples=2, angle_bin_overlap=pi / 3)
    return oc, mc


PREDICTION_FIELDS = ("heatmap", "keypoint_heatmap", "keypoint_affinity", "size", "offset",
                     "roll_bin", "roll_offset", "pitch_bin", "pitch_offset", "yaw_bin",
                     "yaw_offset", "depth")


def port_prediction(prediction) -> Prediction:
    """A JAX ``Prediction``'s heads as the port's (NHWC, f32, on the CPU)."""
    def convert(a):
        return None if a is None else torch.from_numpy(np.array(a, np.float32))

    return Prediction(**{name: convert(getattr(prediction, name)) for name in PREDICTION_FIELDS})


def yolact_pair(cfg: YolactModelConfig, seed: int):
    """(JAX config, JAX model, numpy variables, port Yolact on the CPU
    holding the same weights, eval mode)."""
    jax_cfg = jax_yolact_config(cfg)
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


def random_variables(model, in_shape, seed, offset_gain=1.5, offset_bias=1.0):
    """numpy weights for a flax model, drawn from a seed in the shapes of
    its init (``jax.eval_shape``, so nothing is compiled): conv kernels
    normal with std 1/sqrt(fan_in), biases, BatchNorm parameters and
    statistics uniform; in every DCN block the offset kernel is scaled by
    ``offset_gain`` and the offset and mask biases are uniform in
    +-``offset_bias``: by default 1.5 and 1, so that offsets reach a few
    cells and some samples leave the map."""
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
            out["offset"]["kernel"] *= offset_gain
            for name in ("offset", "mask"):
                n = out[name]["bias"].shape
                out[name]["bias"] = rng.uniform(-offset_bias, offset_bias, n).astype(np.float32)
        return out

    return fill(shapes)


class ChainRecorder:
    """Record what every ``run_layer`` of a JAX chain and of the port's
    returns, by path (int8 maps as int8, float maps as f32 numpy; a path
    run again, as the YOLACT head's on each FPN level, as "path#1", ...),
    and start both from JAX's stem output: while active, the port's
    ``stem`` layer returns what JAX's returned (the one float op the port
    sums in another order).  A port run must follow a JAX run of the same
    input; ``clear()`` between pairs."""

    def __init__(self, jax_chain, port_chain, stem: str):
        self.jax_chain, self.port_chain, self.stem = jax_chain, port_chain, stem
        self.clear()

    def clear(self):
        self.maps = {"jax": {}, "port": {}}
        self.stems = {}

    @staticmethod
    def _numpy(y):
        if isinstance(y, torch.Tensor):
            return y.numpy().copy() if y.dtype == torch.int8 else y.float().numpy()
        return np.asarray(y) if y.dtype == jnp.int8 else np.asarray(y.astype(jnp.float32))

    def _wrap(self, run_layer, side):
        def run(ctx, inp, path, **kwargs):
            y = run_layer(ctx, inp, path, **kwargs)
            if path == self.stem:
                self.stems[side] = self._numpy(y)
                if side == "port":
                    y = torch.from_numpy(self.stems["jax"].copy()).to(y.dtype)
            maps, key, n = self.maps[side], path, 0
            while key in maps:
                n += 1
                key = f"{path}#{n}"
            maps[key] = self._numpy(y)
            return y
        return run

    def __enter__(self):
        self._saved = (self.jax_chain.ChainCtx.run_layer, self.port_chain.ChainCtx.run_layer)
        self.jax_chain.ChainCtx.run_layer = self._wrap(self._saved[0], "jax")
        self.port_chain.ChainCtx.run_layer = self._wrap(self._saved[1], "port")
        return self

    def __exit__(self, *exc):
        self.jax_chain.ChainCtx.run_layer, self.port_chain.ChainCtx.run_layer = self._saved
