"""Probe: does ``torch.func.jacrev`` under ``vmap`` give PnP's Jacobian on
this device, in each autograd mode?

    python -m tauv_vision_tpu_torch.scripts.jacrev_probe [--device cpu]

PnP (``ops/pnp.py``) takes its residual's Jacobian written out by hand
(``pnp._jacobian``).  This script holds that Jacobian against
``vmap(jacrev(residual))`` of the same residual, at w = 0 (where
``so3_exp`` switches to its series) and at random w, under plain autograd,
``torch.no_grad`` and ``torch.inference_mode``.  Then it runs
``solve_pnp_batch`` on exact synthetic poses twice in each mode, once with
the analytic Jacobian and once with jacrev's in its place, and reports how
far each lands from the truth.  Prints the device's name (with the card's
power limit on CUDA) and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from tauv_vision_tpu_torch.ops import pnp
from tauv_vision_tpu_torch.ops.se3 import so3_exp

N_PROBLEMS = 160      # the PnP problems of a batch-16 keypoint request
N_POINTS = 8
CAMERA = ((520.0, 0.0, 320.0), (0.0, 520.0, 180.0), (0.0, 0.0, 1.0))
MODES = {"autograd": contextlib.nullcontext, "no_grad": torch.no_grad,
         "inference_mode": torch.inference_mode}


def jacrev_jacobian(params, object_points, pts, mask, fx, fy):
    """``pnp._jacobian``'s contract through ``vmap(jacrev)``: the principal
    point and the observations shift the residual by constants, so they
    drop out of its derivative."""
    def residual(p, x, m):
        cam = x @ so3_exp(p[:3]).mT + p[3:]
        return (pnp._project(cam, fx, fy, 0.0, 0.0) * m[:, None]).reshape(-1)

    return torch.func.vmap(torch.func.jacrev(residual))(params, object_points, mask)


def problems(device):
    """(object points, image points, camera, mask, rotation, translation)
    of N_PROBLEMS exact correspondences of known poses."""
    rng = np.random.default_rng(0)
    obj = rng.uniform(-0.2, 0.2, (N_PROBLEMS, N_POINTS, 3))
    w = rng.normal(size=(N_PROBLEMS, 3)) * 0.4
    t = np.stack([rng.uniform(-0.2, 0.2, N_PROBLEMS), rng.uniform(-0.1, 0.1, N_PROBLEMS),
                  rng.uniform(1.0, 3.0, N_PROBLEMS)], -1)
    r = so3_exp(torch.from_numpy(w)).numpy()
    pts = np.einsum("nij,npj->npi", r, obj) + t[:, None]
    cam = np.asarray(CAMERA)
    uv = np.stack([cam[0, 0] * pts[..., 0] / pts[..., 2] + cam[0, 2],
                   cam[1, 1] * pts[..., 1] / pts[..., 2] + cam[1, 2]], -1)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (obj, uv, cam, np.ones((N_PROBLEMS, N_POINTS)), r, t))


def probe(device) -> dict:
    obj, uv, cam, mask, r_true, t_true = problems(device)
    fx, fy = cam[0, 0], cam[1, 1]
    gen = torch.Generator().manual_seed(1)
    params = {"w0": torch.cat([torch.zeros(N_PROBLEMS, 3),
                               torch.rand((N_PROBLEMS, 3), generator=gen) + 1.0], -1),
              "w_random": torch.randn((N_PROBLEMS, 6), generator=gen) * 0.5
              + torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 2.0])}
    out = {}
    for mode, ctx in MODES.items():
        row = {}
        for name, p in params.items():
            p = p.to(device)
            with ctx():
                pts = pnp._camera_points(p, obj)
                want = pnp._jacobian(p, obj, pts, mask, fx, fy)
                try:
                    got = jacrev_jacobian(p, obj, pts, mask, fx, fy)
                except RuntimeError as e:   # a mode that refuses the transform
                    row[f"jacobian_{name}"] = f"raised: {str(e).splitlines()[0][:160]}"
                    continue
            row[f"jacobian_{name}_max_abs_diff"] = (got - want).abs().max().item()
            row[f"jacobian_{name}_max_abs"] = want.abs().max().item()
            row[f"jacobian_{name}_jacrev_max_abs"] = got.abs().max().item()
        for route, jac in (("analytic", pnp._jacobian), ("jacrev", jacrev_jacobian)):
            pnp._jacobian, analytic = jac, pnp._jacobian
            try:
                with ctx():
                    res = pnp.solve_pnp_batch(obj, uv, cam, mask > 0)
                row[f"solve_{route}_translation_err_m"] = (
                    (res.translation - t_true).abs().max().item())
                row[f"solve_{route}_rotation_err"] = (res.rotation - r_true).abs().max().item()
                row[f"solve_{route}_valid"] = int(res.valid.sum().item())
            except RuntimeError as e:
                row[f"solve_{route}"] = f"raised: {str(e).splitlines()[0][:160]}"
            finally:
                pnp._jacobian = analytic
        out[mode] = row
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("jacrev_probe: no CUDA device (pass --device cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip())
    print(json.dumps({"torch": torch.__version__, "device": str(device),
                      "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                      "problems": N_PROBLEMS, "modes": probe(device)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
