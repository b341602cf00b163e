"""The reference's inverse-rendering step: one sample a pixel of the whole
image, an L2 loss against the target, autograd gradients of the trained
fields, and the RMS-normalised update p - lr g / rms(g), albedos clipped
at 0 (the program's step, parallel/mesh.py, on one process).
"""
from __future__ import annotations

import torch

from benchmark.reference.pathtrace import trace

FIELDS = {"base_color": ("materials", "base_color"), "lights.le": ("lights", "le")}


def with_params(scene, params):
    tables = {"materials": dict(scene["materials"]), "lights": dict(scene["lights"])}
    for k, v in params.items():
        group, field = FIELDS[k]
        tables[group][field] = v
    return scene.with_fields(materials=tables["materials"], lights_=tables["lights"])


def get_params(scene, fields):
    return {k: scene[FIELDS[k][0]][FIELDS[k][1]] for k in fields}


def steps(scene, cam, target, frames, spp, max_depth, rr_depth, lr, start, fault=None):
    """Run one step per frame in `frames` from the fields `start`
    ({field: tensor}).  Returns {"loss": [floats], "params": [start, then
    the fields after each step]}.  fault, to measure how the check reads a
    broken step: "half" (the loss over the top half of the rows only) or
    "alter" (each step's update of the first trained value off by lr, as
    if its normalised gradient were off by 1: an answer altered where it is
    produced)."""
    h, w = cam["height"], cam["width"]
    dev = target.device
    if fault == "half":
        h = h // 2
        target = target[:h]
    pix = torch.arange(h * w, device=dev)
    zero = torch.zeros_like(pix)
    params = {k: v.detach() for k, v in start.items()}
    out = {"loss": [], "params": [params]}
    for frame in frames:
        leaf = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        rad = trace(with_params(scene, leaf), cam, pix % w, pix // w, int(frame), zero, spp,
                    max_depth, rr_depth)
        loss = torch.mean((rad.reshape(h, w, 3) - target) ** 2)
        grads = torch.autograd.grad(loss, list(leaf.values()), allow_unused=True)
        new = {}
        for (k, p), g in zip(leaf.items(), grads):
            g = torch.zeros_like(p) if g is None else g
            rms = torch.sqrt(torch.mean(g * g) + 1e-12)
            q = p.detach() - lr * g / rms
            new[k] = torch.clamp(q, min=0.0) if k.endswith("base_color") else q
        if fault == "alter":
            k = next(iter(new))
            new[k] = (new[k].flatten() + lr * (torch.arange(new[k].numel(), device=dev) == 0)
                      ).reshape(new[k].shape)
        out["loss"].append(float(loss.detach()))
        out["params"].append(new)
        params = new
    return out
