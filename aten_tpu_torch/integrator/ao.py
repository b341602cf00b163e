"""Ambient-occlusion renderer.

Counterpart of aten_tpu/integrator/ao.py (the reference's AORenderer,
renderer/ao/aorenderer.h:13-37 and libidaten/ao/ao.cu): a primary hit,
then `num_rays` cosine-hemisphere occlusion rays limited to the AO
radius; the visible fraction is the pixel's value.  Past the first hit
every ray is an any-hit walk, on the scene's device; `impl` selects the
traversal (accel/traverse.py).
"""
from __future__ import annotations

import torch

from aten_tpu_torch.accel.traverse import occluded, traverse
from aten_tpu_torch.core import camera as cam_mod
from aten_tpu_torch.core import sampler as smp
from aten_tpu_torch.integrator.pathtracer import eval_hit
from aten_tpu_torch.shading import brdf as brdf_mod


def render_ao_sample(scene, cam_arrays, width, height, frame, sample, spp=1, num_rays=4,
                     ao_radius=1.0, impl="auto"):
    """One sample's AO image [height, width, 3] (grey)."""
    dev = scene.device
    N = width * height
    pix = torch.arange(N, dtype=torch.int64, device=dev)
    px = (pix % width).to(torch.float32)
    py = (pix // width).to(torch.float32)
    pixel_seed = smp.wang_hash(pix + 1)
    state = smp.make_state(pixel_seed, frame, sample, spp, bounce=0)
    ju, jv, state = smp.next_2d(state)
    s = (px + ju) / width
    t = (float(height - 1) - py + jv) / height
    ro, rd = cam_mod.generate_ray(cam_arrays, s, t)

    hit = traverse(scene, ro, rd, impl=impl)
    h = eval_hit(scene, ro, rd, hit)
    n = brdf_mod.orient_normal(h["ns"], -rd)

    radius = torch.full((N,), ao_radius, dtype=torch.float32, device=dev)
    vis = torch.zeros((N,), dtype=torch.float32, device=dev)
    for _ in range(num_rays):
        u1, u2, state = smp.next_2d(state)
        wi, _ = brdf_mod._cos_hemisphere_sample(n, u1, u2)
        blocked = occluded(scene, h["p"] + n * 1e-3, wi, radius, impl=impl)
        vis = vis + torch.where(blocked, 0.0, 1.0)
    ao = vis / num_rays
    ao = torch.where(hit["hit"], ao, 1.0)
    return ao.reshape(height, width, 1).repeat(1, 1, 3)


def render_ao(scene, cam, spp=4, num_rays=4, ao_radius=1.0, frame=0, impl="auto"):
    """The AO image [H, W, 3] of camera `cam`, averaged over spp samples."""
    ca = cam.arrays(scene.device)
    acc = torch.zeros((cam.height, cam.width, 3), dtype=torch.float32, device=scene.device)
    for s in range(spp):
        acc = acc + render_ao_sample(scene, ca, cam.width, cam.height, frame, s, spp,
                                     num_rays, ao_radius, impl=impl)
    return acc / spp
