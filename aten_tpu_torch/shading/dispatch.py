"""Material-partitioned shading dispatch.

Counterpart of aten_tpu/shading/dispatch.py, with its functions and its
gate: ATEN_TPU_PARTITION=1, read once at import, off by default, so by
default `sample_brdf` and `eval_bsdf_pdf` here are exactly the
branchless calls of shading/brdf.py, which evaluate every family the
scene uses on every lane.  With the gate on, a wavefront of at least
MIN_LANES lanes whose scene uses two or more expensive families is
sorted by material type (a stable sort), each family runs once over
exactly its contiguous segment (`used={family}`, so brdf.py's pruning
leaves that family's code alone), and the results are gathered back into
lane order.  The segment bounds come from one `bincount` read on the
host per call (a device-to-host sync, counted in "host_sync.dispatch",
utils/spans.py).  The reference's fixed-size
chunks under a `lax.scan` of `lax.switch` were XLA's static-shape form
of the same partition and are not kept: every segment here is pure, so
no mixed chunk falls back to the branchless path.  Every lane computes
the same operations as in the branchless call, so the two agree lane
for lane.
"""
from __future__ import annotations

import os

import torch

from aten_tpu_torch.scene.materials import MaterialType
from aten_tpu_torch.shading import brdf as brdf_mod
from aten_tpu_torch.utils import spans

# families whose branchless cost is trivial: partitioning pays only when
# at least two expensive families share the wavefront
_CHEAP = {
    int(MaterialType.DIFFUSE),
    int(MaterialType.SPECULAR),
    int(MaterialType.REFRACTION),
    int(MaterialType.EMISSIVE),
}

# the reference's smallest partitioned wavefront (8 chunks of 2,048 lanes)
MIN_LANES = 16384

_ENV_PARTITION = os.environ.get("ATEN_TPU_PARTITION", "0") == "1"


def worth_partitioning(used, n):
    """The static gate: partition only under ATEN_TPU_PARTITION=1, for
    scenes using two or more expensive families, at n >= MIN_LANES."""
    if used is None or not _ENV_PARTITION:
        return False
    expensive = [t for t in used if int(t) not in _CHEAP]
    return len(expensive) >= 2 and n >= MIN_LANES


def _dispatch(mat, lane_arrs, run_family):
    """Sort the lanes by mat["type"], call run_family(frozenset({t}), mat
    segment, *lane segments) -> list of [len, ...] tensors once per type
    present, and return those outputs concatenated and in lane order."""
    mtype = mat["type"]
    n = mtype.shape[0]
    perm = torch.sort(mtype, stable=True).indices
    counts = torch.bincount(mtype.long()).tolist()  # the call's one host read
    spans.count("host_sync.dispatch")
    smat = {k: v[perm] for k, v in mat.items()}
    slanes = [a[perm] for a in lane_arrs]
    outs, start = [], 0
    for fam, c in enumerate(counts):
        if c == 0:
            continue
        seg = slice(start, start + c)
        outs.append(run_family(frozenset({fam}), {k: v[seg] for k, v in smat.items()},
                               *(a[seg] for a in slanes)))
        start += c
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, device=perm.device)
    return [torch.cat(parts)[inv] for parts in zip(*outs)]


_SAMPLE_KEYS = ("wi", "pdf", "bsdf", "singular", "transmission")


def sample_brdf(scene, mat, ns, wo, u1, u2, u3, used=None):
    """brdf.sample_brdf, partitioned by material type where
    worth_partitioning says so.  `scene` is the reference's argument (its
    chunks re-gather material rows from the scene's table); the sorted
    lanes here carry their own rows, so it is not read."""
    if not worth_partitioning(used, ns.shape[0]):
        return brdf_mod.sample_brdf(mat, ns, wo, u1, u2, u3, used)

    def run_family(sub, m, ns, wo, u1, u2, u3):
        s = brdf_mod.sample_brdf(m, ns, wo, u1, u2, u3, sub)
        return [s[k] for k in _SAMPLE_KEYS]

    return dict(zip(_SAMPLE_KEYS, _dispatch(mat, [ns, wo, u1, u2, u3], run_family)))


def eval_bsdf_pdf(scene, mat, ns, wo, wi, used=None):
    """brdf.eval_bsdf_pdf (NEE's fused f and pdf), partitioned by material
    type where worth_partitioning says so."""
    if not worth_partitioning(used, ns.shape[0]):
        return brdf_mod.eval_bsdf_pdf(mat, ns, wo, wi, used)

    def run_family(sub, m, ns, wo, wi):
        return list(brdf_mod.eval_bsdf_pdf(m, ns, wo, wi, sub))

    f, pdf = _dispatch(mat, [ns, wo, wi], run_family)
    return f, pdf
