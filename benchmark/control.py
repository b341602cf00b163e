"""The control of `correct`: the plain reference in a lower precision, or
with a planted fault, put in the program's place, judged as a run judges
the program.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--mode bf16,family]

Render cells: the sampled pixels of `--images` images per seed, traced by
the reference in bfloat16 (the configuration states float32; --mode
bf16), or in float32 with the value f(wo, wi) of one BSDF family scaled
by 0.9 (--mode family --family VELVET: a fault confined to one family),
against the reference in float32.  Train cells: the checked steps of the
reference in bfloat16 (--mode bf16), or in float32 with the loss over
half of the rows (--mode half) or each update of the first trained
value off by lr (--mode alter), against the reference in float32.
Prints one JSON line a seed with each compared number and its limit.
The benchmark's own runs do not run this; it gives the upper readings
of the limits (PERF.md).
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FAMILY_SCALE = 0.9
_REFERENCE = {}  # the float32 reference of (cell, seed, images), read by several controls


@contextlib.contextmanager
def scaled_family(mod, mtype, factor=FAMILY_SCALE):
    """Within the block, the BSDF module `mod` (the reference's or the
    program's: both define `eval_bsdf_pdf` and `sample_brdf`) gives
    materials of type `mtype` the value f(wo, wi) times `factor`, in NEE
    and in the sampled bounce alike; singular families through their
    sampled weight.  Pdfs and directions are unchanged."""
    import torch

    ev, sm = mod.eval_bsdf_pdf, mod.sample_brdf

    def scale(mat, f):
        return torch.where((mat["type"] == int(mtype))[..., None], f * factor, f)

    def eval_bsdf_pdf(mat, ns, wo, wi, used=None):
        f, pdf = ev(mat, ns, wo, wi, used)
        return scale(mat, f), pdf

    def sample_brdf(mat, *args, **kw):
        out = dict(sm(mat, *args, **kw))  # its f comes through eval_bsdf_pdf above
        out["bsdf"] = torch.where(out["singular"][..., None], scale(mat, out["bsdf"]),
                                  out["bsdf"])
        return out

    mod.eval_bsdf_pdf, mod.sample_brdf = eval_bsdf_pdf, sample_brdf
    try:
        yield
    finally:
        mod.eval_bsdf_pdf, mod.sample_brdf = ev, sm


def control_numbers(name, seed, mode, images, device, workload=None, config=None,
                    family="VELVET"):
    """[(name, value, limit)] of the control on cell `name` and `seed`."""
    import torch

    from benchmark import compare, harness
    from benchmark.entries import train as train_entry

    man = harness.manifest(ROOT)
    spec = harness.cell_spec(man, name)
    bench = os.path.join(ROOT, "benchmark")
    w = workload or harness.load_json(os.path.join(bench, "workloads", name + ".json"))
    c = config or harness.load_json(os.path.join(bench, "configs", spec["config"] + ".json"))
    low = torch.bfloat16
    if w["entry"] == "render":
        if mode not in ("bf16", "family"):
            raise ValueError(f"a render cell's control is bf16 or family, not {mode!r}")
        n_pix = w["width"] * w["height"]
        per = w["check"]["pixels_per_image"]
        pix = torch.cat([torch.from_numpy(compare.sample_pixels(seed, i, n_pix, per))
                         for i in range(images)])
        img = torch.repeat_interleave(torch.arange(images), pix.numel() // images)
        frames = seed + img.to(torch.int64)
        key = (seed, images, json.dumps([w, c], sort_keys=True), str(device))
        if key not in _REFERENCE:
            _REFERENCE[key] = compare.reference_pixels(c, w, pix, frames, device)
        ref = _REFERENCE[key]
        if mode == "bf16":
            prog = compare.reference_pixels(c, w, pix, frames, device, dtype=low)
        else:
            from benchmark.reference import bsdf

            with scaled_family(bsdf, bsdf.MATERIAL_TYPES[family]):
                prog = compare.reference_pixels(c, w, pix, frames, device)
        numbers, _ = compare.render_numbers(prog, ref, img, w["check"]["pixel_rel_tol"])
    else:
        factor = train_entry.start_scale(seed, w["start_scale"])
        key = (seed, json.dumps([w, c], sort_keys=True), str(device))
        if key not in _REFERENCE:
            _REFERENCE[key] = train_entry.reference_steps(c, w, seed, device, factor)
        ref = _REFERENCE[key]
        if mode == "bf16":
            prog = train_entry.reference_steps(c, w, seed, device, factor, dtype=low)
        else:
            prog = train_entry.reference_steps(c, w, seed, device, factor, fault=mode)
        numbers = compare.train_numbers(prog, ref, w["lr"])
    return compare.with_limits(numbers, w["check"]["limits"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="bf16",
                    help="bf16, half, alter or family; comma-separated for several")
    ap.add_argument("--family", default="VELVET",
                    help="with --mode family: the material type whose f is scaled; "
                         "comma-separated for several, one reading each")
    ap.add_argument("--images", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [(m, f) for m in args.mode.split(",")
            for f in (args.family.split(",") if m == "family" else [None])]
    if any(m not in ("bf16", "half", "alter", "family") for m, _ in runs):
        ap.error(f"unknown mode in {args.mode!r}")
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode, family in runs:
            t = time.time()
            numbers = control_numbers(args.workload, seed, mode, args.images, "cuda:0",
                                      family=family)
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "family": family, "seconds": time.time() - t,
                              "compared": {n: {"value": v, "limit": lim}
                                           for n, v, lim in numbers}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
