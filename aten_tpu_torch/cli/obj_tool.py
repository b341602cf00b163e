"""OBJ combine and separate: the counterpart of aten_tpu/cli/obj_tool.py
(the reference's ObjCombine and ObjSeparator): merge OBJ files into one,
or split one into a file per material, written through io/obj_writer.py.
A host tool: it uses no card.

    python -m aten_tpu_torch.cli.obj_tool combine a.obj b.obj -o merged.obj
    python -m aten_tpu_torch.cli.obj_tool separate model.obj -o outdir/
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from aten_tpu_torch.io.obj_writer import write_obj


def _load_raw(path):
    """(positions [V, 3], fan-triangulated faces [F, 3], each face's
    material name) of an OBJ, read minimally."""
    pos, faces, fmtl = [], [], []
    cur = "default"
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                pos.append([float(x) for x in t[1:4]])
            elif t[0] == "usemtl":
                cur = t[1]
            elif t[0] == "f":
                idx = [int(v.split("/")[0]) - 1 for v in t[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
                    fmtl.append(cur)
    return np.asarray(pos, np.float32), np.asarray(faces), fmtl


def combine(inputs, output):
    all_pos, all_faces, all_mtl = [], [], []
    base = 0
    for p in inputs:
        pos, faces, fmtl = _load_raw(p)
        all_pos.append(pos)
        all_faces.append(faces + base)
        all_mtl += fmtl
        base += len(pos)
    names = sorted(set(all_mtl))
    ids = {n: i for i, n in enumerate(names)}
    write_obj(output, np.concatenate(all_pos), np.concatenate(all_faces),
              face_mtl=[ids[m] for m in all_mtl], mtl_names=names)
    return 0


def separate(input_path, outdir):
    pos, faces, fmtl = _load_raw(input_path)
    os.makedirs(outdir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(input_path))[0]
    names = np.asarray(fmtl)
    for name in sorted(set(fmtl)):
        sub = faces[names == name]
        used, remapped = np.unique(sub, return_inverse=True)
        write_obj(os.path.join(outdir, f"{stem}_{name}.obj"), pos[used],
                  remapped.reshape(sub.shape))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="aten_tpu_torch.cli.obj_tool")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("combine")
    c.add_argument("inputs", nargs="+")
    c.add_argument("-o", "--output", required=True)
    s = sub.add_parser("separate")
    s.add_argument("input")
    s.add_argument("-o", "--outdir", required=True)
    args = p.parse_args(argv)
    if args.cmd == "combine":
        return combine(args.inputs, args.output)
    return separate(args.input, args.outdir)


if __name__ == "__main__":
    sys.exit(main())
