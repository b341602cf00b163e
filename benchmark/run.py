"""The benchmark of aten_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The run builds the cell's scene and
warms up (set-up), measures for --seconds, checks what the window
produced against the plain reference in benchmark/reference, and prints
the compared numbers with their limits as its last lines on standard
error and one JSON result as its last line on standard output.  It needs
the card: without CUDA, or with fewer cards than the cell asks for, it
exits with code 3 and prints no result.  It loads no JAX and no JAX
package: if one is loaded when the window has closed, it exits with code
4 and prints no result.  Compile caches stay in fixed directories under
build/ of the checkout.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    chips = harness.cell_spec(harness.manifest(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result, compared, ctx = harness.run_cell(args.workload, args.seed, args.seconds,
                                            bool(args.trace), "cuda:0", T_START, root=ROOT)
    except harness.guard.ForbiddenImport as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(f"benchmark: {args.workload} seed {args.seed}: {ctx.report}", file=sys.stderr)
    for name, value, limit in compared:
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
