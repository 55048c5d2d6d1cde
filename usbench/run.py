"""Run one cell of the benchmark once and print its result line.

    python3 -m usbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. Loads and warms up the cell (its inputs made on
the card from the seed), measures for ``--seconds``, checks a sample of
the requests drawn from the seed against the plain reference, and prints
the numbers compared beside their limits as the last lines of standard
error and one JSON object as the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last. Exits 1, printing no result, without a CUDA card (or with
fewer than the cell asks for), and where the process holds JAX or the JAX
package once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(__file__).resolve().parent / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "qups_tpu")


def use_checkout_caches():
    """Kernel and build caches at fixed paths inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()

    import torch

    from usbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"usbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out, errors = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda", 0), T_START)
    bad = forbidden_modules()
    if bad:
        print(f"usbench: the process holds {', '.join(bad)}; no result", file=sys.stderr)
        return 1
    for e in errors[:5]:
        print(f"usbench: {e}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
