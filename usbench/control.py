"""The readings a cell's limits are set from, in one process on the card.

    python3 -m usbench.control --workload <cell> --seeds 11 12 ... --control-seeds 3 [--seconds 3]

For each seed of ``--seeds``: the program's reading, a short window of the
cell's own traffic checked as a run checks it (``image_err``, the worst
sampled request). For the first ``--control-seeds`` seeds also the
control's reading (``usbench/check.py``: the entry's own lower-precision
path, or the plain reference on taps rounded to the traffic's ``control``
precision, in the program's place), on the same inputs and pixels. One
JSON line a seed, then one with the largest program reading and the
smallest control reading. The benchmark's runs never run this.
"""
import argparse
import json
import sys
import time


def control_reading(cell, inputs, idx, device, requests: int = 4) -> float:
    """The control's image_err, the worst over the first ``requests``
    inputs (each resident input, or the first clouds)."""
    from usbench import check

    worst = 0.0
    for i in range(min(requests, len(inputs))):
        ref = check.reference(cell, inputs[i], idx, device)
        worst = max(worst, check.image_err(check.control(cell, inputs[i], idx, device), ref))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from usbench.run import use_checkout_caches
    use_checkout_caches()

    import torch

    from usbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("usbench.control: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    prog, ctl = [], []
    for k, seed in enumerate(args.seeds):
        t = time.perf_counter()
        run, inputs, idx, values, _ = harness.measure(cell, seed, args.seconds, False, dev, t)
        torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        checks, _ = harness.judge(cell, inputs, idx, values, dev)
        line = {"seed": seed, "requests": len(run.requests), "checked": len(values),
                "errors": run.errors[:2], "program_image_err": checks["image_err"]["value"],
                "reference_s": time.perf_counter() - t_ref}
        prog.append(line["program_image_err"])
        if k < args.control_seeds:
            line["control_image_err"] = control_reading(cell, inputs, idx, dev)
            ctl.append(line["control_image_err"])
        del inputs, values
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload, "lower": max(prog),
                      "upper": min(ctl) if ctl else None, "seeds": len(prog),
                      "control_seeds": len(ctl), "card": torch.cuda.get_device_name(dev)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
