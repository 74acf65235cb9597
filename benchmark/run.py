"""Runs one cell of the benchmark and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics (a profiled sub-window).
Every run checks what its timed path produced against the plain
reference (reference/) after the window, prints each number compared
beside its limit as the last lines of standard error, and prints the
result as the last line of standard output.  It exits nonzero with no
result without the CUDA cards the cell asks for, and when the process
holds a module of JAX or of the JAX package once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
sys.path[:0] = [str(HERE), str(REPO)]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def measure(conf, seed: int, seconds: float, trace: bool, device):
    """Runs the cell ``conf`` on ``device``: ``(result, compared)``."""
    import torch

    from harness import checks, registry, roofline
    from harness import trace as trace_lib
    from harness.spans import OFF, Recorder

    recorder = Recorder() if trace else OFF
    out = registry.driver(conf["traffic"]["driver"]).run(
        conf, seed, seconds, trace, device, recorder)
    metrics = {}
    if trace:
        ctx = {"conf": conf, "out": out, "trace": out["trace"],
               "spans": recorder.spans, "flops": registry.flops(conf),
               "roofline": roofline}
        for m in conf["per_layer"]:
            value = registry.layer_metric(conf, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["setup_done"] - T_START)
        for m in conf["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    cuda = device.type == "cuda"
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else device.type),
                   "count": conf["workload"]["chips"],
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    extra = {}
    if out["trace"] is not None:
        device_info.update(busy_s=out["trace"].busy_s,
                           window_s=out["trace"].window_s)
        extra["breakdown"] = trace_lib.breakdown(out["trace"])
    correct, compared = checks.judge(out["readings"],
                                     conf["cell"]["limits"])
    print(f"benchmark: readings {out['readings']}", file=sys.stderr)
    return ({"correct": correct, "attempted": out["attempted"],
             "failed": out["failed"], "metrics": metrics,
             "device": device_info, **extra}, compared)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a whole number >= 0")

    import torch

    from harness import registry, report

    conf = registry.spec(REPO, args.workload)
    chips = conf["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    print(f"benchmark: {args.workload} seed {args.seed} on {card_line()}",
          file=sys.stderr)
    result, compared = measure(conf, args.seed, args.seconds,
                               bool(args.trace), device)
    return report.emit(result, compared)


if __name__ == "__main__":
    sys.exit(main())
