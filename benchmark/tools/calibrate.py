"""Readings that the cells' limits and rates are set from (run on the
card; the benchmark's own runs never run this).

    python3 benchmark/tools/calibrate.py train --workload <cell> \
        --seeds 1,2,... [--controls 7,8,9]
    python3 benchmark/tools/calibrate.py serve --workload <cell> \
        --seeds 1,2,... [--controls 7,8,9] [--seconds 10]
    python3 benchmark/tools/calibrate.py sweep --workload <cell> \
        --rates 1000,2000,... [--seconds 15]

``train``: for each seed, the program's first steps against the
reference (the lower readings); for each control seed, the reference in
float8 in the program's place and the reference with half of each
microbatch left out, each against the float32 reference (the upper
readings).  ``serve``: for each seed, a window of the cell's traffic
through the program against the reference; for each control seed, the
float8 reference's embeddings of the pool, and the smallest gap that an
answer carrying another image's embedding would read.  ``sweep``: one
window per rate on one service; p50/p99 in each third of the window,
failures and how late the sender ran.  One JSON line per reading.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import checks, registry, stats  # noqa: E402
from harness.spans import OFF  # noqa: E402
from reference.precision import FP8  # noqa: E402


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def train(conf, seeds, controls, device) -> None:
    from drivers import train as drv
    t = conf["traffic"]
    for seed in sorted(set(seeds) | set(controls)):
        data = drv.inputs(conf, seed, device)
        t0 = time.perf_counter()
        ref = drv.reference_readings(conf, seed, device, data,
                                     t["check_steps"])
        ref_s = time.perf_counter() - t0
        if seed in seeds:
            state, step = drv.build_program(conf, seed, device, data, OFF)
            prog = drv.first_steps(state, step, data, t["check_steps"], OFF)
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
            emit(kind="program", seed=seed, reference_s=ref_s,
                 **checks.train_readings(prog, ref))
        if seed in controls:
            ctl = drv.reference_readings(conf, seed, device, data,
                                         t["check_steps"], cast=FP8)
            emit(kind="control_fp8", seed=seed,
                 **checks.train_readings(ctl, ref))
            half = (t["batch_size"] // t["accum_steps"]) // 2
            flt = drv.reference_readings(conf, seed, device, data,
                                         t["check_steps"],
                                         rows=slice(0, half))
            emit(kind="fault_half_batch", seed=seed,
                 **checks.train_readings(flt, ref))
        del data
        gc.collect()
        torch.cuda.empty_cache()


def _weights_into(service, conf, seed, device) -> None:
    from drivers import serve as drv
    from harness import weights as weights_lib
    from reference import nets
    w = weights_lib.make(seed, nets.param_shapes(conf), conf["init"], device)
    with torch.no_grad():
        for name, p in drv.served_net(service).named_parameters():
            p.copy_(w[name])


def serve(conf, seeds, controls, seconds, device) -> None:
    from drivers import serve as drv
    from reference import nets
    service = drv.build(conf, (seeds or controls)[0], device, OFF)
    service.start()
    drv.warm(service, drv.pool_images(conf, 0, device))
    dim = nets.feature_dim(conf["arch"])
    for seed in sorted(set(seeds) | set(controls)):
        pool = drv.pool_images(conf, seed, device)
        ref = drv.reference_embeddings(conf, seed, device, pool)
        if seed in seeds:
            _weights_into(service, conf, seed, device)
            w = drv.send(service, pool, dim, conf["cell"]["rate_per_s"],
                         seconds, seed, OFF)
            ok = ~np.isnan(w["done"])
            gaps = checks.embed_gaps(w["answers"][ok], w["index"][ok], ref)
            lat = np.where(ok, w["done"] - w["due"], np.inf) * 1e3
            emit(kind="program", seed=seed, embed_gap=float(gaps.max()),
                 embed_gap_median=float(np.median(gaps)),
                 p50=stats.percentile(lat, 50), p99=stats.percentile(lat, 99),
                 unanswered=int((~ok).sum()), requests=len(ok))
        if seed in controls:
            ctl = drv.reference_embeddings(conf, seed, device, pool, FP8)
            gaps = checks.embed_gaps(ctl, np.arange(len(pool)), ref)
            centred = ref - ref.mean(axis=0)
            d = np.linalg.norm(ref[:, None] - ref[None], axis=2)
            d /= np.linalg.norm(centred, axis=1)[:, None]
            np.fill_diagonal(d, np.inf)
            emit(kind="control_fp8", seed=seed, embed_gap=float(gaps.max()),
                 embed_gap_min=float(gaps.min()))
            emit(kind="fault_other_image", seed=seed,
                 embed_gap=float(d.min()))
    service.stop()


def sweep(conf, rates, seconds, device) -> None:
    from drivers import serve as drv
    from reference import nets
    seed = 1
    service = drv.build(conf, seed, device, OFF)
    service.start()
    pool = drv.pool_images(conf, seed, device)
    drv.warm(service, pool)
    dim = nets.feature_dim(conf["arch"])
    for rate in rates:
        w = drv.send(service, pool, dim, rate, seconds, seed, OFF)
        ok = ~np.isnan(w["done"])
        lat = np.where(ok, w["done"] - w["due"], np.inf) * 1e3
        thirds = np.array_split(lat, 3)
        emit(kind="sweep", rate=rate, requests=len(lat),
             failed=int((~ok).sum()),
             p50=[stats.percentile(x, 50) for x in thirds],
             p99=[stats.percentile(x, 99) for x in thirds],
             p99_all=stats.percentile(lat, 99),
             answered_per_s=float(ok.sum()) / seconds,
             late_ms_median=float(np.median(w["late"]) * 1e3),
             late_ms_max=float(w["late"].max() * 1e3))
    service.stop()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=("train", "serve", "sweep"))
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--rates", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    conf = registry.spec(HERE.parent, args.workload)
    if args.mode == "train":
        train(conf, _ints(args.seeds), _ints(args.controls), device)
    elif args.mode == "serve":
        serve(conf, _ints(args.seeds), _ints(args.controls), args.seconds,
              device)
    else:
        sweep(conf, [float(r) for r in args.rates.split(",")], args.seconds,
              device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
