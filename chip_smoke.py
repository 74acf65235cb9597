#!/usr/bin/env python3
"""Drive byol_tpu_torch's serving path once on one CUDA card, and check it.

    python3 chip_smoke.py            # from the repository root; one card

Phases (any failure raises, and the script exits nonzero):

1. device  — a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off for the comparisons;
2. build   — nvcc builds the kernel library from byol_tpu_torch/ops/csrc/;
3. kernels — each kernel of the path, at the shapes the path gives it, is
   held against its plain PyTorch version on the same inputs (fp32 1e-5,
   bf16 2e-2) and timed with CUDA events beside the plain version, one
   PyTorch library call of the same function (a yardstick the port never
   calls) and its bound: the larger of bytes / 3.35 TB/s and operations /
   peak rate (989 TFLOP/s bf16, 67 TFLOP/s fp32 off the tensor cores);
4. slice   — serves ViT-B/16 (224 px, bf16, attn_impl='flash', random
   weights from the seed, buckets 8..64) through ``build_service``:
   warmup, then 48 closed-loop requests from 3 streams with every launch
   counter set to 0 just before and read just after; every embedding must
   be (1, 768) and finite, no bucket may warm again, and the flash kernel
   must have launched 12 times per served batch.  One bucket-8 batch is
   held against the same weights with attn_impl='dense' (bf16, rtol = atol
   = 3e-2: bf16 rounds the scores and probabilities at other points);
5. prints the ``{"kernels": [...]}`` line, then, last, the ``{"ok": true,
   "device": ...}`` line.
"""
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-5}
SLICE_TOL = 3e-2
HEADS, SEQ = 12, 197               # ViT-B/16 at 224 px: 196 patches + cls


def _time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _qkv_views(batch, head_dim, dtype, seed):
    """q, k, v as the ViT hands them to attention: (B, H, S, D) views of
    one (B, S, 3, H, D) projection output."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((batch, SEQ, 3, HEADS, head_dim), generator=gen,
                      device="cuda", dtype=torch.float32).to(dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def check_flash(card):
    """Kernel vs plain version at the slice's shapes; returns the
    per-shape results."""
    import torch
    import torch.nn.functional as F
    from byol_tpu_torch.ops import flash_attention as fa

    rows = []
    for batch, head_dim, dtype in ((8, 64, torch.bfloat16),
                                   (64, 64, torch.bfloat16),
                                   (8, 64, torch.float32),
                                   (64, 64, torch.float32),
                                   (8, 32, torch.bfloat16),
                                   (8, 128, torch.bfloat16),
                                   (8, 32, torch.float32)):
        name = str(dtype).split(".")[-1]
        q, k, v = _qkv_views(batch, head_dim, dtype, seed=batch + head_dim)
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=TOL[name],
                                 atol=TOL[name]))
        elt = q.element_size()
        n_bytes = 4 * batch * HEADS * SEQ * head_dim * elt
        flops = 4 * batch * HEADS * SEQ * SEQ * head_dim
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        row = {
            "shape": [batch, HEADS, SEQ, head_dim], "dtype": name,
            "max_abs_err": err, "tol": TOL[name], "ok": ok,
            "ms": _time_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": _time_ms(
                lambda: fa.flash_attention_reference(q, k, v)),
            "library_ms": _time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
        print(f"flash_attention {row} [{card}]", flush=True)
        if not ok:
            raise AssertionError(
                f"flash_attention disagrees with its plain version at "
                f"{row['shape']} {name}: max abs err {err} (tol {TOL[name]})")
        rows.append(row)
    return rows


def _kind(kernel_name):
    name = kernel_name.lower()
    if "flash_fwd" in name:
        return "flash_attention"
    if "memcpy" in name or "memset" in name:
        return "memcpy"
    if "conv" in name or "fprop" in name:
        return "conv"
    if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    for op in ("layer_norm", "gelu", "copy", "add"):
        if op in name:
            return op
    return "other"


def profile_embed(engine, rows, card, iters=3):
    """Device time per kernel kind of one full-bucket embed, under
    torch.profiler (its own overhead is in the wall time it prints)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.embed(rows)
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kinds, top = {}, []
    for evt in prof.key_averages():
        # kernels and copies only: an operator's entry repeats its kernels'
        # device time
        ms = evt.self_device_time_total / 1e3 / iters
        if evt.device_type == DeviceType.CUDA and ms > 0:
            kinds[_kind(evt.key)] = kinds.get(_kind(evt.key), 0.0) + ms
            top.append((ms, evt.key))
    busy = sum(kinds.values())
    print(f"profile: bucket {rows.shape[0]} embed, per batch: wall "
          f"{wall_ms:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall_ms:.1%}); device ms by kind "
          f"{ {k: round(v, 4) for k, v in sorted(kinds.items())} } [{card}]",
          flush=True)
    for ms, name in sorted(top, reverse=True)[:10]:
        print(f"profile:   {ms:.4f} ms  {name[:100]}", flush=True)


def run_slice(card):
    """The main path: serve ViT-B/16 through build_service on the card."""
    import numpy as np
    import torch
    from byol_tpu_torch.core.config import (Config, DeviceConfig,
                                            ModelConfig, TaskConfig)
    from byol_tpu_torch.models.layers import store_in_compute_dtype
    from byol_tpu_torch.ops import flash_attention as fa
    from byol_tpu_torch.serving.net.loadgen import run_closed_loop
    from byol_tpu_torch.serving.service import (ServeConfig, _serving_rcfg,
                                                build_service)
    from byol_tpu_torch.training.build import build_net
    from byol_tpu_torch.training.linear_eval import frozen_representation_fn

    cfg = Config(task=TaskConfig(image_size_override=224),
                 model=ModelConfig(arch="vit_b16", attn_impl="flash"),
                 device=DeviceConfig(half=True, seed=0))
    t0 = time.perf_counter()
    service = build_service(cfg, ServeConfig(min_bucket=8, max_bucket=64),
                            device="cuda")
    service.start()
    warm = service.engine.compile_count
    print(f"slice: vit_b16 built and warmed in "
          f"{time.perf_counter() - t0:.1f}s: "
          f"{service.engine.describe()}", flush=True)

    def embed(idx, img):
        out = service.embed(img, timeout=300)
        finite = bool(np.isfinite(out).all())
        if out.shape != (1, 768) or not finite:
            raise AssertionError(f"stream {idx}: embedding of shape "
                                 f"{out.shape}, finite={finite}")

    batches0 = service.meter.total_batches
    fa.LAUNCHES = 0
    res = run_closed_loop(embed, service.engine.input_shape, 48, 3, seed=0)
    launches = fa.LAUNCHES
    batches = service.meter.total_batches - batches0
    snap = service.meter.snapshot(time.perf_counter(), reset=False)
    print(f"slice: {res.summary()} [{card}]", flush=True)
    print(f"slice: served p50 {snap['p50_ms']:.3f} ms, p99 "
          f"{snap['p99_ms']:.3f} ms, {snap['rows_per_sec']:.1f} img/s over "
          f"{batches} batches (fill {snap['fill_ratio']:.3f}) [{card}]",
          flush=True)
    if not res.ok:
        raise AssertionError(f"slice: {res.summary()}")
    if service.engine.compile_count != warm:
        raise AssertionError(f"slice: a bucket warmed again after warmup "
                             f"({warm} -> {service.engine.compile_count})")
    if batches < 1 or launches != 12 * batches:
        raise AssertionError(f"slice: flash_attention launched {launches} "
                             f"times for {batches} batches (want 12 each)")
    print(f"slice: flash_attention launches {launches} = 12 x {batches} "
          "batches", flush=True)

    # full-bucket throughput, through the engine (outside the counted run)
    rows64 = np.random.RandomState(1).rand(64, 224, 224, 3).astype(
        np.float32)
    service.engine.embed(rows64)
    t0 = time.perf_counter()
    for _ in range(5):
        service.engine.embed(rows64)
    dt = (time.perf_counter() - t0) / 5
    print(f"slice: bucket 64 embed {dt * 1e3:.3f} ms = {64 / dt:.1f} img/s "
          f"[{card}]", flush=True)

    profile_embed(service.engine, rows64, card)

    # one bucket-8 batch against the same weights under dense attention
    rows8 = np.random.RandomState(2).rand(8, 224, 224, 3).astype(np.float32)
    got = service.engine.embed(rows8)
    service.stop()
    dense_cfg = cfg.replace(model=ModelConfig(arch="vit_b16",
                                              attn_impl="dense"))
    dense_net = store_in_compute_dtype(
        build_net(_serving_rcfg(dense_cfg, 10)).cuda())
    want = frozen_representation_fn(dense_net, half=True)(
        torch.from_numpy(rows8).cuda()).cpu().numpy()
    err = float(np.abs(got - want).max())
    ok = bool(np.allclose(got, want, rtol=SLICE_TOL, atol=SLICE_TOL))
    print(f"slice: flash vs dense, bucket 8, bf16: max abs err {err:.5f} "
          f"(max |dense| {float(np.abs(want).max()):.3f}; rtol = atol = "
          f"{SLICE_TOL}) ok={ok}", flush=True)
    if not ok:
        raise AssertionError("slice: flash and dense embeddings disagree")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    from byol_tpu_torch.ops import common

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    print(card, flush=True)              # name, power limit (nvidia-smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    path = common.build()
    common.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {common.build_seconds:.1f}s)", flush=True)
    if common.build_log is not None:
        for line in common.build_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {line.strip()}", flush=True)

    flash_rows = check_flash(card)
    launches = run_slice(card)

    main_row = next(r for r in flash_rows
                    if r["shape"][0] == 64 and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "byol_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "byol_tpu/ops/flash_attention.py:47",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in flash_rows
                           if r["dtype"] == "bfloat16"),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "ok": all(r["ok"] for r in flash_rows),
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
