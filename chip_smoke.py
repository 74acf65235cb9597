#!/usr/bin/env python3
"""Drive byol_tpu_torch's serving (in process and over the wire),
training, input, accumulation, observability, linear-eval, data-parallel,
optimizer-registry, ViT-training and tensor-parallel paths once on one
CUDA card, and check them.

    python3 chip_smoke.py            # from the repository root; one card

Phases (any failure raises, and the script exits nonzero):

1. device  — a CUDA card is required; prints its name and power limit
   (nvidia-smi) and turns TF32 off for the comparisons;
2. build   — nvcc builds the kernel library from byol_tpu_torch/ops/csrc/;
3. kernels — each kernel, at the shapes its path gives it, is held against
   its plain PyTorch version on the same inputs and timed as device time
   (CUDA events around replays of a CUDA graph of 20 calls; the eager
   time beside it) beside the plain version, one PyTorch library call of
   the same function where there is one (a yardstick the port never
   calls) and its bound: the larger of bytes / 3.35 TB/s and operations /
   peak rate (989 TFLOP/s bf16, 67 TFLOP/s fp32 off the tensor cores).
   Flash attention (K3) at S = 197 (buckets 8 and 64) and at S = 1, 65,
   208, 256, 257 and 577, each path of the kernel: fp32 1e-5, bf16 2e-2.
   The fused LARS+EMA update (K1a segment norms, K1b
   fused apply) at the ResNet-50 BYOL segment layout (173 leaves,
   35,089,024 padded elements), both EMA modes: fp32 rtol 1e-5, atol 1e-6
   on p, m, t and the trust vector; K1a twice, bitwise equal.  The fused
   two-view augmentation (K2) at batch 64, uint8 224 -> 224 on the port's
   draws, and at batch 8 for 256 -> 224 (the downsampling arm), fp32
   input, strength 0 and forced gates: max abs err 1e-5 on both views,
   bitwise repeatable; its bound counts the band walk (the image read
   once, the views written once, 2 FLOP per non-zero tap), the dense
   contraction's bound printed beside it as superseded; the crop
   contraction alone as two fp32 einsums is timed beside it.  Then K2's
   two passes launch by launch at the training shape, with L2 left as
   the previous call left it, flushed, or holding the image, and the
   clocks nvidia-smi reads meanwhile;
4. serving — ViT-B/16 (224 px, bf16, attn_impl='flash', random weights from
   the seed, buckets 8..64) through ``build_service``: warmup captures one
   CUDA graph per bucket (each capture must record 12 flash launches and
   no other kernel), then 48 closed-loop requests from 3 streams with
   every launch counter set to 0 just before and read just after; every
   embedding must be (1, 768) and finite, no bucket may be captured
   again, no wrapper counter may tick (a replay launches nothing through
   the wrappers), and the flash launches derived from captures x replays
   must be 12 per served batch.  Then the graph engine against an eager
   engine (``graphs=False``) on the same represent fn at buckets 8 and 64:
   bitwise expected (bf16 3e-2 otherwise, the difference printed), wall
   ms a batch in turns and device-busy ms of 3 profiled batches each.
   One bucket-8 batch is held against the same weights with
   attn_impl='dense' (bf16, rtol = atol = 3e-2: bf16 rounds the scores
   and probabilities at other points);
4b. wire — (1) a ``WireServer`` over the same ``build_service`` in this
   process: 48 requests from 3 ``EmbedClient`` streams of single float32
   images, then 48 of uint8, counters set to 0 before and read after:
   every answer (1, 768) and finite, flash launches from captures x
   replays 12 per batch; the same 48 in-process before as the yardstick
   (p50/p99, images/s), the ``wire`` block of serve_stats; one uint8 image
   bitwise equal to its float32 u8/255 over the socket; JAX's malformed
   bodies and the admission answers (411, 413 before the read, 400 and
   408 deadlines) mapped over the real socket, the server serving after.
   (2) ``python -m byol_tpu_torch serve --arch vit_b16 --attn-impl flash
   --http 127.0.0.1:0 --smoke 48 --smoke-streams 3`` must exit 0; the same
   without --smoke (``--drain-grace-s 2``) takes SIGTERM while 3 streams
   have requests in flight: /readyz 503 and /healthz 200 in the grace
   window, every admitted request answered 200 (the 200s of its
   serve.jsonl equal the clients'), exit 0;
5. training — the headline run ``--task fake --arch resnet50
   --image-size-override 224 --batch-size 64 --epochs 3 --debug-step
   --fused-update on --augment-placement step --fused-augment on`` (bf16,
   heads 4096/256, random weights from the seed, both views made in the
   step from raw uint8 batches, its per-epoch checkpoints under a
   temporary ``--model-dir`` removed after) through the CLI's config and
   the trainer, with every launch counter set to 0 just before and read just after: 3
   optimizer steps, every loss finite, K2 = K1a = K1b = 1 launch per step.
   Then one more step on the trained state: the params must move, the
   target must be tau t + (1 - tau) p', the plain unfused chain applied to
   a copy of the pre-step state with that step's gradients must give the
   same p, m and t (rtol 1e-5, atol 1e-6), and the step's K2 views must
   equal the unfused augmentation chain's on its recorded draws (1e-5).
   Then the augmentation of a batch alone both ways, 10 timed steps each
   with K2, with the unfused chain and with no augmentation (in turns,
   twice), and a torch.profiler breakdown of 3 steps of each by kernel
   kind;
6. checkpoint — the headline run without ``--debug-step``, ``--epochs 2``
   (8 steps an epoch), under a temporary ``--model-dir``, cuDNN
   deterministic, counters set to 0 before and read after each run: an
   uninterrupted run (16 steps, K2 = K1a = K1b = 16 launches, ``ckpt-0``
   and ``ckpt-1``, ``meta.json`` as the JAX saver's rules give it for the
   two test losses); a run that takes SIGTERM from its loader after batch
   3 of epoch 1 (exit 143, a checkpoint of epoch 1 at a mid-epoch step s
   equal to the live state bit for bit) and its relaunch (epoch 1
   re-entered at batch s - 8, 16 - s steps and launches of each kernel,
   its losses against the uninterrupted run's, rtol = atol = 3e-2, and
   whether they are bitwise equal); save and restore of the trained state
   on their own (snapshot, write and read times, bytes, the restore
   bitwise); ``serve --checkpoint`` of the trained run (24/24 requests,
   no kernel launched, a bucket-8 batch against the trained state's
   ``frozen_representation_fn`` at 3e-2 in bf16, and no more than the
   parameters and statistics held on the card);
7. input — the slice's command under loader placement, ``--task fake
   --arch resnet50 --image-size-override 224 --batch-size 64 --epochs 2
   --fused-update on`` (256 images: 2 epochs of 4 steps), through the
   CLI's config and the trainer, once per ``--data-backend`` (``tf``, the
   torch host path on DataLoader workers; ``native``, the C++ pipeline,
   with ``--valid-fraction 0.25``; ``device``, the unfused chain on the
   card from host draws), then ``--aug-spec paper`` under ``tf`` in
   the main process (2 steps, ``--workers-per-replica 0``: the tf run
   above spawned the pool) and ``--task synth`` under ``native`` (8
   steps, the loss must
   fall), counters set to 0 before and read after each run: every loss
   finite, K1a = K1b = one launch per step, K2 none, every train batch
   with view1 != view2 in every row and both in [0, 1], the valid loss
   once an epoch.  Then 4 timed steps of each backend (tf at 2 workers,
   native at 2 and 6 threads) beside the step placement's K2 path, fed by
   ``prefetch_to_device`` as the trainer is, one turn each, and a
   torch.profiler breakdown of 3 more steps of each on that turn's
   pipeline (images/s, device-busy
   share, starved steps, H2D MiB per step); then ``--task image_folder``
   on a tree of 2 classes x 64 JPEGs at 256 px written with PIL (2 steps
   under ``native``, and 2 under ``tf`` where the library has libjpeg;
   without it ``native`` moves to ``tf`` and that run covers both), the
   tree removed after;
8. accum — the recipe's batch through gradient accumulation: ``--task
   fake --arch resnet50 --image-size-override 224 --batch-size 4096
   --accum-steps k --accum-bn-mode average --augment-placement step
   --fused-augment on --fused-update on --polyak-ema 0.99 --epochs 1``
   over 4096 fake images (1 optimizer step; eval on the Polyak params),
   through the CLI's config and the trainer, counters set to 0 before and
   read after: every loss finite, K1a = K1b = 1 and K2 = k launches per
   optimizer step.  k = 16 (microbatch 256), or 32 if one k = 1 step of
   256 peaks above 75 GB.  Then the peak memory of a k-step on the batch
   of 4096 against a k = 1 step on one microbatch (at most that plus the
   rest of the uint8 batch and 1 GiB), wall ms of 1 optimizer step,
   images/s, device-busy ms of 1 profiled step; and at effective
   256 = 4 x 64 on one set of views: ``global`` against one k = 1 step in
   loss (bf16 3e-2), ``average`` against ``microbatch`` in the mean
   gradient (rtol 1e-5, cuDNN deterministic);
9. observe — the slice's main path: the accum command with ``--telemetry
   step --telemetry-interval 1 --nan-policy halt --spans on --grapher
   jsonl`` and a temporary ``--log-dir`` (1 optimizer step of 4096 = k x
   256), counters set to 0 before and read after: K1a = K1b = 1 and K2 = k
   launches per step; its run.jsonl read back with the port's strict
   reader must hold run_header, a step record per step, epoch, goodput,
   span_stats and run_end; every health record finite with
   ``nonfinite_count`` 0 and its trust min/median/max EQUAL to those of
   the vector K1a's wrapper returned on that step; every goodput window's
   buckets sum to its wall within 1 %; the productive share and buckets,
   FLOPs per sample (FlopCounterMode over the first step) and MFU are
   printed.  Then the cost of telemetry: at 4096, wall ms of 1 step
   and device-busy ms of 1 profiled step with telemetry 'step' at
   interval 1, beside the accum phase's numbers, and the health vector
   alone; at batch 64 (the training phase's config) off, epoch, step at
   interval 1 and at 50, 5 steps each in turns and 3 profiled.  Last
   ``--nan-policy halt`` at batch 64 under loader placement (fp32 views
   made on the card): a NaN in view1 row 0 of step 2's batch must raise
   NanHaltError for step 2 with ``halt``, ``state_dump`` and a goodput
   ``final`` with ``halted`` in the log.  The serving phase (4) runs with
   the serving CLI's run log and flight recorder: the trace's
   ``serve/dispatch`` spans must number the batches served, and the
   worker's time splits by its top-level spans;
10. linear_eval — ``--task synth --num-synth-samples 1024 --arch resnet50
   --image-size-override 224 --batch-size 64 --epochs 1
   --augment-placement step --fused-augment on --fused-update on
   --linear-eval`` through the CLI's ``main`` (temporary --model-dir and
   --log-dir), counters set to 0 before and read after: 16 finite losses,
   K2 = K1a = K1b = 16, top-1 >= 30 % (chance 10 %); top-1, top-5, train
   accuracy, extraction images/s and the probe's seconds printed; one
   batch through the extractor bitwise equal to the trained state's
   ``frozen_representation_fn``;
11. ddp — data parallel on this one card.  (1) The split K1a (its two
   entries, ``segment_sums`` and ``segment_epilogue``) and K1b on each
   rank's range of the ResNet-50 BYOL layout for worlds 2 and 4, against
   their plain versions (fp32 rtol 1e-5, atol 1e-6; the float64 sums rtol
   1e-5); the ranks' sums added by hand give the whole buffer's trust
   vector within 1e-6 relative; world 1's split path equals the fused K1a
   bit for bit; each timed (graph ms of 20 calls) beside its plain version
   and its bound.  (2) ``--task fake --arch resnet50 --image-size-override
   224 --batch-size 64 --augment-placement step --fused-augment on
   --fused-update on``, 3 steps on the same batches under deterministic
   cuDNN, without a process group and then over NCCL (a FileStore
   rendezvous, rank 0 of 1), each with ``--zero1 off`` and with ``--zero1
   on --flat-resident on``, counters set to 0 before and read after each
   run: the states bitwise equal with and without the group, and with and
   without ZeRO-1; K2 = K1b = 3 launches a run, K1a 3 without ZeRO-1, its
   split entries 3 each with it.  The synced BatchNorm forced on against
   the one-device class (forward, backward, running statistics, fp32
   1e-5 of each tensor's largest magnitude); the NCCL all-reduce and reduce-scatter of the flat gradient and
   the bucketed gather; a profile of each run's step.  (3) ``python -m
   torch.distributed.run --standalone --nproc_per_node 1 -m
   byol_tpu_torch ... --zero1 on --flat-resident on`` exits 0, its run
   header's ``sharding_plan`` reads world 1 and ZeRO-1 on, and its
   checkpoint restores bitwise into a one-card ``--zero1 off`` state,
   which then takes a step;
12. optim — the optimizer registry on the unfused path: the ddp phase's
   config with ``--fused-update off`` (ResNet-50, 224 px, batch 64, bf16,
   K2 in the step), the net built once from the seed; each of the 14
   chains (rmsprop, adam, adadelta, sgd, momentum, lamb, lbfgs, bare and
   as ``lars_<base>``) and sgd and lars_lamb at ``--clip 0.01``, from the
   same state, takes 3 steps on the same batches (no warmup; the adaptive
   bases at lr 1e-3, the rest at the recipe's 0.2), every launch counter
   set to 0
   before the first chain and read after the last: losses finite, K2 one
   launch a step, the split K1a's two entries one a step per LARS or LAMB
   norm (lars_lamb two); busy ms of a profiled step and peak memory per
   chain.  Then one update of lars_adam, lamb and lbfgs at the ResNet-50
   layout from a seeded mid-run state on the card against the same chain
   on CPU copies (rtol 1e-5), and the LAMB-layout epilogue against its
   plain version; lars_adam and lbfgs at world 1 over NCCL with ``--zero1
   on --flat-resident on`` against off, states bit for bit; ``torchrun
   --nproc_per_node 1 ... --optimizer lamb --zero1 on --flat-resident
   on`` exits 0 and its checkpoint restores bitwise into a one-card
   ``--zero1 off`` lamb state, which then takes a step;
13. vit — ViT-B/16 BYOL training (width 768, 12 blocks, 12 heads, patch
   16, 224 px, bf16 over fp32 state, random weights from the seed):
   ``--task fake --arch vit_b16 --image-size-override 224 --batch-size 64
   --epochs 1 --augment-placement step --fused-augment on --fused-update
   on`` over 192 fake images (3 steps), through the CLI's config and the
   trainer, three times: dense attention with cls pooling, ``--attn-impl
   ring --pooling gap`` (the ring at sequence 1: one step of its online
   softmax), and ``--remat-policy dots``; counters set to 0 before and
   read after each run: every loss finite, K2 = K1a = K1b = 3; per run
   the wall ms of 3 more steps, images/s, the device-busy ms of one
   profiled step and the fit's peak memory.  Then, from the seeded state
   and one batch, ring against dense on a first step (gap, bf16 3e-2),
   and dots against none on a first step under deterministic cuDNN and
   cuBLAS: loss and gradients bitwise, or within 1e-6 relative, with the
   contractions the SAC policy saw.  K1a and K1b at the ViT-B/16 BYOL
   layout against their plain versions (rtol 1e-5, atol 1e-6), graph ms
   beside their bounds and ``_foreach_norm``.  Last, each of the seven
   remat policies' one step (k = 1) of ResNet-50 at 256 and of ViT-B/16
   at 256 (128 if a none step of 256 peaks above 75 GB), from one state
   per architecture restored between policies: peak memory, busy ms, the
   running statistics bitwise equal to none's, the host bytes that
   ``offload_block_out`` moved.  Sequence > 1 needs a card per rank, so
   it is not run here (its CPU tests run it over gloo);
14. tp — the tensor-parallel heads (``--model-parallel 2``) of
   ResNet-50 at its published widths (heads 4096/256, 224 px, bf16 over
   fp32 state, batch 64): ``--task synth --num-synth-samples 192 --arch
   resnet50 --image-size-override 224 --batch-size 64 --epochs 1
   --augment-placement step --fused-augment off --fused-update off`` (3
   steps of the unfused lars_momentum chain, whose LARS norms are the
   split K1a's).  First the preflight's killable probe on the card.  The
   model-2 arm: two processes on this one card (NCCL refuses two ranks on
   one device), each of which makes a gloo process group (a FileStore)
   and calls the port's CLI entry ``cli.main`` with ``--model-parallel
   2``, counters set to 0 before and read after: 3 finite losses, equal
   on both ranks, ``segment_sums`` = ``segment_epilogue`` = 3 launches a
   rank, K1a, K1b, K2 and K3 none; then on its trained state the bf16
   step's wall ms (3 steps) on each rank and rank 0's device-busy ms of
   one profiled step, and each rank's peak memory — NOT the cost of TP on
   NVLink: two ranks share one card and their collectives go through the
   host.  The model-1 arm: ``torchrun --standalone --nproc_per_node 1
   train_torch.py`` with the same flags: exit 0, run header mesh ``model:
   1`` (the model-2 arm's ``model: 2``), train loss within 3e-2 (bf16) of
   the model-2 arm's.  Then, in fp32 from the seed under deterministic
   cuDNN and no warmup, every rank's step-0 head shards bitwise the
   slices of the model-1 state's leaves, and after one step on the same
   batch rank 0's
   gathered canonical tree against the model-1 one within ``TP_TOL``
   (each leaf's largest difference over its largest magnitude: 1e-5
   params and target, 1e-3 momentum, 1e-4 BatchNorm statistics; the
   three Dense biases that feed a BatchNorm, whose gradient is 0 in exact
   arithmetic, against their key's largest magnitude; the loss at 1e-5);
   last the model-2 arm's checkpoint (whole leaves) restored
   into a model-1 state on the card, equal to the tree saved bitwise;
15. prints the ``{"input_arms": ...}``, ``{"accum": ...}``,
   ``{"observe": ...}``, ``{"serving_graph_vs_eager": ..., "wire": ...,
   "linear_eval": ...}``, ``{"ddp": ...}``, ``{"optim": ...}``,
   ``{"vit": ...}`` and ``{"tp": ...}`` lines, each phase's seconds, and
   the ``{"kernels": [...]}`` line (launches on this slice's main path —
   the split K1a's entries on the tp phase's two ranks; K1a, K1b and K2
   in the vit phase's three runs; K3's over the wire, from graph replays,
   where it last ran — and per path; the library yardstick of K1a and its
   split is ``torch._foreach_norm`` over the leaves of p and g), then,
   last, the ``{"ok": true, "device": ...}`` line.
"""
import json
import math
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
K1_TOL = dict(rtol=1e-5, atol=1e-6)
K2_TOL = 1e-5
TRAIN_ARGV = ["--task", "fake", "--arch", "resnet50",
              "--image-size-override", "224", "--batch-size", "64",
              "--epochs", "3", "--debug-step", "--fused-update", "on",
              "--augment-placement", "step", "--fused-augment", "on"]
RN50_PADDED = 35_089_024           # the ResNet-50 BYOL segment layout
# the checkpoint phase: the headline run without --debug-step, 2 epochs of
# 8 steps (512 fake samples at batch 64)
CKPT_ARGV = ["--task", "fake", "--arch", "resnet50",
             "--image-size-override", "224", "--batch-size", "64",
             "--epochs", "2", "--fused-update", "on",
             "--augment-placement", "step", "--fused-augment", "on"]
CKPT_STEPS = 16
SIGTERM_AFTER = (1, 3)             # epoch, batches of it yielded


def _time_ms(fn, iters=20, warmup=3):
    """ms per call of ``fn`` launched eagerly, CUDA events around
    ``iters`` calls: the host's launch cost is in it wherever the host
    enqueues more slowly than the card runs."""
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


def _device_ms(fn, iters=20, warmup=3):
    """Device ms per call of ``fn``: ``iters`` calls captured into one CUDA
    graph, replayed, CUDA events around the replays.  The kernels run back
    to back, so the host's launch cost is left out of the kernel's time
    and of its yardsticks' alike."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def _qkv_views(batch, head_dim, dtype, seed, seq=SEQ):
    """q, k, v as the ViT hands them to attention: (B, H, S, D) views of
    one (B, S, 3, H, D) projection output."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((batch, seq, 3, HEADS, head_dim), generator=gen,
                      device="cuda", dtype=torch.float32).to(dtype)
    return [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def check_flash(card):
    """Kernel vs plain version at the slice's shapes (S = 197 at buckets 8
    and 64) and at the sequence lengths that take the kernel's other
    paths: one m-tile (S = 1), a split head (65), keys ending inside a
    64-key chunk on a 16-row edge (208), a full resident head (256), the
    ring (257, and 577 = ViT-B/16 at 384 px); returns the
    per-shape results."""
    import torch
    import torch.nn.functional as F
    from byol_tpu_torch.ops import flash_attention as fa

    rows = []
    bf16, f32 = torch.bfloat16, torch.float32
    for batch, seq, head_dim, dtype in (
            (8, SEQ, 64, bf16), (64, SEQ, 64, bf16), (8, SEQ, 64, f32),
            (64, SEQ, 64, f32), (8, SEQ, 32, bf16), (8, SEQ, 128, bf16),
            (8, SEQ, 32, f32), (8, 1, 64, bf16), (8, 65, 64, bf16),
            (8, 208, 64, bf16), (8, 256, 64, bf16), (8, 257, 64, bf16),
            (8, 577, 64, bf16)):
        name = str(dtype).split(".")[-1]
        q, k, v = _qkv_views(batch, head_dim, dtype, seed=batch + head_dim,
                             seq=seq)
        out = fa.flash_attention(q, k, v)
        ref = fa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.allclose(out.float(), ref.float(), rtol=TOL[name],
                                 atol=TOL[name]))
        elt = q.element_size()
        n_bytes = 4 * batch * HEADS * seq * head_dim * elt
        flops = 4 * batch * HEADS * seq * seq * head_dim
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        plan = fa.launch_plan(batch * HEADS, seq, fa.sm_count(q.device))
        row = {
            "shape": [batch, HEADS, seq, head_dim], "dtype": name,
            "plan": (("resident" if plan.resident else "ring")
                     + f" {plan.blocks_per_head}x{plan.rows_per_block} rows"
                     if name == "bfloat16" else "fp32 64-row tiles"),
            "max_abs_err": err, "tol": TOL[name], "ok": ok,
            "ms": _device_ms(lambda: fa.flash_attention(q, k, v)),
            "plain_ms": _device_ms(
                lambda: fa.flash_attention_reference(q, k, v)),
            "library_ms": _device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            "eager_ms": _time_ms(lambda: fa.flash_attention(q, k, v)),
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


def _k2_operands(b, raw, u8, strength, gates, seed):
    """Images and K2 operands on the card: draws from the port's stream
    of step ``seed`` (gates forced to 0 or 1 when ``gates`` is given)."""
    import torch
    from byol_tpu_torch.data import device_augment as da
    from byol_tpu_torch.ops import fused_augment as fa
    views = da.step_views(1234, seed, b, raw, raw, strength)
    if gates is not None:
        views = [p._replace(**{k: torch.full((b,), float(gates))
                               for k in ("flip", "jitter", "gray", "blur")})
                 for p in views]
    views = da.to_device(views, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.randint(0, 256, (b, raw, raw, 3), generator=gen,
                        device="cuda", dtype=torch.uint8)
    if not u8:
        img = img.float() / 255.0
    per_view = [fa.view_kernel_inputs(p) for p in views]
    crop, prm = (torch.stack([per_view[0][i], per_view[1][i]], dim=1)
                 for i in range(2))
    return img, crop, prm


def _k2_band_flops(crop, raw, size):
    """The FLOPs of the band walk on these windows: 2 per non-zero tap of
    the height pass (each output row, over the crop's source columns x 3)
    and of the width pass (each output pixel x 3)."""
    import torch
    from byol_tpu_torch.ops import fused_augment as fa
    window = fa.CropWindow(*crop.reshape(-1, 5).unbind(1))
    _, rw, cf, cw = fa.crop_window_bands(window, raw, raw, size)
    nz = cw != 0
    cols = cf.unsqueeze(-1) + torch.arange(cw.shape[-1], device=cw.device)
    lo = torch.where(nz, cols, raw).amin(dim=(1, 2))
    hi = torch.where(nz, cols, -1).amax(dim=(1, 2))
    span = (hi - lo + 1).clamp(min=0)
    macs = ((rw != 0).sum(-1).sum(-1) * span * 3
            + size * nz.sum(-1).sum(-1) * 3)
    return 2 * int(macs.sum())


def check_two_view(card):
    """K2 against its plain version, TF32 off: the training shape, the
    downsampling arm (256 -> 224), fp32 input, strength 0 (no hue) and
    forced gates; returns the per-case results (the first is the training
    shape)."""
    import torch
    from byol_tpu_torch.ops import fused_augment as fa
    rows = []
    for name, b, raw, u8, strength, gates in (
            ("batch 64 uint8 224->224", 64, 224, True, 1.0, None),
            ("batch 8 uint8 256->224 (downsampling)", 8, 256, True, 1.0,
             None),
            ("batch 8 float32 224->224", 8, 224, False, 1.0, None),
            ("batch 8 uint8 strength 0 (no hue)", 8, 224, True, 0.0, None),
            ("batch 8 uint8 gates all on", 8, 224, True, 1.0, 1),
            ("batch 8 uint8 gates all off (crop only)", 8, 224, True, 1.0,
             0)):
        size = 224
        img, crop, prm = _k2_operands(b, raw, u8, strength, gates,
                                      seed=len(rows))
        hue = 0.2 * strength > 0
        kw = dict(size=size, hue=hue)
        out = fa.two_view(img, crop, prm, **kw)
        ref = fa.two_view_reference(img, crop, prm, **kw)
        torch.cuda.synchronize()
        err = max((o - r).abs().max().item() for o, r in zip(out, ref))
        ok = err <= K2_TOL and all(o.shape == (b, size, size, 3) and
                                   bool(torch.isfinite(o).all())
                                   for o in out)
        again = fa.two_view(img, crop, prm, **kw)
        bitwise = all(torch.equal(a, o) for a, o in zip(again, out))
        # the bound: the image read once, the views written once, the
        # scalars; the band walk's FLOPs on these windows.  The first
        # design's dense figure beside it (its weights read, the dense
        # contraction's FLOPs), superseded.
        n_bytes = (img.numel() * img.element_size()
                   + 4 * (crop.numel() + prm.numel())
                   + 2 * 4 * b * size * size * 3)
        flops = _k2_band_flops(crop, raw, size)
        dense_bytes = n_bytes + 4 * 2 * b * size * 2 * raw
        dense_flops = b * 2 * (2 * 3 * size * raw * (raw + size))
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["float32"] * 1e3
        window = fa.CropWindow(*crop.reshape(-1, 5).unbind(1))
        wy, wx = (t.reshape(b, 2, raw, size)
                  for t in fa.crop_weight_mats(window, raw, raw, size))
        x = img.float() / 255.0 if u8 else img
        row = {
            "case": name, "max_abs_err": err, "tol": K2_TOL, "ok": ok,
            "bitwise_repeatable": bitwise,
            "ms": _device_ms(lambda: fa.two_view(img, crop, prm, **kw)),
            "plain_ms": _device_ms(lambda: fa.two_view_reference(
                img, crop, prm, **kw)),
            "einsum_crop_ms": _device_ms(
                lambda: fa.crop_contract(x, wy, wx)),
            "eager_ms": _time_ms(lambda: fa.two_view(img, crop, prm, **kw)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "dense_bound_ms": max(dense_bytes / HBM_BYTES_PER_S,
                                  dense_flops / PEAK_FLOPS["float32"]) * 1e3,
            "mbytes": n_bytes / 1e6, "gflop": flops / 1e9,
            "dense_gflop": dense_flops / 1e9,
        }
        print(f"two_view {row} [{card}]", flush=True)
        if not (ok and bitwise):
            raise AssertionError(f"two_view disagrees with its plain version "
                                 f"({name}): max abs err {err} (tol "
                                 f"{K2_TOL}), bitwise repeatable {bitwise}")
        rows.append(row)
    return rows


def _smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def k2_pass_sweeps(card, sweeps=3, calls=40):
    """K2 at the training shape launch by launch, each pass's device time
    from torch.profiler, in turns: straight after the previous call, after
    256 MB were written (L2 flushed), and after a read of the image (the
    image in L2); each sweep ends with the CUDA-graph time the kernel
    line reports.  nvidia-smi reads the clocks while each arm runs."""
    import threading

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from byol_tpu_torch.ops import fused_augment as fa
    img, crop, prm = _k2_operands(64, 224, True, 1.0, None, seed=0)
    scratch = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    before = {"after the previous call": lambda: None,
              "L2 flushed": scratch.zero_,
              "image read into L2": img.amax}

    def k2():
        fa.two_view(img, crop, prm, size=224, hue=True)
    for sweep in range(sweeps):
        for arm, prep in before.items():
            clocks = []
            smi = threading.Thread(target=lambda: clocks.append(_smi(
                "clocks.sm,clocks.mem,power.draw,temperature.gpu")))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                smi.start()
                n = 0
                while n < calls or smi.is_alive():
                    prep()
                    k2()
                    n += 1
                    if n % 20 == 0:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
            smi.join()
            us = {"pass 1": [], "pass 2": []}
            for evt in prof.events():
                if (evt.device_type == DeviceType.CUDA
                        and "two_view_kernel<" in evt.name):
                    final = not evt.name.split(">")[0].endswith("false")
                    us["pass 2" if final else "pass 1"].append(
                        evt.time_range.elapsed_us())
            stats = {k: {"n": len(v), "min": min(v), "median":
                         sorted(v)[len(v) // 2], "max": max(v)}
                     for k, v in us.items() if v}
            print(f"two_view passes, sweep {sweep}, {arm}: us {stats}; "
                  f"sm/mem clock, power, temperature during: {clocks} "
                  f"[{card}]", flush=True)
        print(f"two_view passes, sweep {sweep}: graph ms "
              f"{_device_ms(k2):.4f} [{card}]", flush=True)


def _kind(kernel_name):
    name = kernel_name.lower()
    if "flash_fwd" in name:
        return "flash_attention"
    if "two_view_" in name and "_kernel" in name:
        return "K2_two_view"
    if "row_norms_kernel" in name or "segment_reduce_kernel" in name:
        return "K1a_segment_norms"
    if "segment_sums_kernel" in name or "segment_epilogue_kernel" in name:
        return "K1a_split"
    if "nccl" in name:
        return "nccl"
    if "fused_apply_kernel" in name:
        return "K1b_fused_apply"
    if "memcpy" in name or "memset" in name:
        return "memcpy"
    if "batch_norm" in name or "batchnorm" in name or "bn_" in name:
        return "batch_norm"
    if any(w in name for w in ("conv", "fprop", "dgrad", "wgrad")):
        return "conv"
    if any(w in name for w in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    for op in ("layer_norm", "gelu", "copy", "cat", "add"):
        if op in name:
            return op
    if "elementwise" in name or "reduce" in name:
        return "elementwise"
    return "other"


def _device_profile(run, iters, card, what, top=10, host=True):
    """Device ms per kernel kind of ``iters`` calls of ``run`` under
    torch.profiler (its own overhead is in the wall time it prints).
    ``host=False`` traces the card alone (no host operators, whose events
    cost the trace's processing seconds a step): the busy ms and kinds are
    the same sums, and the host's launch time is not measured (None)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t_profile = time.perf_counter()
    activities = ([ProfilerActivity.CPU] if host else []) + [
        ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kinds, ranked, launches, launch_api_ms = {}, [], 0, 0.0
    for evt in prof.key_averages():
        # kernels and copies only: an operator's entry repeats its kernels'
        # device time, and a span's annotation on the device timeline
        # (a recorder span) spans kernels already counted
        ms = evt.self_device_time_total / 1e3 / iters
        if getattr(evt, "is_user_annotation", False):
            continue
        if evt.device_type == DeviceType.CUDA and ms > 0:
            kinds[_kind(evt.key)] = kinds.get(_kind(evt.key), 0.0) + ms
            ranked.append((ms, evt.key))
            launches += evt.count
        elif "LaunchKernel" in evt.key:
            # the host's time inside the CUDA launch API calls
            launch_api_ms += evt.self_cpu_time_total / 1e3 / iters
    busy = sum(kinds.values())
    if busy <= 0:
        raise AssertionError(f"profile: {what}: the trace holds no device "
                             "time")
    if not host:
        launch_api_ms = None
    print(f"profile: {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall_ms:.1%}) in {launches / iters:.0f} "
          f"kernels and copies, host in launch calls "
          + (f"{launch_api_ms:.3f} ms" if host else "not traced")
          + f"; device ms by kind "
          f"{ {k: round(v, 4) for k, v in sorted(kinds.items())} }; the "
          f"profile took {time.perf_counter() - t_profile:.1f} s [{card}]",
          flush=True)
    for ms, name in sorted(ranked, reverse=True)[:top]:
        print(f"profile:   {ms:.4f} ms  {name[:100]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy, "kinds": kinds,
            "launch_api_ms": launch_api_ms}


def profile_embed(engine, rows, card, iters=3, what=""):
    """Device time per kernel kind of one bucket's embed."""
    return _device_profile(lambda: engine.embed(rows), iters, card,
                           f"bucket {rows.shape[0]} embed{what}, per batch")


def _k3_replayed(engine, replays0):
    """K3 launches the engine's graph replays made since ``replays0`` (a
    ``describe()['replays']``): each bucket's capture launches times its
    replays since.  A replay launches nothing through the wrapper, so its
    counter does not tick."""
    d = engine.describe()
    return sum(d["capture_launches"].get(b, {}).get("flash_attention", 0)
               * (n - replays0.get(b, 0)) for b, n in d["replays"].items())


def _check_captures(engine, what):
    """Every bucket captured, 12 K3 launches (one per ViT-B/16 block) and
    no other kernel in each capture."""
    d = engine.describe()
    want = {str(b): {"flash_attention": 12} for b in engine.buckets.sizes}
    if not d["graphs"] or d["capture_launches"] != want:
        raise AssertionError(f"{what}: captures {d['capture_launches']} "
                             f"(graphs={d['graphs']}); want {want}")


def graph_vs_eager(engine, card, turns=2, iters=10):
    """The graph engine against an eager engine on the same represent fn:
    bucket 8 and 64 embeddings (bitwise expected; bf16 3e-2 otherwise,
    with the difference printed), then wall ms a batch in turns (graph,
    eager, eager, graph) and device-busy ms of 3 profiled batches each."""
    import numpy as np
    import torch
    from byol_tpu_torch.serving.engine import ServingEngine
    eager = ServingEngine(engine.represent, engine.input_shape,
                          engine.buckets, device="cuda", graphs=False)
    eager.warmup()
    out = {}
    for b in (8, 64):
        rows = np.random.RandomState(30 + b).rand(
            b, *engine.input_shape).astype(np.float32)
        got, want = engine.embed(rows), eager.embed(rows)
        bitwise = bool(np.array_equal(got, want))
        err = float(np.abs(got - want).max())
        ok = bitwise or bool(np.allclose(got, want, rtol=SLICE_TOL,
                                         atol=SLICE_TOL))
        print(f"slice: graph vs eager, bucket {b}: bitwise {bitwise}, max "
              f"abs err {err:.3g} ok={ok}", flush=True)
        if not ok:
            raise AssertionError(f"slice: graph and eager disagree at "
                                 f"bucket {b} (max abs err {err})")
        wall = {"graph": [], "eager": []}
        for _ in range(turns):
            for arm in ("graph", "eager", "eager", "graph"):
                eng = engine if arm == "graph" else eager
                t0 = time.perf_counter()
                for _ in range(iters):
                    eng.embed(rows)
                wall[arm].append((time.perf_counter() - t0) * 1e3 / iters)
        prof = {arm: profile_embed(eng, rows, card, what=f" ({arm})")
                for arm, eng in (("graph", engine), ("eager", eager))}
        # the host's share of embed's serial path that no graph removes:
        # the rows' copy into a pinned staging buffer
        pinned = torch.empty(rows.shape, dtype=torch.float32,
                             pin_memory=True).numpy()
        t0 = time.perf_counter()
        for _ in range(iters):
            pinned[:] = rows
        stage_ms = (time.perf_counter() - t0) * 1e3 / iters
        out[b] = {"bitwise": bitwise, "max_abs_err": err,
                  "host_stage_copy_ms": stage_ms}
        for arm in ("graph", "eager"):
            out[b][arm] = {"wall_ms": sorted(wall[arm]),
                           "busy_ms": prof[arm]["busy_ms"],
                           "profiled_wall_ms": prof[arm]["wall_ms"]}
        print(f"slice: bucket {b} wall ms a batch, graph "
              f"{min(wall['graph']):.3f}..{max(wall['graph']):.3f} "
              f"({b / min(wall['graph']) * 1e3:.1f} img/s) vs eager "
              f"{min(wall['eager']):.3f}..{max(wall['eager']):.3f}; busy "
              f"graph {prof['graph']['busy_ms']:.3f} vs eager "
              f"{prof['eager']['busy_ms']:.3f} ms; the rows' host copy into "
              f"pinned memory {stage_ms:.3f} ms [{card}]", flush=True)
    del eager
    return out


def _zero_counters():
    from byol_tpu_torch.ops import flash_attention as fa
    from byol_tpu_torch.ops import fused_augment as fg
    from byol_tpu_torch.ops import fused_update as fu
    fa.LAUNCHES = fu.SEGMENT_NORMS_LAUNCHES = fu.FUSED_APPLY_LAUNCHES = 0
    fg.LAUNCHES = 0


def _read_counters():
    """(flash_attention, segment_norms, fused_apply, two_view) launches."""
    from byol_tpu_torch.serving.engine import kernel_launches
    return tuple(kernel_launches().values())


def _rn50_segment_map(shard=(1, 0)):
    """The segment map of the port's ResNet-50 BYOL net (heads 4096/256,
    10 classes) and its leaves' shapes, from the parameter shapes alone;
    ``shard`` = (M, i): its heads cut to model index i's shards of M."""
    from byol_tpu_torch.models.byol_net import BYOLNet, shard_heads
    from byol_tpu_torch.models.registry import get_backbone
    from byol_tpu_torch.ops import fused_update as fu
    from byol_tpu_torch.training.state import tree_order
    backbone, _ = get_backbone("resnet50")
    net = shard_heads(BYOLNet(backbone, num_classes=10), *shard)
    params = dict(net.named_parameters())
    leaves = [params[n] for n in tree_order(params)]
    return fu.segment_map_for(leaves), [p.shape for p in leaves]


def check_fused_update(card):
    """K1a and K1b against their plain versions at the ResNet-50 layout;
    returns their kernel-line entries (launches filled in later)."""
    import torch
    from byol_tpu_torch.ops import fused_update as fu
    seg, shapes = _rn50_segment_map()
    if (seg.num_segments, seg.total) != (173, RN50_PADDED):
        raise AssertionError(f"fused update: ResNet-50 layout has "
                             f"{seg.num_segments} segments, {seg.total} "
                             f"elements (want 173, {RN50_PADDED})")
    layout = fu.FusedLayout.build(seg, 1e-6, "cuda")
    real = torch.zeros(seg.total, dtype=torch.bool, device="cuda")
    for start, size in zip(seg.starts, seg.sizes):
        real[start:start + size] = True
    gen = torch.Generator(device="cuda").manual_seed(0)
    p, g, m, t = (torch.randn(seg.total, device="cuda", generator=gen)
                  * k * real for k in (0.05, 1e-3, 1e-3, 0.05))
    scale, norms = fu.segment_norms(p, g, layout)
    scale2, norms2 = fu.segment_norms(p, g, layout)
    bitwise = torch.equal(scale, scale2) and torch.equal(norms, norms2)
    ref_scale, ref_norms = fu.segment_norms_reference(p, g, layout)
    err_a = max((scale - ref_scale).abs().max().item(),
                (norms - ref_norms).abs().max().item())
    ok_a = (bitwise and torch.allclose(scale, ref_scale, **K1_TOL)
            and torch.allclose(norms, ref_norms, **K1_TOL))
    err_b, ok_b = 0.0, True
    for ema_pre in (False, True):
        got = [x.clone() for x in (p, m, t)]
        want = [x.clone() for x in (p, m, t)]
        kw = dict(lr=0.3, tau=0.99, momentum_decay=0.9, ema_pre=ema_pre)
        fu.fused_apply(got[0], g, got[1], got[2], ref_scale, layout, **kw)
        fu.fused_apply_reference(want[0], g, want[1], want[2], ref_scale,
                                 layout, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            err_b = max(err_b, (a - b).abs().max().item())
            ok_b = ok_b and torch.allclose(a, b, **K1_TOL)
    bufs = [x.clone() for x in (p, m, t)]
    apply_kw = dict(lr=1e-4, tau=0.99, momentum_decay=0.9, ema_pre=False)
    # the whole update both ways at this layout: K1a + K1b, and the
    # unfused lars_momentum chain (leaf by leaf) + the EMA tick
    from byol_tpu_torch.optim.factory import LarsMomentum
    leaves = [fu.unpack_flat(b, seg, shapes) for b in (bufs[0], g, bufs[1])]

    def unfused():
        LarsMomentum(weight_decay=1e-6).update(
            *leaves, lr=1e-4, adapted=seg.adapted)
        bufs[2].mul_(0.99).add_(bufs[0], alpha=0.01)
    fused_ms = _time_ms(lambda: fu.fused_lars_ema_update_buffers(
        bufs[0], g, bufs[1], bufs[2], layout, lr=1e-4, tau=0.99,
        momentum_decay=0.9))
    unfused_ms = _time_ms(unfused)
    print(f"fused update: K1a + K1b {fused_ms:.4f} ms, unfused chain + EMA "
          f"tick {unfused_ms:.4f} ms at {seg.num_segments} leaves [{card}]",
          flush=True)
    n_bytes = {"segment_norms": 2 * 4 * seg.total,
               "fused_apply": 7 * 4 * seg.total}
    rows = {
        "segment_norms": dict(
            ms=_device_ms(lambda: fu.segment_norms(p, g, layout)),
            plain_ms=_device_ms(
                lambda: fu.segment_norms_reference(p, g, layout)),
            eager_ms=_time_ms(lambda: fu.segment_norms(p, g, layout)),
            max_abs_err=err_a, ok=ok_a, bitwise_repeatable=bitwise),
        "fused_apply": dict(
            ms=_device_ms(lambda: fu.fused_apply(
                bufs[0], g, bufs[1], bufs[2], scale, layout, **apply_kw)),
            plain_ms=_device_ms(lambda: fu.fused_apply_reference(
                bufs[0], g, bufs[1], bufs[2], scale, layout, **apply_kw)),
            eager_ms=_time_ms(lambda: fu.fused_apply(
                bufs[0], g, bufs[1], bufs[2], scale, layout, **apply_kw)),
            max_abs_err=err_b, ok=ok_b),
    }
    # the nearest library call: torch's multi-tensor norm over the leaves
    # of p and of g (K1a's second norm is of g + wd p)
    norm_leaves = fu.unpack_flat(p, seg, shapes) + fu.unpack_flat(g, seg,
                                                                  shapes)
    library = {"segment_norms": _device_ms(
        lambda: torch._foreach_norm(norm_leaves)), "fused_apply": None}
    for name, row in rows.items():
        row.update(bound_ms=n_bytes[name] / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes", library_ms=library[name],
                   elements=seg.total)
        print(f"{name} {row} [{card}]", flush=True)
    if not (ok_a and ok_b):
        raise AssertionError(
            f"fused update disagrees with its plain version: K1a ok={ok_a} "
            f"(bitwise repeatable {bitwise}, max abs err {err_a}), K1b "
            f"ok={ok_b} (max abs err {err_b})")
    return rows


def run_training(card):
    """The training path: the headline CLI config through the trainer."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.data import device_augment as da
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.ops import fused_augment as fg
    from byol_tpu_torch.optim.factory import LarsMomentum
    from byol_tpu_torch.optim.schedules import cosine_ema_decay
    from byol_tpu_torch.training.build import build_tx, step_config
    from byol_tpu_torch.training.steps import make_train_step
    from byol_tpu_torch.training.trainer import _to_device, fit

    # fit checkpoints every epoch: under a directory of its own, removed
    # after, so that a second run of the script trains again
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cfg = config_from_args(build_parser().parse_args(
            TRAIN_ARGV + ["--model-dir", model_dir, "--log-dir",
                          os.path.join(model_dir, "logs")]))
        if not cfg.device.half:
            raise AssertionError("training: the headline run is bf16")
        loader = get_loader(cfg.replace(device=dataclasses.replace(
            cfg.device, num_replicas=1)))
        t0 = time.perf_counter()
        _zero_counters()
        result = fit(cfg, device=torch.device("cuda"), loader=loader)
        counts = _read_counters()
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    steps = len(result.step_losses)
    print(f"training: {steps} steps in {time.perf_counter() - t0:.1f}s "
          f"(build included), losses {result.step_losses}, launches "
          f"(flash, segment_norms, fused_apply, two_view) = {counts}",
          flush=True)
    if steps != 3 or not all(map(math.isfinite, result.step_losses)):
        raise AssertionError(f"training: {steps} steps, losses "
                             f"{result.step_losses}")
    if counts != (0, steps, steps, steps):
        raise AssertionError(f"training: launches {counts}, want (0, "
                             f"{steps}, {steps}, {steps})")

    # one more step on the trained state: params move, the target ticks,
    # and the plain unfused chain agrees with the kernels on the same
    # gradients (so cuDNN's non-determinism does not enter); the step's
    # draws are recorded, and its K2 views held against the unfused chain
    state = result.state
    rcfg = resolve(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)),
        num_train_samples=loader.num_train_samples,
        num_test_samples=loader.num_test_samples,
        output_size=loader.output_size, input_shape=loader.input_shape)
    tx, schedule = build_tx(rcfg)
    scfg = step_config(rcfg)
    drawn = []

    def recording_draws(step, b, h, w, microbatch):
        drawn.append(da.step_views(scfg.aug_seed, step, b, h, w,
                                   scfg.color_jitter_strength, microbatch))
        return drawn[-1]
    policy = get_policy(cfg.device.half)
    train_step = make_train_step(tx, scfg, schedule, policy,
                                 draw_views=recording_draws)
    batch = _to_device(next(iter(loader.train_loader)), "cuda")
    images = batch["images"]
    lr = schedule(state.count)
    tau = cosine_ema_decay(state.ema_step, scfg.total_train_steps,
                           scfg.base_decay)
    p0, m0, t0 = (x.clone() for x in (state.params, state.momentum,
                                      state.target))
    train_step(state, batch)
    torch.cuda.synchronize()
    moved = (state.params - p0).abs().max().item()
    ema_ok = torch.allclose(state.target, tau * t0 + (1 - tau) *
                            state.params, **K1_TOL)
    with torch.no_grad():
        LarsMomentum(weight_decay=tx.weight_decay).update(
            state.leaves(p0), state.leaves(state.grads), state.leaves(m0),
            lr=lr, adapted=state.seg.adapted)
        t0.mul_(tau).add_(p0, alpha=1 - tau)
    errs = {name: (got - want).abs().max().item()
            for name, got, want in (("p", state.params, p0),
                                    ("m", state.momentum, m0),
                                    ("t", state.target, t0))}
    chain_ok = all(torch.allclose(got, want, **K1_TOL)
                   for got, want in ((state.params, p0),
                                     (state.momentum, m0),
                                     (state.target, t0)))
    print(f"training: step {state.step}: lr {lr:.6g}, tau {tau:.6g}, params "
          f"moved by up to {moved:.3e}, target = tau t + (1-tau) p': "
          f"{ema_ok}; kernels vs plain unfused chain on the same "
          f"gradients: max abs err {errs} ok={chain_ok}", flush=True)
    if not (moved > 0 and ema_ok and chain_ok):
        raise AssertionError("training: the fused step is wrong")
    views = da.to_device(drawn[-1], "cuda")
    size = scfg.image_size
    k2 = fg.fused_two_view(images, size, views,
                           strength=scfg.color_jitter_strength)
    chain = da.two_view(images, size, views,
                        strength=scfg.color_jitter_strength)
    torch.cuda.synchronize()
    view_err = max((a - b).abs().max().item() for a, b in zip(k2, chain))
    print(f"training: step {state.step - 1}'s views, K2 vs the unfused "
          f"chain on its draws: max abs err {view_err:.3e} (tol {K2_TOL})",
          flush=True)
    if not view_err <= K2_TOL:
        raise AssertionError("training: K2's views disagree with the "
                             "unfused chain")

    # the augmentation alone at batch 64, both ways
    aug_ms = {
        "K2 path": _time_ms(lambda: fg.fused_two_view(images, size, views)),
        "unfused chain": _time_ms(lambda: da.two_view(images, size, views)),
    }
    print(f"training: two-view augmentation of a batch of 64, ms: "
          f"{ {k: round(v, 4) for k, v in aug_ms.items()} } [{card}]",
          flush=True)

    # step time at batch 64 with K2, the unfused chain and no augmentation
    # (loader placement, the un-augmented image as both views), in turns
    plain = dataclasses.replace(scfg, fused_augment=False)
    bare = dataclasses.replace(scfg, augment_in_step=False,
                               fused_augment=False)
    x = images.float() / 255.0
    arms = {
        "K2": (make_train_step(tx, scfg, schedule, policy), batch),
        "unfused chain": (make_train_step(tx, plain, schedule, policy),
                          batch),
        "no augmentation": (make_train_step(tx, bare, schedule, policy),
                            {"view1": x, "view2": x,
                             "label": batch["label"]}),
    }
    times = {name: [] for name in arms}
    for name in list(arms) + list(arms)[::-1]:
        fn, b = arms[name]
        for _ in range(2):
            fn(state, b)
        torch.cuda.synchronize()
        t0_wall = time.perf_counter()
        for _ in range(10):
            fn(state, b)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0_wall) * 1e3 / 10)
    for name, ms in times.items():
        print(f"training: batch 64 step, {name}: {ms[0]:.3f} / {ms[1]:.3f} "
              f"ms = {64 / min(ms) * 1e3:.1f} img/s at best, 10 steps each "
              f"(peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB) [{card}]", flush=True)

    for name, (fn, b) in arms.items():
        _device_profile(lambda: fn(state, b), 3, card,
                        f"resnet50 train step, {name}, batch 64, per step",
                        top=10 if name == "K2" else 0)
    return counts


def _trees_bitwise(a, b):
    """Two canonical trees hold the same keys, ints and bits."""
    import torch
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_trees_bitwise(a[k], b[k]) for k in a))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def _states_bitwise(a, b):
    """Every flat buffer, BatchNorm statistic and counter of two states."""
    import torch
    sa, sb = a.batch_stats(), b.batch_stats()
    return (all(torch.equal(getattr(a, n), getattr(b, n))
                for n in ("params", "target", "momentum"))
            and sa.keys() == sb.keys()
            and all(torch.equal(sa[k], sb[k]) for k in sa)
            and (a.step, a.count, a.ema_step) == (b.step, b.count,
                                                  b.ema_step))


def _batch64_spans(log, result, card):
    """Where a batch-64 step's wall time goes on the host, from the flight
    recorder of a run's steady epoch (the last: the first carries
    startup): the enqueue of its kernels (train/dispatch), the wait for
    the card at the epoch's end (train/epoch_readback) and for input."""
    from byol_tpu_torch.observability.events import read_events
    evs = list(read_events(log))
    stats = [e for e in evs if e["kind"] == "span_stats"][-1]["spans"]
    good = [e for e in evs if e["kind"] == "goodput"
            and e["scope"] == "epoch"][-1]
    steps = stats["train/dispatch"]["count"]
    per_step = {n: stats[n]["seconds"] * 1e3 / steps for n in (
        "train/dispatch", "train/epoch_readback", "input/wait")
        if n in stats}
    print(f"checkpoint: batch 64 spans, epoch {good['epoch']}: {steps} "
          f"steps, ms per step {dict((n, round(v, 3)) for n, v in per_step.items())}"
          f", dispatch p50 {stats['train/dispatch']['p50_ms']:.3f} ms; the "
          f"trainer's wall {result.step_ms:.3f} ms/step; goodput "
          f"{good['goodput_fraction']:.1%} of the epoch's "
          f"{good['wall_seconds']:.3f} s [{card}]", flush=True)


def run_checkpoint(card):
    """The checkpoint path: the headline training config without
    --debug-step, 2 epochs of 8 steps, under a temporary --model-dir,
    cuDNN deterministic.  An uninterrupted run; a run that takes SIGTERM
    mid-epoch and its relaunch; save and restore on their own; serving the
    trained checkpoint.  Returns the launch counts of the uninterrupted run
    and of the relaunch."""
    import dataclasses
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch
    from byol_tpu_torch.checkpoint import CheckpointStore
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve, run_name
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.serving import cli as serve_cli
    from byol_tpu_torch.serving.service import ServeConfig, build_service
    from byol_tpu_torch.training import trainer
    from byol_tpu_torch.training.linear_eval import frozen_representation_fn
    from byol_tpu_torch.training.state import canonical_state, load_canonical

    cuda = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.backends.cudnn.deterministic = True
    try:
        def config(name):
            return config_from_args(build_parser().parse_args(
                CKPT_ARGV + ["--model-dir", os.path.join(root, name),
                             "--log-dir", os.path.join(root, "logs")]))

        def run_dir(cfg):
            return os.path.join(cfg.model.model_dir, run_name(cfg))

        # 1. uninterrupted
        cfg1 = config("uninterrupted")
        loader = get_loader(cfg1)
        t0 = time.perf_counter()
        _zero_counters()
        run1 = trainer.fit(cfg1, device=cuda, loader=loader)
        counts1 = _read_counters()
        losses1 = run1.step_losses
        print(f"checkpoint: uninterrupted: {len(losses1)} steps in "
              f"{time.perf_counter() - t0:.1f}s, step {run1.state.step}, "
              f"launches (flash, segment_norms, fused_apply, two_view) = "
              f"{counts1}, test losses {run1.test_losses} [{card}]",
              flush=True)
        if (len(losses1) != CKPT_STEPS or run1.state.step != CKPT_STEPS
                or not all(map(math.isfinite, losses1 + run1.test_losses))):
            raise AssertionError(f"checkpoint: uninterrupted run took "
                                 f"{len(losses1)} steps, losses {losses1}")
        if counts1 != (0, CKPT_STEPS, CKPT_STEPS, CKPT_STEPS):
            raise AssertionError(f"checkpoint: launches {counts1}")
        _batch64_spans(os.path.join(cfg1.task.log_dir, run_name(cfg1),
                                    "run.jsonl"), run1, card)
        store = CheckpointStore(run_dir(cfg1))
        epochs, meta = store.epochs(), store.read_meta()
        store.close()
        m0, m1 = run1.test_losses
        better = m1 < m0       # the JAX saver's rules; burn-in int(0.1 * 2)
        want = {"last_epoch": 1, "larger_is_better": False,
                "history": [{"epoch": 0, "metric": m0},
                            {"epoch": 1, "metric": m1}],
                "best_epoch": 1 if better else 0,
                "best_metric": m1 if better else m0,
                "stall_count": 0 if better else 1}
        print(f"checkpoint: uninterrupted: ckpt epochs {epochs}, meta.json "
              f"{meta}", flush=True)
        if epochs != (0, 1) or meta != want:
            raise AssertionError(f"checkpoint: epochs {epochs}, meta {meta}, "
                                 f"want {want}")

        # 2. SIGTERM mid-epoch, then the relaunch
        cfg2 = config("interrupted")
        sig_epoch, sig_after = SIGTERM_AFTER

        def signalling(epoch):
            for i, batch in enumerate(loader.make_train_iter(epoch)):
                yield batch
                if (epoch, i + 1) == SIGTERM_AFTER:
                    signal.raise_signal(signal.SIGTERM)
        live = []
        real_setup = trainer.setup_training

        def recording_setup(*args, **kwargs):
            out = real_setup(*args, **kwargs)
            live.append(out[1])
            return out
        trainer.setup_training = recording_setup
        code = None
        try:
            trainer.fit(cfg2, device=cuda, loader=dataclasses.replace(
                loader, make_train_iter=signalling))
        except SystemExit as e:
            code = e.code
        finally:
            trainer.setup_training = real_setup
        s = live[0].step
        store = CheckpointStore(run_dir(cfg2))
        tree, at_epoch = store.restore()
        store.close()
        same = _trees_bitwise(tree, canonical_state(live[0]))
        print(f"checkpoint: SIGTERM after batch {sig_after} of epoch "
              f"{sig_epoch}: exit {code}, checkpoint of epoch {at_epoch} at "
              f"step s = {tree['step']} (live step {s}); saved tree == live "
              f"state bitwise: {same}", flush=True)
        if (code != 143 or at_epoch != sig_epoch or tree["step"] != s
                or not 9 <= s <= 15 or not same):
            raise AssertionError("checkpoint: the SIGTERM checkpoint is wrong")
        del live[:]
        drawn = {}

        def counting(epoch):
            for batch in loader.make_train_iter(epoch):
                drawn[epoch] = drawn.get(epoch, 0) + 1
                yield batch
        _zero_counters()
        run2 = trainer.fit(cfg2, device=cuda, loader=dataclasses.replace(
            loader, make_train_iter=counting))
        counts2 = _read_counters()
        k = CKPT_STEPS - s
        want_losses = losses1[s:]
        err = max(abs(a - b) for a, b in zip(run2.step_losses, want_losses))
        close = bool(np.allclose(run2.step_losses, want_losses,
                                 rtol=SLICE_TOL, atol=SLICE_TOL))
        bitwise = run2.step_losses == want_losses
        state_err = (run2.state.params - run1.state.params).abs().max().item()
        print(f"checkpoint: relaunch: batches drawn per epoch {drawn} (epoch "
              f"1 re-entered at batch {s - 8}), {len(run2.step_losses)} "
              f"steps to step {run2.state.step}, launches {counts2}; losses "
              f"of steps {s + 1}..{CKPT_STEPS} vs the uninterrupted run's: "
              f"max abs err {err:.3e} (rtol = atol = {SLICE_TOL}) "
              f"ok={close}, bitwise {bitwise} under deterministic cuDNN; "
              f"final params max abs diff {state_err:.3e}, whole state "
              f"bitwise {_states_bitwise(run2.state, run1.state)} "
              f"[{card}]", flush=True)
        if (drawn != {1: 8} or len(run2.step_losses) != k
                or run2.state.step != CKPT_STEPS or counts2 != (0, k, k, k)
                or not close):
            raise AssertionError("checkpoint: the relaunch is wrong")

        # 3. save and restore on their own, at the trained state
        state = run1.state
        store = CheckpointStore(os.path.join(root, "alone"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = canonical_state(state)
        t1 = time.perf_counter()
        store.save(0, tree)
        t2 = time.perf_counter()
        store.wait()
        t3 = time.perf_counter()
        path = os.path.join(store.directory, "ckpt-0", "state.pt")
        n_bytes = os.path.getsize(path)
        rcfg = resolve(cfg1.replace(device=dataclasses.replace(
            cfg1.device, num_replicas=1)),
            num_train_samples=loader.num_train_samples,
            num_test_samples=loader.num_test_samples,
            output_size=loader.output_size, input_shape=loader.input_shape)
        fresh = real_setup(rcfg, cuda,
                           generator=torch.Generator().manual_seed(99))[1]
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        back, _ = store.restore(epoch=0)
        t5 = time.perf_counter()
        load_canonical(fresh, back)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        store.close()
        restored = _states_bitwise(fresh, state)
        print(f"checkpoint: save alone: snapshot (device to host, "
              f"canonical tree) {(t1 - t0) * 1e3:.1f} ms, save() call "
              f"{(t2 - t1) * 1e3:.1f} ms, write on the thread until wait() "
              f"returns {(t3 - t1) * 1e3:.1f} ms, file {n_bytes} bytes "
              f"({n_bytes / (t3 - t1) / 1e9:.2f} GB/s); restore: read "
              f"{(t5 - t4) * 1e3:.1f} ms, load_canonical (host to device) "
              f"{(t6 - t5) * 1e3:.1f} ms; restored state bitwise: "
              f"{restored} [{card}]", flush=True)
        if not restored:
            raise AssertionError("checkpoint: restore is not bitwise")
        del fresh, back, tree

        # 4. serve the uninterrupted run's checkpoint
        serve_argv = ["--arch", "resnet50", "--image-size-override", "224",
                      "--checkpoint", run_dir(cfg1)]
        _zero_counters()
        rc = serve_cli.main(serve_argv + ["--smoke", "24", "--log-dir",
                                          os.path.join(root, "logs")])
        served_counts = _read_counters()
        print(f"checkpoint: serve --checkpoint --smoke 24: rc {rc}, "
              f"launches {served_counts}", flush=True)
        if rc != 0 or served_counts != (0, 0, 0, 0):
            raise AssertionError("checkpoint: serving the checkpoint failed")
        scfg = serve_cli.config_from_args(
            serve_cli.build_serve_parser().parse_args(serve_argv))
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        service = build_service(scfg, ServeConfig(min_bucket=8,
                                                  max_bucket=64),
                                checkpoint_dir=run_dir(cfg1), device=cuda)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - before
        param_bytes = 4 * sum(state.seg.sizes)
        stat_bytes = sum(b.numel() * b.element_size()
                         for b in state.batch_stats().values())
        # the service keeps its weights in bf16: their bytes, the fp32
        # statistics and 8 MiB of slack; a leaked momentum or target tree
        # (70 MB even in bf16) overshoots this by far
        resident_limit = param_bytes // 2 + stat_bytes + 8 * 2**20
        rows8 = np.random.RandomState(3).rand(8, 224, 224, 3).astype(
            np.float32)
        got = service.engine.embed(rows8)
        want = frozen_representation_fn(state.net, half=True)(
            torch.from_numpy(rows8).to(cuda)).cpu().numpy()
        emb_err = float(np.abs(got - want).max())
        emb_ok = bool(np.allclose(got, want, rtol=SLICE_TOL, atol=SLICE_TOL))
        print(f"checkpoint: served bucket 8 vs the trained state's "
              f"frozen_representation_fn, bf16: max abs err {emb_err:.5f} "
              f"(rtol = atol = {SLICE_TOL}) ok={emb_ok}; the service holds "
              f"{resident} bytes on the card, limit {resident_limit} = bf16 "
              f"params {param_bytes // 2} + statistics {stat_bytes} + 8 MiB "
              f"(momentum + target would add {param_bytes} in bf16) "
              f"[{card}]", flush=True)
        if got.shape != (8, 2048) or not emb_ok:
            raise AssertionError("checkpoint: served embeddings disagree")
        if resident > resident_limit:
            raise AssertionError("checkpoint: serving holds more than the "
                                 "forward pass's weights on the card")
        del service
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    return counts1, counts2


# the input phase: the slice's command under loader placement, 2 epochs of
# 4 steps (256 fake images at batch 64), each data backend making the views
INPUT_ARGV = ["--task", "fake", "--arch", "resnet50",
              "--image-size-override", "224", "--batch-size", "64",
              "--epochs", "2", "--fused-update", "on"]
INPUT_SAMPLES = 256
INPUT_VALID_SAMPLES = 344          # 86 held out by --valid-fraction 0.25
INPUT_STEPS = 8
INPUT_SHORT_SAMPLES = 128          # the paper spec's run: 1 epoch, 2 steps
INPUT_TIMED = 4                    # timed steps per arm and turn
IMAGE_TREE = (2, 64, 256)          # classes, train images each, pixels


def _views_ok(batch):
    """view1 != view2 in every row, both in [0, 1] (host arrays or card
    tensors)."""
    import torch
    v1, v2 = (torch.as_tensor(batch[k]) for k in ("view1", "view2"))
    differ = (v1 != v2).flatten(1).any(1).all().item()
    return bool(differ and min(v1.min().item(), v2.min().item()) >= 0.0
                and max(v1.max().item(), v2.max().item()) <= 1.0)


def _input_config(extra, model_dir):
    from byol_tpu_torch.cli import build_parser, config_from_args
    return config_from_args(build_parser().parse_args(
        INPUT_ARGV + extra + ["--model-dir", model_dir, "--log-dir",
                              os.path.join(model_dir, "logs")]))


def _input_run(name, extra, model_dir, samples=INPUT_SAMPLES,
               steps=INPUT_STEPS, loader_fn=None):
    """One run of the slice's command through the CLI's config and the
    trainer, every train batch checked on its way in; -> (result,
    launch counts)."""
    import dataclasses

    import torch
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.training.trainer import fit

    cuda = torch.device("cuda")
    cfg = _input_config(extra, model_dir)
    loader = (loader_fn(cfg) if loader_fn is not None else
              get_loader(cfg, num_fake_samples=samples, device=cuda))
    checked = []

    def checking(epoch):
        for batch in loader.make_train_iter(epoch):
            checked.append(_views_ok(batch))
            yield batch
    t0 = time.perf_counter()
    _zero_counters()
    result = fit(cfg, device=cuda, loader=dataclasses.replace(
        loader, make_train_iter=checking))
    counts = _read_counters()
    n = len(result.step_losses)
    print(f"input: {name}: {n} steps in {time.perf_counter() - t0:.1f}s, "
          f"losses {[round(x, 4) for x in result.step_losses]}, valid "
          f"losses {result.valid_losses}, launches (flash, segment_norms, "
          f"fused_apply, two_view) = {counts}, {len(checked)} batches drawn, "
          f"view1 != view2 in every row and both in [0, 1]: {all(checked)}",
          flush=True)
    if (n != steps or not all(map(math.isfinite, result.step_losses))
            or counts != (0, n, n, 0) or not checked or not all(checked)):
        raise AssertionError(f"input: {name}: the run is wrong")
    return result, counts


def _input_arms(card, model_dir):
    """Steps of ResNet-50 at batch 64 with each backend making the views
    (through prefetch_to_device, the trainer's feed) beside the step
    placement's K2 path: INPUT_TIMED timed steps per arm, one turn each,
    and a torch.profiler breakdown of 3 more steps on the pipeline that
    turn started (a spawned worker pool takes ~14 s to fill, so each turn
    pays for one)."""
    import dataclasses

    import torch
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.data.prefetch import prefetch_to_device
    from byol_tpu_torch.observability.meters import InputPipelineMeter
    from byol_tpu_torch.training.build import (build_tx, setup_training,
                                               step_config)
    from byol_tpu_torch.training.steps import make_train_step

    cuda = torch.device("cuda")
    # one tf arm: a second pool (6 workers) cost another ~15 s start
    arms = {"tf, 2 workers": ["--data-backend", "tf"],
            "native, 2 threads": ["--data-backend", "native"],
            "native, 6 threads": ["--data-backend", "native",
                                  "--workers-per-replica", "6"],
            "device": ["--data-backend", "device"],
            "step placement, K2": ["--augment-placement", "step",
                                   "--fused-augment", "on"]}
    state = None
    feeds = {}
    for name, extra in arms.items():
        cfg = _input_config(extra, model_dir)
        cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                     num_replicas=1))
        loader = get_loader(cfg, num_fake_samples=INPUT_SAMPLES, device=cuda)
        rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                       num_test_samples=loader.num_test_samples,
                       output_size=loader.output_size,
                       input_shape=loader.input_shape)
        if state is None:
            state = setup_training(rcfg, cuda)[1]
        tx, schedule = build_tx(rcfg)
        step = make_train_step(tx, step_config(rcfg), schedule,
                               get_policy(cfg.device.half))

        def endless(loader=loader):
            epoch = 0
            while True:
                yield from loader.make_train_iter(epoch)
                epoch += 1
        feeds[name] = [step, endless, cfg.device.workers_per_replica]

    profiles = {}

    def timed(name, profile):
        """-> (ms per step, starved steps, waited s, h2d bytes per step)
        over the timed steps, after 2 that fill the pipeline; with
        ``profile`` 3 more steps under the profiler."""
        step, endless, _ = feeds[name]
        meter = InputPipelineMeter()
        batches = prefetch_to_device(endless(), cuda, meter=meter)
        try:
            for _ in range(2):
                step(state, next(batches))
            torch.cuda.synchronize()
            starved, waited = meter.starved_steps, meter.wait_seconds
            t0 = time.perf_counter()
            for _ in range(INPUT_TIMED):
                step(state, next(batches))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / INPUT_TIMED
            if profile:
                profiles[name] = _device_profile(
                    lambda: step(state, next(batches)), 3, card,
                    f"input arm {name}, resnet50 train step at batch 64, "
                    f"per step", top=0, host=False)
            return (ms, meter.starved_steps - starved,
                    meter.wait_seconds - waited, meter.h2d_bytes_per_step())
        finally:
            batches.close()

    turns = {name: [timed(name, profile=True)] for name in arms}
    rows = {}
    for name in arms:
        workers = feeds[name][2]
        prof = profiles[name]
        ms = [t[0] for t in turns[name]]
        rows[name] = dict(
            ms=ms, img_s=64e3 / min(ms), busy_ms=prof["busy_ms"],
            wall_ms=prof["wall_ms"], h2d_mib=turns[name][0][3] / 2**20,
            starved=[t[1] for t in turns[name]],
            waited_ms=[round(t[2] * 1e3, 1) for t in turns[name]],
            workers=workers)
        print(f"input: arm {name}: {ms[0]:.3f} ms per step = "
              f"{rows[name]['img_s']:.1f} img/s, {INPUT_TIMED} timed "
              f"steps; starved steps {rows[name]['starved']} of "
              f"{INPUT_TIMED}, waited {rows[name]['waited_ms']} ms; h2d "
              f"{rows[name]['h2d_mib']:.2f} MiB/step; profiled 3 steps: "
              f"device busy {prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} "
              f"ms ({prof['busy_ms'] / prof['wall_ms']:.1%}); "
              f"os.cpu_count() {os.cpu_count()}, workers or threads "
              f"{workers} [{card}]", flush=True)
    return rows


def _write_image_tree(root):
    import numpy as np
    from PIL import Image
    classes, per_class, px = IMAGE_TREE
    rng = np.random.RandomState(0)
    for split, n in (("train", per_class), ("test", per_class // 8)):
        for c in range(classes):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d)
            for i in range(n):
                img = rng.randint(0, 256, (px, px, 3), dtype=np.uint8)
                Image.fromarray(img).save(os.path.join(d, f"{i}.jpg"),
                                          quality=90)


def run_input(card):
    """The input phase: the slice's command under loader placement with
    each data backend, the paper spec, synth, the timed arms and
    image_folder.  Returns the launch counts of each run."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from byol_tpu_torch.data.loader import get_loader

    root = tempfile.mkdtemp(prefix="chip_smoke_input_")
    counts = {}
    try:
        for backend, extra, samples in (
                ("tf", [], INPUT_SAMPLES),
                ("native", ["--valid-fraction", "0.25"], INPUT_VALID_SAMPLES),
                ("device", [], INPUT_SAMPLES)):
            result, counts[f"input, {backend}"] = _input_run(
                f"--data-backend {backend} {' '.join(extra)}".strip(),
                ["--data-backend", backend] + extra,
                os.path.join(root, backend), samples=samples)
            if extra and len(result.valid_losses) != 2:
                raise AssertionError("input: the valid split was not "
                                     "evaluated each epoch")
        _, counts["input, tf, paper spec"] = _input_run(
            "--data-backend tf --aug-spec paper",
            ["--data-backend", "tf", "--aug-spec", "paper", "--epochs", "1",
             "--workers-per-replica", "0"],
            os.path.join(root, "paper"), samples=INPUT_SHORT_SAMPLES, steps=2)
        result, counts["input, synth, native"] = _input_run(
            "--task synth --data-backend native --warmup 0",
            ["--task", "synth", "--data-backend", "native", "--warmup", "0",
             "--num-synth-samples", str(INPUT_SAMPLES)],
            os.path.join(root, "synth"))
        losses = result.step_losses
        fell = np.mean(losses[-3:]) < np.mean(losses[:3])
        print(f"input: synth loss falls over the {len(losses)} steps (mean "
              f"of the last 3 {np.mean(losses[-3:]):.4f} < first 3 "
              f"{np.mean(losses[:3]):.4f}): {fell}", flush=True)
        if not fell:
            raise AssertionError("input: the synth loss did not fall")

        torch.cuda.empty_cache()
        rows = _input_arms(card, os.path.join(root, "arms"))
        torch.cuda.empty_cache()

        tree = os.path.join(root, "tree")
        t0 = time.perf_counter()
        _write_image_tree(tree)
        print(f"input: image tree {IMAGE_TREE[0]} classes x "
              f"{IMAGE_TREE[1]} JPEGs at {IMAGE_TREE[2]} px written in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        from byol_tpu_torch.data import native_aug
        # without libjpeg the native run IS a tf run: one run covers both
        backends = (("native", "tf") if native_aug.has_jpeg()
                    else ("native",))
        for backend in backends:
            _, counts[f"input, image_folder, {backend}"] = _input_run(
                f"--task image_folder --data-backend {backend}",
                ["--task", "image_folder", "--data-dir", tree,
                 "--data-backend", backend, "--epochs", "1"],
                os.path.join(root, f"if_{backend}"), steps=2,
                loader_fn=lambda cfg: get_loader(cfg, device="cuda"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, rows


ACCUM_ARGV = ["--task", "fake", "--arch", "resnet50",
              "--image-size-override", "224", "--batch-size", "4096",
              "--accum-bn-mode", "average", "--augment-placement", "step",
              "--fused-augment", "on", "--fused-update", "on",
              "--polyak-ema", "0.99", "--epochs", "1"]
ACCUM_BATCH = 4096                 # the recipe's batch
ACCUM_SAMPLES = 4096               # fake images: 1 optimizer step
ACCUM_STEPS = ACCUM_SAMPLES // 4096
ACCUM_MICRO = (256, 128)           # microbatch, and the fallback over 75 GB
ACCUM_MEMORY_LIMIT = 75e9          # bytes a step may peak at on the card
ACCUM_SLACK = 2**30                # peak of k steps over one: + the batch
ACCUM_CHECK = (256, 4)             # effective batch, microbatches


def _peak_bytes(fn):
    """max_memory_allocated over one call of ``fn``."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated()


def _accum_checks(state, make_step, scfg, images, labels, card):
    """At effective 256 = 4 x 64 on one set of views (loader placement,
    made by K2 from the batch's first 256 images): 'global' against one
    k = 1 step in loss (bf16 3e-2), and 'average' against 'microbatch' in
    the mean gradient (rtol 1e-5, cuDNN deterministic); the state is
    restored from one snapshot before each step."""
    import dataclasses

    import torch
    from byol_tpu_torch.data import device_augment as da
    from byol_tpu_torch.ops import fused_augment as fg
    from byol_tpu_torch.training.state import canonical_state, load_canonical
    rows, k = ACCUM_CHECK
    x = images[:rows].contiguous()
    views = da.to_device(da.step_views(scfg.aug_seed, state.step, rows,
                                       x.shape[1], x.shape[2],
                                       scfg.color_jitter_strength), "cuda")
    v1, v2 = fg.fused_two_view(x, scfg.image_size, views,
                               strength=scfg.color_jitter_strength)
    batch = {"view1": v1, "view2": v2, "label": labels[:rows]}
    on_views = dataclasses.replace(scfg, augment_in_step=False,
                                   fused_augment=False)
    snapshot = canonical_state(state)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, steps, mode in (("k=1", 1, "average"),
                                  ("global", k, "global"),
                                  ("average", k, "average"),
                                  ("microbatch", k, "microbatch")):
            step = make_step(dataclasses.replace(
                on_views, accum_steps=steps, accum_bn_mode=mode))
            loss = float(step(state, batch)["loss_mean"])
            out[name] = (loss, state.grads.clone())
            load_canonical(state, snapshot)
    finally:
        torch.backends.cudnn.deterministic = False
    global_ok = math.isclose(out["global"][0], out["k=1"][0],
                             rel_tol=SLICE_TOL, abs_tol=SLICE_TOL)
    ga, gm = out["average"][1], out["microbatch"][1]
    grad_err = (ga - gm).abs().max().item()
    grad_ok = torch.allclose(gm, ga, rtol=1e-5,
                             atol=1e-7 * ga.abs().max().item())
    print(f"accum: effective {rows} = {k} x {rows // k}, the same views: "
          f"loss k=1 {out['k=1'][0]:.6f}, global {out['global'][0]:.6f} "
          f"(bf16 tol {SLICE_TOL}: {global_ok}); average {out['average'][0]:.6f}"
          f", microbatch {out['microbatch'][0]:.6f}; their mean gradients: "
          f"max abs diff {grad_err:.3e}, bitwise {torch.equal(ga, gm)}, "
          f"rtol 1e-5: {grad_ok} [{card}]", flush=True)
    if not (global_ok and grad_ok):
        raise AssertionError("accum: global vs k=1 or average vs microbatch "
                             "disagree")


def run_accum(card):
    """The slice's command at the recipe's batch: 4096 as k microbatches
    of 256 (128 if a 256 step peaks above 75 GB), fake images, 2
    optimizer steps, through the CLI's config and the trainer, counters
    set to 0 before and read after; then peak memory of a k-step against a
    k = 1 step at the microbatch size, busy and wall ms per optimizer step,
    and the checks at effective 256.  Returns the launch counts and the
    phase's numbers."""
    import dataclasses
    import gc
    import shutil
    import tempfile

    import torch
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.training.build import (build_tx, setup_training,
                                               step_config)
    from byol_tpu_torch.training.steps import make_train_step
    from byol_tpu_torch.training.trainer import _to_device, fit

    cuda = torch.device("cuda")
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_accum_")
    try:
        def config(micro):
            return config_from_args(build_parser().parse_args(
                ACCUM_ARGV + ["--accum-steps", str(ACCUM_BATCH // micro),
                              "--model-dir", model_dir, "--log-dir",
                              os.path.join(model_dir, "logs")]))

        def resolved(cfg):
            return resolve(cfg.replace(device=dataclasses.replace(
                cfg.device, num_replicas=1)),
                num_train_samples=loader.num_train_samples,
                num_test_samples=loader.num_test_samples,
                output_size=loader.output_size,
                input_shape=loader.input_shape)

        cfg = config(ACCUM_MICRO[0])
        loader = get_loader(cfg.replace(device=dataclasses.replace(
            cfg.device, num_replicas=1)), num_fake_samples=ACCUM_SAMPLES)
        host = next(iter(loader.train_loader))

        # which microbatch: one k = 1 step of 256 on a fresh state
        rcfg = resolved(cfg)
        _, probe, _, _, _ = setup_training(rcfg, cuda)
        tx, schedule = build_tx(rcfg)
        policy = get_policy(cfg.device.half)
        one = make_train_step(tx, dataclasses.replace(
            step_config(rcfg), accum_steps=1), schedule, policy)
        small = _to_device({k: v[:ACCUM_MICRO[0]] for k, v in host.items()},
                           cuda)
        probe_peak = _peak_bytes(lambda: one(probe, small))
        micro = (ACCUM_MICRO[0] if probe_peak <= ACCUM_MEMORY_LIMIT
                 else ACCUM_MICRO[1])
        print(f"accum: a k=1 step of {ACCUM_MICRO[0]} peaks at "
              f"{probe_peak / 1e9:.2f} GB (limit {ACCUM_MEMORY_LIMIT / 1e9:.0f}"
              f" GB): microbatch {micro}, k = {ACCUM_BATCH // micro} [{card}]",
              flush=True)
        del probe, one, small
        gc.collect()
        torch.cuda.empty_cache()

        cfg = config(micro)
        k = cfg.optim.accum_steps
        t0 = time.perf_counter()
        _zero_counters()
        torch.cuda.reset_peak_memory_stats()
        result = fit(cfg, device=cuda, loader=loader)
        counts = _read_counters()
        fit_peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    steps = len(result.step_losses)
    print(f"accum: {steps} optimizer steps of {ACCUM_BATCH} = {k} x {micro} "
          f"in {time.perf_counter() - t0:.1f}s (setup and eval included), "
          f"losses {result.step_losses}, test loss "
          f"{result.test_metrics['loss_mean']:.4f} (Polyak params), launches "
          f"(flash, segment_norms, fused_apply, two_view) = {counts}, peak "
          f"{fit_peak / 1e9:.2f} GB [{card}]", flush=True)
    if steps != ACCUM_STEPS or not all(map(math.isfinite,
                                           result.step_losses + [
            result.test_metrics["loss_mean"]])):
        raise AssertionError(f"accum: {steps} steps, losses "
                             f"{result.step_losses}")
    if counts != (0, steps, steps, k * steps):
        raise AssertionError(f"accum: launches {counts}, want (0, {steps}, "
                             f"{steps}, {k * steps})")

    # peak memory: a k-step on the recipe's batch against one k = 1 step
    # on a microbatch, each with only its own batch on the card
    state = result.state
    rcfg = resolved(cfg)
    tx, schedule = build_tx(rcfg)
    scfg = step_config(rcfg)
    policy = get_policy(cfg.device.half)

    def make_step(c):
        return make_train_step(tx, c, schedule, policy)
    accum_step = make_step(scfg)
    one = make_step(dataclasses.replace(scfg, accum_steps=1))
    small = _to_device({n: v[:micro] for n, v in host.items()}, cuda)
    gc.collect()
    torch.cuda.empty_cache()
    peak_1 = _peak_bytes(lambda: one(state, small))
    del small
    big = _to_device(host, cuda)
    batch_bytes = sum(t.numel() * t.element_size() for t in big.values())
    peak_k = _peak_bytes(lambda: accum_step(state, big))
    bound = peak_1 + batch_bytes * (1 - 1 / k) + ACCUM_SLACK
    memory_ok = peak_k <= bound and peak_k <= ACCUM_MEMORY_LIMIT
    print(f"accum: peak memory, a k={k} step of {ACCUM_BATCH}: "
          f"{peak_k / 1e9:.3f} GB; a k=1 step of {micro}: {peak_1 / 1e9:.3f}"
          f" GB; bound = that + the rest of the uint8 batch "
          f"({batch_bytes * (1 - 1 / k) / 1e6:.1f} MB) + 1 GiB = "
          f"{bound / 1e9:.3f} GB: {memory_ok} [{card}]", flush=True)
    if not memory_ok:
        raise AssertionError("accum: a k-step holds more than one "
                             "microbatch's graph")

    # wall ms of an optimizer step (1 step: ~5 s of device work dwarfs the
    # host's jitter) and device-busy ms (1 profiled)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accum_step(state, big)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # the card alone: a host trace of 16 microbatches' operators takes
    # ~45 s to process
    prof = _device_profile(lambda: accum_step(state, big), 1, card,
                           f"resnet50 optimizer step of {ACCUM_BATCH} = {k} "
                           f"x {micro}, per step", host=False)
    row = {"microbatch": micro, "k": k, "wall_ms": wall_ms,
           "img_per_s": ACCUM_BATCH / wall_ms * 1e3,
           "busy_ms": prof["busy_ms"], "profiled_wall_ms": prof["wall_ms"],
           "busy_share": prof["busy_ms"] / prof["wall_ms"],
           "peak_k_bytes": peak_k, "peak_1_bytes": peak_1,
           "fit_peak_bytes": fit_peak}
    print(f"accum: optimizer step of {ACCUM_BATCH} = {k} x {micro}: wall "
          f"{wall_ms:.1f} ms ({row['img_per_s']:.1f} img/s, 1 step), device "
          f"busy {prof['busy_ms']:.1f} ms of a profiled {prof['wall_ms']:.1f} "
          f"ms ({row['busy_share']:.1%}) [{card}]", flush=True)

    _accum_checks(state, make_step, scfg, big["images"], big["label"], card)
    return counts, row


def _serving_split(records, card):
    """The serving worker's wall time over the served window, split by its
    top-level spans (serve/batch = stage + dispatch, serve/readback) and
    the rest (waiting for requests, coalescing)."""
    from byol_tpu_torch.observability.goodput import span_stats
    served = [r for r in records if r.name.startswith("serve/")]
    top = [r for r in served if r.depth == 0]
    wall = max(r.t1 for r in served) - min(r.t0 for r in served)
    split = {}
    for r in top:
        split[r.name] = split.get(r.name, 0.0) + r.seconds
    split["idle (no top-level span)"] = wall - sum(split.values())
    print(f"slice: serving goodput split over {wall * 1e3:.1f} ms of the "
          f"worker's served window: "
          f"{ {k: f'{v * 1e3:.1f} ms ({v / wall:.1%})' for k, v in split.items()} }"
          f" [{card}]", flush=True)
    print(f"slice: serving span_stats "
          f"{ {k: {f: round(x, 3) for f, x in v.items()} for k, v in span_stats(served).items()} }",
          flush=True)


OBSERVE_ARGV = ["--telemetry", "step", "--telemetry-interval", "1",
                "--nan-policy", "halt", "--spans", "on", "--grapher", "jsonl"]
# the NaN halt: loader placement, views made on the card from host draws
HALT_ARGV = ["--task", "fake", "--arch", "resnet50", "--image-size-override",
             "224", "--batch-size", "64", "--epochs", "1", "--fused-update",
             "on", "--data-backend", "device"] + OBSERVE_ARGV
HALT_AT = 2                        # the optimizer step fed the NaN batch
OBSERVE_64 = 5                     # timed steps per telemetry arm at 64


def _observe_main(card, micro, root):
    """(a) The slice's main path: the accum phase's command with the
    observability flags, counters set to 0 before and read after; its
    run.jsonl read back strictly and checked.  -> (launch counts, row,
    the trained state, the host batch, the loader's config)."""
    import dataclasses

    import torch
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import run_name
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.observability import health
    from byol_tpu_torch.observability.events import read_events
    from byol_tpu_torch.ops import fused_update as fu
    from byol_tpu_torch.training.trainer import fit

    cfg = config_from_args(build_parser().parse_args(
        ACCUM_ARGV + OBSERVE_ARGV + [
            "--accum-steps", str(ACCUM_BATCH // micro), "--model-dir",
            os.path.join(root, "models"), "--log-dir",
            os.path.join(root, "logs")]))
    k = cfg.optim.accum_steps
    loader = get_loader(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)), num_fake_samples=ACCUM_SAMPLES)
    # K1a's own trust vector of every step, as its wrapper returns it
    returned = []
    real = fu.fused_lars_ema_update_buffers

    def spy(*args, **kw):
        out = real(*args, **kw)
        returned.append(out.clone())
        return out
    fu.fused_lars_ema_update_buffers = spy
    try:
        t0 = time.perf_counter()
        _zero_counters()
        result = fit(cfg, device=torch.device("cuda"), loader=loader)
        counts = _read_counters()
    finally:
        fu.fused_lars_ema_update_buffers = real
    wall = time.perf_counter() - t0
    steps = len(result.step_losses)
    log = os.path.join(cfg.task.log_dir, run_name(cfg), "run.jsonl")
    evs = list(read_events(log))
    kinds = [e["kind"] for e in evs]
    print(f"observe: {steps} optimizer steps of {ACCUM_BATCH} = {k} x "
          f"{micro} with {' '.join(OBSERVE_ARGV)} in {wall:.1f}s (setup "
          f"and eval included), losses {result.step_losses}, launches "
          f"(flash, segment_norms, fused_apply, two_view) = {counts}; "
          f"run.jsonl kinds { {n: kinds.count(n) for n in sorted(set(kinds))} }"
          f" [{card}]", flush=True)
    if steps != ACCUM_STEPS or counts != (0, steps, steps, k * steps):
        raise AssertionError(f"observe: {steps} steps, launches {counts}")
    need = ("run_header", "epoch", "goodput", "span_stats", "run_end")
    if kinds.count("step") < steps or not all(n in kinds for n in need) or \
            (kinds[0], kinds[-1]) != ("run_header", "run_end"):
        raise AssertionError(f"observe: run.jsonl kinds {kinds}")

    # the health records: finite, ordered trust, equal to K1a's vector
    records = [e for e in evs if e["kind"] == "step"]
    for rec, trust in zip(records, returned):
        h = rec["health"]
        want = (float(trust.min()), float(health.median(trust)),
                float(trust.max()))
        got = (h["trust_min"], h["trust_median"], h["trust_max"])
        finite = all(isinstance(h[f], float) and math.isfinite(h[f])
                     for f in health.HEALTH_FIELDS)
        print(f"observe: step {rec['step']} health "
              f"{ {f: round(h[f], 6) for f in health.HEALTH_FIELDS} }; "
              f"K1a's returned vector ({trust.numel()} adapted segments): "
              f"min/median/max {want}", flush=True)
        if not (finite and got == want and h["nonfinite_count"] == 0.0
                and got[0] <= got[1] <= got[2]):
            raise AssertionError(f"observe: step {rec['step']} health {h}, "
                                 f"K1a's trust {want}")
    if len(returned) != steps or len(records) != steps:
        raise AssertionError(f"observe: {len(records)} step records for "
                             f"{len(returned)} updates")

    # the goodput partition: every window sums to its wall within 1 %
    goodputs = [e for e in evs if e["kind"] == "goodput"]
    for g in goodputs:
        total = g["productive_seconds"] + sum(g["badput"].values())
        if abs(total - g["wall_seconds"]) > 0.01 * g["wall_seconds"]:
            raise AssertionError(f"observe: goodput {g}")
    run = goodputs[-1]
    share = run["productive_seconds"] / run["wall_seconds"]
    print(f"observe: goodput over the run: wall {run['wall_seconds']:.3f} "
          f"s, productive {run['productive_seconds']:.3f} s ({share:.1%}); "
          f"badput { {b: round(v, 3) for b, v in run['badput'].items()} } "
          f"[{card}]", flush=True)
    stats = next(e for e in evs if e["kind"] == "span_stats")["spans"]
    print(f"observe: epoch 0 span_stats "
          f"{ {n: (v['count'], round(v['seconds'], 3)) for n, v in stats.items()} }",
          flush=True)
    fps = result.flops_per_sample
    print(f"observe: FLOPs per sample {fps:.4e} (FlopCounterMode over the "
          f"first optimizer step; the hand kernels count 0), MFU "
          f"{result.mfu} at {result.images_per_sec:.1f} img/s end to end "
          f"(epoch wall, eval excluded) [{card}]", flush=True)
    if not (fps and result.mfu and 0.0 < result.mfu < 1.0):
        raise AssertionError(f"observe: FLOPs {fps}, MFU {result.mfu}")
    row = {"microbatch": micro, "k": k, "steps": steps,
           "wall_s": wall, "goodput_fraction": share,
           "productive_s": run["productive_seconds"],
           "run_wall_s": run["wall_seconds"], "badput_s": run["badput"],
           "flops_per_sample": fps, "mfu": result.mfu,
           "images_per_sec": result.images_per_sec,
           "step_ms": result.step_ms}
    return counts, row, result.state, next(iter(loader.train_loader)), cfg


def _telemetry_cost_4096(card, state, host, cfg, accum_row, row):
    """(b) at 4096: wall ms of 1 optimizer step and device-busy
    ms of 1 profiled step with telemetry 'step' at interval 1 (the offer
    in the loop), beside the accum phase's numbers with it off; and the
    health vector alone."""
    import dataclasses

    import torch
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.observability import flops, health
    from byol_tpu_torch.observability.telemetry import TelemetrySink
    from byol_tpu_torch.training.build import build_tx, step_config
    from byol_tpu_torch.training.steps import make_train_step
    from byol_tpu_torch.training.trainer import _to_device

    rcfg = resolve(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)), num_train_samples=ACCUM_SAMPLES,
        num_test_samples=ACCUM_SAMPLES // 4, output_size=10,
        input_shape=(224, 224, 3))
    tx, schedule = build_tx(rcfg)
    scfg = step_config(rcfg)
    step = make_train_step(tx, scfg, schedule, get_policy(cfg.device.half))
    sink = TelemetrySink(1, verbose=False)
    big = _to_device(host, "cuda")

    def observed():
        sink.offer(state.step + 1, step(state, big)["health"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    observed()
    torch.cuda.synchronize()
    sink.drain()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = _device_profile(observed, 1, card,
                           f"resnet50 optimizer step of {ACCUM_BATCH} with "
                           "telemetry step, interval 1, per step", top=0,
                           host=False)
    sink.drain()
    # the health vector alone on this state's buffers (eager, CUDA events)
    trust = torch.ones(sum(state.seg.adapted), device="cuda")
    collapse = (torch.ones((), device="cuda"), torch.zeros((), device="cuda"))
    loss = torch.ones((), device="cuda")
    health_ms = _time_ms(lambda: health.health_stats(
        grads=state.grads, params=state.params, target_params=state.target,
        loss=loss, collapse=collapse, trust_ratios=trust,
        update_norm=0.1 * health.global_norm(state.momentum)))
    bound_ms = 5 * state.params.numel() * 4 / HBM_BYTES_PER_S * 1e3
    # MFU at the steady step rate (the fit's own counts its first step,
    # which runs under the FLOP counter)
    steady = flops.mfu(ACCUM_BATCH / accum_row["wall_ms"] * 1e3,
                       row["flops_per_sample"], flops.chip_peak_tflops())
    row.update(telemetry_wall_ms=wall_ms, telemetry_busy_ms=prof["busy_ms"],
               off_wall_ms=accum_row["wall_ms"],
               off_busy_ms=accum_row["busy_ms"], health_ms=health_ms,
               health_bound_ms=bound_ms, mfu_steady=steady)
    print(f"observe: MFU at the accum phase's steady "
          f"{ACCUM_BATCH / accum_row['wall_ms'] * 1e3:.1f} img/s: {steady} "
          f"({row['flops_per_sample'] / 1e9:.2f} GFLOP a sample against "
          f"{flops.chip_peak_tflops()} TFLOP/s dense BF16) [{card}]",
          flush=True)
    print(f"observe: telemetry cost at {ACCUM_BATCH}: wall {wall_ms:.1f} "
          f"ms/step (1 step) vs {accum_row['wall_ms']:.1f} off (the accum "
          f"phase), device busy {prof['busy_ms']:.1f} vs "
          f"{accum_row['busy_ms']:.1f} ms (1 profiled step each: "
          f"{prof['busy_ms'] - accum_row['busy_ms']:+.1f} ms); the health "
          f"vector alone {health_ms:.4f} ms eager over "
          f"{state.params.numel() * 4 / 1e6:.1f} MB buffers (5 buffer reads "
          f"at 3.35 TB/s: {bound_ms:.4f} ms) [{card}]", flush=True)


def _telemetry_cost_64(card):
    """(b) at batch 64 (the training phase's configuration): wall and
    device-busy ms per step with telemetry off, epoch, step at interval 1
    and step at interval 50, in turns, from one fresh state."""
    import dataclasses

    import torch
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.observability.telemetry import TelemetrySink
    from byol_tpu_torch.training.build import (build_tx, setup_training,
                                               step_config)
    from byol_tpu_torch.training.steps import make_train_step
    from byol_tpu_torch.training.trainer import _to_device

    cfg = config_from_args(build_parser().parse_args(TRAIN_ARGV))
    cfg = cfg.replace(device=dataclasses.replace(cfg.device, num_replicas=1))
    loader = get_loader(cfg, num_fake_samples=64)
    rcfg = resolve(cfg, num_train_samples=loader.num_train_samples,
                   num_test_samples=loader.num_test_samples,
                   output_size=loader.output_size,
                   input_shape=loader.input_shape)
    _, state, _, _, _ = setup_training(rcfg, "cuda")
    tx, schedule = build_tx(rcfg)
    policy = get_policy(cfg.device.half)
    batch = _to_device(next(iter(loader.train_loader)), "cuda")

    def arm(mode, interval):
        step = make_train_step(tx, dataclasses.replace(
            step_config(rcfg), telemetry=mode), schedule, policy)
        sink = TelemetrySink(interval, verbose=False)

        def one():
            m = step(state, batch)
            if mode == "step":
                sink.offer(state.step, m["health"])
            elif mode == "epoch":
                sink.hold(state.step, m["health"])
        return one, sink
    arms = {"off": arm("off", 1), "epoch": arm("epoch", 1),
            "step, interval 1": arm("step", 1),
            "step, interval 50": arm("step", 50)}
    walls = {name: [] for name in arms}
    for name in list(arms) + list(arms)[::-1]:
        one, sink = arms[name]
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBSERVE_64):
            one()
        torch.cuda.synchronize()
        sink.drain()                       # the epoch boundary's readback
        walls[name].append((time.perf_counter() - t0) * 1e3 / OBSERVE_64)
    rows = {}
    for name, (one, sink) in arms.items():
        prof = _device_profile(one, 3, card, f"resnet50 train step, batch "
                               f"64, telemetry {name}, per step", top=0)
        sink.drain()
        rows[name] = {"wall_ms": walls[name], "busy_ms": prof["busy_ms"],
                      "profiled_wall_ms": prof["wall_ms"],
                      "launch_api_ms": prof["launch_api_ms"]}
    # which calls of one step make the host wait for the card (CUDA's
    # sync debug mode names each synchronising operation's caller)
    import warnings
    from collections import Counter
    one, _ = arms["off"]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            one()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites = Counter(f"{os.path.relpath(w.filename)}:{w.lineno}"
                    for w in caught if "synchroniz" in str(w.message))
    print(f"observe: batch 64, one step's synchronising calls "
          f"{dict(sites)} [{card}]", flush=True)
    off = rows["off"]
    for name, r in rows.items():
        print(f"observe: batch 64, telemetry {name}: wall "
              f"{r['wall_ms'][0]:.3f} / {r['wall_ms'][1]:.3f} ms/step "
              f"({OBSERVE_64} steps each, in turns), device busy "
              f"{r['busy_ms']:.3f} ms ({r['busy_ms'] - off['busy_ms']:+.3f}"
              f" vs off) [{card}]", flush=True)
    return rows


def _nan_halt(card, root):
    """(c) --nan-policy halt on the card: batch 64, loader placement,
    fp32 views, a NaN in view1 row 0 of the batch of step HALT_AT."""
    import dataclasses

    import numpy as np
    import torch
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import run_name
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.observability.events import read_events
    from byol_tpu_torch.observability.telemetry import NanHaltError
    from byol_tpu_torch.training.trainer import fit

    cfg = config_from_args(build_parser().parse_args(HALT_ARGV + [
        "--model-dir", os.path.join(root, "halt_models"), "--log-dir",
        os.path.join(root, "halt_logs")]))
    loader = get_loader(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)), num_fake_samples=256, device="cuda")

    def poisoned(epoch, _base=loader.make_train_iter):
        for i, batch in enumerate(_base(epoch)):
            if i == HALT_AT - 1:
                v = batch["view1"]
                v = v.clone() if torch.is_tensor(v) else np.array(v)
                v[0, 0, 0, 0] = float("nan")   # passes the range check
                batch = dict(batch, view1=v)
            yield batch
    loader = dataclasses.replace(loader, make_train_iter=poisoned)
    _zero_counters()
    try:
        fit(cfg, device=torch.device("cuda"), loader=loader)
        halted = None
    except NanHaltError as e:
        halted = e
    counts = _read_counters()
    evs = list(read_events(os.path.join(cfg.task.log_dir, run_name(cfg),
                                        "run.jsonl")))
    kinds = [e["kind"] for e in evs]
    final = [e for e in evs if e["kind"] == "goodput"][-1:]
    dump = next((e for e in evs if e["kind"] == "state_dump"), {})
    print(f"observe: NaN in view1 row 0 at step {HALT_AT}: raised "
          f"{type(halted).__name__} at step "
          f"{getattr(halted, 'step', None)}; run.jsonl kinds {kinds}; "
          f"state_dump {dict((k, dump.get(k)) for k in ('step', 'state_step', 'lr', 'reason'))}; "
          f"launches {counts} [{card}]", flush=True)
    if halted is None or halted.step != HALT_AT:
        raise AssertionError("observe: the NaN batch did not halt the run")
    if not ("halt" in kinds and "state_dump" in kinds and final
            and final[0]["scope"] == "run" and final[0].get("halted")):
        raise AssertionError(f"observe: halt events {kinds}")


def run_observe(card, micro, accum_row):
    """The observe phase: (a) the main path with telemetry, spans, goodput
    and MFU; (b) the cost of telemetry at 4096 and at 64; (c) the NaN
    halt.  The serving trace (d) rides the serving phase.  Its run logs
    live under a temporary directory, removed after."""
    import gc
    import shutil
    import tempfile

    import torch
    root = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    try:
        counts, row, state, host, cfg = _observe_main(card, micro, root)
        _telemetry_cost_4096(card, state, host, cfg, accum_row, row)
        del state, host
        gc.collect()
        torch.cuda.empty_cache()
        row["batch_64"] = _telemetry_cost_64(card)
        torch.cuda.empty_cache()
        _nan_halt(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts, row


def run_slice(card):
    """The main path: serve ViT-B/16 through build_service on the card,
    with the serving CLI's run log (--serve-events) and flight recorder
    (--serve-trace) under a temporary directory, removed after."""
    import shutil
    import tempfile
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        return _run_slice(card, log_dir)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def _run_slice(card, log_dir):
    import numpy as np
    import torch
    from byol_tpu_torch.core.config import (Config, DeviceConfig,
                                            ModelConfig, TaskConfig)
    from byol_tpu_torch.models.layers import store_in_compute_dtype
    from byol_tpu_torch.observability.events import (read_events,
                                                     run_header_env)
    from byol_tpu_torch.serving.cli import serve_observers
    from byol_tpu_torch.serving.net.loadgen import run_closed_loop
    from byol_tpu_torch.serving.service import (ServeConfig, _serving_rcfg,
                                                build_service)
    from byol_tpu_torch.training.build import build_net
    from byol_tpu_torch.training.linear_eval import frozen_representation_fn

    cfg = Config(task=TaskConfig(image_size_override=224),
                 model=ModelConfig(arch="vit_b16", attn_impl="flash"),
                 device=DeviceConfig(half=True, seed=0))
    events_path = os.path.join(log_dir, "serve.jsonl")
    trace_path = os.path.join(log_dir, "serve_trace.json")
    events, recorder, export_trace = serve_observers(events_path, trace_path)
    events.emit("run_header", config=cfg.to_dict(), **run_header_env("cuda"))
    t0 = time.perf_counter()
    service = build_service(cfg, ServeConfig(min_bucket=8, max_bucket=64),
                            device="cuda", events=events, recorder=recorder)
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

    _check_captures(service.engine, "slice")
    replays0 = dict(service.engine.describe()["replays"])
    batches0 = service.meter.total_batches
    _zero_counters()
    res = run_closed_loop(embed, service.engine.input_shape, 48, 3, seed=0)
    if _read_counters() != (0, 0, 0, 0):
        raise AssertionError(f"slice: serving launched a kernel outside its "
                             f"graphs: {_read_counters()}")
    launches = _k3_replayed(service.engine, replays0)
    batches = service.meter.total_batches - batches0
    snap = service.meter.snapshot(time.perf_counter(), reset=False)
    # the served window's trace, as the CLI writes it at exit
    n_spans = export_trace()
    with open(trace_path) as f:
        dispatch_spans = sum(e.get("name") == "serve/dispatch"
                             for e in json.load(f)["traceEvents"])
    _serving_split(recorder.records(), card)
    print(f"slice: {res.summary()} [{card}]", flush=True)
    print(f"slice: served p50 {snap['p50_ms']:.3f} ms, p99 "
          f"{snap['p99_ms']:.3f} ms, {snap['rows_per_sec']:.1f} img/s over "
          f"{batches} batches (fill {snap['fill_ratio']:.3f}) [{card}]",
          flush=True)
    print(f"slice: --serve-trace: {n_spans} spans, serve/dispatch "
          f"{dispatch_spans} for {batches} batches served", flush=True)
    if not res.ok:
        raise AssertionError(f"slice: {res.summary()}")
    if service.engine.compile_count != warm:
        raise AssertionError(f"slice: a bucket warmed again after warmup "
                             f"({warm} -> {service.engine.compile_count})")
    if batches < 1 or launches != 12 * batches:
        raise AssertionError(f"slice: flash_attention launched {launches} "
                             f"times for {batches} batches (want 12 each)")
    if dispatch_spans != batches:
        raise AssertionError(f"slice: {dispatch_spans} serve/dispatch spans "
                             f"for {batches} batches")
    print(f"slice: flash_attention launches {launches} = 12 x {batches} "
          "batches, from graph replays (captures x replays)", flush=True)

    # graph against eager on the same weights (outside the counted run)
    versus = graph_vs_eager(service.engine, card)
    if service.engine.compile_count != warm:
        raise AssertionError("slice: a bucket was captured again")

    # one bucket-8 batch against the same weights under dense attention
    rows8 = np.random.RandomState(2).rand(8, 224, 224, 3).astype(np.float32)
    got = service.engine.embed(rows8)
    service.stop()
    events.emit("run_end", smoke_requests=res.completed,
                smoke_failed=res.failed,
                compile_count=service.engine.compile_count)
    events.close()
    kinds = [e["kind"] for e in read_events(events_path)]
    print(f"slice: --serve-events: {kinds}", flush=True)
    if (kinds[0], kinds[-1]) != ("run_header", "run_end") or \
            "serve_stats" not in kinds:
        raise AssertionError(f"slice: serve events {kinds}")
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
    return launches, versus


WIRE_REQUESTS, WIRE_STREAMS = 48, 3
WIRE_ARCH, WIRE_SIZE, WIRE_DIM = "vit_b16", 224, 768
WIRE_GRACE_S = 2.0                 # --drain-grace-s of the SIGTERM run


def _wire_images(kind):
    """make_images for the loadgen: one (1, S, S, 3) image per stream,
    float32 in [0, 1] or uint8, from the stream's seed."""
    import numpy as np

    def make(idx):
        rng = np.random.RandomState(100 + idx)
        if kind == "uint8":
            return rng.randint(0, 256, (1, WIRE_SIZE, WIRE_SIZE, 3),
                               dtype=np.uint8)
        return rng.rand(1, WIRE_SIZE, WIRE_SIZE, 3).astype(np.float32)
    return make


def _malformed_table(max_body_bytes):
    """(what, method args, status, code) over the real socket: JAX's
    malformed bodies at the served shape, and the admission answers made
    before a body byte is read."""
    import struct
    row, half = WIRE_SIZE * WIRE_SIZE * 3, WIRE_SIZE // 2

    def frame(header, payload):
        head = json.dumps(header).encode()
        return struct.pack(">I", len(head)) + head + payload

    shape = [1, WIRE_SIZE, WIRE_SIZE, 3]
    return [
        ("garbage", dict(body=b"garbage"), 400, "bad_frame"),
        ("bad version", dict(body=frame({"v": 9, "dtype": "uint8",
                                         "shape": shape}, bytes(row))),
         400, "bad_version"),
        ("float64", dict(body=frame({"v": 1, "dtype": "float64",
                                     "shape": shape}, bytes(8 * row))),
         415, "unsupported_dtype"),
        ("row shape", dict(body=frame({"v": 1, "dtype": "uint8",
                                       "shape": [1, half, half, 3]},
                                      bytes(half * half * 3))),
         400, "bad_shape"),
        ("truncated", dict(body=frame({"v": 1, "dtype": "uint8",
                                       "shape": shape}, bytes(row - 1))),
         400, "payload_size_mismatch"),
        ("65 rows", dict(body=frame({"v": 1, "dtype": "uint8",
                                     "shape": [65, WIRE_SIZE, WIRE_SIZE, 3]},
                                    bytes(65 * row))), 413, "too_many_rows"),
        ("oversized Content-Length",
         dict(body=b"", headers={"Content-Length": str(max_body_bytes + 1)}),
         413, "too_large"),
        ("no Content-Length", dict(chunked=True), 411, "length_required"),
        ("NaN deadline", dict(headers={"X-Deadline-Ms": "NaN"}), 400,
         "bad_deadline"),
        ("spent deadline", dict(headers={"X-Deadline-Ms": "0"}), 408,
         "deadline_expired"),
    ]


def _raw_post(host, port, good, body=None, headers=None, chunked=False):
    """One POST /v1/embed on a fresh connection -> (status, error code)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        if chunked:
            conn.putrequest("POST", "/v1/embed")
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            conn.send(b"0\r\n\r\n")
        else:
            conn.request("POST", "/v1/embed",
                         body=good if body is None else body,
                         headers=headers or {})
        resp = conn.getresponse()
        payload = resp.read()
        code = (json.loads(payload).get("error")
                if resp.status != 200 else "")
        return resp.status, code
    finally:
        conn.close()


def run_wire(card):
    """The wire front end: (1) the counted run, a WireServer over
    build_service in this process; (2) the serve CLI in subprocesses, a
    wire smoke and a SIGTERM drain under load.  -> (K3 launches of the
    counted run, row)."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_wire_")
    try:
        launches, row = _wire_inproc(card)
        row["cli"] = _wire_cli(card, root)
        return launches, row
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _wire_inproc(card):
    import numpy as np
    from byol_tpu_torch.core.config import (Config, DeviceConfig,
                                            ModelConfig, TaskConfig)
    from byol_tpu_torch.serving.net import protocol
    from byol_tpu_torch.serving.net.client import EmbedClient
    from byol_tpu_torch.serving.net.loadgen import run_closed_loop
    from byol_tpu_torch.serving.net.server import WireServer
    from byol_tpu_torch.serving.service import ServeConfig, build_service

    cfg = Config(task=TaskConfig(image_size_override=WIRE_SIZE),
                 model=ModelConfig(arch=WIRE_ARCH, attn_impl="flash"),
                 device=DeviceConfig(half=True, seed=0))
    service = build_service(cfg, ServeConfig(min_bucket=8, max_bucket=64),
                            device="cuda")
    service.start()
    _check_captures(service.engine, "wire")
    warm = service.engine.compile_count
    server = WireServer(service, "127.0.0.1", 0).start()
    host, port = server.address
    clients = {}
    row = {}
    try:
        def check(idx, out):
            if out.shape != (1, WIRE_DIM) or not np.isfinite(out).all():
                raise AssertionError(f"stream {idx}: embedding of shape "
                                     f"{out.shape}, finite="
                                     f"{bool(np.isfinite(out).all())}")

        def inproc(idx, img):
            check(idx, service.embed(img, timeout=300))

        def setup(idx):
            clients[idx] = EmbedClient(host, port, timeout_s=300, seed=idx)

        def wire(idx, img):
            check(idx, clients[idx].embed(img, deadline_ms=300_000))

        # in-process first, outside the counted window (the yardstick)
        base = run_closed_loop(inproc, service.engine.input_shape,
                               WIRE_REQUESTS, WIRE_STREAMS, seed=0,
                               make_images=_wire_images("float32"))
        replays0 = dict(service.engine.describe()["replays"])
        batches0 = service.meter.total_batches
        _zero_counters()
        runs = {kind: run_closed_loop(
                    wire, service.engine.input_shape, WIRE_REQUESTS,
                    WIRE_STREAMS, seed=0, make_images=_wire_images(kind),
                    stream_setup=setup)
                for kind in ("float32", "uint8")}
        if _read_counters() != (0, 0, 0, 0):
            raise AssertionError(f"wire: a kernel launched outside the "
                                 f"graphs: {_read_counters()}")
        launches = _k3_replayed(service.engine, replays0)
        batches = service.meter.total_batches - batches0
        snap = service.meter.snapshot(time.perf_counter(), reset=False)
        for name, res in (("in-process", base), ("wire float32",
                                                 runs["float32"]),
                          ("wire uint8", runs["uint8"])):
            print(f"wire: {name}: {res.summary()} = "
                  f"{res.throughput():.1f} img/s [{card}]", flush=True)
            if not res.ok:
                raise AssertionError(f"wire: {name}: {res.summary()}")
            row[name] = {"p50_ms": res.percentile_ms(50),
                         "p99_ms": res.percentile_ms(99),
                         "img_per_s": res.throughput()}
        row["wire"] = snap["wire"]
        print(f"wire: serve_stats wire block {snap['wire']} [{card}]",
              flush=True)
        print(f"wire: flash_attention launches {launches} for {batches} "
              f"batches, from graph replays", flush=True)
        if batches < 1 or launches != 12 * batches:
            raise AssertionError(f"wire: flash_attention launched "
                                 f"{launches} times for {batches} batches "
                                 "(want 12 each)")
        if service.engine.compile_count != warm:
            raise AssertionError("wire: a bucket was captured again")
        row["launches"], row["batches"] = launches, batches

        # uint8 against float32 u8/255, one image alone in bucket 8
        u8 = _wire_images("uint8")(7)
        with EmbedClient(host, port, timeout_s=300) as c:
            got_u8 = c.embed(u8)
            got_f32 = c.embed(u8.astype(np.float32) / np.float32(255.0))
        same = bool(np.array_equal(got_u8, got_f32))
        print(f"wire: uint8 == float32 u8/255 bitwise: {same}", flush=True)
        if not same:
            raise AssertionError("wire: the uint8 answer differs from the "
                                 "float32 u8/255 one")
        row["uint8_bitwise"] = same

        good = protocol.encode_request(_wire_images("float32")(0))
        bad = []
        for what, kw, status, code in _malformed_table(
                server.max_body_bytes):
            got = _raw_post(host, port, good, **kw)
            if got != (status, code):
                bad.append(f"{what}: {got} != {(status, code)}")
        if _raw_post(host, port, good)[0] != 200:
            bad.append("a good request after the table was not answered "
                       "200")
        print(f"wire: malformed table over the socket: "
              f"{len(_malformed_table(0)) - len(bad)}/"
              f"{len(_malformed_table(0))} mapped, server still serving "
              f"{not bad}", flush=True)
        if bad:
            raise AssertionError(f"wire: {bad}")
    finally:
        for c in clients.values():
            c.close()
        server.drain(grace_s=0.0, timeout_s=120)
    return launches, row


def _serve_cmd(log_dir, *extra):
    return [sys.executable, "-m", "byol_tpu_torch", "serve", "--arch",
            WIRE_ARCH, "--image-size-override", str(WIRE_SIZE),
            "--attn-impl", "flash", "--http", "127.0.0.1:0",
            "--log-dir", log_dir, *extra]


def _wire_cli(card, root):
    """The serve CLI in subprocesses: a wire smoke of 48 requests from 3
    streams (exit 0), then a long-running server that takes SIGTERM while
    3 streams have requests in flight: readyz 503 in the grace window,
    every accepted request answered 200, exit 0, serve.jsonl with the
    wire block."""
    import http.client
    import signal
    import threading

    import numpy as np
    from byol_tpu_torch.observability.events import read_events
    from byol_tpu_torch.serving.net.client import (EmbedClient,
                                                   WireClientError,
                                                   wait_until_ready)
    here = os.path.dirname(os.path.abspath(__file__))
    row = {}
    smoke_dir = os.path.join(root, "smoke")
    t0 = time.perf_counter()
    proc = subprocess.run(
        _serve_cmd(smoke_dir, "--smoke", str(WIRE_REQUESTS),
                   "--smoke-streams", str(WIRE_STREAMS)),
        cwd=here, capture_output=True, text=True, timeout=600)
    row["smoke_rc"] = proc.returncode
    row["smoke_s"] = time.perf_counter() - t0
    tail = [ln for ln in (proc.stdout + proc.stderr).splitlines()
            if ln.startswith(("serve[", "loadgen:", "serve: smoke"))]
    print(f"wire: serve --http --smoke {WIRE_REQUESTS}: rc "
          f"{proc.returncode} in {row['smoke_s']:.1f} s; {tail} [{card}]",
          flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"wire: the CLI smoke exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")

    log_dir = os.path.join(root, "long")
    os.makedirs(log_dir)
    out_path = os.path.join(log_dir, "stdout.txt")
    with open(out_path, "w") as out, \
            open(os.path.join(log_dir, "stderr.txt"), "w") as err:
        proc = subprocess.Popen(
            _serve_cmd(log_dir, "--drain-grace-s", str(WIRE_GRACE_S)),
            cwd=here, stdout=out, stderr=err)
    try:
        address = None
        deadline = time.monotonic() + 600
        while address is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            with open(out_path) as f:
                for line in f:
                    if "wire front end at http://" in line:
                        address = line.split("http://")[1].split()[0]
            time.sleep(0.2)
        if address is None:
            raise AssertionError(f"wire: the server printed no address "
                                 f"(rc {proc.poll()})")
        host, port = address.rsplit(":", 1)
        port = int(port)
        if not wait_until_ready(host, port, timeout_s=120):
            raise AssertionError("wire: /readyz never answered 200")
        lock = threading.Lock()
        outcome = {"ok": 0, "ok_after_sigterm": 0, "refused": 0,
                   "other": []}
        sigterm_at = []

        def stream(idx):
            img = _wire_images("float32")(idx)
            with EmbedClient(host, port, timeout_s=120, max_attempts=1,
                             seed=idx) as c:
                while True:
                    try:
                        out = c.embed(img)
                    except WireClientError as e:
                        with lock:
                            if e.status in (0, 503):
                                outcome["refused"] += 1
                            else:
                                outcome["other"].append(str(e)[:200])
                        return
                    with lock:
                        if out.shape != (1, WIRE_DIM) or \
                                not np.isfinite(out).all():
                            outcome["other"].append(f"bad {out.shape}")
                            return
                        outcome["ok"] += 1
                        if sigterm_at:
                            outcome["ok_after_sigterm"] += 1

        threads = [threading.Thread(target=stream, args=(i,), daemon=True)
                   for i in range(WIRE_STREAMS)]
        for t in threads:
            t.start()
        while outcome["ok"] < 6 and proc.poll() is None:
            time.sleep(0.01)
        with lock:
            sigterm_at.append(time.perf_counter())
        proc.send_signal(signal.SIGTERM)
        readyz, healthz = [], []
        while time.perf_counter() - sigterm_at[0] < WIRE_GRACE_S:
            with EmbedClient(host, port, timeout_s=5, max_attempts=1) as p:
                try:
                    readyz.append(p.get("/readyz")[0])
                    healthz.append(p.get("/healthz")[0])
                except (OSError, http.client.HTTPException):
                    break
            time.sleep(0.05)
        for t in threads:
            t.join(timeout=300)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stats = [e for e in read_events(os.path.join(log_dir, "serve.jsonl"))
             if e["kind"] == "serve_stats" and "wire" in e]
    statuses = {}
    for e in stats:
        for k, v in e["wire"]["status"].items():
            statuses[k] = statuses.get(k, 0) + int(v)
    row.update(sigterm_rc=rc, readyz=sorted(set(readyz)),
               healthz=sorted(set(healthz)), client=outcome,
               server_statuses=statuses)
    print(f"wire: SIGTERM under load: rc {rc}; readyz in the grace window "
          f"{sorted(set(readyz))} ({len(readyz)} probes), healthz "
          f"{sorted(set(healthz))}; clients {outcome}; serve.jsonl wire "
          f"statuses {statuses} [{card}]", flush=True)
    problems = []
    if rc != 0:
        problems.append(f"exit {rc}")
    if 503 not in readyz or set(healthz) != {200}:
        problems.append("readyz never 503 in the grace window, or healthz "
                        "not 200")
    if any(t.is_alive() for t in threads) or outcome["other"]:
        problems.append(f"a stream hung or failed: {outcome['other']}")
    if not stats:
        problems.append("serve.jsonl has no serve_stats with a wire block")
    if set(statuses) - {"200", "503"} or \
            statuses.get("200", 0) != outcome["ok"]:
        problems.append(f"accepted requests not all answered 200: server "
                        f"{statuses}, clients {outcome['ok']} ok")
    if problems:
        raise AssertionError(f"wire: SIGTERM drain: {problems}")
    return row


LINEAR_EVAL_ARGV = ["--task", "synth", "--num-synth-samples", "1024",
                    "--arch", "resnet50", "--image-size-override", "224",
                    "--batch-size", "64", "--epochs", "1",
                    "--augment-placement", "step", "--fused-augment", "on",
                    "--fused-update", "on", "--linear-eval"]
LINEAR_EVAL_STEPS = 16             # 1024 synth images at batch 64
LINEAR_EVAL_MIN_TOP1 = 30.0        # percent; chance on synth's 10 classes


def run_linear_eval(card):
    """``--linear-eval`` through the CLI's main, counters set to 0 before
    and read after; the trainer and linear eval watched through wrappers
    of their module functions (restored after).  -> (counts, row)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from byol_tpu_torch import cli
    from byol_tpu_torch.training import linear_eval as le
    from byol_tpu_torch.training import trainer

    seen = {"extract_s": 0.0, "extract_rows": 0}
    originals = {(trainer, "fit"): trainer.fit,
                 (le, "encoder_apply_fn"): le.encoder_apply_fn,
                 (le, "extract_features"): le.extract_features,
                 (le, "fit_and_score"): le.fit_and_score,
                 (le, "run_linear_eval_from_cfg"):
                     le.run_linear_eval_from_cfg}

    def fit(*a, **kw):
        seen["fit"] = originals[(trainer, "fit")](*a, **kw)
        return seen["fit"]

    def encoder_apply_fn(*a, **kw):
        seen["apply"] = originals[(le, "encoder_apply_fn")](*a, **kw)
        return seen["apply"]

    def extract_features(*a, **kw):
        t = time.perf_counter()
        feats, labels = originals[(le, "extract_features")](*a, **kw)
        seen["extract_s"] += time.perf_counter() - t
        seen["extract_rows"] += len(labels)
        return feats, labels

    def fit_and_score(*a, **kw):
        t = time.perf_counter()
        out = originals[(le, "fit_and_score")](*a, **kw)
        seen["probe_s"] = time.perf_counter() - t
        return out

    def run_linear_eval_from_cfg(*a, **kw):
        seen["result"] = originals[(le, "run_linear_eval_from_cfg")](*a,
                                                                      **kw)
        return seen["result"]

    spies = {"fit": fit, "encoder_apply_fn": encoder_apply_fn,
             "extract_features": extract_features,
             "fit_and_score": fit_and_score,
             "run_linear_eval_from_cfg": run_linear_eval_from_cfg}
    root = tempfile.mkdtemp(prefix="chip_smoke_linear_eval_")
    for mod, name in originals:
        setattr(mod, name, spies[name])
    try:
        t0 = time.perf_counter()
        _zero_counters()
        rc = cli.main(LINEAR_EVAL_ARGV + [
            "--model-dir", os.path.join(root, "m"),
            "--log-dir", os.path.join(root, "l")])
        counts = _read_counters()
        wall = time.perf_counter() - t0
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
        shutil.rmtree(root, ignore_errors=True)
    result, res = seen.get("fit"), seen.get("result")
    if rc != 0 or result is None or res is None:
        raise AssertionError(f"linear_eval: the CLI exited {rc}")
    losses = result.step_losses
    ips = seen["extract_rows"] / seen["extract_s"]
    print(f"linear_eval: {len(losses)} steps, losses finite "
          f"{bool(np.isfinite(losses).all())}, launches (flash, "
          f"segment_norms, fused_apply, two_view) = {counts}; top1 "
          f"{res.top1:.2f} top5 {res.top5:.2f} train acc "
          f"{res.train_acc:.2f} ({res.num_train} train / {res.num_test} "
          f"test); extraction {seen['extract_rows']} images in "
          f"{seen['extract_s']:.3f} s = {ips:.1f} img/s, probe fit "
          f"{seen['probe_s']:.3f} s, run {wall:.1f} s [{card}]", flush=True)
    n = LINEAR_EVAL_STEPS
    if (len(losses) != n or not np.isfinite(losses).all()
            or counts != (0, n, n, n)):
        raise AssertionError(f"linear_eval: {len(losses)} steps, counts "
                             f"{counts}; want {n} finite, (0, {n}, {n}, {n})")
    if res.top1 < LINEAR_EVAL_MIN_TOP1:
        raise AssertionError(f"linear_eval: top1 {res.top1:.2f} < "
                             f"{LINEAR_EVAL_MIN_TOP1}")
    # one extracted batch against the trained state's own encoder
    size = int(LINEAR_EVAL_ARGV[LINEAR_EVAL_ARGV.index(
        "--image-size-override") + 1])
    rows = np.random.RandomState(5).rand(64, size, size, 3).astype(
        np.float32)
    got = seen["apply"](rows)
    want = le.frozen_representation_fn(result.state.net, half=True)(
        torch.from_numpy(rows).cuda()).cpu().numpy()
    same = bool(np.array_equal(got, want))
    print(f"linear_eval: extracted batch == frozen_representation_fn of the "
          f"trained state, bitwise: {same} (max abs err "
          f"{float(np.abs(got - want).max()):.3g})", flush=True)
    if not same:
        raise AssertionError("linear_eval: the extractor's features differ "
                             "from the trained state's encoder")
    row = {"top1": res.top1, "top5": res.top5, "train_acc": res.train_acc,
           "num_train": res.num_train, "num_test": res.num_test,
           "extract_img_per_s": ips, "extract_s": seen["extract_s"],
           "probe_s": seen["probe_s"], "run_s": wall,
           "losses": [float(x) for x in losses]}
    return counts, row


# ---- ddp: data parallel at world 1 over NCCL, and the range kernels -------

DDP_ARGV = ["--task", "fake", "--arch", "resnet50",
            "--image-size-override", "224", "--batch-size", "64",
            "--epochs", "1", "--augment-placement", "step",
            "--fused-augment", "on", "--fused-update", "on"]
ZERO1_FLAGS = ["--zero1", "on", "--flat-resident", "on"]
DDP_STEPS = 3


def _ddp_counters():
    """(segment_norms, fused_apply, two_view, segment_sums,
    segment_epilogue) launches."""
    from byol_tpu_torch.ops import fused_augment as fg
    from byol_tpu_torch.ops import fused_update as fu
    return (fu.SEGMENT_NORMS_LAUNCHES, fu.FUSED_APPLY_LAUNCHES, fg.LAUNCHES,
            fu.SEGMENT_SUMS_LAUNCHES, fu.SEGMENT_EPILOGUE_LAUNCHES)


def _zero_ddp_counters():
    from byol_tpu_torch.ops import fused_update as fu
    _zero_counters()
    fu.SEGMENT_SUMS_LAUNCHES = fu.SEGMENT_EPILOGUE_LAUNCHES = 0


def check_range_kernels(card):
    """The split K1a and K1b on each rank's range of the ResNet-50 BYOL
    layout for worlds 2 and 4, on this one card, against their plain
    versions; the ranks' sums added by hand against the whole buffer's
    trust vector; world 1's split path against the fused K1a, bit for
    bit.  -> kernel-line entries for the split entries."""
    import torch
    from byol_tpu_torch.ops import fused_update as fu
    from byol_tpu_torch.parallel import zero1 as z
    seg, _ = _rn50_segment_map()
    full = fu.FusedLayout.build(seg, 1e-6, "cuda")
    real = torch.zeros(seg.total, dtype=torch.bool, device="cuda")
    for start, size in zip(seg.starts, seg.sizes):
        real[start:start + size] = True
    gen = torch.Generator(device="cuda").manual_seed(1)
    p, g, m, t = (torch.randn(seg.total, device="cuda", generator=gen)
                  * k * real for k in (0.05, 1e-3, 1e-3, 0.05))
    want_scale, want_norms = fu.segment_norms(p, g, full)
    sums1 = fu.segment_sums(p, g, full)
    scale1, norms1 = fu.segment_epilogue(sums1, full)
    bitwise1 = (torch.equal(scale1, want_scale)
                and torch.equal(norms1, want_norms))
    want_trust = full.trust_vector(want_scale)
    kw = dict(lr=0.3, tau=0.99, momentum_decay=0.9, ema_pre=False)
    err = {"sums": 0.0, "sums_rel": 0.0, "epilogue": 0.0, "apply": 0.0,
           "trust_rel": 0.0}
    ok = bitwise1
    timed = {}
    for world in (2, 4):
        parts = []
        for r in range(world):
            lo, hi = z.rank_rows(seg.num_rows, world, r)
            lay = fu.FusedLayout.build(seg, 1e-6, "cuda", lo, hi)
            sl = slice(lo * fu.LANES, hi * fu.LANES)
            sums = fu.segment_sums(p[sl], g[sl], lay)
            ref = fu.segment_sums_reference(p[sl], g[sl], lay)
            rel = ((sums - ref).abs() / ref.abs().clamp_min(1e-300)).max()
            err["sums_rel"] = max(err["sums_rel"], rel.item())
            err["sums"] = max(err["sums"], (sums - ref).abs().max().item())
            ok = ok and torch.allclose(sums, ref, rtol=1e-5, atol=0.0)
            parts.append((lay, sl, sums))
        total = torch.stack([s for _, _, s in parts]).sum(0)
        scale, norms = fu.segment_epilogue(total, full)
        ref_scale, ref_norms = fu.segment_epilogue_reference(total, full)
        err["epilogue"] = max(err["epilogue"],
                              (scale - ref_scale).abs().max().item(),
                              (norms - ref_norms).abs().max().item())
        ok = ok and torch.allclose(scale, ref_scale, **K1_TOL) \
            and torch.allclose(norms, ref_norms, **K1_TOL)
        trust = full.trust_vector(scale)
        rel = ((trust - want_trust).abs() / want_trust.abs()).max().item()
        err["trust_rel"] = max(err["trust_rel"], rel)
        ok = ok and rel <= 1e-6
        for lay, sl, _ in parts:
            got = [x[sl].clone() for x in (p, m, t)]
            want = [x[sl].clone() for x in (p, m, t)]
            fu.fused_apply(got[0], g[sl], got[1], got[2], scale, lay, **kw)
            fu.fused_apply_reference(want[0], g[sl], want[1], want[2],
                                     scale, lay, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                err["apply"] = max(err["apply"], (a - b).abs().max().item())
                ok = ok and torch.allclose(a, b, **K1_TOL)
        lay, sl, _ = parts[0]
        pr, gr = p[sl], g[sl]
        bufs = [x[sl].clone() for x in (p, m, t)]
        # the nearest library call: torch's multi-tensor norm over the
        # range's piece of each segment, of p and of g
        bounds = lay.seg_row_start.tolist()
        pieces = [x.view(-1, fu.LANES)[a:b].reshape(-1) for x in (pr, gr)
                  for a, b in zip(bounds[:-1], bounds[1:])]
        timed[world] = {
            "segment_sums": (
                _device_ms(lambda: fu.segment_sums(pr, gr, lay)),
                _device_ms(lambda: fu.segment_sums_reference(pr, gr, lay)),
                (2 * 4 * lay.total + 16 * seg.num_segments),
                _device_ms(lambda: torch._foreach_norm(pieces))),
            "fused_apply": (
                _device_ms(lambda: fu.fused_apply(
                    bufs[0], gr, bufs[1], bufs[2], scale, lay, **kw)),
                _device_ms(lambda: fu.fused_apply_reference(
                    bufs[0], gr, bufs[1], bufs[2], scale, lay, **kw)),
                7 * 4 * lay.total),
            "rows": lay.rows}
    epi = (_device_ms(lambda: fu.segment_epilogue(total, full)),
           _device_ms(lambda: fu.segment_epilogue_reference(total, full)),
           seg.num_segments * (16 + 4 + 8 + 4))
    print(f"ddp: range kernels at the ResNet-50 layout, worlds 2 and 4: "
          f"ok={ok}, world 1 split == fused K1a bitwise {bitwise1}, errors "
          f"{err} [{card}]", flush=True)
    for world, rows in timed.items():
        for name in ("segment_sums", "fused_apply"):
            ms, plain, nbytes = rows[name][:3]
            print(f"ddp: {name} on rank 0's range of world {world} "
                  f"({rows['rows']} rows): {ms:.4f} ms graph, plain "
                  f"{plain:.4f}, bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f}"
                  f" (bytes) [{card}]", flush=True)
    print(f"ddp: segment_epilogue ({seg.num_segments} segments): "
          f"{epi[0]:.4f} ms graph, plain {epi[1]:.4f}, bound "
          f"{epi[2] / HBM_BYTES_PER_S * 1e3:.6f} (bytes) [{card}]",
          flush=True)
    if not ok:
        raise AssertionError(f"ddp: the range kernels disagree with their "
                             f"plain versions or the whole buffer: {err}, "
                             f"world 1 bitwise {bitwise1}")

    def entry(ms, plain, nbytes, max_err, library_ms=None, **more):
        return dict(ms=ms, plain_ms=plain,
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", library_ms=library_ms,
                    max_abs_err=max_err, ok=ok, **more)
    ms, plain, nbytes, library_ms = timed[2]["segment_sums"]
    return {
        "segment_sums": entry(
            ms, plain, nbytes, err["sums"], library_ms=library_ms,
            max_rel_err=err["sums_rel"], shape=f"rank 0 of 2, "
            f"{timed[2]['rows']} rows",
            world4_ms=timed[4]["segment_sums"][0],
            world4_bound_ms=timed[4]["segment_sums"][2]
            / HBM_BYTES_PER_S * 1e3),
        "segment_epilogue": entry(*epi, err["epilogue"],
                                  shape=f"{seg.num_segments} segments"),
        "fused_apply_range": {
            "ms": timed[2]["fused_apply"][0],
            "plain_ms": timed[2]["fused_apply"][1],
            "bound_ms": timed[2]["fused_apply"][2] / HBM_BYTES_PER_S * 1e3,
            "world4_ms": timed[4]["fused_apply"][0],
            "max_abs_err": err["apply"]},
        "trust_rel_err": err["trust_rel"], "world1_bitwise": bitwise1}


def _ddp_batches(n):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(11)
    return [{"images": torch.randint(0, 256, (64, 224, 224, 3),
                                     generator=gen, device="cuda",
                                     dtype=torch.uint8),
             "label": torch.randint(0, 10, (64,), generator=gen,
                                    device="cuda", dtype=torch.int32)}
            for _ in range(n)]


def _ddp_run(zero1, batches):
    """``DDP_STEPS`` steps of the slice's config (``--zero1 on
    --flat-resident on`` with ``zero1``) in this process at the current
    world, counters set to 0 before and read after.  -> (state, step,
    counts, losses)."""
    import dataclasses
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.parallel.compile_plan import plan_from_cfg
    from byol_tpu_torch.training.build import setup_training
    cfg = config_from_args(build_parser().parse_args(
        DDP_ARGV + (ZERO1_FLAGS if zero1 else [])))
    world = mesh.world_size()
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 num_replicas=world))
    rcfg = resolve(cfg, num_train_samples=512, num_test_samples=128,
                   output_size=10, input_shape=(224, 224, 3))
    _, state, step, _, _ = setup_training(rcfg, "cuda",
                                          plan=plan_from_cfg(cfg, world))
    _zero_ddp_counters()
    losses = [float(step(state, b)["loss_mean"]) for b in batches]
    return state, step, _ddp_counters(), losses


def _differing(a, b, prefix=""):
    """The leaves where two canonical trees differ."""
    import torch
    if isinstance(a, dict):
        return [n for k in a for n in _differing(a[k], b[k],
                                                 f"{prefix}{k}.")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [prefix[:-1]]
    return [] if a == b else [prefix[:-1]]


def _synced_bn_check(card):
    """The synced BatchNorm forced on against the one-device class on
    ResNet-50's stem shape, forward and backward, fp32."""
    import copy

    import torch
    from byol_tpu_torch.models.layers import BatchNorm
    gen = torch.Generator(device="cuda").manual_seed(5)
    one = BatchNorm(64).to("cuda")
    with torch.no_grad():
        one.weight.copy_(torch.rand(64, generator=gen, device="cuda") + 0.5)
        one.bias.copy_(torch.randn(64, generator=gen, device="cuda"))
    synced = copy.deepcopy(one)
    synced.sync = True
    x = torch.randn(64, 64, 112, 112, generator=gen, device="cuda") * 2 + 1
    dy = torch.randn(x.shape, generator=gen, device="cuda")
    errs = {}
    outs = []
    for bn in (one, synced):
        xi = x.clone().requires_grad_(True)
        y = bn.train()(xi)
        y.backward(dy)
        outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean.clone(), bn.running_var.clone()))
    # each error relative to its tensor's largest magnitude: the
    # parameter gradients are sums over 802,816 positions each, ~1e3, so
    # another summation order moves them by ~1e-3
    ok = True
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean",
                           "running_var"), *outs):
        errs[name] = ((a - b).abs().max() / b.abs().max()).item()
        ok = ok and errs[name] <= 1e-5
    print(f"ddp: synced BatchNorm forced on at world 1 vs the one-device "
          f"class, {tuple(x.shape)} fp32: max abs err over max abs value "
          f"{errs} ok={ok} [{card}]", flush=True)
    if not ok:
        raise AssertionError(f"ddp: synced BatchNorm disagrees: {errs}")
    return errs


def _torchrun(card, root, state_like, argv=None, what="ddp"):
    """The launcher: ``torch.distributed.run --standalone --nproc_per_node
    1 -m byol_tpu_torch ... --zero1 on --flat-resident on`` (``argv``,
    default the ddp phase's); its run header's plan; its checkpoint
    restored into a one-card ``--zero1 off`` state, which then takes a
    step.  -> row."""
    import glob

    import torch
    from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
    from byol_tpu_torch.observability.events import read_events
    from byol_tpu_torch.training.state import (canonical_state,
                                               load_canonical)
    model_dir = os.path.join(root, "models")
    log_dir = os.path.join(root, "logs")
    argv = DDP_ARGV + ZERO1_FLAGS if argv is None else argv
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "byol_tpu_torch", *argv,
           "--model-dir", model_dir, "--log-dir", log_dir,
           "--grapher", "jsonl", "--workers-per-replica", "0"]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    # its own process group: on a timeout the launcher's workers are killed
    # with it
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    tail = out.strip().splitlines()[-12:]
    for line in tail:
        print(f"{what}: torchrun | {line[:200]}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: torchrun exited {proc.returncode}")
    (log,) = glob.glob(os.path.join(log_dir, "*", "run.jsonl"))
    header = next(read_events(log))
    plan = header["sharding_plan"]
    (run_dir,) = glob.glob(os.path.join(model_dir, "*"))
    store = CheckpointStore(run_dir)
    tree, epoch = store.restore(best=False)
    store.close()
    state, step = state_like
    load_canonical(state, tree)
    restored = _trees_bitwise(canonical_state(state), tree)
    loss = float(step(state, _ddp_batches(1)[0])["loss_mean"])
    print(f"{what}: torchrun --nproc_per_node 1 rc 0 in {wall:.1f} s; run "
          f"header sharding_plan {plan}; its checkpoint (epoch {epoch}, "
          f"step {tree['step']}) restored into a one-card --zero1 off state "
          f"bitwise {restored}, which then took step {state.step} with loss "
          f"{loss:.4f} [{card}]", flush=True)
    if not (plan["zero1"] == "on" and plan["mesh_shape"]["data"] == 1
            and plan["flat_resident"] == "on" and restored
            and math.isfinite(loss) and tree["step"] == 8):
        raise AssertionError(f"{what}: torchrun run {plan}, restored "
                             f"{restored}, step {tree['step']}, loss {loss}")
    return {"wall_s": wall, "sharding_plan": plan, "restored_bitwise":
            restored, "checkpoint_step": tree["step"]}


def run_ddp(card):
    """The data-parallel path on this one card: the range kernels of
    worlds 2 and 4; the slice's step at world 1 without a process group
    and over NCCL (a FileStore rendezvous, rank 0 of 1), with and without
    ZeRO-1, states bitwise equal; the synced BatchNorm forced on; the
    collectives on the 140 MB flat gradient; step profiles; then the
    torchrun launch.  -> (counts by run, kernel rows, row)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from byol_tpu_torch.parallel import collectives, mesh
    from byol_tpu_torch.training.state import canonical_state
    rows = check_range_kernels(card)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="chip_smoke_ddp_")
    try:
        batches = _ddp_batches(DDP_STEPS)
        runs, trees, counts, losses = {}, {}, {}, {}
        for where in ("solo", "nccl"):
            if where == "nccl":
                mesh.initialize_distributed(
                    "cuda", store=dist.FileStore(os.path.join(root, "store"),
                                                 1), rank=0, world_size=1)
                if not (mesh.is_initialized()
                        and dist.get_backend() == "nccl"):
                    raise AssertionError("ddp: no NCCL process group")
            for zero1 in (False, True):
                key = (where, zero1)
                state, step, counts[key], losses[key] = _ddp_run(zero1,
                                                                 batches)
                trees[key] = canonical_state(state)
                runs[key] = (state, step)
        checks = {
            "nccl == no group, zero1 off": (("solo", False), ("nccl", False)),
            "nccl == no group, zero1 on": (("solo", True), ("nccl", True)),
            "zero1 on == off, no group": (("solo", False), ("solo", True)),
        }
        bitwise = {}
        for name, (a, b) in checks.items():
            diff = _differing(trees[a], trees[b])
            bitwise[name] = not diff
            print(f"ddp: {name}: states bitwise {not diff}"
                  + (f"; differing leaves {diff[:6]}" if diff else "")
                  + f"; losses {losses[a]} vs {losses[b]} [{card}]",
                  flush=True)
        want = {False: (DDP_STEPS, DDP_STEPS, DDP_STEPS, 0, 0),
                True: (0, DDP_STEPS, DDP_STEPS, DDP_STEPS, DDP_STEPS)}
        for key, c in counts.items():
            print(f"ddp: launches {key} (segment_norms, fused_apply, "
                  f"two_view, segment_sums, segment_epilogue) = {c}",
                  flush=True)
            if c != want[key[1]]:
                raise AssertionError(f"ddp: launches {key} {c}, want "
                                     f"{want[key[1]]}")
        if not all(bitwise.values()):
            raise AssertionError(f"ddp: states differ: {bitwise}")
        bn_errs = _synced_bn_check(card)
        state, step = runs[("nccl", True)]
        grads = runs[("nccl", False)][0].grads
        shard = torch.empty(state.zero1.shard_elements, device="cuda")
        coll = {
            "all_reduce_mean_ms": _time_ms(
                lambda: collectives.grad_allreduce_mean(grads)),
            "reduce_scatter_ms": _time_ms(
                lambda: collectives.reduce_scatter_mean(shard,
                                                        state.grads)),
            "bucketed_gather_ms": _time_ms(
                lambda: state.zero1.gather(state.params)),
            "bytes": grads.numel() * 4}
        print(f"ddp: NCCL at world 1 on the {coll['bytes'] / 1e6:.1f} MB "
              f"flat gradient, eager ms: {coll} [{card}]", flush=True)
        # the step without collectives (built before the group existed)
        # against the step over NCCL, with and without ZeRO-1: wall ms of
        # 5 steps each in turns, then 3 profiled
        order = [("solo", False), ("nccl", False), ("nccl", True)]
        walls = {key: [] for key in order}
        for key in order + order[::-1]:
            st, fn = runs[key]
            fn(st, batches[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn(st, batches[0])
            torch.cuda.synchronize()
            walls[key].append((time.perf_counter() - t0) * 1e3 / 5)
        profiles = {}
        for key in order:
            st, fn = runs[key]
            profiles[key] = _device_profile(
                lambda: fn(st, batches[0]), 3, card,
                f"ddp world 1, {'NCCL' if key[0] == 'nccl' else 'no group'},"
                f" zero1 {'on' if key[1] else 'off'}, resnet50 batch 64 "
                f"step (wall ms of 5 steps, in turns: {walls[key]})",
                top=6 if key == ("nccl", True) else 0)
        # the step built without a group, with --zero1 off, takes the
        # launcher's checkpoint
        plain = runs[("solo", False)]
        del runs
        torch.cuda.empty_cache()
        mesh.shutdown()
        launcher = _torchrun(card, root, plain)
    finally:
        mesh.shutdown()
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    row = {"bitwise": bitwise, "synced_bn_max_rel_err": bn_errs,
           "collectives": coll,
           "busy_ms": {f"{w} zero1 {'on' if z else 'off'}": p["busy_ms"]
                       for (w, z), p in profiles.items()},
           "wall_ms": {f"{w} zero1 {'on' if z else 'off'}": walls[(w, z)]
                       for (w, z) in profiles},
           "torchrun": launcher,
           "range_kernels": {k: rows[k] for k in ("fused_apply_range",
                                                  "trust_rel_err",
                                                  "world1_bitwise")}}
    return counts, rows, row


# the optim phase: every chain of the optimizer registry on the unfused
# path (the ddp phase's config with --fused-update off)
OPTIM_ARGV = DDP_ARGV[:DDP_ARGV.index("--fused-update")] + [
    "--fused-update", "off", "--warmup", "0"]
OPTIM_STEPS = 3
OPTIM_CLIP = 0.01
# the adaptive bases normalise each element: the recipe's lr 0.2 would
# move every weight by ~0.2 a step, so they run at 1e-3
OPTIM_ADAPTIVE_LR = 1e-3


def _optim_chains():
    from byol_tpu_torch.optim.transforms import BASES
    names = list(BASES) + ["lars_" + b for b in BASES]
    return [(n, 0.0) for n in names] + [("sgd", OPTIM_CLIP),
                                       ("lars_lamb", OPTIM_CLIP)]


def _optim_argv(name, clip):
    lr = (OPTIM_ADAPTIVE_LR if name.split("_")[-1] in
          ("rmsprop", "adam", "lamb") else None)
    return OPTIM_ARGV + ["--optimizer", name, "--clip", str(clip)] + (
        ["--lr", str(lr)] if lr is not None else [])


def _optim_rcfg(argv):
    import dataclasses
    from byol_tpu_torch.cli import build_parser, config_from_args
    from byol_tpu_torch.core.config import resolve
    cfg = config_from_args(build_parser().parse_args(argv))
    cfg = cfg.replace(device=dataclasses.replace(cfg.device,
                                                 num_replicas=1))
    size = cfg.task.image_size_override
    return cfg, resolve(cfg, num_train_samples=512, num_test_samples=128,
                        output_size=10, input_shape=(size, size, 3))


def _optim_counters():
    """(two_view, segment_sums, segment_epilogue) launches."""
    c = _ddp_counters()
    return c[2], c[3], c[4]


def _optim_chain_runs(card, batches):
    """Each chain from one seeded ResNet-50 state, 3 steps on the same
    batches, every launch counter set to 0 before the first chain and
    read after the last.  -> (rows, counts)."""
    import torch
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.training.build import (build_net, build_tx,
                                               step_config)
    from byol_tpu_torch.training.state import create_train_state
    from byol_tpu_torch.training.steps import make_train_step
    cfg, rcfg = _optim_rcfg(_optim_argv("lars_momentum", 0.0))
    net = build_net(rcfg).to("cuda")          # built once, seeded
    init = create_train_state(net, ema_init_mode=cfg.parity.ema_init_mode)
    p0, t0 = init.params.clone(), init.target.clone()
    stats0 = {k: v.clone() for k, v in init.batch_stats().items()}
    del init
    policy = get_policy(cfg.device.half)
    rows = {}
    _zero_ddp_counters()
    for name, clip in _optim_chains():
        cfg, rcfg = _optim_rcfg(_optim_argv(name, clip))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(net, optimizer=name,
                                   ema_init_mode=cfg.parity.ema_init_mode)
        with torch.no_grad():
            state.params.copy_(p0)
            state.target.copy_(t0)
            for k, v in state.batch_stats().items():
                v.copy_(stats0[k])
        tx, schedule = build_tx(rcfg)
        step = make_train_step(tx, step_config(rcfg), schedule, policy)
        before = _optim_counters()
        losses = [float(step(state, batches[0])["loss_mean"])]
        prof = _device_profile(lambda: losses.append(float(step(
            state, batches[1])["loss_mean"])), 1, card,
            f"optim {name} clip {clip}, resnet50 batch 64 step", top=0,
            host=False)
        losses.append(float(step(state, batches[2])["loss_mean"]))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = tuple(a - b for a, b in zip(_optim_counters(), before))
        norms = int(tx.lars) + int(tx.base == "lamb")
        want = (OPTIM_STEPS, norms * OPTIM_STEPS, norms * OPTIM_STEPS)
        key = name + (f" clip {clip}" if clip else "")
        rows[key] = {"busy_ms": prof["busy_ms"],
                     "wall_ms": prof["wall_ms"],
                     "peak_gib": peak / 2**30, "losses": losses,
                     "launches": launches,
                     "opt_buffers": len(state.opt)}
        print(f"optim: {key}: losses {losses}, busy {prof['busy_ms']:.3f} "
              f"ms a step, peak {peak / 2**30:.2f} GiB, {len(state.opt)} "
              f"state buffers, launches (two_view, segment_sums, "
              f"segment_epilogue) = {launches} [{card}]", flush=True)
        if launches != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f"optim: {key}: launches {launches}, want "
                                 f"{want}; losses {losses}")
        del state, step
        torch.cuda.empty_cache()
    return rows, _optim_counters()


def _optim_update_checks(card):
    """One update of lars_adam, lamb and lbfgs at the ResNet-50 layout
    from seeded gradients and a seeded mid-run state, on the card (the
    kernels) and on CPU copies (the plain versions): rtol 1e-5.  Then the
    LAMB-layout epilogue against its plain version.  -> row."""
    import torch
    from byol_tpu_torch.ops import fused_update as fu
    from byol_tpu_torch.optim.factory import build_optimizer
    seg, _ = _rn50_segment_map()
    real = torch.zeros(seg.total, dtype=torch.bool, device="cuda")
    for start, size in zip(seg.starts, seg.sizes):
        real[start:start + size] = True
    gen = torch.Generator(device="cuda").manual_seed(3)

    def draw(scale, shape=(seg.total,)):
        return torch.randn(shape, generator=gen, device="cuda") * scale \
            * real

    p, g = draw(0.05), draw(1e-3)
    errs, ok = {}, True
    for name in ("lars_adam", "lamb", "lbfgs"):
        chain, _ = build_optimizer(name, base_lr=1e-3, global_batch_size=64,
                                   weight_decay=1e-6, total_units=10,
                                   warmup_units=0)
        opt, counts = chain.init(p)
        # a state in mid-run: every buffer filled, the counts past the
        # memory's length
        for k, buf in opt.items():
            if k == "weights_memory":
                buf.copy_(torch.rand(10, generator=gen, device="cuda") + 1)
            elif k == "nu":
                buf.copy_(draw(1e-3).square())
            else:
                buf.copy_(draw(1e-3, buf.shape))
        counts = {k: 13 for k in counts}
        host = {k: v.to("cpu", copy=True) for k, v in opt.items()}
        host_counts = dict(counts)
        dev_layout = fu.FusedLayout.build(seg, 1e-6, "cuda")
        cpu_layout = fu.FusedLayout.build(seg, 1e-6, "cpu")
        u, trust = chain.update(p, g, opt, counts, lr=1e-3,
                                layout=dev_layout)
        hu, htrust = chain.update(p.to("cpu", copy=True),
                                  g.to("cpu", copy=True), host, host_counts,
                                  lr=1e-3, layout=cpu_layout)
        torch.cuda.synchronize()
        pairs = [("u", u, hu), ("trust", trust, htrust)] + [
            (k, opt[k], host[k]) for k in opt]
        err = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(
            1e-30)).item() for _, a, b in pairs)
        good = counts == host_counts and all(
            torch.allclose(a.cpu(), b, rtol=1e-5,
                           atol=1e-7 * b.abs().max().item())
            for _, a, b in pairs)
        errs[name] = err
        ok = ok and good
        print(f"optim: one {name} update at the ResNet-50 layout, kernels vs "
              f"the plain versions on CPU copies: max abs err over max abs "
              f"{err:.3e} ok={good} [{card}]", flush=True)
    # LAMB's trust ratio through the split K1a on its layout
    lamb = fu.FusedLayout.build(fu.SegmentMap(
        sizes=seg.sizes, padded=seg.padded, starts=seg.starts,
        adapted=(True,) * seg.num_segments), 0.0, "cuda")
    sums = fu.segment_sums(p, g, lamb)
    scale, norms = fu.segment_epilogue(sums, lamb, 1.0, 0.0)
    ref_scale, ref_norms = fu.segment_epilogue_reference(sums, lamb, 1.0,
                                                          0.0)
    epi_err = max((scale - ref_scale).abs().max().item(),
                  (norms - ref_norms).abs().max().item())
    epi_ok = (torch.allclose(scale, ref_scale, **K1_TOL)
              and torch.allclose(norms, ref_norms, **K1_TOL))
    print(f"optim: segment_epilogue on the LAMB layout ({seg.num_segments} "
          f"segments, every one adapted, trust coefficient 1) vs its plain "
          f"version: max abs err {epi_err:.3e} ok={epi_ok} [{card}]",
          flush=True)
    if not (ok and epi_ok):
        raise AssertionError(f"optim: the chains' kernels disagree with "
                             f"their plain versions: {errs}, LAMB epilogue "
                             f"{epi_err}")
    return {"update_max_rel_err": errs, "lamb_epilogue_max_abs_err":
            epi_err}


def _optim_zero1(card, root, batches):
    """lars_adam and lbfgs at world 1 over NCCL (a FileStore rendezvous),
    --zero1 on against off, 3 steps each on the same batches under
    deterministic cuDNN: the states bit for bit.  -> row."""
    import torch.distributed as dist
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.parallel.compile_plan import plan_from_cfg
    from byol_tpu_torch.training.build import setup_training
    from byol_tpu_torch.training.state import canonical_state
    mesh.initialize_distributed(
        "cuda", store=dist.FileStore(os.path.join(root, "store"), 1),
        rank=0, world_size=1)
    if not (mesh.is_initialized() and dist.get_backend() == "nccl"):
        raise AssertionError("optim: no NCCL process group")
    out = {}
    try:
        for name in ("lars_adam", "lbfgs"):
            trees = {}
            for zero1 in (False, True):
                cfg, rcfg = _optim_rcfg(_optim_argv(name, 0.0) + (
                    ZERO1_FLAGS if zero1 else []))
                _, state, step, _, _ = setup_training(
                    rcfg, "cuda", plan=plan_from_cfg(cfg, 1))
                for b in batches:
                    step(state, b)
                trees[zero1] = canonical_state(state)
                del state, step
            diff = _differing(trees[False], trees[True])
            out[name] = not diff
            print(f"optim: {name} at world 1 over NCCL, --zero1 on (with "
                  f"--flat-resident on) vs off, {len(batches)} steps: states "
                  f"bitwise {not diff}"
                  + (f"; differing {diff[:6]}" if diff else "")
                  + f" [{card}]", flush=True)
    finally:
        mesh.shutdown()
    if not all(out.values()):
        raise AssertionError(f"optim: ZeRO-1 on != off: {out}")
    return out


def run_optim(card):
    """The optimizer registry on the card: every chain's 3 steps from one
    seeded state (the main path of this phase, counted), the chains'
    kernels against their plain versions, ZeRO-1 on against off at world
    1 over NCCL, and torchrun with lamb under ZeRO-1 whose checkpoint
    restores into a one-card lamb state.  -> (counts, row)."""
    import shutil
    import tempfile

    import torch
    from byol_tpu_torch.training.build import setup_training
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="chip_smoke_optim_")
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        parts[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    try:
        batches = _ddp_batches(OPTIM_STEPS)
        rows, counts = _optim_chain_runs(card, batches)
        print(f"optim: launches over the {len(rows)} chains (two_view, "
              f"segment_sums, segment_epilogue) = {counts}", flush=True)
        lap("chains")
        checks = _optim_update_checks(card)
        lap("update checks")
        zero1 = _optim_zero1(card, root, batches)
        lap("zero1")
        lamb = _optim_argv("lamb", 0.0)
        _, rcfg = _optim_rcfg(lamb)
        _, state, step, _, _ = setup_training(rcfg, "cuda")
        torchrun = _torchrun(card, os.path.join(root, "torchrun"),
                             (state, step), argv=lamb + ZERO1_FLAGS,
                             what="optim")
        del state, step
        lap("torchrun")
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(root, ignore_errors=True)
    print(f"optim: seconds by part {parts}", flush=True)
    return counts, {"chains": rows, "checks": checks,
                    "zero1_bitwise": zero1, "torchrun_lamb": torchrun,
                    "seconds": parts}


VIT_ARGV = ["--task", "fake", "--arch", "vit_b16", "--image-size-override",
            "224", "--batch-size", "64", "--epochs", "1",
            "--augment-placement", "step", "--fused-augment", "on",
            "--fused-update", "on"]
VIT_STEPS = 3                      # 192 fake images at batch 64
VIT_SIZE = 224
# the phase's three runs of the slice's command: name -> extra flags
VIT_RUNS = {
    "dense, cls": [],
    "ring at sequence 1, gap": ["--attn-impl", "ring", "--pooling", "gap"],
    "dense, cls, dots": ["--remat-policy", "dots"],
}
# the remat table: arch -> (argv, microbatches to try in order)
REMAT_ARCHS = {
    "resnet50": (ACCUM_ARGV[:ACCUM_ARGV.index("--batch-size")] + [
        "--augment-placement", "step", "--fused-augment", "on",
        "--fused-update", "on", "--epochs", "1"], (256,)),
    "vit_b16": (VIT_ARGV[:VIT_ARGV.index("--batch-size")] + [
        "--augment-placement", "step", "--fused-augment", "on",
        "--fused-update", "on", "--epochs", "1"], ACCUM_MICRO),
}


def _vit_config(extra, root, batch=None):
    from byol_tpu_torch.cli import build_parser, config_from_args
    argv = list(extra) + ["--model-dir", root, "--log-dir",
                          os.path.join(root, "logs")]
    if batch is not None:
        argv += ["--batch-size", str(batch)]
    return config_from_args(build_parser().parse_args(argv))


def _vit_rcfg(cfg, samples):
    import dataclasses
    from byol_tpu_torch.core.config import resolve
    return resolve(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)), num_train_samples=samples,
        num_test_samples=64, output_size=10,
        input_shape=(VIT_SIZE, VIT_SIZE, 3))


def _vit_batch(rows, seed=21):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"images": torch.randint(0, 256, (rows, VIT_SIZE, VIT_SIZE, 3),
                                    generator=gen, device="cuda",
                                    dtype=torch.uint8),
            "label": torch.randint(0, 10, (rows,), generator=gen,
                                   device="cuda", dtype=torch.int32)}


def _vit_fit(card, name, extra, root):
    """One run of the slice's command through the CLI's config and the
    trainer, counters set to 0 before and read after; then 1 + 3 timed
    steps and one profiled step on its trained state."""
    import dataclasses

    import torch
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.data.loader import get_loader
    from byol_tpu_torch.training.build import build_tx, step_config
    from byol_tpu_torch.training.steps import make_train_step
    from byol_tpu_torch.training.trainer import fit
    cfg = _vit_config(VIT_ARGV + extra, os.path.join(root, name.replace(
        " ", "_").replace(",", "")))
    batch_size = cfg.task.batch_size
    loader = get_loader(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)),
        num_fake_samples=batch_size * VIT_STEPS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _zero_counters()
    result = fit(cfg, device=torch.device("cuda"), loader=loader)
    counts = _read_counters()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = len(result.step_losses)
    print(f"vit: {name}: {steps} steps in {fit_s:.1f}s (build and eval "
          f"included), losses {result.step_losses}, test loss "
          f"{result.test_metrics['loss_mean']:.4f}, launches (flash, "
          f"segment_norms, fused_apply, two_view) = {counts}, peak "
          f"{peak / 1e9:.2f} GB [{card}]", flush=True)
    if steps != VIT_STEPS or not all(map(math.isfinite, result.step_losses
                                         + [result.test_metrics[
                                             "loss_mean"]])):
        raise AssertionError(f"vit: {name}: {steps} steps, losses "
                             f"{result.step_losses}")
    if counts != (0, steps, steps, steps):
        raise AssertionError(f"vit: {name}: launches {counts}, want (0, "
                             f"{steps}, {steps}, {steps})")
    state = result.state
    rcfg = _vit_rcfg(cfg, batch_size * VIT_STEPS)
    tx, schedule = build_tx(rcfg)
    step = make_train_step(tx, step_config(rcfg), schedule,
                           get_policy(cfg.device.half))
    batch = _vit_batch(batch_size)
    step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof = _device_profile(lambda: step(state, batch), 1, card,
                           f"vit_b16 train step, {name}, batch "
                           f"{batch_size}, per step",
                           top=8 if not extra else 0, host=False)
    row = {"steps": steps, "losses": result.step_losses,
           "launches": list(counts), "wall_ms": wall_ms,
           "img_per_s": batch_size * 1e3 / wall_ms,
           "busy_ms": prof["busy_ms"],
           "peak_gb": peak / 1e9, "fit_s": fit_s}
    print(f"vit: {name}: batch {batch_size} step wall {wall_ms:.2f} ms (3 "
          f"steps, "
          f"{row['img_per_s']:.1f} img/s), device busy "
          f"{prof['busy_ms']:.2f} ms of a profiled step [{card}]",
          flush=True)
    del result, state, step
    return counts, row


def _set_attention(net, impl):
    from byol_tpu_torch.models.vit import SelfAttention
    from byol_tpu_torch.ops.attention import get_attention_fn
    for m in net.modules():
        if isinstance(m, SelfAttention):
            m.attn_impl, m.attn_fn = impl, get_attention_fn(impl)


def _vit_checks(card, root):
    """ring against dense on one first step from the seeded state (gap
    pooling, bf16 3e-2), and dots against none on one first step (dense,
    cls) under deterministic cuDNN and cuBLAS: loss and gradients bitwise,
    else the largest difference held to 1e-6 relative."""
    import torch
    from byol_tpu_torch.core import remat
    from byol_tpu_torch.training.build import setup_training
    from byol_tpu_torch.training.state import (canonical_state,
                                               load_canonical)
    out = {}
    cfg = _vit_config(VIT_ARGV + VIT_RUNS["ring at sequence 1, gap"], root)
    batch = _vit_batch(cfg.task.batch_size, seed=22)
    samples = cfg.task.batch_size * VIT_STEPS
    _, state, step, _, _ = setup_training(_vit_rcfg(cfg, samples), "cuda")
    tree = canonical_state(state)
    ring = float(step(state, batch)["loss_mean"])
    load_canonical(state, tree)
    for net in (state.net, state.target_net):
        _set_attention(net, "dense")
    dense = float(step(state, batch)["loss_mean"])
    ok = abs(ring - dense) <= SLICE_TOL * (1 + abs(dense))
    out["ring_vs_dense"] = {"ring": ring, "dense": dense,
                            "diff": abs(ring - dense), "ok": ok}
    print(f"vit: first step from the seed, ring at sequence 1 vs dense "
          f"(gap): loss {ring:.6f} vs {dense:.6f}, ok={ok} (bf16 "
          f"{SLICE_TOL}) [{card}]", flush=True)
    del state, step, tree
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("vit: ring and dense disagree")

    cfg = _vit_config(VIT_ARGV, root)
    _, state, step, _, _ = setup_training(_vit_rcfg(cfg, samples), "cuda")
    tree = canonical_state(state)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        none = float(step(state, batch)["loss_mean"])
        g_none = state.grads.clone()
        load_canonical(state, tree)
        remat.set_remat_policy(state.net, "dots")
        with remat.probe_ops() as seen:
            dots = float(step(state, batch)["loss_mean"])
        g_dots = state.grads.clone()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    bitwise = none == dots and torch.equal(g_none, g_dots)
    rel = ((g_none - g_dots).abs().max()
           / g_none.abs().max().clamp_min(1e-30)).item()
    ok = bitwise or (rel <= 1e-6 and abs(none - dots) <= 1e-6 * abs(none))
    ops = sorted(set(seen))
    saved = sorted(o for o in ops if any(
        d in o for d in ("convolution", ".mm.", "addmm", "bmm")))
    out["dots_vs_none"] = {"loss_none": none, "loss_dots": dots,
                           "bitwise": bitwise, "grad_max_rel_diff": rel,
                           "ok": ok, "sac_contractions_seen": saved}
    print(f"vit: first step, dots vs none under deterministic cuDNN/cuBLAS: "
          f"loss {none!r} vs {dots!r}, gradients bitwise {bitwise} (largest "
          f"relative difference {rel:.3e}), ok={ok}; the SAC policy saw "
          f"{len(ops)} ops, contractions {saved} [{card}]", flush=True)
    del state, step, tree, g_none, g_dots
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("vit: dots and none disagree")
    return out


def _remat_table(card, root):
    """Each remat policy's one optimizer step (k = 1, K2 in the step) of
    ResNet-50 at 256 and of ViT-B/16 at 256 (128 where a none step of 256
    peaks above 75 GB), from one state per architecture, restored between
    policies: peak memory, device-busy ms of the profiled step, the
    running statistics bitwise against none's, the host bytes offloaded."""
    import gc

    import torch
    from byol_tpu_torch.core import remat
    from byol_tpu_torch.training.build import setup_training
    from byol_tpu_torch.training.state import (canonical_state,
                                               load_canonical)
    table = {}
    torch.backends.cudnn.deterministic = True
    try:
        for arch, (argv, micros) in REMAT_ARCHS.items():
            state = step = None
            for micro in micros:
                cfg = _vit_config(argv, root, batch=micro)
                _, state, step, _, _ = setup_training(
                    _vit_rcfg(cfg, micro), "cuda")
                tree = canonical_state(state)
                batch = _vit_batch(micro, seed=23)
                try:
                    peak = _peak_bytes(lambda: step(state, batch))
                except torch.cuda.OutOfMemoryError:
                    peak = float("inf")
                load_canonical(state, tree)
                if peak <= ACCUM_MEMORY_LIMIT or micro == micros[-1]:
                    break
                print(f"remat: {arch}: a none step of {micro} peaks at "
                      f"{peak / 1e9:.2f} GB (> {ACCUM_MEMORY_LIMIT / 1e9:.0f}"
                      f" GB): next microbatch", flush=True)
                del state, step, tree, batch
                gc.collect()
                torch.cuda.empty_cache()
            rows, base = {}, None
            for policy in remat.POLICY_NAMES:
                load_canonical(state, tree)
                remat.set_remat_policy(state.net, policy)
                remat.offload_stats(reset=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                prof = _device_profile(
                    lambda: step(state, batch), 1, card,
                    f"{arch} step of {micro} under remat {policy}", top=0,
                    host=False)
                peak = torch.cuda.max_memory_allocated()
                stats = {k: v.clone() for k, v in
                         state.batch_stats().items()}
                base = stats if base is None else base
                equal = all(torch.equal(stats[k], base[k]) for k in base)
                rows[policy] = {
                    "peak_gb": peak / 1e9, "busy_ms": prof["busy_ms"],
                    "wall_ms": prof["wall_ms"], "stats_equal_none": equal,
                    "host_bytes": remat.offload_stats()["bytes"]}
                print(f"remat: {arch} at {micro}, {policy}: peak "
                      f"{peak / 1e9:.2f} GB, busy {prof['busy_ms']:.2f} ms, "
                      f"running statistics == none's: {equal}, offloaded "
                      f"{rows[policy]['host_bytes'] / 1e9:.3f} GB [{card}]",
                      flush=True)
                if not equal:
                    raise AssertionError(f"remat: {arch} {policy}: the "
                                         "running statistics moved")
            remat.set_remat_policy(state.net, "none")
            table[arch] = {"microbatch": micro, "policies": rows}
            del state, step, tree, batch
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    return table


def _vit_update_rows(card):
    """K1a and K1b at the ViT-B/16 BYOL layout (heads 4096/256, 10
    classes), against their plain versions, graph-timed beside their
    bounds and ``torch._foreach_norm``."""
    import torch
    from byol_tpu_torch.models.byol_net import BYOLNet
    from byol_tpu_torch.models.registry import get_backbone
    from byol_tpu_torch.ops import fused_update as fu
    from byol_tpu_torch.training.state import tree_order
    backbone, _ = get_backbone("vit_b16")
    params = dict(BYOLNet(backbone, num_classes=10).named_parameters())
    names = tree_order(params)
    leaves = [params[n] for n in names]
    seg = fu.segment_map_for(leaves)
    shapes = [p.shape for p in leaves]
    del backbone, params, leaves
    layout = fu.FusedLayout.build(seg, 1e-6, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    p, g, m, t = (torch.randn(seg.total, device="cuda", generator=gen) * k
                  for k in (0.05, 1e-3, 1e-3, 0.05))
    scale, norms = fu.segment_norms(p, g, layout)
    ref_scale, ref_norms = fu.segment_norms_reference(p, g, layout)
    err_a = max((scale - ref_scale).abs().max().item(),
                (norms - ref_norms).abs().max().item())
    ok_a = (torch.allclose(scale, ref_scale, **K1_TOL)
            and torch.allclose(norms, ref_norms, **K1_TOL))
    kw = dict(lr=1e-4, tau=0.99, momentum_decay=0.9, ema_pre=False)
    got = [x.clone() for x in (p, m, t)]
    want = [x.clone() for x in (p, m, t)]
    fu.fused_apply(got[0], g, got[1], got[2], ref_scale, layout, **kw)
    fu.fused_apply_reference(want[0], g, want[1], want[2], ref_scale, layout,
                             **kw)
    err_b = max((a - b).abs().max().item() for a, b in zip(got, want))
    ok_b = all(torch.allclose(a, b, **K1_TOL) for a, b in zip(got, want))
    norm_leaves = fu.unpack_flat(p, seg, shapes) + fu.unpack_flat(g, seg,
                                                                  shapes)
    rows = {
        "segment_norms": dict(
            ms=_device_ms(lambda: fu.segment_norms(p, g, layout)),
            plain_ms=_device_ms(
                lambda: fu.segment_norms_reference(p, g, layout)),
            library_ms=_device_ms(lambda: torch._foreach_norm(norm_leaves)),
            bound_ms=2 * 4 * seg.total / HBM_BYTES_PER_S * 1e3,
            max_abs_err=err_a, ok=ok_a),
        "fused_apply": dict(
            ms=_device_ms(lambda: fu.fused_apply(
                got[0], g, got[1], got[2], scale, layout, **kw)),
            plain_ms=_device_ms(lambda: fu.fused_apply_reference(
                want[0], g, want[1], want[2], scale, layout, **kw)),
            library_ms=None,
            bound_ms=7 * 4 * seg.total / HBM_BYTES_PER_S * 1e3,
            max_abs_err=err_b, ok=ok_b),
    }
    for name, row in rows.items():
        row.update(bound_by="bytes", elements=seg.total,
                   rows=seg.total // fu.LANES, segments=seg.num_segments,
                   real=sum(seg.sizes))
        print(f"vit layout {name} {row} [{card}]", flush=True)
    if not (ok_a and ok_b):
        raise AssertionError("vit layout: K1a/K1b disagree with their "
                             "plain versions")
    return rows


def run_vit(card):
    """ViT-B/16 BYOL training (the slice's main path): the slice's command
    three times (dense with cls pooling; ring at sequence 1 with gap
    pooling; dense with ``--remat-policy dots``), each through the CLI's
    config and the trainer with the counters set to 0 before and read
    after (3 steps: K2 = K1a = K1b = 3); ring against dense and dots
    against none on one first step; K1a and K1b at the ViT layout; the
    seven remat policies' peak memory and busy ms for ResNet-50 and
    ViT-B/16.  -> (counts per run, row)."""
    import shutil
    import tempfile

    import torch
    root = tempfile.mkdtemp(prefix="chip_smoke_vit_")
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        parts[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    counts, runs = {}, {}
    try:
        for name, extra in VIT_RUNS.items():
            counts[name], runs[name] = _vit_fit(card, name, extra, root)
            torch.cuda.empty_cache()
        lap("runs")
        checks = _vit_checks(card, root)
        lap("checks")
        update = _vit_update_rows(card)
        lap("update kernels")
        table = _remat_table(card, root)
        lap("remat table")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"vit: seconds by part {parts}", flush=True)
    return counts, {"runs": runs, **checks, "update_kernels": update,
                    "remat": table, "seconds": parts}


TP_ARGV = ["--task", "synth", "--num-synth-samples", "192", "--arch",
           "resnet50", "--image-size-override", "224", "--batch-size", "64",
           "--epochs", "1", "--augment-placement", "step",
           "--fused-augment", "off", "--fused-update", "off",
           "--workers-per-replica", "0", "--grapher", "jsonl"]
TP_STEPS = 3                       # 192 synth images at batch 64
TP_TIMED = 3
# the fp32 step from the seed, model 2 against model 1, set before the
# first run: each leaf's largest |difference| over its largest magnitude
TP_TOL = {"params": 1e-5, "target": 1e-5, "momentum": 1e-3,
          "batch_stats": 1e-4}
# the health vector's norms of that step, model 2 against model 1, set
# before the first run: relative difference (a replicated leaf counted on
# both model ranks moves them by up to sqrt(2), 41 %)
TP_HEALTH_TOL = {"grad_norm": 1e-4, "param_norm": 1e-4,
                 "update_norm": 1e-4, "ema_drift": 1e-4}
# the Dense biases that feed a BatchNorm: their gradient is 0 in exact
# arithmetic, so they hold rounding noise, held against their tree key's
# largest magnitude instead of their own
ZERO_GRAD = ("projector.dense1.bias", "projector.dense2.bias",
             "predictor.dense1.bias")


def _tp_cfg(extra=()):
    from byol_tpu_torch.cli import build_parser, config_from_args
    return config_from_args(build_parser().parse_args(TP_ARGV + list(extra)))


def _tp_rcfg(cfg):
    import dataclasses
    from byol_tpu_torch.core.config import resolve
    return resolve(cfg.replace(device=dataclasses.replace(
        cfg.device, num_replicas=1)), num_train_samples=192,
        num_test_samples=64, output_size=10, input_shape=(224, 224, 3))


def _tp_fp32(model, batch):
    """The fp32 state of the tp config built from the seed at the laid-out
    model axis, its step with the health vector on: -> (its split leaves
    at step 0 on the host, the gathered canonical tree after one step on
    ``batch``, the step's loss, its health vector by field)."""
    import torch
    from byol_tpu_torch.observability import health
    from byol_tpu_torch.parallel import partitioning
    from byol_tpu_torch.parallel.compile_plan import plan_from_cfg
    from byol_tpu_torch.training.build import setup_training
    # no warmup: the step moves the params (warmup's step 0 has lr 0)
    cfg = _tp_cfg(["--no-half", "--warmup", "0", "--model-parallel",
                   str(model), "--telemetry", "step"])
    plan = plan_from_cfg(cfg, 1)
    _, state, step, _, _ = setup_training(_tp_rcfg(cfg),
                                          torch.device("cuda"), plan=plan)
    tree0 = {**state.tree(state.params), **state.batch_stats()}
    split = {name: v.to("cpu", copy=True) for name, v in tree0.items()
             if partitioning.tp_dim(name, v.ndim) is not None}
    metrics = step(state, batch)
    return (split, plan.to_canonical(state), float(metrics["loss_mean"]),
            health.unpack(metrics["health"].cpu()))


def _tp_rank(rank, root, card):
    """One rank of the tp phase's model-2 arm, a process of its own (two
    share the card, over gloo): (1) the port's CLI entry (``cli.main``)
    with ``--model-parallel 2`` on a process group made here, counters set
    to 0 before and read after; (2) its trained state's bf16 step, warm,
    then timed and profiled on rank 0 (both ranks step: the collectives
    pair them); (3) the fp32 state from the seed, one step.  Writes
    ``rank{r}.json``, its step-0 shards and, on rank 0, the fp32 tree."""
    import torch
    import torch.distributed as dist
    from byol_tpu_torch import cli
    from byol_tpu_torch.core.precision import get_policy
    from byol_tpu_torch.ops import flash_attention as fa
    from byol_tpu_torch.parallel import mesh
    from byol_tpu_torch.training import trainer
    from byol_tpu_torch.training.build import build_tx, step_config
    from byol_tpu_torch.training.steps import make_train_step
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def join(name):
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(root, name), 2),
            rank=rank, world_size=2)
    out = {}
    join("store_cli")
    fitted, fit = {}, trainer.fit

    def keep(*args, **kwargs):
        fitted["result"] = fit(*args, **kwargs)
        return fitted["result"]
    trainer.fit = keep
    torch.cuda.reset_peak_memory_stats()
    _zero_ddp_counters()
    t0 = time.perf_counter()
    out["rc"] = cli.main(TP_ARGV + [
        "--model-parallel", "2", "--model-dir", os.path.join(root, "m2"),
        "--log-dir", os.path.join(root, "l2")])
    out["cli_s"] = time.perf_counter() - t0
    out["counts"] = list(_ddp_counters()) + [fa.LAUNCHES]
    out["fit_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    result = fitted["result"]
    out["losses"] = result.step_losses
    out["test_loss"] = result.test_metrics["loss_mean"]
    # the layout the split K1a ran on: (segments, elements)
    out["layout"] = [result.state.seg.num_segments, result.state.seg.total]
    # main() left the group when it returned: a second one for the rest
    join("store_rest")
    mesh.init_mesh(1, 2)
    state = result.state
    rcfg = _tp_rcfg(_tp_cfg(["--model-parallel", "2"]))
    tx, schedule = build_tx(rcfg)
    step = make_train_step(tx, step_config(rcfg), schedule, get_policy(True))
    batch = _ddp_batches(1)[0]
    step(state, batch)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(TP_TIMED):
        step(state, batch)
    torch.cuda.synchronize()
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3 / TP_TIMED
    if rank == 0:
        prof = _device_profile(
            lambda: step(state, batch), 1, card,
            "resnet50 train step at model 2 (rank 0; the other rank on the "
            "same card, collectives through the host), batch 64, per step",
            top=6, host=False)
        out["busy_ms"], out["kinds"] = prof["busy_ms"], prof["kinds"]
    else:
        step(state, batch)
        torch.cuda.synchronize()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, result, fitted, step
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    split, tree, out["loss32"], out["health32"] = _tp_fp32(2, batch)
    torch.save(split, os.path.join(root, f"shards{rank}.pt"))
    if rank == 0:
        torch.save(tree, os.path.join(root, "tree32_m2.pt"))
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _tp_children(root, card):
    """The model-2 arm: two ranks of ``_tp_rank`` on this card.  -> their
    outputs, in rank order."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LOCAL_RANK="0", PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke._tp_rank("
         f"{r}, {root!r}, {card!r})"], cwd=here, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        for line in log.strip().splitlines()[-14:]:
            print(f"tp: rank {r} | {line[:200]}", flush=True)
        if p.returncode != 0:
            raise AssertionError(f"tp: rank {r} exited {p.returncode}")
    outs = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    return outs


def _tp_torchrun(root):
    """The model-1 arm: ``torchrun --standalone --nproc_per_node 1
    train_torch.py`` with the tp config.  -> (wall s, its run log)."""
    import glob
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "train_torch.py", *TP_ARGV,
           "--model-parallel", "1", "--model-dir", os.path.join(root, "m1"),
           "--log-dir", os.path.join(root, "l1")]
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall = time.perf_counter() - t0
    for line in out.strip().splitlines()[-6:]:
        print(f"tp: torchrun | {line[:200]}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"tp: torchrun exited {proc.returncode}")
    (log,) = glob.glob(os.path.join(root, "l1", "*", "run.jsonl"))
    return wall, log


def _tp_log(log):
    """(mesh_shape, train loss_mean) of a run log."""
    from byol_tpu_torch.observability.events import read_events
    events = list(read_events(log))
    train = [e for e in events if e["kind"] == "epoch"
             and e.get("split") == "train"]
    return events[0]["mesh_shape"], train[-1]["metrics"]["loss_mean"]


def _leaf_errors(got, want, tol):
    """Per tree key, the largest over its leaves of each leaf's max
    |difference| over its max magnitude (a ``ZERO_GRAD`` leaf's over its
    key's largest); -> (errors, leaves past tol)."""
    errs, bad = {}, []
    for key, limit in tol.items():
        worst = 0.0
        top = max(w.abs().max().item() for w in want[key].values())
        for name, w in want[key].items():
            g = got[key][name]
            if g.shape != w.shape:
                raise AssertionError(f"tp: {key} {name} shape "
                                     f"{tuple(g.shape)} vs {tuple(w.shape)}")
            scale = (top if name in ZERO_GRAD
                     else w.abs().max().item()) or 1.0
            err = (g.double() - w.double()).abs().max().item() / scale
            worst = max(worst, err)
            if err > limit:
                bad.append(f"{key} {name} {err:.3g}")
        errs[key] = worst
    return errs, bad


def _tp_segment_sums(card, path_layout):
    """The split K1a's ``segment_sums`` at a model rank's layout of the tp
    path (ResNet-50 with its heads cut to model index 0's shards of 2:
    the rank's whole buffer, 173 segments; index 1's has the same shapes)
    against its plain version, with the tp config's weight decay.
    ``path_layout``: [segments, elements] of the model-2 arm's state,
    which this layout must be.  -> its kernel-line numbers."""
    import torch
    from byol_tpu_torch.ops import fused_update as fu
    from byol_tpu_torch.training.build import build_tx
    seg, _ = _rn50_segment_map((2, 0))
    if [seg.num_segments, seg.total] != list(path_layout):
        raise AssertionError(f"tp: the model-2 layout here is "
                             f"{[seg.num_segments, seg.total]}, the path's "
                             f"{path_layout}")
    tx, _ = build_tx(_tp_rcfg(_tp_cfg()))
    lay = fu.FusedLayout.build(seg, tx.weight_decay, "cuda")
    real = torch.zeros(seg.total, dtype=torch.bool, device="cuda")
    for start, size in zip(seg.starts, seg.sizes):
        real[start:start + size] = True
    gen = torch.Generator(device="cuda").manual_seed(2)
    p, g = (torch.randn(seg.total, device="cuda", generator=gen) * k * real
            for k in (0.05, 1e-3))
    sums = fu.segment_sums(p, g, lay)
    ref = fu.segment_sums_reference(p, g, lay)
    err = (sums - ref).abs().max().item()
    rel = ((sums - ref).abs() / ref.abs().clamp_min(1e-300)).max().item()
    ok = torch.allclose(sums, ref, rtol=1e-5, atol=0.0)
    bounds = lay.seg_row_start.tolist()
    pieces = [x.view(-1, fu.LANES)[a:b].reshape(-1) for x in (p, g)
              for a, b in zip(bounds[:-1], bounds[1:])]
    ms = _device_ms(lambda: fu.segment_sums(p, g, lay))
    plain = _device_ms(lambda: fu.segment_sums_reference(p, g, lay))
    library = _device_ms(lambda: torch._foreach_norm(pieces))
    bound = (2 * 4 * lay.total + 16 * seg.num_segments) \
        / HBM_BYTES_PER_S * 1e3
    shape = (f"model index 0 of 2, {lay.rows} rows, {seg.num_segments} "
             f"segments")
    print(f"tp: segment_sums at {shape} (wd {tx.weight_decay}): against its "
          f"plain version max |err| {err:.3g}, max rel {rel:.3g} (rtol "
          f"1e-5: {ok}); {ms:.4f} ms graph, plain {plain:.4f}, "
          f"_foreach_norm {library:.4f}, bound {bound:.4f} (bytes) [{card}]",
          flush=True)
    if not ok:
        raise AssertionError(f"tp: segment_sums disagrees with its plain "
                             f"version at the model-2 layout: {rel}")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=library, max_abs_err=err, max_rel_err=rel, ok=ok,
                shape=shape)


def run_tp(card):
    """Tensor-parallel heads on this card: the preflight's probe; the
    model-2 arm (two processes over gloo through ``cli.main``) and the
    model-1 arm (``torchrun --nproc_per_node 1 train_torch.py``) of the tp
    config; the launches of the split K1a on the tp path, and its
    ``segment_sums`` at the path's layout against its plain version; the
    fp32 step from the seed at model 2 against model 1, its health
    vector's norms included; the model-2 checkpoint restored at model 1.
    -> (launches per rank, row, segment_sums' kernel-line numbers)."""
    import glob
    import shutil
    import tempfile

    import torch
    from byol_tpu_torch.checkpoint.checkpointer import CheckpointStore
    from byol_tpu_torch.core.preflight import preflight_backend
    from byol_tpu_torch.parallel import mesh, partitioning
    from byol_tpu_torch.parallel.compile_plan import plan_from_cfg
    from byol_tpu_torch.training.build import setup_training
    from byol_tpu_torch.training.state import canonical_state
    if mesh.is_initialized():
        raise AssertionError("tp: a process group is left from a phase")
    root = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    parts, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        parts[name] = round(time.perf_counter() - t, 1)
        t = time.perf_counter()
    try:
        ok = preflight_backend()
        lap("preflight")
        print(f"tp: the preflight probe on the card returned {ok} in "
              f"{parts['preflight']} s [{card}]", flush=True)
        if not ok:
            raise AssertionError("tp: the preflight probe failed")
        ranks = _tp_children(root, card)
        lap("model-2 arm")
        counts = [r["counts"] for r in ranks]
        for r, o in enumerate(ranks):
            print(f"tp: rank {r}: cli.main rc {o['rc']} in {o['cli_s']:.1f}"
                  f" s, losses {o['losses']}, test loss {o['test_loss']:.4f}"
                  f", launches (segment_norms, fused_apply, two_view, "
                  f"segment_sums, segment_epilogue, flash) = {o['counts']}; "
                  f"bf16 step wall {o['wall_ms']:.2f} ms ({TP_TIMED} steps)"
                  + (f", device busy {o['busy_ms']:.2f} ms" if r == 0
                     else "")
                  + f"; peak {o['fit_peak_gb']:.2f} GB in the fit, "
                  f"{o['peak_gb']:.2f} GB with the timed steps [{card}]",
                  flush=True)
        print("tp: NOT the cost of TP on NVLink: both ranks share this one "
              "card and their collectives go through the host (gloo)",
              flush=True)
        want = [0, 0, 0, TP_STEPS, TP_STEPS, 0]
        if any(c != want for c in counts) or any(
                len(o["losses"]) != TP_STEPS
                or not all(map(math.isfinite, o["losses"]))
                for o in ranks):
            raise AssertionError(f"tp: launches {counts} (want {want} a "
                                 f"rank), losses "
                                 f"{[o['losses'] for o in ranks]}")
        if ranks[0]["losses"] != ranks[1]["losses"]:
            raise AssertionError("tp: the model ranks' losses differ")
        sums_row = _tp_segment_sums(card, ranks[0]["layout"])
        lap("segment_sums check")
        wall1, log1 = _tp_torchrun(root)
        lap("model-1 arm")
        (log2,) = glob.glob(os.path.join(root, "l2", "*", "run.jsonl"))
        (mesh1, loss1), (mesh2, loss2) = _tp_log(log1), _tp_log(log2)
        loss_ok = abs(loss2 - loss1) <= 3e-2 * abs(loss1)
        print(f"tp: torchrun --nproc_per_node 1 train_torch.py rc 0 in "
              f"{wall1:.1f} s, mesh {mesh1}, train loss {loss1:.6f}; the "
              f"model-2 arm's mesh {mesh2}, train loss {loss2:.6f} (bf16, "
              f"rtol 3e-2: {loss_ok}) [{card}]", flush=True)
        if not (loss_ok and mesh1["model"] == 1 and mesh2["model"] == 2):
            raise AssertionError(f"tp: model-1 arm {mesh1} {loss1}, "
                                 f"model-2 arm {mesh2} {loss2}")
        # the fp32 step from the seed at model 1, in this process
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            split1, tree1, loss32, health1 = _tp_fp32(1, _ddp_batches(1)[0])
        finally:
            torch.backends.cudnn.deterministic = False
        shards_ok = True
        for r in range(2):
            got = torch.load(os.path.join(root, f"shards{r}.pt"))
            for name, shard in got.items():
                dim = partitioning.tp_dim(name, shard.ndim)
                shards_ok = shards_ok and torch.equal(
                    shard, partitioning.shard_leaf(split1[name], dim, 2, r))
        tree2 = torch.load(os.path.join(root, "tree32_m2.pt"))
        errs, bad = _leaf_errors(tree2, tree1, TP_TOL)
        loss32_err = abs(ranks[0]["loss32"] - loss32) / abs(loss32)
        print(f"tp: fp32 from the seed: every rank's step-0 head shards the "
              f"slices of the model-1 tree bitwise {shards_ok}; after one "
              f"step, model 2's gathered tree against model 1's, each "
              f"leaf's max |diff| over its max |value|, worst per key "
              f"{ {k: f'{v:.3g}' for k, v in errs.items()} } (tolerances "
              f"{TP_TOL}), loss {ranks[0]['loss32']:.7f} vs {loss32:.7f} "
              f"(rel {loss32_err:.2g}) [{card}]", flush=True)
        health2 = ranks[0]["health32"]
        health_err = {k: abs(health2[k] - health1[k]) / abs(health1[k])
                      for k in TP_HEALTH_TOL}
        health_bad = [k for k, v in health_err.items()
                      if not v <= TP_HEALTH_TOL[k]]
        ranks_equal = ranks[0]["health32"] == ranks[1]["health32"]
        rel = {k: f"{v:.3g}" for k, v in health_err.items()}
        print(f"tp: fp32 health vector after that step, model 2 against "
              f"model 1, relative: {rel} (tolerances {TP_HEALTH_TOL}; model 2 "
              f"{ {k: health2[k] for k in TP_HEALTH_TOL} }, model 1 "
              f"{ {k: health1[k] for k in TP_HEALTH_TOL} }); the two "
              f"model ranks' vectors equal {ranks_equal} [{card}]",
              flush=True)
        if not shards_ok or bad or loss32_err > 1e-5 or health_bad \
                or not ranks_equal:
            raise AssertionError(f"tp: fp32 shards {shards_ok}, past "
                                 f"tolerance {bad[:8]}, loss {loss32_err}, "
                                 f"health past tolerance {health_bad}, "
                                 f"ranks' health equal {ranks_equal}")
        del tree1, tree2
        lap("fp32 check")
        # the model-2 checkpoint restored at model 1 on the card
        (run_dir,) = glob.glob(os.path.join(root, "m2", "*"))
        store = CheckpointStore(run_dir)
        tree, epoch = store.restore(best=False)
        store.close()
        cfg = _tp_cfg()
        plan = plan_from_cfg(cfg, 1)
        _, state, _, _, _ = setup_training(_tp_rcfg(cfg),
                                           torch.device("cuda"), plan=plan)
        plan.from_canonical(state, tree)
        restored = _trees_bitwise(canonical_state(state), tree)
        whole = tree["params"]["projector.dense1.weight"].shape
        print(f"tp: the model-2 checkpoint (epoch {epoch}, step "
              f"{tree['step']}, projector.dense1.weight {tuple(whole)}) "
              f"restored at model 1 on the card, equal to the tree saved "
              f"bitwise {restored} [{card}]", flush=True)
        if not restored or tree["step"] != TP_STEPS:
            raise AssertionError(f"tp: restore {restored}, step "
                                 f"{tree['step']}")
        del state, tree
        lap("restore at model 1")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"tp: seconds by part {parts}", flush=True)
    row = {"ranks": [{k: o[k] for k in ("losses", "counts", "wall_ms",
                                        "fit_peak_gb", "peak_gb", "cli_s")}
                     for o in ranks],
           "rank0_busy_ms": ranks[0]["busy_ms"],
           "rank0_kinds": ranks[0]["kinds"],
           "not_nvlink": "two ranks on one card, collectives through the "
                         "host (gloo)",
           "model1_torchrun_s": wall1, "train_loss": [loss1, loss2],
           "fp32_leaf_errors": errs, "fp32_tol": TP_TOL,
           "fp32_health_rel_errors": health_err,
           "fp32_health_tol": TP_HEALTH_TOL,
           "shards_bitwise": shards_ok, "restored_at_model_1": restored,
           "seconds": parts}
    return counts, row, sums_row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    from byol_tpu_torch.ops import common

    card = _smi("name,power.limit").strip()
    print(card, flush=True)              # name, power limit (nvidia-smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS reads its workspace setting when its handle is made: the vit
    # phase's deterministic remat check needs the deterministic one
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    t0 = time.perf_counter()
    path = common.build()
    common.library()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f}s "
          f"(nvcc {common.build_seconds:.1f}s)", flush=True)
    if common.build_log is not None:
        for line in common.build_log.read_text().splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"build: {line.strip()[:160]}", flush=True)

    phases = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.empty_cache()
        phases[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {phases[name]} s", flush=True)
        return out
    flash_rows = phase("flash", check_flash, card)
    k1_rows = phase("fused_update", check_fused_update, card)
    k2_rows = phase("two_view", check_two_view, card)
    phase("two_view passes", k2_pass_sweeps, card)
    serving_launches, versus = phase("serving", run_slice, card)
    wire_launches, wire_row = phase("wire", run_wire, card)
    train_counts = phase("training", run_training, card)
    ckpt_counts, resumed_counts = phase("checkpoint", run_checkpoint, card)
    input_counts, input_rows = phase("input", run_input, card)
    accum_counts, accum_row = phase("accum", run_accum, card)
    observe_counts, observe_row = phase(
        "observe", run_observe, card, accum_row["microbatch"], accum_row)
    le_counts, le_row = phase("linear_eval", run_linear_eval, card)
    ddp_counts, ddp_rows, ddp_row = phase("ddp", run_ddp, card)
    optim_counts, optim_row = phase("optim", run_optim, card)
    vit_counts, vit_row = phase("vit", run_vit, card)
    tp_counts, tp_row, tp_sums = phase("tp", run_tp, card)
    # this slice's main path: the model-2 arm's two ranks (counts a rank:
    # segment_norms, fused_apply, two_view, segment_sums, segment_epilogue,
    # flash)
    tp = [sum(c[i] for c in tp_counts) for i in range(6)]

    main_row = next(r for r in flash_rows
                    if r["shape"] == [64, HEADS, SEQ, 64]
                    and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "byol_tpu_torch/ops/csrc/flash_attention.cu",
        "replaces": "byol_tpu/ops/flash_attention.py:47",
        # this slice's main path: served over the wire, from graph
        # replays (each bucket's capture launches x its replays)
        "launches": wire_launches,
        "launches_by_path": {
            "wire (graph replays)": wire_launches,
            "serving (graph replays)": serving_launches,
            "linear_eval": le_counts[0], "observe": observe_counts[0],
            "accum": accum_counts[0], "training": train_counts[0],
            "vit": sum(c[0] for c in vit_counts.values()), "tp": tp[5]},
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

    # this slice's main path: the vit phase's three runs of ViT-B/16, each
    # with the counters set to 0 before it
    vit = [sum(c[i] for c in vit_counts.values()) for i in range(4)]
    vit_paths = {f"vit {name}": c for name, c in vit_counts.items()}
    # the ddp phase's two runs over NCCL (zero1 off, then on)
    ddp = [a + b for a, b in zip(ddp_counts[("nccl", False)],
                                 ddp_counts[("nccl", True)])]

    def ddp_paths(i):
        return {f"ddp {where}, zero1 {'on' if z else 'off'}": c[i]
                for (where, z), c in ddp_counts.items()}

    def by_path(i, j):
        """A kernel's launches on each training path (and 0 on the served
        ones); ``j`` its index among the ddp phase's counters."""
        paths = {"tp": tp[j], "vit": vit[i]}
        paths.update({name: c[i] for name, c in vit_paths.items()})
        paths.update(ddp_paths(j))
        paths.update({"linear_eval": le_counts[i], "wire": 0, "serving": 0,
                 "observe": observe_counts[i], "accum": accum_counts[i],
                 "training": train_counts[i],
                 "checkpoint, uninterrupted": ckpt_counts[i],
                 "checkpoint, relaunch after SIGTERM": resumed_counts[i]})
        paths.update({name: c[i] for name, c in input_counts.items()})
        return paths
    for name, line, i, j in (("segment_norms", 198, 1, 0),
                             ("fused_apply", 215, 2, 1)):
        row = k1_rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "byol_tpu_torch/ops/csrc/fused_update.cu",
            "replaces": f"byol_tpu/ops/fused_update.py:{line}",
            "launches": vit[i], "launches_by_path": by_path(i, j),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "elements": row["elements"],
            "vit_layout": vit_row["update_kernels"][name],
            "ok": row["ok"] and vit_row["update_kernels"][name]["ok"]})
    k2 = k2_rows[0]                      # the training shape
    kernels.append({
        "name": "two_view", "route": "cuda",
        "source": "byol_tpu_torch/ops/csrc/fused_augment.cu",
        "replaces": "byol_tpu/ops/fused_augment.py:179",
        "launches": vit[3],
        "launches_by_path": dict(by_path(3, 2), optim=optim_counts[0]),
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None, "einsum_crop_ms": k2["einsum_crop_ms"],
        "shape": [64, 224, 224, 3],
        "ok": all(r["ok"] for r in k2_rows)})
    # K1a split: its own entries, which the ZeRO-1 fused update and every
    # LARS and LAMB chain call; this slice's main path is the tp phase's
    # model-2 arm (one of each a step on each of its two ranks), and
    # segment_sums' numbers are at that path's layout, the ZeRO-1 range's
    # beside them (the epilogue's 173 segments are the same on both)
    for name, j, i in (("segment_sums", 3, 1), ("segment_epilogue", 4, 2)):
        row = ddp_rows[name]
        if name == "segment_sums":
            row = dict(tp_sums, zero1_range=row)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "byol_tpu_torch/ops/csrc/fused_update.cu",
            "replaces": "byol_tpu/ops/fused_update.py:198 (the ZeRO-1 "
                        "call at :417)",
            "launches": tp[j],
            "launches_by_path": dict(ddp_paths(j), optim=optim_counts[i],
                                     tp=tp[j]),
            "tp_launches_per_rank": [c[j] for c in tp_counts],
            **row})
    print(json.dumps({"input_arms": input_rows}), flush=True)
    print(json.dumps({"accum": accum_row}), flush=True)
    print(json.dumps({"observe": observe_row}), flush=True)
    print(json.dumps({"serving_graph_vs_eager": versus, "wire": wire_row,
                      "linear_eval": le_row}), flush=True)
    print(json.dumps({"ddp": ddp_row}), flush=True)
    print(json.dumps({"optim": optim_row}), flush=True)
    print(json.dumps({"vit": vit_row}), flush=True)
    print(json.dumps({"tp": tp_row}), flush=True)
    print(f"phases, s: {phases}; total since start "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
