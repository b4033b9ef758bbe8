#!/usr/bin/env python3
"""Smoke test of cvm_tpu_torch on one CUDA card (an NVIDIA H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
hand-written kernels from ``cvm_tpu_torch/csrc`` and drives the port's
slices with random seeded weights: serving CenterNet config B (512x512,
``small`` backbone with the space-to-depth stem, stride 4, 80 classes,
batch 8, planar YUV420 padded to 768x768), training the same model on
the flagship synthetic recipe (10 classes, batch 16, 512x512 padding)
through ``cvm_tpu_torch.cli.train``, and evaluating it (with evals during
training, then ``cvm_tpu_torch.cli.evaluate`` in four postures); then the
dense zoo at full width (256x640, ``small`` backbone, space-to-depth
stem): semseg (config A at batch 1, and batch 8), depth (config C) and
multitask (config D), served, trained and timed by ``cli.benchmark``; then
the int8 deployment slice: config B in W8A8 on ``torch._int_mm``, the
trained model exported in five postures and each artifact served, and a
QAT fine-tune of it; then the rest of the zoo: config B with the
monocular 3D heads (served in fp and int8, trained on the flagship recipe
with ``--with_3d true``, exported) and DMDS, config E (192x640, batch 8,
``small``, ``motion_features`` 128, object motion on); then the record
path at config B's width: JPEG decode (nvJPEG on the card), training and
evaluation from ``.cvrec`` records, and serving records and HTTP requests
through an exported artifact; then the data tools and offline inference:
a COCO-layout tree packed, validated, counted, rendered and repacked,
config B trained from the packed shard, and ``cli.infer`` over its images
through an exported artifact and a checkpoint; then the rest of the single-
card surface (video inference, the stall watchdog and re-exec, profiling,
``--debug_nans``, TensorBoard, the LR finder, rotation, remat and tiled
inference, phases 28-33, run after 27); then multi-process training on the
one card (phase 34), sharded serving (35) and whole-host training (36).
``cli.doctor``'s report (the card, the toolchain and the JPEG decoders'
prerequisites) is printed first:

  1. card, versions, both kernel builds (one nvcc each, started together);
  2. the fused W8A8 ConvBN kernel K2 vs its plain PyTorch version at every
     config-B shape, the reference tests' shapes and one case per special
     path of the kernel, in four modes; then, per main-path call, the
     kernel's device time beside its bound, cuDNN's bf16 conv of the same
     shape (the library yardstick) and the plain version's time; then the
     same for every distinct K2 call of the dense models' int8 forwards
     (recorded from one forward of each), batch 1 and the 8x20 map of
     stride 32 included;
  3. the model at full width with non-trivial BN statistics, calibrated on
     3 synthetic batches; the fp (BN folded) and int8 (fused + chained)
     pipelines;
  4. one batch-8 request through each posture: finite results, exactly 24
     kernel launches (7 with int8 output) and no weight packing per int8
     forward, int8 heads near fp heads, and the int8 posture through the
     kernel vs through the plain version on the card;
  5. a DynamicBatcher over the int8 pipeline answering 16 threaded requests;
  6. median batch-8 latency of both postures;
  6b. the folded conv's epilogue (``csrc/conv_epilogue.cu``) in the
     benchmark's two fp cells (config B at batch 8, semseg A at batch 1,
     seeded as the cells seed them): every call of one forward recorded
     (31 and 29), the kernel vs its plain version bit for bit, the calls'
     device time per forward beside their bytes bound at 3.35 TB/s, the
     plain version's and the old fold's unfused sequence (``library_ms``,
     the yardstick); the kernel's own launch counter over 10 replays of
     each pipeline (one launch per folded conv per replay, none in the
     old fold); then each cell's replayed step with the old fold
     (``BiasAdd``, a cast per weight and bias per call) and the new, in
     turns (old, new, new, old), and its device kernels by class. Every
     fp fold_bn path this process serves (phases 4, 6, 6b, 9, 12, 16, 18,
     20, 21) is held to that counter too (``epilogue_launches``);
  6c. the eval YUV420 letterbox kernel (``csrc/yuv_letterbox.cu``) in the
     same two cells: the kernel vs its plain version (the eager ops) bit for
     bit on a batch of each cell's frames, in bf16 and float32, ROI fields
     included; the device kernels of one call (one) against the eager
     ops'; the kernel's device time beside its bytes bound at 3.35 TB/s
     (the output, and the plane rows and columns its taps touch) and the
     eager ops' time; its launch counter over 10 replays of a pipeline on
     the kernel (10) and of one captured on the eager preprocess (0),
     whose outputs are equal; each cell's replayed step on the eager
     preprocess and on the kernel in turns, and its kernels by class. Every
     CUDA YUV420 eval path this process serves (phases 3, 4, 6, 6b, 9, 16,
     18, 20, 21) and phase 35's ranks are held to that counter too
     (``letterbox_launches``: one a call, one per frame in DMDS);
  7. the Gaussian splat kernel K1 vs its plain version at the flagship
     training shape, config B's default shape, multitask's (B8 K128 64x160
     C10) and twelve edge cases, each
     output block poisoned with NaN first; one call at the flagship shape
     runs exactly one device kernel (torch.profiler); its device time
     beside its bound and the plain version's time;
  8. training through ``cli.train.main``: 30 steps with a checkpoint at
     step 20 (finite, falling loss, one K1 launch per step), then a second
     call that resumes from step 20 to 40; median ms per step;
  9. the trained model served (BN folded) for one batch-8 request;
 10. training with evaluation through ``cli.train.main``: 20 steps with an
     eval every 10 (2 batches of 16), ``--keep_best mAP --early_stop 1``
     (one K1 launch per step, ``val_mAP`` at steps 10 and 20, a best
     checkpoint on disk); seconds per eval;
 11. ``cli.evaluate.main`` on that workdir at batch 16 and 512^2 padding,
     2 batches, in four postures: fp, ``--fold_bn``, ``--quantize
     w8a8_fused_chain`` (24 K2 launches per forward, 7 int8-out, no weight
     packs) and ``--tta hflip``; then the int8 posture at batch 16 through
     K2 and through its plain version (heads and mAP; the plain version in
     a pipeline of its own, since a CUDA graph's replay runs the kernel
     whatever is swapped in after its capture), and the eval layer's host
     and device ms per batch;
 12. dense serving, each model at batch 8 (and semseg at batch 1): fp with
     BN folded and ``w8a8_fused_chain`` after 1 calibration batch, K2's
     launches per int8 forward (24 semseg, 27 depth, 28 multitask), the
     int8 posture through K2 vs its plain version (mean |d| of logits and
     depth, class-map agreement), and batch latencies;
 13. dense training through ``cli.train.main``: 20 multitask steps (one K1
     launch per step, finite and falling loss), then 20 semseg steps with
     an eval (mIoU);
 14. ``cli.benchmark --configs A,B,C,D --iters 6``: one JSON line each;
 15. int8 through ``torch._int_mm``: one config-B batch-8 forward in
     ``w8a8`` (dynamic scales) and one in ``w8a8_static`` (phase 3's
     scales), every ``Int8Conv`` call recorded and its int32 sums held to
     their float64 plain version exactly (stem, stride-2 convs and heads
     included); the int8 convs' device time beside cuDNN's bf16 convs of
     the same shapes; batch-8 ``predict`` of fp, ``w8a8``,
     ``w8a8_static`` and ``w8a8_fused_chain`` on the host clock;
 16. ``cli.export`` of phase 8's step-40 checkpoint in five postures
     (``none`` with BN folded, ``int8``, ``w8a8``, ``w8a8_fused``,
     ``w8a8_fused_chain``; yuv420, buckets 1 and 8), each loaded by
     ``ServingModel(device="cuda")``: its selftest passes, its outputs equal
     the eager pipeline's of the same posture (boxes and classes
     identically in the int8 postures), the fused artifacts launch K2 24
     times per batch-8 call, and ``cli.serve --selftest`` exits 3 on a
     tampered ``weights.npz``; the artifact's ``predict`` beside the eager
     pipeline's;
 17. QAT: ``cli.train --qat true`` resumes phase 8's fp run for 20 steps
     with an eval every 10 (one K1 launch per step, finite loss, the evals
     under fake-quant);
 18. 3D serving: config B with the 3D heads at batch 8 on 768^2 YUV420 with
     intrinsics, fp (BN folded) and ``w8a8_fused_chain`` after 3
     calibration batches: 27 K2 launches per int8 forward (7 int8-out, no
     packs), the int8 posture through K2 vs its plain version (mean |d| of
     each head within 1% of the plain head's mean |value|, decoded classes
     identical), batch-8 latencies;
 19. 3D training: ``cli.train.main --with_3d true`` on the flagship recipe,
     20 steps with an eval at 10 and 20 (one K1 launch per step, finite
     and falling loss; ``val_mAP`` and the three 3D metrics);
 20. 3D export: that run in ``none`` and ``w8a8_fused`` (yuv420 with
     intrinsics, batch 8), each served by ``ServingModel(device="cuda")``:
     its selftest passes and its outputs equal the eager pipeline's (boxes
     and classes identical in int8; 27 K2 launches per fused call);
 21. DMDS: the pose-recovery property on the card (Adam 0.05, 300 steps);
     ``cli.train.main --model dmds`` 20 steps with an eval (median-scaled
     ``abs_rel`` / ``delta1``) and ms/step; one two-frame batch-8 request
     in fp (BN folded); ``cli.benchmark --configs E`` (500 pipelined steps);
     a ``none`` export served against its eager pipeline. DMDS runs no TPU
     kernel: the reference refuses W8A8 for it;
 22. decode: the committed fixture (``tests/data/torch_records``) decoded
     on the card, RGB and YUV420 at the 768^2 pad with and without its
     target, every ``hw`` equal to the reference decoder's and the pixels
     held frame by frame: a full-scale frame to what IDCT rounding can do
     (``IDCT_GAP``), the 1/2-scale frame to the gap between the reference's
     own two decoders (its PIL fallback against libjpeg) on that frame, as
     the fixture records it; a batch of 8 timed with 1 and 4 threads;
     ``RecordLoader.stats()`` per stage;
 23. training from records: the fixture's 8 records 10 times over (72
     train, 8 val), ``cli.train.main --data`` at config B, batch 8, 20
     steps with one eval of the val split (one K1 launch per step, finite
     and falling loss, ms/step beside phase 8's), then ``cli.evaluate
     --data`` on the checkpoint;
 24. serving records: that checkpoint exported ``w8a8_fused_chain``
     (planar YUV420, 768^2, bucket 8); ``cli.serve --records`` over three
     batches (24 K2 launches per batch-8 call, every JSON line equal to the
     eager pipeline's of the same posture and calibration); a
     ``ModelServer`` on 127.0.0.1 answering 16 concurrent POSTs of the
     fixture's JPEGs (24 K2 launches per dispatched batch, classes equal
     and boxes within 1e-3 px of a direct ``ServingModel`` call on the
     same decoded frame), with its batch fill and latency percentiles;
 25. pack and check: a COCO-layout tree (``annotations/instances_val2017.json``
     with COCO's 80 category ids, gaps included; 64 synthetic scenes at
     640x480 and 480x640, six as PNGs, two as 4:4:0 JPEGs) through
     ``cli.pack --dataset coco``, ``cli.validate`` (0 errors, every JPEG
     decoded on the card), ``cli.stats`` (class counts equal to the
     annotation file's), ``cli.inspect`` (4 PNGs) and ``cli.repack`` on the
     card (every plane equal to the card's decode of the same bytes); the
     4:4:0 frames within the IDCT gap of PIL's decode; each tool's seconds;
 26. ``cli.train --data`` on that shard at config B (512^2, ``small``, 80
     classes, batch 8), 20 steps: one K1 launch per step, ms/step;
 27. offline inference: ``cli.export --input_format rgb --quantize
     w8a8_fused_chain --batch_size 8`` of that checkpoint, then
     ``cli.infer --artifact`` over the tree's images with ``--visualize``
     and ``--score_threshold 0``: 8 batches, 24 K2 launches per call, every
     JSON line equal to the eager pipeline's of the same posture on the
     same decoded batch, one PNG per image at the source size; then
     ``cli.infer --checkpoint_dir`` in fp, with ``--w8a8`` (``torch._int_mm``,
     0 K2 launches) and over ``--records``; ms per batch of each;
 33b. video: ``run_video`` over those images, decoded on the card as
     ``cli.infer`` decodes them, through that artifact's ``predict``
     (``cli.video.artifact_predict``): every JSON line equal to ``cli.infer
     --artifact``'s (boxes and classes identical, scores after rounding), 24
     K2 launches per batch-8 call; then, where ``cli.doctor`` finds ``cv2``,
     the full ``cli.video --artifact`` (decode, annotate, encode) over a
     16-frame mp4;
 28. the stall watchdog: config-B training in a child process
     (``tests/torch_hang_child.py``, threshold 4 s, re-exec armed) whose
     step 4 sleeps on the device for 20 s: the stall reported as the
     device's, AUTO-RESTART 1/1, the new process image resumed from the
     step-2 checkpoint to step 12 (the detection latency and the time to the
     first step after the exec); a second child stopped (SIGSTOP) for 10 s
     and continued finishes 40 steps without a restart;
 29. ``cli.train --profile_steps 5`` on config B: the trace's five longest
     CUDA kernels, K1 among them; ``--debug_nans`` on a run a huge learning
     rate makes non-finite raises at step 3, naming the tensors;
 30. ``cli.train --tensorboard --eval_every 5 --eval_images 2``: the event
     file (read back by the port's reader) holds every step's scalars, the
     evals' and two images per eval;
 31. ``cli.lr_find`` on config B (a 20-step sweep): a finite suggestion;
     20 config-B steps with ``--aug_rotate_deg 15``: finite loss, one K1
     launch per step;
 32. ``remat``: one config-B step with and without, from the same weights
     and batch: loss and gradient-norm gap, peak device memory, ms/step;
     then config-B ``fit`` steps/s with the watchdog's in-flight bound (8
     steps) and without, two pairs after a warm-up run;
 33a. ``cli.infer --tiled`` of a config-A semseg checkpoint over three
     720x1280 images: tiles and ms per image;
 34. multi-process training (``cvm_tpu_torch/parallel``) on the one card,
     the ranks children of ``tests/torch_dist_child.py``, cuDNN
     deterministic throughout: (a) config B on
     the flagship scenes, global batch 16, 10 steps, two gloo ranks of 8
     rows sharing the card against one process of 16 on the same global
     batches and draws: losses equal between the ranks and within 5e-3
     of the one process, parameter checksums equal, 10 K1 launches per
     rank, ms/step of both, all-reduces per step and their bytes; (b) ``cli.train`` with ``--coordinator
     127.0.0.1:<port> --num_processes 1 --process_id 0`` (NCCL at world
     size 1) against the same command without them, 10 steps: losses
     within 5e-3, ``metrics.jsonl`` written, the checkpoint scored by
     ``cli.evaluate``; (c) tensor parallelism, two gloo ranks with a model
     axis of 2, 5 steps: losses within 5e-3 of (a)'s one process, each rank
     holding half of every ``s5b*.c1`` (C_out) and ``s5b*.c2`` (C_in), the
     gathered checkpoint loaded by one process, all-reduces per step; (d) two NCCL ranks asked to
     share the card refuse, naming it;
 35. sharded serving and evaluation and semseg's spatial sharding on the
     one card, two gloo ranks sharing it, cuDNN deterministic as in 34:
     (a) config B, a batch of 8 planar YUV420 images padded to 768², over
     a data axis of 2 (``InferencePipeline(mesh=)``), fp with BN folded and
     ``w8a8_fused_chain``: each rank's results match one process's on the
     same 8 inputs (the CPU tests' tie-robust matching), 24 K2 launches
     per rank per call, ms per batch-8 call of both; (b) the same over a
     model axis of 2, the stage-5 convs served split (fp, BN folded):
     matched to one process's; (c) ``cli.train --coordinator`` over two
     gloo ranks resumes phase 8's step-40 run for 4 flagship steps with an
     eval every 2 on every rank: the step-44 ``val_*`` (mAP above 0) equal
     ``cli.evaluate``'s in one process on the checkpoint, each image in a
     batch of the same 8 rows as on its rank (cuDNN rounds batches of 16
     otherwise: that score printed beside), ``eval_seconds`` beside the
     same resume in one process, K1 launches per rank; (d) ``cli.evaluate``
     and ``cli.infer`` of the step-44 checkpoint and ``cli.infer`` of its
     ``w8a8_fused_chain`` RGB export over two ranks (the three pairs at
     once), batched as in (c):
     rank 0's JSON and JSONL byte-equal to one process's, 48 K2 launches
     per rank through the artifact; (e)
     semseg config A (256x640) with ``spatial_shard`` over a model axis of
     2: logits at batch 1 and 8 within bf16 rounding of the unsharded
     model's, one training step's loss (5e-3) and gradient norm (2e-2) the
     unsharded step's. One launch of the two ranks runs (a), (b) and (e).
 36. whole-host training on the one card, cuDNN deterministic as in 34,
     the local launcher run as ``tests/torch_dist_child.py``'s ``local``
     mode (``cli.train``'s own ``launch_local``, its ranks the child's
     ``cli`` mode, which counts their launches): (a) ``cli.train`` config
     B without process flags runs in this process (10 K1 launches, no
     launcher call); with ``--num_processes 2 --backend gloo`` and no
     ``--coordinator`` its two local ranks write the hand-launched
     ``--coordinator`` pair's ``metrics.jsonl`` (every value but the
     clock), 10 K1 launches per rank, the two pairs at once; (b)
     ``--auto_restart 1`` over two local ranks (run beside (d) and (e)),
     rank 1's device asleep in step 4: a watchdog exits for
     the restart, the launcher starts both again, they resume from step 2
     and reach step 12; the seconds from the stall to the exit and from the
     exit to the relaunched ranks' first step; (c) config B, 30 steps of
     ``Trainer.fit`` with a save every 5 steps, asynchronous, each
     waited for at once, and none: host ms of the steps after a save and
     of the others, the pinned MiB; a resume from the step-10 save ends at
     the straight run's step-30 loss exactly; (d) QAT on a model axis of 2
     against one process, 5 steps: losses within 5e-3, the ranks' scales
     equal, step 1's ``s5b*.c2`` scales the one process's (weights exactly,
     activations within 1e-2); (e) ``cli.evaluate --quantize
     w8a8_fused_chain`` of phase 8's step-40 checkpoint over two local
     ranks: metrics equal to one process calibrated alike and predicting
     the same 8-row halves, 48 K2 launches per rank.

Device times come from CUDA events around 20 back-to-back calls while the
card first sleeps through the host's enqueueing (``cuda_ms``). Any failure
raises (exit code != 0). The last two lines are the kernels' JSON record
(with each kernel's launches on the main path, bound and library time) and
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 before
printing any result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

B = 8
PAD_HW = (768, 768)
KERNEL_SOURCE = "cvm_tpu_torch/csrc/fused_qconv.cu"
KERNEL_REPLACES = "cvm_tpu/ops/pallas/fused_qconv.py:150"
SPLAT_SOURCE = "cvm_tpu_torch/csrc/gaussian_splat.cu"
SPLAT_REPLACES = "cvm_tpu/ops/pallas/gaussian_splat.py:60"
EPILOGUE_SOURCE = "cvm_tpu_torch/csrc/conv_epilogue.cu"
LETTERBOX_SOURCE = "cvm_tpu_torch/csrc/yuv_letterbox.cu"
# Phase 6b: the benchmark's fp cells (cvbench/configs, cvbench/traffic) and a seed.
EPILOGUE_CELLS = {"centernet_b": "closed_loop_coco_b8", "semseg_a": "closed_loop_camera"}
EPILOGUE_SEED = 2147490011
HBM_BYTES_PER_S = 3.35e12
# The flagship training recipe (scripts/flagship_persist.sh) at 30 + 10
# steps, with a short warmup so the loss visibly falls within them.
TRAIN_FLAGS = ["--model", "centernet", "--data", "synthetic", "--pad_hw", "512,512",
               "--checkpoint_every", "20", "--log_every", "1", "--num_classes", "10",
               "--max_objects", "16", "--batch_size", "16", "--warmup_steps", "5",
               "--total_steps", "5000", "--seed", "0", "--device", "cuda"]

# Phases 10-11: evals during training, then cli.evaluate on that workdir.
EVAL_TRAIN_FLAGS = ["--steps", "20", "--eval_every", "10", "--eval_batches", "2",
                    "--keep_best", "mAP", "--early_stop", "1"]
EVAL_FLAGS = ["--model", "centernet", "--pad_hw", "512,512", "--batches", "2",
              "--calib_batches", "1", "--device", "cuda"]
EVAL_POSTURES = {"fp": [], "fold_bn": ["--fold_bn"],
                 "w8a8_fused_chain": ["--quantize", "w8a8_fused_chain"],
                 "tta hflip": ["--tta", "hflip"]}

# The 24 fused_qconv calls of one config-B int8 forward (B = 8, all 3x3):
# (name, H, W, Cin, Cout, input, output, act, calls per forward).
MAIN_CALLS = [
    ("stem", 256, 256, 12, 32, "bf16", "bf16", "silu", 1),
    ("s2 c1", 128, 128, 64, 64, "bf16", "int8", "silu", 1),
    ("s2 c2", 128, 128, 64, 64, "int8", "bf16", None, 1),
    ("s3 c1", 64, 64, 128, 128, "bf16", "int8", "silu", 2),
    ("s3 c2", 64, 64, 128, 128, "int8", "bf16", None, 2),
    ("s4 c1", 32, 32, 256, 256, "bf16", "int8", "silu", 2),
    ("s4 c2", 32, 32, 256, 256, "int8", "bf16", None, 2),
    ("s5 c1", 16, 16, 512, 512, "bf16", "int8", "silu", 2),
    ("s5 c2", 16, 16, 512, 512, "int8", "bf16", None, 2),
    ("up0 c1", 32, 32, 768, 128, "bf16", "bf16", "silu", 1),
    ("up0 c2", 32, 32, 128, 128, "bf16", "bf16", "silu", 1),
    ("up1 c1", 64, 64, 256, 128, "bf16", "bf16", "silu", 1),
    ("up1 c2", 64, 64, 128, 128, "bf16", "bf16", "silu", 1),
    ("up2 c1", 128, 128, 192, 128, "bf16", "bf16", "silu", 1),
    ("up2 c2", 128, 128, 128, 128, "bf16", "bf16", "silu", 1),
    ("head c1", 128, 128, 128, 64, "bf16", "bf16", "silu", 3),
]
# (k, B, H, W, Cin, Cout, act) of tests/test_fused_qconv.py: 1x1, W not a
# multiple of the tile, Cout > 128, narrow Cin with wide W, W = 1; then the
# card tests' ragged Cin / Cout, and one case per special path of the
# kernel: the folded stem, the Cin split over a cluster, Cout 512, W ragged.
TEST_SHAPES = [
    (1, 2, 8, 16, 32, 64, "silu"),
    (3, 2, 16, 20, 32, 64, "silu"),
    (3, 1, 32, 48, 16, 256, None),
    (3, 1, 8, 96, 8, 32, "relu"),
    (3, 2, 2, 1, 16, 32, "relu"),
    (3, 2, 9, 13, 12, 24, "silu"),
    (1, 1, 5, 7, 40, 72, None),
    (3, 2, 40, 24, 12, 32, "silu"),
    (3, 1, 16, 16, 256, 128, None),
    (3, 1, 16, 24, 64, 512, "relu"),
    (3, 3, 19, 29, 96, 96, "silu"),
]
# The card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# int8 tensor-core operations and HBM3 bytes per second.
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
_ESIZE = {"f32": 4, "bf16": 2, "int8": 1}
# mode -> (input, output)
MODES = {"f32->f32": ("f32", "f32"), "bf16->bf16": ("bf16", "bf16"),
         "int8->bf16": ("int8", "bf16"), "bf16->int8": ("bf16", "int8")}
_KIND = {"torch.float32": "f32", "torch.bfloat16": "bf16", "torch.int8": "int8"}

# Phase 16: the postures cli.export writes, each with its eager twin's
# InferencePipeline flags.
EXPORT_POSTURES = {"none": dict(fold_bn=True), "int8": {}, "w8a8": {},
                   "w8a8_fused": dict(w8a8_fused=True),
                   "w8a8_fused_chain": dict(w8a8_fused=True, w8a8_chain=True)}
# Phase 17: the QAT fine-tune of phase 8's run, 20 more steps, 2 evals.
QAT_FLAGS = ["--qat", "true", "--steps", "60", "--eval_every", "10", "--eval_batches", "1"]

# The dense zoo's serving paths: (path, model, batch, K2 launches per int8
# forward). Config A is semseg at batch 1.
DENSE_PATHS = [("semseg", "semseg", 8, 24), ("semseg b1", "semseg", 1, 24),
               ("depth", "depth", 8, 27), ("multitask", "multitask", 8, 28)]
DENSE_PAD = (384, 960)  # the loaders' default: 1.5x the 256x640 input
# Phases 18-20: config B with the monocular 3D heads (27 K2 calls per int8
# forward: config B's 24 and one per 3D head), trained on the flagship
# recipe with --with_3d true, then exported.
THREE_D_K2 = 27
TRAIN3D_FLAGS = ["--with_3d", "true", "--steps", "20", "--eval_every", "10",
                 "--eval_batches", "2"]
# Phase 21: DMDS, config E at its defaults (192x640, batch 8).
DMDS_TRAIN_FLAGS = ["--model", "dmds", "--data", "synthetic", "--batch_size", "8",
                    "--warmup_steps", "5", "--log_every", "1", "--checkpoint_every", "20",
                    "--seed", "0", "--steps", "20", "--eval_every", "20", "--eval_batches", "2",
                    "--device", "cuda"]
DENSE_TRAIN_FLAGS = ["--data", "synthetic", "--batch_size", "8", "--warmup_steps", "5",
                     "--log_every", "1", "--checkpoint_every", "1000", "--seed", "0",
                     "--steps", "20", "--device", "cuda"]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3, rounds: int = 3) -> float:
    """Device time of one ``fn()``: CUDA events around ``reps`` calls, the
    median over ``rounds``. The card first sleeps for longer than the host
    takes to enqueue the calls, so the events time the device's work back
    to back, not the host's launch overhead (which exceeds a small
    kernel's time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # _sleep counts SM cycles (~2 GHz); 1.5x the enqueue time, at most 0.5 s.
    sleep_cycles = int(min(0.5, 1.5 * reps * host_s + 2e-4) * 2.0e9)
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


# conv_epilogue's launches on each fp fold_bn path the smoke runs in this
# process, read from the kernel's own counter (``epilogue_launches``).
EPILOGUE_PATHS = {}
HOST_MS_CALLS = 23  # host_ms's default 3 warm-up and 20 timed calls
DMDS_PASSES = 2  # a DMDS call runs its depth net on both frames, its motion net both ways


def epilogue_launches(path: str, folded, forwards: int, fn):
    """``fn()``, which runs ``forwards`` passes of every conv of a pipeline
    whose ``folded_counts`` is ``folded`` (None: no folded module), with
    conv_epilogue's launch counter set to 0 first; the count must be
    ``folded["fused"]`` per pass, replays included. Recorded under
    ``path`` in ``EPILOGUE_PATHS``; returns ``fn()``'s result."""
    import torch

    from cvm_tpu_torch.ops.cuda import conv_epilogue as ce

    want = (folded["fused"] if folded else 0) * forwards
    ce.conv_epilogue.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = ce.conv_epilogue.launches
    if got != want:
        raise AssertionError(f"{path}: {got} conv_epilogue launches in {forwards} forwards, "
                             f"expected {want} (folded {folded})")
    EPILOGUE_PATHS[path] = dict(launches=got, forwards=forwards)
    return out


# yuv_letterbox's launches on each CUDA YUV420 eval path the smoke runs, in
# this process (``letterbox_launches``) and in phase 35's ranks, read from
# the kernel's own counter.
LETTERBOX_PATHS = {}


def letterbox_launches(path: str, calls: int, fn):
    """``fn()``, which runs ``calls`` eval preprocesses of YUV420 planes on
    the card, with yuv_letterbox's launch counter set to 0 first; the count
    must be ``calls``, replays included. Recorded under ``path`` in
    ``LETTERBOX_PATHS``; returns ``fn()``'s result."""
    import torch

    from cvm_tpu_torch.ops.cuda import yuv_letterbox as yl

    yl.yuv_letterbox.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = yl.yuv_letterbox.launches
    if got != calls:
        raise AssertionError(f"{path}: {got} yuv_letterbox launches, expected {calls}")
    LETTERBOX_PATHS[path] = dict(launches=got, calls=calls)
    return out


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median host-clock time of ``fn()`` ending in a device synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                           "torch_records")


def fixture_jpegs():
    """The committed fixture's JPEG bytes and metas
    (``scripts/make_torch_record_fixture.py``)."""
    from cvm_tpu_torch.data.records import RecordDataset

    ds = RecordDataset([os.path.join(FIXTURE_DIR, "scenes.cvrec")])
    recs = [ds.get(i) for i in range(len(ds))]
    return [b["jpeg"] for _, b in recs], [m for m, _ in recs]


# (source layout, luma sampling byte) -> (target luma sampling byte, MCU
# width, MCU height of the target). "1x4": luma sampled 1 across and 4
# down, chroma at full width and a quarter of the height.
_RELAYOUT = {"4:4:0": (0x21, 0x12, 8, 16), "4:1:1": (0x22, 0x41, 32, 8),
             "1x4": (0x22, 0x14, 8, 32)}


def relayout_jpeg(jpeg: bytes, layout: str) -> bytes:
    """A baseline JPEG of ``layout`` ("4:4:0", "4:1:1" or "1x4"), which no
    encoder at hand writes, from a baseline 4:2:2 (for 4:4:0) or 4:2:0 (for
    the others) one: the luma's sampling factors are re-declared (each MCU
    keeps its 4 or 6 blocks in their order) and the frame is re-cut to the
    same grid of MCUs, one pixel short of it each way, so that its height
    and width are odd. Each MCU's luma blocks come out stacked (4:4:0, 1x4)
    or in a row (4:1:1) instead of side by side."""
    import struct

    source, target, mcu_w, mcu_h = _RELAYOUT[layout]
    data = bytearray(jpeg)
    at = data.index(b"\xff\xc0")
    h, w = struct.unpack_from(">HH", data, at + 5)
    if data[at + 9] != 3 or data[at + 11] != source:
        raise ValueError(f"{layout} is made from a 3-component JPEG whose luma sampling "
                         f"byte is {source:#x}, got {data[at + 9]} components, "
                         f"{data[at + 11]:#x}")
    src_w, src_h = (16, 8) if source == 0x21 else (16, 16)
    nx, ny = -(-w // src_w), -(-h // src_h)
    struct.pack_into(">HH", data, at + 5, ny * mcu_h - 1, nx * mcu_w - 1)
    data[at + 11] = target
    return bytes(data)


def _huffman_table(symbols, length):
    """Codes of one length for every symbol (a legal, if not a small, JPEG
    Huffman table): {symbol: (code, length)} and its DHT counts."""
    counts = [0] * 16
    counts[length - 1] = len(symbols)
    return {s: (i, length) for i, s in enumerate(symbols)}, counts


def encode_jpeg(rgb: np.ndarray, factors, quality: int = 90) -> bytes:
    """A baseline JFIF (YCbCr) JPEG of the (H, W, 3) uint8 frame ``rgb`` with
    the components' sampling factors ``factors`` ((h, v) of Y, Cb, Cr; e.g.
    ((4, 2), (1, 1), (1, 1)) for 4:1:0), which no encoder at hand writes:
    JFIF's YCbCr, each chroma plane the rounded mean of its source pixels,
    a float DCT, the standard luminance table scaled to ``quality`` for
    every component, and Huffman tables of one code length."""
    import struct

    p = rgb.astype(np.float64)
    ycc = np.stack([0.299 * p[..., 0] + 0.587 * p[..., 1] + 0.114 * p[..., 2],
                    -0.168736 * p[..., 0] - 0.331264 * p[..., 1] + 0.5 * p[..., 2] + 128,
                    0.5 * p[..., 0] - 0.418688 * p[..., 1] - 0.081312 * p[..., 2] + 128], 0)
    H, W = rgb.shape[:2]
    mh, mv = max(f[0] for f in factors), max(f[1] for f in factors)
    mcu_x, mcu_y = -(-W // (8 * mh)), -(-H // (8 * mv))
    luma = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13,
                     16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56,
                     68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103,
                     121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    q = np.clip((luma * scale + 50) // 100, 1, 255)
    zz = sorted(((i, j) for i in range(8) for j in range(8)),
                key=lambda t: (t[0] + t[1], t[0] if (t[0] + t[1]) % 2 else -t[0]))
    zi, zj = np.array([t[0] for t in zz]), np.array([t[1] for t in zz])
    k = np.arange(8)
    dct = np.sqrt(np.where(k == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
        (2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    dc_codes, dc_counts = _huffman_table(list(range(12)), 4)
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    ac_codes, ac_counts = _huffman_table(ac_syms, 8)
    planes = []
    for c, (h, v) in enumerate(factors):
        # the component's plane, then padded to whole MCUs by replication
        ph, pw = -(-H * v // mv), -(-W * h // mh)
        fy, fx = mv // v, mh // h
        src = np.pad(ycc[c], ((0, ph * fy - H), (0, pw * fx - W)), mode="edge")
        plane = src.reshape(ph, fy, pw, fx).mean((1, 3))
        plane = np.pad(plane, ((0, mcu_y * v * 8 - ph), (0, mcu_x * h * 8 - pw)), mode="edge")
        planes.append(plane - 128.0)
    bits = []
    out = bytearray()

    def put(code, length):
        for b in range(length - 1, -1, -1):
            bits.append((code >> b) & 1)

    def put_value(v):
        size = int(abs(v)).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    pred = [0] * len(factors)
    for my in range(mcu_y):
        for mx in range(mcu_x):
            for c, (h, v) in enumerate(factors):
                for by in range(v):
                    for bx in range(h):
                        y0, x0 = (my * v + by) * 8, (mx * h + bx) * 8
                        co = dct @ planes[c][y0:y0 + 8, x0:x0 + 8] @ dct.T
                        z = np.round(co / q).astype(int)[zi, zj]
                        size, bitsv = put_value(int(z[0]) - pred[c])
                        pred[c] = int(z[0])
                        put(*dc_codes[size])
                        put(bitsv, size)
                        run = 0
                        last = max([i for i in range(1, 64) if z[i]], default=0)
                        for i in range(1, last + 1):
                            if z[i] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac_codes[0xF0])
                                run -= 16
                            size, bitsv = put_value(int(z[i]))
                            put(*ac_codes[(run << 4) | size])
                            put(bitsv, size)
                            run = 0
                        if last < 63:
                            put(*ac_codes[0x00])
    bits.extend([1] * (-len(bits) % 8))
    for i in range(0, len(bits), 8):
        byte = int("".join(map(str, bits[i:i + 8])), 2)
        out.append(byte)
        if byte == 0xFF:
            out.append(0)

    def seg(marker, body):
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    nc = len(factors)
    head = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    head += seg(0xDB, bytes([0]) + bytes(int(q[i, j]) for i, j in zz))
    head += seg(0xC0, struct.pack(">BHHB", 8, H, W, nc) + b"".join(
        bytes([c + 1, (h << 4) | v, 0]) for c, (h, v) in enumerate(factors)))
    head += seg(0xC4, bytes([0x00] + dc_counts) + bytes(range(12)))
    head += seg(0xC4, bytes([0x10] + ac_counts) + bytes(ac_syms))
    head += seg(0xDA, bytes([nc]) + b"".join(bytes([c + 1, 0x00]) for c in range(nc))
                + bytes([0, 63, 0]))
    return head + bytes(out) + b"\xff\xd9"


# What IDCT rounding alone can do to a frame decoded at full scale by
# another decoder than libjpeg: one step per plane sample, which libjpeg's
# YCbCr tables turn into at most 3 per RGB channel (1 from Y, at most 2 from
# each fixed-point chroma term), on a few samples in a hundred.
IDCT_GAP = {"rgb": {"mean_abs": 0.1, "max_abs": 3}, "yuv420": {"mean_abs": 0.1, "max_abs": 1}}


def fixture_decode_check(device, num_threads: int = 4) -> dict:
    """Decode the fixture's JPEGs on ``device`` and hold them against the
    reference decoder's (libjpeg) output recorded in the fixture, in RGB and
    YUV420 at the 768^2 pad, with and without its target_hw. Every ``hw``
    must equal the reference's. The CPU's decoder is libjpeg, so its
    buffers must hash identically. Another decoder (nvJPEG on a card) is
    held frame by frame, over the valid pixels: a frame decoded at full
    scale to ``IDCT_GAP``; a frame decoded at a reduced scale to the gap
    between the reference's own two decoders (its PIL fallback against
    libjpeg) on that frame, mean and max |d|. Raises on failure; returns
    the per-frame gaps."""
    import hashlib
    import lzma

    import torch

    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420

    with open(os.path.join(FIXTURE_DIR, "manifest.json")) as f:
        man = json.load(f)
    jpegs, metas = fixture_jpegs()
    pad, exact = tuple(man["pad_hw"]), torch.device(device).type == "cpu"
    refs = {}
    for fmt in ("rgb", "yuv420"):
        with open(os.path.join(FIXTURE_DIR, f"decoded_{fmt}.xz"), "rb") as f:
            refs[fmt] = np.frombuffer(lzma.decompress(f.read()), np.uint8)
    result = {"case": "a (identical)" if exact else "b (frame by frame within the bounds)"}
    for tag, target in (("no_target", (0, 0)), ("target", tuple(man["target_hw"]))):
        for fmt in ("rgb", "yuv420"):
            want = man["decoded"][tag][fmt]
            if fmt == "rgb":
                out, hw = decode_jpeg_batch(jpegs, *pad, num_threads, target_hw=target,
                                            device=device)
                frames = [out[i] for i in range(len(jpegs))]
                valid = [out[i, :h, :w].ravel() for i, (h, w) in enumerate(hw)]
            else:
                Y, U, V, hw = decode_jpeg_batch_yuv420(jpegs, *pad, num_threads,
                                                       target_hw=target, device=device)
                frames = [np.concatenate([Y[i].ravel(), U[i].ravel(), V[i].ravel()])
                          for i in range(len(jpegs))]
                valid = [np.concatenate([Y[i, :h, :w].ravel(),
                                         U[i, :(h + 1) // 2, :(w + 1) // 2].ravel(),
                                         V[i, :(h + 1) // 2, :(w + 1) // 2].ravel()])
                         for i, (h, w) in enumerate(hw)]
            if hw.tolist() != want["hw"]:
                raise AssertionError(f"{tag} {fmt}: hw {hw.tolist()} != reference {want['hw']}")
            same = [hashlib.sha256(fr.tobytes()).hexdigest() == h
                    for fr, h in zip(frames, want["sha256"])]
            entry = {"identical_frames": int(sum(same))}
            if exact:
                if not all(same):
                    raise AssertionError(f"{tag} {fmt}: {len(same) - sum(same)} frames differ "
                                         "from the reference decoder's")
                result[f"{tag} {fmt}"] = entry
                continue
            if want["sha256"] != man["decoded"]["no_target"][fmt]["sha256"]:
                raise AssertionError(f"{tag} {fmt}: no recorded pixels to compare with")
            # the reference decoded these frames as without the target, so
            # its recorded pixels are the ones to compare with
            ref = np.split(refs[fmt], np.cumsum([v.size for v in valid])[:-1])
            entry.update(mean_abs=[], max_abs=[], bound=[])
            for i, (v, r) in enumerate(zip(valid, ref)):
                d = np.abs(v.astype(np.int16) - r)
                full = tuple(hw[i]) == (metas[i]["height"], metas[i]["width"])
                bound = IDCT_GAP[fmt] if full else man["fallback_gap"][fmt]["per_frame"][i]
                entry["mean_abs"].append(float(d.mean()))
                entry["max_abs"].append(int(d.max()))
                entry["bound"].append("idct" if full else "fallback")
                if not (d.mean() <= bound["mean_abs"] and d.max() <= bound["max_abs"]):
                    raise AssertionError(
                        f"{tag} {fmt} frame {i} ({'full' if full else 'reduced'} scale): "
                        f"decode gap mean {float(d.mean())} max {int(d.max())} exceeds {bound}")
            result[f"{tag} {fmt}"] = entry
    return result


def compare(got, ref):
    """(ok, max abs error, note). Tolerances by output type: f32 1e-4
    (both sums are exact, the kernel's in int32 and the plain version's in
    f64; only the f32 epilogue may round differently); bf16 one bf16 step
    (2^-7 relative); int8 one lattice step on at most 0.1% of outputs."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False, float("inf"), f"dtype/shape {got.dtype}{tuple(got.shape)} vs {ref.dtype}{tuple(ref.shape)}"
    if got.dtype == torch.int8:
        d = (got.int() - ref.int()).abs()
        frac = float((d > 0).float().mean())
        return int(d.max()) <= 1 and frac <= 1e-3, float(d.max()), f"lattice diff frac {frac:.2e}"
    g, r = got.float(), ref.float()
    err = float((g - r).abs().max())
    if got.dtype == torch.bfloat16:
        ok = bool(((g - r).abs() <= 2 ** -7 * r.abs() + 1e-5).all())
    else:
        ok = bool(((g - r).abs() <= 1e-4 * r.abs() + 1e-4).all())
    return ok, err, ""


def kernel_case(dev, gen, k, b, h, w, cin, cout, act, x_kind, out_kind):
    """Inputs for one fused_qconv call whose output is O(1)."""
    import torch

    if x_kind == "int8":
        x = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=dev, dtype=torch.int8)
        inv_sx = None
    else:
        x = torch.randn(b, h, w, cin, generator=gen, device=dev)
        x = x.to(torch.bfloat16) if x_kind == "bf16" else x
        inv_sx = 127.0 / 3.0
    wq = torch.randint(-127, 128, (k, k, cin, cout), generator=gen, device=dev, dtype=torch.int8)
    acc_std = (k * k * cin) ** 0.5 * 42.0 * 73.0
    scale = torch.rand(cout, generator=gen, device=dev) / acc_std + 0.5 / acc_std
    bias = 0.1 * torch.randn(cout, generator=gen, device=dev)
    out_dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[out_kind]
    kw = dict(inv_sx=inv_sx, act=act, out_dtype=out_dtype,
              inv_s_out=127.0 / 4.0 if out_kind == "int8" else None)
    return (x, wq, scale, bias), kw


def phase_kernels(dev, dense_calls):
    """K2 against its plain version, then its times. ``dense_calls`` maps
    each dense path to the K2 calls of one int8 forward, as recorded by
    ``record_k2_calls``."""
    import torch

    from cvm_tpu_torch.ops.cuda.fused_qconv import fused_qconv, fused_qconv_reference

    gen = torch.Generator(device=dev).manual_seed(1)
    shapes = []
    for name, h, w, cin, cout, _, _, act, _ in MAIN_CALLS:
        key = (3, B, h, w, cin, cout)
        if key not in [s[1:7] for s in shapes]:
            shapes.append((name.split()[0], *key, act))
    shapes += [(f"test{i}", *s) for i, s in enumerate(TEST_SHAPES)]
    # Batch 16 (phase 11's int8 eval): the folded stem, and s5 / up0 whose
    # Cin batch 8 splits over a cluster and batch 16 does not.
    shapes += [("b16 stem", 3, 16, 256, 256, 12, 32, "silu"),
               ("b16 s5", 3, 16, 16, 16, 512, 512, "silu"),
               ("b16 up0", 3, 16, 32, 32, 768, 128, "silu")]
    # Every distinct shape of the dense models' int8 forwards (256x640:
    # ragged 8x20 maps at stride 32, batch 1 with its 4-way Cin split, the
    # concatenated Cin 160 / 320 of the decoders).
    seen = {s[1:] for s in shapes}
    for path, calls in dense_calls.items():
        for c in calls:
            key = (c["k"], c["B"], c["H"], c["W"], c["cin"], c["cout"], c["act"])
            if key not in seen:
                seen.add(key)
                shapes.append((path.replace(" ", "-"), *key))
    log("[kernel] tolerance vs plain: f32 out |d| <= 1e-4*|ref| + 1e-4; bf16 out "
        "|d| <= 2^-7*|ref| + 1e-5; int8 out |d| <= 1 lattice step on <= 0.1% of outputs")
    worst, failures = 0.0, []
    for name, k, b, h, w, cin, cout, act in shapes:
        notes = []
        for mode, (xk, ok_) in MODES.items():
            args, kw = kernel_case(dev, gen, k, b, h, w, cin, cout, act, xk, ok_)
            got = fused_qconv(*args, **kw)
            torch.cuda.synchronize()
            ok, err, note = compare(got, fused_qconv_reference(*args, **kw))
            if ok_ != "int8":
                worst = max(worst, err)
            notes.append(f"{mode} {'ok' if ok else 'FAIL'} err={err:.3g}{' ' + note if note else ''}")
            if not ok:
                failures.append(f"{name} {mode}: {err} {note}")
        log(f"[kernel] {name:7s} k{k} B{b} {h}x{w} {cin}->{cout} act={act}: " + "; ".join(notes))
    if failures:
        raise AssertionError(f"kernel disagrees with its plain version: {failures}")

    # Times at the main path's shapes and modes: the kernel (weights packed
    # once, as the modules do), its bound, the plain version, and the
    # library yardstick: cuDNN's bf16 conv of the same shape on
    # channels_last tensors (timed here only; the port never calls it).
    import torch.nn.functional as F

    from cvm_tpu_torch.ops.cuda.fused_qconv import cin_split, pack_qconv_weights, qconv_plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "ops_bound": 0.0}
    per_call = {}
    log(f"[kernel-time] bound = max(int8 ops / {PEAK_INT8_OPS / 1e12:.0f} TOP/s, bytes / "
        f"{PEAK_BYTES / 1e12:.2f} TB/s); bytes = input + weights + scale/bias + output, each once")
    for name, h, w, cin, cout, xk, ok_, act, n in MAIN_CALLS:
        args, kw = kernel_case(dev, gen, 3, B, h, w, cin, cout, act, xk, ok_)
        wp = pack_qconv_weights(args[1])
        t_k = cuda_ms(lambda: fused_qconv(*args, **kw, w_packed=wp))
        t_p = cuda_ms(lambda: fused_qconv_reference(*args, **kw))
        xb = torch.randn(B, cin, h, w, generator=gen, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        wb = torch.randn(cout, cin, 3, 3, generator=gen, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        t_l = cuda_ms(lambda: F.conv2d(xb, wb, padding=1))
        ops = 2.0 * B * h * w * 9 * cin * cout
        nbytes = (B * h * w * (cin * _ESIZE[xk] + cout * _ESIZE[ok_]) + 9 * cin * cout
                  + 8 * cout)
        t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        plan = qconv_plan(3, cin, cout)
        path = ("fold" if plan.fold else f"split {cin_split(plan, B, h, w, sms)}") + \
            f", bn {plan.bn}"
        log(f"[kernel-time] {name:8s} {h}x{w} {cin}->{cout} {xk}->{ok_} x{n} ({path}): kernel "
            f"{t_k:.4f} ms ({ops / t_k / 1e9:.1f} TOP/s), bound {bound * 1e3:.1f} us "
            f"({'ops' if t_ops >= t_bytes else 'bytes'}; {bound / t_k:.1%} of it), "
            f"cuDNN bf16 {t_l:.4f} ms, plain {t_p:.4f} ms")
        per_call[name] = dict(ms=t_k, plain=t_p, lib=t_l, bound=bound)
        tot["ms"] += n * t_k
        tot["plain"] += n * t_p
        tot["lib"] += n * t_l
        tot["bound"] += n * bound
        tot["ops_bound"] += n * bound * (t_ops >= t_bytes)
    tot["bound_by"] = "operations" if tot["ops_bound"] >= tot["bound"] / 2 else "bytes"
    log(f"[kernel-time] one config-B int8 forward's 24 calls: kernel {tot['ms']:.3f} ms, "
        f"bound {tot['bound']:.3f} ms ({tot['bound'] / tot['ms']:.1%} of it; "
        f"{tot['ops_bound']:.3f} ms of it ops-bound), cuDNN bf16 {tot['lib']:.3f} ms, "
        f"plain {tot['plain']:.3f} ms")
    # The 3D model's forward: config B's 24 calls and one "head c1" per 3D
    # head (the same 3x3 128 -> 64 shape as config B's own heads).
    tot["3d"] = {k: tot[k] + 3 * per_call["head c1"][k] for k in ("ms", "plain", "lib", "bound")}
    log(f"[kernel-time] one 3D config-B int8 forward's 27 calls: kernel {tot['3d']['ms']:.3f} "
        f"ms, bound {tot['3d']['bound']:.3f} ms, cuDNN bf16 {tot['3d']['lib']:.3f} ms, plain "
        f"{tot['3d']['plain']:.3f} ms")
    return worst, tot, dense_kernel_times(dev, gen, dense_calls, sms)


def dense_kernel_times(dev, gen, dense_calls, sms):
    """Per distinct dense call (in its main-path mode): the kernel, its
    bound, cuDNN's bf16 conv and the plain version (fewer repeats: at
    these shapes its f64 conv takes milliseconds); then each path's sum
    over one int8 forward."""
    import torch
    import torch.nn.functional as F

    from cvm_tpu_torch.ops.cuda.fused_qconv import (cin_split, fused_qconv,
                                                    fused_qconv_reference, pack_qconv_weights,
                                                    qconv_plan)

    times = {}
    for calls in dense_calls.values():
        for c in calls:
            key = (c["k"], c["B"], c["H"], c["W"], c["cin"], c["cout"], c["x"], c["out"],
                   c["act"])
            if key in times:
                continue
            k, b, h, w, cin, cout, xk, ok_, act = key
            args, kw = kernel_case(dev, gen, k, b, h, w, cin, cout, act, xk, ok_)
            wp = pack_qconv_weights(args[1])
            t_k = cuda_ms(lambda: fused_qconv(*args, **kw, w_packed=wp))
            t_p = cuda_ms(lambda: fused_qconv_reference(*args, **kw), reps=3, warmup=1,
                          rounds=1)
            xb = torch.randn(b, cin, h, w, generator=gen, device=dev).to(
                torch.bfloat16, memory_format=torch.channels_last)
            wb = torch.randn(cout, cin, k, k, generator=gen, device=dev).to(
                torch.bfloat16, memory_format=torch.channels_last)
            t_l = cuda_ms(lambda: F.conv2d(xb, wb, padding=k // 2))
            ops = 2.0 * b * h * w * k * k * cin * cout
            nbytes = (b * h * w * (cin * _ESIZE[xk] + cout * _ESIZE[ok_]) + k * k * cin * cout
                      + 8 * cout)
            t_ops, t_bytes = ops / PEAK_INT8_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(t_ops, t_bytes)
            plan = qconv_plan(k, cin, cout)
            path = ("fold" if plan.fold else f"split {cin_split(plan, b, h, w, sms)}") + \
                f", bn {plan.bn}"
            times[key] = dict(ms=t_k, plain=t_p, lib=t_l, bound=bound,
                              ops_bound=bound if t_ops >= t_bytes else 0.0)
            log(f"[kernel-time] dense B{b} {h}x{w} {cin}->{cout} {xk}->{ok_} act={act} ({path}): "
                f"kernel {t_k:.4f} ms ({ops / t_k / 1e9:.1f} TOP/s), bound {bound * 1e3:.1f} us "
                f"({'ops' if t_ops >= t_bytes else 'bytes'}; {bound / t_k:.1%} of it), cuDNN "
                f"bf16 {t_l:.4f} ms, plain {t_p:.4f} ms")
    per_path = {}
    for path, calls in dense_calls.items():
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0, "ops_bound": 0.0}
        for c in calls:
            t = times[(c["k"], c["B"], c["H"], c["W"], c["cin"], c["cout"], c["x"], c["out"],
                       c["act"])]
            for k in tot:
                tot[k] += t[k]
        tot["calls"] = len(calls)
        per_path[path] = tot
        log(f"[kernel-time] one {path} int8 forward's {len(calls)} calls: kernel "
            f"{tot['ms']:.3f} ms, bound {tot['bound']:.3f} ms ({tot['bound'] / tot['ms']:.1%} of "
            f"it; {tot['ops_bound']:.3f} ms of it ops-bound), cuDNN bf16 {tot['lib']:.3f} ms, "
            f"plain {tot['plain']:.3f} ms")
    return per_path


def build_model(dev, with_3d=False):
    """Config B (with the monocular 3D heads when ``with_3d``) with seeded
    weights and non-trivial BN statistics."""
    import torch

    from cvm_tpu_torch.models.centernet.model import create_model
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.models.layers import BatchNorm

    cfg = CenternetParams(with_3d=with_3d)
    gen = torch.Generator().manual_seed(0)
    model = create_model(cfg, "cpu", gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return cfg, model.to(dev).eval()


def build_dense(name, batch_size, dev):
    """A dense model of the zoo at its full width (256x640, ``small``),
    seeded weights and non-trivial BN statistics."""
    import torch

    from cvm_tpu_torch.models.layers import BatchNorm
    from cvm_tpu_torch.models.registry import get_model

    spec = get_model(name)
    cfg = spec.params_cls(batch_size=batch_size)
    gen = torch.Generator().manual_seed(0)
    model = spec.create_model(cfg, "cpu", gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return cfg, model.to(dev).eval()


def record_k2_calls(cfg, model, dev):
    """The K2 calls of one int8 forward (``w8a8_fused_chain`` with
    placeholder scales): shape, input and output type, activation."""
    import torch

    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.layers import Conv

    scales = {n: 0.05 for n, m in model.named_modules() if isinstance(m, Conv)}
    pipe = InferencePipeline(cfg, model, dev, input_format="rgb", w8a8=scales,
                             w8a8_fused=True, w8a8_chain=True)
    calls, real = [], qz.fused_qconv

    def record(x, w_q, *a, **kw):
        B, H, W, cin = x.shape
        calls.append(dict(k=w_q.shape[0], B=B, H=H, W=W, cin=cin, cout=w_q.shape[-1],
                          x=_KIND[str(x.dtype)], out=_KIND[str(kw["out_dtype"])],
                          act=kw["act"]))
        return real(x, w_q, *a, **kw)

    qz.fused_qconv = record
    try:
        with torch.no_grad():
            pipe.heads(torch.zeros(cfg.batch_size, *cfg.input_hw, 3, device=dev,
                                   dtype=torch.bfloat16))
    finally:
        qz.fused_qconv = real
    return calls


def batch_to(batch, dev):
    import torch

    return [torch.from_numpy(batch[k]).to(dev) for k in ("y", "u", "v", "image_hw")]


def splat_cases(dev):
    """(name, per-object inputs, map_hw, C) of K1 at the main path's shapes
    and at the edge cases."""
    import torch

    from cvm_tpu_torch.ops.heatmap import prepare_centers

    rng = np.random.default_rng(7)
    cases = []
    # flagship training (B16, K8 boxes, 128^2 map, 10 classes); config B
    # default (B8, K128, 128^2, 80 classes); then a non-square map, a row
    # length Ws*C not a multiple of 4 floats, no objects at all, all objects
    # invalid, rows wider than a tile (flat chunks)
    for name, (b, k, hs, ws, c) in (("flagship", (16, 8, 128, 128, 10)),
                                    ("config-B", (8, 128, 128, 128, 80)),
                                    ("multitask", (8, 128, 64, 160, 10)),
                                    ("24x40", (2, 6, 24, 40, 3)), ("ragged", (3, 7, 13, 17, 5)),
                                    ("K=0", (2, 0, 32, 32, 3)),
                                    ("all-invalid", (4, 16, 128, 128, 10)),
                                    ("wide-row", (1, 6, 8, 1024, 80))):
        x0 = rng.uniform(-8, ws, (b, k)).astype(np.float32)
        y0 = rng.uniform(-8, hs, (b, k)).astype(np.float32)
        w = rng.uniform(1, min(96, ws + 2), (b, k)).astype(np.float32)
        h = rng.uniform(1, min(96, hs + 2), (b, k)).astype(np.float32)
        boxes = np.stack([x0, y0, x0 + w, y0 + h], -1)
        valid = np.arange(k)[None] < rng.integers(0, k + 1, (b, 1))
        if name in ("24x40", "ragged", "wide-row"):
            valid = rng.uniform(size=(b, k)) < 0.8
        cls = rng.integers(0, c, (b, k))
        cases.append((name, boxes, valid & (name != "all-invalid"), cls, (hs, ws), c))
    half = rng.uniform(0.2, 4, (2, 3, 1)).astype(np.float32)   # 1x1 map, one class
    cases.append(("1x1 C1", np.concatenate([0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half], -1),
                  np.ones((2, 3), bool), np.zeros((2, 3), int), (1, 1), 1))
    edge = {  # one image, 32^2 map, 3 classes: boxes (map coords), classes
        "no-valid": ([[4, 4, 12, 12], [20, 2, 30, 9]], [0, 1]),
        "border": ([[-12, -12, 13, 13], [14, 18, 49, 45], [-10, 20, 11, 40]], [0, 1, 2]),
        "radius-0": ([[10, 10, 11.5, 11.5], [3, 20, 4, 21]], [0, 1]),
        "overlap": ([[6, 6, 22, 20], [9, 8, 25, 24]], [1, 1]),
        "class=C": ([[6, 6, 22, 20], [9, 8, 25, 24]], [3, 3]),
        # a box 40 maps wide centred in the map: its radius exceeds the map
        "radius>map": ([[-624, -624, 656, 656], [3, 20, 9, 27]], [0, 1]),
    }
    for name, (boxes, cls) in edge.items():
        valid = np.full((1, len(cls)), name != "no-valid")
        cases.append((name, np.asarray([boxes], np.float32), valid, np.asarray([cls]), (32, 32), 3))
    out = []
    for name, boxes, valid, cls, map_hw, c in cases:
        _, _, _, _, v, ix, iy, radius, sigma = prepare_centers(
            torch.from_numpy(boxes).to(dev), torch.from_numpy(valid).to(dev), map_hw, 0.7)
        cls_t = torch.from_numpy(np.asarray(cls, np.int32).reshape(valid.shape)).to(dev)
        out.append((name, (iy, ix, sigma, radius, cls_t, v), map_hw, c))
    return out


def device_kernels(fn):
    """Names of the device kernels one ``fn()`` runs (torch.profiler, CUDA
    activity), with ``fn`` run once before to build and warm it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _cell_program(cell, dev):
    """A benchmark cell's program (``cvbench``: its configuration, traffic
    mix and weights from ``EPILOGUE_SEED``): params, model and one batch of
    its frames on the host."""
    from cvbench import program
    from cvbench.runners.closed_loop_batches import stack
    from cvbench.traffic.generator import frame_pool, stream

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "cvbench", "configs", f"{cell}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "cvbench", "traffic", f"{EPILOGUE_CELLS[cell]}.json")) as f:
        mix = json.load(f)
    cfg = program.cell_config(cfg, mix)
    params, model, _ = program.build(cfg, EPILOGUE_SEED, dev)
    n = int(cfg["params"]["batch_size"])
    batch = stack(frame_pool(stream(EPILOGUE_SEED, 1), dict(mix, pool=n),
                             cfg["params"]["num_classes"]), n)[0]
    return params, model, batch


def _cell_pipelines(cell, dev):
    """A benchmark cell's program as two ``fold_bn`` pipelines, the folded
    convs' (``swap_folded``) and the old fold's (``BiasAdd``, a cast of each
    weight and bias per call), and one batch on the card."""
    import torch
    from cvm_tpu_torch.infer import fold_bn
    from cvm_tpu_torch.infer.pipeline import InferencePipeline

    params, model, batch = _cell_program(cell, dev)
    new = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=True)
    real = fold_bn.swap_folded
    fold_bn.swap_folded = lambda m: None
    try:
        old = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=True)
    finally:
        fold_bn.swap_folded = real
    return new, old, [torch.from_numpy(batch[k]).to(dev) for k in new.keys]


def _kernel_classes(fn, n: int = 10):
    """Device ms per ``fn()`` by kernel class (torch.profiler over ``n``
    calls): cuDNN's convs, the epilogue, the letterbox kernel, PyTorch's elementwise kernels
    (adds, casts, silu, copies), memory copies and the rest; and kernels
    per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(("conv", "epilogue", "letterbox", "elementwise", "memcpy", "other"),
                          0.0)
    count = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name, ms = e.name.lower(), (e.time_range.end - e.time_range.start) / 1e3 / n
        if "conv_epilogue" in name:
            split["epilogue"] += ms
        elif "yuv_letterbox" in name:
            split["letterbox"] += ms
        elif "xmma" in name or "conv" in name or "fprop" in name or "implicit_gemm" in name:
            split["conv"] += ms
        elif "elementwise" in name or ("copy" in name and "memcpy" not in name):
            split["elementwise"] += ms
        elif "memcpy" in name or "memset" in name:
            split["memcpy"] += ms
        else:
            split["other"] += ms
        count += 1
    return {k: round(v, 4) for k, v in split.items()}, count / n


def phase_conv_epilogue(dev, smi):
    """Phase 6b (module docstring). Returns the kernel's record for the
    final JSON line: launches per forward and per-forward times by cell."""
    import torch
    from cvm_tpu_torch.infer import fold_bn
    from cvm_tpu_torch.ops.cuda import conv_epilogue as ce

    record = {}
    for cell in EPILOGUE_CELLS:
        new, old, data = _cell_pipelines(cell, dev)
        calls, real = [], fold_bn.conv_epilogue

        def recording(y, bias, residual=None, **kw):
            calls.append((y.clone(), bias, None if residual is None else residual.clone(),
                          kw["act"], kw["out_dtype"]))
            return real(y, bias, residual, **kw)

        fold_bn.conv_epilogue = recording
        try:
            with torch.no_grad():
                new.run(*data)
        finally:
            fold_bn.conv_epilogue = real
        if len(calls) != new.folded_counts["fused"]:
            raise AssertionError(f"{cell}: {len(calls)} epilogue calls per forward, "
                                 f"{new.folded_counts} folded")
        max_err = 0.0
        for y, b, r, act, out in calls:
            got = ce.conv_epilogue(y, b, r, act=act, out_dtype=out)
            ref = ce.conv_epilogue_reference(y, b, r, act, out)
            max_err = max(max_err, float((got.float() - ref.float()).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(f"{cell}: conv_epilogue differs from its plain version "
                                     f"at {tuple(y.shape)} act={act} residual={r is not None}")
        nbytes = sum(y.numel() * (2 + (2 if r is not None else 0) + out.itemsize)
                     + b.numel() * 2 for y, b, r, _, out in calls)
        old_bias = [b.float() for _, b, _, _, _ in calls]  # what the old fold cast per call
        acts = {None: lambda v: v, "silu": torch.nn.functional.silu,
                "relu": torch.nn.functional.relu}

        def kernel():
            for y, b, r, act, out in calls:
                ce.conv_epilogue(y, b, r, act=act, out_dtype=out)

        def plain():
            for y, b, r, act, out in calls:
                ce.conv_epilogue_reference(y, b, r, act, out)

        def library():
            for (y, _, r, act, out), b32 in zip(calls, old_bias):
                v = y + b32.to(torch.bfloat16)
                acts[act](v if r is None else r + v).to(out)

        t = dict(ms=cuda_ms(kernel), plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        t["bound_share_pct"] = 100.0 * t["bound_ms"] / t["ms"]
        log(f"[epilogue] {cell}: {len(calls)} calls per forward, {nbytes / 1e6:.1f} MB; "
            f"kernel {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms (bytes at 3.35 TB/s; "
            f"{t['bound_share_pct']:.1f}%), plain {t['plain_ms']:.4f} ms, the old fold's "
            f"unfused sequence {t['library_ms']:.4f} ms per forward, on {smi}")

        for pipe in (old, new):  # first sighting, then the capture
            pipe.predict(*data), pipe.predict(*data)
        launches = {}
        for side, pipe in (("old", old), ("new", new)):
            path = f"phase 6b {cell} {side} fold, 10 replays"
            replays = pipe.graph_counts["replays"]
            epilogue_launches(path, pipe.folded_counts, 10, lambda: letterbox_launches(
                path, 10, lambda: [pipe.predict(*data) for _ in range(10)]))
            if pipe.graph_counts["replays"] - replays != 10:
                raise AssertionError(f"{cell} {side}: {pipe.graph_counts} after 10 predicts "
                                     "from a captured signature")
            launches[side] = EPILOGUE_PATHS[path]["launches"]
        steps = {"old": [], "new": []}
        for side in ("old", "new", "new", "old"):
            pipe = old if side == "old" else new
            steps[side].append(cuda_ms(lambda: pipe.predict(*data)))
        split = {side: _kernel_classes(lambda p=p: p.predict(*data))
                 for side, p in (("old", old), ("new", new))}
        for side in ("old", "new"):
            log(f"[epilogue] {cell} {side} fold: replayed step {steps[side][0]:.4f} / "
                f"{steps[side][1]:.4f} ms on the device (CUDA events), {split[side][1]:.0f} "
                f"kernels, by class (ms, profiled) {split[side][0]}")
        log(f"[epilogue] {cell}: conv_epilogue launches in 10 replays, by its counter: old "
            f"fold {launches['old']}, new {launches['new']} "
            f"({new.folded_counts}); max |kernel - plain| {max_err}")
        record[cell] = dict(launches=launches["new"], max_abs_err=max_err, **t,
                            step_ms=steps,
                            split={k: v[0] for k, v in split.items()},
                            kernels={k: v[1] for k, v in split.items()})
    return record


def _letterbox_read_bytes(hw, out_hw) -> int:
    """Bytes of the planes the eval letterbox reads: per image and plane, the
    rows and columns its bilinear taps touch (at most two per output row or
    column, within the valid extent), luma once and chroma twice."""
    import torch

    from cvm_tpu_torch.ops.image import _axis_coords, chroma_roi, letterbox_roi

    def distinct(lo, hi, inside):
        return int(torch.cat([lo[inside], hi[inside]]).unique().numel())

    hw = hw.cpu()
    h, w = hw[:, 0], hw[:, 1]
    roi = letterbox_roi(h, w, out_hw[0], out_hw[1])
    total = 0
    for r, vh, vw, n in ((roi, h, w, 1), (chroma_roi(roi), (h + 1) // 2, (w + 1) // 2, 2)):
        ylo, yhi, _, yin = _axis_coords(out_hw[0], r.dst_y0, r.dst_h, r.src_y0, r.src_h, vh)
        xlo, xhi, _, xin = _axis_coords(out_hw[1], r.dst_x0, r.dst_w, r.src_x0, r.src_w, vw)
        for b in range(len(h)):
            total += n * distinct(ylo[b], yhi[b], yin[b]) * distinct(xlo[b], xhi[b], xin[b])
    return total


def phase_yuv_letterbox(dev, smi):
    """Phase 6c (module docstring). Returns the kernel's record for the
    final JSON line: per cell its time, bound, launches and the largest
    |kernel - plain| over its calls."""
    import torch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.ops.cuda import yuv_letterbox as yl
    from cvm_tpu_torch.pipeline import preprocess

    record = {}
    for cell in EPILOGUE_CELLS:
        params, model, batch = _cell_program(cell, dev)
        new = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=True)
        plain = InferencePipeline(params, model, dev, input_format="yuv420", fold_bn=True)
        data = [torch.from_numpy(batch[k]).to(dev) for k in new.keys]
        y, u, v, hw = data[:4]
        out_hw = tuple(params.input_hw)
        unequal, max_abs_err = {}, 0.0
        for dt in (torch.bfloat16, torch.float32):
            got, roi = yl.yuv_letterbox(y, u, v, hw, out_hw, dt)
            want, want_roi = yl.yuv_letterbox_reference(y, u, v, hw, out_hw, dt)
            unequal[str(dt)] = int((got != want).sum())
            max_abs_err = max(max_abs_err, float((got.float() - want.float()).abs().max()))
            same_roi = all(torch.equal(a, b) for a, b in zip(roi, want_roi))
            if unequal[str(dt)] or not same_roi:
                raise AssertionError(f"{cell}: yuv_letterbox differs from its plain version in "
                                     f"{dt}: {unequal[str(dt)]} of {got.numel()} elements, "
                                     f"ROI {roi} against {want_roi}")
        kernels = device_kernels(lambda: yl.yuv_letterbox(y, u, v, hw, out_hw))
        plain_kernels = device_kernels(lambda: yl.yuv_letterbox_reference(y, u, v, hw, out_hw))
        if len(kernels) != 1:
            raise AssertionError(f"{cell}: the kernel path runs {len(kernels)} device kernels "
                                 f"(expected 1): {kernels}")
        nbytes = (y.shape[0] * out_hw[0] * out_hw[1] * 3 * 2 + hw.numel() * 4 + 33 * y.shape[0]
                  + _letterbox_read_bytes(hw, out_hw))
        t = dict(ms=cuda_ms(lambda: yl.yuv_letterbox(y, u, v, hw, out_hw)),
                 plain_ms=cuda_ms(lambda: yl.yuv_letterbox_reference(y, u, v, hw, out_hw)),
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        t["bound_share_pct"] = 100.0 * t["bound_ms"] / t["ms"]
        log(f"[letterbox] {cell}: B{y.shape[0]} {tuple(y.shape[1:])} -> {out_hw}, bit-equal to "
            f"the plain version (unequal {unequal}, max |d| {max_abs_err}); {len(kernels)} "
            f"device kernels a call ({kernels}) against {len(plain_kernels)} for the eager ops; "
            f"kernel {t['ms'] * 1e3:.2f} us, bound {t['bound_ms'] * 1e3:.2f} us (bytes: the "
            f"output, and the plane rows and columns the taps touch, {nbytes / 1e6:.2f} MB at "
            f"3.35 TB/s; {t['bound_share_pct']:.1f}%), plain (the eager ops) "
            f"{t['plain_ms'] * 1e3:.1f} us, on {smi}")

        real = preprocess.yuv_letterbox
        preprocess.yuv_letterbox = yl.yuv_letterbox_reference
        try:  # the plain pipeline's first sighting and capture take the eager ops
            plain.predict(*data), plain.predict(*data)
        finally:
            preprocess.yuv_letterbox = real
        new.predict(*data), new.predict(*data)
        launches = {}
        for side, pipe in (("plain", plain), ("kernel", new)):
            path = f"phase 6c {cell} {side} preprocess, 10 replays"
            letterbox_launches(path, 10 if side == "kernel" else 0,
                               lambda: [pipe.predict(*data) for _ in range(10)])
            launches[side] = LETTERBOX_PATHS[path]["launches"]
            if pipe.graph_counts["replays"] < 11:
                raise AssertionError(f"{cell} {side}: {pipe.graph_counts}")
        want = plain.predict(*data)
        for k, val in new.predict(*data).items():
            if not torch.equal(val, want[k]):
                raise AssertionError(f"{cell}: the replayed step's {k} differs from the plain "
                                     "preprocess's")
        steps = {"plain": [], "kernel": []}
        for side in ("plain", "kernel", "kernel", "plain"):
            pipe = plain if side == "plain" else new
            steps[side].append(cuda_ms(lambda: pipe.predict(*data)))
        split = {side: _kernel_classes(lambda p=p: p.predict(*data))
                 for side, p in (("plain", plain), ("kernel", new))}
        for side in ("plain", "kernel"):
            log(f"[letterbox] {cell} {side} preprocess: replayed step {steps[side][0]:.4f} / "
                f"{steps[side][1]:.4f} ms on the device (CUDA events), {split[side][1]:.0f} "
                f"kernels, by class (ms, profiled) {split[side][0]}")
        log(f"[letterbox] {cell}: yuv_letterbox launches in 10 replays, by its counter: "
            f"{launches}; outputs equal")
        record[cell] = dict(launches_per_replay=launches["kernel"] / 10, device_kernels=kernels,
                            plain_device_kernels=len(plain_kernels), unequal=unequal,
                            max_abs_err=max_abs_err, bound_bytes=nbytes, **t, step_ms=steps,
                            split={k: v[0] for k, v in split.items()},
                            kernels={k: v[1] for k, v in split.items()})
    return record


def phase_splat(dev):
    """K1 against its plain version, each output block first poisoned with
    NaN (the kernel's output comes from torch.empty and must be written
    whole); one call at the flagship shape runs one device kernel; times at
    the flagship and config-B shapes."""
    import torch

    from cvm_tpu_torch.ops.cuda.gaussian_splat import (render_heatmap, render_heatmap_reference,
                                                       splat_plan)

    log("[splat] tolerance vs plain: max |kernel - plain| <= 1e-6 (values in [0, 1])")
    worst, failures, times = 0.0, [], {}
    for name, args, map_hw, c in splat_cases(dev):
        B = args[0].shape[0]
        torch.full((B, *map_hw, c), float("nan"), device=dev)  # freed at once, then reused
        got = render_heatmap(*args, map_hw, c)
        torch.cuda.synchronize()
        ref = render_heatmap_reference(*args, map_hw, c)
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        ok = got.shape == ref.shape and err <= 1e-6
        if name == "class=C":
            ok = ok and bool(args[5].all()) and float(got.abs().sum()) == 0.0
        if name in ("no-valid", "K=0", "all-invalid"):
            ok = ok and float(got.abs().sum()) == 0.0
        if name == "radius>map":
            ok = ok and float(args[3][0, 0]) > max(map_hw) and bool((got[0, ..., 0] > 0).all())
        note = ""
        if name == "flagship":
            kernels = device_kernels(lambda: render_heatmap(*args, map_hw, c))
            log(f"[splat] one render_heatmap call at the flagship shape runs {len(kernels)} "
                f"device kernel(s): {kernels}")
            if len(kernels) != 1 or "splat" not in kernels[0]:
                failures.append(f"expected one device kernel, the splat; got {kernels}")
        if name in ("flagship", "config-B", "multitask"):
            t_k = cuda_ms(lambda: render_heatmap(*args, map_hw, c))
            t_p = cuda_ms(lambda: render_heatmap_reference(*args, map_hw, c))
            times[name] = (t_k, t_p)
            # Bound: the map written once plus the per-object inputs read once,
            # against ~15 f32 operations per pixel of each valid object's
            # window (R = ceil(r) + 1) at 67 TFLOP/s; the bytes bound it.
            nbytes = got.numel() * 4 + sum(t.numel() * t.element_size() for t in args)
            win = (2 * (torch.ceil(args[3].float()) + 1) + 1) ** 2
            ops = 15.0 * float((win * args[5]).sum())
            bound = max(nbytes / 3.35e12, ops / 67e12) * 1e3
            if name == "flagship":
                times["bound_ms"] = bound
            if name == "multitask":
                times["multitask_bound_ms"] = bound
            plan = splat_plan(B, *map_hw, c)
            note = (f"; kernel {t_k:.4f} ms (one kernel, no fill; {plan.blocks} blocks of "
                    f"{plan.rows} rows, {plan.smem_bytes} B shared), bound {bound * 1e3:.1f} us "
                    f"(bytes; {bound / t_k:.1%} of it), plain {t_p:.4f} ms, library: none")
        log(f"[splat] {name:11s} B{B} K{args[0].shape[1]} {map_hw[0]}x{map_hw[1]} C{c} "
            f"valid {int(args[5].sum())}: {'ok' if ok else 'FAIL'} err={err:.3g}{note}")
        if not ok:
            failures.append(f"{name}: {err}")
    if failures:
        raise AssertionError(f"splat kernel disagrees with its plain version: {failures}")
    return worst, times


def read_metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_train(dev, workdir):
    """The flagship recipe through the CLI: 30 steps, then a resume to 40."""
    import torch

    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
    from cvm_tpu_torch.train.checkpoints import CheckpointManager

    flags = TRAIN_FLAGS + ["--workdir", workdir]
    ckpts = CheckpointManager(os.path.join(workdir, "checkpoints"))
    metrics_path = os.path.join(workdir, "metrics.jsonl")
    t0 = time.perf_counter()
    gs.reset_counts()
    train_main(flags + ["--steps", "30"])      # the main path, training slice
    torch.cuda.synchronize()
    launches = gs.render_heatmap.launches
    first = read_metrics(metrics_path)
    losses = [r["loss"] for r in first]
    log(f"[train] 30 steps in {time.perf_counter() - t0:.1f} s: {launches} K1 launches, "
        f"checkpoints {ckpts.all_steps()}; loss first 5 {np.round(losses[:5], 4).tolist()}, "
        f"last 5 {np.round(losses[-5:], 4).tolist()}")
    if [r["step"] for r in first] != list(range(1, 31)):
        raise AssertionError(f"expected 30 logged steps, got {[r['step'] for r in first]}")
    if not all(np.isfinite(r[k]) for r in first for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or grad_norm")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    if launches != 30:
        raise AssertionError(f"expected one K1 launch per step (30), got {launches}")
    if ckpts.all_steps() != [20]:
        raise AssertionError(f"expected the step-20 checkpoint only, got {ckpts.all_steps()}")
    # ms per step: each logged step ends in a host read of its metrics (a
    # device sync); steps 1-5 (cuDNN autotuning, warm-up) are left out.
    step_ms = [1e3 / r["steps_per_sec"] for r in first[5:]]

    t0 = time.perf_counter()
    gs.reset_counts()
    train_main(flags + ["--steps", "40"])      # resumes from step 20
    torch.cuda.synchronize()
    resumed = read_metrics(metrics_path)[len(first):]
    log(f"[train] resume to 40 in {time.perf_counter() - t0:.1f} s: steps "
        f"{resumed[0]['step']}..{resumed[-1]['step']}, {gs.render_heatmap.launches} K1 "
        f"launches, checkpoints {ckpts.all_steps()}, last loss {resumed[-1]['loss']:.4f}")
    if [r["step"] for r in resumed] != list(range(21, 41)):
        raise AssertionError(f"resume did not continue from step 20: "
                             f"{[r['step'] for r in resumed]}")
    if not all(np.isfinite(r["loss"]) for r in resumed) or gs.render_heatmap.launches != 20:
        raise AssertionError("resumed run: non-finite loss or wrong K1 launch count")
    if ckpts.all_steps() != [20, 40]:
        raise AssertionError(f"expected checkpoints [20, 40], got {ckpts.all_steps()}")
    return launches, statistics.median(step_ms)


def phase_serve_trained(dev, workdir):
    """The step-40 model (EMA parameters when on), BN folded, serves one
    batch-8 request."""
    import torch

    from cvm_tpu_torch.data.synthetic import synthetic_yuv420_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.centernet.model import create_model
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.checkpoints import CheckpointManager, load_params_cfg

    ckdir = os.path.join(workdir, "checkpoints")
    cfg = load_params_cfg(ckdir, CenternetParams)
    ck = CheckpointManager(ckdir).restore_latest(map_location=dev)
    model = create_model(cfg, dev)
    sd = dict(ck["model"])
    sd.update(ck["ema"] or {})
    model.load_state_dict(sd, strict=True)
    pipe = InferencePipeline(cfg, model.eval(), dev, fold_bn=True)
    batch = synthetic_yuv420_batch(np.random.default_rng(3), B, PAD_HW, num_classes=10)
    out = epilogue_launches("phase 9 step-40 model", pipe.folded_counts, 1,
                            lambda: letterbox_launches("phase 9 step-40 model", 1,
                                                       lambda: pipe(batch)))
    if out["boxes"].shape != (B, cfg.top_k, 4) or not torch.isfinite(out["boxes"]).all():
        raise AssertionError(f"trained model: bad boxes {tuple(out['boxes'].shape)}")
    if not torch.isfinite(out["scores"]).all():
        raise AssertionError("trained model: non-finite scores")
    log(f"[serve-trained] step-{ck['step']} model, BN folded: boxes {tuple(out['boxes'].shape)}, "
        f"top score {float(out['scores'].max()):.4f}, "
        f"scores > {cfg.score_threshold}: {int((out['scores'] > cfg.score_threshold).sum())}")


def phase_train_eval(workdir, smi):
    """The flagship recipe with evals: 20 steps, an eval every 10."""
    import torch

    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
    from cvm_tpu_torch.train.checkpoints import CheckpointManager

    t0 = time.perf_counter()
    gs.reset_counts()
    train_main(TRAIN_FLAGS + EVAL_TRAIN_FLAGS + ["--workdir", workdir])  # main path, eval slice
    torch.cuda.synchronize()
    launches = gs.render_heatmap.launches
    evals = [r for r in read_metrics(os.path.join(workdir, "metrics.jsonl")) if "val_mAP" in r]
    with open(os.path.join(workdir, "best", "best.json")) as f:
        best = json.load(f)
    on_disk = CheckpointManager(os.path.join(workdir, "best")).all_steps()
    log(f"[train-eval] 20 steps with 2 evals on {smi} in {time.perf_counter() - t0:.1f} s: "
        f"{launches} K1 launches; " + "; ".join(
            f"step {r['step']}: val_mAP {r['val_mAP']:.4f}, mAP50 {r['val_mAP50']:.4f}, "
            f"{r['eval_seconds']:.2f} s" for r in evals)
        + f"; best.json {best}, best checkpoint steps on disk {on_disk}")
    if launches != 20:
        raise AssertionError(f"expected one K1 launch per step (20), got {launches}")
    if [r["step"] for r in evals] != [10, 20]:
        raise AssertionError(f"expected val_mAP at steps 10 and 20, got {[r['step'] for r in evals]}")
    for r in evals:
        if not all(np.isfinite(r[k]) and 0.0 <= r[k] <= 1.0
                   for k in ("val_mAP", "val_mAP50", "val_mAP75")):
            raise AssertionError(f"eval metrics not finite in [0, 1]: {r}")
    if best["metric"] != "mAP" or on_disk != [best["step"]]:
        raise AssertionError(f"best.json {best} does not name the step on disk {on_disk}")


def phase_evaluate(dev, workdir, smi):
    """cli.evaluate in four postures at batch 16; then the int8 posture
    through K2 and through its plain version, and the eval layer's times."""
    import torch

    from cvm_tpu_torch.cli.evaluate import main as eval_main
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.evaluate import evaluate_model
    from cvm_tpu_torch.train.loop import Trainer

    maps, launches = {}, 0
    for name, extra in EVAL_POSTURES.items():
        out = os.path.join(workdir, f"eval_{name.replace(' ', '_')}.json")
        fq.reset_counts()
        t0 = time.perf_counter()
        eval_main(EVAL_FLAGS + ["--workdir", workdir, "--json_out", out] + extra)  # main path
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        # counted at each launch: of the 2 batches the first runs eagerly
        # and the second is the CUDA graph's capture (no replay)
        counts = (fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches,
                  fq.fused_qconv.weight_packs)
        with open(out) as f:
            m = json.load(f)
        maps[name] = m["mAP"]
        log(f"[evaluate] {name:16s} step {m['step']}: mAP {m['mAP']:.4f}, mAP50 {m['mAP50']:.4f}, "
            f"mAP75 {m['mAP75']:.4f}; {seconds:.2f} s for the call (2 batches of 16), K2 "
            f"launches / int8-out / weight packs {counts}")
        if not all(np.isfinite(m[k]) and 0.0 <= m[k] <= 1.0 for k in ("mAP", "mAP50", "mAP75")):
            raise AssertionError(f"{name}: eval metrics not finite in [0, 1]: {m}")
        want = (48, 14, 0) if name == "w8a8_fused_chain" else (0, 0, 0)
        if counts != want:
            raise AssertionError(f"{name}: expected K2 launches / int8-out / packs {want} "
                                 f"(24 / 7 / 0 per int8 forward), got {counts}")
        launches += counts[0]

    # The int8 posture at batch 16, kernel vs plain, on the same weights,
    # scales and scenes.
    ckdir = os.path.join(workdir, "checkpoints")
    cfg = load_params_cfg(ckdir, CenternetParams)
    trainer = Trainer(cfg, dev, checkpoint_dir=ckdir)
    trainer.init_state()
    model = trainer.eval_model()
    cal = synthetic_batch(np.random.default_rng(0), cfg.batch_size, (512, 512), num_classes=10)
    proc_cal, _ = preprocess_image_batch(torch.from_numpy(cal["image"]).to(dev),
                                         torch.from_numpy(cal["image_hw"]).to(dev), cfg.input_hw)
    scales = qz.calibrate_activation_scales(model, [proc_cal])
    # The plain pass gets a pipeline of its own, built alike and first
    # called with the plain version swapped in: the kernel pass's second
    # batch captures a CUDA graph of the kernel, which a replay would run
    # whatever ``qz.fused_qconv`` holds by then.
    pipe_q, pipe_plain = (InferencePipeline(cfg, model, dev, input_format="rgb", w8a8=scales,
                                            w8a8_fused=True, w8a8_chain=True) for _ in range(2))
    pipe_fp = InferencePipeline(cfg, model, dev, input_format="rgb")
    rng = np.random.default_rng(999)
    val = [synthetic_batch(rng, cfg.batch_size, (512, 512), num_classes=10) for _ in range(2)]
    data = [torch.from_numpy(val[0][k]).to(dev) for k in ("image", "image_hw")]
    proc, _ = preprocess_image_batch(*data, cfg.input_hw, out_dtype=torch.bfloat16)
    st_k, st_p, st_fp = {}, {}, {}
    with torch.no_grad():
        fq.reset_counts()
        m_k = evaluate_model("centernet", cfg, None, val, device=dev, predict_fn=pipe_q, stats=st_k)
        heads_k = pipe_q.heads(proc)
        k2_kernel = fq.fused_qconv.launches
        real = qz.fused_qconv
        qz.fused_qconv = lambda *a, w_packed=None, **k: fq.fused_qconv_reference(*a, **k)
        fq.reset_counts()
        try:
            m_p = evaluate_model("centernet", cfg, None, val, device=dev, predict_fn=pipe_plain,
                                 stats=st_p)
            heads_p = pipe_plain.heads(proc)
        finally:
            qz.fused_qconv = real
        k2_plain = fq.fused_qconv.launches
        evaluate_model("centernet", cfg, None, val, device=dev, predict_fn=pipe_fp, stats=st_fp)
    graphs_k, graphs_p = (dict((k, p.graph_counts[k]) for k in ("captures", "replays"))
                          for p in (pipe_q, pipe_plain))
    log(f"[evaluate] kernel pass: {k2_kernel} K2 launches, graphs {graphs_k}; plain pass on a "
        f"pipeline of its own: {k2_plain} K2 launches, graphs {graphs_p}")
    if k2_kernel != 3 * 24 or k2_plain != 0:
        raise AssertionError(f"int8 posture at batch 16: K2 launches kernel / plain pass "
                             f"{k2_kernel} / {k2_plain}, expected 72 (two batches of 16 and a "
                             f"forward of the heads, 24 each) / 0")
    d_sig = float((torch.sigmoid(heads_k["heatmap"]) - torch.sigmoid(heads_p["heatmap"]))
                  .abs().mean())
    d_map = abs(m_k["mAP"] - m_p["mAP"])
    log(f"[evaluate] int8 posture at batch 16, kernel vs plain: mean |d sigmoid(hm)| = "
        f"{d_sig:.3e} (bound 1e-3), mAP {m_k['mAP']:.4f} vs {m_p['mAP']:.4f} (|d| {d_map:.4f}, "
        f"bound 0.005)")
    if not d_sig < 1e-3:
        raise AssertionError(f"int8 posture at batch 16: kernel vs plain heads differ: {d_sig}")
    if not d_map <= 0.005:
        raise AssertionError(f"int8 posture at batch 16: kernel vs plain mAP differ: {d_map}")
    # The eval layer: host ms per batch in the pipeline (transfers and the
    # sync of the results included) and in the evaluator; device ms per
    # batch of predict on resident inputs.
    dev_fp = cuda_ms(lambda: pipe_fp.predict(*data), reps=10)
    dev_q = cuda_ms(lambda: pipe_q.predict(*data), reps=10)
    for name, st, d in (("fp", st_fp, dev_fp), ("w8a8_fused_chain", st_k, dev_q)):
        n = st["batches"]
        tot = st["predict_s"] + st["evaluator_s"]
        log(f"[eval-layer] {name:16s} batch 16 on {smi}: evaluate_model host "
            f"{1e3 * tot / n:.3f} ms/batch (pipeline {1e3 * st['predict_s'] / n:.3f}, evaluator "
            f"{1e3 * st['evaluator_s'] / n:.3f}: {st['evaluator_s'] / tot:.1%}), device "
            f"{d:.3f} ms/batch (predict, inputs resident)")
    return maps, launches


def _rel_mean_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().mean() / b.float().abs().mean().clamp_min(1e-12))


def phase_dense_serve(dev, smi):
    """Each dense path at full width: calibration, the fp (BN folded) and
    int8 (fused, chained) pipelines, K2's launches per int8 forward, the
    int8 posture through K2 vs its plain version, latencies."""
    import torch

    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.pipeline.preprocess import preprocess_image_batch

    log("[dense] tolerance, int8 through K2 vs through its plain version: mean |d| of "
        "logits / depth <= 1% of the plain output's mean |value|; class maps agree on >= "
        "99.5% of pixels")
    launches = {}
    for path, name, b, want in DENSE_PATHS:
        t0 = time.perf_counter()
        cfg, model = build_dense(name, b, dev)
        rng = np.random.default_rng(0)
        cal = []
        for _ in range(1):  # one batch: its percentiles run on the host
            cb = synthetic_batch(rng, b, DENSE_PAD, num_classes=5)
            cal.append(preprocess_image_batch(torch.from_numpy(cb["image"]).to(dev),
                                              torch.from_numpy(cb["image_hw"]).to(dev),
                                              cfg.input_hw)[0])
        scales = qz.calibrate_activation_scales(model, cal)
        t_cal = time.perf_counter() - t0
        pipe_fp = InferencePipeline(cfg, model, dev, input_format="rgb", fold_bn=True)
        pipe_q = InferencePipeline(cfg, model, dev, input_format="rgb", w8a8=scales,
                                   w8a8_fused=True, w8a8_chain=True)
        batch = synthetic_batch(np.random.default_rng(1), b, DENSE_PAD, num_classes=5)
        out_fp = epilogue_launches(f"phase 12 {path} fp", pipe_fp.folded_counts, 1,
                                   lambda: pipe_fp(batch))
        fq.reset_counts()
        out_q = pipe_q(batch)                  # a main path: the dense int8 posture
        torch.cuda.synchronize()
        counts = (fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches,
                  fq.fused_qconv.weight_packs)
        launches[path] = counts[0]
        if counts != (want, 7, 0):
            raise AssertionError(f"{path}: expected K2 launches / int8-out / packs "
                                 f"({want}, 7, 0) per int8 forward, got {counts}")
        H, W = cfg.input_hw
        want_shapes = {"class_map": (b, H, W), "depth": (b, H, W, 1), "boxes": (b, 100, 4),
                       "scores": (b, 100)}
        for posture, out in (("fp", out_fp), ("int8", out_q)):
            for k, v in out.items():
                if k in want_shapes and tuple(v.shape) != want_shapes[k]:
                    raise AssertionError(f"{path} {posture}: {k} shape {tuple(v.shape)}")
                if v.is_floating_point() and not torch.isfinite(v).all():
                    raise AssertionError(f"{path} {posture}: non-finite {k}")
        data = [torch.from_numpy(batch[k]).to(dev) for k in ("image", "image_hw")]
        proc, _ = preprocess_image_batch(*data, cfg.input_hw, out_dtype=torch.bfloat16)
        with torch.no_grad():
            h_fp, h_k = pipe_fp.heads(proc), pipe_q.heads(proc)
            real = qz.fused_qconv
            qz.fused_qconv = lambda *a, w_packed=None, **k: fq.fused_qconv_reference(*a, **k)
            try:
                h_p = pipe_q.heads(proc)
            finally:
                qz.fused_qconv = real
        notes, bad = [], []
        for key in ("logits", "depth", "heatmap"):
            if key not in h_k:
                continue
            d_kp = _rel_mean_diff(h_k[key], h_p[key])
            d_fp = _rel_mean_diff(h_k[key], h_fp[key])
            notes.append(f"{key}: kernel vs plain mean |d| {d_kp:.2e} of mean |plain|, int8 vs "
                         f"fp {d_fp:.2e}")
            if key in ("logits", "depth") and not d_kp <= 1e-2:
                bad.append(f"{key} {d_kp}")
        if "logits" in h_k:
            agree = float((h_k["logits"].argmax(-1) == h_p["logits"].argmax(-1)).float().mean())
            agree_fp = float((h_k["logits"].argmax(-1) == h_fp["logits"].argmax(-1))
                             .float().mean())
            notes.append(f"class maps: kernel vs plain agree on {agree:.4%}, int8 vs fp "
                         f"{agree_fp:.4%}")
            if not agree >= 0.995:
                bad.append(f"class-map agreement {agree}")
        lat_fp = host_ms(lambda: pipe_fp.predict(*data))
        lat_q = host_ms(lambda: pipe_q.predict(*data))
        log(f"[dense] {path:10s} B{b} {H}x{W}: K2 launches / int8-out / packs {counts}; "
            + "; ".join(notes) + f"; calibration {t_cal:.1f} s; predict median of 20 on {smi}: "
            f"fp (BN folded) {lat_fp:.3f} ms, int8 (fused, chained) {lat_q:.3f} ms")
        if bad:
            raise AssertionError(f"{path}: int8 posture through K2 disagrees with its plain "
                                 f"version: {bad}")
        del model, pipe_fp, pipe_q
        torch.cuda.empty_cache()
    return launches


def phase_dense_train(smi):
    """20 multitask steps through the CLI (one K1 launch per step), then 20
    semseg steps with an eval."""
    import torch

    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        gs.reset_counts()
        train_main(["--model", "multitask", "--workdir", wd] + DENSE_TRAIN_FLAGS)  # main path
        torch.cuda.synchronize()
        k1 = gs.render_heatmap.launches
        rows = read_metrics(os.path.join(wd, "metrics.jsonl"))
        losses = [r["loss"] for r in rows]
        step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in rows[5:])
        log(f"[dense-train] multitask 20 steps (B8, 256x640, full width) in "
            f"{time.perf_counter() - t0:.1f} s: {k1} K1 launches; loss first 5 "
            f"{np.round(losses[:5], 4).tolist()}, last 5 {np.round(losses[-5:], 4).tolist()}; "
            f"median {step_ms:.3f} ms/step on {smi} (host clock, a sync per step, steps 6-20)")
        if [r["step"] for r in rows] != list(range(1, 21)):
            raise AssertionError(f"multitask: expected 20 logged steps, got {len(rows)}")
        if not all(np.isfinite(r[k]) for r in rows for k in ("loss", "grad_norm")):
            raise AssertionError("multitask: non-finite loss or grad_norm")
        if not np.mean(losses[-5:]) < np.mean(losses[:5]):
            raise AssertionError(f"multitask: loss did not fall: {losses}")
        if k1 != 20:
            raise AssertionError(f"multitask: expected one K1 launch per step (20), got {k1}")
    with tempfile.TemporaryDirectory() as wd:
        t0 = time.perf_counter()
        train_main(["--model", "semseg", "--workdir", wd, "--eval_every", "20",
                    "--eval_batches", "2"] + DENSE_TRAIN_FLAGS)                 # main path
        torch.cuda.synchronize()
        rows = read_metrics(os.path.join(wd, "metrics.jsonl"))
        train = [r for r in rows if "loss" in r]
        evals = [r for r in rows if "val_miou" in r]
        log(f"[dense-train] semseg 20 steps (B8, 256x640) with an eval in "
            f"{time.perf_counter() - t0:.1f} s: loss first {train[0]['loss']:.4f}, last "
            f"{train[-1]['loss']:.4f}; " + "; ".join(
                f"step {r['step']}: val_miou {r['val_miou']:.4f}, val_pixel_acc "
                f"{r['val_pixel_acc']:.4f}, {r['eval_seconds']:.2f} s" for r in evals))
        if not all(np.isfinite(r["loss"]) for r in train):
            raise AssertionError("semseg: non-finite loss")
        if [r["step"] for r in evals] != [20] or not 0.0 <= evals[0]["val_miou"] <= 1.0:
            raise AssertionError(f"semseg: expected val_miou in [0, 1] at step 20, got {evals}")
    return k1


def phase_benchmark():
    """``cli.benchmark --configs A,B,C,D --iters 6`` in this process."""
    import contextlib
    import io

    from cvm_tpu_torch.cli import benchmark

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        benchmark.main(["--configs", "A,B,C,D", "--iters", "6"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    for r in lines:
        log(f"[benchmark] {json.dumps(r)}")
    if [r["config"] for r in lines] != ["A", "B", "C", "D"]:
        raise AssertionError(f"cli.benchmark: expected configs A-D, got {lines}")
    for r in lines:
        if not (np.isfinite(r["images_per_sec"]) and r["images_per_sec"] > 0
                and r["p50_latency_ms"] > 0 and "mfu_pct" in r):
            raise AssertionError(f"cli.benchmark: bad line {r}")


def phase_int8(dev, cfg, model, scales, planes, pipe_fp, pipe_q, smi):
    """Config B at batch 8 in ``w8a8`` and ``w8a8_static``: every Int8Conv
    call's ``_int_mm`` sums against its float64 plain version, the int8
    convs' device time beside cuDNN bf16, and batch-8 predict of four
    postures."""
    import torch
    import torch.nn.functional as F

    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

    pipes = {"w8a8": InferencePipeline(cfg, model, dev, w8a8=True),
             "w8a8_static": InferencePipeline(cfg, model, dev, w8a8=scales)}
    proc, _ = preprocess_yuv420_batch(*planes, cfg.input_hw, out_dtype=torch.bfloat16)
    real = qz.Int8Conv.int8_conv
    calls = []

    def record(mod, xq):
        acc = real(mod, xq)
        calls.append((mod, xq, acc))
        return acc

    int8_ms, lib_ms = {}, {}
    for name, pipe in pipes.items():
        counts = pipe.int8_counts
        calls.clear()
        qz.Int8Conv.int8_conv = record
        qz.Int8Conv.mm_launches = 0
        try:
            with torch.no_grad():
                out = pipe.predict(*planes)       # a main path: the XLA-composed int8 posture
            torch.cuda.synchronize()
        finally:
            qz.Int8Conv.int8_conv = real
        launches = qz.Int8Conv.mm_launches
        if counts["fp"] or launches != counts["int8"] or len(calls) != counts["int8"]:
            raise AssertionError(f"{name}: {counts}, {launches} _int_mm launches, "
                                 f"{len(calls)} calls recorded")
        if not (torch.isfinite(out["scores"]).all() and torch.isfinite(out["boxes"]).all()):
            raise AssertionError(f"{name}: non-finite results")
        bad, kinds = [], set()
        t_mm = t_lib = 0.0
        for mod, xq, acc in calls:
            ref = qz.int8_conv_reference(mod, xq)
            if acc.dtype != torch.int32 or not torch.equal(acc, ref):
                bad.append(f"k{mod.k} s{mod.stride} {tuple(xq.shape)}->{mod.cout}: max |d| "
                           f"{(acc.double() - ref.double()).abs().max().item()}")
            kinds.add((mod.k, mod.stride, mod.cin == 12, mod.bias is not None))
            if name == "w8a8_static":  # one timing pass: the product is the same
                B, H, W, cin = xq.shape
                xb = torch.randn(B, cin, H, W, device=dev).to(torch.bfloat16,
                                                              memory_format=torch.channels_last)
                wb = torch.randn(mod.cout, cin, mod.k, mod.k, device=dev).to(
                    torch.bfloat16, memory_format=torch.channels_last)
                t_mm += cuda_ms(lambda: qz.int8_conv_mm(mod, xq), reps=10)
                t_lib += cuda_ms(lambda: F.conv2d(xb, wb, stride=mod.stride,
                                                  padding=mod.k // 2), reps=10)
        log(f"[int8] {name}: {len(calls)} Int8Conv calls ({counts}), {launches} _int_mm "
            f"launches; int32 sums vs float64 plain: {len(calls) - len(bad)} of {len(calls)} "
            f"exact; kinds (k, stride, stem, bias) {sorted(kinds)}")
        if bad:
            raise AssertionError(f"{name}: _int_mm sums differ from the plain version: {bad}")
        if not {(3, 2, False, False), (3, 1, True, False), (1, 1, False, True)} <= kinds:
            raise AssertionError(f"{name}: stride-2, stem or head convs missing: {kinds}")
        if name == "w8a8_static":
            int8_ms["mm"], lib_ms["conv"] = t_mm, t_lib
    for name, pipe in pipes.items():
        int8_ms[name] = cuda_ms(lambda: pipe.heads(proc), reps=5)
    int8_ms["fp"] = cuda_ms(lambda: pipe_fp.heads(proc), reps=5)
    log(f"[int8] device ms per config-B batch-8 forward on {smi}: the 31 convs' _int_mm "
        f"products {int8_ms['mm']:.3f} (im2col + _int_mm, inputs quantized), cuDNN bf16 "
        f"convs of the same shapes {lib_ms['conv']:.3f}; whole forward fp (BN folded) "
        f"{int8_ms['fp']:.3f}, w8a8 {int8_ms['w8a8']:.3f}, w8a8_static "
        f"{int8_ms['w8a8_static']:.3f}")
    lat = {"fp": host_ms(lambda: pipe_fp.predict(*planes))}
    for name, pipe in pipes.items():
        lat[name] = host_ms(lambda: pipe.predict(*planes))
    lat["w8a8_fused_chain"] = host_ms(lambda: pipe_q.predict(*planes))
    log(f"[int8] batch-8 predict, median of 20 (host clock) on {smi}: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in lat.items()))
    return len(calls)


def phase_export(dev, workdir, smi):
    """cli.export of the step-40 checkpoint in five postures, each served
    by ServingModel on the card against its eager pipeline."""
    import torch

    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.data.synthetic import synthetic_yuv420_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.infer.quantize import dequantize_params, quantize_params
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.infer.selftest import compare, fingerprint
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.loop import Trainer

    ckdir = os.path.join(workdir, "checkpoints")
    cfg = load_params_cfg(ckdir, CenternetParams)
    trainer = Trainer(cfg, dev, checkpoint_dir=ckdir)
    trainer.init_state()
    model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)
    pad = (int(cfg.input_hw[0] * 1.5) // 2 * 2, int(cfg.input_hw[1] * 1.5) // 2 * 2)
    scales = calibration_scales(cfg, model, pad, 3, 1, dev)  # cli.export's, --batch_size 1
    batch = synthetic_yuv420_batch(np.random.default_rng(4), B, pad, num_classes=10)
    data = [batch[k] for k in ("y", "u", "v", "image_hw")]
    launches = {}
    log("[export] tolerance, artifact vs eager pipeline of the same posture: the selftest's "
        "(each output's mean and std within 5% of its scale + 1e-3); boxes and classes "
        "identical in the int8 postures")
    for q, flags in EXPORT_POSTURES.items():
        art = os.path.join(workdir, f"art_{q}")
        t0 = time.perf_counter()
        export_main(["--model", "centernet", "--checkpoint_dir", ckdir, "--out", art,
                     "--quantize", q, "--input_format", "yuv420", "--batch_sizes", "1,8",
                     "--device", "cuda"])
        t_export = time.perf_counter() - t0
        sm = ServingModel(art, device="cuda")
        problems = sm.selftest()
        eager_model = model
        if q == "int8":
            eager_model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)
            params = dict(eager_model.named_parameters())
            deq = dequantize_params(quantize_params(params)[0])
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(deq[n])
        eager = InferencePipeline(cfg.replace(batch_size=B), eager_model, dev,
                                  w8a8=scales if q.startswith("w8a8") else None, **flags)
        fq.reset_counts()
        got = epilogue_launches(f"phase 16 {q} artifact", eager.folded_counts, 1,
                                lambda: letterbox_launches(f"phase 16 {q} artifact", 1,
                                                           lambda: sm(*data)))  # a main path
        launches[q] = (fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches)
        want = eager(batch)
        diff = compare(fingerprint(want), fingerprint(got))
        same = all(torch.equal(got[k], want[k]) for k in ("boxes", "classes"))
        d_scores = float((got["scores"] - want["scores"]).abs().max())
        t_art = host_ms(lambda: sm(*data))
        planes = [torch.from_numpy(a).to(dev) for a in data]
        t_eager = host_ms(lambda: eager.predict(*planes))
        log(f"[export] {q:16s}: exported in {t_export:.1f} s ({os.path.getsize(art + '/model.pt2')} "
            f"B program, {os.path.getsize(art + '/weights.npz')} B weights); selftest "
            f"{problems or 'ok'}; vs eager: {diff or 'within tolerance'}, boxes and classes "
            f"{'identical' if same else 'differ'}, max |d score| {d_scores:.3g}; K2 launches / "
            f"int8-out per batch-8 call {launches[q]}; predict median of 20 on {smi}: artifact "
            f"{t_art:.3f} ms (host numpy in), eager pipeline {t_eager:.3f} ms (planes resident)")
        if problems or diff:
            raise AssertionError(f"{q}: selftest {problems}, vs eager {diff}")
        if q != "none" and not same:
            raise AssertionError(f"{q}: artifact boxes or classes differ from the eager pipeline")
        want_k2 = {"w8a8_fused": (24, 0), "w8a8_fused_chain": (24, 7)}.get(q, (0, 0))
        if launches[q] != want_k2:
            raise AssertionError(f"{q}: expected K2 launches / int8-out {want_k2} per batch-8 "
                                 f"call, got {launches[q]}")
        b3 = sm(*(a[:3] for a in data))           # the b8 bucket, padded
        if tuple(b3["boxes"].shape) != (3, cfg.top_k, 4) or not torch.equal(
                b3["boxes"], got["boxes"][:3]):
            raise AssertionError(f"{q}: a batch of 3 through the b8 bucket differs")
        # The b1 bucket against the eager pipeline at batch 1: a batch-1
        # program's fp convs may take other cuDNN algorithms than batch 8's,
        # so b1 and b8 are compared for information only.
        eager1 = InferencePipeline(cfg.replace(batch_size=1), eager_model, dev,
                                   w8a8=scales if q.startswith("w8a8") else None, **flags)
        b1 = sm(*(a[:1] for a in data))
        want1 = eager1({k: v[:1] for k, v in batch.items()})
        diff1 = compare(fingerprint(want1), fingerprint(b1))
        same1 = all(torch.equal(b1[k], want1[k]) for k in ("boxes", "classes"))
        d_b1_b8 = float((b1["scores"].sort(dim=1).values - got["scores"][:1].sort(dim=1).values)
                        .abs().max())
        log(f"[export] {q:16s}: batch 3 through the b8 bucket equals rows 0-2; batch 1 through "
            f"the b1 bucket vs the eager pipeline at batch 1: {diff1 or 'within tolerance'}, "
            f"boxes and classes {'identical' if same1 else 'differ'}; b1 vs b8 row 0: max |d "
            f"sorted score| {d_b1_b8:.3g}")
        if diff1 or (q != "none" and not same1):
            raise AssertionError(f"{q}: the b1 bucket differs from the eager pipeline at "
                                 f"batch 1: {diff1}")
    # A tampered weights file fails cli.serve --selftest with exit 3.
    art = os.path.join(workdir, "art_w8a8_fused_chain")
    bad = os.path.join(workdir, "art_tampered")
    shutil.copytree(art, bad)
    with np.load(os.path.join(bad, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    key = "hm.out.bias"  # the heatmap logits' bias: every score moves
    flat[key] = flat[key] + 1.0
    np.savez(os.path.join(bad, "weights.npz"), **flat)
    cmd = [sys.executable, "-m", "cvm_tpu_torch.cli.serve", "--selftest", "--device", "cuda"]
    rc_good = subprocess.run(cmd + ["--artifact", art], timeout=300).returncode
    proc = subprocess.run(cmd + ["--artifact", bad], timeout=300, capture_output=True, text=True)
    log(f"[export] cli.serve --selftest: untouched artifact exit {rc_good}; {key} + 1 in "
        f"weights.npz: exit {proc.returncode} ({proc.stderr.strip().splitlines()[-1:]})")
    if rc_good != 0 or proc.returncode != 3:
        raise AssertionError(f"cli.serve --selftest: exits {rc_good} / {proc.returncode}, "
                             "expected 0 / 3")
    return launches


def phase_qat(workdir, smi):
    """--qat true on phase 8's fp run: 20 steps, an eval every 10."""
    import torch

    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
    from cvm_tpu_torch.train import qat
    from cvm_tpu_torch.train.checkpoints import load_params_cfg

    real, modes = qat.fq_conv, {True: 0, False: 0}

    def counted(conv, x, dtype=None):
        modes[conv.training] += 1
        return real(conv, x, dtype)

    metrics_path = os.path.join(workdir, "metrics.jsonl")
    n0 = len(read_metrics(metrics_path))
    t0 = time.perf_counter()
    gs.reset_counts()
    qat.fq_conv = counted
    try:
        train_main(TRAIN_FLAGS + QAT_FLAGS + ["--workdir", workdir])  # main path, QAT slice
        torch.cuda.synchronize()
    finally:
        qat.fq_conv = real
    rows = read_metrics(metrics_path)[n0:]
    train = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "val_mAP" in r]
    launches = gs.render_heatmap.launches
    saved = load_params_cfg(os.path.join(workdir, "checkpoints"), CenternetParams)
    log(f"[qat] 20 fake-quant steps (40 -> 60) on {smi} in {time.perf_counter() - t0:.1f} s: "
        f"{launches} K1 launches; loss {train[0]['loss']:.4f} -> {train[-1]['loss']:.4f}; "
        f"fake-quant conv calls: {modes[True]} in training mode, {modes[False]} in eval mode; "
        + "; ".join(f"step {r['step']}: val_mAP {r['val_mAP']:.4f}" for r in evals)
        + f"; saved config qat={saved.qat}")
    if [r["step"] for r in train] != list(range(41, 61)):
        raise AssertionError(f"qat: expected steps 41-60, got {[r['step'] for r in train]}")
    if not all(np.isfinite(r[k]) for r in train for k in ("loss", "grad_norm")):
        raise AssertionError("qat: non-finite loss or grad_norm")
    if launches != 20:
        raise AssertionError(f"qat: expected one K1 launch per step (20), got {launches}")
    if [r["step"] for r in evals] != [50, 60] or not modes[True] or not modes[False]:
        raise AssertionError(f"qat: evals {evals}, fake-quant calls {modes}")
    if not saved.qat:
        raise AssertionError("qat: the resumed run's saved config still says qat=false")
    return launches


def _heads_plain(pipe, proc):
    """``pipe``'s model on ``proc`` with K2 swapped for its plain version
    (which reads the HWIO weights); the kernel's counts are not touched."""
    import torch

    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    real = qz.fused_qconv
    qz.fused_qconv = lambda *a, w_packed=None, **k: fq.fused_qconv_reference(*a, **k)
    try:
        with torch.no_grad():
            return pipe.model(proc)
    finally:
        qz.fused_qconv = real


def phase_3d_serve(dev, smi):
    """Config B with the 3D heads at batch 8 on 768^2 YUV420 + intrinsics:
    calibration, fp (BN folded) and int8 (fused, chained), K2's launches
    per int8 forward, the int8 posture through K2 vs its plain version."""
    import torch

    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline, postprocess
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

    cfg, model = build_model(dev, with_3d=True)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cal = []
    for _ in range(3):
        b = synthetic_batch(rng, B, PAD_HW, num_classes=10, with_3d=True, yuv420=True)
        cal.append(preprocess_yuv420_batch(*(torch.from_numpy(b[k]).to(dev)
                                             for k in ("y", "u", "v", "image_hw")),
                                           cfg.input_hw)[0])
    scales = qz.calibrate_activation_scales(model, cal)
    t_cal = time.perf_counter() - t0
    pipe_fp = InferencePipeline(cfg, model, dev, fold_bn=True)
    pipe_q = InferencePipeline(cfg, model, dev, w8a8=scales, w8a8_fused=True, w8a8_chain=True)
    if pipe_q.fused_counts != {"convbn": 13, "resblock": 7, "calls": THREE_D_K2}:
        raise AssertionError(f"3D: unexpected fused coverage {pipe_q.fused_counts}")
    batch = synthetic_batch(np.random.default_rng(1), B, PAD_HW, num_classes=10, with_3d=True,
                            yuv420=True)
    out_fp = epilogue_launches("phase 18 3D fp", pipe_fp.folded_counts, 1,
                               lambda: letterbox_launches("phase 18 3D fp", 1,
                                                          lambda: pipe_fp(batch)))
    fq.reset_counts()
    out_q = letterbox_launches("phase 18 3D int8", 1,
                               lambda: pipe_q(batch))  # a main path: 3D int8 serving
    torch.cuda.synchronize()
    counts = (fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches,
              fq.fused_qconv.weight_packs)
    if counts != (THREE_D_K2, 7, 0):
        raise AssertionError(f"3D: expected K2 launches / int8-out / packs ({THREE_D_K2}, 7, "
                             f"0) per int8 forward, got {counts}")
    shapes = {"boxes": (B, cfg.top_k, 4), "scores": (B, cfg.top_k), "classes": (B, cfg.top_k),
              "centers3d": (B, cfg.top_k, 3), "dims": (B, cfg.top_k, 3), "yaw": (B, cfg.top_k)}
    for posture, out in (("fp", out_fp), ("int8", out_q)):
        if {k: tuple(v.shape) for k, v in out.items()} != shapes:
            raise AssertionError(f"3D {posture}: shapes {[tuple(v.shape) for v in out.values()]}")
        if not all(torch.isfinite(v.float()).all() for v in out.values()):
            raise AssertionError(f"3D {posture}: non-finite outputs")
    data = [torch.from_numpy(batch[k]).to(dev) for k in pipe_q.keys]
    proc, rois = preprocess_yuv420_batch(*data[:4], cfg.input_hw, out_dtype=torch.bfloat16)
    with torch.no_grad():
        h_k = pipe_q.model(proc)
    h_p = _heads_plain(pipe_q, proc)
    d = {k: float((h_k[k] - h_p[k]).abs().mean() / h_p[k].abs().mean().clamp_min(1e-12))
         for k in h_k}
    r_k, r_p = (postprocess(cfg, h, rois, data[4]) for h in (h_k, h_p))
    same_classes = torch.equal(r_k["classes"], r_p["classes"])
    agree = float((r_k["classes"] == r_p["classes"]).float().mean())
    lat_fp = epilogue_launches(
        "phase 18 3D fp latency", pipe_fp.folded_counts, HOST_MS_CALLS,
        lambda: letterbox_launches("phase 18 3D fp latency", HOST_MS_CALLS,
                                   lambda: host_ms(lambda: pipe_fp.predict(*data))))
    lat_q = letterbox_launches("phase 18 3D int8 latency", HOST_MS_CALLS,
                               lambda: host_ms(lambda: pipe_q.predict(*data)))
    log(f"[3d-serve] config B + 3D heads, B{B} 768^2 yuv420 + intrinsics: calibration "
        f"{t_cal:.1f} s; K2 launches / int8-out / packs {counts}; int8 through K2 vs its plain "
        f"version: mean |d| / mean |plain| per head " + ", ".join(
            f"{k} {v:.2e}" for k, v in d.items())
        + f" (bound 1e-2 each); decoded classes {'identical' if same_classes else 'differ'} "
        f"(slot agreement {agree:.4f}); predict median of 20 on {smi}: fp (BN folded) "
        f"{lat_fp:.3f} ms, int8 (fused, chained) {lat_q:.3f} ms")
    if not all(v <= 1e-2 for v in d.values()):
        raise AssertionError(f"3D: int8 posture through K2 disagrees with its plain version {d}")
    if not same_classes:
        raise AssertionError(f"3D: decoded classes differ between K2 and its plain version "
                             f"(agreement {agree})")
    del model, pipe_fp, pipe_q
    torch.cuda.empty_cache()
    return counts[0], dict(fp=lat_fp, int8=lat_q)


def phase_3d_train(workdir, smi):
    """``cli.train --with_3d true`` on the flagship recipe: 20 steps, an
    eval at 10 and 20 (3D metrics), one K1 launch per step."""
    import torch

    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    t0 = time.perf_counter()
    gs.reset_counts()
    train_main(TRAIN_FLAGS + TRAIN3D_FLAGS + ["--workdir", workdir])  # main path: 3D training
    torch.cuda.synchronize()
    launches = gs.render_heatmap.launches
    rows = read_metrics(os.path.join(workdir, "metrics.jsonl"))
    train = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "val_mAP" in r]
    losses = [r["loss"] for r in train]
    step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in train[5:])
    log(f"[3d-train] flagship recipe + 3D heads, 20 steps on {smi} in "
        f"{time.perf_counter() - t0:.1f} s: {launches} K1 launches; loss first 5 "
        f"{np.round(losses[:5], 4).tolist()}, last 5 {np.round(losses[-5:], 4).tolist()} (3D "
        f"terms last: dep {train[-1]['loss_dep3d']:.4f}, dim {train[-1]['loss_dim3d']:.4f}, "
        f"rot {train[-1]['loss_rot']:.4f}); median {step_ms:.3f} ms/step (host clock, a sync "
        f"per step, steps 6-20); " + "; ".join(
            f"step {r['step']}: val_mAP {r['val_mAP']:.4f}, center_err_3d_m "
            f"{r['val_center_err_3d_m']:.4f}, depth3d_abs_rel {r['val_depth3d_abs_rel']:.4f}, "
            f"matched_3d_frac {r['val_matched_3d_frac']:.4f}" for r in evals))
    if [r["step"] for r in train] != list(range(1, 21)) or launches != 20:
        raise AssertionError(f"3D training: steps {[r['step'] for r in train]}, K1 launches "
                             f"{launches} (expected 1-20 and 20)")
    if not all(np.isfinite(r[k]) for r in train for k in ("loss", "grad_norm", "loss_dep3d")):
        raise AssertionError("3D training: non-finite loss")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"3D training: loss did not fall: {losses}")
    keys = ("val_mAP", "val_center_err_3d_m", "val_depth3d_abs_rel", "val_matched_3d_frac")
    if [r["step"] for r in evals] != [10, 20] or not all(
            np.isfinite(r[k]) for r in evals for k in keys):
        raise AssertionError(f"3D training: evals {evals}")
    return launches, step_ms


def _export_and_serve(tag, model_name, ckdir, art, quantize, fmt, eager, batch, smi):
    """cli.export into ``art``, served by ServingModel on the card: its
    selftest, its outputs against ``eager`` (the same posture's pipeline),
    K2's launches per call."""
    import torch

    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.infer.selftest import compare, fingerprint
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    t0 = time.perf_counter()
    export_main(["--model", model_name, "--checkpoint_dir", ckdir, "--out", art, "--quantize",
                 quantize, "--input_format", fmt, "--batch_size", str(B), "--device", "cuda"])
    t_export = time.perf_counter() - t0
    sm = ServingModel(art, device="cuda")
    problems = sm.selftest()
    data = [batch[k] for k in sm.keys]
    fq.reset_counts()
    passes = DMDS_PASSES if model_name == "dmds" else 1
    frames = passes if fmt == "yuv420" else 0  # a DMDS pass preprocesses each frame
    got = epilogue_launches(f"{tag} {quantize} artifact", eager.folded_counts, passes,
                            lambda: letterbox_launches(f"{tag} {quantize} {fmt} artifact",
                                                       frames, lambda: sm(*data)))  # a main path
    launches = fq.fused_qconv.launches
    want = eager(batch)
    diff = compare(fingerprint(want), fingerprint(got))
    exact = [k for k in got if torch.equal(got[k], want[k])]
    t_art = host_ms(lambda: sm(*data))
    log(f"[{tag}] export {quantize} ({fmt}) in {t_export:.1f} s; selftest {problems or 'ok'}; "
        f"vs eager: {diff or 'within tolerance'}, identical outputs {exact}; K2 launches per "
        f"batch-{B} call {launches}; artifact predict median of 20 on {smi}: {t_art:.3f} ms "
        "(host numpy in)")
    if problems or diff:
        raise AssertionError(f"{tag} {quantize}: selftest {problems}, vs eager {diff}")
    return launches, exact, t_art


def phase_3d_export(dev, workdir, smi):
    """Phase 19's run exported in ``none`` and ``w8a8_fused`` (yuv420, with
    intrinsics), each artifact served on the card against its eager
    pipeline."""
    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.loop import Trainer

    ckdir = os.path.join(workdir, "checkpoints")
    cfg = load_params_cfg(ckdir, CenternetParams)
    trainer = Trainer(cfg, dev, checkpoint_dir=ckdir)
    trainer.init_state()
    model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)
    pad = (int(cfg.input_hw[0] * 1.5) // 2 * 2, int(cfg.input_hw[1] * 1.5) // 2 * 2)
    batch = synthetic_batch(np.random.default_rng(4), B, pad, num_classes=10, with_3d=True,
                            yuv420=True)
    launches = {}
    for q in ("none", "w8a8_fused"):
        kw = dict(fold_bn=True) if q == "none" else dict(
            w8a8=calibration_scales(cfg, model, pad, 3, B, dev), w8a8_fused=True)
        eager = InferencePipeline(cfg.replace(batch_size=B), model, dev, **kw)
        launches[q], exact, t_art = _export_and_serve(
            "3d-export", "centernet", ckdir, os.path.join(workdir, f"art_{q}"), q, "yuv420",
            eager, batch, smi)
        if q != "none" and not {"boxes", "classes"} <= set(exact):
            raise AssertionError(f"3D {q}: artifact boxes or classes differ from the eager "
                                 "pipeline")
        want = THREE_D_K2 if q == "w8a8_fused" else 0
        if launches[q] != want:
            raise AssertionError(f"3D {q}: expected {want} K2 launches per call, got "
                                 f"{launches[q]}")
    return launches


def pose_recovery(dev):
    """The reference's pose-recovery property on ``dev``: depth held at the
    truth, Adam(0.05) on the photometric loss over the translation, 300
    steps -> (first loss, last loss, max |t - t_true|)."""
    import torch

    from cvm_tpu_torch.data.synthetic import _bilinear_np
    from cvm_tpu_torch.models.dmds.loss import photometric_loss
    from cvm_tpu_torch.ops.warp import warp_frame

    H, W, Z, fx, shift = 32, 64, 10.0, 32.0, 4
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (H // 4, (W + 2 * shift) // 4, 3)).astype(np.uint8)
    yy, xx = np.meshgrid(np.linspace(0.0, H // 4 - 1.0, H, dtype=np.float32),
                         np.linspace(0.0, (W + 2 * shift) // 4 - 1.0, W + 2 * shift,
                                     dtype=np.float32), indexing="ij")
    big = torch.from_numpy(_bilinear_np(base, xx, yy).astype(np.float32) / 255.0).to(dev)
    img_a, img_b = big[None, :, shift:shift + W], big[None, :, :W]
    depth = torch.full((1, H, W, 1), Z, device=dev)
    intr = torch.tensor([[fx, fx, W / 2.0, H / 2.0]], device=dev)
    t_true = torch.tensor([[shift * Z / fx, 0.0, 0.0]], device=dev)
    t = torch.zeros(1, 3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([t], lr=0.05)
    losses = []
    for _ in range(301):
        w = warp_frame(img_b, depth, torch.zeros(1, 3, device=dev), t, intr)
        loss = photometric_loss(img_a, w.warped, w.valid, alpha=0.5)
        losses.append(loss.detach())
        opt.zero_grad()
        loss.backward()
        opt.step()
    return float(losses[0]), float(losses[300]), float((t.detach() - t_true).abs().max())


def phase_dmds(dev, workdir, smi):
    """DMDS (config E): pose recovery on the card; cli.train 20 steps at
    192x640 batch 8 with an eval; one two-frame batch-8 request served in
    fp; cli.benchmark --configs E; a ``none`` export served."""
    import contextlib
    import io

    import torch

    from cvm_tpu_torch.cli import benchmark
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.dmds.params import DmdsParams
    from cvm_tpu_torch.train.checkpoints import load_params_cfg
    from cvm_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    first, last, err = pose_recovery(dev)
    log(f"[dmds] pose recovery on the card (Adam 0.05, 300 steps): loss {first:.5f} -> "
        f"{last:.5f} ({last / first:.2%} of its start; bound 5%), max |t - t_true| {err:.4f} "
        f"(bound 0.1), {time.perf_counter() - t0:.1f} s")
    if not (last < 0.05 * first and err < 0.1):
        raise AssertionError(f"dmds pose recovery: loss {first} -> {last}, error {err}")

    # The host's share of a step: one batch of two-frame scenes (the
    # training loader makes one per step, in the training thread).
    pad = tuple(int(v * 1.5) for v in DmdsParams().input_hw)  # cli.train's default
    t0 = time.perf_counter()
    synthetic_batch(np.random.default_rng(0), B, pad, num_classes=10, two_frame=True)
    scenes_ms = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    train_main(DMDS_TRAIN_FLAGS + ["--workdir", workdir])  # main path: DMDS training
    torch.cuda.synchronize()
    rows = read_metrics(os.path.join(workdir, "metrics.jsonl"))
    train = [r for r in rows if "loss" in r]
    evals = [r for r in rows if "val_abs_rel" in r]
    step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in train[5:])
    log(f"[dmds] cli.train 20 steps (B8, 192x640, small, motion_features 128, object motion) "
        f"on {smi} in {time.perf_counter() - t0:.1f} s: loss {train[0]['loss']:.4f} -> "
        f"{train[-1]['loss']:.4f} (photo {train[-1]['loss_photo']:.4f}); median {step_ms:.3f} "
        f"ms/step (host clock, a sync per step, steps 6-20; one batch of two-frame scenes "
        f"takes {scenes_ms:.1f} ms of the host); " + "; ".join(
            f"step {r['step']}: val_abs_rel {r['val_abs_rel']:.4f}, val_delta1 "
            f"{r['val_delta1']:.4f} (median-scaled), {r['eval_seconds']:.2f} s" for r in evals))
    if [r["step"] for r in train] != list(range(1, 21)) or not all(
            np.isfinite(r[k]) for r in train for k in ("loss", "grad_norm", "loss_photo")):
        raise AssertionError(f"dmds training: steps or losses {train}")
    if [r["step"] for r in evals] != [20] or not all(
            np.isfinite(evals[0][k]) for k in ("val_abs_rel", "val_delta1")):
        raise AssertionError(f"dmds training: evals {evals}")

    ckdir = os.path.join(workdir, "checkpoints")
    cfg = load_params_cfg(ckdir, DmdsParams)
    trainer = Trainer(cfg, dev, checkpoint_dir=ckdir)
    trainer.init_state()
    model = trainer.eval_model(use_ema=cfg.ema_decay > 0.0)
    pad = (int(cfg.input_hw[0] * 1.5) // 2 * 2, int(cfg.input_hw[1] * 1.5) // 2 * 2)
    batch = synthetic_batch(np.random.default_rng(5), B, pad, num_classes=10, two_frame=True)
    pipe = InferencePipeline(cfg.replace(batch_size=B), model, dev, input_format="rgb",
                             fold_bn=True)
    out = epilogue_launches("phase 21 DMDS fp", pipe.folded_counts, DMDS_PASSES,
                            lambda: pipe(batch))
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != {"depth": (B, *cfg.input_hw, 1), "rotation": (B, 3), "translation": (B, 3)} \
            or not all(torch.isfinite(v).all() for v in out.values()):
        raise AssertionError(f"dmds serving: {shapes}")
    data = [torch.from_numpy(batch[k]).to(dev) for k in pipe.keys]
    lat = epilogue_launches("phase 21 DMDS fp latency", pipe.folded_counts,
                            DMDS_PASSES * HOST_MS_CALLS,
                            lambda: host_ms(lambda: pipe.predict(*data)))
    # the same model on YUV420 planes: each frame through the letterbox kernel
    yuv = synthetic_batch(np.random.default_rng(6), B, pad, num_classes=10, two_frame=True,
                          yuv420=True)
    pipe_yuv = InferencePipeline(cfg.replace(batch_size=B), model, dev, input_format="yuv420",
                                 fold_bn=True)
    out_yuv = epilogue_launches("phase 21 DMDS yuv420 fp", pipe_yuv.folded_counts, DMDS_PASSES,
                                lambda: letterbox_launches("phase 21 DMDS yuv420 fp", 2,
                                                           lambda: pipe_yuv(yuv)))
    if {k: tuple(v.shape) for k, v in out_yuv.items()} != shapes \
            or not all(torch.isfinite(v).all() for v in out_yuv.values()):
        raise AssertionError(f"dmds yuv420 serving: {out_yuv.keys()}")
    log(f"[dmds] two-frame batch-8 request, fp (BN folded): {shapes}; depth "
        f"{float(out['depth'].min()):.3f}..{float(out['depth'].max()):.3f} m; predict median of "
        f"20 on {smi}: {lat:.3f} ms; yuv420 planes: the letterbox kernel once per frame")

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        benchmark.main(["--configs", "E", "--iters", "6"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    log(f"[dmds] cli.benchmark in {time.perf_counter() - t0:.1f} s: {json.dumps(lines)}")
    if [r["config"] for r in lines] != ["E"] or not (lines[0]["steps_per_sec"] > 0
                                                    and "mfu_pct" in lines[0]):
        raise AssertionError(f"cli.benchmark --configs E: {lines}")

    _, exact, t_art = _export_and_serve("dmds", "dmds", ckdir, os.path.join(workdir, "art_none"),
                                        "none", "rgb", pipe, batch, smi)
    return dict(step_ms=step_ms, scenes_ms=scenes_ms, predict_ms=lat, artifact_ms=t_art,
                bench=lines[0])


# Phases 22-24: the record path at config B's width (the fixture's frames,
# replicated into a shard of 80 records: 72 train, 8 val).
K2_PER_FORWARD = 24  # fused_qconv launches per config-B int8 forward
RECORD_FLAGS = ["--model", "centernet", "--batch_size", str(B), "--warmup_steps", "5",
                "--total_steps", "5000", "--log_every", "1", "--checkpoint_every", "20",
                "--seed", "0"]


def _pad_flag():
    return ["--pad_hw", f"{PAD_HW[0]},{PAD_HW[1]}"]


def _median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median host-clock time of ``fn()`` (host work: the decoder returns
    once its frames are in host memory)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_decode(dev, smi):
    """Phase 22: the fixture decoded on the card's machine against the
    reference decoder's recorded output; decode and loader stage times."""
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420
    from cvm_tpu_torch.data.loader import RecordLoader
    from cvm_tpu_torch.data.records import RecordDataset

    res = fixture_decode_check(dev)
    log(f"[decode] fixture vs the reference decoder, case {res.pop('case')}: "
        f"{json.dumps(res)}")
    jpegs, _ = fixture_jpegs()
    times = {}
    for threads in (1, 4):
        times[f"rgb t{threads}"] = _median_ms(
            lambda: decode_jpeg_batch(jpegs, *PAD_HW, threads, device=dev))
        times[f"yuv420 t{threads}"] = _median_ms(
            lambda: decode_jpeg_batch_yuv420(jpegs, *PAD_HW, threads, device=dev))
    stats = {}
    for fmt in ("yuv420", "rgb"):
        loader = RecordLoader(RecordDataset([os.path.join(FIXTURE_DIR, "scenes.cvrec")]), B,
                              PAD_HW, output_format=fmt, device=dev)
        it = iter(loader)
        try:
            for _ in range(12):
                next(it)
        finally:
            it.close()
        stats[fmt] = {k: round(v, 3) for k, v in loader.stats().items()}
    log(f"[decode] batch of {B} fixture JPEGs into {PAD_HW[0]}^2 on {smi}, median of 10 "
        f"(ms, host clock): " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    log(f"[decode] RecordLoader.stats() over 12 batches of {B} (ms per batch): {stats}")
    return res, times, stats


def make_record_shard(path, copies: int = 10) -> int:
    """The fixture's records, ``copies`` times over (new ids), into one shard."""
    from cvm_tpu_torch.data.records import RecordDataset, RecordWriter

    ds = RecordDataset([os.path.join(FIXTURE_DIR, "scenes.cvrec")])
    with RecordWriter(path) as w:
        for c in range(copies):
            for i in range(len(ds)):
                meta, blobs = ds.get(i)
                w.write(dict(meta, id=f"{meta['id']}-{c}"), dict(blobs))
    return copies * len(ds)


def phase_record_train(dev, workdir, shard, smi):
    """Phase 23: cli.train from records at config B (20 steps, one eval of
    the val split), then cli.evaluate --data on the checkpoint."""
    from cvm_tpu_torch.cli.evaluate import main as eval_main
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.data.records import RecordDataset
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    train_ids, val_ids = RecordDataset([shard]).split_ids()
    if not (len(val_ids) >= B and len(train_ids) > B):
        raise AssertionError(f"split {len(train_ids)}/{len(val_ids)} cannot feed batch {B}")
    t0 = time.perf_counter()
    gs.reset_counts()
    train_main(RECORD_FLAGS + _pad_flag() + ["--data", shard, "--workdir", workdir, "--device",
                                             str(dev), "--steps", "20", "--eval_every", "20",
                                             "--eval_batches", "1"])
    launches = gs.render_heatmap.launches
    rows = read_metrics(os.path.join(workdir, "metrics.jsonl"))
    steps = [r for r in rows if "loss" in r]
    losses = [r["loss"] for r in steps]
    val = [r for r in rows if "val_mAP" in r]
    step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in steps[5:])
    log(f"[records-train] 20 config-B steps from {len(train_ids)} train records in "
        f"{time.perf_counter() - t0:.1f} s: {launches} K1 launches; loss first 3 "
        f"{np.round(losses[:3], 4).tolist()}, last 3 {np.round(losses[-3:], 4).tolist()}; "
        f"median {step_ms:.3f} ms/step on {smi} (steps 6-20); val split eval "
        f"{ {k: round(v, 4) for k, v in val[-1].items() if k.startswith('val_')} }")
    if [r["step"] for r in steps] != list(range(1, 21)) or len(val) != 1:
        raise AssertionError(f"expected 20 logged steps and one eval, got {rows}")
    if not all(np.isfinite(r[k]) for r in steps for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or grad_norm")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        raise AssertionError(f"loss did not fall: {losses}")
    if launches != 20:
        raise AssertionError(f"expected one K1 launch per step (20), got {launches}")
    out = os.path.join(workdir, "eval.json")
    t0 = time.perf_counter()
    eval_main(["--model", "centernet", "--workdir", workdir, "--data", shard, "--split", "val",
               "--device", str(dev), "--json_out", out] + _pad_flag())
    with open(out) as f:
        m = json.load(f)
    log(f"[records-eval] cli.evaluate --data (val split, {len(val_ids)} records) in "
        f"{time.perf_counter() - t0:.1f} s: mAP {m['mAP']:.4f}, mAP50 {m['mAP50']:.4f} "
        "(20 steps from a random init: a plumbing check, not an accuracy claim)")
    if m["step"] != 20 or not all(np.isfinite(m[k]) for k in ("mAP", "mAP50", "mAP75")):
        raise AssertionError(f"cli.evaluate --data: {m}")
    return launches, step_ms, val[-1], m


def phase_record_serve(dev, workdir, shard, smi):
    """Phase 24: a config-B w8a8_fused_chain artifact (planar YUV420, 768^2,
    bucket 8) serving the shard through cli.serve --records, then 16
    concurrent HTTP requests through ModelServer."""
    import contextlib
    import io
    import urllib.request

    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.cli.serve import main as serve_main
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch_yuv420
    from cvm_tpu_torch.data.loader import RecordLoader
    from cvm_tpu_torch.data.records import RecordDataset
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.infer.server import result_record, server_for_artifact
    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.train.loop import Trainer

    ckdir, art = os.path.join(workdir, "checkpoints"), os.path.join(workdir, "art")
    t0 = time.perf_counter()
    export_main(["--model", "centernet", "--checkpoint_dir", ckdir, "--out", art,
                 "--quantize", "w8a8_fused_chain", "--input_format", "yuv420", "--batch_size",
                 str(B), "--device", str(dev)] + _pad_flag())
    t_export = time.perf_counter() - t0
    sm = ServingModel(art, device=dev)
    # the artifact's eager twin: the same checkpoint, posture and calibration
    tr = Trainer(get_model("centernet").params_cls.from_dict(sm.meta["params_cfg"]), dev,
                 checkpoint_dir=ckdir)
    tr.init_state()
    model = tr.eval_model()
    eager = InferencePipeline(tr.cfg, model, dev, input_format="yuv420",
                              w8a8=calibration_scales(tr.cfg, model, PAD_HW, 3, B, dev),
                              w8a8_fused=True, w8a8_chain=True)

    n_batches = 3
    buf = io.StringIO()
    fq.reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):      # a main path: cli.serve --records
        serve_main(["--artifact", art, "--records", shard, "--device", str(dev),
                    "--max_batches", str(n_batches), "--score_threshold", "0.0"])
    t_serve = time.perf_counter() - t0
    records_launches = fq.fused_qconv.launches
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    loader = RecordLoader(RecordDataset([shard]), B, PAD_HW, shuffle=False, loop=False,
                          output_format="yuv420", drop_remainder=False, device=dev)
    want = []
    for k, b in enumerate(loader):
        if k == n_batches:
            break
        out = {key: v.cpu().numpy() for key, v in eager(b).items()}
        want += [result_record(out, i, 0.0) for i in range(B)]
    names = [line.pop("input") for line in lines]
    same = sum(json.dumps(a) == json.dumps(b) for a, b in zip(lines, want))
    log(f"[serve-records] export w8a8_fused_chain (yuv420, {PAD_HW[0]}^2, bucket {B}) in "
        f"{t_export:.1f} s; cli.serve --records: {len(lines)} lines ({names[0]}..{names[-1]}) "
        f"in {t_serve:.1f} s, {records_launches} K2 launches for {n_batches} batch-{B} calls, "
        f"{same}/{len(want)} lines equal to the eager pipeline's")
    if records_launches != K2_PER_FORWARD * n_batches:
        raise AssertionError(f"expected {K2_PER_FORWARD} K2 launches per batch-{B} call, got "
                             f"{records_launches} for {n_batches}")
    if len(lines) != len(want) or same != len(want):
        raise AssertionError(f"cli.serve --records: {same}/{len(want)} lines equal")

    jpegs, _ = fixture_jpegs()
    bodies = (jpegs * 2)[:16]
    server = server_for_artifact(sm, max_wait_ms=50.0, score_threshold=0.0)
    ready, port = threading.Event(), []
    thread = threading.Thread(target=server.serve_forever, daemon=True, kwargs=dict(
        host="127.0.0.1", port=0, ready_cb=lambda p: (port.append(p), ready.set())))
    thread.start()
    try:
        if not ready.wait(60):
            raise AssertionError("ModelServer did not bind")
        url = f"http://127.0.0.1:{port[0]}"
        t0 = time.perf_counter()
        while not server.warm.is_set():
            if time.perf_counter() - t0 > 300:
                raise AssertionError("ModelServer never went warm")
            time.sleep(0.05)
        batches0 = server.batcher.n_batches
        fq.reset_counts()
        results = [None] * len(bodies)

        def client(i):
            req = urllib.request.Request(f"{url}/predict", data=bodies[i], method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = (r.status, json.loads(r.read()))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        t_http = time.perf_counter() - t0
        http_launches = fq.fused_qconv.launches
        dispatched = server.batcher.n_batches - batches0
        with urllib.request.urlopen(f"{url}/stats", timeout=60) as r:
            st = json.loads(r.read())
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if any(t.is_alive() for t in threads) or any(r is None or r[0] != 200 for r in results):
        raise AssertionError(f"HTTP: unanswered or failed requests {results}")
    worst = 0.0
    for body, (_, rec) in zip(bodies, results):
        planes = decode_jpeg_batch_yuv420([body], *PAD_HW, device=dev)
        direct = result_record({k: v.cpu().numpy() for k, v in sm(*planes).items()}, 0, 0.0)
        if rec["classes"] != direct["classes"]:
            raise AssertionError("HTTP: classes differ from a direct ServingModel call")
        worst = max(worst, float(np.abs(np.asarray(rec["boxes"]) -
                                        np.asarray(direct["boxes"])).max(initial=0.0)))
    log(f"[serve-http] 16 concurrent POSTs of fixture JPEGs answered in {t_http:.2f} s: "
        f"{dispatched} batches, {http_launches} K2 launches, fill {st['batch_fill']}, latency "
        f"p50 {st['latency_ms'].get('p50')} ms p90 {st['latency_ms'].get('p90')} ms, model "
        f"p50 {st['model_ms'].get('p50')} ms on {smi}; classes equal to direct ServingModel "
        f"calls, max |d box| {worst:.3e} px")
    if http_launches != K2_PER_FORWARD * dispatched:
        raise AssertionError(f"expected {K2_PER_FORWARD} K2 launches per dispatched batch, got "
                             f"{http_launches} for {dispatched}")
    if worst > 1e-3:
        raise AssertionError(f"HTTP boxes differ from direct calls by {worst} px")
    return records_launches, http_launches, st


# Phases 25-27: the data tools and offline inference on a COCO-layout tree
# (COCO's 80 category ids, gaps included; the names of data/label_spec.py).
COCO_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
COCO_IMAGES = 64
COCO_TRAIN_FLAGS = ["--model", "centernet", "--batch_size", str(B), "--warmup_steps", "5",
                    "--total_steps", "5000", "--log_every", "1", "--checkpoint_every", "20",
                    "--seed", "0", "--steps", "20", "--eval_every", "0"]


def write_coco_tree(root: str, n: int, seed: int = 0) -> dict:
    """A COCO-layout tree, ``annotations/instances_val2017.json`` and
    ``val2017/``: ``n`` synthetic scenes (``data/synthetic.py``: 10 classes,
    each labelled with every 8th of COCO's 80, up to 12 objects) at 640x480
    and 480x640, as quality-90 4:2:0 JPEGs,
    six as PNGs and two as 4:4:0 JPEGs (a 240x1280 scene encoded 4:2:2 and
    re-declared, ``relayout_jpeg``: 479x639, each MCU's content at the same
    grid place, so its boxes are the scene's scaled by (1/2, 2)). Returns
    the annotation file's per-class box counts, the files and their sizes."""
    import io

    from PIL import Image

    from cvm_tpu_torch.data.label_spec import COCO_CLASSES
    from cvm_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "val2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, anns, counts, files = [], [], {}, {}
    for i in range(n):
        kind = "png" if i % 10 == 3 and i < 60 else ("440" if i in (5, 37) else "jpg")
        name = f"{i:012d}." + ("png" if kind == "png" else "jpg")
        path = os.path.join(root, "val2017", name)
        if kind == "440":
            s = synthetic_sample(rng, (240, 1280), num_classes=10, max_objects=12)
            buf = io.BytesIO()
            Image.fromarray(s["image"]).save(buf, format="JPEG", quality=90, subsampling=1)
            with open(path, "wb") as f:
                f.write(relayout_jpeg(buf.getvalue(), "4:4:0"))
            h, w, scale = 479, 639, np.float32([0.5, 2.0, 0.5, 2.0])
        else:
            h, w = (480, 640) if i % 2 == 0 else (640, 480)
            s = synthetic_sample(rng, (h, w), num_classes=10, max_objects=12)
            Image.fromarray(s["image"]).save(path, quality=90)
            scale = np.float32([1, 1, 1, 1])
        images.append({"id": 1000 + i, "file_name": name, "height": h, "width": w})
        files[path] = (h, w)
        for k in range(int(s["num_objects"])):
            x0, y0, x1, y1 = (float(v) for v in s["boxes"][k] * scale)
            c = 8 * int(s["classes"][k])
            anns.append({"id": len(anns) + 1, "image_id": 1000 + i,
                         "category_id": COCO_IDS[c], "bbox": [x0, y0, x1 - x0, y1 - y0],
                         "area": (x1 - x0) * (y1 - y0), "iscrowd": 0})
            counts[c] = counts.get(c, 0) + int((x1 - x0) * (y1 - y0) >= 4.0)
    cats = [{"id": cid, "name": COCO_CLASSES[j], "supercategory": "none"}
            for j, cid in enumerate(COCO_IDS)]
    with open(os.path.join(root, "annotations", "instances_val2017.json"), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return {"counts": {str(k): v for k, v in sorted(counts.items()) if v}, "files": files}


def _cli(main, argv):
    """(exit code, stdout lines, stderr) of an in-process CLI ``main``."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue().splitlines(), err.getvalue()


def phase_pack(dev, root, smi):
    """Phase 25: a COCO-layout tree through cli.pack, cli.validate (sample
    decode on the card), cli.stats, cli.inspect and cli.repack (on the
    card); the repacked planes against the card's decode of the same bytes;
    the 4:4:0 files against PIL within the IDCT gap."""
    import io

    from PIL import Image

    from cvm_tpu_torch.cli import inspect, pack, repack, stats, validate
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch, decode_jpeg_batch_yuv420
    from cvm_tpu_torch.data.records import RecordDataset

    t0 = time.perf_counter()
    tree = write_coco_tree(os.path.join(root, "coco"), COCO_IMAGES)
    secs = {"tree": time.perf_counter() - t0}
    shard, yuv = os.path.join(root, "coco.cvrec"), os.path.join(root, "coco_yuv.cvrec")
    steps = [
        ("pack", pack.main, ["--dataset", "coco", "--src", os.path.join(root, "coco"),
                             "--split", "val2017", "--out", shard]),
        ("validate", validate.main, ["--data", shard, "--sample_decode", str(COCO_IMAGES),
                                     "--device", str(dev)]),
        ("stats", stats.main, ["--data", shard, "--json"]),
        ("inspect", inspect.main, ["--data", shard, "--out", os.path.join(root, "inspect"),
                                   "--num", "4"]),
        ("repack", repack.main, ["--src", shard, "--out", yuv, "--device", str(dev)]),
    ]
    res = {}
    for name, main, argv in steps:
        t0 = time.perf_counter()
        rc, lines, err = _cli(main, argv)
        secs[name] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"cli.{name} exited {rc}: {lines[-3:]} {err[-2000:]}")
        res[name] = json.loads(lines[-1])
    if res["pack"] != {"written": COCO_IMAGES, "skipped": 0, "num_classes": 80}:
        raise AssertionError(f"cli.pack: {res['pack']}")
    if res["validate"]["errors"] or res["validate"]["sample_decoded_ok"] != COCO_IMAGES:
        raise AssertionError(f"cli.validate: {res['validate']}")
    if res["stats"]["box_classes"] != tree["counts"]:
        raise AssertionError(f"cli.stats class counts {res['stats']['box_classes']} != the "
                             f"annotation file's {tree['counts']}")
    pngs = [f for f in os.listdir(os.path.join(root, "inspect")) if f.endswith(".png")]
    if res["inspect"]["rendered"] != 4 or len(pngs) != 4:
        raise AssertionError(f"cli.inspect: {res['inspect']}, {pngs}")
    if res["repack"]["written"] != COCO_IMAGES or res["repack"]["failed"]:
        raise AssertionError(f"cli.repack: {res['repack']}")
    src, planes = RecordDataset([shard]), RecordDataset([yuv])
    for i in range(len(src)):
        meta, blobs = src.get(i)
        h, w = meta["height"], meta["width"]
        Y, U, V, hw = decode_jpeg_batch_yuv420([blobs["jpeg"]], h + h % 2, w + w % 2,
                                               device=dev)
        dh, dw = h - h % 2, w - w % 2
        got = planes.get(i)[1]
        for k, want in (("y", Y[0, :dh, :dw]), ("u", U[0, :dh // 2, :dw // 2]),
                        ("v", V[0, :dh // 2, :dw // 2])):
            if not np.array_equal(got[k], want):
                raise AssertionError(f"repacked {k} plane of record {i} differs from the "
                                     "card's decode of its JPEG")
    gaps = {}
    for path, (h, w) in tree["files"].items():
        with open(path, "rb") as f:
            data = f.read()
        if (h, w) != (479, 639):
            continue
        rgb, _ = decode_jpeg_batch([data], h, w, device=dev)
        d = np.abs(rgb[0].astype(int) - np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        gaps[os.path.basename(path)] = (round(float(d.mean()), 4), int(d.max()))
        if d.mean() > IDCT_GAP["rgb"]["mean_abs"] or d.max() > IDCT_GAP["rgb"]["max_abs"]:
            raise AssertionError(f"4:4:0 {path}: {gaps} beyond the IDCT gap {IDCT_GAP}")
    log(f"[pack] {COCO_IMAGES} COCO-layout images (6 PNG, 2 4:4:0): pack {res['pack']}; "
        f"validate 0 errors, {res['validate']['sample_decoded_ok']} decoded on the card; "
        f"stats {res['stats']['boxes_total']} boxes in {len(tree['counts'])} classes = the "
        f"annotation file's; inspect 4 PNGs; repack {res['repack']} (planes = the card's "
        f"decode); 4:4:0 vs PIL (mean, max |d|) {gaps}; seconds on {smi}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()))
    return shard, tree, secs


def phase_coco_train(dev, workdir, shard, smi):
    """Phase 26: cli.train --data on the packed COCO shard at config B
    (512^2, small, 80 classes, batch 8), 20 steps."""
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    t0 = time.perf_counter()
    gs.reset_counts()
    train_main(COCO_TRAIN_FLAGS + _pad_flag() + ["--data", shard, "--workdir", workdir,
                                                 "--device", str(dev)])
    launches = gs.render_heatmap.launches
    steps = [r for r in read_metrics(os.path.join(workdir, "metrics.jsonl")) if "loss" in r]
    losses = [r["loss"] for r in steps]
    step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in steps[5:])
    log(f"[coco-train] 20 config-B steps (80 classes, batch {B}) from the packed COCO shard in "
        f"{time.perf_counter() - t0:.1f} s: {launches} K1 launches; loss first 3 "
        f"{np.round(losses[:3], 4).tolist()}, last 3 {np.round(losses[-3:], 4).tolist()}; "
        f"median {step_ms:.3f} ms/step on {smi} (steps 6-20)")
    if [r["step"] for r in steps] != list(range(1, 21)):
        raise AssertionError(f"expected 20 logged steps, got {[r['step'] for r in steps]}")
    if not all(np.isfinite(r[k]) for r in steps for k in ("loss", "grad_norm")):
        raise AssertionError("non-finite loss or grad_norm")
    if launches != 20:
        raise AssertionError(f"expected one K1 launch per step (20), got {launches}")
    return launches, step_ms


def phase_infer(dev, workdir, shard, tree, smi):
    """Phase 27: that checkpoint exported (rgb, w8a8_fused_chain, batch 8)
    and run by cli.infer --artifact over the tree's images with
    --visualize; every JSON line against the eager pipeline of the same
    posture on the same decoded batch; then cli.infer --checkpoint_dir in
    fp, with --w8a8 and over --records."""
    from PIL import Image

    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.cli.infer import main as infer_main
    from cvm_tpu_torch.data.images import read_image_as_jpeg
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.models.registry import get_model
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.train.loop import Trainer

    ckdir, art = os.path.join(workdir, "checkpoints"), os.path.join(workdir, "art_rgb")
    vis = os.path.join(workdir, "vis")
    images = os.path.join(os.path.dirname(next(iter(tree["files"]))), "*")
    t0 = time.perf_counter()
    rc = export_main(["--model", "centernet", "--checkpoint_dir", ckdir, "--out", art,
                      "--input_format", "rgb", "--quantize", "w8a8_fused_chain",
                      "--batch_size", str(B), "--device", str(dev)] + _pad_flag())
    t_export = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli.export exited {rc}")
    fq.reset_counts()
    rc, lines, err = _cli(infer_main, ["--artifact", art, "--images", images, "--visualize", vis,
                                       "--score_threshold", "0", "--device", str(dev)])
    launches = fq.fused_qconv.launches
    if rc != 0:
        raise AssertionError(f"cli.infer --artifact exited {rc}: {err[-2000:]}")
    summary = {"artifact": json.loads(err.splitlines()[-1])}
    recs = [json.loads(x) for x in lines]
    n_batches = -(-COCO_IMAGES // B)
    if summary["artifact"]["batches"] != n_batches or launches != K2_PER_FORWARD * n_batches:
        raise AssertionError(f"cli.infer --artifact: {summary['artifact']}, {launches} K2 "
                             f"launches (expected {K2_PER_FORWARD} per batch-{B} call)")
    with open(os.path.join(art, "artifact.json")) as f:
        params_cfg = json.load(f)["params_cfg"]
    tr = Trainer(get_model("centernet").params_cls.from_dict(params_cfg), dev,
                 checkpoint_dir=ckdir)
    tr.init_state()
    model = tr.eval_model()
    eager = InferencePipeline(tr.cfg, model, dev, input_format="rgb",
                              w8a8=calibration_scales(tr.cfg, model, PAD_HW, 3, B, dev),
                              w8a8_fused=True, w8a8_chain=True)
    files = sorted(tree["files"])
    same = 0
    for s in range(0, len(files), B):
        jpegs = [read_image_as_jpeg(f)[0] for f in files[s:s + B]]
        img, hw = decode_jpeg_batch(jpegs, *PAD_HW, device=dev)
        out = {k: v.cpu().numpy() for k, v in eager({"image": img, "image_hw": hw}).items()}
        for i, rec in enumerate(recs[s:s + B]):
            want = {k: out[k][i].tolist() for k in ("boxes", "scores", "classes")}
            if rec["input"] != os.path.basename(files[s + i]):
                raise AssertionError(f"cli.infer line {s + i} is {rec['input']}")
            same += all(json.dumps(rec[k]) == json.dumps(want[k])
                        for k in ("boxes", "scores", "classes"))
    pngs = 0
    for f, (h, w) in tree["files"].items():
        png = os.path.join(vis, os.path.basename(f) + ".png")
        pngs += Image.open(png).size == (w, h)
    log(f"[infer] export rgb w8a8_fused_chain (bucket {B}) in {t_export:.1f} s; cli.infer "
        f"--artifact over {len(recs)} images: {summary['artifact']}, {launches} K2 launches, "
        f"{same}/{len(recs)} lines equal to the eager pipeline's, {pngs} PNGs at the source "
        f"sizes")
    if len(recs) != COCO_IMAGES or same != len(recs):
        raise AssertionError(f"cli.infer --artifact: {same}/{len(recs)} lines equal")
    if pngs != COCO_IMAGES:
        raise AssertionError(f"--visualize: {pngs}/{COCO_IMAGES} PNGs at the source size")
    for name, extra in (("fp", ["--images", images]), ("w8a8", ["--images", images, "--w8a8"]),
                        ("records", ["--records", shard])):
        fq.reset_counts()
        rc, lines, err = _cli(infer_main, ["--model", "centernet", "--checkpoint_dir", ckdir,
                                           "--device", str(dev)] + extra)
        if rc != 0:
            raise AssertionError(f"cli.infer --checkpoint_dir ({name}) exited {rc}: {err[-2000:]}")
        summary[name] = json.loads(err.splitlines()[-1])
        n = summary[name]["images"]
        if n != COCO_IMAGES or fq.fused_qconv.launches != 0:
            raise AssertionError(f"cli.infer {name}: {summary[name]}, "
                                 f"{fq.fused_qconv.launches} K2 launches (expected 0)")
    log(f"[infer] cli.infer ms per batch of {B} (host clock: decode excluded, predict and the "
        f"copy to the host) on {smi}: " + ", ".join(
            f"{k} {v['ms_per_batch_avg']}" for k, v in summary.items()))
    return launches, summary, art, files, recs


# Phases 28-33: the rest of the single-card surface at config B's width
# (512^2, small, 80 classes, batch 8, 768^2 synthetic scenes).
SYN_B_FLAGS = ["--model", "centernet", "--data", "synthetic", "--batch_size", str(B),
               "--warmup_steps", "5", "--total_steps", "5000", "--log_every", "1",
               "--seed", "0"]
WATCHDOG_THRESHOLD_S, WATCHDOG_HANG_S = 4, 20
HANG_CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "torch_hang_child.py")


def _child_lines(out: str, tag: str):
    return [line.split()[1:] for line in out.splitlines() if line.startswith(tag)]


def phase_watchdog(workdir, smi):
    """Phase 28: the stall watchdog on config-B training in a child process
    (``tests/torch_hang_child.py``, threshold 4 s, ``--auto_restart 1``'s
    Trainer): step 4 sleeps on the device for 20 s; the stall must be
    reported as the device's, re-exec'd once (AUTO-RESTART 1/1), and the
    new process image resume from the step-2 checkpoint and reach step 12.
    Then a second child, stopped (SIGSTOP) for 10 s mid-run and continued,
    must finish its 40 steps without a restart."""
    import signal

    env = dict(os.environ, CVM_STALL_THRESHOLD_S=str(WATCHDOG_THRESHOLD_S),
               CVM_HANG_S=str(WATCHDOG_HANG_S))
    env.pop("CVM_RESTART_COUNT", None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, HANG_CHILD, os.path.join(workdir, "hang"), "12",
                           "cuda", "B", "hang"], capture_output=True, text=True, env=env,
                          timeout=600)
    out, err = proc.stdout, proc.stderr
    if proc.returncode != 0:
        raise AssertionError(f"watchdog child exited {proc.returncode}:\n{out}\n{err[-3000:]}")
    hang = _child_lines(out, "HANGING")
    resumed = _child_lines(out, "RESUMED")
    firsts = _child_lines(out, "FIRST")
    done = _child_lines(out, "DONE")
    if "no training step completed on the device" not in err or "AUTO-RESTART 1/1" not in err:
        raise AssertionError(f"the stall was not reported as the device's and re-exec'd:\n{err}")
    if [r[0] for r in resumed] != ["0", "2"] or len(hang) != 1 or len(firsts) != 2:
        raise AssertionError(f"expected one stall, then a resume from step 2:\n{out}")
    if not done or done[-1][0] != "12":
        raise AssertionError(f"the resumed run did not reach step 12:\n{out}")
    exec_at = float(resumed[1][1])
    detect_s = exec_at - float(hang[0][0])
    first_s = float(firsts[1][0]) - exec_at
    k1 = int(done[-1][1])
    log(f"[watchdog] config-B child, threshold {WATCHDOG_THRESHOLD_S} s, device sleep "
        f"{WATCHDOG_HANG_S} s in step 4, on {smi}: stall reported as the device's, "
        f"AUTO-RESTART 1/1 {detect_s:.2f} s after the stalled step was enqueued; the new "
        f"image's first step done {first_s:.2f} s after the exec (python start, CUDA init, "
        f"model, a step); resumed at step 2, done at step 12 with {k1} K1 launches; "
        f"{time.perf_counter() - t0:.1f} s in all")
    if k1 != 10:
        raise AssertionError(f"expected 10 K1 launches after the resume, got {k1}")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, HANG_CHILD, os.path.join(workdir, "pause"), "40",
                             "cuda", "B", "pause"], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    first = threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("FIRST"):
                first.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        if not first.wait(300):
            raise AssertionError(f"the paused child never stepped:\n{''.join(lines)}")
        proc.send_signal(signal.SIGSTOP)
        time.sleep(10.0)
        proc.send_signal(signal.SIGCONT)
        rc = proc.wait(timeout=300)
        reader.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out = "".join(lines)
    done = _child_lines(out, "DONE")
    if rc != 0 or "AUTO-RESTART" in out or "looks stalled" in out or done[0][0] != "40":
        raise AssertionError(f"the stopped child restarted or failed (rc {rc}):\n{out}")
    log(f"[watchdog] a config-B child stopped for 10 s (SIGSTOP, SIGCONT) mid-run: no restart, "
        f"40 steps, {done[0][1]} K1 launches, {time.perf_counter() - t0:.1f} s")
    return k1 + int(done[0][1])


def phase_profile_nans(dev, workdir, smi):
    """Phase 29: ``cli.train --profile_steps 5`` on config B (5 warm-up
    steps, then 5 traced): the trace's five longest CUDA kernels by device
    time, K1 among the names; then ``--debug_nans`` on a run that a huge
    learning rate makes non-finite raises FloatingPointError at step 3."""
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    t0 = time.perf_counter()
    gs.reset_counts()
    rc = train_main(SYN_B_FLAGS + _pad_flag() + ["--steps", "10", "--profile_steps", "5",
                                                 "--checkpoint_every", "100", "--workdir",
                                                 os.path.join(workdir, "prof"),
                                                 "--device", str(dev)])
    launches = gs.render_heatmap.launches
    if rc != 0:
        raise AssertionError(f"cli.train --profile_steps exited {rc}")
    with open(os.path.join(workdir, "prof", "trace", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    splat = {n: d for n, d in by_name.items() if "gaussian_splat" in n}
    log(f"[profile] --profile_steps 5 on config B, {launches} K1 launches in 10 steps; the "
        f"trace's five longest CUDA kernels over 5 steps (device us) on {smi}: "
        + "; ".join(f"{n[:70]} {d:.1f}" for n, d in top)
        + f"; K1 {sorted(splat.items())} of {sum(by_name.values()):.1f} us in "
        f"{len(by_name)} kernels")
    if not splat or launches != 10:
        raise AssertionError(f"K1 not in the trace ({len(by_name)} kernels) or {launches} "
                             "launches (expected 10)")
    try:
        train_main(SYN_B_FLAGS + _pad_flag() + ["--steps", "6", "--debug_nans",
                                                "--warmup_steps", "1", "--lr_schedule",
                                                "constant", "--learning_rate", "1e30",
                                                "--checkpoint_every", "100", "--workdir",
                                                os.path.join(workdir, "nans"),
                                                "--device", str(dev)])
    except FloatingPointError as e:
        log(f"[debug_nans] raised as expected: {e}")
        if "step 3" not in str(e):
            raise AssertionError(f"--debug_nans named another step: {e}")
    else:
        raise AssertionError("--debug_nans let a non-finite run through")
    log(f"[profile] phase 29 took {time.perf_counter() - t0:.1f} s")
    return launches


def phase_tensorboard(dev, workdir, smi):
    """Phase 30: ``cli.train --tensorboard --eval_every 5 --eval_images 2``
    on config B, 10 steps: the event file, read back by the port's reader,
    holds every step's scalars, the evals' and two images per eval."""
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
    from cvm_tpu_torch.train.tensorboard import read_scalar_events

    t0 = time.perf_counter()
    wd = os.path.join(workdir, "tb_run")
    gs.reset_counts()
    rc = train_main(SYN_B_FLAGS + _pad_flag() + [
        "--steps", "10", "--eval_every", "5", "--eval_batches", "1", "--tensorboard",
        "--eval_images", "2", "--checkpoint_every", "100", "--workdir", wd,
        "--device", str(dev)])
    launches = gs.render_heatmap.launches
    if rc != 0:
        raise AssertionError(f"cli.train --tensorboard exited {rc}")
    (path,) = [os.path.join(wd, "tb", f) for f in os.listdir(os.path.join(wd, "tb"))]
    ev = read_scalar_events(path)
    steps = [e["step"] for e in ev if "loss" in e.get("scalars", {})]
    evals = [e["step"] for e in ev if "val_mAP" in e.get("scalars", {})]
    images = [(e["step"], tag, img["height"], img["width"]) for e in ev
              for tag, img in e.get("images", {}).items()]
    log(f"[tensorboard] {len(ev)} events in {os.path.basename(path)}: loss at steps {steps}, "
        f"val_mAP at {evals}, images {images}; {launches} K1 launches; "
        f"{time.perf_counter() - t0:.1f} s")
    if steps != list(range(1, 11)) or evals != [5, 10] or len(images) != 4 or launches != 10:
        raise AssertionError("the TensorBoard events miss scalars or images")
    return launches


def phase_lr_find_rotate(dev, workdir, smi):
    """Phase 31: ``cli.lr_find`` on config B (a 20-step sweep) prints a
    finite suggestion; config B trains 20 steps with ``--aug_rotate_deg
    15`` to a finite loss. K1's launches for both."""
    from cvm_tpu_torch.cli.lr_find import main as lr_main
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    t0 = time.perf_counter()
    gs.reset_counts()
    rc, lines, _ = _cli(lr_main, ["--model", "centernet", "--batch_size", str(B),
                                  "--num_steps", "20", "--lr_min", "1e-5", "--lr_max", "1.0",
                                  "--device", str(dev)] + _pad_flag())
    lr_k1 = gs.render_heatmap.launches
    res = json.loads(lines[-1]) if rc == 0 else {}
    log(f"[lr_find] 20-step sweep on config B on {smi}: {res}; {lr_k1} K1 launches; "
        f"{time.perf_counter() - t0:.1f} s")
    if rc != 0 or not np.isfinite(res["suggestion"]) or lr_k1 != res["steps_run"]:
        raise AssertionError(f"cli.lr_find: rc {rc}, {res}, {lr_k1} K1 launches")
    t0 = time.perf_counter()
    wd = os.path.join(workdir, "rot")
    gs.reset_counts()
    train_main(SYN_B_FLAGS + _pad_flag() + ["--steps", "20", "--aug_rotate_deg", "15",
                                            "--checkpoint_every", "100", "--workdir", wd,
                                            "--device", str(dev)])
    rot_k1 = gs.render_heatmap.launches
    steps = [r for r in read_metrics(os.path.join(wd, "metrics.jsonl")) if "loss" in r]
    losses = [r["loss"] for r in steps]
    step_ms = statistics.median(1e3 / r["steps_per_sec"] for r in steps[5:])
    log(f"[rotate] 20 config-B steps with --aug_rotate_deg 15: loss first 3 "
        f"{np.round(losses[:3], 4).tolist()}, last 3 {np.round(losses[-3:], 4).tolist()}; "
        f"{rot_k1} K1 launches; median {step_ms:.3f} ms/step on {smi}; "
        f"{time.perf_counter() - t0:.1f} s")
    if len(steps) != 20 or not np.isfinite(losses).all() or rot_k1 != 20:
        raise AssertionError("rotation training: missing steps, non-finite loss or K1 launches")
    return lr_k1, rot_k1


def phase_remat(dev, smi):
    """Phase 32: one config-B training step (batch 8, 768^2 synthetic
    scenes) with and without ``remat`` from the same weights and batch:
    the loss and gradient-norm gap, the peak device memory of each, and
    ms per step (5 more steps each, synchronized)."""
    import torch

    from cvm_tpu_torch.data.loader import prefetch_to_device
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.loop import Trainer, step_generator

    batch = synthetic_batch(np.random.default_rng(7), B, PAD_HW, num_classes=10)
    res = {}
    for remat in (False, True):
        tr = Trainer(CenternetParams(batch_size=B, warmup_steps=1, remat=remat), dev)
        tr.init_state()
        raw = next(prefetch_to_device(iter([batch]), dev))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _, m = tr.train_step(tr.state, raw, step_generator(dev, 0, 0))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        peak = torch.cuda.max_memory_allocated(dev) - base
        times = []
        for s in range(1, 6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(tr.state, raw, step_generator(dev, 0, s))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[remat] = dict(loss=loss, grad_norm=gnorm, peak_mib=peak / 2 ** 20,
                          ms=statistics.median(times))
        del tr, raw
        torch.cuda.empty_cache()
    d_loss = abs(res[True]["loss"] - res[False]["loss"])
    d_gn = abs(res[True]["grad_norm"] - res[False]["grad_norm"])
    log(f"[remat] one config-B step (batch {B}, from the same weights and batch) on {smi}: "
        f"|d loss| {d_loss:.3e}, |d grad_norm| {d_gn:.3e}; peak memory above the weights "
        f"{res[False]['peak_mib']:.1f} MiB without remat, {res[True]['peak_mib']:.1f} MiB "
        f"with; median ms/step (5 steps, synchronized, host clock) {res[False]['ms']:.3f} "
        f"without, {res[True]['ms']:.3f} with")
    if d_loss > 1e-6 * abs(res[False]["loss"]) or d_gn > 1e-3 * res[False]["grad_norm"]:
        raise AssertionError(f"remat changed the step: {res}")
    return res


def phase_inflight(dev, smi):
    """Phase 32b: what ``Trainer.MAX_INFLIGHT`` (the watchdog's bound on the
    host's run-ahead, 8 steps) does to config-B training (batch 8,
    synthetic scenes): steps/s of ``fit`` over steps 2-25 with the bound and
    with none (as before it), after one untimed run, in two pairs that
    alternate which side runs first."""
    from cvm_tpu_torch.data.synthetic import SyntheticIterator
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.loop import Trainer

    rates = {8: [], None: []}
    for i, bound in enumerate((8, 8, None, None, 8)):
        tr = Trainer(CenternetParams(batch_size=B, warmup_steps=5), dev, log_every=1000)
        tr.MAX_INFLIGHT = bound if bound is not None else 1 << 30
        tr.init_state()
        m = tr.fit(SyntheticIterator(0, B, PAD_HW, num_classes=10), 25)
        if i:  # the first run warms up
            rates[bound].append(m["steps_per_sec"])
    med = {k: statistics.median(v) for k, v in rates.items()}
    log(f"[inflight] config-B fit, steps 2-25, steps/s on {smi}: bound 8 "
        f"{[round(r, 3) for r in rates[8]]} (median {med[8]:.3f}), unbounded "
        f"{[round(r, 3) for r in rates[None]]} (median {med[None]:.3f})")
    return rates


def phase_tiled(dev, workdir, smi):
    """Phase 33a: ``cli.infer --tiled`` of a config-A semseg checkpoint
    (256x640 input, seeded weights) over three 720x1280 PNGs: each image's
    line at its own size, and the tiles per image and ms per image."""
    from PIL import Image

    from cvm_tpu_torch.cli.infer import main as infer_main
    from cvm_tpu_torch.data.synthetic import synthetic_sample
    from cvm_tpu_torch.infer.tiled import tile_positions
    from cvm_tpu_torch.models.semseg.params import SemsegParams
    from cvm_tpu_torch.train.loop import Trainer

    cfg = SemsegParams(batch_size=1)
    tr = Trainer(cfg, dev, checkpoint_dir=os.path.join(workdir, "semseg_ck"))
    tr.init_state()
    tr.ckpt.save(1, tr.checkpoint_state(None))
    tr.ckpt.wait()  # the write is asynchronous
    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(workdir, "big"))
    hw = (720, 1280)
    for i in range(3):
        Image.fromarray(synthetic_sample(rng, hw, num_classes=10)["image"]).save(
            os.path.join(workdir, "big", f"big{i}.png"))
    rc, lines, err = _cli(infer_main, ["--model", "semseg", "--checkpoint_dir",
                                       os.path.join(workdir, "semseg_ck"), "--images",
                                       os.path.join(workdir, "big", "*.png"), "--tiled",
                                       "--device", str(dev)])
    if rc != 0:
        raise AssertionError(f"cli.infer --tiled exited {rc}: {err[-2000:]}")
    recs = [json.loads(x) for x in lines]
    summary = json.loads(err.splitlines()[-1])
    tiles = (len(tile_positions(hw[0], cfg.input_hw[0], 0.25))
             * len(tile_positions(hw[1], cfg.input_hw[1], 0.25)))
    log(f"[tiled] cli.infer --tiled, config-A semseg ({cfg.input_hw[0]}x{cfg.input_hw[1]} "
        f"tiles, overlap 0.25) over 3 images of {hw[0]}x{hw[1]}: {tiles} tiles per image, "
        f"{summary['ms_per_image_avg']} ms per image (host clock, first image included) "
        f"on {smi}")
    if len(recs) != 3 or any(r["hw"] != list(hw) or sum(r["class_histogram"]) != hw[0] * hw[1]
                             for r in recs):
        raise AssertionError(f"cli.infer --tiled lines: {recs}")


def phase_video(dev, workdir, art, files, recs, smi, cv2_version):
    """Phase 33b: ``run_video`` over the COCO tree's images, decoded on the
    card as ``cli.infer`` decodes them, through phase 27's fused artifact's
    ``predict`` (``cli.video.artifact_predict``): every JSON line equal to
    ``cli.infer --artifact``'s on the same frames (boxes and classes
    identical, scores after rounding), 24 K2 launches per batch-8 call;
    then, where ``cli.doctor`` found cv2, the full ``cli.video`` (decode,
    annotate, encode) over an mp4 of synthetic frames."""
    from cvm_tpu_torch.cli import video
    from cvm_tpu_torch.data.images import read_image_as_jpeg
    from cvm_tpu_torch.data.jpeg import decode_jpeg_batch
    from cvm_tpu_torch.infer.runtime import ServingModel
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    t0 = time.perf_counter()
    img, hw = decode_jpeg_batch([read_image_as_jpeg(f)[0] for f in files], *PAD_HW, device=dev)
    frames = [(i, img[i, :hw[i, 0], :hw[i, 1]]) for i in range(len(files))]
    sm = ServingModel(art, device=dev)
    jsonl = os.path.join(workdir, "video.jsonl")
    fq.reset_counts()
    t1 = time.perf_counter()
    n = video.run_video(video.artifact_predict(sm, PAD_HW), iter(frames), B, PAD_HW, 30.0,
                        None, jsonl, score_threshold=0.0)
    run_s = time.perf_counter() - t1
    launches = fq.fused_qconv.launches
    with open(jsonl) as f:
        got = [json.loads(line) for line in f]
    same = sum(g["boxes"] == w["boxes"] and g["classes"] == w["classes"]
               and g["scores"] == np.round(np.float32(w["scores"]), 4).tolist()
               for g, w in zip(got, recs))
    n_calls = -(-len(files) // B)
    log(f"[video] run_video over {n} frames through the w8a8_fused_chain artifact: {launches} "
        f"K2 launches ({n_calls} batch-{B} calls), {same}/{n} lines equal to cli.infer "
        f"--artifact's on the same frames; {run_s * 1e3 / n_calls:.3f} ms per batch on {smi} "
        f"(host clock: predict, records)")
    if n != len(recs) or same != n or launches != K2_PER_FORWARD * n_calls:
        raise AssertionError(f"run_video: {same}/{n} lines equal, {launches} K2 launches")
    if cv2_version is None:
        log("[video] cli.doctor found no cv2 on this machine: the full cli.video (decode, "
            "annotate, encode) is not run")
        return launches
    import cv2

    from cvm_tpu_torch.data.synthetic import synthetic_sample

    clip = os.path.join(workdir, "clip.mp4")
    w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (640, 480))
    rng = np.random.default_rng(4)
    for _ in range(2 * B):
        w.write(np.ascontiguousarray(
            synthetic_sample(rng, (480, 640), num_classes=10)["image"][..., ::-1]))
    w.release()
    fq.reset_counts()
    out = os.path.join(workdir, "annotated.mp4")
    rc, lines, err = _cli(video.main, ["--artifact", art, "--video", clip, "--out", out,
                                       "--jsonl", os.path.join(workdir, "clip.jsonl"),
                                       "--device", str(dev)])
    cli_launches = fq.fused_qconv.launches
    cap = cv2.VideoCapture(out)
    written = 0
    while cap.read()[0]:
        written += 1
    cap.release()
    log(f"[video] cv2 {cv2_version} (cli.doctor): cli.video --artifact over a {2 * B}-frame "
        f"640x480 mp4: {lines[-1] if lines else err[-500:]}, {written} annotated frames "
        f"written, {cli_launches} K2 launches; {time.perf_counter() - t0:.1f} s for phase 33b")
    if rc != 0 or written != 2 * B or cli_launches != 2 * K2_PER_FORWARD:
        raise AssertionError(f"cli.video: rc {rc}, {written} frames, {cli_launches} launches")
    return launches + cli_launches


DIST_CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "torch_dist_child.py")


def _dist_child():
    """``tests/torch_dist_child.py`` as a module (it imports no JAX)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_dist_child", DIST_CHILD)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=0):
        raise AssertionError(f"{what}: {got.tolist()} against {want.tolist()} (rtol {rtol})")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _reduces(rank):
    """A rank's all-reduces per step (the steps after the first)."""
    n, b = rank["all_reduces"][1:], rank["all_reduce_bytes"][1:]
    return (f"{statistics.median(n):.0f} all-reduces per step "
            f"({statistics.median(b) / 2**20:.3f} MiB)")


def phase_dist(dev, workdir, smi):
    """Phase 34: multi-process training on the one card (docstring, 34a-d),
    with deterministic cuDNN algorithms (two runs of one command otherwise
    drift apart: 0.8% in the loss by step 10 of 34b's twins).
    Returns K1's launches by path."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process's cache
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _phase_dist(dev, workdir, smi)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _phase_dist(dev, workdir, smi):
    import torch

    from cvm_tpu_torch.cli.evaluate import main as eval_main
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
    from cvm_tpu_torch.parallel.mesh import free_port
    from cvm_tpu_torch.train.loop import Trainer

    child = _dist_child()
    k1 = {}
    # 34a: two gloo ranks x 8 against one process x 16
    t0 = time.perf_counter()
    ranks = [r for r, _ in child.launch(2, ["train", "--model", "centernet", "--config", "B",
                                            "--steps", 10], os.path.join(workdir, "a"),
                                        device="cuda", timeout=600)]
    t_ranks = time.perf_counter() - t0
    one = child.run_train(None, dev, "centernet", "B", 10)   # resets and reads K1's count
    torch.cuda.synchronize()
    if ranks[0]["losses"] != ranks[1]["losses"] or ranks[0]["checksum"] != ranks[1]["checksum"]:
        raise AssertionError(f"the ranks disagree: {ranks[0]['losses']} {ranks[1]['losses']}")
    err_a = _close(ranks[0]["losses"], one["losses"], 5e-3, "34a losses, 2 ranks vs 1")
    if [r["k1"] for r in ranks] != [10, 10] or one["k1"] != 10:
        raise AssertionError(f"K1 launches: ranks {[r['k1'] for r in ranks]}, one {one['k1']}")
    ms_ranks = statistics.median(ranks[0]["ms"][2:])
    if ranks[0]["all_reduces"] != ranks[1]["all_reduces"] or not min(ranks[0]["all_reduces"]):
        raise AssertionError(f"all-reduces per step: {[r['all_reduces'] for r in ranks]}")
    ms_one = statistics.median(one["ms"][2:])
    k1["multi-process: 2 gloo ranks x 8 (34a)"] = dict(launches=ranks[0]["k1"] + ranks[1]["k1"])
    k1["multi-process: its one process x 16 (34a)"] = dict(launches=one["k1"])
    log(f"[dist] 34a config B, global batch 16, 10 steps on {smi}: two gloo ranks x 8 on one "
        f"card {ms_ranks:.3f} ms/step, one process x 16 {ms_one:.3f} ms/step (median of steps "
        f"3-10, scene making outside the clock); losses equal between the ranks, max rel. "
        f"gap to the one process {err_a:.2e}; first/last loss {one['losses'][0]:.4f} / "
        f"{one['losses'][-1]:.4f}; checksums equal; K1 10 launches per rank and 10 in the one "
        f"process; {_reduces(ranks[0])} on each rank; the ranks' run {t_ranks:.1f} s with "
        "their start")

    # 34b: cli.train over NCCL at world size 1, against the same command plain
    runs = {}
    for tag, extra in (("plain", []), ("nccl", ["--coordinator",
                                                f"127.0.0.1:{free_port()}",
                                                "--num_processes", "1", "--process_id", "0"])):
        w = os.path.join(workdir, f"b_{tag}")
        gs.reset_counts()
        t0 = time.perf_counter()
        train_main(TRAIN_FLAGS + ["--workdir", w, "--steps", "10", "--checkpoint_every", "10"]
                   + extra)
        torch.cuda.synchronize()
        rows = read_metrics(os.path.join(w, "metrics.jsonl"))
        runs[tag] = dict(losses=[r["loss"] for r in rows], k1=gs.render_heatmap.launches,
                         ms=statistics.median(1e3 / r["steps_per_sec"] for r in rows[2:]),
                         s=time.perf_counter() - t0, w=w)
        if [r["step"] for r in rows] != list(range(1, 11)) or runs[tag]["k1"] != 10:
            raise AssertionError(f"34b {tag}: steps {[r['step'] for r in rows]}, "
                                 f"K1 {runs[tag]['k1']}")
    err_b = _close(runs["nccl"]["losses"], runs["plain"]["losses"], 5e-3, "34b losses")
    rc, out, err = _cli(eval_main, ["--model", "centernet", "--workdir", runs["nccl"]["w"],
                                    "--device", "cuda", "--pad_hw", "512,512", "--batches", "1"])
    if rc != 0 or "no checkpoint restored" in err:
        raise AssertionError(f"cli.evaluate on the NCCL run's checkpoint: rc {rc}\n{err[-2000:]}")
    k1["cli.train over NCCL, world size 1 (34b)"] = dict(launches=runs["nccl"]["k1"])
    k1["cli.train plain, its twin (34b)"] = dict(launches=runs["plain"]["k1"])
    log(f"[dist] 34b cli.train 10 config-B steps on {smi}: over NCCL at world size 1 "
        f"{runs['nccl']['ms']:.3f} ms/step ({runs['nccl']['s']:.1f} s with the group), plain "
        f"{runs['plain']['ms']:.3f} ms/step ({runs['plain']['s']:.1f} s); max rel. loss gap "
        f"{err_b:.2e}; 10 K1 launches each; cli.evaluate scored the checkpoint: "
        f"{out[-1] if out else ''}")

    # 34c: tensor parallelism over a model axis of 2 (both ranks hold the 16 rows)
    ck = os.path.join(workdir, "c_ck")
    t0 = time.perf_counter()
    tp = [r for r, _ in child.launch(2, ["train", "--model", "centernet", "--config", "B",
                                         "--steps", 5, "--model_parallel", 2,
                                         "--tensor_parallel", "--ckdir", ck],
                                     os.path.join(workdir, "c"), device="cuda", timeout=600)]
    t_tp = time.perf_counter() - t0
    if tp[0]["losses"] != tp[1]["losses"]:
        raise AssertionError(f"the TP ranks disagree: {tp[0]['losses']} {tp[1]['losses']}")
    err_c = _close(tp[0]["losses"], one["losses"][:5], 5e-3, "34c TP losses vs one process")
    full = one["shapes"]
    for r in tp:
        for name, shape in r["shapes"].items():
            want = list(full[name])
            if name in r["split"]:
                want[1 if ".c2." in name else 0] //= 2
            if shape != want:
                raise AssertionError(f"34c rank {r['rank']}: {name} {shape}, expected {want}")
    halves = sorted(n for n in tp[0]["split"] if n.endswith("conv.weight"))
    cfg = CenternetParams(**child.CONFIGS["B"]["centernet"][0], batch_size=16,
                          tensor_parallel=True)
    back = Trainer(cfg, dev, checkpoint_dir=ck)
    back.init_state()
    got = float(sum(v.to(torch.float64).sum() for v in back.eval_params.values()))
    if back.state.step != 5 or got != tp[0]["checksum"]:
        raise AssertionError(f"34c: the gathered checkpoint (step {back.state.step}) loads with "
                             f"checksum {got!r}, the ranks hold {tp[0]['checksum']!r}")
    ms_tp = statistics.median(tp[0]["ms"][2:])
    k1["multi-process: 2 tensor-parallel gloo ranks (34c)"] = dict(
        launches=tp[0]["k1"] + tp[1]["k1"])
    if [r["k1"] for r in tp] != [5, 5]:
        raise AssertionError(f"34c K1 launches {[r['k1'] for r in tp]}")
    log(f"[dist] 34c tensor parallel (model axis 2), config B batch 16, 5 steps on {smi}: "
        f"{ms_tp:.3f} ms/step (median of steps 3-5); max rel. loss gap to 34a's one process "
        f"{err_c:.2e}; halves on each rank: {halves} (C_out of c1, C_in of c2, c1's BN); the "
        f"gathered step-5 checkpoint loads in one process with the ranks' checksum; "
        f"{_reduces(tp[0])} on each rank; {t_tp:.1f} s with the ranks' start")

    # 34d: two NCCL ranks on one card are refused, by name. Each rank reads
    # both cards and refuses; the launcher kills the other ranks at the first
    # failure it sees, so the second rank is reported only when it exited
    # before that: every rank reported must carry the refusal.
    try:
        child.launch(2, ["join"], os.path.join(workdir, "d"), device="cuda:0", timeout=300,
                     backend="nccl")
    except RuntimeError as e:
        msg = str(e)
        reported = re.split(r"(?m)^(?=rank \d+ exited)", msg)[1:]
        if not reported or not all("NCCL ranks 0 and 1 would share the card" in part
                                   for part in reported):
            raise AssertionError(f"34d: not the shared-card refusal:\n{msg}") from e
    else:
        raise AssertionError("34d: two NCCL ranks on one card formed a group")
    log(f"[dist] 34d two NCCL ranks asked to share cuda:0: refused before NCCL's init, naming "
        f"the card ({', '.join(part.split(':')[0] for part in reported)} reported)")
    return k1


def _match_detections(got, want, top=None):
    """Tie-robust detection equality, as the CPU tests hold it
    (``tests/test_torch_cli_infer.py::assert_jsonl_close``): per image the
    top scores within 0.01, and every detection of ``want``'s that stands
    more than 0.01 above its list's last score (no difference within the
    tolerance can push it out of the top k) is one of ``got``'s with the
    same class, a score within 0.01 and a box within 0.5 px. Returns
    (detections matched, max |score gap| over the sorted lists)."""
    matched, gap = 0, 0.0
    if any(np.asarray(got[k]).shape != np.asarray(want[k]).shape for k in want):
        raise AssertionError(f"shapes {[np.asarray(got[k]).shape for k in want]}")
    for i in range(len(want["scores"])):
        ws, gs = np.asarray(want["scores"][i]), np.asarray(got["scores"][i])
        gap = max(gap, float(np.abs(np.sort(ws) - np.sort(gs)).max()))
        if abs(float(gs.max()) - float(ws.max())) > 0.01:
            raise AssertionError(f"image {i}: top score {gs.max()} against {ws.max()}")
        gc, gb = np.asarray(got["classes"][i]), np.asarray(got["boxes"][i])
        order = np.argsort(-ws)[:top]
        for j in order:
            if ws[j] <= ws.min() + 0.01:
                continue
            hit = ((gc == want["classes"][i][j]) & (np.abs(gs - ws[j]) <= 0.01)
                   & (np.abs(gb - np.asarray(want["boxes"][i][j])).max(1) <= 0.5))
            if not hit.any():
                raise AssertionError(f"image {i}: detection {j} (score {ws[j]:.4f}, class "
                                     f"{want['classes'][i][j]}) not among the ranks'")
            matched += 1
    return matched, gap


def _bf16_close(got, ref, what):
    """The zoo tests' bf16 tolerance (``tests/test_torch_model.py::
    assert_bf16_close``): max |d| <= 3% and mean <= 0.5% of ref's scale."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-3)
    d = np.abs(got - ref)
    if got.shape != ref.shape or d.max() > 0.03 * scale or d.mean() > 0.005 * scale:
        raise AssertionError(f"{what}: max |d| {d.max()}, mean {d.mean()}, scale {scale}")
    return float(d.max() / scale)


def _save_npz(path, name, cfg, model, **arrays):
    np.savez(path, name=json.dumps(name), cfg=cfg.to_json(),
             **{f"sd/{k}": v.detach().cpu().numpy() for k, v in model.state_dict().items()},
             **arrays)
    return path


def phase_dist_serve(dev, workdir, seed, smi):
    """Phase 35: sharded serving and evaluation, and semseg's spatial
    sharding, on the one card (docstring, 35a-e), cuDNN deterministic as in
    phase 34. Returns (K2's launches by path, K1's launches by path)."""
    import torch

    torch.cuda.empty_cache()
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _phase_dist_serve(dev, workdir, seed, smi)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _letterbox_ranks(path, one, ranks):
    """Phase 35's first YUV420 call, in the one process and on each rank
    (``tests/torch_dist_child.py::run_serve``): one yuv_letterbox launch
    each, recorded in ``LETTERBOX_PATHS``."""
    got = [one["letterbox"]] + [res["letterbox"] for res, _ in ranks]
    if got != [1] * len(got):
        raise AssertionError(f"{path}: yuv_letterbox launches in one call (one process, then "
                             f"each rank) {got}, expected 1 each")
    LETTERBOX_PATHS[f"{path}, one process"] = dict(launches=1, calls=1)
    LETTERBOX_PATHS[f"{path}, {len(ranks)} gloo ranks"] = dict(launches=len(ranks),
                                                               calls=len(ranks))


def _phase_dist_serve(dev, workdir, seed, smi):
    import torch

    from cvm_tpu_torch.cli.evaluate import main as eval_main
    from cvm_tpu_torch.cli.export import calibration_scales
    from cvm_tpu_torch.cli.export import main as export_main
    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.data.synthetic import synthetic_batch
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs

    child = _dist_child()
    k1, k2 = {}, {}

    # 35a: config B, global batch 8 of planar YUV420 at 768², data axis 2;
    # the heatmap head sharpened (as tests/test_torch_cli_infer.py does) so
    # that the top-k scores spread beyond the matching's 0.01
    cfg, model = build_model(dev)
    with torch.no_grad():
        model.hm.out.weight.mul_(6.0)
    rng = np.random.default_rng(35)
    ph, pw = PAD_HW
    planes = {"y": rng.integers(0, 255, (B, ph, pw), dtype=np.uint8),
              "u": rng.integers(0, 255, (B, ph // 2, pw // 2), dtype=np.uint8),
              "v": rng.integers(0, 255, (B, ph // 2, pw // 2), dtype=np.uint8),
              "image_hw": rng.integers(ph * 15 // 32, ph, (B, 2)).astype(np.int32)}
    batch = {f"b/{k}": v for k, v in planes.items()}
    scales = calibration_scales(cfg, model, (512, 512), 1, B, dev)
    postures = {"fold_bn": dict(input_format="yuv420", fold_bn=True),
                "w8a8_fused_chain": dict(input_format="yuv420", w8a8="scales",
                                         w8a8_fused=True, w8a8_chain=True)}
    ins = {f"a {q}": _save_npz(os.path.join(workdir, f"a_{q}.npz"), "centernet", cfg, model,
                               opts=json.dumps(o), scales=json.dumps(scales), **batch)
           for q, o in postures.items()}
    # 35b: tensor-parallel serving (model axis 2), fp with BN folded
    ins["b"] = _save_npz(os.path.join(workdir, "b.npz"), "centernet",
                         cfg.replace(tensor_parallel=True), model,
                         opts=json.dumps(postures["fold_bn"]), model_parallel=2, **batch)
    # 35e: semseg config A with spatial_shard at model axis 2, its logits at
    # batch 1 and 8 and one training step
    dense_cfg, dense = build_dense("semseg", 8, dev)
    scfg = dense_cfg.replace(spatial_shard=True)
    x = np.random.default_rng(37).uniform(-1, 1, (8, *scfg.input_hw, 3)).astype(np.float32)
    for b in (1, 8):
        ins[f"e{b}"] = _save_npz(os.path.join(workdir, f"e{b}.npz"), "semseg",
                                 scfg.replace(batch_size=b), dense, inputs=x[:b],
                                 mode="forward", model_parallel=2)
    classes = np.random.default_rng(38).integers(0, scfg.num_classes, (8, *scfg.input_hw))
    ins["eg"] = _save_npz(os.path.join(workdir, "eg.npz"), "semseg", scfg, dense, inputs=x,
                          mode="grads", model_parallel=2,
                          **{"t/classes": classes.astype(np.int32)})
    # one launch of the two ranks runs 35a, 35b and 35e, each IN on its mesh
    t0 = time.perf_counter()
    launched = child.launch(2, ["serve", "--npz", ",".join(ins.values()), "--reps", 5,
                                "--steps", 1], os.path.join(workdir, "r"), device="cuda",
                            timeout=600)
    t_ranks = time.perf_counter() - t0
    ranks = {case: [(res["results"][i], {k[len(f"{i}/"):]: v for k, v in arrays.items()
                                         if k.startswith(f"{i}/")})
                    for res, arrays in launched]
             for i, case in enumerate(ins)}

    lines = []
    for q in postures:
        one, want = child.run_serve(None, dev, ins[f"a {q}"], reps=5)
        for res, got in ranks[f"a {q}"]:
            n, gap = _match_detections(got, want)
            if q == "w8a8_fused_chain" and not res["k2"] == one["k2"] == 24:
                raise AssertionError(f"35a K2 launches per call: rank {res['rank']} "
                                     f"{res['k2']}, one process {one['k2']} (24 expected)")
        _letterbox_ranks(f"phase 35a {q}", one, ranks[f"a {q}"])
        ms = [statistics.median(res["ms"]) for res, _ in ranks[f"a {q}"]]
        k2_ranks = [res["k2"] for res, _ in ranks[f"a {q}"]]
        if q == "w8a8_fused_chain":
            k2["sharded serving w8a8_fused_chain, 2 gloo ranks (35a)"] = dict(
                launches=sum(k2_ranks))
        lines.append(f"{q}: 2 ranks x 4 rows {ms[0]:.3f} / {ms[1]:.3f} ms per batch-8 call, "
                     f"one process x 8 {statistics.median(one['ms']):.3f} ms; {n} detections "
                     f"matched (sorted scores' max gap {gap:.2e}); K2 {k2_ranks} per rank per "
                     f"call, {one['k2']} in the one process")
    log(f"[dist-serve] 35a config B, batch 8 of 768² YUV420, data axis 2 on {smi}: "
        + "; ".join(lines) + " (median of 5 calls each)")

    one, want = child.run_serve(None, dev, ins["b"], reps=5)
    _letterbox_ranks("phase 35b fold_bn", one, ranks["b"])
    gaps = []
    for res, got in ranks["b"]:
        if not res["tensor_parallel"]:
            raise AssertionError("35b: the stage-5 convs were not served split")
        gaps.append(_match_detections(got, want))
    log(f"[dist-serve] 35b tensor-parallel serving (model axis 2), config B fp with BN folded "
        f"on {smi}: {statistics.median(ranks['b'][0][0]['ms']):.3f} ms per batch-8 call on "
        f"each rank (both hold the 8 rows), one process {statistics.median(one['ms']):.3f} "
        f"ms; {gaps[0][0]} detections matched, sorted scores' max gap "
        f"{max(g for _, g in gaps):.2e}")

    errs = []
    for b in (1, 8):
        _, want = child.run_forward(None, dev, ins[f"e{b}"])
        for _, arrays in ranks[f"e{b}"]:
            errs.append(_bf16_close(arrays["logits"], want["logits"], f"35e logits, batch {b}"))
    one, _ = child.run_grads(None, dev, ins["eg"], 1)
    m1 = one["metrics"][0]
    ms_e = [res["metrics"][0] for res, _ in ranks["eg"]]
    for m in ms_e:
        _close([m["loss"]], [m1["loss"]], 5e-3, "35e loss, spatial vs unsharded")
        _close([m["grad_norm"]], [m1["grad_norm"]], 2e-2, "35e grad_norm, spatial vs unsharded")
    log(f"[dist-serve] 35e semseg config A (256x640) with spatial_shard over a model axis of 2 "
        f"on {smi}: logits at batch 1 and 8 within bf16 rounding of the unsharded model (max "
        f"|d| {max(errs):.2e} of the logits' scale); one training step of batch 8: loss "
        f"{ms_e[0]['loss']:.6f} / {ms_e[1]['loss']:.6f} on the ranks against "
        f"{m1['loss']:.6f}, grad_norm {ms_e[0]['grad_norm']:.6f} / {ms_e[1]['grad_norm']:.6f} "
        f"against {m1['grad_norm']:.6f}; the ranks' launch for 35a, 35b and 35e "
        f"{t_ranks:.1f} s with their start")

    # 35c: cli.train over two gloo ranks, resuming phase 8's step-40 run for
    # 4 steps with an eval every 2 on every rank, against cli.evaluate in
    # one process on its step-44 checkpoint, and the same resume in one
    # process whose evals score every row (rank 0 alone, as before the mesh
    # served). cuDNN picks other algorithms for 16 rows than for 8, so the
    # one process scores the same 32 scenes in batches of 8, each image in
    # the batch it has on its rank (batches of 16 differ in bf16 rounding:
    # printed beside).
    flags = TRAIN_FLAGS + ["--steps", "44", "--checkpoint_every", "4", "--eval_every", "2",
                           "--eval_batches", "2"]
    w2, w1 = os.path.join(workdir, "c2"), os.path.join(workdir, "c1")
    for w in (w2, w1):
        shutil.copytree(os.path.join(seed, "checkpoints"), os.path.join(w, "checkpoints"))
    t0 = time.perf_counter()
    ranks = [r for r, _ in child.launch(2, ["cli", "--module", "cvm_tpu_torch.cli.train",
                                            "--argv", json.dumps(flags + ["--workdir", w2])],
                                        os.path.join(workdir, "c"), device="cuda",
                                        timeout=600)]
    t_c = time.perf_counter() - t0
    if [r["rc"] for r in ranks] != [0, 0] or [r["k1"] for r in ranks] != [4, 4]:
        raise AssertionError(f"35c: rc {[r['rc'] for r in ranks]}, K1 "
                             f"{[r['k1'] for r in ranks]} (4 per rank expected)")
    gs.reset_counts()
    _cli(train_main, flags + ["--workdir", w1])
    k1_one = gs.render_heatmap.launches
    evals = {w: [r for r in read_metrics(os.path.join(w, "metrics.jsonl")) if "val_mAP" in r]
             for w in (w2, w1)}
    ev_flags = EVAL_FLAGS[:4] + ["--device", "cuda", "--workdir", w2]
    one_json = os.path.join(workdir, "d1.json")
    rc, out_8, err = _cli(eval_main, ev_flags + ["--batches", "4", "--batch_size", "8",
                                                 "--json_out", one_json])
    rc16, out_16, err16 = _cli(eval_main, ev_flags + ["--batches", "2"])
    if rc != 0 or rc16 != 0 or not out_8 or not out_16:
        raise AssertionError(f"35c cli.evaluate: rc {rc} / {rc16}\n{err[-2000:]}")
    scored, scored16 = (json.loads(o[-1].split(": ", 1)[1]) for o in (out_8, out_16))
    last = {k[4:]: v for k, v in evals[w2][-1].items() if k.startswith("val_")}
    if [r["step"] for r in evals[w2]] != [42, 44] or last != scored:
        raise AssertionError(f"35c: evals {evals[w2]} against cli.evaluate's {scored}")
    if not scored["mAP"] > 0:  # else the equality holds for any predictions
        raise AssertionError(f"35c: the step-44 model scores mAP {scored['mAP']}, not above 0")
    k1["cli.train --coordinator, 2 gloo ranks (35c)"] = dict(launches=sum(r["k1"]
                                                                          for r in ranks))
    k1["cli.train, its one process (35c)"] = dict(launches=k1_one)
    secs = [[r["eval_seconds"] for r in evals[w]] for w in (w2, w1)]
    log(f"[dist-serve] 35c cli.train config B (flagship scenes), phase 8's run resumed from "
        f"step 40 for 4 steps, an eval of 2 batches of 16 every 2, over two gloo ranks on "
        f"{smi}: eval_seconds {secs[0]} with every rank scoring its 8 rows, against "
        f"{secs[1]} for one process scoring all 16 (rank 0 alone's work before the mesh "
        f"served); val_* at step 44 equal to cli.evaluate in one process on the checkpoint "
        f"in batches of 8 ({scored}; in batches of 16, bf16 rounding apart: {scored16}); K1 "
        f"{[r['k1'] for r in ranks]} launches per rank, {k1_one} in the one process; "
        f"{t_c:.1f} s with the ranks' start")

    # 35d: cli.evaluate and cli.infer of the step-44 checkpoint, and
    # cli.infer of its w8a8_fused_chain RGB artifact (K2 on every rank),
    # over two processes against one, each image in a batch of the same
    # rows in both (the ranks' global batch twice the one process's; the
    # artifact's b8 program takes a rank's 4 rows padded)
    art_dir = os.path.join(workdir, "art")
    export_main(["--model", "centernet", "--checkpoint_dir", os.path.join(w2, "checkpoints"),
                 "--out", art_dir, "--quantize", "w8a8_fused_chain", "--batch_sizes", "8",
                 "--device", "cuda"])
    img_dir = os.path.join(workdir, "images")
    os.makedirs(img_dir)
    from PIL import Image

    scenes = synthetic_batch(np.random.default_rng(36), 10, (480, 640), num_classes=10)
    for i in range(10):  # 10 images: the second batch padded
        Image.fromarray(scenes["image"][i]).save(os.path.join(img_dir, f"im{i}.jpg"),
                                                 quality=90)
    images = ["--device", "cuda", "--images", os.path.join(img_dir, "*.jpg"),
              "--score_threshold", "0"]
    ckpt = ["--model", "centernet", "--checkpoint_dir", os.path.join(w2, "checkpoints")]
    art = ["--artifact", art_dir]
    cases = {  # case: (module, the two ranks' argv, one process's output or argv)
        "cli.evaluate": ("cvm_tpu_torch.cli.evaluate", ev_flags + [
            "--batches", "2", "--json_out", os.path.join(workdir, "d2.json")], out_8),
        "cli.infer": ("cvm_tpu_torch.cli.infer", ckpt + images + ["--batch_size", "16"],
                      ckpt + images + ["--batch_size", "8"]),
        "cli.infer --artifact": ("cvm_tpu_torch.cli.infer", art + images, art + images)}
    outs = []
    # the three pairs of ranks run at once (six ranks share the card), while
    # this process runs the one-process twins
    with ThreadPoolExecutor(len(cases)) as ex:
        launched = {case: ex.submit(child.launch, 2, [
            "cli", "--module", module, "--argv", json.dumps(argv2)],
            os.path.join(workdir, "d_" + case.replace(" ", "").replace("-", "")),
            device="cuda", timeout=600) for case, (module, argv2, _) in cases.items()}
        for case, (module, argv2, one) in cases.items():
            outs.append(_dist_cli_case(case, module, one, out_8, launched[case],
                                       one_json, workdir, scored, fq, k2))
    log(f"[dist-serve] 35d over two gloo ranks on {smi}, rank 0's output against one "
        f"process's: " + "; ".join(outs))
    return k2, k1


def _dist_cli_case(case, module, one, out_8, launched, one_json, workdir, scored, fq, k2):
    """35d's check of one case: the two ranks' output (``launched``, a
    future of ``child.launch``) against one process's (``one``: its output
    lines, or the argv to run it with); a line for the log."""
    k2_one = None
    if one is not out_8:
        fq.reset_counts()
        rc, one, err = _cli(__import__(module, fromlist=["main"]).main, one)
        k2_one = fq.fused_qconv.launches
        if rc != 0:
            raise AssertionError(f"35d {case}: one process rc {rc}\n{err[-2000:]}")
    two = [r for r, _ in launched.result()]
    if any(r["rc"] != 0 for r in two):
        raise AssertionError(f"35d {case}: rc {[r['rc'] for r in two]}")
    one_text = "\n".join(one) + "\n"
    same = two[0]["stdout"] == one_text and two[1]["stdout"] == ""
    if case == "cli.evaluate":
        with open(one_json, "rb") as f1, open(os.path.join(workdir, "d2.json"), "rb") as f2:
            same = same and f1.read() == f2.read()
    if not same:
        raise AssertionError(f"35d {case}: two processes' output differs from one's:\n"
                             f"{two[0]['stdout'][-1500:]}\n---\n{one_text[-1500:]}")
    what = f"{case}: {len(one)} lines byte-equal"
    if case == "cli.evaluate":
        what += f" and the JSON (mAP {scored['mAP']:.4f})"
    if case == "cli.infer --artifact":
        k2["cli.infer --artifact w8a8_fused_chain, 2 gloo ranks (35d)"] = dict(
            launches=sum(r["k2"] for r in two))
        if [r["k2"] for r in two] != [k2_one] * 2 or k2_one != 48:  # 24 per b8 call
            raise AssertionError(f"35d K2: ranks {[r['k2'] for r in two]}, one {k2_one} "
                                 "(48 expected: two batches of 8)")
        what += f", K2 {[r['k2'] for r in two]} per rank / {k2_one} in one process"
    return what


def _local(child, workdir, tag, module, argv, hooks=(), env=None, timeout=600):
    """``module``'s CLI on ``argv`` with no process flags but ``--num_processes``
    and ``--backend gloo`` in it: the launcher runs as
    ``tests/torch_dist_child.py``'s ``local`` mode in a child process, its
    ranks as the script's ``cli`` mode (which counts their K1 and K2
    launches). The launcher's exit code and errors, each rank's result, and
    the ranks' events (``hang``, ``restart``, ``start``, ``first_step``)."""
    out = os.path.join(workdir, f"{tag}.json")
    proc = subprocess.run([sys.executable, DIST_CHILD, "--device", "cuda", "--backend", "gloo",
                           "--out", out, *map(str, hooks), "local", "--module", module,
                           "--argv", json.dumps(argv)],
                          capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, **(env or {})))
    if proc.returncode != 0:
        raise AssertionError(f"{tag}: the launcher's process exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    with open(out) as f:
        rc = json.load(f)["rc"]
    ranks, events = [], []
    for r in range(2):
        if os.path.exists(f"{out}.rank{r}"):
            with open(f"{out}.rank{r}") as f:
                ranks.append(json.load(f))
        if os.path.exists(f"{out}.rank{r}.events"):
            with open(f"{out}.rank{r}.events") as f:
                events += [line.split() for line in f]
    return rc, proc.stderr, ranks, events


def phase_launcher(dev, workdir, seed, smi):
    """Phase 36: whole-host training (docstring, 36a-e), cuDNN deterministic
    as in 34. Returns (K1's launches by path, K2's launches by path)."""
    import torch

    torch.cuda.empty_cache()  # the ranks share the card with this process's cache
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        return _phase_launcher(dev, workdir, seed, smi)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _phase_launcher(dev, workdir, seed, smi):
    import torch

    from cvm_tpu_torch.cli.train import main as train_main
    from cvm_tpu_torch.ops.cuda import gaussian_splat as gs
    from cvm_tpu_torch.parallel import mesh as pmesh

    child = _dist_child()
    k1 = {}
    train = "cvm_tpu_torch.cli.train"

    # 36a: no process flags on one card: this process trains, no child
    launched = []
    real_launch = pmesh.run_local_ranks
    pmesh.run_local_ranks = lambda *a, **kw: launched.append(a) or real_launch(*a, **kw)
    gs.reset_counts()
    t0 = time.perf_counter()
    try:
        rc, _, err = _cli(train_main, TRAIN_FLAGS + ["--workdir", os.path.join(workdir, "a1"),
                                                     "--steps", "10"])
    finally:
        pmesh.run_local_ranks = real_launch
    torch.cuda.synchronize()
    one_k1, t_one = gs.render_heatmap.launches, time.perf_counter() - t0
    if rc != 0 or launched or one_k1 != 10:
        raise AssertionError(f"36a one card: rc {rc}, launcher calls {len(launched)}, K1 "
                             f"{one_k1}\n{err[-2000:]}")
    k1["cli.train, no process flags, one card (36a)"] = dict(launches=one_k1)
    # --num_processes 2 --backend gloo without --coordinator, against the
    # hand-launched --coordinator pair
    # (the two pairs run at once: four ranks share the card)
    flags = TRAIN_FLAGS + ["--steps", "10", "--checkpoint_every", "10"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        hand = ex.submit(child.launch, 2, ["cli", "--module", train, "--argv", json.dumps(
            flags + ["--workdir", os.path.join(workdir, "a3")])],
            os.path.join(workdir, "a_hand"), device="cuda", timeout=600)
        rc, err, local, _ = _local(child, workdir, "a_local", train,
                                   flags + ["--workdir", os.path.join(workdir, "a2"),
                                            "--num_processes", "2", "--backend", "gloo"])
        hand = [r for r, _ in hand.result()]
    t_a = time.perf_counter() - t0
    if rc != 0 or [r["rc"] for r in local + hand] != [0] * 4:
        raise AssertionError(f"36a: launcher rc {rc}, ranks {[r['rc'] for r in local]}, "
                             f"hand-launched {[r['rc'] for r in hand]}\n{err[-2000:]}")
    clock = ("steps_per_sec", "ts")
    got, want = ([{k: v for k, v in r.items() if k not in clock}
                  for r in read_metrics(os.path.join(workdir, w, "metrics.jsonl"))]
                 for w in ("a2", "a3"))
    if got != want or [r["step"] for r in got] != list(range(1, 11)):
        raise AssertionError(f"36a: the launcher's metrics.jsonl differs from the hand-launched "
                             f"pair's:\n{got}\n{want}")
    if [r["k1"] for r in local] != [10, 10] or [r["k1"] for r in hand] != [10, 10]:
        raise AssertionError(f"36a K1: launcher's ranks {[r['k1'] for r in local]}, "
                             f"hand-launched {[r['k1'] for r in hand]}")
    k1["cli.train --num_processes 2 --backend gloo, the launcher's ranks (36a)"] = dict(
        launches=sum(r["k1"] for r in local))
    k1["cli.train --coordinator, the hand-launched pair (36a)"] = dict(
        launches=sum(r["k1"] for r in hand))
    log(f"[launcher] 36a cli.train config B, 10 steps, on {smi}: no process flags on one card "
        f"ran in this process ({one_k1} K1 launches, no launcher call, {t_one:.1f} s); "
        f"--num_processes 2 --backend gloo without --coordinator: two local ranks whose "
        f"metrics.jsonl equals the hand-launched --coordinator pair's in every value but the "
        f"clock (loss at step 10 {got[-1]['loss']:.4f}); K1 {[r['k1'] for r in local]} per "
        f"rank (hand-launched {[r['k1'] for r in hand]}); {t_a:.1f} s for both pairs at "
        f"once, starts included")

    # 36c: asynchronous saves, config B 30 steps, a save every 5 steps
    # (asynchronous, then waited for at once as the synchronous manager
    # did) against none; an exact resume from the step-10 save
    ck_ms, losses, pinned = {}, {}, 0
    gs.reset_counts()
    for tag, every in (("none", 1000), ("async", 5), ("sync", 5)):
        ms, loss, trainer = _timed_fit(dev, os.path.join(workdir, "c_" + tag), every,
                                       sync=tag == "sync")
        saves = [m for i, m in enumerate(ms) if (i + 1) % 5 == 0]
        others = [m for i, m in enumerate(ms) if (i + 1) % 5 and i >= 2]
        ck_ms[tag] = (statistics.median(saves), statistics.median(others))
        losses[tag] = loss
        if tag == "async":
            pinned = trainer.ckpt.pinned_bytes
            if trainer.ckpt.all_steps() != [5, 10, 15, 20, 25, 30]:
                raise AssertionError(f"36c: checkpoints {trainer.ckpt.all_steps()}")
    resume_dir = os.path.join(workdir, "c_resume", "checkpoints")
    os.makedirs(resume_dir)
    for name in ("10.pt", "params.json"):
        shutil.copy(os.path.join(workdir, "c_async", "checkpoints", name), resume_dir)
    _, losses["resumed"], _ = _timed_fit(dev, os.path.join(workdir, "c_resume"), 1000)
    if len(set(losses.values())) != 1 or gs.render_heatmap.launches != 3 * 30 + 20:
        raise AssertionError(f"36c: the step-30 losses differ: {losses}, or K1 launched "
                             f"{gs.render_heatmap.launches} times, not 110")
    k1["Trainer.fit with asynchronous saves, 3 x 30 steps and a resume (36c)"] = dict(
        launches=gs.render_heatmap.launches)
    log(f"[launcher] 36c config B (flagship scenes, batch 16), 30 steps, host clock between "
        f"step starts, on {smi}: a save every 5 steps, asynchronous: median "
        f"{ck_ms['async'][0]:.3f} ms at the steps after a save, {ck_ms['async'][1]:.3f} ms at "
        f"the others; each save "
        f"waited for at once (the synchronous manager's cost): {ck_ms['sync'][0]:.3f} / "
        f"{ck_ms['sync'][1]:.3f} ms; no save: {ck_ms['none'][1]:.3f} ms; pinned snapshot "
        f"buffers {pinned / 2**20:.1f} MiB; the run resumed from the step-10 save ends at the "
        f"straight run's step-30 loss exactly ({losses['none']!r})")

    # 36b: --auto_restart 1 over two local ranks, rank 1 stalled in step 4;
    # it runs beside 36d and 36e (its ranks mostly wait: for the stall, the
    # watchdog, the relaunch), which time nothing
    env = {"CVM_STALL_THRESHOLD_S": str(WATCHDOG_THRESHOLD_S),
           "CVM_HANG_S": str(WATCHDOG_HANG_S)}
    os.environ.pop("CVM_RESTART_COUNT", None)

    def run_restart():
        t0 = time.perf_counter()
        out = _local(child, workdir, "b", train,
                     TRAIN_FLAGS + ["--steps", "12", "--checkpoint_every", "2",
                                    "--auto_restart", "1", "--workdir",
                                    os.path.join(workdir, "b"), "--num_processes", "2",
                                    "--backend", "gloo"],
                     hooks=["--hang_rank", 1, "--hang_step", 4], env=env)
        return (*out, time.perf_counter() - t0)

    with ThreadPoolExecutor(1) as pool:
        restart = pool.submit(run_restart)
        k2 = _launcher_qat_and_eval(dev, workdir, seed, smi, child, k1)

    # 36b's results
    rc, err, ranks, events, t_b = restart.result()
    at = {}
    for name, rank, t, count in events:
        at.setdefault((name, count), []).append(float(t))
    if (rc != 0 or [r["rc"] for r in ranks] != [0, 0] or "asked for restart 1" not in err
            or len(at.get(("hang", "-"), [])) != 1 or not at.get(("restart", "-"))):
        raise AssertionError(f"36b: launcher rc {rc}, ranks {[r['rc'] for r in ranks]}, "
                             f"events {events}\n{err[-3000:]}")
    out0 = ranks[0]["stdout"]
    if "start_step=2" not in out0 or "done at step 12" not in out0 or \
            [r["k1"] for r in ranks] != [10, 10]:
        raise AssertionError(f"36b: not resumed from step 2 to 12 with 10 K1 launches per rank "
                             f"({[r['k1'] for r in ranks]}):\n{out0[-2000:]}")
    hang_at, restart_at = at[("hang", "-")][0], min(at[("restart", "-")])
    first_at = max(at[("first_step", "1")])
    k1["cli.train --auto_restart 1 over two local ranks, after the restart (36b)"] = dict(
        launches=sum(r["k1"] for r in ranks))
    log(f"[launcher] 36b --auto_restart 1 over two local gloo ranks, config B, rank 1's device "
        f"asleep {WATCHDOG_HANG_S} s in step 4, threshold {WATCHDOG_THRESHOLD_S} s, on {smi}: "
        f"a watchdog exited for a restart {restart_at - hang_at:.2f} s after the stall was "
        f"enqueued; both ranks' first step after the relaunch done "
        f"{first_at - restart_at:.2f} s after that exit (kill, spawn, python and CUDA start, "
        f"group, model, checkpoint, a step); resumed at step 2, done at step 12, K1 "
        f"{[r['k1'] for r in ranks]} per rank; the card took the new ranks after an exit "
        f"with a kernel in flight; {t_b:.1f} s in all, beside 36d and 36e")

    return k1, k2


def _launcher_qat_and_eval(dev, workdir, seed, smi, child, k1):
    """Phase 36d and 36e; K2's launches by path (K1's go into ``k1``)."""
    from cvm_tpu_torch.cli.evaluate import main as eval_main
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    k2 = {}
    # 36d: QAT on a model axis of 2 against one process
    t0 = time.perf_counter()
    tp = [r for r, _ in child.launch(2, ["train", "--model", "centernet", "--config", "B",
                                         "--steps", 5, "--model_parallel", 2,
                                         "--tensor_parallel", "--qat"],
                                     os.path.join(workdir, "d"), device="cuda", timeout=600)]
    t_d = time.perf_counter() - t0
    one = child.run_train(None, dev, "centernet", "B", 5, qat=True)
    if tp[0]["losses"] != tp[1]["losses"] or tp[0]["scales"] != tp[1]["scales"]:
        raise AssertionError("36d: the ranks' losses or scales differ")
    err_d = _close(tp[0]["losses"], one["losses"], 5e-3, "36d QAT TP losses vs one process")
    # Step 1 runs both sides from the same weights: its weight scales are
    # equal, its activation scales within bf16 rounding; from step 2 on the
    # weights differ by bf16 noise, which Adam turns into full-size steps.
    gaps = {}
    for name, want in one["scales"].items():
        got, want = np.asarray(tp[0]["scales"][name]), np.asarray(want)
        rel = np.abs(got - want) / want
        gaps[name] = (float(rel[0, 0]), float(np.max(np.abs(got[0, 1:] - want[0, 1:]))),
                      [round(float(v), 4) for v in rel[1:, 0]],
                      [round(float(v), 4) for v in rel[1:, 1:].max(axis=1)])
        if gaps[name][1] != 0 or gaps[name][0] > 1e-2:
            raise AssertionError(f"36d {name}: step-1 scale gaps {gaps[name]}")
    if [r["k1"] for r in tp] != [5, 5]:
        raise AssertionError(f"36d K1 launches {[r['k1'] for r in tp]}")
    k1["QAT, 2 tensor-parallel gloo ranks (36d)"] = dict(launches=sum(r["k1"] for r in tp))
    log(f"[launcher] 36d QAT over a model axis of 2, config B batch 16, 5 steps, on {smi}: "
        f"the ranks' losses and s5b*.c2 scales equal each other; max rel. loss gap to one "
        f"process {err_d:.2e}; per conv against one process (step 1's activation-scale rel. "
        f"gap, step 1's weight-scale max |d|, then steps 2-5's activation and max weight "
        f"rel. gaps): {gaps}; K1 {[r['k1'] for r in tp]}; {t_d:.1f} s with the ranks' start")

    # 36e: cli.evaluate --quantize w8a8_fused_chain over two local ranks
    # against one process batched alike (phase 35's rule: cuDNN rounds 16 rows
    # otherwise than 8). The pipeline pads a batch to the config's
    # batch_size, and calibration takes a batch of batch_size scenes (the
    # global batch, 16): so the one process runs batches of 8 (the rows of
    # a rank) and calibrates on 16 scenes, as each rank does.
    from cvm_tpu_torch.cli import evaluate as ev_mod

    ev = ["--model", "centernet", "--workdir", seed, "--device", "cuda", "--pad_hw", "512,512",
          "--quantize", "w8a8_fused_chain", "--calib_batches", "1"]
    t0 = time.perf_counter()
    rc, err, ranks, _ = _local(child, workdir, "e", "cvm_tpu_torch.cli.evaluate",
                               ev + ["--batches", "2", "--json_out",
                                     os.path.join(workdir, "e2.json"), "--num_processes", "2",
                                     "--backend", "gloo"])
    t_e = time.perf_counter() - t0
    real_calibrate = ev_mod._calibrate

    def calibrate_on_16(args, cfg, *rest):
        return real_calibrate(args, cfg.replace(batch_size=16), *rest)

    ev_mod._calibrate = calibrate_on_16
    fq.reset_counts()
    try:
        rc1, one_out, err1 = _cli(eval_main, ev + ["--batches", "4", "--batch_size", "8",
                                                   "--json_out",
                                                   os.path.join(workdir, "e1.json")])
    finally:
        ev_mod._calibrate = real_calibrate
    k2_one = fq.fused_qconv.launches
    if rc != 0 or rc1 != 0 or [r["rc"] for r in ranks] != [0, 0]:
        raise AssertionError(f"36e: rc {rc} / {rc1}, ranks {[r['rc'] for r in ranks]}\n"
                             f"{err[-2000:]}\n{err1[-2000:]}")
    with open(os.path.join(workdir, "e1.json")) as f1, \
            open(os.path.join(workdir, "e2.json")) as f2:
        m1, m2 = json.load(f1), json.load(f2)
    k2["cli.evaluate w8a8_fused_chain, 2 local gloo ranks (36e)"] = dict(
        launches=sum(r["k2"] for r in ranks))
    k2["cli.evaluate w8a8_fused_chain, its one process (36e)"] = dict(launches=k2_one)
    # 24 K2 calls per forward: 2 of 8 rows on each rank, 4 of 8 in one
    # process. The ranks' sharded pipelines run eagerly and count at each
    # launch; in the one process the third and fourth batches replay a CUDA
    # graph, and their 48 are the capture's counts, added per replay
    if [r["k2"] for r in ranks] != [48, 48] or k2_one != 96 or m1 != m2 or not m1["mAP"] > 0:
        raise AssertionError(f"36e: K2 {[r['k2'] for r in ranks]} / {k2_one}, metrics "
                             f"{m2} against {m1}")
    log(f"[launcher] 36e cli.evaluate --quantize w8a8_fused_chain of phase 8's step-40 "
        f"checkpoint, 2 batches of 16, over two local gloo ranks (8 rows each) on {smi}: "
        f"metrics equal to one process predicting the same images in batches of 8, "
        f"calibrated alike (mAP {m2['mAP']!r}); K2 {[r['k2'] for r in ranks]} per rank, "
        f"{k2_one} in the one process; {t_e:.1f} s through the launcher")
    return k2


def _timed_fit(dev, workdir, every, sync=False):
    """Config B (``TRAIN_FLAGS``' flagship recipe) trained to step 30 by
    ``Trainer.fit`` from ``workdir``'s newest checkpoint, a save every
    ``every`` steps (each waited for at once with ``sync``): the host ms
    between consecutive steps' starts, the step-30 loss, the trainer."""
    import torch

    from cvm_tpu_torch.data.synthetic import SyntheticIterator
    from cvm_tpu_torch.models.centernet.params import CenternetParams
    from cvm_tpu_torch.train.loop import Trainer

    cfg = CenternetParams(num_classes=10, max_objects=16, batch_size=16, warmup_steps=5,
                          total_steps=5000)
    trainer = Trainer(cfg, dev, checkpoint_dir=os.path.join(workdir, "checkpoints"),
                      keep_checkpoints=10, checkpoint_every=every, log_every=1000, seed=0)
    trainer.init_state()
    it = SyntheticIterator(0, 16, (512, 512), num_classes=10)
    if trainer.data_state is not None:
        it.load_state_dict(trainer.data_state)
    starts, real = [], trainer.train_step

    def step(*args):
        starts.append(time.perf_counter())
        return real(*args)

    trainer.train_step = step
    if sync:
        save = trainer._save

        def save_and_wait(data_state):
            save(data_state)
            trainer.ckpt.wait()

        trainer._save = save_and_wait
    last = trainer.fit(it, 30 - trainer.state.step)
    torch.cuda.synchronize()
    return list(1e3 * np.diff(starts)), last["loss"], trainer


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this test needs the card",
              file=sys.stderr)
        return 1
    t_smoke = time.perf_counter()
    dev = torch.device("cuda:0")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[card] {smi}")
    log(f"[versions] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False")
    from cvm_tpu_torch.cli.doctor import run_checks

    report = run_checks("cuda")
    log(f"[doctor] {json.dumps(report)}")
    if not report["ok"]:
        raise AssertionError(f"cli.doctor: a required check failed: {report}")

    # Phase 1: build both kernels from the checkout's sources, in parallel.
    from cvm_tpu_torch.ops.cuda import _build
    from cvm_tpu_torch.ops.cuda import fused_qconv as fq

    def timed_load(name):
        t = time.perf_counter()
        _build.load_library(name)
        return name, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        took = dict(ex.map(timed_load, ["fused_qconv", "gaussian_splat", "conv_epilogue",
                                        "yuv_letterbox"]))
    log(f"[build] fused_qconv {took['fused_qconv']:.1f} s, gaussian_splat "
        f"{took['gaussian_splat']:.1f} s, conv_epilogue {took['conv_epilogue']:.1f} s, "
        f"yuv_letterbox {took['yuv_letterbox']:.1f} s, together "
        f"{time.perf_counter() - t0:.1f} s, into {_build.BUILD_DIR}")

    # Phase 2: kernel vs plain, at config B's shapes and at every shape of
    # the dense models' int8 forwards (recorded from one forward each).
    t0 = time.perf_counter()
    dense_calls = {}
    for path, name, b, _ in DENSE_PATHS:
        dense_calls[path] = record_k2_calls(*build_dense(name, b, dev), dev)
    max_err, k2, k2_dense = phase_kernels(dev, dense_calls)
    log(f"[kernel] phase 2 took {time.perf_counter() - t0:.1f} s")

    # Phase 3: model, calibration, both pipelines.
    from cvm_tpu_torch.data.synthetic import synthetic_yuv420_batch
    from cvm_tpu_torch.entry import entry
    from cvm_tpu_torch.infer import quantize as qz
    from cvm_tpu_torch.infer.pipeline import InferencePipeline
    from cvm_tpu_torch.infer.server import DynamicBatcher
    from cvm_tpu_torch.pipeline.preprocess import preprocess_yuv420_batch

    cfg, model = build_model(dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    cal = letterbox_launches("phase 3 config B calibration, float32", 3, lambda: [
        preprocess_yuv420_batch(*batch_to(synthetic_yuv420_batch(rng, B, PAD_HW, num_classes=10),
                                          dev), cfg.input_hw)[0] for _ in range(3)])
    scales = qz.calibrate_activation_scales(model, cal)
    log(f"[calibrate] {len(scales)} conv scales from 3 batches in "
        f"{time.perf_counter() - t0:.1f} s")
    pipe_fp = InferencePipeline(cfg, model, dev, fold_bn=True)
    pipe_q = InferencePipeline(cfg, model, dev, w8a8=scales, w8a8_fused=True, w8a8_chain=True)
    log(f"[pipelines] fp: BN folded; int8: {pipe_q.fused_counts}")
    if pipe_q.fused_counts != {"convbn": 10, "resblock": 7, "calls": 24}:
        raise AssertionError(f"unexpected fused coverage {pipe_q.fused_counts}")

    # Phase 4: serve one batch-8 request through each posture.
    batch = synthetic_yuv420_batch(np.random.default_rng(1), B, PAD_HW, num_classes=10)
    out_fp = epilogue_launches("phase 4 config B fp", pipe_fp.folded_counts, 1,
                               lambda: letterbox_launches("phase 4 config B fp", 1,
                                                          lambda: pipe_fp(batch)))
    fq.reset_counts()
    out_q = letterbox_launches("phase 4 config B int8", 1,
                               lambda: pipe_q(batch))  # the main path, int8 posture
    torch.cuda.synchronize()
    launches, int8_launches = fq.fused_qconv.launches, fq.fused_qconv.int8_out_launches
    packs = fq.fused_qconv.weight_packs
    log(f"[serve] int8 forward: {launches} kernel launches, {int8_launches} with int8 output, "
        f"{packs} weight packs")
    if (launches, int8_launches) != (24, 7):
        raise AssertionError(f"expected 24 launches (7 int8-out), got {launches} ({int8_launches})")
    if packs != 0:
        raise AssertionError(f"the int8 forward packed weights {packs} times (expected 0)")
    for name, out in (("fp", out_fp), ("int8", out_q)):
        if out["boxes"].shape != (B, cfg.top_k, 4) or out["scores"].shape != (B, cfg.top_k):
            raise AssertionError(f"{name}: bad shapes {out['boxes'].shape} {out['scores'].shape}")
        if not (torch.isfinite(out["boxes"]).all() and torch.isfinite(out["scores"]).all()):
            raise AssertionError(f"{name}: non-finite boxes or scores")

    planes = batch_to(batch, dev)
    proc, _ = preprocess_yuv420_batch(*planes, cfg.input_hw, out_dtype=torch.bfloat16)
    with torch.no_grad():
        heads_fp = pipe_fp.model(proc)
        heads_q = pipe_q.model(proc)
        real = qz.fused_qconv
        # the same posture, plain version (which reads the HWIO weights)
        qz.fused_qconv = lambda *a, w_packed=None, **k: fq.fused_qconv_reference(*a, **k)
        try:
            heads_plain = pipe_q.model(proc)
        finally:
            qz.fused_qconv = real
    p_fp, p_q, p_plain = (torch.sigmoid(h["heatmap"]) for h in (heads_fp, heads_q, heads_plain))
    d_fp = float((p_q - p_fp).abs().mean())
    d_plain = float((p_q - p_plain).abs().mean())
    d_plain_max = max(float((heads_q[k] - heads_plain[k]).abs().max()) for k in heads_q)
    log(f"[serve] mean |sigmoid(hm_int8) - sigmoid(hm_fp)| = {d_fp:.3e} (bound 5e-2); "
        f"int8 kernel vs int8 plain: mean |d sigmoid(hm)| = {d_plain:.3e} (bound 1e-3), "
        f"max |d head| = {d_plain_max:.3e}")
    if not d_fp < 5e-2:
        raise AssertionError(f"int8 heads too far from fp: {d_fp}")
    if not d_plain < 1e-3:
        raise AssertionError(f"int8 kernel posture disagrees with its plain version: {d_plain}")
    fn, args = entry(dev)
    boxes, scores, classes = fn(*args)
    if not (torch.isfinite(boxes).all() and torch.isfinite(scores).all()):
        raise AssertionError("entry(): non-finite results")
    log(f"[entry] config-B fp program: boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}")

    # Phase 5: a DynamicBatcher (batch 8) over the int8 pipeline.
    keys = ("y", "u", "v", "image_hw")
    reqs = synthetic_yuv420_batch(np.random.default_rng(2), 2 * B, PAD_HW, num_classes=10)
    direct = [pipe_q({k: reqs[k][i:i + B] for k in keys}) for i in (0, B)]
    direct_scores = torch.cat([d["scores"] for d in direct]).cpu().numpy()
    fq.reset_counts()
    batcher = DynamicBatcher(lambda *a: pipe_q(dict(zip(keys, a))), batch_size=B,
                             max_wait_ms=200)
    results, errors = [None] * (2 * B), []

    def client(i):
        try:
            results[i] = batcher.submit([reqs[k][i:i + 1] for k in keys])
        except Exception as e:  # collected and raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2 * B)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        batcher.close()
    if errors or any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"batcher: unanswered requests or errors {errors}")
    for i, r in enumerate(results):
        if r["scores"].shape != (1, cfg.top_k) or not np.allclose(r["scores"][0],
                                                                  direct_scores[i], atol=1e-4):
            raise AssertionError(f"batcher: request {i} result differs from its direct run")
    st = batcher.stats()
    # pipe_q's signature was captured by the second direct call: each batch
    # replays, and its launches are the capture's, added per replay
    log(f"[server] 16 threaded requests answered: {st['batches']} batches, fill "
        f"{st['batch_fill']}, {fq.fused_qconv.launches} kernel launches (replayed)")

    # Phase 6: median batch-8 latency, inputs resident on the card.
    lat_fp = epilogue_launches(
        "phase 6 config B fp latency", pipe_fp.folded_counts, HOST_MS_CALLS,
        lambda: letterbox_launches("phase 6 config B fp latency", HOST_MS_CALLS,
                                   lambda: host_ms(lambda: pipe_fp.predict(*planes))))
    lat_q = letterbox_launches("phase 6 config B int8 latency", HOST_MS_CALLS,
                               lambda: host_ms(lambda: pipe_q.predict(*planes)))
    log(f"[latency] batch-8 predict (preprocess+forward+decode), median of 20 on {smi}: "
        f"fp (BN folded) {lat_fp:.3f} ms, int8 (fused, chained) {lat_q:.3f} ms")

    # Phase 6b: the folded conv's epilogue in the benchmark's fp cells.
    t0 = time.perf_counter()
    epilogue = phase_conv_epilogue(dev, smi)
    log(f"[epilogue] phase 6b took {time.perf_counter() - t0:.1f} s")

    # Phase 6c: the eval YUV420 letterbox kernel in the benchmark's fp cells.
    t0 = time.perf_counter()
    letterbox = phase_yuv_letterbox(dev, smi)
    log(f"[letterbox] phase 6c took {time.perf_counter() - t0:.1f} s")

    # Phase 7: K1 against its plain version.
    t0 = time.perf_counter()
    splat_err, splat_times = phase_splat(dev)
    log(f"[splat] phase 7 took {time.perf_counter() - t0:.1f} s")

    # Phases 8-9: training through the CLI, then the trained model served.
    # Phases 16-17 export and fine-tune this run.
    train_dir = tempfile.TemporaryDirectory()
    workdir8 = train_dir.name
    t0 = time.perf_counter()
    splat_launches, step_ms = phase_train(dev, workdir8)
    log(f"[train] flagship step (B16, 512^2, config-B model, 10 classes) on {smi}: "
        f"median {step_ms:.3f} ms/step ({1e3 / step_ms:.2f} steps/s; host clock, "
        f"each step ending in a device sync; steps 6-30 of the first call)")
    phase_serve_trained(dev, workdir8)
    log(f"[train] phases 8-9 took {time.perf_counter() - t0:.1f} s")

    # Phases 10-11: training with evals, then cli.evaluate on its workdir.
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        phase_train_eval(workdir, smi)
        log(f"[train-eval] phase 10 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        maps, eval_launches = phase_evaluate(dev, workdir, smi)
        log(f"[evaluate] phase 11 took {time.perf_counter() - t0:.1f} s: mAP by posture {maps}, "
            f"{eval_launches} K2 launches")

    # Phases 12-14: the dense zoo served, trained and timed.
    t0 = time.perf_counter()
    dense_launches = phase_dense_serve(dev, smi)
    log(f"[dense] phase 12 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    dense_k1 = phase_dense_train(smi)
    log(f"[dense-train] phase 13 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_benchmark()
    log(f"[benchmark] phase 14 took {time.perf_counter() - t0:.1f} s")

    # Phases 15-17: the int8 deployment slice.
    t0 = time.perf_counter()
    phase_int8(dev, cfg, model, scales, planes, pipe_fp, pipe_q, smi)
    log(f"[int8] phase 15 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    export_launches = phase_export(dev, workdir8, smi)
    log(f"[export] phase 16 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # Phase 35 resumes the step-40 run that phase 17 goes on from.
    seed = tempfile.TemporaryDirectory()
    os.makedirs(os.path.join(seed.name, "checkpoints"))
    for name in ("params.json", "40.pt"):
        shutil.copy(os.path.join(workdir8, "checkpoints", name),
                    os.path.join(seed.name, "checkpoints"))
    qat_launches = phase_qat(workdir8, smi)
    log(f"[qat] phase 17 took {time.perf_counter() - t0:.1f} s")
    train_dir.cleanup()

    # Phases 18-21: the 3D heads served, trained and exported; DMDS.
    t0 = time.perf_counter()
    serve3d_launches, lat3d = phase_3d_serve(dev, smi)
    log(f"[3d-serve] phase 18 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        train3d_launches, step3d_ms = phase_3d_train(workdir, smi)
        log(f"[3d-train] phase 19 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        export3d_launches = phase_3d_export(dev, workdir, smi)
        log(f"[3d-export] phase 20 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        dmds = phase_dmds(dev, workdir, smi)
        log(f"[dmds] phase 21 took {time.perf_counter() - t0:.1f} s")
    # Phases 22-24: the record path (decode, train, evaluate, serve, HTTP).
    t0 = time.perf_counter()
    phase_decode(dev, smi)
    log(f"[decode] phase 22 took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as workdir:
        shard = os.path.join(workdir, "fixture_x10.cvrec")
        log(f"[records] {make_record_shard(shard)} records (the fixture's 8, 10 times over)")
        t0 = time.perf_counter()
        rec_k1, rec_step_ms, _, _ = phase_record_train(dev, os.path.join(workdir, "w"), shard,
                                                       smi)
        log(f"[records-train] phase 23 took {time.perf_counter() - t0:.1f} s; config-B step "
            f"from records {rec_step_ms:.3f} ms beside phase 8's synthetic flagship step "
            f"{step_ms:.3f} ms (B16, 10 classes)")
        t0 = time.perf_counter()
        serve_k2, http_k2, _ = phase_record_serve(dev, os.path.join(workdir, "w"), shard, smi)
        log(f"[serve-records] phase 24 took {time.perf_counter() - t0:.1f} s")

    # Phases 25-27: the data tools, training from a packed COCO tree, and
    # offline inference through an exported artifact.
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        coco_shard, tree, _ = phase_pack(dev, workdir, smi)
        log(f"[pack] phase 25 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        coco_k1, coco_step_ms = phase_coco_train(dev, os.path.join(workdir, "w"), coco_shard,
                                                 smi)
        log(f"[coco-train] phase 26 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        infer_k2, _, art, files, recs = phase_infer(dev, os.path.join(workdir, "w"),
                                                    coco_shard, tree, smi)
        log(f"[infer] phase 27 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        video_k2 = phase_video(dev, workdir, art, files, recs, smi, report["cv2"])
        log(f"[video] phase 33b took {time.perf_counter() - t0:.1f} s")

    # Phases 28-33a: the watchdog and re-exec, profiling and --debug_nans,
    # TensorBoard, the LR finder and rotation, remat, tiled inference.
    t_new = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        watchdog_k1 = phase_watchdog(workdir, smi)
        log(f"[watchdog] phase 28 took {time.perf_counter() - t0:.1f} s")
        prof_k1 = phase_profile_nans(dev, workdir, smi)
        t0 = time.perf_counter()
        tb_k1 = phase_tensorboard(dev, workdir, smi)
        log(f"[tensorboard] phase 30 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        lr_k1, rot_k1 = phase_lr_find_rotate(dev, workdir, smi)
        log(f"[lr_find-rotate] phase 31 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_remat(dev, smi)
        phase_inflight(dev, smi)
        log(f"[remat-inflight] phase 32 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_tiled(dev, workdir, smi)
        log(f"[tiled] phase 33a took {time.perf_counter() - t0:.1f} s")
    log(f"[smoke] phases 28-33a took {time.perf_counter() - t_new:.1f} s")

    # Phase 34: multi-process training on the one card.
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        dist_k1 = phase_dist(dev, workdir, smi)
        log(f"[dist] phase 34 took {time.perf_counter() - t0:.1f} s")

    # Phase 35: sharded serving and evaluation, spatial sharding.
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        dist_serve_k2, dist_serve_k1 = phase_dist_serve(dev, workdir, seed.name, smi)
        log(f"[dist-serve] phase 35 took {time.perf_counter() - t0:.1f} s")

    # Phase 36: whole-host training: the local launcher, --auto_restart over
    # its ranks, asynchronous checkpoints, QAT under tensor parallelism.
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        launcher_k1, launcher_k2 = phase_launcher(dev, workdir, seed.name, smi)
        log(f"[launcher] phase 36 took {time.perf_counter() - t0:.1f} s")
    seed.cleanup()

    log(f"[zoo3d] on {smi}: 3D batch-8 predict fp {lat3d['fp']:.3f} ms, int8 "
        f"{lat3d['int8']:.3f} ms; 3D training {step3d_ms:.3f} ms/step; DMDS training "
        f"{dmds['step_ms']:.3f} ms/step ({dmds['scenes_ms']:.1f} ms of host scenes), "
        f"batch-8 predict fp {dmds['predict_ms']:.3f} ms "
        f"(artifact {dmds['artifact_ms']:.3f} ms); DMDS reaches no TPU kernel (the "
        "reference refuses W8A8 for it)")

    log(f"[smoke] phases 1-36 took {time.perf_counter() - t_smoke:.1f} s")
    log(f"[card] {nvidia_smi()}")
    # K2's numbers are those of one config-B int8 forward; launches count
    # every main-path run (config B and each dense path), with each path's
    # launches and per-forward times beside them.
    k2_paths = {"config-B": dict(launches=launches, ms=k2["ms"], plain_ms=k2["plain"],
                                 bound_ms=k2["bound"], library_ms=k2["lib"])}
    for path, t in k2_dense.items():
        k2_paths[path] = dict(launches=dense_launches[path], ms=t["ms"], plain_ms=t["plain"],
                              bound_ms=t["bound"], library_ms=t["lib"])
    for q in ("w8a8_fused", "w8a8_fused_chain"):
        k2_paths[f"artifact {q}"] = dict(launches=export_launches[q][0])
    k2_paths["3D config-B"] = dict(launches=serve3d_launches, ms=k2["3d"]["ms"],
                                   plain_ms=k2["3d"]["plain"], bound_ms=k2["3d"]["bound"],
                                   library_ms=k2["3d"]["lib"])
    k2_paths["3D artifact w8a8_fused"] = dict(launches=export3d_launches["w8a8_fused"])
    k2_paths["cli.serve --records"] = dict(launches=serve_k2)
    k2_paths["HTTP ModelServer"] = dict(launches=http_k2)
    k2_paths["cli.infer --artifact"] = dict(launches=infer_k2)
    k2_paths["run_video + cli.video --artifact"] = dict(launches=video_k2)
    k2_paths.update(dist_serve_k2)
    k2_paths.update(launcher_k2)
    k2_shapes = sorted({f"k{c['k']} B{c['B']} {c['H']}x{c['W']} {c['cin']}->{c['cout']}"
                        for calls in dense_calls.values() for c in calls})
    print(json.dumps({"kernels": [{
        "name": "fused_qconv", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": sum(p["launches"] for p in k2_paths.values()),
        "max_abs_err": max_err,
        "ms": k2["ms"], "plain_ms": k2["plain"], "bound_ms": k2["bound"],
        "bound_by": k2["bound_by"], "library_ms": k2["lib"], "paths": k2_paths,
        "dense_shapes_checked": k2_shapes}, {
        "name": "gaussian_splat", "route": "cuda", "source": SPLAT_SOURCE,
        "replaces": SPLAT_REPLACES,
        "launches": (splat_launches + dense_k1 + qat_launches + train3d_launches + rec_k1
                     + coco_k1 + watchdog_k1 + prof_k1 + tb_k1 + lr_k1 + rot_k1
                     + sum(p["launches"] for p in dist_k1.values())
                     + sum(p["launches"] for p in dist_serve_k1.values())
                     + sum(p["launches"] for p in launcher_k1.values())),
        "max_abs_err": splat_err,
        "ms": splat_times["flagship"][0], "plain_ms": splat_times["flagship"][1],
        "bound_ms": splat_times["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "paths": {"flagship training": dict(launches=splat_launches),
                  "qat fine-tune": dict(launches=qat_launches),
                  "3D training": dict(launches=train3d_launches),
                  "training from records": dict(launches=rec_k1),
                  "training from a packed COCO shard": dict(launches=coco_k1),
                  "watchdog children (re-exec'd and stopped)": dict(launches=watchdog_k1),
                  "--profile_steps": dict(launches=prof_k1),
                  "--tensorboard --eval_images": dict(launches=tb_k1),
                  "cli.lr_find": dict(launches=lr_k1),
                  "--aug_rotate_deg": dict(launches=rot_k1),
                  "multitask training": dict(launches=dense_k1,
                                             ms=splat_times["multitask"][0],
                                             plain_ms=splat_times["multitask"][1],
                                             bound_ms=splat_times["multitask_bound_ms"]),
                  **dist_k1, **dist_serve_k1, **launcher_k1}}, {
        "name": "conv_epilogue", "route": "cuda", "source": EPILOGUE_SOURCE,
        "replaces": None, "launches": sum(p["launches"] for p in EPILOGUE_PATHS.values()),
        "max_abs_err": max(p["max_abs_err"] for p in epilogue.values()),
        "ms": epilogue["centernet_b"]["ms"],
        "plain_ms": epilogue["centernet_b"]["plain_ms"],
        "bound_ms": epilogue["centernet_b"]["bound_ms"], "bound_by": "bytes",
        "library_ms": epilogue["centernet_b"]["library_ms"], "cells": epilogue,
        "paths": EPILOGUE_PATHS}, {
        "name": "yuv_letterbox", "route": "cuda", "source": LETTERBOX_SOURCE,
        "replaces": None, "launches": sum(p["launches"] for p in LETTERBOX_PATHS.values()),
        "max_abs_err": max(c["max_abs_err"] for c in letterbox.values()),
        "ms": letterbox["centernet_b"]["ms"], "plain_ms": letterbox["centernet_b"]["plain_ms"],
        "bound_ms": letterbox["centernet_b"]["bound_ms"], "bound_by": "bytes",
        "paths": LETTERBOX_PATHS,
        "library_ms": None, "cells": letterbox}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
