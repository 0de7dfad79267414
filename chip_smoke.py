#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each reported on its own lines:
  1. device: the card's name and power limit, the build of every CUDA
     kernel from the sources in this checkout (one nvcc per source, started
     together), and the count of tensor-core instructions (HMMA / HGMMA) in
     each kernel's machine code (cuobjdump -sass): the bf16 flash kernels
     up to dh 128 and every kernel of scored_fwd, scored_bwd and
     fused_block must have them (fused_block more than the 744 its score
     dots alone had), and none of the three may spill up to dh 128;
  2. kernels: each kernel against its plain PyTorch version on the card, at
     the shapes the main paths give it and at edge cases, with its time, the
     plain version's, one library call's (timing yardstick only) and the
     bound the card sets for the same work: flash_fwd (with and without its
     row stats), flash_bwd_dq and flash_bwd_dkv, scored_fwd in its four
     variants (S_prev given or not, S emitted or not), scored_bwd_dq and
     scored_bwd_dkv in the same four, with dc and dmask held at the scale of
     the terms they sum, fully masked q x 4 rows at dh 16 and 32 among the
     edge cases, and their dq, dk and dv bit-equal whether they read the
     forward's S or rebuild s, and fused_block in the same four (its S
     and row stats m bit-equal to scored_fwd's, l within 1e-6, out, S and
     the stats the same bits over two launches; each launch's cluster size
     and blocks logged);
  3. train: `mosei_trans_s1024` at full width, bf16 over f32 masters,
     trained by the port's Trainer for 2 epochs of 4 steps at batch 64 with
     an eval pass after each, with the kernel launch counts of that run, the
     losses and the step-1 gradients held against the plain attention path
     (impl="xla") from the same weights and batches, and one profiled step;
  4. serve: the same preset, four seeded random members in bf16, served
     through the port's BatchingServer (16 concurrent synthetic requests)
     and StreamingPredictor (4 batch-1 requests), with the launch counts of
     that run and the outputs held against impl="xla" on the same members;
  5. serve_robot: `robot_demo` at full width (dim 192, 6 heads, two chained
     RealFormer blocks per stream), four seeded random members in f32 with
     their gates a, b, c set non-zero from a seeded generator (at their
     initial 0 the attention would not reach the logits), served the same
     way at impl="pallas", with scored_fwd's launch counts per variant and
     the outputs held against impl="xla" on the same members;
  6. train_realformer: `mosei_realformer` at full width (dim 96, 6 heads,
     lengths 50/50/50, two chained RealFormer blocks per stream, the
     state_transfer head over 6-clip paragraphs, 1,449,702 parameters), its
     gates set non-zero, trained by the port's Trainer at impl="pallas" for
     2 epochs of 4 steps at batch 64 (384 clips per attention call, f32,
     Adam, the clip-mask loss) with an eval pass after each: scored_fwd and
     both scored_bwd kernels counted per variant, the step-1 gradients and
     the 8 losses held against impl="xla" from the same weights and
     batches, and one profiled step;
  7. serve_paragraph: five gate-perturbed seeded members of the same
     config in a ParagraphStreamingPredictor at impl="pallas", one
     synthetic paragraph pushed clip by clip, each clip's blended logits
     held against the members' whole-window forward at impl="xla";
  8. train_fused: `mosei_trans` at its reference width (dim 96, 6 heads,
     lengths 20/100/200, one minus block per stream, 588,192 parameters,
     f32, AdamW), trained by the port's Trainer at impl="pallas_fused" for
     2 epochs of 4 steps at batch 64 with an eval pass after each: the
     whole-block kernel fused_block in every forward and both scored_bwd
     kernels in every backward, counted per variant; the 8 losses and the
     step-1 gradients held against impl="xla" from the same weights and
     batches, one profiled step; then one forward and backward of an
     n_layers=2 member with its gates c set non-zero (the S_prev variants'
     model path) against impl="xla";
  9. serve_ren_mme: `ren_mme` at its reference width (dim 128, 8 heads,
     lengths 40/76/275, the shared-LayerNorm unify, 1,317,544 parameters),
     four seeded members in f32 served at impl="pallas_fused" (eval mode,
     so its dropout is inactive) the same way as phase 4, with fused_block
     counted and the outputs held against impl="xla", then profiled at
     both impls.  The kernels phase
     also holds fused_block against its plain version in its four
     variants (and its S bit for bit against scored_fwd's);
 10. train_ren_mme: `ren_mme` at its reference width, f32, AdamW, dropout
     0.1 and R-Drop (16 pairs a step, each duplicated: 32 rows), trained
     by the port's Trainer at impl="pallas_fused" for 2 epochs of 4 steps
     with an eval pass after each: active dropout routes every block to
     scored_fwd with the plain epilogue and the scored_bwd pair, the eval
     passes to fused_block, all counted per variant; the 8 losses, the 2
     valid losses and the step-1 gradients held against impl="xla" from
     the same weights, batches and dropout generator seed; one profiled
     step;
 11. train_robot: `robot_demo` at full width, gates set, f32, AdamW,
     dropout 0.1, batch 64, trained the same way at impl="pallas"
     (scored_fwd and the scored_bwd pair in their chained variants, dh 32);
 12. train_rencecps: `rencecps` (the concat_linear head at dim 2304, no
     kernel) trained the same way for 2 epochs of 4 steps at batch 64,
     with no kernel launched, against the port's own run on the CPU.
     The kernels phase also holds scored_fwd and scored_bwd against their
     plain versions at the training shapes of phases 10 and 11, and
     fused_block at the shapes of phase 10's eval passes, and checks
     dropout itself on the card (keep rate, exact x / keep, the same bits
     from a seed);
 13. experiment: the k-fold experiment of `mosei_trans` at its reference
     width through `cli train` (pipelines.run_experiment) at
     impl="pallas_fused" (4
     folds of 128 from 512 synthetic pairs, 2 epochs, best checkpoints and
     per-epoch resume points, the 4 best members' mean over 128 test
     pairs, the fixed thresholds), with every kernel counted, each
     member's fit wall and step times, the checkpoint saves and the
     ensemble pass timed and profiled; held against the same experiment at
     impl="xla" (epoch losses, best epochs, decisions), the restored
     members at both impls, run_predict from the store (the same bits as
     the run's eval logits) and `cli serve --checkpoint-dir` (batch-1 and
     16 concurrent requests against Ensemble.logits); then run_kfold over 2
     folds cut during member 1's epoch 2 and resumed, bit-equal to the
     uninterrupted run;
 14. experiment_families: `ren_mme` (R-Drop, dropout 0.1, 2 folds, summed
     members, the joint threshold grid) at impl="pallas_fused",
     `mosei_realformer` (3 folds, its two best members at 0.6/0.4, the
     400-point sweep, paragraph clips) at impl="pallas", 1 epoch each, and
     4 seeded `mosei_trans_s1024` members written with save_params and
     scored by run_predict at impl="flash" in bf16: the launches of each
     path, the restored members' logits against impl="xla" (2e-4 f32, 5e-2
     bf16, the realformer's through gate-perturbed copies) and the swept or
     gridded thresholds against the same search on the xla logits;
 15. real_data: corpus trees written at the reference widths with numpy
     and pickle (Ren-MME: 160 utterances, a video file missing; the
     shared Ren-CECps tree over cet_1..cet_1487 with 768-d tokens; 128
     robot clips of mixed-resolution pickles, one empty) and read by the
     port's corpus readers: `ren_mme` (R-Drop, dropout 0.1, the joint
     grid) through `cli train --data-root` at impl="pallas_fused", 2 folds,
     1 epoch; `robot_demo` (dropout 0.1, gates set) at impl="pallas", 2
     folds, 2 epochs of texts substituted anew; `rencecps` at impl="xla";
     each held against run_experiment(data_root=...) at "xla" from the
     same start (rencecps: on the CPU) with phase 13's bounds, with its
     launches, load_real_data's wall, robot's resample walls and the wall
     per member-epoch beside the synthetic figure at the same fold sizes;
     the store's members at both impls on the tree's test split;
     `cli predict --split all --data-root` bit-equal to the eval logits;
     `check-data` on every tree, and exit 1 naming a removed file.  The
     MOSEI `.csd` tree (mosei_trans at pallas_fused against xla, held as
     ren_mme is) runs only where h5py imports (a line says so);
 16. serve_io: every serving path as the captured CUDA-graph programs it
     runs as (serve/graphs.py: one graph per input shape; each replay adds
     the launches it recorded to the kernels' counts, so phases 4, 5, 7 and
     9 count as before): for mosei_trans_s1024 (flash, bf16), robot_demo
     (pallas, gates set) and ren_mme (pallas_fused), 4 seeded members each,
     the bucket-8 ensemble forward and the batch-1 packed predict bit-equal
     to the eager path, each replayed call traced (one graph launch, no
     host kernel launch, and each hand-written kernel's device events a
     call equal to what the graphs' ledgers credit, the server's and the
     paragraph step's too), bucket-8 wall and idle share and batch-1 p50
     graphed and eager, and BatchingServer's host-to-device copies a batch
     (one); the paragraph step of 5 mosei_realformer members the same way
     (clip p50); the HTTP front end over robot_demo (binary wire bit-equal
     and JSON float32-exact to in-process predicts, 400s, req/s of 16
     concurrent clients on each wire and of direct submits); `cli export
     ren_mme --batch 8` on the card against ensemble_serve_fn(impl="xla"),
     its size and call time; run_predict of mosei_trans at the float16,
     bfloat16 and int8 wires against f32, the H2D bytes of a batch, and
     `cli train --transfer-dtype float16` on f16-grid features against f32.
     Phase 13's resume check runs its cut and resumed runs through the
     asynchronous store (--async-checkpoint) and reports the time each
     save holds the fit, synchronous and asynchronous.
 17. drivers: the whole-run drivers (train/device_epochs.py,
     vmap_kfold.py, sweep.py), every step one replay of a captured CUDA
     graph: the Trainer's 8 captured steps (2 epochs of 4, an eval pass
     after each) of mosei_trans (pallas_fused), ren_mme (dropout 0.1,
     R-Drop, 16 pairs) and robot_demo (pallas, dropout 0.1, gates set)
     bit-equal to a loop of eager engine.train_step (losses, parameters,
     moments, count, LR, step, dropout generator) with the same launches,
     each captured program's replay traced (one graph launch, no host
     kernel launch but PyTorch's two generator fills of a step that draws
     dropout, each kernel's device events equal to its ledger's credit,
     the backward kernels that autograd launches from its own thread
     included); every driver at pallas_fused held to phase 13's bounds
     against xla at phase 13's cell (the host-fed lockstep and
     scan_steps=4 against the sequential run_experiment, device-resident
     and one-dispatch against the device-resident run at xla); then
     run_experiment of mosei_trans at its reference width over 4 folds of
     4096 synthetic pairs, 2 epochs: the lockstep host-fed against the
     sequential run at xla, device-resident against the device-resident
     run at xla (epoch losses within FOLD_LOSS_TOL, best epochs and
     decisions as phase 13's), beside a witness (the xla run against itself
     from parameters moved by one ulp), scan_steps=4 and one-dispatch
     bit-equal to the lockstep and device-resident runs, each with its
     wall per member-epoch, the device's busy and idle share over epoch 2
     profiled whole, staging seconds and bytes and peak memory; the
     sequential host-fed driver at pallas_fused on member 1 (the cut),
     bit-equal to the lockstep's member 1, epoch 2 profiled whole;
     accumulation at mosei_trans_s1024 (flash, bf16, B 64), accum_steps 1,
     2 and 4, step-1 gradients against the unaccumulated step (5e-2) and
     each one's peak memory; predict_all_staged bit-equal to predict_all
     on 4 restored mosei_trans and ren_mme members; the sweep over 4 lrs
     on a 1,024-pair split, its member at the config's lr bit-equal to
     fit_fully_compiled.  The phases before it run run_experiment's
     default, the sequential driver.
 18. tools: the port's CLI tools at full width: `doctor` (its JSON line;
     every floor positive, no GEMM share over 105 % of its peak);
     `summary` of the five families and mosei_trans_s1024 (each total equal
     to the built model's count and the JAX model's); four seeded ren_mme
     members through `export-torch` and `import-torch` (bit-equal), then
     `acceptance ren_mme` over a written Ren-MME tree at pallas_fused, the
     ensemble's logits held against xla (2e-4) with its decisions; the
     robot golden demo through `acceptance robot_demo` at pallas from
     gate-set members over a written robot tree (probabilities within 2e-4
     of xla); `tune mosei_trans_s1024 --arms scan,remat,impl --steps 4
     --reps 2` (no arm in error) and remat's step-1 gradients at s1024 the
     same bits as without it, with each one's peak memory and launches;
     short `cli train` runs with --tuned (the applied knobs),
     --profile-dir (the traces name fused_block) and --debug-nans with a
     NaN in one feature (it must raise, naming the module).
Then one JSON line of the kernels, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that line.
Details go to chip_smoke_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_JSON = ROOT / "chip_smoke_out" / "chip_smoke.json"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; FLOP/s by type —
# bf16 on the tensor cores, f32 outside them (TF32 is off in this script)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# f32 work on the tensor cores as the split-TF32 kernels take it: three
# TF32 products (495 TFLOP/s dense) for each f32 one
SPLIT_TF32_FLOPS = 495e12 / 3

F32_TOL = 1e-5     # f32 with TF32 off: only summation order differs
BF16_TOL = 5e-2    # bf16 operands and output (tests/test_flash.py:90)
# emitted scores, elementwise: |S − S_plain| ≤ 1e-5 · max(1, |S_plain|) (the
# rtol of tests/test_pallas.py:37-38; masked entries sit near −1e8 or
# −(1 + c)·1e8, where the f32 spacing is 8 to 16)
SCORE_RTOL = 1e-5
# served robot_demo logits, f32 end to end, against impl="xla"
# (tests/test_interop.py:20)
ROBOT_TOL = 2e-4

# the nine (Lq, Lkv) stream shapes of mosei_trans_s1024 (l/v/a = 128/256/512)
S1024_LENS = (128, 256, 512)
S1024_HEADS, S1024_DH, SERVE_BUCKET = 8, 128, 8
S1024_PARAMS = 57_584_096
N_MEMBERS, N_CONCURRENT, N_STREAMING = 4, 16, 4
# robot_demo: lengths l/v/a 25/100/100, 6 heads of 32; the nine (Lq, Lkv)
# stream shapes in the grid's stream order (ll, lv, la, vv, vl, va, aa, al,
# av); 5,662,397 parameters per member (the JAX model's eval_shape)
STREAM_PAIRS = (("l", "l"), ("l", "v"), ("l", "a"), ("v", "v"), ("v", "l"),
                ("v", "a"), ("a", "a"), ("a", "l"), ("a", "v"))
ROBOT_LEN = {"l": 25, "v": 100, "a": 100}
ROBOT_SHAPES = tuple((ROBOT_LEN[q], ROBOT_LEN[kv]) for q, kv in STREAM_PAIRS)
ROBOT_HEADS, ROBOT_DH, ROBOT_PARAMS = 6, 32, 5_662_397
# scored_fwd variants (has S_prev, emits S); a stream's block 0 runs the
# first, its block 1 the second
MAIN_VARIANTS = ((False, True), (True, False))
# mosei_realformer: lengths l/v/a 50/50/50, so its nine stream shapes are all
# 50 x 50; 6 heads of 16; a batch of 64 paragraphs of 6 clips folds into
# B·P = 384 clips per attention call; 1,449,702 parameters (the JAX model's
# init)
RF_LEN, RF_HEADS, RF_DH, RF_P, RF_BATCH = 50, 6, 16, 6, 64
RF_CLIPS = RF_BATCH * RF_P
RF_PARAMS = 1_449_702
# its training run: 256 / 64 synthetic paragraphs and 2 epochs give 8
# optimizer steps and 2 eval passes; step-1 gradients per tensor against
# impl="xla" at relative L2 2e-4 (tests/test_interop.py:20), the 8 losses at
# 1e-3 relative, both f32 with TF32 off
RF_N_TRAIN, RF_N_VALID, RF_EPOCHS = 256, 64, 2
RF_GRAD_TOL, RF_LOSS_TOL = 2e-4, 1e-3
# the step-1 gradient check pins the ReLUs' routing to the pallas forward's;
# rounding may move at most this share of the ReLU inputs across 0, and no
# max-pool argmax
RF_RELU_FLIP_SHARE = 1e-6
# paragraph serving: the config's n_folds members, offsets of
# tests/test_train_eval.py:903, clip-t logits against the whole-window xla
# forward at 2e-4 (normalised)
RF_MEMBERS = 5
RF_OFFSETS = (0.1, -0.3, -0.5, -0.6, -0.3, -0.5)
# mosei_trans at its reference width: lengths l/v/a 20/100/200, dim 96, 6
# heads of 16, one minus block per stream; 588,192 parameters (the JAX
# model's init).  Trained at impl="pallas_fused": one member, batch 64, f32,
# AdamW, 256 / 64 synthetic pairs for 2 epochs (8 steps, 2 eval passes);
# losses at 1e-3 relative and step-1 gradients at 2e-4 relative L2 against
# impl="xla" (tests/test_interop.py:20), the max pool's routing pinned to
# the fused forward's, which may route at most this share of the pooled
# columns otherwise
MT_LEN = {"l": 20, "v": 100, "a": 200}
MT_SHAPES = tuple((MT_LEN[q], MT_LEN[kv]) for q, kv in STREAM_PAIRS)
MT_HEADS, MT_DH, MT_BATCH, MT_PARAMS = 6, 16, 64, 588_192
MT_N_TRAIN, MT_N_VALID, MT_EPOCHS = 256, 64, 2
MT_GRAD_TOL, MT_LOSS_TOL, MT_POOL_FLIP_SHARE = 2e-4, 1e-3, 1e-4
# the chained check: an n_layers=2 member (1,097,394 parameters) at batch 8,
# every gate c ~ U(0.25, 1.0)
MT_CHAINED_BATCH = 8
# ren_mme at its reference width: lengths l/v/a 40/76/275, dim 128, 8 heads
# of 16, the linear_ln unify; 1,317,544 parameters (the JAX model's init);
# served in eval mode, where its dropout 0.1 is inactive
REN_LEN = {"l": 40, "v": 76, "a": 275}
REN_SHAPES = tuple((REN_LEN[q], REN_LEN[kv]) for q, kv in STREAM_PAIRS)
REN_HEADS, REN_DH, REN_PARAMS = 8, 16, 1_317_544
# ren_mme training (Ren-MME/run.py): 16 pairs a step, each duplicated for
# R-Drop into adjacent rows (32 rows), f32, AdamW, dropout 0.1; 64 / 16
# synthetic pairs and 2 epochs give 8 optimizer steps and 2 eval passes of
# one batch.  robot_demo training: batch 64, 256 / 64 synthetic samples, 2
# epochs, gates set, dropout 0.1.  Both against impl="xla" from the same
# weights, batches and dropout generator seed: the 8 losses and each
# epoch's valid loss at 1e-3 relative, the step-1 gradients at 2e-4
# relative L2 per tensor
# (tests/test_interop.py:20), f32 with TF32 off
REN_PAIRS, REN_N_TRAIN, REN_N_VALID, REN_EPOCHS = 16, 64, 16, 2
ROBOT_BATCH, ROBOT_N_TRAIN, ROBOT_N_VALID, ROBOT_EPOCHS = 64, 256, 64, 2
DROP_GRAD_TOL, DROP_LOSS_TOL = 2e-4, 1e-3
# the kernels phase holds scored_fwd and scored_bwd at these training
# shapes: (B, Lq, Lkv, H, dh, mask, q scale), ren_mme's nine at B 32 (16
# R-Drop pairs; 8 heads of 16) and robot_demo's at B 64 (6 heads of 32,
# its chained variants); fused_block at ren_mme's, its eval passes
TRAIN_DROPOUT_SHAPES = tuple(
    [(2 * REN_PAIRS, lq, lkv, REN_HEADS, REN_DH, "zero_row", 1.0)
     for lq, lkv in REN_SHAPES]
    + [(ROBOT_BATCH, lq, lkv, ROBOT_HEADS, ROBOT_DH, "zero_row", 1.0)
       for lq, lkv in ROBOT_SHAPES])
# rencecps at its reference width (dim 2304, 42,390 parameters, batch 64,
# AdamW): 256 / 64 synthetic pairs, 2 epochs, held against the port's own
# CPU run of the same fit at the bounds above
RC_BATCH, RC_N_TRAIN, RC_N_VALID, RC_EPOCHS, RC_PARAMS = 64, 256, 64, 2, 42_390
# the dropout check: keep rate within 5 sigma of 1 - rate over this many
# elements, kept values exactly x / keep, the same bits from the same seed
DROPOUT_N, DROPOUT_RATE = 1 << 21, 0.1
# fused_block edge cases: (B, Lq, Lkv, H, dh, mask); dh 1 and 256, Lq 1,
# ragged Lkv 275 and 1000, no mask, and fully masked rows under S_prev
# from a previous block (c = 0.7); one head (a cluster of one block), 12
# heads of 8 (more than a cluster's 8 blocks), one s1024 stream shape (D
# 1024, dh 128), and ren_mme's longest streams at batch 1
FUSED_EDGE_CASES = (
    (2, 20, 50, 2, 1, "zero_row"), (2, 70, 300, 2, 256, "zero_row"),
    (3, 1, 100, 6, 16, "zero_row"), (2, 37, 275, 8, 16, "ragged"),
    (2, 33, 1000, 4, 64, "ragged"), (2, 64, 64, 6, 32, "none"),
    (4, 100, 200, 6, 16, "zero_row"), (2, 37, 77, 1, 64, "zero_row"),
    (2, 40, 100, 12, 8, "zero_row"), (2, 128, 512, 8, 128, "zero_row"),
    (1, 40, 275, 8, 16, "zero_row"), (1, 275, 76, 8, 16, "zero_row"))
# the fused_block library's HMMA count when only its score dots ran on the
# tensor cores: with every product on them it must count more
FUSED_SCORE_DOTS_HMMA = 744
# fused_block's row stats against scored_fwd's: m bit-equal, l within this
# relative error (the two kernels may split a tile's keys over warps
# differently)
FUSED_L_RTOL = 1e-6
# scored_fwd edge cases: (B, Lq, Lkv, H, dh, mask); dh 1/16/48/256, ragged
# Lkv up to 1024, Lq 1, no mask; every "zero_row" case has a fully masked
# row, whose S_prev (block 0's output) holds -1e8 + raw under c = 0.7
SCORED_EDGE_CASES = (
    (2, 20, 50, 2, 1, "zero_row"), (2, 37, 77, 2, 16, "zero_row"),
    (3, 33, 77, 3, 48, "ragged"), (2, 70, 300, 2, 256, "zero_row"),
    (2, 64, 1024, 4, 64, "zero_row"), (2, 128, 1000, 2, 128, "ragged"),
    (3, 1, 100, 6, 32, "zero_row"), (2, 64, 64, 6, 32, "none"),
    (1, 1, 1, 1, 1, "ragged"))
# the score-chained kernels' fully masked rows with q x 4 at the main paths'
# head widths: raw scores straddle +-4, so -1e8 + raw and -(1 + c) 1e8 + raw
# land on neighbouring multiples of 8, and the forward's S, the s its
# backward rebuilds and fused_block's S must come from one chain
SCORED_QX4_CASES = ((2, 64, 77, 2, 16, "zero_row", 4.0),
                    (2, 64, 77, 2, 32, "zero_row", 4.0))
# the experiment phase: mosei_trans (dim 96, f32, AdamW) through
# pipelines.run_experiment with the config's 4 folds; fold_size 4096 x 4
# exceeds 512 samples, so the folds are the fractional carving's 128 each;
# 2 epochs, 128 test pairs.  Against the same experiment at impl="xla":
# each epoch's train and valid loss at 1e-3 relative, the ensemble's
# logits at 2e-4 normalised (tests/test_interop.py:20), the decisions equal
# wherever a logit lies 1e-4 or more from its threshold.  Its resume check:
# 2 folds of 128, 4 epochs, cut in member 1's epoch 2.  Stores and
# checkpoints go under STORES and are removed after each phase
STORES = ROOT / "chip_smoke_out" / "stores"
EXP_FOLDS, EXP_N_TRAIN, EXP_N_TEST, EXP_EPOCHS = 4, 512, 128, 2
EXP_LOSS_TOL, EXP_LOGIT_TOL, EXP_MARGIN = 1e-3, 2e-4, 1e-4
EXP_RESUME_N, EXP_RESUME_EPOCHS = 256, 4
# the families' experiments, 1 epoch each: ren_mme 2 folds of 64 pairs (16
# a step) and 64 test pairs; mosei_realformer 3 folds of 64 paragraphs and
# 64 test paragraphs; mosei_trans_s1024 4 seeded members over 64 test
# samples.  A swept or gridded threshold that differs from the one found on
# the xla logits must score within this of it
FAM_EPOCHS = 1
FAM_REN_N_TRAIN, FAM_REN_N_TEST = 128, 64
FAM_RF_N_TRAIN, FAM_RF_N_TEST = 192, 64
FAM_S1024_N_TEST = 64
FAM_OBJECTIVE_TOL = 1e-6
# the real-corpus phase: trees written at the reference widths under
# REAL_ROOT and removed after it.  Ren-MME: episodes 1-8 train and 9-10
# test, 4 dialogues of 4 sentences each (128 / 32 utterances), lengths drawn
# up to twice the model's (so truncation runs), video 1_1_3 missing.  The
# shared Ren tree: cet_1..cet_1487, 768-d BERT tokens, 3 to REAL_REN_TOKENS
# per sentence.  Robot: REAL_ROBOT_CLIPS clips.  ren_mme trains 2 folds of
# 64 for 1 epoch, robot_demo 2 folds of 64 for 2 epochs (so epoch 1's
# resample runs), rencecps 2 folds for 1 epoch; each against impl="xla"
# (rencecps against the same run on the CPU) with the experiment's bounds
REAL_ROOT = ROOT / "chip_smoke_out" / "real_data"
REAL_SEED = 11
REAL_REN_TOKENS = 50
REAL_ROBOT_CLIPS = 128
REAL_FOLDS = 2
REAL_EPOCHS = {"ren_mme": 1, "robot_demo": 2, "rencecps": 1,
               "mosei_trans": 1}
REAL_MISSING_VIDEO = "1_1_3"
# serve_io: p50s over this many calls; the HTTP front end with HTTP_CLIENTS
# concurrent clients sending HTTP_ROUNDS requests each on each wire, after
# HTTP_SEQUENTIAL sequential ones (one bucket-1 program, as in-process
# predict); the export against impl="xla" at EXPORT_RTOL relative (max
# error over max |ref|); the wire: run_predict over WIRE_N_TEST samples
# from one seeded member against f32 (float16 ~1e-3 relative rounding,
# bfloat16 ~1e-2, int8 at most half a step of its row's max / 127 a
# feature), and `cli train` at WIRE_FOLDS folds of WIRE_N_TRAIN pairs,
# WIRE_EPOCHS epochs, on features on the float16 grid, whose losses the
# float16 wire leaves within WIRE_TRAIN_RTOL (tests/test_transfer.py:142-160)
SERVE_IO_P50_CALLS, SERVE_IO_TRACE_REPS = 9, 3
HTTP_CLIENTS, HTTP_ROUNDS, HTTP_SEQUENTIAL = 16, 2, 4
EXPORT_RTOL = 1e-6
WIRE_N_TEST, WIRE_N_TRAIN, WIRE_FOLDS, WIRE_EPOCHS = 128, 256, 2, 2
WIRE_TRAIN_RTOL = 1e-6
WIRE_PREDICT_BOUNDS = {"float16": 1e-2, "bfloat16": 5e-2, "int8": 2e-1}
# training: configs.SCALE_POINTS["s1024"] batch 64; 256 / 64 synthetic
# samples and 2 epochs give 8 optimizer steps and 2 eval passes
TRAIN_BATCH, N_TRAIN, N_VALID, TRAIN_EPOCHS = 64, 256, 64, 2
# backward edge cases: (B, Lq, Lkv, H, dh, mask, q scale); ragged Lkv, head
# widths, Lq 1, no mask, and a fully masked row whose raw scores straddle
# +-4 (q x 4), where -1e8 + raw rounds to a neighbouring multiple of 8: with
# q x 4 at each head-width bucket that takes the tensor cores in bf16 (16,
# 32, 64, 128), at Lq and Lkv that are not multiples of the 64-wide tiles
# and at Lq 1, these fail if the forward and the two backward kernels do
# not compute every score with the same bits
BWD_EDGE_CASES = (
    (2, 37, 1, 2, 16, "zero_row", 1.0), (2, 37, 20, 2, 16, "zero_row", 1.0),
    (2, 37, 77, 2, 16, "zero_row", 1.0), (2, 37, 100, 2, 16, "ragged", 1.0),
    (2, 37, 200, 2, 16, "zero_row", 1.0), (2, 37, 300, 2, 16, "zero_row", 1.0),
    (2, 128, 1024, 8, 128, "zero_row", 1.0), (2, 20, 50, 2, 1, "zero_row", 1.0),
    (2, 20, 50, 2, 48, "zero_row", 1.0), (2, 70, 300, 2, 256, "zero_row", 1.0),
    (3, 1, 100, 2, 64, "ragged", 1.0), (2, 64, 64, 8, 128, "none", 1.0),
    (2, 64, 77, 2, 16, "zero_row", 4.0), (2, 64, 77, 2, 32, "zero_row", 4.0),
    (2, 64, 77, 2, 64, "zero_row", 4.0), (2, 64, 77, 2, 128, "zero_row", 4.0),
    (2, 96, 130, 4, 128, "zero_row", 4.0), (2, 1, 77, 2, 128, "zero_row", 4.0),
    (2, 50, 33, 2, 3, "zero_row", 4.0))
# the instruction the bf16 flash kernels use for every product, up to dh 128
FLASH_MMA = "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32"
# the score-chained kernels' instruction, every f32 operand split into two
# TF32 terms and each product taken as three (csrc/scored_mma.cuh)
SCORED_MMA = "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
SCORED_INSTRUCTION = (f"{SCORED_MMA} for every product, each f32 operand as "
                      "hi + lo TF32 terms, three products into f32 "
                      "accumulators (the two small terms into their own)")


def log(msg: str) -> None:
    print(msg, flush=True)


def ptxas_kernels(report: str) -> list:
    """(kernel, registers, bytes spilled) per kernel function of an
    `nvcc -Xptxas -v` report, the kernel named from its mangled entry as
    name<template arguments>, e.g. flash_bwd_dkv_mma_kernel<128>."""
    import re

    rows, name, spill = [], None, 0
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            base = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)I(\w*?)EE", mangled)
            if base:
                args = base.group(2)
                targs = (["bf16"] if "bfloat16" in args else
                         ["f32"] if args.startswith("f") else [])
                targs += re.findall(r"L[ib](\d+)", args)
                name = f"{base.group(1)}<{','.join(targs)}>"
            else:
                name = mangled
            spill = 0
            continue
        stores = re.search(r"(\d+) bytes spill stores", line)
        if stores and name:
            spill = int(stores.group(1))
            continue
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            rows.append((name, int(used.group(1)), spill))
            name = None
    return rows


def tensor_core_counts(path) -> dict:
    """Per kernel function of a built library, the count of tensor-core
    instructions (HMMA, HGMMA) in its machine code, from `cuobjdump -sass`;
    empty when the toolkit has no cuobjdump."""
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or (
        str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME else None)
    if not tool or not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound(b, h, lq, lkv, dh, dtype_name, mask_itemsize):
    """Least time for o = softmax(q·kᵀ/√dh + neg)·v on this card: q, k, v
    and the mask read once and o written once, against the two products'
    flops at the peak of the operand type."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    nbytes = (2 * b * lq * d + 2 * b * lkv * d) * itemsize + b * lkv * mask_itemsize
    return _bound(nbytes, 4.0 * b * h * lq * lkv * dh, dtype_name)


def _bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def backward_bounds(b, h, lq, lkv, dh, dtype_name, mask_itemsize):
    """Least times for the backward on this card.  Each kernel: its inputs
    (q, o, do, k, v, the mask and the f32 stats m, l) read once and its
    outputs written once, against the products it must do: s, dp and dq
    (6 B·H·Lq·Lkv·dh flops) for flash_bwd_dq; s, dp, dv and dk (8) for
    flash_bwd_dkv.  The pair: q, k, v, o, do and the mask read once, dq, dk
    and dv written once, against 10 B·H·Lq·Lkv·dh flops."""
    it = 2 if dtype_name == "bfloat16" else 4
    q_like = b * lq * h * dh * it
    kv_like = b * lkv * h * dh * it
    ins = 3 * q_like + 2 * kv_like + b * lkv * mask_itemsize
    stats = 2 * b * h * lq * 4
    unit = float(b * h * lq * lkv * dh)
    return {"flash_bwd_dq": _bound(ins + stats + q_like, 6 * unit, dtype_name),
            "flash_bwd_dkv": _bound(ins + stats + 2 * kv_like, 8 * unit,
                                    dtype_name),
            "pair": _bound(ins + q_like + 2 * kv_like, 10 * unit, dtype_name)}


def errors(got, ref):
    """(max abs error, max abs error / max(1, max |ref|))."""
    abs_err = (got.float() - ref.float()).abs().max().item()
    return abs_err, abs_err / max(1.0, ref.float().abs().max().item())


def dmask_term_scale(torch, q, k, v, mask, o, do, m, l, h):
    """1e8 · max_j Σ_{h,i} p (|dp| + |delta|): the size of the terms that the
    dmask sum 1e8 Σ_i p (dp − delta) adds up.  Those terms cancel (with one
    key, p = 1 and dp = delta: every ds is 0 up to rounding), so the
    result is no scale for its own rounding error; the terms are."""
    from multimodal_emotion_processing_tpu_torch.ops.attention import (
        MASK_PENALTY, split_heads)

    qh, kh, vh, oh, doh = (split_heads(t, h).float() for t in (q, k, v, o, do))
    s = (qh @ kh.transpose(-2, -1)) / (qh.shape[-1] ** 0.5)
    s = s - MASK_PENALTY * (1.0 - mask.float()[:, None, None, :])
    p = torch.exp(s - m[..., None]) / l[..., None]
    dp = doh @ vh.transpose(-2, -1)
    delta = (doh * oh).sum(dim=-1, keepdim=True)
    return (MASK_PENALTY * (p * (dp.abs() + delta.abs())).sum(dim=(1, 2))
            ).max().item()


def sdpa_backward_ms(torch, q, k, v, bias, do, h):
    """The library yardstick for a backward: SDPA forward + backward minus
    SDPA forward, with the float bias the kernel's scores carry, on
    head-split copies."""
    from multimodal_emotion_processing_tpu_torch.ops.attention import split_heads

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (split_heads(t, h).detach().contiguous().requires_grad_(True)
                  for t in (q, k, v))
    doh = split_heads(do, h).contiguous()
    fwd = time_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=bias))
    both = time_ms(torch, lambda: torch.autograd.grad(
        sdpa(qh, kh, vh, attn_mask=bias), (qh, kh, vh), doh))
    return both - fwd


def attention_inputs(torch, g, b, lq, lkv, h, dh, dtype, mask_kind):
    d = h * dh
    q = torch.randn(b, lq, d, generator=g, device="cuda").to(dtype)
    k = torch.randn(b, lkv, d, generator=g, device="cuda").to(dtype)
    v = torch.randn(b, lkv, d, generator=g, device="cuda").to(dtype)
    if mask_kind == "none":
        return q, k, v, None
    # a ragged valid prefix per row, like summary masking gives, and row 0
    # fully masked (the no_name sample) when asked for
    lens = torch.randint(1, lkv + 1, (b,), generator=g, device="cuda")
    mask = (torch.arange(lkv, device="cuda")[None, :] < lens[:, None]).to(dtype)
    if mask_kind == "zero_row":
        mask[0] = 0
    return q, k, v, mask


def phase_kernels(torch, report):
    from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_processing_tpu_torch.ops.attention import (
        MASK_PENALTY, split_heads)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for lq in S1024_LENS:
            for lkv in S1024_LENS:
                cases.append(dict(main=True, dtype=dtype, b=SERVE_BUCKET, lq=lq,
                                  lkv=lkv, h=S1024_HEADS, dh=S1024_DH,
                                  mask="zero_row"))
        for (b, lq, lkv, h, dh, mask) in (
                (4, 128, 64, 8, 128, "ragged"), (3, 37, 100, 6, 16, "ragged"),
                (2, 20, 200, 2, 16, "zero_row"), (2, 5, 20, 2, 16, "zero_row"),
                (2, 64, 64, 8, 128, "none"), (2, 128, 1024, 8, 128, "zero_row"),
                (2, 70, 300, 4, 256, "zero_row"), (2, 33, 77, 3, 48, "zero_row"),
                (1, 1, 1, 1, 1, "ragged")):
            cases.append(dict(main=False, dtype=dtype, b=b, lq=lq, lkv=lkv,
                              h=h, dh=dh, mask=mask))
    rows, ok = [], True
    for c in cases:
        dname = str(c["dtype"]).removeprefix("torch.")
        q, k, v, mask = attention_inputs(torch, g, c["b"], c["lq"], c["lkv"],
                                         c["h"], c["dh"], c["dtype"], c["mask"])
        out = fa.flash_forward_kernel(q, k, v, mask, n_heads=c["h"])
        torch.cuda.synchronize()
        ref = fa.flash_forward_plain(q, k, v, mask, n_heads=c["h"])
        abs_err, err = errors(out, ref)
        tol = BF16_TOL if c["dtype"] == torch.bfloat16 else F32_TOL
        good = bool(torch.isfinite(out).all().item()) and err <= tol
        ok &= good
        row = dict(dtype=dname, b=c["b"], lq=c["lq"], lkv=c["lkv"], h=c["h"],
                   dh=c["dh"], mask=c["mask"], main_path=c["main"],
                   max_abs_err=abs_err, max_norm_err=err, tol=tol, ok=good)
        if c["main"]:
            qh, kh, vh = (split_heads(t, c["h"]).contiguous() for t in (q, k, v))
            bias = (-MASK_PENALTY * (1.0 - mask.float())).to(c["dtype"])[:, None, None, :]
            row["ms"] = time_ms(torch, lambda: fa.flash_forward_kernel(
                q, k, v, mask, n_heads=c["h"]))
            row["plain_ms"] = time_ms(torch, lambda: fa.flash_forward_plain(
                q, k, v, mask, n_heads=c["h"]))
            row["library_ms"] = time_ms(
                torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=bias))
            row.update(attention_bound(c["b"], c["h"], c["lq"], c["lkv"],
                                       c["dh"], dname, mask.element_size()))
        rows.append(row)
        timing = (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                  f"library_ms={row['library_ms']:.4f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                  if c["main"] else "")
        log(f"[kernels] flash_fwd {dname} B={c['b']} Lq={c['lq']} "
            f"Lkv={c['lkv']} H={c['h']} dh={c['dh']} mask={c['mask']} "
            f"max_abs_err={abs_err:.3e} norm_err={err:.3e} tol={tol:g} "
            f"{'ok' if good else 'FAIL'}{timing}")
    report["kernel_cases"] = rows
    if not ok:
        raise AssertionError("flash_fwd disagrees with its plain version")
    main_bf16 = [r for r in rows if r["main_path"] and r["dtype"] == "bfloat16"]
    summary = {k: sum(r[k] for r in main_bf16)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    summary["bound_by"] = majority_bound(main_bf16)
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    summaries = {"flash_fwd": summary}
    summaries.update(backward_cases(torch, g, report))
    summaries["scored_fwd"] = scored_cases(torch, g, report)
    summaries.update(scored_bwd_cases(torch, g, report))
    summaries["fused_block"] = fused_cases(torch, g, report)
    report["dropout_check"] = dropout_check(torch)
    return summaries


def dropout_check(torch):
    """The port's dropout on the card, from a CUDA torch.Generator: the keep
    share over DROPOUT_N elements within 5 sigma of 1 - rate, every kept
    value x / keep exactly (numpy's IEEE f32 division on the host), every
    other 0, the same bits from the same seed and other bits from another
    seed; and its time."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch.models.layers import dropout

    keep = 1.0 - DROPOUT_RATE
    x = torch.randn(DROPOUT_N, generator=torch.Generator(device="cuda")
                    .manual_seed(3), device="cuda").abs() + 0.5

    def run(seed):
        y = dropout(x, DROPOUT_RATE,
                    torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return y

    y = run(11)
    kept = (y != 0).cpu().numpy()
    share = float(kept.mean())
    sigma = (keep * DROPOUT_RATE / DROPOUT_N) ** 0.5
    want = x.cpu().numpy() / np.float32(keep)
    exact = bool(np.array_equal(y.cpu().numpy()[kept], want[kept]))
    same = bool(torch.equal(run(11), y))
    other = not torch.equal(run(12), y)
    g = torch.Generator(device="cuda").manual_seed(11)
    ms = time_ms(torch, lambda: dropout(x, DROPOUT_RATE, g))
    out = dict(n=DROPOUT_N, rate=DROPOUT_RATE, keep_share=share,
               z=(share - keep) / sigma, kept_exact=exact, same_seed_equal=same,
               other_seed_differs=other, ms=ms)
    log(f"[kernels] dropout on the card, {DROPOUT_N} f32 elements at rate "
        f"{DROPOUT_RATE}: keep share {share:.6f} ({out['z']:+.2f} sigma), "
        f"kept values x / keep exactly: {exact}, same seed same bits: {same},"
        f" another seed other bits: {other}; {ms:.4f} ms a call")
    if not (abs(out["z"]) < 5 and exact and same and other):
        raise AssertionError(f"dropout on the card: {out}")
    return out


def majority_bound(rows, key="bound_by"):
    return ("operations" if sum(r[key] == "operations" for r in rows) * 2
            > len(rows) else "bytes")


def backward_cases(torch, g, report):
    """flash_fwd with its stats, flash_bwd_dq and flash_bwd_dkv against
    flash_forward_plain / flash_backward_plain, each side from its own
    forward: the nine s1024 stream shapes at the training batch (timed) and
    the edge cases, in bf16 and f32."""
    from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_processing_tpu_torch.ops.attention import MASK_PENALTY

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for lq in S1024_LENS:
            for lkv in S1024_LENS:
                cases.append((True, dtype, (TRAIN_BATCH, lq, lkv, S1024_HEADS,
                                            S1024_DH, "zero_row", 1.0)))
        cases += [(False, dtype, c) for c in BWD_EDGE_CASES]
    rows, ok = [], True
    for main, dtype, (b, lq, lkv, h, dh, mask_kind, q_scale) in cases:
        dname = str(dtype).removeprefix("torch.")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        q, k, v, mask = attention_inputs(torch, g, b, lq, lkv, h, dh, dtype,
                                         mask_kind)
        if q_scale != 1.0:
            q = (q.float() * q_scale).to(dtype)
        do = torch.randn(b, lq, h * dh, generator=g, device="cuda").to(dtype)
        o, m, l = fa.flash_forward_kernel(q, k, v, mask, n_heads=h, stats=True)
        args = (q, k, v, mask, o, do, m, l)
        dq = fa.flash_bwd_dq_kernel(*args, n_heads=h)
        dk, dv, dmask = fa.flash_bwd_dkv_kernel(*args, n_heads=h)
        torch.cuda.synchronize()
        ro, rm, rl = fa.flash_forward_plain(q, k, v, mask, n_heads=h, stats=True)
        ref = fa.flash_backward_plain(q, k, v, mask, ro, do, rm, rl, n_heads=h)
        errs = {name: errors(got, want) for name, got, want in (
            ("o", o, ro), ("l", l, rl), ("dq", dq, ref[0]), ("dk", dk, ref[1]),
            ("dv", dv, ref[2]))}
        if mask is not None:
            abs_err = (dmask - ref[3]).abs().max().item()
            errs["dmask"] = (abs_err, abs_err / max(
                1.0, ref[3].abs().max().item(),
                dmask_term_scale(torch, q, k, v, mask, ro, do, rm, rl, h)))
        # m is about -1e8 in a fully masked row: each row at its own scale
        m_err = ((m - rm).abs() / rm.abs().clamp(min=1.0)).max().item()
        finite = all(bool(torch.isfinite(t).all().item())
                     for t in (o, m, l, dq, dk, dv))
        good = (finite and m_err <= F32_TOL and errs["l"][1] <= F32_TOL
                and all(e[1] <= tol for n, e in errs.items() if n != "l"))
        ok &= good
        row = dict(dtype=dname, b=b, lq=lq, lkv=lkv, h=h, dh=dh, mask=mask_kind,
                   q_scale=q_scale, main_path=main, tol=tol, ok=good,
                   m_row_rel_err=m_err,
                   **{f"{n}_abs_err": e[0] for n, e in errs.items()},
                   **{f"{n}_norm_err": e[1] for n, e in errs.items()})
        timing = ""
        if main:
            row["fwd_stats_ms"] = time_ms(torch, lambda: fa.flash_forward_kernel(
                q, k, v, mask, n_heads=h, stats=True))
            row["dq_ms"] = time_ms(torch, lambda: fa.flash_bwd_dq_kernel(
                *args, n_heads=h))
            # as the main path calls it: the batch masks need no gradient
            row["dkv_ms"] = time_ms(torch, lambda: fa.flash_bwd_dkv_kernel(
                *args, n_heads=h, want_dmask=False))
            row["plain_ms"] = time_ms(torch, lambda: fa.flash_backward_plain(
                q, k, v, mask, ro, do, rm, rl, n_heads=h))
            bias = (-MASK_PENALTY * (1.0 - mask.float())).to(dtype)[:, None, None, :]
            try:
                row["library_ms"] = sdpa_backward_ms(torch, q, k, v, bias, do, h)
            except RuntimeError as e:       # a yardstick only
                row["library_ms"] = None
                log(f"[kernels] SDPA backward not measured: {e}")
            for kname, bnd in backward_bounds(b, h, lq, lkv, dh, dname,
                                              mask.element_size()).items():
                row.update({f"{kname}_{key}": val for key, val in bnd.items()})
            lib = row["library_ms"]
            timing = (f" dq_ms={row['dq_ms']:.4f} dkv_ms={row['dkv_ms']:.4f} "
                      f"plain_ms={row['plain_ms']:.4f} library_ms="
                      + ("n/a" if lib is None else f"{lib:.4f}")
                      + f" pair_bound_ms={row['pair_bound_ms']:.4f} "
                      f"({row['pair_bound_by']})")
        rows.append(row)
        log(f"[kernels] flash_bwd {dname} B={b} Lq={lq} Lkv={lkv} H={h} dh={dh} "
            f"mask={mask_kind} q_scale={q_scale:g} norm_err "
            + " ".join(f"{n}={e[1]:.2e}" for n, e in errs.items())
            + f" m_rel={m_err:.1e} tol={tol:g} {'ok' if good else 'FAIL'}"
            + timing)
    report["backward_cases"] = rows
    if not ok:
        raise AssertionError("the backward kernels disagree with their plain "
                             "versions")
    main_bf16 = [r for r in rows if r["main_path"] and r["dtype"] == "bfloat16"]
    lib = [r["library_ms"] for r in main_bf16]
    out = {}
    for kname, ms_key, err_keys in (("flash_bwd_dq", "dq_ms", ("dq",)),
                                    ("flash_bwd_dkv", "dkv_ms", ("dk", "dv"))):
        out[kname] = dict(
            ms=sum(r[ms_key] for r in main_bf16),
            plain_ms=sum(r["plain_ms"] for r in main_bf16),
            library_ms=None if None in lib else sum(lib),
            bound_ms=sum(r[f"{kname}_bound_ms"] for r in main_bf16),
            bound_by=majority_bound(main_bf16, f"{kname}_bound_by"),
            max_abs_err=max(r[f"{e}_abs_err"] for r in rows for e in err_keys))
    out["pair"] = dict(
        ms=out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"],
        bound_ms=sum(r["pair_bound_ms"] for r in main_bf16),
        bound_by=majority_bound(main_bf16, "pair_bound_by"),
        fwd_stats_ms=sum(r["fwd_stats_ms"] for r in main_bf16))
    report["backward_summary"] = out
    log(f"[kernels] backward, sum over the nine s1024 shapes at B={TRAIN_BATCH} "
        f"bf16: dq {out['flash_bwd_dq']['ms']:.3f} ms, dkv "
        f"{out['flash_bwd_dkv']['ms']:.3f} ms (bounds "
        f"{out['flash_bwd_dq']['bound_ms']:.3f} / "
        f"{out['flash_bwd_dkv']['bound_ms']:.3f}; pair bound "
        f"{out['pair']['bound_ms']:.3f}), plain {out['flash_bwd_dq']['plain_ms']:.3f}"
        f" ms, SDPA backward {out['flash_bwd_dq']['library_ms']} ms; "
        f"forward with stats {out['pair']['fwd_stats_ms']:.3f} ms")
    return out


def scored_bound(b, h, lq, lkv, dh, dtype_name, has_sprev, emit):
    """Least time for one scored_fwd call on this card: q, k, v, the f32
    mask, S_prev (f32, when given) read once, ctx and S (f32, when emitted)
    written once, against the two products' 4·B·H·Lq·Lkv·dh flops at the
    peak of the operand type."""
    itemsize = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    scores = b * h * lq * lkv * 4
    nbytes = ((2 * b * lq * d + 2 * b * lkv * d) * itemsize + b * lkv * 4
              + scores * (int(has_sprev) + int(emit)))
    return _bound(nbytes, 4.0 * b * h * lq * lkv * dh, dtype_name)


def score_errors(got, ref):
    """max |S − S_plain| / max(1, |S_plain|), elementwise."""
    return ((got - ref).abs() / ref.abs().clamp(min=1.0)).max().item()


def kernel_device_ms(torch, calls, name: str, reps: int = 20):
    """Device time of the kernels whose name holds `name`, per pass over
    `calls`, from torch.profiler's CUDA events: what the card spends in the
    kernel, without the host's launch cost that CUDA events around a loop
    of short calls also count.  None where the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for fn in calls:
                fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name)
    return us / 1e3 / reps if us > 0 else None


def scored_cases(torch, g, report):
    """scored_fwd against scored_forward_plain, ctx and S, in its four
    variants, in f32 and bf16: the nine robot_demo stream shapes at B 8
    (the two variants of the main path timed in f32, the serving dtype),
    the edge cases, and the training shapes of ren_mme (B 32) and
    robot_demo (B 64).  S_prev is what block 0 emits (the plain version's
    S of another q on the same keys and mask), so it holds −1e8 + raw where
    the mask is 0; c is 0.7."""
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa
    from multimodal_emotion_processing_tpu_torch.ops.attention import (
        MASK_PENALTY, split_heads)

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for lq, lkv in ROBOT_SHAPES:
            cases.append((True, dtype, (SERVE_BUCKET, lq, lkv, ROBOT_HEADS,
                                        ROBOT_DH, "zero_row", 1.0)))
        cases += [(False, dtype, c + (1.0,)) for c in SCORED_EDGE_CASES]
        cases += [(False, dtype, c) for c in SCORED_QX4_CASES]
        cases += [(False, dtype, c) for c in TRAIN_DROPOUT_SHAPES]
    rows, ok, timed_calls = [], True, []
    for main, dtype, (b, lq, lkv, h, dh, mask_kind, q_scale) in cases:
        dname = str(dtype).removeprefix("torch.")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        q, k, v, mask = attention_inputs(torch, g, b, lq, lkv, h, dh, dtype,
                                         mask_kind)
        q = (q.float() * q_scale).to(dtype)
        q0 = torch.randn(b, lq, h * dh, generator=g, device="cuda").to(dtype)
        sprev = pa.scored_forward_plain(q0, k, v, mask, None, None,
                                        n_heads=h)[1].contiguous()
        c = torch.tensor([0.7], device="cuda").to(dtype)
        for has_sprev, emit in pa.VARIANTS:
            sp = sprev if has_sprev else None
            ctx, s = pa.scored_forward_kernel(q, k, v, mask, sp, c, n_heads=h,
                                              emit_scores=emit)
            torch.cuda.synchronize()
            rctx, rs = pa.scored_forward_plain(q, k, v, mask, sp, c, n_heads=h,
                                               emit_scores=emit)
            abs_err, err = errors(ctx, rctx)
            s_err = score_errors(s, rs) if emit else 0.0
            good = (bool(torch.isfinite(ctx).all().item()) and err <= tol
                    and s_err <= SCORE_RTOL and (s is None) == (not emit))
            ok &= good
            row = dict(dtype=dname, b=b, lq=lq, lkv=lkv, h=h, dh=dh,
                       mask=mask_kind, q_scale=q_scale, has_sprev=has_sprev,
                       emit=emit, main_path=main, max_abs_err=abs_err,
                       max_norm_err=err, score_rel_err=s_err, tol=tol, ok=good)
            timing = ""
            if main and dtype == torch.float32 and (has_sprev, emit) in MAIN_VARIANTS:
                qh, kh, vh = (split_heads(t, h).contiguous() for t in (q, k, v))
                bias = -MASK_PENALTY * (1.0 - mask.float())[:, None, None, :]
                if has_sprev:
                    bias = (bias + c.float() * sprev).contiguous()
                call = (lambda q=q, k=k, v=v, mask=mask, sp=sp, c=c, h=h, emit=emit:
                        pa.scored_forward_kernel(q, k, v, mask, sp, c, n_heads=h,
                                                 emit_scores=emit))
                timed_calls.append(call)
                row["ms"] = time_ms(torch, call)
                row["plain_ms"] = time_ms(torch, lambda: pa.scored_forward_plain(
                    q, k, v, mask, sp, c, n_heads=h, emit_scores=emit))
                row["library_ms"] = time_ms(
                    torch, lambda: torch.nn.functional.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=bias))
                row.update(scored_bound(b, h, lq, lkv, dh, dname, has_sprev, emit))
                timing = (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                          f"library_ms={row['library_ms']:.4f} "
                          f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
            rows.append(row)
            log(f"[kernels] scored_fwd {dname} B={b} Lq={lq} Lkv={lkv} H={h} "
                f"dh={dh} mask={mask_kind} q_scale={q_scale:g} sprev={int(has_sprev)} "
                f"emit={int(emit)} max_abs_err={abs_err:.3e} norm_err={err:.3e} "
                f"S_rel_err={s_err:.2e} tol={tol:g} {'ok' if good else 'FAIL'}"
                + timing)
    report["scored_cases"] = rows
    if not ok:
        raise AssertionError("scored_fwd disagrees with its plain version")
    timed = [r for r in rows if "ms" in r]
    summary = {k: sum(r[k] for r in timed)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    summary["bound_by"] = majority_bound(timed)
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    summary["max_score_rel_err"] = max(r["score_rel_err"] for r in rows)
    summary["calls_timed"] = len(timed)
    try:
        summary["device_ms"] = kernel_device_ms(torch, timed_calls, "scored_fwd")
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        summary["device_ms"] = None
    report["scored_summary"] = summary
    dev = summary["device_ms"]
    log(f"[kernels] scored_fwd, sum over the {len(timed)} calls of one "
        f"robot_demo member forward at B={SERVE_BUCKET} f32: "
        f"{summary['ms']:.4f} ms as the wrapper is called (CUDA events), "
        + ("device time not measured" if dev is None else
           f"{dev:.4f} ms device time (profiler)")
        + f"; bound {summary['bound_ms']:.4f} ({summary['bound_by']}), plain "
        f"{summary['plain_ms']:.4f} ms, SDPA with the float bias (ctx only, "
        f"no S) {summary['library_ms']:.4f} ms")
    return summary


def scored_bwd_bounds(b, h, lq, lkv, dh, dtype_name, has_sprev, emit):
    """Least times for the score-chained backward on this card, per kernel
    and for the pair.  The pair reads q, k, v, dctx, the forward's ctx and
    row stats (m, l) and the f32 mask once, S_prev when given, S and
    dscores when S was emitted, and writes dq, dk, dv and (with S_prev)
    dS_prev, against 8 B·H·Lq·Lkv·dh flops (dp, dq, dk, dv), 10 where s is
    rebuilt.  scored_bwd_dq: q, k, v, dctx, ctx, the mask, the stats,
    S_prev, S and dscores in; dq, the row stats with delta and dS_prev
    out; dp and dq (+ s).  scored_bwd_dkv: q, k, v, dctx, the mask, S and
    dscores (S_prev only where s is rebuilt) and the stats with delta in; dk
    and dv out; dp, dk and dv (+ s).  The flops are counted once, at the
    f32 rate outside the tensor cores, though the kernels take each f32
    product as three TF32 products on them."""
    it = 2 if dtype_name == "bfloat16" else 4
    q_like, kv_like = b * lq * h * dh * it, b * lkv * h * dh * it
    score = b * h * lq * lkv * 4
    stats = 3 * b * h * lq * 4
    fwd_stats = 2 * b * h * lq * 4
    common = 2 * q_like + 2 * kv_like + b * lkv * 4 + 2 * score * int(emit)
    unit = float(b * h * lq * lkv * dh)
    s_flops = 0 if emit else 2
    sprev_in = score * int(has_sprev)
    return {
        "scored_bwd_dq": _bound(common + q_like + fwd_stats + sprev_in
                                + q_like + stats + sprev_in,
                                (4 + s_flops) * unit, dtype_name),
        "scored_bwd_dkv": _bound(common + sprev_in * int(not emit) + stats
                                 + 2 * kv_like, (6 + s_flops) * unit,
                                 dtype_name),
        "pair": _bound(common + q_like + fwd_stats + 2 * sprev_in + q_like
                       + 2 * kv_like, (8 + s_flops) * unit, dtype_name)}


def scored_bwd_term_scales(torch, pa, q, k, v, mask, sprev, c, dctx, dscores, h):
    """The sizes of the terms that dc = Σ ds·S_prev and dmask =
    1e8·Σ_{h,q} ds add up, from the plain version: with |ds| ≤ p·(|dp| +
    |Σ dp·p|) + |dS|, Σ |ds|·|S_prev| and 1e8·max_j Σ_{h,q} |ds|.  Those
    terms cancel (a row's p·(dp − Σ dp·p) sums to 0, and S_prev ≈ −1e8 in
    a fully masked row), so the results are no scale for their own
    rounding error; the terms are."""
    _, s = pa.scored_forward_plain(q.float(), k.float(), v.float(), mask,
                                   sprev, c.float(), n_heads=h)
    vh, gh = (pa.split_heads(t.float(), h) for t in (v, dctx))
    p = torch.softmax(s, dim=-1)
    dp = gh @ vh.transpose(-2, -1)
    terms = p * (dp.abs() + (dp * p).sum(-1, keepdim=True).abs())
    if dscores is not None:
        terms = terms + dscores.abs()
    dc = 0.0 if sprev is None else float((terms * sprev.abs()).sum())
    return dc, pa.MASK_PENALTY * float(terms.sum(dim=(1, 2)).max())


def elementwise_errors(got, ref):
    """(max abs error, max |got − ref| / max(1, |ref|) elementwise)."""
    got, ref = got.float(), ref.float()
    return (got - ref).abs().max().item(), score_errors(got, ref)


def scored_backward_reference(pa, q, k, v, mask, sp, c, emit, dsc, dctx, h):
    """scored_backward_plain on the kernels' inputs, evaluated in f64 from
    the plain forward's S in f32 (so a fully masked row keeps f32's
    rounding of −1e8 + raw; without an emitted S, p is then that of the
    rebuilt s), cast back to f32.  The f32 evaluation's own error reaches
    9.6e-6 of max(1, |ref|) in dq at Lkv 1000 (cuBLAS's f32 sum over the
    keys) where the kernel's is 2.3e-6, both against f64, on an H100: as
    large as the 1e-5 bound, so the checks hold the kernels against the
    exact answer.  bf16 inputs are upcast first, as the kernels compute in
    f32 from them."""
    q32, k32, v32, c32 = (None if t is None else t.float() for t in (q, k, v, c))
    s32 = pa.scored_forward_plain(q32, k32, v32, mask, sp, c32, n_heads=h)[1]
    f64 = [None if t is None else t.double() for t in (q, k, v, sp, c, s32,
                                                       dsc, dctx)]
    out = pa.scored_backward_plain(*f64[:3], mask, *f64[3:5], f64[5],
                                   f64[6] if emit else None, f64[7], n_heads=h)
    return tuple(None if t is None else t.float() for t in out)


def scored_rebuild_equal(torch, pa, q, k, v, mask, c, dctx, h) -> bool:
    """Whether scored_bwd returns the same dq, dk and dv bits when it reads
    the forward's emitted S as when it rebuilds s (no S, no dS, no S_prev),
    from the same row stats and ctx: the forward, both backward kernels and
    the rebuild must share one score chain.  The forward's ctx and stats
    must not depend on whether it emits S either."""
    ctx, s, st = pa.scored_forward_kernel(q, k, v, mask, None, c, n_heads=h,
                                          stats=True)
    ctx2, _, st2 = pa.scored_forward_kernel(q, k, v, mask, None, c, n_heads=h,
                                            emit_scores=False, stats=True)
    read = pa.scored_backward_kernel(q, k, v, mask, None, c, s, None, dctx,
                                     n_heads=h, out=ctx, stats=st)
    rebuilt = pa.scored_backward_kernel(q, k, v, mask, None, c, None, None,
                                        dctx, n_heads=h, out=ctx, stats=st)
    return (torch.equal(ctx, ctx2) and torch.equal(st, st2)
            and all(torch.equal(a, b) for a, b in zip(read[:3], rebuilt[:3])))


def scored_bwd_cases(torch, g, report):
    """scored_bwd_dq and scored_bwd_dkv against scored_backward_plain in the
    four variants, each side from its own forward (the kernels from
    scored_fwd's S, the plain version from scored_forward_plain's), in f32
    and bf16: the nine mosei_realformer stream shapes at B·P = 384 (the two
    variants of the training path timed in f32) and that shape once more
    with a ragged mask, the nine robot_demo shapes at B 8, the edge cases,
    and the training shapes of ren_mme (B 32) and robot_demo (B 64), each
    with a fully masked row (but the no-mask and ragged cases), dscores from the seeded generator where S is
    emitted, and c = 0.7 over an S_prev that holds −1e8 + raw where the
    mask is 0.  dq, dk, dv and dS_prev elementwise against max(1, |ref|);
    dc and dmask at the scale of their summed terms."""
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa
    from multimodal_emotion_processing_tpu_torch.ops.attention import MASK_PENALTY

    shapes = [(True, (RF_CLIPS, RF_LEN, RF_LEN, RF_HEADS, RF_DH, "zero_row", 1.0))
              for _ in range(9)]
    # the main shape without a fully masked row: there dc's terms are
    # O(1), not ±1e8, so the term-scale check holds dc tightly
    shapes.append((False, (RF_CLIPS, RF_LEN, RF_LEN, RF_HEADS, RF_DH, "ragged",
                           1.0)))
    shapes += [(False, (SERVE_BUCKET, lq, lkv, ROBOT_HEADS, ROBOT_DH,
                        "zero_row", 1.0)) for lq, lkv in ROBOT_SHAPES]
    shapes += [(False, c + (1.0,)) for c in SCORED_EDGE_CASES]
    shapes += [(False, c) for c in SCORED_QX4_CASES]
    shapes += [(False, c) for c in TRAIN_DROPOUT_SHAPES]
    bwd = pa.scored_backward_kernel
    rows, ok, timed = [], True, {"scored_bwd_dq": [], "scored_bwd_dkv": []}
    rebuild_equal = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        for main, (b, lq, lkv, h, dh, mask_kind, q_scale) in shapes:
            q, k, v, mask = attention_inputs(torch, g, b, lq, lkv, h, dh, dtype,
                                             mask_kind)
            if q_scale != 1.0:
                q = (q.float() * q_scale).to(dtype)
            q0 = torch.randn(b, lq, h * dh, generator=g, device="cuda").to(dtype)
            sprev = pa.scored_forward_plain(q0, k, v, mask, None, None,
                                            n_heads=h)[1].contiguous()
            c = torch.tensor([0.7], device="cuda").to(dtype)
            dctx = torch.randn(b, lq, h * dh, generator=g, device="cuda").to(dtype)
            dsc_all = torch.randn(b, h, lq, lkv, generator=g, device="cuda")
            rebuild_equal.append(scored_rebuild_equal(torch, pa, q, k, v, mask,
                                                      c, dctx, h))
            for has_sprev, emit in pa.VARIANTS:
                sp = sprev if has_sprev else None
                dsc = dsc_all if emit else None
                ctx, s, st = pa.scored_forward_kernel(
                    q, k, v, mask, sp, c, n_heads=h, emit_scores=emit,
                    stats=True)
                args = (q, k, v, mask, sp, c, s, dsc, dctx)
                dq, dk, dv, dmask, dsprev, dc = bwd(*args, n_heads=h, out=ctx,
                                                    stats=st)
                torch.cuda.synchronize()
                _, rs = pa.scored_forward_plain(q, k, v, mask, sp, c, n_heads=h,
                                                emit_scores=emit)
                ref = scored_backward_reference(pa, q, k, v, mask, sp, c,
                                                emit, dsc, dctx, h)
                errs = {n: elementwise_errors(got, want) for n, got, want in (
                    ("dq", dq, ref[0]), ("dk", dk, ref[1]), ("dv", dv, ref[2]))}
                dc_scale, dm_scale = scored_bwd_term_scales(
                    torch, pa, q, k, v, mask, sp, c, dctx, dsc, h)
                if has_sprev:
                    errs["dS_prev"] = elementwise_errors(dsprev, ref[4])
                    e = abs(float(dc) - float(ref[5]))
                    errs["dc"] = (e, e / max(1.0, abs(float(ref[5])), dc_scale))
                if mask is not None:
                    e = (dmask - ref[3].float()).abs().max().item()
                    errs["dmask"] = (e, e / max(1.0, ref[3].float().abs().max()
                                                .item(), dm_scale))
                finite = all(bool(torch.isfinite(t).all().item()) for t in
                             (dq, dk, dv) + ((dsprev,) if has_sprev else ()))
                good = (finite and dq.dtype == dk.dtype == dv.dtype == dtype
                        and all(e[1] <= tol for e in errs.values()))
                ok &= good
                row = dict(dtype=dname, b=b, lq=lq, lkv=lkv, h=h, dh=dh,
                           mask=mask_kind, q_scale=q_scale, has_sprev=has_sprev,
                           emit=emit, main_path=main, tol=tol, ok=good,
                           **{f"{n}_abs_err": e[0] for n, e in errs.items()},
                           **{f"{n}_norm_err": e[1] for n, e in errs.items()})
                timing = ""
                if (main and dtype == torch.float32
                        and (has_sprev, emit) in MAIN_VARIANTS):
                    # as the main path calls them: the batch mask needs no
                    # gradient.  Each kernel on inputs checked once; the pair
                    # through the wrapper, checks included
                    ins, dims, variant = bwd.check(*args, n_heads=h, out=ctx,
                                                   stats=st)
                    _, stats3, _, dcpart = bwd.dq.launch(ins, dims, variant)
                    calls = {
                        "scored_bwd_dq": functools.partial(
                            bwd.dq.launch, ins, dims, variant),
                        "scored_bwd_dkv": functools.partial(
                            bwd.dkv.launch, ins, stats3, dcpart, dims,
                            variant, False)}
                    for kname, call in calls.items():
                        timed[kname].append(call)
                        row[f"{kname}_ms"] = time_ms(torch, call)
                    row["pair_ms"] = time_ms(torch, lambda: bwd(
                        *args, n_heads=h, out=ctx, stats=st, want_dmask=False))
                    row["plain_ms"] = time_ms(torch, lambda: pa.scored_backward_plain(
                        q, k, v, mask, sp, c, rs, dsc, dctx, n_heads=h))
                    bias = -MASK_PENALTY * (1.0 - mask.float())[:, None, None, :]
                    if has_sprev:
                        bias = (bias + c.float() * sprev).contiguous()
                    try:
                        row["library_ms"] = sdpa_backward_ms(
                            torch, q, k, v, bias.expand(b, h, lq, lkv), dctx, h)
                    except RuntimeError as e:   # a yardstick only
                        row["library_ms"] = None
                        log(f"[kernels] SDPA backward not measured: {e}")
                    for kname, bnd in scored_bwd_bounds(
                            b, h, lq, lkv, dh, dname, has_sprev, emit).items():
                        row.update({f"{kname}_{key}": val
                                    for key, val in bnd.items()})
                    lib = row["library_ms"]
                    timing = (f" dq_ms={row['scored_bwd_dq_ms']:.4f} dkv_ms="
                              f"{row['scored_bwd_dkv_ms']:.4f} plain_ms="
                              f"{row['plain_ms']:.4f} library_ms="
                              + ("n/a" if lib is None else f"{lib:.4f}")
                              + f" pair_bound_ms={row['pair_bound_ms']:.5f} "
                              f"({row['pair_bound_by']})")
                rows.append(row)
                log(f"[kernels] scored_bwd {dname} B={b} Lq={lq} Lkv={lkv} H={h} "
                    f"dh={dh} mask={mask_kind} q_scale={q_scale:g} "
                    f"sprev={int(has_sprev)} emit={int(emit)} norm_err "
                    + " ".join(f"{n}={e[1]:.2e}" for n, e in errs.items())
                    + f" tol={tol:g} {'ok' if good else 'FAIL'}" + timing)
    report["scored_bwd_cases"] = rows
    report["scored_bwd_rebuild_equal"] = rebuild_equal
    n_equal = sum(rebuild_equal)
    log(f"[kernels] scored_bwd rebuilding s (no S, no dS, no S_prev) against "
        f"reading the forward's S, same stats and ctx: dq, dk, dv bit-equal "
        f"in {n_equal} of {len(rebuild_equal)} cases")
    if not ok:
        raise AssertionError("the scored backward kernels disagree with "
                             "their plain version")
    if n_equal != len(rebuild_equal):
        raise AssertionError("scored_bwd gives other bits when it rebuilds s "
                             "than when it reads the forward's S")
    main = [r for r in rows if "plain_ms" in r]
    lib = [r["library_ms"] for r in main]
    out = {}
    # max_abs_err over the elementwise outputs; dc and dmask, sums of
    # terms up to ~1e8 · 1e3 that cancel, only at their term scale
    for kname, err_keys, term_key in (
            ("scored_bwd_dq", ("dq", "dS_prev"), "dc"),
            ("scored_bwd_dkv", ("dk", "dv"), "dmask")):
        try:
            dev = kernel_device_ms(torch, timed[kname], kname)
        except Exception:   # a measurement only: the checks above stand
            traceback.print_exc()
            dev = None
        out[kname] = dict(
            ms=sum(r[f"{kname}_ms"] for r in main), device_ms=dev,
            plain_ms=sum(r["plain_ms"] for r in main),
            library_ms=None if None in lib else sum(lib),
            bound_ms=sum(r[f"{kname}_bound_ms"] for r in main),
            bound_by=majority_bound(main, f"{kname}_bound_by"),
            max_abs_err=max(r.get(f"{e}_abs_err", 0.0) for r in rows
                            for e in err_keys),
            max_norm_err=max(r.get(f"{e}_norm_err", 0.0) for r in rows
                             for e in err_keys),
            **{f"max_{term_key}_term_scale_err": max(
                r.get(f"{term_key}_norm_err", 0.0) for r in rows)},
            calls_timed=len(main))
    out["scored_bwd_pair"] = dict(
        ms=sum(r["pair_ms"] for r in main),
        bound_ms=sum(r["pair_bound_ms"] for r in main),
        bound_by=majority_bound(main, "pair_bound_by"),
        by_variant={f"sprev={int(a)},emit={int(e)}": dict(
            dq_ms=sum(r["scored_bwd_dq_ms"] for r in main
                      if (r["has_sprev"], r["emit"]) == (a, e)),
            dkv_ms=sum(r["scored_bwd_dkv_ms"] for r in main
                       if (r["has_sprev"], r["emit"]) == (a, e)),
            pair_bound_ms=sum(r["pair_bound_ms"] for r in main
                              if (r["has_sprev"], r["emit"]) == (a, e)))
            for a, e in MAIN_VARIANTS})
    out["scored_bwd_pair"]["mosei_trans"] = scored_bwd_fused_timing(
        torch, g, pa)
    report["scored_bwd_summary"] = out
    dq, dkv = out["scored_bwd_dq"], out["scored_bwd_dkv"]
    log(f"[kernels] scored_bwd, sum over the {len(main)} calls of one "
        f"mosei_realformer train step (nine 50x50 streams x two chained "
        f"blocks) at B={RF_CLIPS} f32: dq {dq['ms']:.3f} ms, dkv "
        f"{dkv['ms']:.3f} ms as launched on checked inputs, pair "
        f"{out['scored_bwd_pair']['ms']:.3f} ms through the wrapper (CUDA "
        f"events); device {dq['device_ms']} / {dkv['device_ms']} ms "
        f"(profiler); bounds {dq['bound_ms']:.4f} / {dkv['bound_ms']:.4f}, "
        f"pair {out['scored_bwd_pair']['bound_ms']:.4f} ms; plain "
        f"{dq['plain_ms']:.3f} ms; SDPA backward with the float bias "
        f"{dq['library_ms']} ms")
    return out


def scored_bwd_fused_timing(torch, g, pa):
    """The scored_bwd pair as FusedMinusBlock's backward calls it in a
    mosei_trans train step at impl="pallas_fused": the nine stream shapes
    at B 64 (dh 16, L 20/100/200, f32), no S_prev, no emitted S (s
    rebuilt), the forward's row stats (dq sweeps the keys once), the batch
    mask without a gradient.  Each call checked against
    scored_backward_plain; timed through the wrapper, with its device time
    (and dq's alone), bound, plain and SDPA times."""
    from multimodal_emotion_processing_tpu_torch.ops.attention import MASK_PENALTY

    bwd = pa.scored_backward_kernel
    res = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_norm_err=0.0)
    calls, lib = [], []
    for lq, lkv in MT_SHAPES:
        h, dh = MT_HEADS, MT_DH
        q, k, v, mask = attention_inputs(torch, g, MT_BATCH, lq, lkv, h, dh,
                                         torch.float32, "zero_row")
        dctx = torch.randn(q.shape, generator=g, device="cuda")
        ctx, _, st = pa.scored_forward_kernel(q, k, v, mask, None, None,
                                              n_heads=h, emit_scores=False,
                                              stats=True)
        call = functools.partial(bwd, q, k, v, mask, None, None, None, None,
                                 dctx, n_heads=h, out=ctx, stats=st,
                                 want_dmask=False)
        got = call()
        ref = scored_backward_reference(pa, q, k, v, mask, None, None,
                                        False, None, dctx, h)
        res["max_norm_err"] = max([res["max_norm_err"]] + [
            elementwise_errors(a, b)[1] for a, b in zip(got[:3], ref[:3])])
        calls.append(call)
        res["ms"] += time_ms(torch, call)
        res["plain_ms"] += time_ms(torch, lambda: pa.scored_backward_plain(
            q, k, v, mask, None, None, None, None, dctx, n_heads=h))
        bias = (-MASK_PENALTY * (1.0 - mask.float()))[:, None, None, :]
        try:
            lib.append(sdpa_backward_ms(
                torch, q, k, v, bias.expand(MT_BATCH, h, lq, lkv), dctx, h))
        except RuntimeError as e:   # a yardstick only
            lib.append(None)
            log(f"[kernels] SDPA backward not measured: {e}")
        res["bound_ms"] += scored_bwd_bounds(MT_BATCH, h, lq, lkv, dh,
                                             "float32", False, False)[
                                                 "pair"]["bound_ms"]
    res["library_ms"] = None if None in lib else sum(lib)
    if res["max_norm_err"] > F32_TOL:
        raise AssertionError("scored_bwd at the mosei_trans shapes disagrees "
                             "with its plain version")
    try:
        res["device_ms"] = kernel_device_ms(torch, calls, "scored_bwd")
        res["dq_device_ms"] = kernel_device_ms(torch, calls, "scored_bwd_dq")
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        res["device_ms"] = res["dq_device_ms"] = None
    log(f"[kernels] scored_bwd pair as FusedMinusBlock calls it, sum over the "
        f"nine mosei_trans stream shapes at B={MT_BATCH} f32 (s rebuilt, the "
        f"forward's stats): {res['ms']:.4f} ms through the wrapper, device "
        f"{res['device_ms']} ms (dq {res['dq_device_ms']} ms); bound "
        f"{res['bound_ms']:.4f}, plain "
        f"{res['plain_ms']:.4f}, SDPA backward {res['library_ms']} ms; "
        f"norm_err {res['max_norm_err']:.2e}")
    return res


def fused_bound(b, h, lq, lkv, dh, dtype_name, has_sprev, emit, save_ctx):
    """Least time for one fused_block call on this card: q, k, v, the f32
    mask, the three D x D weights and the LayerNorm's two vectors read
    once, S_prev (f32) when given, out written once, S (f32) and the ctx
    residual when asked for, against 4·B·H·Lq·Lkv·dh flops for the
    attention plus 6·B·Lq·D² for the three products, at the peak of the
    operand type (bound_ms); and the same at the split-TF32 rate, 495/3
    TFLOP/s, at which the kernel runs every f32 product on the tensor cores
    (bound_split_tf32_ms)."""
    it = 2 if dtype_name == "bfloat16" else 4
    d = h * dh
    scores = b * h * lq * lkv * 4
    nbytes = ((2 * b * lq * d + 2 * b * lkv * d + 3 * d * d + 2 * d) * it
              + b * lkv * 4 + scores * (int(has_sprev) + int(emit))
              + b * lq * d * it * int(save_ctx))
    flops = 4.0 * b * h * lq * lkv * dh + 6.0 * b * lq * d * d
    out = _bound(nbytes, flops, dtype_name)
    out["bound_split_tf32_ms"] = max(out["bytes_ms"],
                                     flops / SPLIT_TF32_FLOPS * 1e3)
    return out


def fused_weights(torch, g, d, dtype):
    """A minus block's weights in torch's layout, Linear-initialised, and
    its LayerNorm's scale and bias away from 1 and 0."""
    bound = 1.0 / d ** 0.5

    def uniform(*shape):
        return ((torch.rand(*shape, generator=g, device="cuda") * 2 - 1)
                * bound).to(dtype)

    return [uniform(d, d), uniform(d, 2 * d),
            (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype),
            (0.1 * torch.randn(d, generator=g, device="cuda")).to(dtype)]


def fused_library_call(torch, q, k, v, mask, ws, h):
    """The block (no S_prev) as PyTorch library calls, for timing as one
    sequence: SDPA with the float bias −1e8(1 − mask), then F.linear for the
    projection and the split combine, and F.layer_norm.  No single PyTorch
    call computes the block; this composite writes no S."""
    from multimodal_emotion_processing_tpu_torch.ops.attention import (
        MASK_PENALTY, merge_heads, split_heads)

    F = torch.nn.functional
    qh, kh, vh = (split_heads(t, h).contiguous() for t in (q, k, v))
    bias = (-MASK_PENALTY * (1.0 - mask.float()))[:, None, None, :].to(q.dtype)
    wp, wm, lw, lb = ws
    d = q.shape[-1]

    def call():
        ctx = merge_heads(F.scaled_dot_product_attention(qh, kh, vh,
                                                         attn_mask=bias))
        y = F.linear(q, wm[:, :d]) + F.linear(F.linear(ctx, wp), wm[:, d:])
        return F.layer_norm(y, (d,), lw, lb, 1e-5)

    return call


def fused_cases(torch, g, report):
    """fused_block against fused_block_plain (out and S) and
    scored_forward_plain (the ctx residual) in its four variants, in f32
    and bf16: the nine mosei_trans stream shapes at the training batch 64,
    the nine ren_mme shapes at the serving bucket 8 and at the 32 rows of
    its training's eval passes, and the edge cases.
    S_prev is what a previous block emits (the plain version's S of another
    q on the same keys and mask), so it holds −1e8 + raw where the mask is
    0; c is 0.7.  S must also equal scored_fwd's S on the same inputs bit
    for bit, the row stats m scored_fwd's bit for bit and l within 1e-6
    relative, and out, S and the stats must be the same bits over two
    launches.  Each case logs its launch's cluster size and blocks.  Timed
    in f32 as the main paths call it (no S_prev, no S; the training forward
    with the ctx residual, serving without), with the backward through
    FusedMinusBlock against autograd through the plain version at the
    training shapes."""
    from multimodal_emotion_processing_tpu_torch.ops import fused_block as fb
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa

    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("train", dtype, (MT_BATCH, lq, lkv, MT_HEADS, MT_DH,
                                    "zero_row")) for lq, lkv in MT_SHAPES]
        cases += [("serve", dtype, (SERVE_BUCKET, lq, lkv, REN_HEADS, REN_DH,
                                    "zero_row")) for lq, lkv in REN_SHAPES]
        cases += [("eval", dtype, (2 * REN_PAIRS, lq, lkv, REN_HEADS, REN_DH,
                                   "zero_row")) for lq, lkv in REN_SHAPES]
        cases += [("edge", dtype, c) for c in FUSED_EDGE_CASES]
    rows, ok, timed_calls = [], True, {"train": [], "serve": []}
    for path, dtype, (b, lq, lkv, h, dh, mask_kind) in cases:
        dname = str(dtype).removeprefix("torch.")
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        q, k, v, mask = attention_inputs(torch, g, b, lq, lkv, h, dh, dtype,
                                         mask_kind)
        q0 = torch.randn(b, lq, h * dh, generator=g, device="cuda").to(dtype)
        sprev = pa.scored_forward_plain(q0, k, v, mask, None, None,
                                        n_heads=h)[1].contiguous()
        c = torch.tensor([0.7], device="cuda").to(dtype)
        ws = fused_weights(torch, g, h * dh, dtype)
        geo = fb.fused_block_kernel.geometry(b, h, lq, lkv, dh, dtype)
        for has_sprev, emit in pa.VARIANTS:
            sp = sprev if has_sprev else None
            out, s, ctx, st = fb.fused_block_kernel(
                q, k, v, mask, sp, c, *ws, n_heads=h, emit_scores=emit,
                save_ctx=True, stats=True)
            out2, s2, _, st2 = fb.fused_block_kernel(
                q, k, v, mask, sp, c, *ws, n_heads=h, emit_scores=emit,
                save_ctx=True, stats=True)
            torch.cuda.synchronize()
            ref, rs = fb.fused_block_plain(q, k, v, mask, sp, c, *ws,
                                           n_heads=h, emit_scores=emit)
            rctx, _ = pa.scored_forward_plain(q, k, v, mask, sp, c, n_heads=h,
                                              emit_scores=False)
            abs_err, err = errors(out, ref)
            ctx_err = errors(ctx, rctx)[1]
            _, s_sc, st_sc = pa.scored_forward_kernel(
                q, k, v, mask, sp, c, n_heads=h, emit_scores=emit, stats=True)
            s_err, s_bits = 0.0, True
            if emit:
                s_err = score_errors(s, rs)
                s_bits = torch.equal(s, s_sc)
            m_bits = torch.equal(st[0], st_sc[0])
            l_err = ((st[1] - st_sc[1]).abs() / st_sc[1]).max().item()
            repeat_bits = (torch.equal(out, out2) and torch.equal(st, st2)
                           and (s is None or torch.equal(s, s2)))
            good = (bool(torch.isfinite(out).all().item()) and err <= tol
                    and ctx_err <= tol and s_err <= SCORE_RTOL and s_bits
                    and m_bits and l_err <= FUSED_L_RTOL and repeat_bits
                    and (s is None) == (not emit) and out.dtype == dtype)
            ok &= good
            row = dict(path=path, dtype=dname, b=b, lq=lq, lkv=lkv, h=h, dh=dh,
                       mask=mask_kind, has_sprev=has_sprev, emit=emit,
                       max_abs_err=abs_err, max_norm_err=err,
                       ctx_norm_err=ctx_err, score_rel_err=s_err,
                       scores_equal_scored_fwd=s_bits,
                       stats_m_equal_scored_fwd=m_bits, stats_l_rel_err=l_err,
                       repeat_bits_equal=repeat_bits, tol=tol, ok=good, **geo)
            timing = ""
            if (path in timed_calls and dtype == torch.float32
                    and (has_sprev, emit) == (False, False)):
                save = path == "train"
                call = functools.partial(
                    fb.fused_block_kernel, q, k, v, mask, None, c, *ws,
                    n_heads=h, emit_scores=False, save_ctx=save)
                timed_calls[path].append(call)
                row["ms"] = time_ms(torch, call)
                row["plain_ms"] = time_ms(torch, lambda: fb.fused_block_plain(
                    q, k, v, mask, None, c, *ws, n_heads=h, emit_scores=False))
                row["library_ms"] = time_ms(
                    torch, fused_library_call(torch, q, k, v, mask, ws, h))
                row.update(fused_bound(b, h, lq, lkv, dh, dname, False, False,
                                       save))
                timing = (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                          f" library_ms={row['library_ms']:.4f} bound_ms="
                          f"{row['bound_ms']:.5f} ({row['bound_by']}) "
                          f"bound_split_tf32_ms="
                          f"{row['bound_split_tf32_ms']:.5f}")
                if save:
                    row.update(fused_backward_timing(torch, fb, q, k, v, mask,
                                                     c, ws, h, g))
                    timing += (f" bwd_ms={row['bwd_ms']:.4f} plain_bwd_ms="
                               f"{row['plain_bwd_ms']:.4f} bwd_norm_err="
                               f"{row['bwd_norm_err']:.2e}")
                    good = row["bwd_norm_err"] <= MT_GRAD_TOL
                    row["ok"] = row["ok"] and good
                    ok &= good
            rows.append(row)
            log(f"[kernels] fused_block {dname} B={b} Lq={lq} Lkv={lkv} H={h} "
                f"dh={dh} mask={mask_kind} sprev={int(has_sprev)} "
                f"emit={int(emit)} cluster={geo['cluster']} rows={geo['rows']} "
                f"blocks={geo['blocks']} norm_err={err:.3e} "
                f"ctx_err={ctx_err:.2e} S_rel_err={s_err:.2e} "
                f"S==scored_fwd={s_bits} m==scored_fwd={m_bits} "
                f"l_rel_err={l_err:.1e} repeat_bits={repeat_bits} tol={tol:g} "
                f"{'ok' if row['ok'] else 'FAIL'}" + timing)
    report["fused_cases"] = rows
    if not ok:
        raise AssertionError("fused_block disagrees with its plain version")
    out = {}
    for path in ("train", "serve"):
        timed = [r for r in rows if r["path"] == path and "ms" in r]
        summ = {k: sum(r[k] for r in timed)
                for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_split_tf32_ms")}
        summ["blocks"] = [r["blocks"] for r in timed]
        summ["bound_by"] = majority_bound(timed)
        summ["calls_timed"] = len(timed)
        if path == "train":
            for k in ("bwd_ms", "plain_bwd_ms"):
                summ[k] = sum(r[k] for r in timed)
        try:
            summ["device_ms"] = kernel_device_ms(torch, timed_calls[path],
                                                 "fused_block")
        except Exception:   # a measurement only: the checks above stand
            traceback.print_exc()
            summ["device_ms"] = None
        out[path] = summ
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["max_score_rel_err"] = max(r["score_rel_err"] for r in rows)
    out["scores_equal_scored_fwd"] = all(r["scores_equal_scored_fwd"]
                                         for r in rows)
    out["stats_m_equal_scored_fwd"] = all(r["stats_m_equal_scored_fwd"]
                                          for r in rows)
    out["max_stats_l_rel_err"] = max(r["stats_l_rel_err"] for r in rows)
    out["repeat_bits_equal"] = all(r["repeat_bits_equal"] for r in rows)
    report["fused_summary"] = out
    for path, what in (("train", f"the nine mosei_trans stream shapes at "
                                 f"B={MT_BATCH} f32 with the ctx residual "
                                 "(one grid of a train step's forward)"),
                       ("serve", f"the nine ren_mme stream shapes at "
                                 f"B={SERVE_BUCKET} f32 (one grid of a "
                                 "bucket-8 member forward)")):
        summ = out[path]
        dev = summ["device_ms"]
        log(f"[kernels] fused_block, sum over {what}: {summ['ms']:.4f} ms as "
            "called (CUDA events), "
            + ("device time not measured" if dev is None else
               f"{dev:.4f} ms device time (profiler)")
            + f"; bound {summ['bound_ms']:.4f} ({summ['bound_by']}; at the "
            f"split-TF32 rate {summ['bound_split_tf32_ms']:.4f}), blocks "
            f"{summ['blocks']}, plain "
            f"{summ['plain_ms']:.4f} ms, library composite (SDPA + F.linear + "
            f"F.layer_norm, no S) {summ['library_ms']:.4f} ms"
            + (f"; backward through FusedMinusBlock {summ['bwd_ms']:.4f} ms, "
               f"autograd through the plain version {summ['plain_bwd_ms']:.4f}"
               " ms" if path == "train" else ""))
    return out


def fused_backward_timing(torch, fb, q, k, v, mask, c, ws, h, g):
    """The backward of one terminal block as the train step runs it (no
    S_prev, no S; q, k, v and the weights need gradients, the batch mask
    not): FusedMinusBlock (the scored_bwd kernels and the plain epilogue
    products) against torch autograd through fused_block_plain, timed on a
    graph built once, and their gradients against each other (max error
    over the tensors, normalised by max(1, |ref|))."""
    dout = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    res = {}
    grads = {}
    for key, fn in (("bwd_ms", fb.fused_minus_block),
                    ("plain_bwd_ms", fb.fused_block_plain)):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (q, k, v, *ws)]
        out, _ = fn(*leaves[:3], mask, None, c, *leaves[3:], n_heads=h,
                    emit_scores=False)
        res[key] = time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, dout, retain_graph=True))
        grads[key] = torch.autograd.grad(out, leaves, dout)
    res["bwd_norm_err"] = max(errors(a, b)[1] for a, b in zip(
        grads["bwd_ms"], grads["plain_bwd_ms"]))
    return res


def ensure_no_name(samples):
    """The main path must carry a no_name request (previous slot all zero,
    all-zero masks): make sample 0 one if the seed gave none."""
    if not any(float(s["l_mask"][0].sum()) == 0.0 for s in samples):
        for kind in ("l", "v", "a"):
            samples[0][kind][0] = 0.0
            samples[0][kind + "_mask"][0] = 0.0
    return samples


def phase_train(torch, report):
    """The training slice: Trainer.fit on mosei_trans_s1024 with the flash
    kernels, counted and timed, then held against impl="xla"."""
    import dataclasses

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_processing_tpu_torch.train import engine

    exp = configs.get("mosei_trans_s1024")
    tcfg = exp.train
    if (tcfg.batch_size, tcfg.compute_dtype, exp.model.attn_impl) != (
            TRAIN_BATCH, "bfloat16", "flash"):
        raise AssertionError(f"unexpected preset {exp}")
    train = ensure_no_name(synthetic_dataset(exp.name, exp.model, N_TRAIN, seed=0))
    valid = ensure_no_name(synthetic_dataset(exp.name, exp.model, N_VALID, seed=1))

    def loaders():
        # the same seed, so every run sees the same batches in the same order
        return (Batcher(train, TRAIN_BATCH, seed=1),
                Batcher(valid, TRAIN_BATCH, shuffle=False))

    TimedTrainer = timed_trainer(torch, engine)
    state = engine.init_state(exp.model, tcfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[train] {exp.name}: dim={exp.model.dim} heads={exp.model.n_heads} "
        f"lens l/v/a={exp.model.l_len}/{exp.model.v_len}/{exp.model.a_len} "
        f"params={n_params} batch={TRAIN_BATCH} dtype={tcfg.compute_dtype} "
        f"over f32 masters, optimizer={tcfg.optimizer}; {N_TRAIN} train / "
        f"{N_VALID} valid synthetic samples, {TRAIN_EPOCHS} epochs")
    if n_params != S1024_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {S1024_PARAMS}")
    init_weights = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}

    # step-1 gradients, flash against xla, on the same weights and batch:
    # in the run's bf16 and, as a tighter look at the kernels, in f32; and
    # each bf16 path against the f32 xla gradients, to show how far bf16
    # alone moves them
    first = to_device(next(iter(loaders()[0]())), "cuda")
    grads = {dname: step_gradients(engine, state.model, cfg, first)
             for dname, cfg in (("bfloat16", tcfg), ("float32", dataclasses.replace(
                 tcfg, compute_dtype="float32")))}
    grad_err = {}
    for key, (got, ref) in (
            ("bfloat16", (grads["bfloat16"]["flash"], grads["bfloat16"]["xla"])),
            ("float32", (grads["float32"]["flash"], grads["float32"]["xla"])),
            ("bfloat16_flash_vs_float32_xla",
             (grads["bfloat16"]["flash"], grads["float32"]["xla"])),
            ("bfloat16_xla_vs_float32_xla",
             (grads["bfloat16"]["xla"], grads["float32"]["xla"]))):
        grad_err[key] = gradient_errors(got, ref)
        for form in ("rel_l2", "max_abs"):
            worst = sorted(grad_err[key].items(), key=lambda kv: -kv[1][form])[:4]
            log(f"[train] step-1 gradients, {key.replace('_', ' ')}"
                f"{' flash vs xla' if '_vs_' not in key else ''}, "
                f"{len(grad_err[key])} tensors, {form} per tensor, worst: "
                + ", ".join(f"{n}={e[form]:.2e}" for n, e in worst))
    del grads
    max_grad_err = max(e["rel_l2"] for e in grad_err["bfloat16"].values())

    # the main path, counted: Trainer.fit with the flash kernels
    for kern in fa.KERNELS:
        kern.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = TimedTrainer(exp.model, tcfg, impl="flash", device="cuda")
    t0 = time.perf_counter()
    state, hist = trainer.fit(*loaders(), state=state, epochs=TRAIN_EPOCHS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in fa.KERNELS}
    stats_launches = fa.flash_forward_kernel.stats_launches
    peak = torch.cuda.max_memory_allocated()
    step_ms = trainer.step_ms()

    n_steps = sum(h.steps for h in hist)
    n_eval = TRAIN_EPOCHS * -(-N_VALID // TRAIN_BATCH)
    expected = {"flash_fwd": 18 * (n_steps + n_eval),
                "flash_bwd_dq": 18 * n_steps, "flash_bwd_dkv": 18 * n_steps}
    losses = [x for h in hist for x in h.step_losses]
    for e, h in enumerate(hist):
        log(f"[train] epoch {e}: train_loss={h.train_loss:.6f} valid_loss="
            f"{h.valid_loss:.6f} steps={h.steps} samples={h.samples} "
            f"seconds={h.seconds:.3f} samples/s={h.samples_per_sec:.1f}")
    log(f"[train] step losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log(f"[train] step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median after the first {statistics.median(step_ms[1:]):.2f} ms "
        f"= {TRAIN_BATCH / statistics.median(step_ms[1:]) * 1e3:.1f} samples/s; "
        f"fit wall {wall_s:.2f} s; peak memory {peak / 2**30:.2f} GiB")
    log(f"[train] launches {launches}, flash_fwd with stats {stats_launches}; "
        f"expected {expected}, with stats {18 * n_steps} "
        f"(18 attention calls x {n_steps} steps, + 18 x {n_eval} eval forwards)")

    # the same run through the plain attention path
    twin = engine.init_state(exp.model, tcfg, seed=0, device="cuda")
    twin.model.load_state_dict(init_weights)
    del init_weights
    torch.cuda.reset_peak_memory_stats()
    twin_trainer = TimedTrainer(exp.model, tcfg, impl="xla", device="cuda")
    twin, hist_x = twin_trainer.fit(*loaders(), state=twin, epochs=TRAIN_EPOCHS)
    peak_x = torch.cuda.max_memory_allocated()
    step_ms_x = twin_trainer.step_ms()
    losses_x = [x for h in hist_x for x in h.step_losses]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, losses_x))
    log(f"[train] impl=xla from the same weights and batches (batch "
        f"{TRAIN_BATCH}): step losses " + ", ".join(f"{x:.6f}" for x in losses_x)
        + f"; max relative loss difference {loss_rel:.2e} (bound {BF16_TOL:g}); "
        f"step ms median after the first {statistics.median(step_ms_x[1:]):.2f}; "
        f"peak memory {peak_x / 2**30:.2f} GiB")

    report["train"] = dict(
        config=exp.name, params=n_params, batch=TRAIN_BATCH, steps=n_steps,
        eval_forwards=n_eval, step_losses=losses, step_losses_xla=losses_x,
        epochs=[dataclasses.asdict(h) for h in hist],
        epochs_xla=[dataclasses.asdict(h) for h in hist_x],
        step_ms=step_ms, step_ms_xla=step_ms_x,
        step_ms_median=statistics.median(step_ms[1:]),
        step_ms_median_xla=statistics.median(step_ms_x[1:]),
        fit_wall_s=wall_s, peak_bytes=peak, peak_bytes_xla=peak_x,
        launches=launches, flash_fwd_stats_launches=stats_launches,
        expected_launches=expected, grad_err=grad_err,
        max_grad_err_bf16_rel_l2=max_grad_err, max_loss_rel_err=loss_rel)
    if not (len(losses) == len(losses_x) == n_steps == 8
            and np.isfinite(losses + losses_x).all()):
        raise AssertionError(f"step losses {losses} / {losses_x}")
    if launches != expected or stats_launches != 18 * n_steps:
        raise AssertionError(f"launches {launches} (stats {stats_launches}), "
                             f"expected {expected}")
    if max_grad_err > BF16_TOL:
        raise AssertionError(f"step-1 bf16 gradients disagree with impl='xla': "
                             f"relative L2 {max_grad_err:.3e}")
    if loss_rel > BF16_TOL:
        raise AssertionError(f"losses disagree with impl='xla': {loss_rel:.3e}")

    # where the time goes: one more replay of each run's captured step
    # under torch.profiler
    try:
        report["train_profile"] = {
            "flash_step": profile_breakdown(
                torch, trainer.programs["train"]),
            "xla_step": profile_breakdown(
                torch, twin_trainer.programs["train"])}
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        report["train_profile"] = "not measured: the profiler failed"
        log("[profile] not measured: the profiler failed")
    return launches


def timed_trainer(torch, engine):
    """The port's Trainer, recording a CUDA event on the consuming stream
    as each train batch is taken and after the last: the interval between
    two is one captured step (its batch's copy into the static buffers,
    the replay and the loss's copy out), the first one its capture."""

    class TimedTrainer(engine.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.events = []

        def _iter(self, loader, counter=None):
            batches = super()._iter(loader, counter)
            # the train loader is the one whose samples are counted
            return batches if counter is None else self._timed(batches)

        def _timed(self, batches):
            last = None
            for b in batches:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                if last is not None:
                    self.events.append((last, ev))
                last = ev
                yield b
            if last is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append((last, ev))

        def step_ms(self):
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.events]

    return TimedTrainer


def dropout_kwargs(engine, model, generator_seed):
    """{"generator": a fresh dropout generator of `generator_seed` on the
    model's device} (the one `engine.init_state(seed=generator_seed)`
    carries, so step 1 of a fit draws the same masks), or {} for None."""
    if generator_seed is None:
        return {}
    device = next(model.parameters()).device
    return {"generator": engine.dropout_generator(generator_seed, device)}


def step_gradients(engine, model, tcfg, batch, impls=("flash", "xla"), *,
                   generator_seed=None):
    """{impl: {parameter name: gradient}} of one loss on the same weights
    and batch, for each impl, with dropout (if any) drawn by each impl from
    its own generator of `generator_seed`, so every impl sees the same
    masks; the impls must give gradients to the same parameters."""
    grads = {}
    model.train()
    for impl in impls:
        engine.batch_loss(model, tcfg, batch, impl=impl, **dropout_kwargs(
            engine, model, generator_seed)).backward()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()
                       if p.grad is not None}
        for p in model.parameters():
            p.grad = None
    if len({frozenset(g) for g in grads.values()}) != 1:
        raise AssertionError(f"{' and '.join(impls)} give gradients to "
                             "different parameters")
    return grads


def pinned_step_gradients(torch, engine, model, tcfg, batch, impls, *,
                          pin_pool: bool = False, generator_seed=None):
    """step_gradients with every ReLU module's routing pinned, in every
    impl after the first, to what the first impl's forward chose: its
    backward passes a gradient where its input was > 0, so where an input
    lies within the last bits of 0 the impls route that gradient
    differently and a whole row's term moves in or out of a weight's
    gradient.  Pinned, the comparison sees the attention's gradients.  The
    grid's max pool (its backward sends each column's gradient to its
    argmax row) is watched, and with `pin_pool` pinned the same way (the
    later impls take each column's value at the first impl's argmax).
    Dropout, if any, as in `step_gradients`.  Returns (grads, {"pool": n,
    "relu": n}: how many pooled columns and ReLU inputs the later impls'
    own forward routed otherwise, {"pool": n, "relu": n}: how many there
    are)."""
    from multimodal_emotion_processing_tpu_torch.models import grid as grid_mod

    recorded = {"pool": [], "relu": []}
    flips = dict.fromkeys(recorded, 0)
    sizes = dict.fromkeys(recorded, 0)
    calls = dict.fromkeys(recorded, 0)

    def routed(kind, chosen):
        """The first impl records `chosen`; later ones count where theirs
        differs.  Returns the recorded routing."""
        i = calls[kind]
        calls[kind] += 1
        if i >= len(recorded[kind]):
            recorded[kind].append(chosen)
            sizes[kind] += chosen.numel()
            return chosen
        flips[kind] += int((chosen != recorded[kind][i]).sum())
        return recorded[kind][i]

    def pool(x):
        idx = routed("pool", torch.max(x, dim=1).indices)
        if not pin_pool:
            return original(x)
        return torch.cat([x.mean(dim=1), x.gather(1, idx[:, None, :])[:, 0]],
                         dim=1)

    def relu_hook(module, args, out):
        x = args[0]
        return x * routed("relu", x > 0)

    original = grid_mod.mean_max_pool
    grid_mod.mean_max_pool = pool
    hooks = [mod.register_forward_hook(relu_hook) for mod in model.modules()
             if isinstance(mod, torch.nn.ReLU)]
    grads = {}
    try:
        model.train()
        for impl in impls:
            calls.update(pool=0, relu=0)
            engine.batch_loss(model, tcfg, batch, impl=impl, **dropout_kwargs(
                engine, model, generator_seed)).backward()
            grads[impl] = {n: p.grad for n, p in model.named_parameters()
                           if p.grad is not None}
            for p in model.parameters():
                p.grad = None
    finally:
        grid_mod.mean_max_pool = original
        for h in hooks:
            h.remove()
    if len({frozenset(g) for g in grads.values()}) != 1:
        raise AssertionError(f"{' and '.join(impls)} give gradients to "
                             "different parameters")
    return grads, flips, sizes


def gradient_errors(got, ref):
    """Per parameter tensor: rel_l2 = ‖got − ref‖₂ / ‖ref‖₂ and max_abs =
    max |got − ref| / max |ref|.  The max-pool routes each column's gradient
    to one row, so where bf16 rounding changes a near-tied argmax two runs
    route that column to different rows: max_abs sees one row's whole
    contribution, rel_l2 weighs it against the tensor."""
    out = {}
    for n, g in ref.items():
        diff = got[n].float() - g.float()
        out[n] = {"rel_l2": (diff.norm() / g.float().norm().clamp(min=1e-30)).item(),
                  "max_abs": (diff.abs().max()
                              / g.float().abs().max().clamp(min=1e-30)).item()}
    return out


def run_serving(torch, exp, members, samples, *, impl, dtype, kernel, tag):
    """The serving main path, counted: BatchingServer and StreamingPredictor
    over `members`, warmed up; `kernel`'s counts are set to 0 just before
    all `samples` go to the server at once and the first N_STREAMING to
    StreamingPredictor.predict one by one, and the caller reads them right
    after.  Returns (timings and server stats, served and streamed
    (logits, probs), the predictor)."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch.serve import (
        BatchingServer, StreamingPredictor)

    srv = BatchingServer(members, exp.thresholds, impl=impl, max_delay_ms=3.0,
                         dtype=dtype)
    sp = StreamingPredictor(members, exp.thresholds, impl=impl, dtype=dtype)
    try:
        srv.warmup(samples[0])
        sp.warmup(samples[0])
        torch.cuda.synchronize()

        kernel.reset()
        t0 = time.perf_counter()
        done, futs = {}, []
        for i, s in enumerate(samples):
            t_submit = time.perf_counter()
            fut = srv.submit(s)
            fut.add_done_callback(
                lambda f, i=i, t=t_submit: done.__setitem__(
                    i, time.perf_counter() - t))
            futs.append(fut)
        served = [f.result(timeout=600) for f in futs]
        elapsed = time.perf_counter() - t0
        stats = srv.stats()
        stream_ms, streamed = [], []
        for s in samples[:N_STREAMING]:
            t1 = time.perf_counter()
            streamed.append(sp.predict(s))
            stream_ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        srv.close()

    lat_ms = sorted(v * 1e3 for v in done.values())
    out = dict(config=exp.name, impl=impl, dtype=dtype, requests=len(served),
               batches=stats["batches"], by_bucket=stats["by_bucket"],
               forwards=stats["batches"] + N_STREAMING,
               server_elapsed_s=elapsed, server_req_per_s=len(served) / elapsed,
               server_p50_ms=statistics.median(lat_ms), server_max_ms=max(lat_ms),
               stream_ms=stream_ms, stream_p50_ms=statistics.median(stream_ms))
    log(f"[{tag}] server: {len(served)} requests in {elapsed * 1e3:.2f} ms = "
        f"{out['server_req_per_s']:.2f} req/s; p50 latency "
        f"{out['server_p50_ms']:.2f} ms, max {out['server_max_ms']:.2f} ms; "
        f"batches={stats['batches']} by_bucket={stats['by_bucket']}")
    log(f"[{tag}] streaming: {N_STREAMING} batch-1 predicts, p50 "
        f"{out['stream_p50_ms']:.2f} ms ({', '.join(f'{t:.2f}' for t in stream_ms)})")
    pred = np.stack([p for p, _ in served])
    probs = np.stack([q for _, q in served])
    if pred.shape != (len(samples), exp.model.n_emotions) or probs.shape != (
            len(samples), len(exp.thresholds)):
        raise AssertionError(f"served shapes {pred.shape} {probs.shape}")
    if not (np.isfinite(pred).all() and np.isfinite(probs).all()):
        raise AssertionError("served outputs are not finite")
    return out, served, streamed, sp


def check_against_xla(torch, exp, members, samples, served, streamed, *,
                      dtype, tol, tag):
    """The same members through the plain attention path, all requests at
    once: the served and streamed logits (normalised by max(1, |ref|)) and
    probabilities against it, within `tol`.  Returns (errors, the batch on
    the card)."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch.serve import ensemble_serve_fn

    ref_fn = ensemble_serve_fn(members, exp.thresholds, impl="xla", dtype=dtype)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])).cuda()
             for k in samples[0] if k != "label"}
    ref_pred, ref_probs = (t.cpu().numpy() for t in ref_fn(batch))
    scale = max(1.0, float(np.abs(ref_pred).max()))
    pred = np.stack([p for p, _ in served])
    probs = np.stack([q for _, q in served])
    errs = dict(
        err_vs_xla_pred=float(np.abs(pred - ref_pred).max()) / scale,
        err_vs_xla_probs=float(np.abs(probs - ref_probs).max()),
        err_stream_vs_xla=max(max(float(np.abs(p - ref_pred[i]).max()) / scale,
                                  float(np.abs(q - ref_probs[i]).max()))
                              for i, (p, q) in enumerate(streamed)))
    log(f"[{tag}] vs impl=xla on the same members: logits norm_err="
        f"{errs['err_vs_xla_pred']:.3e} probs abs_err="
        f"{errs['err_vs_xla_probs']:.3e} streaming err="
        f"{errs['err_stream_vs_xla']:.3e} (bound {tol:g})")
    if max(errs.values()) > tol:
        raise AssertionError("served outputs disagree with impl='xla'")
    return errs, batch


def profile_serving(torch, exp, members, batch, sp, sample, *, impl, dtype):
    """Where the time goes, after the counted run: one bucket-8 ensemble
    forward and one batch-1 predict under torch.profiler."""
    from multimodal_emotion_processing_tpu_torch.serve import ensemble_serve_fn

    fwd8 = ensemble_serve_fn(members, exp.thresholds, impl=impl, dtype=dtype)
    batch8 = {k: v[:SERVE_BUCKET] for k, v in batch.items()}
    try:
        return {f"bucket{SERVE_BUCKET}_forward": profile_breakdown(
                    torch, lambda: fwd8(batch8)),
                "batch1_predict": profile_breakdown(
                    torch, lambda: sp.predict(sample))}
    except Exception:   # a measurement only: the checks stand
        traceback.print_exc()
        log("[profile] not measured: the profiler failed")
        return "not measured: the profiler failed"


def phase_serve(torch, report):
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.ops.flash_attention import flash_forward_kernel

    exp = configs.get("mosei_trans_s1024")
    dtype, impl = exp.train.compute_dtype, exp.model.attn_impl
    members = [build_model(exp, device="cuda", seed=i) for i in range(N_MEMBERS)]
    n_params = sum(p.numel() for p in members[0].parameters())
    samples = ensure_no_name(synthetic_dataset(exp.name, exp.model,
                                               N_CONCURRENT, seed=7))
    log(f"[main] {exp.name}: dim={exp.model.dim} heads={exp.model.n_heads} "
        f"lens l/v/a={exp.model.l_len}/{exp.model.v_len}/{exp.model.a_len} "
        f"params/member={n_params} members={N_MEMBERS} dtype={dtype} "
        f"impl={impl}")

    main, served, streamed, sp = run_serving(
        torch, exp, members, samples, impl=impl, dtype=dtype,
        kernel=flash_forward_kernel, tag="main")
    launches = flash_forward_kernel.launches
    expected = 18 * N_MEMBERS * main["forwards"]
    main.update(params_per_member=n_params, flash_launches=launches,
                expected_launches=expected)
    report["main_path"] = main
    log(f"[main] flash_fwd launches={launches} expected 18 x {N_MEMBERS} "
        f"members x {main['forwards']} forwards = {expected}")

    errs, batch = check_against_xla(torch, exp, members, samples, served,
                                    streamed, dtype=dtype, tol=BF16_TOL,
                                    tag="main")
    main.update(errs)
    if launches != expected:
        raise AssertionError(f"flash_fwd launched {launches} times, expected "
                             f"{expected}")
    report["profile"] = profile_serving(torch, exp, members, batch, sp,
                                        samples[0], impl=impl, dtype=dtype)
    return launches


def set_gates(torch, members, seed: int = 1234):
    """a, b ~ U(0.5, 1.5) and c ~ U(0.25, 1.0) in every RealFormer block,
    from one seeded generator (c > 0: a gate at or below −1 would cancel
    the next block's mask penalty)."""
    from multimodal_emotion_processing_tpu_torch.models.layers import RealformerBlock

    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in members:
            for blk in m.modules():
                if isinstance(blk, RealformerBlock):
                    blk.a.uniform_(0.5, 1.5, generator=g)
                    blk.b.uniform_(0.5, 1.5, generator=g)
                    blk.c.uniform_(0.25, 1.0, generator=g)


def phase_serve_robot(torch, report):
    """The robot_demo slice: gate-perturbed seeded members served at
    impl="pallas" through BatchingServer and StreamingPredictor, with
    scored_fwd counted per variant, then held against impl="xla"."""
    import copy

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = configs.get("robot_demo")
    m = exp.model
    dtype, impl = exp.train.compute_dtype, "pallas"
    if (dtype, m.dim, m.n_heads, m.n_layers, m.block, m.head) != (
            "float32", 192, ROBOT_HEADS, 2, "realformer", "grid_only"):
        raise AssertionError(f"unexpected config {exp}")
    members = [build_model(exp, device="cuda", seed=i) for i in range(N_MEMBERS)]
    zero_gates = copy.deepcopy(members[0])
    set_gates(torch, members)
    n_params = sum(p.numel() for p in members[0].parameters())
    samples = synthetic_dataset(exp.name, m, N_CONCURRENT, seed=7)
    log(f"[robot] {exp.name}: dim={m.dim} heads={m.n_heads} lens l/v/a="
        f"{m.l_len}/{m.v_len}/{m.a_len} n_layers={m.n_layers} "
        f"params/member={n_params} members={N_MEMBERS} dtype={dtype} "
        f"impl={impl}; gates a, b ~ U(0.5, 1.5), c ~ U(0.25, 1.0)")
    if n_params != ROBOT_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {ROBOT_PARAMS}")

    main, served, streamed, sp = run_serving(
        torch, exp, members, samples, impl=impl, dtype=dtype,
        kernel=pa.scored_forward_kernel, tag="robot")
    launches = pa.scored_forward_kernel.launches
    by_variant = dict(pa.scored_forward_kernel.variant_launches)
    forwards = main["forwards"]
    expected = 18 * N_MEMBERS * forwards
    expected_by_variant = {v: (9 * N_MEMBERS * forwards if v in MAIN_VARIANTS
                               else 0) for v in pa.VARIANTS}
    main.update(params_per_member=n_params, scored_launches=launches,
                scored_launches_by_variant={f"sprev={int(a)},emit={int(b)}": n
                                            for (a, b), n in by_variant.items()},
                expected_launches=expected)
    report["robot_path"] = main
    log(f"[robot] scored_fwd launches={launches} by variant "
        f"{main['scored_launches_by_variant']}; expected 18 x {N_MEMBERS} "
        f"members x {forwards} forwards = {expected}, split 9/9 between "
        "(no S_prev, emit S) and (S_prev, no S)")

    errs, batch = check_against_xla(torch, exp, members, samples, served,
                                    streamed, dtype=dtype, tol=ROBOT_TOL,
                                    tag="robot")
    # the check sees the attention: member 0 with its gates at 0 (as built)
    # gives other logits than with the gates set
    with torch.no_grad():
        gated = members[0](batch, impl="xla").float()
        ungated = zero_gates(batch, impl="xla").float()
    gate_effect = float((gated - ungated).abs().max()) / max(
        1.0, float(gated.abs().max()))
    main.update(errs, gate_effect=gate_effect)
    log(f"[robot] member 0 with its gates at 0 moves its logits by "
        f"{gate_effect:.3e} (normalised)")
    if gate_effect <= 100 * ROBOT_TOL:
        raise AssertionError("the gates do not reach the logits: the check "
                             "cannot see the attention")
    if launches != expected or by_variant != expected_by_variant:
        raise AssertionError(f"scored_fwd launched {launches} times "
                             f"({by_variant}), expected {expected} "
                             f"({expected_by_variant})")
    report["robot_profile"] = profile_serving(torch, exp, members, batch, sp,
                                              samples[0], impl=impl, dtype=dtype)
    return launches


def variant_counts(kernels):
    """{kernel: {variant: launches}}, {} for a kernel without variants."""
    return {k.name: {f"sprev={int(a)},emit={int(e)}": n
                     for (a, e), n in getattr(k, "variant_launches", {}).items()}
            for k in kernels}


def expected_variants(totals, split):
    """{kernel: {variant: n}} with `totals[kernel]` launches divided among
    the variants as `split` ({(has S_prev, emits S): share}) says."""
    from multimodal_emotion_processing_tpu_torch.ops.pallas_attention import VARIANTS

    return {name: {f"sprev={int(a)},emit={int(e)}": int(n * split.get((a, e), 0))
                   for a, e in VARIANTS} for name, n in totals.items()}


def phase_train_realformer(torch, report):
    """The mosei_realformer training slice: Trainer.fit at impl="pallas"
    from gate-perturbed weights, scored_fwd and both scored_bwd kernels
    counted per variant and timed, then held against impl="xla"."""
    import copy
    import dataclasses

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa
    from multimodal_emotion_processing_tpu_torch.train import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = configs.get("mosei_realformer")
    m, tcfg = exp.model, exp.train
    if (tcfg.batch_size, tcfg.compute_dtype, tcfg.optimizer, tcfg.clip_mask_loss,
            m.dim, m.n_heads, m.n_layers, m.p_len, m.dropout, m.head) != (
            RF_BATCH, "float32", "adam", True, 96, RF_HEADS, 2, RF_P, 0.0,
            "state_transfer"):
        raise AssertionError(f"unexpected config {exp}")
    train = synthetic_dataset(exp.name, m, RF_N_TRAIN, seed=0)
    valid = synthetic_dataset(exp.name, m, RF_N_VALID, seed=1)

    def loaders():
        return (Batcher(train, RF_BATCH, seed=1),
                Batcher(valid, RF_BATCH, shuffle=False))

    state = engine.init_state(m, tcfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in state.model.parameters())
    zero_gates = copy.deepcopy(state.model)
    set_gates(torch, [state.model])
    log(f"[realformer] {exp.name}: dim={m.dim} heads={m.n_heads} lens l/v/a="
        f"{m.l_len}/{m.v_len}/{m.a_len} n_layers={m.n_layers} p_len={m.p_len} "
        f"params={n_params} batch={RF_BATCH} paragraphs ({RF_CLIPS} clips a "
        f"call) f32, optimizer={tcfg.optimizer}, clip-mask loss; "
        f"{RF_N_TRAIN} train / {RF_N_VALID} valid synthetic paragraphs, "
        f"{RF_EPOCHS} epochs; gates a, b ~ U(0.5, 1.5), c ~ U(0.25, 1.0)")
    if n_params != RF_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {RF_PARAMS}")
    init_weights = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}

    # step-1 gradients, pallas against xla, on the same weights and batch;
    # and the gates reach them: with the gates at 0 (as built) ctx never
    # reaches the loss and every w_qkv gradient is 0
    first = to_device(next(iter(loaders()[0]())), "cuda")
    grads = step_gradients(engine, state.model, tcfg, first,
                           impls=("pallas", "xla"))
    unpinned = max(e["rel_l2"] for e in gradient_errors(
        grads["pallas"], grads["xla"]).values())
    grads, flips, routes = pinned_step_gradients(
        torch, engine, state.model, tcfg, first, ("pallas", "xla"))
    grad_err = gradient_errors(grads["pallas"], grads["xla"])
    max_grad_err = max(e["rel_l2"] for e in grad_err.values())
    log(f"[realformer] step-1 gradients pallas vs xla: worst relative L2 "
        f"{unpinned:.2e} as each forward routes its own max pool and ReLUs; "
        f"the xla forward routes {flips['pool']} of {routes['pool']} pooled "
        f"columns and {flips['relu']} of {routes['relu']} ReLU inputs "
        "otherwise than the pallas one (bounds: no pooled column, a share "
        f"of {RF_RELU_FLIP_SHARE:g} of the ReLU inputs), and with the ReLU "
        "routing pinned to the pallas forward's:")
    ungated = step_gradients(engine, zero_gates, tcfg, first, impls=("xla",))["xla"]
    qkv = [n for n in grads["xla"] if ".w_qkv." in n]
    gate_effect = max(float((grads["xla"][n] - ungated.get(
        n, torch.zeros_like(grads["xla"][n]))).abs().max()) for n in qkv)
    del zero_gates, ungated
    for form in ("rel_l2", "max_abs"):
        worst = sorted(grad_err.items(), key=lambda kv: -kv[1][form])[:4]
        log(f"[realformer] step-1 gradients pallas vs xla, {len(grad_err)} "
            f"tensors, {form} per tensor, worst: "
            + ", ".join(f"{n}={e[form]:.2e}" for n, e in worst))
    log(f"[realformer] zeroing the gates moves the step-1 w_qkv gradients by "
        f"up to {gate_effect:.3e}")
    del grads

    # the main path, counted: Trainer.fit at impl="pallas"
    for kern in pa.KERNELS:
        kern.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = timed_trainer(torch, engine)(m, tcfg, impl="pallas", device="cuda")
    t0 = time.perf_counter()
    state, hist = trainer.fit(*loaders(), state=state, epochs=RF_EPOCHS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in pa.KERNELS}
    by_variant = variant_counts(pa.KERNELS)
    peak = torch.cuda.max_memory_allocated()
    step_ms = trainer.step_ms()
    n_steps = sum(h.steps for h in hist)
    n_eval = RF_EPOCHS * -(-RF_N_VALID // RF_BATCH)
    expected = {"scored_fwd": 18 * (n_steps + n_eval),
                "scored_bwd_dq": 18 * n_steps, "scored_bwd_dkv": 18 * n_steps}
    expected_by_variant = expected_variants(
        expected, {v: 0.5 for v in MAIN_VARIANTS})
    losses = [x for h in hist for x in h.step_losses]
    median = statistics.median(step_ms[1:])
    for e, h in enumerate(hist):
        log(f"[realformer] epoch {e}: train_loss={h.train_loss:.6f} "
            f"valid_loss={h.valid_loss:.6f} steps={h.steps} samples={h.samples}"
            f" seconds={h.seconds:.3f} samples/s={h.samples_per_sec:.1f}")
    log(f"[realformer] step losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log(f"[realformer] step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median after the first {median:.2f} ms = "
        f"{RF_BATCH / median * 1e3:.1f} paragraphs/s "
        f"({RF_CLIPS / median * 1e3:.1f} clips/s); fit wall {wall_s:.2f} s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[realformer] launches {launches}, by variant {by_variant}; expected "
        f"{expected} (18 attention calls x {n_steps} steps, + 18 x {n_eval} "
        "eval forwards), split evenly between (no S_prev, emit S) and "
        "(S_prev, no S)")

    # the same run through the plain attention path
    twin = engine.init_state(m, tcfg, seed=0, device="cuda")
    twin.model.load_state_dict(init_weights)
    del init_weights
    torch.cuda.reset_peak_memory_stats()
    twin_trainer = timed_trainer(torch, engine)(m, tcfg, impl="xla", device="cuda")
    twin, hist_x = twin_trainer.fit(*loaders(), state=twin, epochs=RF_EPOCHS)
    peak_x = torch.cuda.max_memory_allocated()
    step_ms_x = twin_trainer.step_ms()
    losses_x = [x for h in hist_x for x in h.step_losses]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, losses_x))
    log(f"[realformer] impl=xla from the same weights and batches: step "
        "losses " + ", ".join(f"{x:.6f}" for x in losses_x)
        + f"; max relative loss difference {loss_rel:.2e} (bound "
        f"{RF_LOSS_TOL:g}); step ms median after the first "
        f"{statistics.median(step_ms_x[1:]):.2f}; peak memory "
        f"{peak_x / 2**30:.2f} GiB")

    report["train_realformer"] = dict(
        config=exp.name, params=n_params, batch=RF_BATCH, clips=RF_CLIPS,
        steps=n_steps, eval_forwards=n_eval, step_losses=losses,
        step_losses_xla=losses_x,
        epochs=[dataclasses.asdict(h) for h in hist],
        epochs_xla=[dataclasses.asdict(h) for h in hist_x],
        step_ms=step_ms, step_ms_xla=step_ms_x, step_ms_median=median,
        step_ms_median_xla=statistics.median(step_ms_x[1:]),
        paragraphs_per_s=RF_BATCH / median * 1e3, fit_wall_s=wall_s,
        peak_bytes=peak, peak_bytes_xla=peak_x, launches=launches,
        launches_by_variant=by_variant, expected_launches=expected,
        grad_err=grad_err, max_grad_rel_l2=max_grad_err,
        max_grad_rel_l2_unpinned=unpinned, routing_flips=flips,
        routings=routes,
        max_loss_rel_err=loss_rel, gate_effect_w_qkv_grad=gate_effect)
    if not (len(losses) == len(losses_x) == n_steps == 8
            and np.isfinite(losses + losses_x).all()):
        raise AssertionError(f"step losses {losses} / {losses_x}")
    if launches != expected or by_variant != expected_by_variant:
        raise AssertionError(f"launches {launches} {by_variant}, expected "
                             f"{expected} {expected_by_variant}")
    if flips["pool"] or flips["relu"] > RF_RELU_FLIP_SHARE * routes["relu"]:
        raise AssertionError(f"the pallas and xla forwards route {flips} of "
                             f"{routes} max-pool columns and ReLU inputs "
                             "differently: more than rounding can move")
    if max_grad_err > RF_GRAD_TOL:
        raise AssertionError(f"step-1 gradients disagree with impl='xla': "
                             f"relative L2 {max_grad_err:.3e}")
    if loss_rel > RF_LOSS_TOL:
        raise AssertionError(f"losses disagree with impl='xla': {loss_rel:.3e}")
    if gate_effect <= 0.0:
        raise AssertionError("the gates do not reach the w_qkv gradients: "
                             "the check cannot see the attention")
    try:
        report["train_realformer_profile"] = {
            "pallas_step": profile_breakdown(
                torch, trainer.programs["train"]),
            "xla_step": profile_breakdown(
                torch, twin_trainer.programs["train"])}
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        report["train_realformer_profile"] = "not measured: the profiler failed"
        log("[profile] not measured: the profiler failed")
    return launches


def phase_serve_paragraph(torch, report):
    """Paragraph serving: RF_MEMBERS gate-perturbed seeded members of
    mosei_realformer in a ParagraphStreamingPredictor at impl="pallas",
    one synthetic paragraph pushed clip by clip, held against the members'
    whole-window forward at impl="xla"."""
    import copy

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa
    from multimodal_emotion_processing_tpu_torch.serve import ParagraphStreamingPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = configs.get("mosei_realformer")
    members = [build_model(exp, device="cuda", seed=i) for i in range(RF_MEMBERS)]
    zero_gates = copy.deepcopy(members[0])
    set_gates(torch, members, seed=4321)
    sample = synthetic_dataset(exp.name, exp.model, 1, seed=7)[0]
    keys = ParagraphStreamingPredictor._CLIP_KEYS
    clips = [{k: sample[k][t] for k in keys} for t in range(RF_P)]
    sp = ParagraphStreamingPredictor(members, RF_OFFSETS, impl="pallas")
    log(f"[paragraph] {exp.name}: {RF_MEMBERS} seeded members (gates set), "
        f"f32, impl=pallas, one synthetic paragraph of {RF_P} clips "
        f"({int(sample['clip_mask'].sum())} valid), offsets {RF_OFFSETS}")
    sp.warmup(clips[0])
    torch.cuda.synchronize()

    pa.scored_forward_kernel.reset()
    clip_ms, pushed = [], []
    for clip in clips:
        t0 = time.perf_counter()
        pushed.append(sp.push(clip))
        clip_ms.append((time.perf_counter() - t0) * 1e3)
    launches = pa.scored_forward_kernel.launches
    by_variant = dict(pa.scored_forward_kernel.variant_launches)
    expected = 18 * RF_MEMBERS * RF_P
    expected_by_variant = {v: expected // 2 if v in MAIN_VARIANTS else 0
                           for v in pa.VARIANTS}

    batch = {k: torch.from_numpy(sample[k][None]).cuda() for k in keys}
    with torch.no_grad():
        whole = torch.stack([mb(batch, impl="xla")[0] for mb in members])
        ref = whole.mean(dim=0).cpu().numpy()                   # (P, E)
        gate_effect = float((members[0](batch, impl="xla")
                             - zero_gates(batch, impl="xla")).abs().max())
    scale = max(1.0, float(np.abs(ref).max()))
    err = max(float(np.abs(pred - ref[t]).max()) / scale
              for t, (pred, _) in enumerate(pushed))
    ref_probs = 1 / (1 + np.exp(-(ref - np.asarray(RF_OFFSETS))))
    prob_err = max(float(np.abs(probs - ref_probs[t]).max())
                   for t, (_, probs) in enumerate(pushed))
    sp.reset()
    reset_err = float(np.abs(sp.push(clips[0])[0] - ref[0]).max()) / scale
    report["paragraph_path"] = dict(
        config=exp.name, members=RF_MEMBERS, clips=RF_P,
        valid_clips=int(sample["clip_mask"].sum()), clip_ms=clip_ms,
        clip_p50_ms=statistics.median(clip_ms), scored_launches=launches,
        scored_launches_by_variant={f"sprev={int(a)},emit={int(e)}": n
                                    for (a, e), n in by_variant.items()},
        expected_launches=expected, err_vs_whole_window_xla=err,
        probs_err=prob_err, reset_err=reset_err, gate_effect=gate_effect)
    log(f"[paragraph] per-clip push ms: " + ", ".join(f"{t:.2f}" for t in clip_ms)
        + f"; p50 {statistics.median(clip_ms):.2f} ms")
    log(f"[paragraph] scored_fwd launches={launches} by variant "
        f"{report['paragraph_path']['scored_launches_by_variant']}; expected "
        f"18 x {RF_MEMBERS} members x {RF_P} clips = {expected}")
    log(f"[paragraph] clip-t logits vs the whole-window xla forward: norm_err "
        f"{err:.3e}, probs {prob_err:.3e}, after reset() {reset_err:.3e} "
        f"(bound {ROBOT_TOL:g}); zeroing member 0's gates moves its logits "
        f"by {gate_effect:.3e}")
    if max(err, prob_err, reset_err) > ROBOT_TOL:
        raise AssertionError("streamed paragraph logits disagree with the "
                             "whole-window forward")
    if gate_effect <= 100 * ROBOT_TOL:
        raise AssertionError("the gates do not reach the logits")
    if launches != expected or by_variant != expected_by_variant:
        raise AssertionError(f"scored_fwd launched {launches} times "
                             f"({by_variant}), expected {expected}")
    return launches


def spread_ln(torch, models, seed: int = 99):
    """Every LayerNorm's bias moved by 0.1·N(0, 1) from a seeded generator
    (tests/test_torch_train.py::_spread_ln_biases): in a no_name slot every
    block's output is its LN bias, and at their init of 0 the max pool
    would compare exact ties across blocks."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for m in models:
            for name, p in m.named_parameters():
                if "norm" in name and name.endswith(".bias"):
                    p.add_(0.1 * torch.randn(p.shape, generator=g,
                                             device="cuda"))


def phase_train_fused(torch, report):
    """The mosei_trans training slice at impl="pallas_fused": Trainer.fit
    with fused_block forward and both scored_bwd kernels counted per
    variant and timed, then held against impl="xla"; then one chained
    (n_layers=2) forward and backward, the S_prev variants' model path."""
    import dataclasses

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.ops import fused_block as fb
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa
    from multimodal_emotion_processing_tpu_torch.train import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = configs.get("mosei_trans")
    m, tcfg = exp.model, exp.train
    if (tcfg.batch_size, tcfg.compute_dtype, tcfg.optimizer, m.dim, m.n_heads,
            m.n_layers, m.dropout, m.unify, m.head) != (
            MT_BATCH, "float32", "adamw", 96, MT_HEADS, 1, 0.0, "linear",
            "concat_trans"):
        raise AssertionError(f"unexpected config {exp}")
    train = ensure_no_name(synthetic_dataset(exp.name, m, MT_N_TRAIN, seed=0))
    valid = ensure_no_name(synthetic_dataset(exp.name, m, MT_N_VALID, seed=1))

    def loaders():
        return (Batcher(train, MT_BATCH, seed=1),
                Batcher(valid, MT_BATCH, shuffle=False))

    kernels = fb.KERNELS + (pa.scored_backward_kernel.dq,
                            pa.scored_backward_kernel.dkv)
    state = engine.init_state(m, tcfg, seed=0, device="cuda")
    spread_ln(torch, [state.model])
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"[fused] {exp.name}: dim={m.dim} heads={m.n_heads} lens l/v/a="
        f"{m.l_len}/{m.v_len}/{m.a_len} n_layers={m.n_layers} params={n_params}"
        f" batch={MT_BATCH} f32, optimizer={tcfg.optimizer}; {MT_N_TRAIN} train"
        f" / {MT_N_VALID} valid synthetic pairs, {MT_EPOCHS} epochs; LN biases "
        "spread by 0.1 N(0, 1)")
    if n_params != MT_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {MT_PARAMS}")
    init_weights = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}

    # step-1 gradients, pallas_fused against xla, on the same weights and
    # batch, with the max pool's routing pinned to the fused forward's
    first = to_device(next(iter(loaders()[0]())), "cuda")
    impls = ("pallas_fused", "xla")
    grads = step_gradients(engine, state.model, tcfg, first, impls=impls)
    unpinned = max(e["rel_l2"] for e in gradient_errors(
        grads["pallas_fused"], grads["xla"]).values())
    grads, flips, routes = pinned_step_gradients(
        torch, engine, state.model, tcfg, first, impls, pin_pool=True)
    grad_err = gradient_errors(grads["pallas_fused"], grads["xla"])
    max_grad_err = max(e["rel_l2"] for e in grad_err.values())
    del grads
    for form in ("rel_l2", "max_abs"):
        worst = sorted(grad_err.items(), key=lambda kv: -kv[1][form])[:4]
        log(f"[fused] step-1 gradients pallas_fused vs xla, {len(grad_err)} "
            f"tensors, max pool pinned, {form} per tensor, worst: "
            + ", ".join(f"{n}={e[form]:.2e}" for n, e in worst))
    log(f"[fused] the xla forward routes {flips['pool']} of {routes['pool']} "
        f"pooled columns otherwise than the fused one (bound: a share of "
        f"{MT_POOL_FLIP_SHARE:g}); unpinned, the worst relative L2 is "
        f"{unpinned:.2e}")

    # the main path, counted: Trainer.fit at impl="pallas_fused"
    for kern in kernels:
        kern.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = timed_trainer(torch, engine)(m, tcfg, impl="pallas_fused",
                                           device="cuda")
    t0 = time.perf_counter()
    state, hist = trainer.fit(*loaders(), state=state, epochs=MT_EPOCHS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    by_variant = variant_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    step_ms = trainer.step_ms()
    n_steps = sum(h.steps for h in hist)
    n_eval = MT_EPOCHS * -(-MT_N_VALID // MT_BATCH)
    expected = {"fused_block": 18 * (n_steps + n_eval),
                "scored_bwd_dq": 18 * n_steps, "scored_bwd_dkv": 18 * n_steps}
    expected_by_variant = expected_variants(expected, {(False, False): 1})
    losses = [x for h in hist for x in h.step_losses]
    median = statistics.median(step_ms[1:])
    for e, h in enumerate(hist):
        log(f"[fused] epoch {e}: train_loss={h.train_loss:.6f} valid_loss="
            f"{h.valid_loss:.6f} steps={h.steps} samples={h.samples} "
            f"seconds={h.seconds:.3f} samples/s={h.samples_per_sec:.1f}")
    log("[fused] step losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log("[fused] step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median after the first {median:.2f} ms = "
        f"{MT_BATCH / median * 1e3:.1f} samples/s; fit wall {wall_s:.2f} s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[fused] launches {launches}, by variant {by_variant}; expected "
        f"{expected} (18 blocks x {n_steps} steps, + 18 x {n_eval} eval "
        "forwards), all terminal blocks: no S_prev, no S")

    # the same run through the plain attention path
    twin = engine.init_state(m, tcfg, seed=0, device="cuda")
    twin.model.load_state_dict(init_weights)
    del init_weights
    torch.cuda.reset_peak_memory_stats()
    twin_trainer = timed_trainer(torch, engine)(m, tcfg, impl="xla",
                                                device="cuda")
    twin, hist_x = twin_trainer.fit(*loaders(), state=twin, epochs=MT_EPOCHS)
    peak_x = torch.cuda.max_memory_allocated()
    step_ms_x = twin_trainer.step_ms()
    losses_x = [x for h in hist_x for x in h.step_losses]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, losses_x))
    log("[fused] impl=xla from the same weights and batches: step losses "
        + ", ".join(f"{x:.6f}" for x in losses_x)
        + f"; max relative loss difference {loss_rel:.2e} (bound "
        f"{MT_LOSS_TOL:g}); step ms median after the first "
        f"{statistics.median(step_ms_x[1:]):.2f}; peak memory "
        f"{peak_x / 2**30:.2f} GiB")

    report["train_fused"] = dict(
        config=exp.name, params=n_params, batch=MT_BATCH, steps=n_steps,
        eval_forwards=n_eval, step_losses=losses, step_losses_xla=losses_x,
        epochs=[dataclasses.asdict(h) for h in hist],
        epochs_xla=[dataclasses.asdict(h) for h in hist_x],
        step_ms=step_ms, step_ms_xla=step_ms_x, step_ms_median=median,
        step_ms_median_xla=statistics.median(step_ms_x[1:]),
        samples_per_s=MT_BATCH / median * 1e3, fit_wall_s=wall_s,
        peak_bytes=peak, peak_bytes_xla=peak_x, launches=launches,
        launches_by_variant=by_variant, expected_launches=expected,
        grad_err=grad_err, max_grad_rel_l2=max_grad_err,
        max_grad_rel_l2_unpinned=unpinned, routing_flips=flips,
        routings=routes, max_loss_rel_err=loss_rel)
    if not (len(losses) == len(losses_x) == n_steps == 8
            and np.isfinite(losses + losses_x).all()):
        raise AssertionError(f"step losses {losses} / {losses_x}")
    if launches != expected or by_variant != expected_by_variant:
        raise AssertionError(f"launches {launches} {by_variant}, expected "
                             f"{expected} {expected_by_variant}")
    if flips["pool"] > MT_POOL_FLIP_SHARE * routes["pool"]:
        raise AssertionError(f"the fused and xla forwards route {flips} of "
                             f"{routes} pooled columns differently: more "
                             "than rounding can move")
    if max_grad_err > MT_GRAD_TOL:
        raise AssertionError(f"step-1 gradients disagree with impl='xla': "
                             f"relative L2 {max_grad_err:.3e}")
    if loss_rel > MT_LOSS_TOL:
        raise AssertionError(f"losses disagree with impl='xla': {loss_rel:.3e}")
    try:
        report["train_fused_profile"] = {
            "pallas_fused_step": profile_breakdown(
                torch, trainer.programs["train"]),
            "xla_step": profile_breakdown(
                torch, twin_trainer.programs["train"])}
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        report["train_fused_profile"] = "not measured: the profiler failed"
        log("[profile] not measured: the profiler failed")
    del state, twin, trainer, twin_trainer
    chained = fused_chained_check(torch, report, exp, first, kernels)
    return {"main": launches, "chained": chained}


def fused_chained_check(torch, report, exp, first, kernels):
    """One forward and backward of a full-width mosei_trans member with
    n_layers=2 (each stream's block 0 emits S, block 1 reads it under its
    gate c ~ U(0.25, 1.0)) at batch MT_CHAINED_BATCH, at pallas_fused
    against xla: the logits, the gradients (max pool pinned) and the
    launches per variant."""
    import dataclasses

    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.models.layers import MinusBlock
    from multimodal_emotion_processing_tpu_torch.train import engine

    m2 = dataclasses.replace(exp.model, n_layers=2)
    model = build_model(m2, device="cuda", seed=5)
    spread_ln(torch, [model], seed=98)
    g = torch.Generator(device="cuda").manual_seed(1234)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, MinusBlock):
                blk.c.uniform_(0.25, 1.0, generator=g)
    batch = {k: v[:MT_CHAINED_BATCH] for k, v in first.items()}
    for kern in kernels:
        kern.reset()
    grads, flips, routes = pinned_step_gradients(
        torch, engine, model, exp.train, batch, ("pallas_fused", "xla"),
        pin_pool=True)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    by_variant = variant_counts(kernels)
    expected = {k.name: 36 for k in kernels}
    expected_by_variant = expected_variants(
        expected, {v: 0.5 for v in MAIN_VARIANTS})
    grad_err = gradient_errors(grads["pallas_fused"], grads["xla"])
    max_grad_err = max(e["rel_l2"] for e in grad_err.values())
    gates = [n for n in grad_err if n.endswith(".c")]
    with torch.no_grad():
        model.eval()
        fused = model(batch, impl="pallas_fused")
        ref = model(batch, impl="xla")
    logit_err = errors(fused, ref)[1]
    worst = sorted(grad_err.items(), key=lambda kv: -kv[1]["rel_l2"])[:4]
    log(f"[fused] chained: n_layers=2 member, batch {MT_CHAINED_BATCH}, gates "
        f"c ~ U(0.25, 1.0): logits norm_err {logit_err:.2e}; step-1 gradients "
        f"(max pool pinned, {flips['pool']} of {routes['pool']} columns routed "
        f"otherwise) worst relative L2 "
        + ", ".join(f"{n}={e['rel_l2']:.2e}" for n, e in worst)
        + f"; {len(gates)} gates c get gradients; launches {by_variant}")
    report["train_fused_chained"] = dict(
        batch=MT_CHAINED_BATCH, logits_norm_err=logit_err,
        max_grad_rel_l2=max_grad_err, gates_with_gradients=len(gates),
        routing_flips=flips, routings=routes, launches=launches,
        launches_by_variant=by_variant)
    if launches != expected or by_variant != expected_by_variant:
        raise AssertionError(f"chained launches {launches} {by_variant}, "
                             f"expected {expected_by_variant}")
    if len(gates) != 18:
        raise AssertionError(f"{len(gates)} gates get gradients, expected 18")
    if flips["pool"] > MT_POOL_FLIP_SHARE * routes["pool"]:
        raise AssertionError(f"chained: {flips} of {routes} pooled columns "
                             "routed differently")
    if max_grad_err > MT_GRAD_TOL or logit_err > MT_GRAD_TOL:
        raise AssertionError(f"chained block disagrees with impl='xla': "
                             f"gradients {max_grad_err:.3e}, logits "
                             f"{logit_err:.3e}")
    return launches


def phase_serve_ren_mme(torch, report):
    """The ren_mme serving slice: seeded members in f32 served at
    impl="pallas_fused" (eval mode: dropout inactive) through BatchingServer
    and StreamingPredictor, with fused_block counted per variant, then
    held against impl="xla"."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = configs.get("ren_mme")
    m = exp.model
    dtype, impl = exp.train.compute_dtype, "pallas_fused"
    if (dtype, m.dim, m.n_heads, m.n_layers, m.block, m.unify, m.head) != (
            "float32", 128, REN_HEADS, 1, "minus", "linear_ln", "concat_trans"):
        raise AssertionError(f"unexpected config {exp}")
    members = [build_model(exp, device="cuda", seed=i) for i in range(N_MEMBERS)]
    spread_ln(torch, members, seed=97)
    n_params = sum(p.numel() for p in members[0].parameters())
    samples = synthetic_dataset(exp.name, m, N_CONCURRENT, seed=7)
    log(f"[ren_mme] {exp.name}: dim={m.dim} heads={m.n_heads} lens l/v/a="
        f"{m.l_len}/{m.v_len}/{m.a_len} unify={m.unify} params/member="
        f"{n_params} members={N_MEMBERS} dtype={dtype} impl={impl}, eval "
        f"(dropout {m.dropout} inactive); LN biases spread by 0.1 N(0, 1)")
    if n_params != REN_PARAMS:
        raise AssertionError(f"{n_params} parameters, expected {REN_PARAMS}")

    main, served, streamed, sp = run_serving(
        torch, exp, members, samples, impl=impl, dtype=dtype,
        kernel=fb.fused_block_kernel, tag="ren_mme")
    launches = fb.fused_block_kernel.launches
    by_variant = variant_counts(fb.KERNELS)
    forwards = main["forwards"]
    expected = {"fused_block": 18 * N_MEMBERS * forwards}
    expected_by_variant = expected_variants(expected, {(False, False): 1})
    main.update(params_per_member=n_params, fused_launches=launches,
                fused_launches_by_variant=by_variant["fused_block"],
                expected_launches=expected["fused_block"])
    report["ren_mme_path"] = main
    log(f"[ren_mme] fused_block launches={launches} by variant "
        f"{by_variant['fused_block']}; expected 18 x {N_MEMBERS} members x "
        f"{forwards} forwards = {expected['fused_block']}, all without S_prev "
        "or S")
    errs, batch = check_against_xla(torch, exp, members, samples, served,
                                    streamed, dtype=dtype, tol=ROBOT_TOL,
                                    tag="ren_mme")
    main.update(errs)
    if launches != expected["fused_block"] or by_variant != expected_by_variant:
        raise AssertionError(f"fused_block launched {launches} times "
                             f"({by_variant}), expected {expected_by_variant}")
    report["ren_mme_profile"] = profile_serving(torch, exp, members, batch, sp,
                                                samples[0], impl=impl,
                                                dtype=dtype)
    # the same forwards through the plain attention path, for comparison
    from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor

    sp_xla = StreamingPredictor(members, exp.thresholds, impl="xla",
                                dtype=dtype)
    sp_xla.warmup(samples[0])
    log("[ren_mme] profile at impl=xla:")
    report["ren_mme_profile_xla"] = profile_serving(
        torch, exp, members, batch, sp_xla, samples[0], impl="xla",
        dtype=dtype)
    return launches


def train_against_xla(torch, report, *, tag, exp, impl, batch, n_train,
                      n_valid, epochs, kernels, expected, prepare=None,
                      ref_device="cuda"):
    """One member of `exp` trained by the port's Trainer at `impl` for
    `epochs` with an eval pass after each, `kernels` counted per variant
    over that run (their counts set to 0 just before it) and held against
    `expected(n_steps, n_eval)` = (launches, launches by variant); then the
    same run at impl="xla" on `ref_device` from the same weights, batches
    and dropout generator seed.  Checks the step-1 gradients (on the card,
    max pool and ReLUs pinned to `impl`'s forward, as in the realformer and
    fused phases), the step losses and each epoch's valid loss against the
    reference, and profiles one step of each run on the card.  A CPU
    reference draws other dropout masks, so it serves only models without
    a dropout site.  `prepare` moves the fresh model's weights (gates,
    LayerNorms) before anything runs.  Returns the launches."""
    import dataclasses

    import numpy as np

    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.train import engine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, tcfg = exp.model, exp.train
    dup = tcfg.rdrop_kl
    rows = batch * (2 if dup else 1)
    train = synthetic_dataset(exp.name, m, n_train, seed=0)
    valid = synthetic_dataset(exp.name, m, n_valid, seed=1)
    ref = f"xla on {ref_device}"

    def loaders():
        return (Batcher(train, batch, duplicate=dup, seed=1),
                Batcher(valid, batch, duplicate=dup, shuffle=False))

    state = engine.init_state(m, tcfg, seed=0, device="cuda")
    if prepare is not None:
        prepare(state.model)
    n_params = sum(p.numel() for p in state.model.parameters())
    init_weights = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}
    log(f"[{tag}] {exp.name}: dim={m.dim} heads={m.n_heads} lens l/v/a="
        f"{m.l_len}/{m.v_len}/{m.a_len} n_layers={m.n_layers} head={m.head} "
        f"params={n_params} batch={batch} ({rows} rows"
        f"{', R-Drop pairs' if dup else ''}) f32, optimizer={tcfg.optimizer},"
        f" dropout={m.dropout}; {n_train} train / {n_valid} valid synthetic "
        f"samples, {epochs} epochs, impl={impl}, reference {ref}")

    # step-1 gradients against the reference, on the same weights and batch
    # and from the same dropout generator seed as the fit's first step
    first = next(iter(loaders()[0]()))
    if ref_device == "cuda":
        first = to_device(first, "cuda")
        impls = (impl, "xla")
        grads = step_gradients(engine, state.model, tcfg, first, impls=impls,
                               generator_seed=0)
        unpinned = max(e["rel_l2"] for e in gradient_errors(
            grads[impl], grads["xla"]).values())
        grads, flips, routes = pinned_step_gradients(
            torch, engine, state.model, tcfg, first, impls, pin_pool=True,
            generator_seed=0)
        grad_err = gradient_errors(grads[impl], grads["xla"])
        log(f"[{tag}] the xla forward routes {flips['pool']} of "
            f"{routes['pool']} pooled columns and {flips['relu']} of "
            f"{routes['relu']} ReLU inputs otherwise than the {impl} one "
            f"(bounds: shares of {MT_POOL_FLIP_SHARE:g} and "
            f"{RF_RELU_FLIP_SHARE:g}); unpinned, the worst relative L2 is "
            f"{unpinned:.2e}")
    else:
        ref_state = engine.init_state(m, tcfg, seed=0, device=ref_device)
        ref_state.model.load_state_dict(init_weights)
        grads = {}
        for key, model, dev in (("got", state.model, "cuda"),
                                ("ref", ref_state.model, ref_device)):
            model.train()
            engine.batch_loss(model, tcfg, to_device(first, dev), impl=impl,
                              **dropout_kwargs(engine, model, 0)).backward()
            grads[key] = {n: p.grad.cpu() for n, p in model.named_parameters()}
            model.zero_grad(set_to_none=True)
        grad_err = gradient_errors(grads["got"], grads["ref"])
        unpinned, flips, routes = None, None, None
        first = to_device(first, "cuda")
    max_grad_err = max(e["rel_l2"] for e in grad_err.values())
    del grads
    for form in ("rel_l2", "max_abs"):
        worst = sorted(grad_err.items(), key=lambda kv: -kv[1][form])[:4]
        log(f"[{tag}] step-1 gradients {impl} vs {ref}, {len(grad_err)} "
            f"tensors, {form} per tensor, worst: "
            + ", ".join(f"{n}={e[form]:.2e}" for n, e in worst))

    # the main path, counted: Trainer.fit at `impl`
    for kern in kernels:
        kern.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = timed_trainer(torch, engine)(m, tcfg, impl=impl, device="cuda")
    t0 = time.perf_counter()
    state, hist = trainer.fit(*loaders(), state=state, epochs=epochs)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    by_variant = variant_counts(kernels)
    peak = torch.cuda.max_memory_allocated()
    step_ms = trainer.step_ms()
    n_steps = sum(h.steps for h in hist)
    n_eval = epochs * -(-n_valid // batch)
    want, want_by_variant = expected(n_steps, n_eval)
    losses = [x for h in hist for x in h.step_losses]
    median = statistics.median(step_ms[1:])
    for e, h in enumerate(hist):
        log(f"[{tag}] epoch {e}: train_loss={h.train_loss:.6f} valid_loss="
            f"{h.valid_loss:.6f} steps={h.steps} rows={h.samples} "
            f"seconds={h.seconds:.3f} rows/s={h.samples_per_sec:.1f}")
    log(f"[{tag}] step losses: " + ", ".join(f"{x:.6f}" for x in losses))
    log(f"[{tag}] step ms: " + ", ".join(f"{x:.2f}" for x in step_ms)
        + f"; median after the first {median:.2f} ms = "
        f"{batch / median * 1e3:.1f} samples/s ({rows / median * 1e3:.1f} "
        f"rows/s); fit wall {wall_s:.2f} s; peak memory {peak / 2**30:.3f} GiB")
    log(f"[{tag}] launches {launches}, by variant {by_variant}; expected "
        f"{want} ({n_steps} steps, {n_eval} eval forwards)")

    # the same run at impl="xla" on the reference device
    twin = engine.init_state(m, tcfg, seed=0, device=ref_device)
    twin.model.load_state_dict(init_weights)
    del init_weights
    on_card = ref_device == "cuda"
    torch.cuda.reset_peak_memory_stats()
    twin_trainer = (timed_trainer(torch, engine) if on_card else
                    engine.Trainer)(m, tcfg, impl="xla", device=ref_device)
    twin, hist_x = twin_trainer.fit(*loaders(), state=twin, epochs=epochs)
    peak_x = torch.cuda.max_memory_allocated() if on_card else None
    step_ms_x = twin_trainer.step_ms() if on_card else None
    median_x = statistics.median(step_ms_x[1:]) if on_card else None
    losses_x = [x for h in hist_x for x in h.step_losses]
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, losses_x))
    valid_rel = [abs(h.valid_loss - hx.valid_loss) / max(abs(hx.valid_loss),
                                                         1e-30)
                 for h, hx in zip(hist, hist_x)]
    log(f"[{tag}] {ref} from the same weights, batches and dropout seed: "
        "step losses " + ", ".join(f"{x:.6f}" for x in losses_x)
        + f"; max relative loss difference {loss_rel:.2e}; valid losses "
        + ", ".join(f"{h.valid_loss:.6f}" for h in hist_x)
        + ", relative differences " + ", ".join(f"{x:.2e}" for x in valid_rel)
        + f" (bound {DROP_LOSS_TOL:g})"
        + (f"; step ms median after the first {median_x:.2f}; peak memory "
           f"{peak_x / 2**30:.3f} GiB" if on_card else ""))

    report[tag] = dict(
        config=exp.name, impl=impl, reference=ref, params=n_params,
        batch=batch, rows=rows, dropout=m.dropout, rdrop=dup, steps=n_steps,
        eval_forwards=n_eval, step_losses=losses, step_losses_xla=losses_x,
        epochs=[dataclasses.asdict(h) for h in hist],
        epochs_xla=[dataclasses.asdict(h) for h in hist_x],
        step_ms=step_ms, step_ms_xla=step_ms_x, step_ms_median=median,
        step_ms_median_xla=median_x,
        samples_per_s=batch / median * 1e3, rows_per_s=rows / median * 1e3,
        fit_wall_s=wall_s, peak_bytes=peak, peak_bytes_xla=peak_x,
        launches=launches, launches_by_variant=by_variant,
        expected_launches=want, grad_err=grad_err,
        max_grad_rel_l2=max_grad_err, max_grad_rel_l2_unpinned=unpinned,
        routing_flips=flips, routings=routes, max_loss_rel_err=loss_rel,
        valid_loss_rel_err=valid_rel)
    if not (len(losses) == len(losses_x) == n_steps == 8
            and len(hist) == len(hist_x) == epochs
            and np.isfinite(losses + losses_x).all()
            and np.isfinite([h.valid_loss for h in hist + hist_x]).all()):
        raise AssertionError(f"step losses {losses} / {losses_x}, valid "
                             f"losses {[h.valid_loss for h in hist]} / "
                             f"{[h.valid_loss for h in hist_x]}")
    if launches != want or by_variant != want_by_variant:
        raise AssertionError(f"launches {launches} {by_variant}, expected "
                             f"{want} {want_by_variant}")
    if flips is not None and (
            flips["pool"] > MT_POOL_FLIP_SHARE * routes["pool"]
            or flips["relu"] > RF_RELU_FLIP_SHARE * routes["relu"]):
        raise AssertionError(f"the {impl} and xla forwards route {flips} of "
                             f"{routes} pooled columns and ReLU inputs "
                             "differently: more than rounding can move")
    if max_grad_err > DROP_GRAD_TOL:
        raise AssertionError(f"step-1 gradients disagree with {ref}: "
                             f"relative L2 {max_grad_err:.3e}")
    if loss_rel > DROP_LOSS_TOL:
        raise AssertionError(f"losses disagree with {ref}: {loss_rel:.3e}")
    if max(valid_rel) > DROP_LOSS_TOL:
        raise AssertionError(f"valid losses disagree with {ref}: {valid_rel}")
    steps = {impl + "_step": trainer.programs["train"]}
    if on_card:
        steps["xla_step"] = twin_trainer.programs["train"]
    try:
        report[tag + "_profile"] = {k: profile_breakdown(torch, fn)
                                    for k, fn in steps.items()}
    except Exception:   # a measurement only: the checks above stand
        traceback.print_exc()
        report[tag + "_profile"] = "not measured: the profiler failed"
        log("[profile] not measured: the profiler failed")
    return launches


def phase_train_ren_mme(torch, report):
    """The ren_mme training slice: dropout 0.1 and R-Drop at
    impl="pallas_fused", where active dropout routes every minus block to
    scored_fwd with the plain epilogue (and the scored_bwd pair in the
    backward), and the eval passes (dropout inactive) to fused_block; all
    18 blocks terminal (no S_prev, no S)."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.ops import fused_block as fb
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa

    exp = configs.get("ren_mme")
    m, tcfg = exp.model, exp.train
    if (tcfg.batch_size, tcfg.compute_dtype, tcfg.optimizer, tcfg.rdrop_kl,
            m.dim, m.n_heads, m.n_layers, m.dropout, m.unify, m.head) != (
            REN_PAIRS, "float32", "adamw", True, 128, REN_HEADS, 1, 0.1,
            "linear_ln", "concat_trans"):
        raise AssertionError(f"unexpected config {exp}")

    def expected(n_steps, n_eval):
        want = {"fused_block": 18 * n_eval, "scored_fwd": 18 * n_steps,
                "scored_bwd_dq": 18 * n_steps, "scored_bwd_dkv": 18 * n_steps}
        return want, expected_variants(want, {(False, False): 1})

    launches = train_against_xla(
        torch, report, tag="train_ren_mme", exp=exp, impl="pallas_fused",
        batch=REN_PAIRS, n_train=REN_N_TRAIN, n_valid=REN_N_VALID,
        epochs=REN_EPOCHS, kernels=fb.KERNELS + pa.KERNELS, expected=expected,
        prepare=lambda model: spread_ln(torch, [model], seed=97))
    if report["train_ren_mme"]["params"] != REN_PARAMS:
        raise AssertionError("ren_mme parameter count")
    return launches


def phase_train_robot(torch, report):
    """The robot_demo training slice: dropout 0.1, gates set, at
    impl="pallas": scored_fwd in every forward and the scored_bwd pair in
    every backward, block 0 of a stream (no S_prev, emits S) and block 1
    (reads S_prev, emits none) split evenly."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa

    exp = configs.get("robot_demo")
    m, tcfg = exp.model, exp.train
    if (tcfg.batch_size, tcfg.compute_dtype, tcfg.optimizer, m.dim,
            m.n_heads, m.n_layers, m.dropout, m.head) != (
            ROBOT_BATCH, "float32", "adamw", 192, ROBOT_HEADS, 2, 0.1,
            "grid_only"):
        raise AssertionError(f"unexpected config {exp}")

    def expected(n_steps, n_eval):
        want = {"scored_fwd": 18 * (n_steps + n_eval),
                "scored_bwd_dq": 18 * n_steps, "scored_bwd_dkv": 18 * n_steps}
        return want, expected_variants(want, {v: 0.5 for v in MAIN_VARIANTS})

    launches = train_against_xla(
        torch, report, tag="train_robot", exp=exp, impl="pallas",
        batch=ROBOT_BATCH, n_train=ROBOT_N_TRAIN, n_valid=ROBOT_N_VALID,
        epochs=ROBOT_EPOCHS, kernels=pa.KERNELS, expected=expected,
        prepare=lambda model: set_gates(torch, [model]))
    if report["train_robot"]["params"] != ROBOT_PARAMS:
        raise AssertionError("robot_demo parameter count")
    return launches


def phase_train_rencecps(torch, report):
    """The rencecps training slice: the concat_linear head at dim 2304 (no
    grid, no attention, no dropout site), trained by the port's Trainer for
    RC_EPOCHS epochs at batch 64 with every kernel's count held at 0,
    against the same run of the port on the CPU."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.ops import fused_block as fb
    from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa

    exp = configs.get("rencecps")
    m, tcfg = exp.model, exp.train
    if (tcfg.batch_size, tcfg.optimizer, tcfg.rdrop_kl, m.dim, m.head) != (
            RC_BATCH, "adamw", False, 2304, "concat_linear"):
        raise AssertionError(f"unexpected config {exp}")
    kernels = fa.KERNELS + pa.KERNELS + fb.KERNELS

    def expected(n_steps, n_eval):
        return ({k.name: 0 for k in kernels},
                {name: dict.fromkeys(counts, 0)
                 for name, counts in variant_counts(kernels).items()})

    launches = train_against_xla(
        torch, report, tag="train_rencecps", exp=exp, impl="xla",
        batch=RC_BATCH, n_train=RC_N_TRAIN, n_valid=RC_N_VALID,
        epochs=RC_EPOCHS, kernels=kernels, expected=expected,
        ref_device="cpu")
    if report["train_rencecps"]["params"] != RC_PARAMS:
        raise AssertionError("rencecps parameter count")
    return launches


def all_kernels():
    """Every kernel wrapper of the port, each with its launch counter."""
    from multimodal_emotion_processing_tpu_torch.ops import fused_block as fb
    from multimodal_emotion_processing_tpu_torch.ops import flash_attention as fa
    from multimodal_emotion_processing_tpu_torch.ops import pallas_attention as pa

    return fa.KERNELS + pa.KERNELS + fb.KERNELS


def reset_counts(kernels):
    for k in kernels:
        k.reset()


def read_counts(kernels):
    return {k.name: k.launches for k in kernels}


class Preempted(Exception):
    """Raised by a run's log callback to cut it as a preemption would."""


@contextlib.contextmanager
def experiment_hooks(torch, *, spread: bool, gates: bool = False,
                     nudge: bool = False):
    """Instruments the experiment path for the duration of the block and
    restores it after: with `spread`, `engine.init_state` moves every
    LayerNorm bias of a new member by 0.1·N(0, 1) from a generator seeded by
    the member's seed (at init they tie across blocks, and the max pool's
    routing would then rest on the last ulp of each impl: spread_ln); with
    `gates`, it sets a new member's RealFormer gates from a generator seeded
    by the member's seed (set_gates; at their initial 0 the attention cannot
    reach the logits); with `nudge`, it then moves every parameter of a new
    member by one ulp towards +inf (a witness of how far rounding alone
    carries a run);
    `engine.Trainer` records each fit's wall time and CUDA events between
    its captured train steps (timed_trainer); the checkpoint store's
    save_best, save_last and restore_last record their wall times; and
    `Ensemble.predict_all` records its wall time and the kernel launches
    it made.  Yields the record."""
    from multimodal_emotion_processing_tpu_torch.eval import ensemble
    from multimodal_emotion_processing_tpu_torch.train import checkpoint, engine

    rec = {"fits": [], "save_best_ms": [], "save_last_ms": [],
           "restore_last_ms": [], "predict_all": []}
    kernels = all_kernels()
    init, trainer = engine.init_state, engine.Trainer
    store_cls, ens_cls = checkpoint.CheckpointStore, ensemble.Ensemble
    saved = {n: getattr(store_cls, n)
             for n in ("save_best", "save_last", "restore_last")}
    predict_all = ens_cls.predict_all
    base = timed_trainer(torch, engine)

    def prepared_init(cfg, tcfg, seed, **kw):
        state = init(cfg, tcfg, seed, **kw)
        if spread:
            spread_ln(torch, [state.model], seed=99 + seed)
        if gates:
            set_gates(torch, [state.model], seed=1234 + seed)
        if nudge:
            with torch.no_grad():
                for p in state.model.parameters():
                    p.copy_(torch.nextafter(p, p.new_tensor(float("inf"))))
        return state

    class FitTimer(base):
        def fit(self, *args, **kw):
            self.events = []
            t0 = time.perf_counter()
            out = super().fit(*args, **kw)
            torch.cuda.synchronize()
            rec["fits"].append({"wall_s": time.perf_counter() - t0,
                                "step_ms": self.step_ms(),
                                "epochs": len(out[1]),
                                "epoch_s": [h.seconds for h in out[1]]})
            return out

    def timed(name):
        fn = saved[name]

        def wrapper(self, *args, **kw):
            t0 = time.perf_counter()
            out = fn(self, *args, **kw)
            rec[name + "_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

        return wrapper

    def counted_predict_all(self, loader, **kw):
        before = read_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict_all(self, loader, **kw)
        wall = time.perf_counter() - t0
        after = read_counts(kernels)
        rec["predict_all"].append({
            "wall_s": wall, "rows": int(out.shape[0]), "members": self.k,
            "impl": self.impl,
            "launches": {n: after[n] - before[n] for n in after}})
        return out

    if spread or gates or nudge:
        engine.init_state = prepared_init
    engine.Trainer = FitTimer
    for name in saved:
        setattr(store_cls, name, timed(name))
    ens_cls.predict_all = counted_predict_all
    try:
        yield rec
    finally:
        engine.init_state, engine.Trainer = init, trainer
        for name, fn in saved.items():
            setattr(store_cls, name, fn)
        ens_cls.predict_all = predict_all


def log_fits(tag, fits, names):
    """Each member's fit wall time and median step after its first."""
    out = []
    for name, fit in zip(names, fits):
        steps = fit["step_ms"]
        median = statistics.median(steps[1:] if len(steps) > 1 else steps)
        out.append({"member": name, "fit_wall_s": fit["wall_s"],
                    "epochs": fit["epochs"], "epoch_s": fit["epoch_s"],
                    "steps": len(steps), "step_ms": steps,
                    "step_ms_median": median})
        log(f"[{tag}] {name}: fit wall {fit['wall_s']:.3f} s over "
            f"{fit['epochs']} epochs (their loops "
            + ", ".join(f"{x:.3f}" for x in fit["epoch_s"])
            + f" s), {len(steps)} steps, median step after the first "
            f"{median:.2f} ms, slowest {max(steps):.2f} ms")
    return out


def normalised_err(got, ref):
    import numpy as np

    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def phase_experiment(torch, report):
    """The k-fold experiment of mosei_trans at its reference width through
    `cli train` (pipelines.run_experiment) at impl="pallas_fused" and
    through run_experiment at "xla";
    the same store's members evaluated at both impls, through run_predict
    and served by `cli serve --checkpoint-dir`; run_kfold cut mid-member and
    resumed on the card."""
    import dataclasses
    import io
    import shutil

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import cli, configs, pipelines
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import (
        Ensemble, apply_thresholds)
    from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor
    from multimodal_emotion_processing_tpu_torch.train import engine
    from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore
    from multimodal_emotion_processing_tpu_torch.train.kfold import run_kfold

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    exp = configs.get("mosei_trans")
    m, tcfg = exp.model, exp.train
    if (tcfg.n_folds, tcfg.fold_size, tcfg.batch_size, tcfg.compute_dtype,
            tcfg.optimizer, m.dim, m.n_heads, m.n_layers, m.dropout) != (
            EXP_FOLDS, 4096, MT_BATCH, "float32", "adamw", 96, MT_HEADS, 1,
            0.0):
        raise AssertionError(f"unexpected config {exp}")
    root = STORES / "experiment"
    shutil.rmtree(root, ignore_errors=True)
    kernels = all_kernels()
    names = [f"mosei_trans_{i + 1}" for i in range(EXP_FOLDS)]
    out = {"config": exp.name, "folds": EXP_FOLDS, "n_train": EXP_N_TRAIN,
           "n_test": EXP_N_TEST, "epochs": EXP_EPOCHS}
    log(f"[experiment] {exp.name}: dim={m.dim} heads={m.n_heads} lens l/v/a="
        f"{m.l_len}/{m.v_len}/{m.a_len} f32 AdamW; {EXP_FOLDS} folds of "
        f"{EXP_N_TRAIN // EXP_FOLDS} from {EXP_N_TRAIN} synthetic pairs "
        f"(fold_size {tcfg.fold_size} x {EXP_FOLDS} > {EXP_N_TRAIN}: the "
        f"fractional carving), {EXP_EPOCHS} epochs, {EXP_N_TEST} test pairs; "
        "LN biases spread by 0.1 N(0, 1) at every member's init")
    try:
        runs = {}
        # the main path is `cli train`, which runs pipelines.run_experiment;
        # the reference run calls run_experiment itself
        train_out = io.StringIO()
        for impl in ("pallas_fused", "xla"):
            with experiment_hooks(torch, spread=True) as rec:
                reset_counts(kernels)
                t0 = time.perf_counter()
                if impl == "pallas_fused":
                    with contextlib.redirect_stdout(train_out):
                        res = cli.main([
                            "train", exp.name, "--impl", impl, "--epochs",
                            str(EXP_EPOCHS), "--n-train", str(EXP_N_TRAIN),
                            "--n-test", str(EXP_N_TEST), "--checkpoint-dir",
                            str(root / impl), "--quiet"])
                else:
                    res = pipelines.run_experiment(
                        exp.name, n_train=EXP_N_TRAIN, n_test=EXP_N_TEST,
                        epochs=EXP_EPOCHS, checkpoint_dir=str(root / impl),
                        impl=impl, quiet=True, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            runs[impl] = (res, rec, read_counts(kernels), wall)
        res, rec, launches, wall = runs["pallas_fused"]
        res_x, rec_x, launches_x, wall_x = runs["xla"]
        lines = [json.loads(x) for x in train_out.getvalue().splitlines()]
        log(f"[experiment] cli train printed {len(lines)} JSON lines: "
            f"{sum('epoch' in x for x in lines)} member epochs, then "
            f"{[k for x in lines if 'epoch' not in x for k in x]}")
        if (sum("epoch" in x for x in lines) != EXP_FOLDS * EXP_EPOCHS
                or lines[-1] != {"report": res.report}):
            raise AssertionError("cli train printed other lines than a "
                                 "member's epochs and the report")
        fits = log_fits("experiment", rec["fits"], names)
        fits_x = log_fits("experiment xla", rec_x["fits"], names)
        n_epochs = sum(f["epochs"] for f in rec["fits"])
        saves = {k: rec[k] for k in ("save_best_ms", "save_last_ms")}
        (pred,) = rec["predict_all"]
        outside = wall - sum(f["wall_s"] for f in rec["fits"]) - pred["wall_s"]
        log(f"[experiment] run_experiment wall {wall:.2f} s at pallas_fused "
            f"({wall / n_epochs:.3f} s per member-epoch; {outside:.2f} s of it "
            "outside the fits and the ensemble pass: the synthetic data, "
            f"loaders, restores and report), {wall_x:.2f} s at "
            f"xla; save_best {len(saves['save_best_ms'])} x median "
            f"{statistics.median(saves['save_best_ms']):.1f} ms, save_last "
            f"{len(saves['save_last_ms'])} x median "
            f"{statistics.median(saves['save_last_ms']):.1f} ms; the ensemble "
            f"pass {pred['wall_s'] * 1e3:.1f} ms for {pred['rows']} pairs x "
            f"{pred['members']} members")

        # launches: 18 blocks a forward; each member trains 6 steps and
        # validates 2 batches an epoch, the ensemble runs 4 members x 2
        # batches
        steps = EXP_EPOCHS * -(-(EXP_N_TRAIN - EXP_N_TRAIN // EXP_FOLDS)
                               // MT_BATCH)
        evals = EXP_EPOCHS * -(-(EXP_N_TRAIN // EXP_FOLDS) // MT_BATCH)
        ens_forwards = EXP_FOLDS * -(-EXP_N_TEST // MT_BATCH)
        expected = {k.name: 0 for k in kernels}
        expected.update(
            fused_block=18 * (EXP_FOLDS * (steps + evals) + ens_forwards),
            scored_bwd_dq=18 * EXP_FOLDS * steps,
            scored_bwd_dkv=18 * EXP_FOLDS * steps)
        ens_launches = pred["launches"]["fused_block"]
        log(f"[experiment] launches {launches}, expected {expected}; the "
            f"ensemble pass {ens_launches} fused_block = 18 x "
            f"{ens_forwards} member forwards; xla run {launches_x}")
        if launches != expected or ens_launches != 18 * ens_forwards:
            raise AssertionError(f"launches {launches} (ensemble "
                                 f"{ens_launches}), expected {expected}")
        if any(launches_x.values()):
            raise AssertionError(f"the xla run launched kernels: {launches_x}")

        # the two runs agree
        loss_rel = 0.0
        for hist, hist_x in zip(res.fold_histories, res_x.fold_histories):
            if len(hist) != len(hist_x) or len(hist) != EXP_EPOCHS:
                raise AssertionError("the runs trained different epochs")
            for h, hx in zip(hist, hist_x):
                for a, b in ((h.train_loss, hx.train_loss),
                             (h.valid_loss, hx.valid_loss)):
                    if not np.isfinite(a):
                        raise AssertionError(f"loss {a}")
                    loss_rel = max(loss_rel, abs(a - b) / max(abs(b), 1e-30))
        best = [res.store.manifest[n]["epoch"] for n in names]
        best_x = [res_x.store.manifest[n]["epoch"] for n in names]
        th, idx = exp.thresholds, exp.emotion_index
        dec = apply_thresholds(res.logits, th, idx)
        dec_x = apply_thresholds(res_x.logits, th, idx)
        cols = np.stack([res.logits[:, i] for i in idx], 1)
        cols_x = np.stack([res_x.logits[:, i] for i in idx], 1)
        near = np.minimum(np.abs(cols - np.asarray(th)),
                          np.abs(cols_x - np.asarray(th))) < EXP_MARGIN
        flips = int((dec != dec_x).sum())
        unexplained = int(((dec != dec_x) & ~near).sum())
        logit_err = normalised_err(res.logits, res_x.logits)
        log("[experiment] per-member epoch losses at pallas_fused: "
            + "; ".join(", ".join(f"{h.train_loss:.6f}/{h.valid_loss:.6f}"
                                  for h in hist) for hist in res.fold_histories)
            + f"; max relative difference to xla {loss_rel:.2e} (bound "
            f"{EXP_LOSS_TOL:g}); best epochs {best} (xla {best_x}); ensemble "
            f"logits of the two runs {logit_err:.2e} apart; {flips} of "
            f"{dec.size} decisions differ, {unexplained} of them with both "
            f"logits {EXP_MARGIN:g} or more from the threshold; micro F1 "
            f"{res.report['micro_f1']:.6f} (xla {res_x.report['micro_f1']:.6f})")
        if loss_rel > EXP_LOSS_TOL:
            raise AssertionError(f"losses disagree with xla: {loss_rel:.3e}")
        if best != best_x:
            raise AssertionError(f"best epochs {best} vs {best_x}")
        if unexplained or (not flips and res.report != res_x.report):
            raise AssertionError("the reports disagree")

        # what a save_last costs: the state's copy to the host, then the
        # file (a fresh member's state has the same tensors and bytes)
        state = engine.init_state(m, tcfg, seed=0, device="cuda")
        sd_ms, save_ms = [], []
        path = root / "probe.pt"
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sd = state.state_dict()
            t1 = time.perf_counter()
            CheckpointStore._save(str(path), sd)
            t2 = time.perf_counter()
            sd_ms.append((t1 - t0) * 1e3)
            save_ms.append((t2 - t1) * 1e3)
        n_tensors = len(sd["model"]) + 2 * len(sd["optimizer"]["mu"])
        nbytes = path.stat().st_size
        log(f"[experiment] a save_last's parts: state_dict() (the copies of "
            f"{n_tensors} tensors to the host) median "
            f"{statistics.median(sd_ms):.1f} ms, torch.save of {nbytes} bytes "
            f"and the rename median {statistics.median(save_ms):.1f} ms")
        del state

        # the same members, evaluated at both impls
        store = CheckpointStore(str(root / "pallas_fused"))
        members, _ = pipelines._restore_members(exp.name, exp, store, "cuda")
        test = synthetic_dataset(exp.name, m, EXP_N_TEST, seed=1)
        loader = Batcher(test, MT_BATCH, shuffle=False)
        ens = Ensemble(members, impl="pallas_fused")
        lf = ens.predict_all(loader)
        lx = Ensemble(members, impl="xla").predict_all(loader)
        eval_err = normalised_err(lf, lx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ens.predict_all(loader)
        torch.cuda.synchronize()
        pass_s = (time.perf_counter() - t0) / 3
        log(f"[experiment] restored members, pallas_fused vs xla: "
            f"{eval_err:.2e} (bound {EXP_LOGIT_TOL:g}); again bit-equal to "
            f"the run's eval logits: {np.array_equal(lf, res.logits)}; "
            f"predict_all {pass_s * 1e3:.2f} ms = "
            f"{EXP_N_TEST / pass_s:.1f} samples/s")
        try:
            profile = profile_breakdown(torch, lambda: ens.predict_all(loader))
            if "launches_per_call" in profile:
                profile["device_ops_per_batch"] = (
                    profile["launches_per_call"] / -(-EXP_N_TEST // MT_BATCH))
        except Exception:   # a measurement only: the checks stand
            traceback.print_exc()
            profile = "not measured: the profiler failed"
        if eval_err > EXP_LOGIT_TOL:
            raise AssertionError(f"eval logits disagree with xla: {eval_err:.3e}")
        if not np.array_equal(lf, res.logits):
            raise AssertionError("predict_all is not the run's eval logits")

        table = pipelines.run_predict(exp.name, checkpoint_dir=str(
            root / "pallas_fused"), n_test=EXP_N_TEST, impl="pallas_fused",
            quiet=True, device="cuda")
        predict_equal = bool(np.array_equal(table["logits"], res.logits))
        log(f"[experiment] run_predict from the store: {table['rows']} rows, "
            f"{table['members']} members, bit-equal to the eval logits: "
            f"{predict_equal}")
        if not predict_equal:
            raise AssertionError("run_predict differs from the eval logits")

        # cli serve from the store: one batch-1 request, then a burst
        streamed, predict = [], StreamingPredictor.predict

        def spy(self, sample):
            got = predict(self, sample)
            streamed.append(got[0])
            return got

        StreamingPredictor.predict = spy
        text = io.StringIO()
        try:
            reset_counts(kernels)
            with contextlib.redirect_stdout(text):
                cli.main(["serve", exp.name, "--checkpoint-dir",
                          str(root / "pallas_fused"), "--impl", "pallas_fused"])
                served = cli.main(["serve", exp.name, "--checkpoint-dir",
                                   str(root / "pallas_fused"), "--impl",
                                   "pallas_fused", "--concurrent",
                                   str(N_CONCURRENT)])
            serve_launches = read_counts(kernels)
        finally:
            StreamingPredictor.predict = predict
        one = synthetic_dataset(exp.name, m, 1, seed=7)[0]
        burst = synthetic_dataset(exp.name, m, N_CONCURRENT, seed=7)
        ref1 = ens.logits({k: v[None] for k, v in one.items()}).cpu().numpy()[0]
        refs = ens.logits({k: np.stack([s[k] for s in burst])
                           for k in burst[0]}).cpu().numpy()
        serve_err = max([normalised_err(s, ref1) for s in streamed]
                        + [normalised_err(lg, r)
                           for (lg, _), r in zip(served, refs)])
        log(f"[experiment] cli serve --checkpoint-dir: {len(streamed)} "
            f"batch-1 predicts and {len(served)} concurrent requests within "
            f"{serve_err:.2e} of Ensemble.logits (bound {EXP_LOGIT_TOL:g}); "
            f"launches {serve_launches}; its output: "
            + " | ".join(text.getvalue().splitlines()))
        if serve_err > EXP_LOGIT_TOL or len(served) != N_CONCURRENT:
            raise AssertionError(f"served logits {serve_err:.3e} off")
        del members, ens

        # resume on the card: 2 folds, unshuffled, cut in member 1's epoch 2;
        # the uninterrupted run saves synchronously, the cut and resumed runs
        # through the asynchronous store (--async-checkpoint)
        samples = synthetic_dataset(exp.name, m, EXP_RESUME_N, seed=3)
        rtcfg = dataclasses.replace(tcfg, n_folds=2)
        stores = {}

        def resume_run(sub, *, crash=None, resume=False, use_async=False):
            losses = {}

            def log_cb(name, epoch, stats):
                if (name, epoch) == crash:
                    raise Preempted(f"{name} epoch {epoch}")
                losses.setdefault(name, []).append(
                    (stats.train_loss, stats.valid_loss))

            def make_loaders(train, valid):
                return (Batcher(train, MT_BATCH, shuffle=False),
                        Batcher(valid, MT_BATCH, shuffle=False))

            stores[sub] = CheckpointStore(str(root / sub), use_async=use_async)
            results = run_kfold(
                samples, make_loaders, exp, rtcfg, store=stores[sub],
                name_prefix="m", epochs=EXP_RESUME_EPOCHS, impl="pallas_fused",
                log_cb=log_cb, resume=resume, device="cuda")
            stores[sub].wait()
            return results, losses

        with experiment_hooks(torch, spread=True) as srec:
            full, full_losses = resume_run("full")
        with experiment_hooks(torch, spread=True) as rrec:
            try:
                resume_run("cut", crash=("m_1", 2), use_async=True)
                raise AssertionError("the cut did not happen")
            except Preempted:
                # a process that exits joins the write in flight (the
                # interpreter joins the store's worker thread at exit)
                stores["cut"].wait()
            resumed, res_losses = resume_run("cut", resume=True,
                                             use_async=True)
        holds = {mode: {k: rec[k] for k in ("save_best_ms", "save_last_ms")}
                 for mode, rec in (("sync", srec), ("async", rrec))}
        log("[experiment] the time a save holds the fit (resume check, 2 "
            "members): "
            + "; ".join(f"{mode} save_best median "
                        f"{statistics.median(h['save_best_ms']):.1f} ms "
                        f"({len(h['save_best_ms'])}), save_last median "
                        f"{statistics.median(h['save_last_ms']):.1f} ms "
                        f"({len(h['save_last_ms'])})"
                        for mode, h in holds.items()))
        equal = all(torch.equal(a, b) for (s, _), (t, _) in zip(full, resumed)
                    for a, b in zip(s.model.state_dict().values(),
                                    t.model.state_dict().values()))
        log(f"[experiment] resume: member 1 ran epochs "
            f"{len(full_losses['m_1']) - len(res_losses['m_1'])}-"
            f"{EXP_RESUME_EPOCHS - 1} after the cut (asynchronous store), "
            f"member 2 "
            f"{len(res_losses['m_2'])} epochs; losses bit-equal "
            f"{res_losses['m_1'] == full_losses['m_1'][2:]} / "
            f"{res_losses['m_2'] == full_losses['m_2']}; final parameters "
            f"bit-equal {equal}; restore_last "
            + ", ".join(f"{x:.1f}" for x in rrec["restore_last_ms"]) + " ms")
        if not (len(res_losses["m_1"]) == 2 and len(res_losses["m_2"]) == 4
                and res_losses["m_1"] == full_losses["m_1"][2:]
                and res_losses["m_2"] == full_losses["m_2"] and equal):
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one")
        out.update(
            run_wall_s=wall, run_wall_s_xla=wall_x,
            s_per_member_epoch=wall / n_epochs, outside_fits_s=outside,
            fits=fits, fits_xla=fits_x,
            save_best_ms=saves["save_best_ms"],
            save_last_ms=saves["save_last_ms"],
            restore_last_ms=rrec["restore_last_ms"], save_holds_ms=holds,
            save_parts={"state_dict_ms": sd_ms, "file_ms": save_ms,
                        "tensors": n_tensors, "bytes": nbytes},
            launches=launches, expected_launches=expected,
            ensemble_pass=pred, max_loss_rel_err=loss_rel, best_epochs=best,
            best_epochs_xla=best_x, decision_flips=flips,
            run_logit_err=logit_err, report=res.report,
            report_xla=res_x.report, eval_err_vs_xla=eval_err,
            predict_all_ms=pass_s * 1e3,
            predict_all_samples_per_s=EXP_N_TEST / pass_s,
            predict_all_profile=profile, run_predict_bit_equal=predict_equal,
            serve_err=serve_err, serve_launches=serve_launches,
            resume_bit_equal=equal)
        report["experiment"] = out
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_experiment_families(torch, report):
    """The other families' experiment paths at their full widths: ren_mme
    (R-Drop, dropout 0.1, summed members, the joint threshold grid) at
    pallas_fused, mosei_realformer (its two best of 3 members at 0.6/0.4,
    the 400-point sweep, paragraph clips) at pallas, and 4 seeded
    mosei_trans_s1024 members through run_predict at flash in bf16; each
    held against xla on the same members."""
    import copy
    import shutil

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs, pipelines
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import (
        joint_threshold_grid, realformer_threshold_grid, ren_mme_joint_grids,
        threshold_sweep)
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = STORES / "families"
    shutil.rmtree(root, ignore_errors=True)
    kernels = all_kernels()
    total = {k.name: 0 for k in kernels}
    out = {}

    def run(name, impl, folds, n_train, n_test):
        exp = configs.with_overrides(configs.get(name),
                                     {"train": {"n_folds": folds}})
        with experiment_hooks(torch, spread=False) as rec:
            reset_counts(kernels)
            t0 = time.perf_counter()
            res = pipelines.run_experiment(
                name, n_train=n_train, n_test=n_test, epochs=FAM_EPOCHS,
                checkpoint_dir=str(root / name), impl=impl,
                sweep_thresholds=True, quiet=True, device="cuda",
                overrides={"train": {"n_folds": folds}})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        for k, v in launches.items():
            total[k] += v
        fits = log_fits(name, rec["fits"],
                        [f"{name}_{i + 1}" for i in range(folds)])
        (pred,) = rec["predict_all"]
        log(f"[{name}] run_experiment at {impl}: wall {wall:.2f} s, "
            f"{folds} folds of {n_train // folds}, {FAM_EPOCHS} epoch; "
            f"launches {launches}, of them in the ensemble pass "
            f"{pred['launches']}")
        store = CheckpointStore(str(root / name))
        members, losses = pipelines._restore_members(name, exp, store, "cuda")
        test = synthetic_dataset(name, exp.model, n_test, seed=1)
        loader = Batcher(test, exp.train.batch_size, shuffle=False)
        logits = {}
        for i in (impl, "xla"):
            ens = pipelines._make_ensemble(name, members, losses, impl=i,
                                           dtype=exp.train.compute_dtype)
            logits[i], labels = pipelines._collapse_test_outputs(
                ens.predict_all(loader), test)
        err = normalised_err(logits[impl], logits["xla"])
        entry = dict(impl=impl, folds=folds, n_train=n_train, n_test=n_test,
                     wall_s=wall, fits=fits, launches=launches,
                     ensemble_pass=pred, members=ens.k,
                     weights=ens.weights.tolist(), logit_err_vs_xla=err,
                     eval_bit_equal=bool(np.array_equal(logits[impl],
                                                        res.logits)))
        log(f"[{name}] restored members ({ens.k} in the ensemble, weights "
            f"{entry['weights']}): {impl} vs xla {err:.2e} (bound "
            f"{EXP_LOGIT_TOL:g}); bit-equal to the run's eval logits: "
            f"{entry['eval_bit_equal']}")
        if err > EXP_LOGIT_TOL or not entry["eval_bit_equal"]:
            raise AssertionError(f"{name}: eval logits disagree")
        return exp, res, members, losses, logits, labels, entry, launches

    try:
        # ren_mme: dropout trains through scored_fwd and the scored_bwd pair,
        # the eval passes and the summed ensemble through fused_block
        exp, res, _, _, logits, labels, entry, launches = run(
            "ren_mme", "pallas_fused", 2, FAM_REN_N_TRAIN, FAM_REN_N_TEST)
        pairs = exp.train.batch_size
        steps = FAM_EPOCHS * -(-(FAM_REN_N_TRAIN // 2) // pairs)
        evals = FAM_EPOCHS * -(-(FAM_REN_N_TRAIN // 2) // pairs)
        ens_fw = 2 * -(-FAM_REN_N_TEST // pairs)
        expected = {k.name: 0 for k in kernels}
        expected.update(scored_fwd=18 * 2 * steps, scored_bwd_dq=18 * 2 * steps,
                        scored_bwd_dkv=18 * 2 * steps,
                        fused_block=18 * (2 * evals + ens_fw))
        jx = joint_threshold_grid(logits["xla"], labels, ren_mme_joint_grids(),
                                  exp.emotion_index, exp.emotion_names)
        joint = res.sweep["joint"]
        same = joint["thresholds"] == jx["thresholds"]
        obj_gap = abs(joint["objective"] - jx["objective"])
        entry.update(expected_launches=expected, joint=joint, joint_xla=jx,
                     objective_gap=obj_gap)
        log(f"[ren_mme] expected launches {expected}; joint grid "
            f"{joint['thresholds']} (objective {joint['objective']:.6f}), on "
            f"the xla logits {'the same' if same else jx['thresholds']} "
            f"({jx['objective']:.6f})")
        if launches != expected:
            raise AssertionError(f"ren_mme launches {launches}, expected "
                                 f"{expected}")
        if not same and obj_gap > FAM_OBJECTIVE_TOL:
            raise AssertionError("ren_mme joint grids disagree")
        out["ren_mme"] = entry

        # mosei_realformer: 3 members, the two best at 0.6/0.4, 400-point sweep
        exp, res, members, losses, logits, labels, entry, launches = run(
            "mosei_realformer", "pallas", 3, FAM_RF_N_TRAIN, FAM_RF_N_TEST)
        steps = FAM_EPOCHS * -(-(FAM_RF_N_TRAIN * 2 // 3) // RF_BATCH)
        evals = FAM_EPOCHS * -(-(FAM_RF_N_TRAIN // 3) // RF_BATCH)
        ens_fw = 2 * -(-FAM_RF_N_TEST // RF_BATCH)
        expected = {k.name: 0 for k in kernels}
        expected.update(scored_fwd=18 * (3 * (steps + evals) + ens_fw),
                        scored_bwd_dq=18 * 3 * steps,
                        scored_bwd_dkv=18 * 3 * steps)
        sx = threshold_sweep(logits["xla"], labels, realformer_threshold_grid(),
                             exp.emotion_index, exp.emotion_names)
        gaps = {e: (res.sweep[e]["t"] == sx[e]["t"],
                    abs(res.sweep[e]["f1"] - sx[e]["f1"]))
                for e in exp.emotion_names}
        if entry["members"] != 2 or not np.allclose(entry["weights"],
                                                     [0.6, 0.4]):
            raise AssertionError(f"realformer ensemble {entry['members']} "
                                 f"members at {entry['weights']}")
        # the trained gates sit near their initial 0: copies with the gates
        # set, written with save_params, held at pallas against xla
        copies = [copy.deepcopy(mm) for mm in members]
        set_gates(torch, copies)
        gstore = CheckpointStore(str(root / "realformer_gates"))
        names = [f"{exp.name}_{i + 1}" for i in range(3)]
        for name, mm, loss in zip(names, copies, losses):
            gstore.save_params(name, mm, valid_loss=loss, imported=False)
        gated = {i: pipelines.run_predict(
            exp.name, checkpoint_dir=str(root / "realformer_gates"),
            n_test=FAM_RF_N_TEST, impl=i, quiet=True, device="cuda")["logits"]
            for i in ("pallas", "xla")}
        gate_err = normalised_err(gated["pallas"], gated["xla"])
        gate_effect = normalised_err(gated["xla"], logits["xla"])
        entry.update(expected_launches=expected, sweep=res.sweep,
                     sweep_xla=sx, gated_err_vs_xla=gate_err,
                     gate_effect=gate_effect, members_written=names)
        log(f"[mosei_realformer] expected launches {expected}; sweep "
            f"thresholds {[res.sweep[e]['t'] for e in exp.emotion_names]}, on "
            f"the xla logits {[sx[e]['t'] for e in exp.emotion_names]}; "
            f"gate-perturbed copies through run_predict: pallas vs xla "
            f"{gate_err:.2e} (bound {EXP_LOGIT_TOL:g}); the gates move the "
            f"logits by {gate_effect:.2e}")
        if launches != expected:
            raise AssertionError(f"realformer launches {launches}, expected "
                                 f"{expected}")
        if any(not eq and gap > FAM_OBJECTIVE_TOL for eq, gap in gaps.values()):
            raise AssertionError(f"realformer sweeps disagree: {gaps}")
        if gate_err > EXP_LOGIT_TOL or gate_effect <= 100 * EXP_LOGIT_TOL:
            raise AssertionError("gate-perturbed realformer check failed")
        out["mosei_realformer"] = entry
        del members, copies

        # mosei_trans_s1024: 4 seeded members, run_predict at flash in bf16
        exp = configs.get("mosei_trans_s1024")
        sstore = CheckpointStore(str(root / "s1024"))
        for i in range(N_MEMBERS):
            sstore.save_params(f"{exp.name}_{i + 1}",
                               build_model(exp, device="cuda", seed=i),
                               imported=False)
        tables = {}
        for impl in ("flash", "xla"):
            reset_counts(kernels)
            t0 = time.perf_counter()
            tables[impl] = pipelines.run_predict(
                exp.name, checkpoint_dir=str(root / "s1024"),
                n_test=FAM_S1024_N_TEST, impl=impl, quiet=True, device="cuda")
            torch.cuda.synchronize()
            if impl == "flash":
                wall = time.perf_counter() - t0
                launches = read_counts(kernels)
        for k, v in launches.items():
            total[k] += v
        expected = {k.name: 0 for k in kernels}
        expected["flash_fwd"] = 18 * N_MEMBERS * -(-FAM_S1024_N_TEST
                                                   // exp.train.batch_size)
        err = normalised_err(tables["flash"]["logits"],
                             tables["xla"]["logits"])
        out["mosei_trans_s1024"] = dict(
            impl="flash", dtype=exp.train.compute_dtype, n_test=FAM_S1024_N_TEST,
            members=tables["flash"]["members"], wall_s=wall, launches=launches,
            expected_launches=expected, logit_err_vs_xla=err)
        log(f"[mosei_trans_s1024] run_predict at flash, bf16, "
            f"{tables['flash']['members']} members, {FAM_S1024_N_TEST} samples: "
            f"{wall:.2f} s; launches {launches} (expected {expected}); vs xla "
            f"{err:.2e} (bound {BF16_TOL:g})")
        if launches != expected or err > BF16_TOL:
            raise AssertionError("mosei_trans_s1024 run_predict check failed")
        out["launches"] = total
        report["experiment_families"] = out
        return total
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_ren_mme_tree(root, m, rng):
    """Ren-MME's layout (Ren-MME/run.py:18-23,42-148): data/zero_one_adjust
    .csv, text_feat / video_feat .npy of (T, dim) and audio_feat .npy stored
    transposed (dim, T); episodes 1-10, 4 dialogues of 4 sentences, each
    length drawn from 2 to twice the model's; video REAL_MISSING_VIDEO has
    no file.  Returns the utterance names."""
    import numpy as np

    emotions = ("Love", "Anxiety", "Sorrow", "Joy", "Expect", "Hate", "Anger",
                "Surprise", "Neutral")
    for d in ("data", "text_feat", "video_feat", "audio_feat"):
        (root / d).mkdir(parents=True, exist_ok=True)
    names, rows = [], []
    for ep in range(1, 11):
        for dlg in range(1, 5):
            for sent in range(1, 5):
                name = f"{ep}_{dlg}_{sent}"
                names.append(name)
                lab = (rng.random(9) > 0.7).astype(int)
                rows.append(f"{ep},{dlg},{sent}," + ",".join(map(str, lab)))
    (root / "data" / "zero_one_adjust.csv").write_text(
        "Episode,Dialogue,Sentence," + ",".join(emotions) + "\n"
        + "\n".join(rows) + "\n")

    def feats(length, dim):
        t = int(rng.integers(2, 2 * length + 1))
        return rng.standard_normal((t, dim)).astype(np.float32)

    for name in names:
        np.save(root / "text_feat" / f"{name}.npy", feats(m.l_len, m.l_dim))
        if name != REAL_MISSING_VIDEO:
            np.save(root / "video_feat" / f"{name}.npy",
                    feats(m.v_len, m.v_dim))
        np.save(root / "audio_feat" / f"{name}.npy",
                feats(m.a_len, m.a_dim).T)
    return names


def write_ren_tree(root, rng, tok_dim):
    """The Ren-CECps layout (rencecps/run.py:30-127) that rencecps and the
    robot demo read: cet_1..cet_1487 .txt / .xml and one .npy of BERT
    tokens per kept sentence.  Every 50th document has three sentences, the
    second an empty-text line the loaders skip; every 7th sentence is all
    zero (the neutral label); every 97th document's text is not Chinese
    (robot_demo.py:157-162 leaves it out, rencecps keeps it)."""
    import numpy as np

    txt_dir = root / "1487_txt_hier_sents_202002"
    xml_dir = root / "1487_xml_doc_segmented_utf8"
    feat_dir = root / "ren_text_feat"
    for d in (txt_dir, xml_dir, feat_dir):
        d.mkdir(parents=True, exist_ok=True)
    count = 0
    for doc in range(1, 1488):
        plan = ([("1", "1", True), ("1", "2", False), ("2", "1", True)]
                if doc % 50 == 0 else [("1", "1", True)])
        txt, xml = [], []
        for para, sent, keep in plan:
            count += 1
            if not keep:
                txt.append("s:0.0,0.0,0.0,0.0,0.0,0.0,0.0,0.0:/n\n")
            else:
                intens = ["0.0"] * 8
                if count % 7:
                    intens[int(rng.integers(0, 8))] = "0.6"
                text = ("hello/n  world/n" if doc % 97 == 0
                        else "今天/t  天气/n  很好/a")
                txt.append("s:" + ",".join(intens) + f":{text}\n")
                n = int(rng.integers(3, REAL_REN_TOKENS + 1))
                np.save(feat_dir / f"{doc}_{para}_{sent}.npy",
                        rng.standard_normal((n, tok_dim)).astype(np.float32))
            xml.append(f"<S_no>第{para}段第{sent}句</S_no>\n")
        (txt_dir / f"cet_{doc}.txt").write_text("".join(txt))
        (xml_dir / f"cet_{doc}.xml").write_text("".join(xml))


def write_robot_tree(root, m, rng):
    """The robot demo's layout (robot_demo.py:21-29,45-112) beside the Ren
    tree: Feature(0)-360/<clip>.pk (a pickled list of per-frame vectors of
    mixed resolutions: the majority rotates over 256/512/1024, every other
    clip adds minority frames, every 16th ties 512 with 1024, the last is
    empty), WAV_feature/<clip>.npy of (T, 40) and a MOSEI labels.txt."""
    import pickle

    import numpy as np

    video_dir, wav_dir = root / "Feature(0)-360", root / "WAV_feature"
    video_dir.mkdir(parents=True, exist_ok=True)
    wav_dir.mkdir(parents=True, exist_ok=True)
    dims = m.v_dims_multires
    lines = ["name, start_time, end_time, happy, sad, angry, disgust, "
             "surprise, fear, neutral \n"]
    for i in range(REAL_ROBOT_CLIPS):
        name = f"clip{i}[0]"
        lab = (rng.random(7) > 0.6).astype(int)
        lines.append(f"{name},{i}.0,{i + 5}.0," + ",".join(map(str, lab)) + "\n")
        n = int(rng.integers(3, 2 * m.v_len))
        frames = [rng.standard_normal(dims[i % 3]).astype(np.float32)
                  for _ in range(n)]
        if i % 16 == 5:
            frames = [rng.standard_normal(d).astype(np.float32)
                      for d in (dims[1], dims[2]) for _ in range(n)]
        elif i % 2 == 0:
            frames += [rng.standard_normal(dims[(i + 1) % 3]).astype(np.float32)
                       for _ in range(n // 3)]
        if i == REAL_ROBOT_CLIPS - 1:
            frames = []
        with open(video_dir / f"{name}.pk", "wb") as f:
            pickle.dump(frames, f)
        t = int(rng.integers(2, 2 * m.a_len + 1))
        np.save(wav_dir / f"{name}.npy",
                rng.standard_normal((t, m.a_dim)).astype(np.float32))
    (root / "labels.txt").write_text("".join(lines))


def write_mosei_tree(root, m, rng, h5py):
    """CMU-MOSEI's layout (cmu-mosei/run.py:21-25,45-61): labels.txt, the
    glove / FACET / COVAREP computational sequences (.csd, HDF5, mmsdk's
    <sequence>/data/<sentence>/features layout) and standard_test_fold.txt;
    12 videos of 2-6 sentences, 3 of them the test fold, lengths drawn up
    to the model's plus 6 (so both the pad and the two-crop paths run)."""
    import numpy as np

    root.mkdir(parents=True, exist_ok=True)
    videos = [f"v{i}" for i in range(12)]
    sentences = [f"{v}[{j}]" for v in videos
                 for j in range(int(rng.integers(2, 7)))]
    lines = ["name, start_time, end_time, happy, sad, angry, disgust, "
             "surprise, fear, neutral \n"]
    for name in sentences:
        start = float(rng.random() * 100)
        lab = (rng.random(7) > 0.6).astype(int)
        lines.append(f"{name},{start:.3f},{start + 5:.3f},"
                     + ",".join(map(str, lab)) + "\n")
    (root / "labels.txt").write_text("".join(lines))
    (root / "standard_test_fold.txt").write_text("\n".join(videos[-3:]) + "\n")
    for fname, dim, length in (("glove_vectors", m.l_dim, m.l_len),
                               ("FACET 4.2", m.v_dim, m.v_len),
                               ("COAVAREP", m.a_dim, m.a_len)):
        with h5py.File(root / f"{fname}.csd", "w") as h:
            grp = h.create_group(f"{fname}/data")
            for name in sentences:
                n = int(rng.integers(1, length + 7))
                grp.create_group(name).create_dataset(
                    "features",
                    data=rng.standard_normal((n, dim)).astype(np.float32))


def tree_bytes(root) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def phase_real_data(torch, report):
    """Real corpus trees on disk at the reference widths, read by the port's
    corpus readers and trained on the card: ren_mme (R-Drop, dropout 0.1,
    the joint grid) through `cli train --data-root` at impl="pallas_fused",
    robot_demo (dropout 0.1, gates set, 2 epochs of resampled texts) at
    impl="pallas", rencecps at impl="xla", each against run_experiment(
    data_root=...) at "xla" from the same start (rencecps: on the CPU); then
    check-data on every tree and on one with a file removed, and `cli
    predict --split all --data-root` from ren_mme's store.  MOSEI's `.csd`
    path (mosei_trans at "pallas_fused" against "xla", held as ren_mme is)
    runs only where h5py imports."""
    import io
    import shutil

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import cli, configs, pipelines
    from multimodal_emotion_processing_tpu_torch.data import robot
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import apply_thresholds
    from multimodal_emotion_processing_tpu_torch.train import engine
    from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    stores = STORES / "real_data"
    for d in (REAL_ROOT, stores):
        shutil.rmtree(d, ignore_errors=True)
    kernels = all_kernels()
    total = {k.name: 0 for k in kernels}
    out = {"card": smi}
    loads, resamples = [], []
    load_real_data = pipelines.load_real_data
    epoch_materialize = robot.RobotAssembler.epoch_materialize

    def timed_load(exp, data_root):
        t0 = time.perf_counter()
        got = load_real_data(exp, data_root)
        wall = time.perf_counter() - t0
        n = sum(len(u) if isinstance(u, list) else 1
                for part in got[:2] for u in part)
        loads.append({"family": configs.family(exp.name), "wall_s": wall,
                      "samples": n, "samples_per_s": n / wall})
        return got

    def timed_resample(self, names, base_table, epoch, seed=0):
        t0 = time.perf_counter()
        got = epoch_materialize(self, names, base_table, epoch, seed=seed)
        resamples.append({"epoch": epoch, "seed": seed, "clips": len(got),
                          "wall_s": time.perf_counter() - t0})
        return got

    def train(name, impl, root, *, via_cli, device="cuda", spread=False,
              gates=False):
        """One k-fold run on the tree: through `cli train` (the main path)
        or run_experiment; its launches, wall and records."""
        store = stores / f"{name}_{impl}_{device}"
        sweep = name == "ren_mme"
        epochs = REAL_EPOCHS[name]
        del loads[:]
        del resamples[:]
        with experiment_hooks(torch, spread=spread, gates=gates) as rec:
            reset_counts(kernels)
            t0 = time.perf_counter()
            if via_cli:
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    res = cli.main(
                        ["train", name, "--data-root", str(root), "--impl",
                         impl, "--epochs", str(epochs), "--checkpoint-dir",
                         str(store), "--quiet", "--set",
                         f"train.n_folds={REAL_FOLDS}"]
                        + (["--sweep-thresholds"] if sweep else []))
                lines = [json.loads(x) for x in text.getvalue().splitlines()]
                if sum("epoch" in x for x in lines) != REAL_FOLDS * epochs:
                    raise AssertionError(f"{name}: cli train printed "
                                         f"{len(lines)} lines")
            else:
                res = pipelines.run_experiment(
                    name, synthetic_data=False, data_root=str(root),
                    epochs=epochs, checkpoint_dir=str(store), impl=impl,
                    sweep_thresholds=sweep, quiet=True, device=device,
                    overrides={"train": {"n_folds": REAL_FOLDS}})
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        return dict(res=res, launches=launches, wall=wall, rec=rec,
                    loads=list(loads), resamples=list(resamples), store=store)

    def hold(name, run, ref, *, decisions):
        """Epoch losses within EXP_LOSS_TOL and the same best epochs; with
        `decisions`, the ensemble's decisions at the kernel run's
        thresholds equal wherever a logit lies EXP_MARGIN or more from
        them.  Returns the readings."""
        res, res_x = run["res"], ref["res"]
        loss_rel = 0.0
        for hist, hist_x in zip(res.fold_histories, res_x.fold_histories):
            if len(hist) != len(hist_x) or len(hist) != REAL_EPOCHS[name]:
                raise AssertionError(f"{name}: the runs trained other epochs")
            for h, hx in zip(hist, hist_x):
                if h.steps != hx.steps or h.samples != hx.samples:
                    raise AssertionError(f"{name}: other steps or samples")
                for a, b in ((h.train_loss, hx.train_loss),
                             (h.valid_loss, hx.valid_loss)):
                    if not np.isfinite(a):
                        raise AssertionError(f"{name}: loss {a}")
                    loss_rel = max(loss_rel, abs(a - b) / max(abs(b), 1e-30))
        members = [f"{name}_{i + 1}" for i in range(REAL_FOLDS)]
        best = [res.store.manifest[n]["epoch"] for n in members]
        best_x = [res_x.store.manifest[n]["epoch"] for n in members]
        got = {"max_loss_rel_err": loss_rel, "best_epochs": best,
               "best_epochs_ref": best_x,
               "epoch_losses": [[(h.train_loss, h.valid_loss) for h in hist]
                                for hist in res.fold_histories]}
        msg = (f"[real_data] {name}: epoch losses (train/valid) "
               + "; ".join(", ".join(f"{a:.6f}/{b:.6f}" for a, b in member)
                           for member in got["epoch_losses"])
               + f"; max relative difference to the reference {loss_rel:.2e}"
               f" (bound {EXP_LOSS_TOL:g}); best epochs {best} (reference "
               f"{best_x})")
        if decisions:
            exp = configs.get(name)
            th = (list(exp.thresholds) if res.sweep is None else
                  [res.sweep["joint"]["thresholds"][e]
                   for e in exp.emotion_names])
            idx = exp.emotion_index
            dec = apply_thresholds(res.logits, th, idx)
            dec_x = apply_thresholds(res_x.logits, th, idx)
            cols = np.stack([res.logits[:, i] for i in idx], 1)
            cols_x = np.stack([res_x.logits[:, i] for i in idx], 1)
            near = np.minimum(np.abs(cols - np.asarray(th)),
                              np.abs(cols_x - np.asarray(th))) < EXP_MARGIN
            flips = int((dec != dec_x).sum())
            unexplained = int(((dec != dec_x) & ~near).sum())
            got.update(decision_flips=flips, unexplained_flips=unexplained,
                       run_logit_err=normalised_err(res.logits, res_x.logits),
                       micro_f1=res.report["micro_f1"],
                       micro_f1_ref=res_x.report["micro_f1"])
            msg += (f"; the two runs' ensemble logits "
                    f"{got['run_logit_err']:.2e} apart, {flips} of {dec.size}"
                    f" decisions differ, {unexplained} of them with both "
                    f"logits {EXP_MARGIN:g} or more from the threshold; micro"
                    f" F1 {got['micro_f1']:.6f} (reference "
                    f"{got['micro_f1_ref']:.6f})")
            if unexplained:
                raise AssertionError(f"{name}: decisions disagree")
        log(msg + f"; {smi}")
        if loss_rel > EXP_LOSS_TOL:
            raise AssertionError(f"{name}: losses {loss_rel:.3e} apart")
        if best != best_x:
            raise AssertionError(f"{name}: best epochs {best} vs {best_x}")
        return got

    def member_epoch_s(rec):
        fits = rec["fits"]
        return (sum(f["wall_s"] for f in fits)
                / max(1, sum(f["epochs"] for f in fits)))

    def log_run(name, run, impl):
        (load,) = run["loads"]
        log(f"[real_data] {name} at {impl} through cli train --data-root: "
            f"load_real_data {load['wall_s']:.3f} s for {load['samples']} "
            f"samples ({load['samples_per_s']:.0f} samples/s); run wall "
            f"{run['wall']:.2f} s, {member_epoch_s(run['rec']):.3f} s per "
            f"member-epoch; launches {run['launches']}; {smi}")

    def check_data(name, root):
        text = io.StringIO()
        code = 0
        with contextlib.redirect_stdout(text):
            try:
                cli.main(["check-data", name, "--data-root", str(root)])
            except SystemExit as e:
                code = e.code
        return code, json.loads(text.getvalue())

    pipelines.load_real_data = timed_load
    robot.RobotAssembler.epoch_materialize = timed_resample
    try:
        t0 = time.perf_counter()
        trees = {"ren_mme": REAL_ROOT / "ren_mme", "ren": REAL_ROOT / "ren"}
        rng = np.random.default_rng(REAL_SEED)
        write_ren_mme_tree(trees["ren_mme"], configs.get("ren_mme").model, rng)
        write_ren_tree(trees["ren"], rng, configs.get("robot_demo").model.l_dim)
        write_robot_tree(trees["ren"], configs.get("robot_demo").model, rng)
        sizes = {k: tree_bytes(v) for k, v in trees.items()}
        out["trees"] = {"bytes": sizes, "write_s": time.perf_counter() - t0}
        log(f"[real_data] trees written in {out['trees']['write_s']:.1f} s: "
            f"Ren-MME {sizes['ren_mme'] / 1e6:.1f} MB (160 utterances, video "
            f"{REAL_MISSING_VIDEO} missing), the shared Ren-CECps + robot tree "
            f"{sizes['ren'] / 1e6:.1f} MB (cet_1..cet_1487, "
            f"{REAL_ROBOT_CLIPS} clips)")
        try:
            import h5py
        except ImportError as e:
            h5py = None
            out["mosei"] = f"not run: h5py does not import ({e})"
            log("[real_data] the MOSEI .csd path was not run on the card: "
                f"h5py does not import here ({e}); mosei_trans' kernels run "
                "on synthetic samples in phase experiment, and its .csd "
                "readers are held against the JAX package's on the CPU "
                "(tests/test_torch_real_data.py)")

        # ren_mme: dropout trains through scored_fwd and the scored_bwd pair,
        # the eval passes and the summed ensemble through fused_block
        run = train("ren_mme", "pallas_fused", trees["ren_mme"], via_cli=True,
                    spread=True)
        ref = train("ren_mme", "xla", trees["ren_mme"], via_cli=False,
                    spread=True)
        exp = configs.get("ren_mme")
        pairs = exp.train.batch_size
        steps = -(-64 // pairs)
        expected = {k.name: 0 for k in kernels}
        expected.update(scored_fwd=18 * REAL_FOLDS * steps,
                        scored_bwd_dq=18 * REAL_FOLDS * steps,
                        scored_bwd_dkv=18 * REAL_FOLDS * steps,
                        fused_block=18 * (REAL_FOLDS * steps
                                          + REAL_FOLDS * -(-32 // pairs)))
        log_run("ren_mme", run, "pallas_fused")
        if run["launches"] != expected or any(ref["launches"].values()):
            raise AssertionError(f"ren_mme launches {run['launches']} "
                                 f"(expected {expected}), xla "
                                 f"{ref['launches']}")
        entry = hold("ren_mme", run, ref, decisions=True)
        joint, jx = run["res"].sweep["joint"], ref["res"].sweep["joint"]
        same = joint["thresholds"] == jx["thresholds"]
        if not same and abs(joint["objective"] - jx["objective"]) \
                > FAM_OBJECTIVE_TOL:
            raise AssertionError("ren_mme joint grids disagree")
        # the store's members at both impls on the tree's test split
        store = CheckpointStore(str(run["store"]))
        members, losses = pipelines._restore_members("ren_mme", exp, store,
                                                     "cuda")
        test = load_real_data(exp, str(trees["ren_mme"]))[1]
        loader = Batcher(test, pairs, shuffle=False)
        logits = {i: pipelines._make_ensemble(
                      "ren_mme", members, losses, impl=i).predict_all(loader)
                  for i in ("pallas_fused", "xla")}
        eval_err = normalised_err(logits["pallas_fused"], logits["xla"])
        eval_equal = bool(np.array_equal(logits["pallas_fused"],
                                         run["res"].logits))
        del members
        # predict --split all: the train rows, then the 32 test rows
        reset_counts(kernels)
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            table = cli.main(["predict", "ren_mme", "--split", "all",
                              "--data-root", str(trees["ren_mme"]),
                              "--checkpoint-dir", str(run["store"]), "-o",
                              str(stores / "ren_mme_all.npz"), "--impl",
                              "pallas_fused", "--quiet"])
        predict_launches = read_counts(kernels)
        n_test = run["res"].logits.shape[0]
        predict_equal = bool(np.array_equal(table["logits"][-n_test:],
                                            run["res"].logits))
        want_predict = {k.name: 0 for k in kernels}
        want_predict["fused_block"] = 18 * REAL_FOLDS * -(-160 // pairs)
        entry.update(launches=run["launches"], expected_launches=expected,
                     wall_s=run["wall"], wall_s_ref=ref["wall"],
                     load_real_data=run["loads"], fits=run["rec"]["fits"],
                     s_per_member_epoch=member_epoch_s(run["rec"]),
                     joint=joint, joint_ref=jx, eval_err_vs_xla=eval_err,
                     eval_bit_equal=eval_equal, predict_rows=table["rows"],
                     predict_launches=predict_launches,
                     predict_bit_equal=predict_equal)
        syn = report.get("experiment_families", {}).get("ren_mme")
        syn_s = (sum(f["fit_wall_s"] for f in syn["fits"])
                 / sum(f["epochs"] for f in syn["fits"]) if syn else None)
        entry["synthetic_s_per_member_epoch"] = syn_s
        log(f"[real_data] ren_mme: joint grid {joint['thresholds']} (the "
            f"reference's {'the same' if same else jx['thresholds']}); "
            f"restored members pallas_fused vs xla {eval_err:.2e} (bound "
            f"{EXP_LOGIT_TOL:g}), bit-equal to the run's eval logits "
            f"{eval_equal}; cli predict --split all: {table['rows']} rows, "
            f"the last {n_test} bit-equal to the eval logits {predict_equal},"
            f" launches {predict_launches}; "
            f"{entry['s_per_member_epoch']:.3f} s per member-epoch on the tree"
            f" against " + (f"{syn_s:.3f} s" if syn_s is not None
                            else "not measured (phase experiment_families "
                                 "did not run)")
            + f" on synthetic samples at the same fold sizes "
            f"(experiment_families); {smi}")
        if eval_err > EXP_LOGIT_TOL or not eval_equal:
            raise AssertionError("ren_mme: restored members disagree")
        if not predict_equal or table["rows"] != 160 \
                or predict_launches != want_predict:
            raise AssertionError(f"ren_mme predict: {table['rows']} rows, "
                                 f"launches {predict_launches}")
        for k in total:
            total[k] += run["launches"][k] + predict_launches[k]
        out["ren_mme"] = entry

        # robot_demo: the scored kernels, texts substituted anew each epoch
        run = train("robot_demo", "pallas", trees["ren"], via_cli=True,
                    gates=True)
        ref = train("robot_demo", "xla", trees["ren"], via_cli=False,
                    gates=True)
        log_run("robot_demo", run, "pallas")
        epochs = REAL_EPOCHS["robot_demo"]
        expected = {k.name: 0 for k in kernels}
        expected.update(scored_fwd=18 * REAL_FOLDS * epochs * 2,
                        scored_bwd_dq=18 * REAL_FOLDS * epochs,
                        scored_bwd_dkv=18 * REAL_FOLDS * epochs)
        if run["launches"] != expected or any(ref["launches"].values()):
            raise AssertionError(f"robot_demo launches {run['launches']} "
                                 f"(expected {expected}), xla "
                                 f"{ref['launches']}")
        entry = hold("robot_demo", run, ref, decisions=False)
        rs = run["resamples"]
        log(f"[real_data] robot_demo: resample walls (text .npy re-read each"
            f" epoch; video and audio cached) "
            + ", ".join(f"epoch {r['epoch']} seed {r['seed']} {r['clips']} "
                        f"clips {r['wall_s'] * 1e3:.1f} ms" for r in rs)
            + f"; {smi}")
        if sorted((r["seed"], r["epoch"]) for r in rs) != sorted(
                (1000 * configs.get("robot_demo").train.seed + f, e)
                for f in range(REAL_FOLDS) for e in range(epochs)):
            raise AssertionError(f"robot_demo resamples {rs}")
        # the synthetic figure at the same fold sizes and checkpoints, for
        # the wall beside it
        with experiment_hooks(torch, spread=False, gates=True) as srec:
            pipelines.run_experiment(
                "robot_demo", n_train=REAL_ROBOT_CLIPS, n_test=0,
                epochs=epochs, impl="pallas", quiet=True, device="cuda",
                checkpoint_dir=str(stores / "robot_demo_synthetic"),
                overrides={"train": {"n_folds": REAL_FOLDS}})
            torch.cuda.synchronize()
        entry.update(launches=run["launches"], expected_launches=expected,
                     wall_s=run["wall"], wall_s_ref=ref["wall"],
                     load_real_data=run["loads"], resamples=rs,
                     fits=run["rec"]["fits"],
                     s_per_member_epoch=member_epoch_s(run["rec"]),
                     synthetic_s_per_member_epoch=member_epoch_s(srec))
        log(f"[real_data] robot_demo: {entry['s_per_member_epoch']:.3f} s per"
            f" member-epoch on the tree against "
            f"{entry['synthetic_s_per_member_epoch']:.3f} s on synthetic "
            f"samples at the same fold sizes; {smi}")
        for k in total:
            total[k] += run["launches"][k]
        out["robot_demo"] = entry

        # rencecps: no kernel; the card's run against the CPU's
        init = engine.init_state

        def card_start(cfg, tcfg, seed, *, device=None):
            state = init(cfg, tcfg, seed, device=device)
            if str(device) == "cpu":
                card = init(cfg, tcfg, seed, device="cuda")
                state.model.load_state_dict(
                    {k: v.cpu() for k, v in card.model.state_dict().items()})
            return state

        run = train("rencecps", "xla", trees["ren"], via_cli=True)
        engine.init_state = card_start
        try:
            ref = train("rencecps", "xla", trees["ren"], via_cli=False,
                        device="cpu")
        finally:
            engine.init_state = init
        log_run("rencecps", run, "xla")
        if any(run["launches"].values()):
            raise AssertionError(f"rencecps launched {run['launches']}")
        entry = hold("rencecps", run, ref, decisions=True)
        entry.update(wall_s=run["wall"], wall_s_cpu=ref["wall"],
                     load_real_data=run["loads"],
                     s_per_member_epoch=member_epoch_s(run["rec"]))
        out["rencecps"] = entry

        # check-data: every tree, then Ren-MME without its label table and
        # the robot tree without its labels
        checks = {}
        for name, root in (("ren_mme", trees["ren_mme"]),
                           ("rencecps", trees["ren"]),
                           ("robot_demo", trees["ren"])):
            code, rep = check_data(name, root)
            checks[name] = {"exit": code, "ok": rep["ok"]}
            if code != 0 or not rep["ok"]:
                raise AssertionError(f"check-data {name}: {rep['problems']}")
        for name, path in (
                ("ren_mme", trees["ren_mme"] / "data" / "zero_one_adjust.csv"),
                ("robot_demo", trees["ren"] / "labels.txt")):
            aside = path.with_name(path.name + ".aside")
            path.rename(aside)
            try:
                code, rep = check_data(name, path.parents[1] if name ==
                                       "ren_mme" else path.parent)
            finally:
                aside.rename(path)
            named = any(path.name in p for p in rep["problems"])
            checks[f"{name} without {path.name}"] = {
                "exit": code, "problems": rep["problems"]}
            if code != 1 or not named:
                raise AssertionError(f"check-data {name} without "
                                     f"{path.name}: exit {code}, "
                                     f"{rep['problems']}")
        out["check_data"] = checks
        log(f"[real_data] check-data: {checks}")

        if h5py is not None:
            root = REAL_ROOT / "mosei"
            write_mosei_tree(root, configs.get("mosei_trans").model, rng, h5py)
            code, rep = check_data("mosei_trans", root)
            if code != 0 or not rep["ok"]:
                raise AssertionError(f"check-data mosei_trans: "
                                     f"{rep['problems']}")
            run = train("mosei_trans", "pallas_fused", root, via_cli=True,
                        spread=True)
            ref = train("mosei_trans", "xla", root, via_cli=False,
                        spread=True)
            log_run("mosei_trans", run, "pallas_fused")
            if not run["launches"]["fused_block"] \
                    or any(ref["launches"].values()):
                raise AssertionError(f"mosei_trans launches "
                                     f"{run['launches']}, xla "
                                     f"{ref['launches']}")
            entry = hold("mosei_trans", run, ref, decisions=True)
            entry.update(launches=run["launches"], wall_s=run["wall"],
                         wall_s_ref=ref["wall"], load_real_data=run["loads"])
            for k in total:
                total[k] += run["launches"][k]
            out["mosei"] = entry

        out["launches"] = total
        log(f"[real_data] launches on the trees' main paths {total}; {smi}")
        report["real_data"] = out
        return total
    finally:
        pipelines.load_real_data = load_real_data
        robot.RobotAssembler.epoch_materialize = epoch_materialize
        for d in (REAL_ROOT, stores):
            shutil.rmtree(d, ignore_errors=True)


def trace_call(torch, fn, reps: int = 3, traced=None):
    """One call of fn under torch.profiler, `reps` times after one call
    untraced (then `traced()`, if given, marks the traced window's start):
    wall, device busy and idle share, device ops, and per call the host's
    CUDA graph launches, kernel launches (cudaLaunchKernel*,
    cuLaunchKernel*) and copies (cudaMemcpyAsync), the device's
    host-to-device copy events (the profiler has been seen to drop one of
    three; the host's count is the one checked) and the device's events of
    each hand-written kernel, by name (`kernels_per_call`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    if traced is not None:
        traced()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    busy = ops = graphs = kernel_launches = copies = h2d = 0
    ours = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy += e.time_range.elapsed_us() / 1e3
            ops += 1
            h2d += "HtoD" in e.name
            cat = _kernel_category(e.name)
            if cat in KERNEL_NAMES:
                ours[cat] = ours.get(cat, 0) + 1
        elif e.name == "cudaGraphLaunch":
            graphs += 1
        elif "LaunchKernel" in e.name:
            kernel_launches += 1
        elif e.name == "cudaMemcpyAsync":
            copies += 1
    out = {"wall_ms": wall_ms, "graph_launches_per_call": graphs / reps,
           "host_kernel_launches_per_call": kernel_launches / reps,
           "host_copies_per_call": copies / reps,
           "h2d_copies_per_call": h2d / reps,
           "kernels_per_call": {k: n / reps for k, n in sorted(ours.items())}}
    if busy <= 0.0:
        out["device"] = "not measured: the profiler recorded no device time"
        return out
    out.update(device_busy_ms=busy / reps,
               device_idle_share=max(0.0, 1 - busy / reps / wall_ms),
               device_ops_per_call=ops / reps)
    return out


def _fmt_trace(t):
    return (f"wall {t['wall_ms']:.2f} ms, busy "
            f"{t.get('device_busy_ms', float('nan')):.2f} ms, idle "
            f"{t.get('device_idle_share', float('nan')):.3f}, "
            f"{t.get('device_ops_per_call', float('nan')):.0f} device ops, "
            f"{t['graph_launches_per_call']:g} graph / "
            f"{t['host_kernel_launches_per_call']:g} kernel launches, "
            f"{t['host_copies_per_call']:g} copies ({t['h2d_copies_per_call']:g}"
            " H2D seen on the device) a call")


def p50_ms(torch, fn, n: int = SERVE_IO_P50_CALLS):
    """Median wall of n calls of fn (each ends with its copy to the host)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def eager_packed(torch, prog, samples):
    """The packed program's work without its graph: the same pinned buffer,
    one copy up, the eager forward, one copy down."""
    prog.pack(samples)
    out = prog.fn.fn(prog.host.to(prog.device, non_blocking=True))
    return out.cpu().numpy()


def graphs_case(torch, tag, exp, members, samples, *, impl, dtype):
    """One served config through its captured programs against eager on the
    same members and inputs: the bucket-8 ensemble forward and the batch-1
    predict bit-equal; the replayed calls' traces (one graph launch, no
    host kernel launch); bucket-8 wall and idle, batch-1 p50, graphed and
    eager; BatchingServer's H2D copies per batch."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch.serve import (
        BatchingServer, StreamingPredictor, ensemble_serve_fn)

    fn = ensemble_serve_fn(members, exp.thresholds, impl=impl, dtype=dtype)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples[:SERVE_BUCKET]]))
             .cuda() for k in samples[0] if k != "label"}
    first = [t.clone() for t in fn(batch)]          # warm-up: eager, capture
    replay = [t.clone() for t in fn(batch)]
    eager = fn.fn(batch)
    bucket_equal = all(torch.equal(a, b) for a, b in zip(replay, eager)) and \
        all(torch.equal(a, b) for a, b in zip(first, eager))
    sp = StreamingPredictor(members, exp.thresholds, impl=impl, dtype=dtype)
    sp.warmup(samples[0])
    prog = sp.packed_program(samples[0])
    b1_equal = all(np.array_equal(np.concatenate(sp.predict(s)),
                                  eager_packed(torch, prog, [s])[0])
                   for s in samples[:2])
    out = {"bucket8_bit_equal": bucket_equal, "batch1_bit_equal": b1_equal,
           "bucket8_graphed": trace_call(torch, lambda: fn(batch)),
           "bucket8_eager": trace_call(torch, lambda: fn.fn(batch)),
           "batch1_graphed": trace_call(torch, lambda: sp.predict(samples[0])),
           "batch1_p50_ms": p50_ms(torch, lambda: sp.predict(samples[0])),
           "batch1_eager_p50_ms": p50_ms(
               torch, lambda: eager_packed(torch, prog, [samples[0]])),
           "graph_stats": [fn.stats(), prog.fn.stats()]}
    with BatchingServer(members, exp.thresholds, impl=impl, max_delay_ms=3.0,
                        dtype=dtype) as srv:
        srv.warmup(samples[0])

        def burst():
            for f in [srv.submit(s) for s in samples[:SERVE_BUCKET]]:
                f.result(timeout=600)

        mark = {}

        def traced():
            mark["batches"] = srv.stats()["batches"]
            mark["replays"] = {b: p.fn.replays
                               for b, p in srv._programs.items()}

        out["server_burst"] = trace_call(
            torch, burst, reps=SERVE_IO_TRACE_REPS, traced=traced)
        batches = srv.stats()["batches"] - mark["batches"]
        server_ledger = {}   # over the traced window, then a call
        for b, p in srv._programs.items():
            n = p.fn.replays - mark["replays"].get(b, 0)
            for k, c in p.fn.launches_per_replay().items():
                server_ledger[k] = server_ledger.get(k, 0) + c * n
        server_ledger = {k: n / SERVE_IO_TRACE_REPS
                         for k, n in server_ledger.items()}
        out["server_batches_traced"] = batches
        per_batch = SERVE_IO_TRACE_REPS / batches
        out["server_copies_per_batch"] = (
            out["server_burst"]["host_copies_per_call"] * per_batch)
        out["server_device_h2d_per_batch"] = (
            out["server_burst"]["h2d_copies_per_call"] * per_batch)
    for key in ("bucket8_graphed", "batch1_graphed"):
        log(f"[serve_io] {tag} {key}: {_fmt_trace(out[key])}")
    log(f"[serve_io] {tag} bucket8_eager: {_fmt_trace(out['bucket8_eager'])}")
    log(f"[serve_io] {tag}: replay bit-equal to eager: bucket 8 "
        f"{bucket_equal}, batch 1 {b1_equal}; batch-1 p50 "
        f"{out['batch1_p50_ms']:.2f} ms graphed, "
        f"{out['batch1_eager_p50_ms']:.2f} ms eager; the server made "
        f"{out['server_copies_per_batch']:g} copies a batch (one up, one "
        f"down; {out['server_device_h2d_per_batch']:g} H2D seen on the "
        f"device) over {batches} traced batches; first calls (eager call "
        f"and capture) {fn.capture_ms[0]:.1f} ms bucket 8, "
        f"{prog.fn.capture_ms[0]:.1f} ms packed batch 1")
    out["ledger_per_replay"] = {
        "bucket8_graphed": dict(fn.launches_per_replay()),
        "batch1_graphed": dict(prog.fn.launches_per_replay()),
        "server_burst": server_ledger}
    check_ledger(torch, tag, out, out["ledger_per_replay"], {
        "bucket8_graphed": lambda: fn(batch),
        "batch1_graphed": lambda: sp.predict(samples[0])})
    g = [out["bucket8_graphed"], out["batch1_graphed"]]
    if not (bucket_equal and b1_equal):
        raise AssertionError(f"{tag}: a replay differs from the eager path")
    if any(t["graph_launches_per_call"] != 1
           or t["host_kernel_launches_per_call"] != 0 for t in g):
        raise AssertionError(f"{tag}: a replayed call is not one graph launch "
                             f"without host kernel launches: {g}")
    if out["server_copies_per_batch"] != 2 or \
            out["server_device_h2d_per_batch"] > 1:
        raise AssertionError(f"{tag}: the server made "
                             f"{out['server_copies_per_batch']} copies a batch")
    return out


def check_ledger(torch, tag, traces, ledgers, calls):
    """Each traced graphed case ran on the device, kernel by kernel, the
    launches that its graphs' ledgers credit per call, and at least one.
    The profiler drops device events in a long process, never adds one
    (traced_program): where the window of a case in `calls` (one graph
    launch a call) falls short of its ledger and exceeds it nowhere, the
    call is traced again replay by replay (replay_kernel_counts): none may
    exceed the ledger and one must match it, kernel for kernel."""
    for case, ledger in ledgers.items():
        seen = traces[case]["kernels_per_call"]
        want = {k: float(n) for k, n in sorted(ledger.items())}
        ok = bool(ledger) and seen == want
        by_replay = None
        if (not ok and ledger and case in calls
                and all(seen.get(k, 0.0) <= n for k, n in want.items())
                and set(seen) <= set(want)):
            by_replay = replay_kernel_counts(torch, calls[case])
            if by_replay is not None:
                ok = (any(dict(c) == dict(ledger) for c in by_replay)
                      and not any(c[k] > ledger.get(k, 0)
                                  for c in by_replay for k in c))
        log(f"[serve_io] {tag} {case}: hand-written kernels a call on the "
            f"device {seen}, credited by the ledger {ledger}"
            + ("" if by_replay is None else "; traced again by replay: "
               + ", ".join(str(dict(c)) for c in by_replay)))
        if not ok:
            raise AssertionError(f"{tag} {case}: the device ran {seen} "
                                 f"kernels a call, the ledger credits {ledger}")


def serve_io_graphs(torch, report):
    """The graphs part of serve_io: the three served configs and the
    paragraph step.  Returns the kernels' launches in it."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.serve import ParagraphStreamingPredictor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = all_kernels()
    reset_counts(kernels)
    out = {}
    for name, impl in (("mosei_trans_s1024", "flash"), ("robot_demo", "pallas"),
                       ("ren_mme", "pallas_fused")):
        exp = configs.get(name)
        members = [build_model(exp, device="cuda", seed=i)
                   for i in range(N_MEMBERS)]
        if name == "robot_demo":
            set_gates(torch, members)
        samples = synthetic_dataset(exp.name, exp.model, SERVE_BUCKET, seed=7)
        out[name] = graphs_case(torch, name, exp, members, samples, impl=impl,
                                dtype=exp.train.compute_dtype)
        del members
    exp = configs.get("mosei_realformer")
    members = [build_model(exp, device="cuda", seed=i) for i in range(RF_MEMBERS)]
    set_gates(torch, members, seed=4321)
    sample = synthetic_dataset(exp.name, exp.model, 1, seed=7)[0]
    sp = ParagraphStreamingPredictor(members, RF_OFFSETS, impl="pallas")
    keys = sp._CLIP_KEYS
    clips = [{k: sample[k][t] for k in keys} for t in range(RF_P)]
    sp.warmup(clips[0])
    sp.reset()
    graphed = [np.concatenate(sp.push(c)) for c in clips]
    sp.reset()
    dev = [{k: torch.from_numpy(np.asarray(c[k])[None]).cuda() for k in keys}
           for c in clips]
    eager = [sp.step.fn(d).cpu().numpy() for d in dev]
    equal = all(np.array_equal(a, b) for a, b in zip(graphed, eager))

    def clip_ms(push):
        sp.reset()
        times = []
        for c in clips:
            t0 = time.perf_counter()
            push(c)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    para = {"bit_equal": equal,
            "clip_graphed": trace_call(torch, lambda: sp.push(clips[0])),
            "clip_p50_ms": clip_ms(sp.push),
            "clip_eager_p50_ms": clip_ms(lambda c: sp.step.fn(
                {k: torch.from_numpy(np.asarray(c[k])[None]).cuda()
                 for k in keys}).cpu()),
            "graph_stats": sp.step.stats()}
    para["ledger_per_replay"] = {"clip_graphed": dict(
        sp.step.launches_per_replay())}
    out["mosei_realformer_paragraph"] = para
    log(f"[serve_io] paragraph step clip_graphed: {_fmt_trace(para['clip_graphed'])}")
    log(f"[serve_io] paragraph: {RF_P} clips through the captured step "
        f"bit-equal to eager {equal}; clip p50 {para['clip_p50_ms']:.2f} ms "
        f"graphed, {para['clip_eager_p50_ms']:.2f} ms eager; first call "
        f"(eager call and capture) {sp.step.capture_ms[0]:.1f} ms")
    check_ledger(torch, "paragraph step", para, para["ledger_per_replay"],
                 {"clip_graphed": lambda: sp.push(clips[0])})
    if not equal:
        raise AssertionError("the paragraph step's replay differs from eager")
    t = para["clip_graphed"]
    if t["graph_launches_per_call"] != 1 or t["host_kernel_launches_per_call"]:
        raise AssertionError(f"a replayed clip is not one graph launch: {t}")
    report["serve_io"]["graphs"] = out
    return read_counts(kernels)


def serve_io_http(torch, report):
    """robot_demo at full width, N_MEMBERS gate-set members, behind
    HttpFrontend on an ephemeral port: sequential requests on the binary
    wire bit-equal to in-process BatchingServer.predict and JSON
    float32-exact; a wrong shape a 400; HTTP_CLIENTS concurrent clients on
    each wire and on direct submits, req/s."""
    import json as _json
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.serve import (
        BatchingServer, HttpFrontend)

    exp = configs.get("robot_demo")
    members = [build_model(exp, device="cuda", seed=i) for i in range(N_MEMBERS)]
    set_gates(torch, members)
    samples = synthetic_dataset(exp.name, exp.model, HTTP_CLIENTS, seed=7)
    spec = {k: v.shape for k, v in samples[0].items() if k != "label"}
    names = exp.emotion_names[: len(exp.thresholds)]

    def call(port, path, body=None, ctype="application/json"):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=body,
            method="POST" if body is not None else "GET",
            headers={"Content-Type": ctype})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, _json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, _json.loads(e.read())

    with BatchingServer(members, exp.thresholds, impl="pallas",
                        max_delay_ms=3.0) as srv:
        srv.warmup(samples[0])
        with HttpFrontend(srv, spec, names, port=0) as fe:
            order = fe.binary_order()
            binary = [b"".join(np.asarray(s[k], "<f4").tobytes() for k in order)
                      for s in samples]
            js = [_json.dumps({k: np.asarray(s[k]).tolist() for k in spec})
                  .encode() for s in samples]
            bin_equal = json_exact = True
            for i in range(HTTP_SEQUENTIAL):
                logits, probs = srv.predict(samples[i])
                _, b = call(fe.port, "/predict", binary[i],
                            "application/octet-stream")
                _, j = call(fe.port, "/predict", js[i])
                bin_equal &= (np.array_equal(np.asarray(b["logits"], np.float32), logits)
                              and np.array_equal(np.asarray(b["probs"], np.float32), probs))
                json_exact &= (j["logits"] == logits.tolist()
                               and j["probs"] == probs.tolist())
            bad = dict(_json.loads(js[0]))
            bad["l"] = bad["l"][:-1]
            bad_code, _ = call(fe.port, "/predict", _json.dumps(bad).encode())
            short_code, _ = call(fe.port, "/predict", binary[0][:-4],
                                 "application/octet-stream")
            refs = [srv.predict(s) for s in samples]

            def rate(one):
                with ThreadPoolExecutor(HTTP_CLIENTS) as pool:
                    t0 = time.perf_counter()
                    got = list(pool.map(one, range(HTTP_CLIENTS * HTTP_ROUNDS)))
                    return got, HTTP_CLIENTS * HTTP_ROUNDS / (time.perf_counter() - t0)

            def ok(got, pick):
                return max(normalised_err(np.asarray(pick(g)[0], np.float32),
                                          refs[i % HTTP_CLIENTS][0])
                           for i, g in enumerate(got))

            b0 = srv.stats()["batches"]
            got_b, rate_b = rate(lambda i: call(
                fe.port, "/predict", binary[i % HTTP_CLIENTS],
                "application/octet-stream")[1])
            got_j, rate_j = rate(lambda i: call(fe.port, "/predict",
                                                js[i % HTTP_CLIENTS])[1])
            got_d, rate_d = rate(lambda i: srv.predict(samples[i % HTTP_CLIENTS]))
            err = max(ok(got_b, lambda g: (g["logits"],)),
                      ok(got_j, lambda g: (g["logits"],)),
                      ok(got_d, lambda g: g))
            stats = srv.stats()
            health = call(fe.port, "/healthz")[1]
    out = {"members": N_MEMBERS, "clients": HTTP_CLIENTS,
           "requests_per_wire": HTTP_CLIENTS * HTTP_ROUNDS,
           "binary_bytes": len(binary[0]), "json_bytes": len(js[0]),
           "binary_bit_equal": bool(bin_equal),
           "json_float32_exact": bool(json_exact),
           "wrong_shape_status": bad_code, "short_body_status": short_code,
           "req_per_s": {"binary": rate_b, "json": rate_j, "direct": rate_d},
           "concurrent_max_err": err, "batches": stats["batches"] - b0,
           "by_bucket": stats["by_bucket"], "healthz_members": health["members"]}
    report["serve_io"]["http"] = out
    log(f"[serve_io] http robot_demo, {N_MEMBERS} members: binary bit-equal "
        f"{bin_equal}, JSON float32-exact {json_exact} over {HTTP_SEQUENTIAL} "
        f"sequential requests; wrong shape -> {bad_code}, short body -> "
        f"{short_code}; {HTTP_CLIENTS} clients x {HTTP_ROUNDS}: binary "
        f"{rate_b:.1f} req/s ({len(binary[0])} bytes a request), JSON "
        f"{rate_j:.1f} req/s ({len(js[0])} bytes), direct submits "
        f"{rate_d:.1f} req/s; concurrent results within {err:.2e} of "
        f"in-process; {out['batches']} batches {stats['by_bucket']}")
    if not (bin_equal and json_exact) or (bad_code, short_code) != (400, 400):
        raise AssertionError("the HTTP wires disagree with in-process predicts "
                             "or a bad request was not a 400")
    if err > ROBOT_TOL or health["members"] != N_MEMBERS:
        raise AssertionError(f"concurrent HTTP results {err:.3e} off")


def serve_io_export(torch, report):
    """`cli export ren_mme --batch 8` on the card, loaded and run against
    ensemble_serve_fn(impl="xla") on the same seeded members (the CLI's
    store-less members), within EXPORT_RTOL; its size and call time beside
    the captured programs'."""
    import io

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import cli, configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.serve import (
        ensemble_serve_fn, load_predictor)

    exp = configs.get("ren_mme")
    path = STORES / "ren_mme_b8.pt2"
    path.parent.mkdir(parents=True, exist_ok=True)
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
        cli.main(["export", "ren_mme", "--batch", str(SERVE_BUCKET),
                  "--out", str(path)])
    export_s = time.perf_counter() - t0
    blob = path.read_bytes()
    path.unlink()
    fn = load_predictor(blob)
    members = [build_model(exp, device="cuda", seed=i) for i in range(N_MEMBERS)]
    samples = synthetic_dataset(exp.name, exp.model, SERVE_BUCKET, seed=7)
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples])).cuda()
             for k in samples[0] if k != "label"}
    pred, probs = fn(batch)
    xla = ensemble_serve_fn(members, exp.thresholds, impl="xla")
    fused = ensemble_serve_fn(members, exp.thresholds, impl="pallas_fused")
    ref_pred, ref_probs = xla.fn(batch)
    rel = max(float((pred - ref_pred).abs().max() / ref_pred.abs().max()),
              float((probs - ref_probs).abs().max() / ref_probs.abs().max()))

    def timed(f):
        def call():
            out = f(batch)
            torch.cuda.synchronize()
            return out
        call()
        return p50_ms(torch, call)

    out = {"artifact_bytes": len(blob), "export_s": export_s,
           "device": str(pred.device), "max_rel_err_vs_xla": rel,
           "shapes": [list(pred.shape), list(probs.shape)],
           "call_p50_ms": timed(fn), "captured_xla_p50_ms": timed(xla),
           "captured_pallas_fused_p50_ms": timed(fused),
           "cli_output": text.getvalue().strip()}
    report["serve_io"]["export"] = out
    log(f"[serve_io] export ren_mme batch {SERVE_BUCKET}: {len(blob)} bytes in "
        f"{export_s:.1f} s on {pred.device}; against ensemble_serve_fn(xla) "
        f"{rel:.2e} relative (bound {EXPORT_RTOL:g}); call p50 "
        f"{out['call_p50_ms']:.2f} ms, the captured program "
        f"{out['captured_xla_p50_ms']:.2f} ms at xla, "
        f"{out['captured_pallas_fused_p50_ms']:.2f} ms at pallas_fused")
    if rel > EXPORT_RTOL or pred.device.type != "cuda" or list(pred.shape) != [
            SERVE_BUCKET, exp.model.n_emotions]:
        raise AssertionError(f"the exported predictor is {rel:.3e} off")


def serve_io_wire(torch, report):
    """run_predict of mosei_trans at each wire against f32; `cli train
    --transfer-dtype float16` on features on the float16 grid against f32;
    the H2D bytes of a batch at each wire."""
    import io

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import cli, configs, pipelines
    from multimodal_emotion_processing_tpu_torch.data.loader import (
        Batcher, cast_for_transfer, resolve_transfer_dtype)
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset

    exp = configs.get("mosei_trans")
    wires = (None, "float16", "bfloat16", "int8")
    logits = {w: pipelines.run_predict(
        exp.name, init_random=True, n_test=WIRE_N_TEST, impl="pallas_fused",
        quiet=True, device="cuda", transfer_dtype=w)["logits"] for w in wires}
    batch = next(iter(Batcher(synthetic_dataset(exp.name, exp.model,
                                                MT_BATCH, seed=1),
                              MT_BATCH, shuffle=False)()))

    def nbytes(b):
        return sum(v.numel() * v.element_size() if torch.is_tensor(v)
                   else v.nbytes for v in b.values())

    h2d = {str(w): nbytes(cast_for_transfer(batch, resolve_transfer_dtype(w)))
           for w in wires}
    errs = {w: normalised_err(logits[w], logits[None]) for w in wires[1:]}

    def rounded(exp_, n_train, n_test, seed=0):
        train, test = synthetic(exp_, n_train, n_test, seed)
        grid = [[{k: (v.astype(np.float16).astype(np.float32)
                      if v.dtype == np.float32 else v) for k, v in s.items()}
                 for s in part] for part in (train, test)]
        return grid[0], grid[1]

    synthetic = pipelines._synthetic_data
    pipelines._synthetic_data = rounded
    kernels = all_kernels()
    runs = {}
    try:
        for w in (None, "float16"):
            reset_counts(kernels)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                res = cli.main(
                    ["train", exp.name, "--impl", "pallas_fused", "--epochs",
                     str(WIRE_EPOCHS), "--n-train", str(WIRE_N_TRAIN),
                     "--n-test", str(WIRE_N_TEST), "--quiet", "--set",
                     f"train.n_folds={WIRE_FOLDS}"]
                    + (["--transfer-dtype", w] if w else []))
            runs[w] = (res, read_counts(kernels))
    finally:
        pipelines._synthetic_data = synthetic
    losses = {w: [x for h in r.fold_histories for e in h
                  for x in (*e.step_losses, e.valid_loss)]
              for w, (r, _) in runs.items()}
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses["float16"], losses[None]))
    logit_rel = normalised_err(runs["float16"][0].logits, runs[None][0].logits)
    out = {"run_predict_err_vs_f32": errs, "h2d_bytes_per_batch": h2d,
           "batch": MT_BATCH, "train_loss_max_rel_err_f16_vs_f32": loss_rel,
           "train_losses": len(losses[None]),
           "train_logit_err_f16_vs_f32": logit_rel,
           "train_launches": {str(w): c for w, (_, c) in runs.items()}}
    report["serve_io"]["wire"] = out
    log(f"[serve_io] wire: run_predict mosei_trans ({WIRE_N_TEST} samples, "
        "pallas_fused) against f32: "
        + ", ".join(f"{w} {e:.2e}" for w, e in errs.items())
        + "; H2D bytes a batch of " + str(MT_BATCH) + ": "
        + ", ".join(f"{w} {b}" for w, b in h2d.items())
        + f"; cli train --transfer-dtype float16 on f16-grid features: "
        f"{len(losses[None])} losses within {loss_rel:.2e} of f32 (bound "
        f"{WIRE_TRAIN_RTOL:g}), ensemble logits {logit_rel:.2e}")
    if loss_rel > WIRE_TRAIN_RTOL or len(losses[None]) != len(losses["float16"]):
        raise AssertionError(f"the float16 wire moved the fit: {loss_rel:.3e}")
    if runs[None][1] != runs["float16"][1]:
        raise AssertionError(f"the wires launched differently: {out['train_launches']}")
    for w, bound in WIRE_PREDICT_BOUNDS.items():
        if errs[w] > bound:
            raise AssertionError(f"run_predict at {w}: {errs[w]:.3e} > {bound}")


def phase_serve_io(torch, report):
    """Phase serve_io: the captured programs of every served path against
    eager, the HTTP front end, the export and the wire formats (the
    asynchronous store is checked in phase experiment's resume).  Returns
    the kernels' launches in the graphs part."""
    report["serve_io"] = {}
    t0 = time.perf_counter()
    launches = serve_io_graphs(torch, report)
    for part in (serve_io_http, serve_io_export, serve_io_wire):
        part(torch, report)
    report["serve_io"]["wall_s"] = time.perf_counter() - t0
    log(f"[serve_io] phase wall {report['serve_io']['wall_s']:.1f} s; "
        f"launches in its graphs part {launches}")
    return launches


# the drivers phase: the whole-run drivers of train/device_epochs.py,
# vmap_kfold.py and sweep.py at cmu-mosei/run.py's width (mosei_trans, dim
# 96, impl="pallas_fused", B 64, the config's 4 folds of 4096 pairs:
# 16,384 synthetic pairs, 3 epochs: epoch 1 pays the captures, epoch 2
# is timed, epoch 3 profiled whole; 512 test pairs); its captured steps
# (the Trainer's) against a loop of eager engine.train_step over 8 steps
# (2 epochs of 4, an eval pass after each) of mosei_trans, ren_mme (16
# pairs, dropout 0.1, R-Drop) and robot_demo (dropout 0.1, gates set); the
# sequential host-fed baseline at pallas_fused timed on member 1 (its
# three epochs), and run whole at xla as the reference; the bounds
# against xla (EXP_*) held at the experiment phase's cell, and at the
# fold size, where the two impls' trajectories drift apart over 576
# steps, the epoch losses held to FOLD_LOSS_TOL, best epochs equal and at
# most FOLD_FLIP_SHARE of the decisions flipped, beside a witness: the
# xla run against itself from every initial parameter moved by one ulp;
# accumulation at mosei_trans_s1024 (flash, bf16, B 64) against the
# unaccumulated step's step-1 gradients (bf16 bound); predict_all_staged
# on 4 restored members; the sweep over 4 learning rates on a 1,024-pair
# split, 2 epochs
DRV_FOLDS, DRV_FOLD, DRV_EPOCHS, DRV_N_TEST = 4, 4096, 3, 512
DRV_CAPTURED_STEPS = 4          # a fit's steps per epoch in the bit checks
DRV_TIMED_EPOCH = 2             # the epoch whose wall is reported (1-based)
DRV_PROFILED_EPOCH = 3          # the epoch profiled whole (1-based)
# the fold size's bounds against xla, set from readings (PERF.md): over
# 576 steps the lockstep's epoch losses came 4.22e-3 from xla's and
# device-resident's 2.60e-3 (7 of 3072 decisions flipped), and xla from
# parameters moved by one ulp 4.19e-3 from xla itself (6 flipped)
FOLD_LOSS_TOL = 1e-2            # epoch losses, relative
FOLD_FLIP_SHARE = 1e-2          # decisions flipped
ACC_STEPS, ACC_TOL = (1, 2, 4), 5e-2
SWEEP_LRS, SWEEP_PAIRS, SWEEP_EPOCHS = (1e-3, 5e-4, 2e-4, 1e-4), 1024, 2


class EpochProfile:
    """torch.profiler (device activity only) over one window of a run,
    entered and left after a synchronisation, so that no device work
    crosses its edges: the host wall of the window, the device busy time
    (the union of the device's kernel, copy and fill intervals), the idle
    share and the device events.  Busy over the wall fails: no device
    work can run outside the window."""

    def __init__(self, torch):
        self.torch = torch

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self) -> dict:
        from torch.autograd import DeviceType

        self.torch.cuda.synchronize()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        spans = sorted((e.start_ns(), e.end_ns())
                       for e in self.prof.profiler.kineto_results.events()
                       if e.device_type() == DeviceType.CUDA)
        del self.prof
        busy_ns, end = 0, None
        for a, b in spans:
            if end is None or a > end:
                busy_ns += b - a
                end = b
            elif b > end:
                busy_ns += b - end
                end = b
        busy = busy_ns / 1e9
        out = {"window_s": wall, "busy_s": busy, "device_events": len(spans),
               "profiler_start_s": self.start_s}
        if not spans:
            out["device"] = "not measured: the profiler recorded no device time"
            return out
        if busy > wall:
            raise AssertionError(f"the profiled window's device busy time "
                                 f"{busy:.4f} s exceeds its wall {wall:.4f} s")
        out["idle_share"] = 1.0 - busy / wall
        return out


@contextlib.contextmanager
def lockstep_probe(torch, profile_epoch=None):
    """For the block: the Lockstep that a driver builds (the last one) is
    kept in the yielded record (`lockstep`), whose captured programs a
    check can then replay; a CUDA event is recorded as each epoch's first
    train step is launched (`starts`) and as the driver reads the step
    counts (`syncs`: after each epoch's losses were fetched; one-dispatch
    once, at the run's end), and `device_epoch_s` gives each epoch's wall
    on the device's timeline from them.  With `profile_epoch` (1-based)
    that epoch runs under EpochProfile, from its first train launch (after
    a synchronisation) to the next read of the step counts, the window in
    `epoch`.  The record is the caller's: nothing of the driver outlives
    it."""
    from multimodal_emotion_processing_tpu_torch.train import device_epochs

    cls = device_epochs.Lockstep
    names = ("__init__", "steps", "eval_batches", "sync_steps")
    saved = {n: getattr(cls, n) for n in names}
    rec = {"lockstep": None, "epoch": None, "starts": [], "syncs": []}
    at = {"epochs": 0, "kind": None, "profile": None}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def init(self, *args, **kw):
        saved["__init__"](self, *args, **kw)
        rec.update(lockstep=self, starts=[], syncs=[])
        at.update(epochs=0, kind=None)

    def steps(self, n):
        if at["kind"] != "train":
            at["epochs"] += 1
            at["kind"] = "train"
            rec["starts"].append(event())
            if at["epochs"] == profile_epoch:
                at["profile"] = EpochProfile(torch)
                at["profile"].start()
        return saved["steps"](self, n)

    def eval_batches(self, n):
        at["kind"] = "eval"
        return saved["eval_batches"](self, n)

    def sync_steps(self):
        rec["syncs"].append(event())
        if at["profile"] is not None:
            rec["epoch"] = at["profile"].stop()
            at["profile"] = None
        return saved["sync_steps"](self)

    for n, fn in (("__init__", init), ("steps", steps),
                  ("eval_batches", eval_batches), ("sync_steps", sync_steps)):
        setattr(cls, n, fn)
    try:
        yield rec
        torch.cuda.synchronize()
        starts, syncs = rec["starts"], rec["syncs"]
        if len(syncs) == len(starts):   # one read an epoch
            ends = syncs
        else:                           # one-dispatch: the next launch
            ends = starts[1:] + syncs[-1:]
        rec["device_epoch_s"] = [a.elapsed_time(b) / 1e3
                                 for a, b in zip(starts, ends)]
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)


def same_state(torch, a, b) -> bool:
    """Two TrainStates hold the same bits: parameters, moments, count,
    learning rate, step and dropout generator."""
    pairs = list(zip(a.model.state_dict().values(), b.model.state_dict().values()))
    pairs += list(zip(a.optimizer.mu + a.optimizer.nu,
                      b.optimizer.mu + b.optimizer.nu))
    return (all(torch.equal(x, y) for x, y in pairs)
            and (a.optimizer.count, a.optimizer.lr, a.step)
            == (b.optimizer.count, b.optimizer.lr, b.step)
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


REPLAY_TRACE_REPS = 4


def replay_kernel_counts(torch, prog, reps: int = REPLAY_TRACE_REPS):
    """Each of `reps` replays of `prog` traced in one profiler window, its
    hand-written kernels' device events counted by replay (a graph's
    kernels share the correlation id of its launch).  Returns a list of
    one Counter a replay, or None where the events do not split into
    `reps` replays."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            prog()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        cat = _kernel_category(e.name())
        if cat in KERNEL_NAMES:
            groups.setdefault(e.correlation_id(), Counter())[cat] += 1
    return list(groups.values()) if len(groups) == reps else None


def traced_program(torch, tag, prog, reset, drawing: int = 0):
    """One replay of a captured step program traced (after `reset` zeroes
    its index): one graph launch, no host kernel launch but PyTorch's two
    fills of each registered generator that the step draws dropout masks
    from (`drawing` of them: the generator's seed and offset written into
    the graph's inputs), and each hand-written kernel's device events a
    replay equal to its ledger's credit, the backward kernels that
    autograd launched from its own thread included.  The profiler has
    been seen to drop device events in a long process (a few of a
    window's first; a host-to-device copy in three in serve_io), never to
    add one, and a graph runs the same kernels at every replay: the
    events are counted replay by replay (`replay_kernel_counts`), none
    may exceed the ledger and at least one replay must match it kernel
    for kernel; where the events do not split by replay, the window's
    mean must match."""
    ledger = prog.launches_per_replay()
    want = {k: float(n) for k, n in sorted(ledger.items())}
    reset()
    prog()
    trace = trace_call(torch, prog, traced=reset)
    seen = trace["kernels_per_call"]
    reset()
    per_replay = replay_kernel_counts(torch, prog)
    if per_replay is not None:
        exact = sum(dict(c) == dict(ledger) for c in per_replay)
        over = any(c[k] > ledger.get(k, 0) for c in per_replay for k in c)
        ok = exact > 0 and not over
        trace["replays_fully_recorded"] = f"{exact} of {len(per_replay)}"
    else:
        ok = seen == want
    log(f"[drivers] {tag}: {_fmt_trace(trace)}; hand-written kernels a "
        f"replay on the device {seen} (mean of the window), by replay "
        + (", ".join(str(dict(c)) for c in per_replay)
           if per_replay is not None else "not split")
        + f"; credited by the ledger {dict(ledger)}")
    if not ok:
        raise AssertionError(f"{tag}: the device ran {seen} kernels a "
                             f"replay, the ledger credits {dict(ledger)}")
    if (trace["graph_launches_per_call"] != 1
            or trace["host_kernel_launches_per_call"] != 2 * drawing):
        raise AssertionError(f"{tag}: a replay is not one graph launch and "
                             f"{2 * drawing} generator fills")
    return trace


def eager_fit(torch, tcfg, impl, state, train_loader, valid_loader, epochs):
    """Trainer.fit's epochs as a loop of eager engine.train_step and
    engine.eval_step over the same loaders (each batch copied to the card
    as it comes), with its plateau and early stop: the reference that the
    Trainer's captured steps are held to.  Returns (state, [(step losses,
    valid loss) an epoch])."""
    from multimodal_emotion_processing_tpu_torch.data.loader import to_device
    from multimodal_emotion_processing_tpu_torch.train import engine, schedule

    plateau = schedule.PlateauState(lr=tcfg.lr, factor=tcfg.plateau_factor,
                                    patience=tcfg.plateau_patience)
    stopper = schedule.EarlyStop(patience=tcfg.early_stop,
                                 save_guard=tcfg.save_guard)
    out = []
    for _ in range(epochs):
        losses = [engine.train_step(state, tcfg, to_device(b, "cuda"),
                                    impl=impl) for b in train_loader()]
        va = [engine.eval_step(state.model, tcfg, to_device(b, "cuda"),
                               impl=impl) for b in valid_loader()]
        va_losses = torch.stack(va).cpu().tolist()
        valid = sum(va_losses) / max(len(va_losses), 1)
        out.append((tuple(torch.stack(losses).cpu().tolist()), valid))
        engine.set_learning_rate(state, plateau.step(valid))
        if stopper.step(valid)[1]:
            break
    return state, out


def drivers_captured(torch, report, smi):
    """The Trainer's captured train and eval steps against a loop of eager
    engine.train_step and eval_step (eager_fit), bit for bit, from the same
    weights, batches and dropout seed, and one traced replay of each
    captured program."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.train import engine

    out = {}
    kernels = all_kernels()
    for name, impl, prepare in (
            ("mosei_trans", "pallas_fused",
             lambda model: spread_ln(torch, [model], seed=99)),
            ("ren_mme", "pallas_fused",
             lambda model: spread_ln(torch, [model], seed=97)),
            ("robot_demo", "pallas", lambda model: set_gates(torch, [model]))):
        exp = configs.get(name)
        tcfg = exp.train
        bs, dup = tcfg.batch_size, tcfg.rdrop_kl
        train = synthetic_dataset(name, exp.model, DRV_CAPTURED_STEPS * bs,
                                  seed=0)
        valid = synthetic_dataset(name, exp.model, 2 * bs, seed=1)

        def loaders():   # fresh ones for each run: a Batcher counts epochs
            return (Batcher(train, bs, duplicate=dup, seed=1),
                    Batcher(valid, bs, duplicate=dup, shuffle=False))

        def counted(run):
            state = engine.init_state(exp, tcfg, 0, device="cuda")
            prepare(state.model)
            before = read_counts(kernels)
            t0 = time.perf_counter()
            state, epochs = run(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts(kernels)
            return state, epochs, {k: after[k] - before[k] for k in after}, wall

        trainer = engine.Trainer(exp, tcfg, impl=impl, device="cuda")

        def captured(state):
            state, hist = trainer.fit(*loaders(), state=state, epochs=2)
            return state, [(h.step_losses, h.valid_loss) for h in hist]

        eager, hist_e, counts_e, wall_e = counted(
            lambda state: eager_fit(torch, tcfg, impl, state, *loaders(), 2))
        graphed, hist_g, counts_g, wall_g = counted(captured)
        losses_equal = hist_e == hist_g
        state_equal = same_state(torch, eager, graphed)
        entry = {"steps": sum(len(h[0]) for h in hist_g),
                 "losses_equal": losses_equal, "state_equal": state_equal,
                 "launches_eager": counts_e, "launches_graphed": counts_g,
                 "fit_s_eager": wall_e, "fit_s_graphed": wall_g}
        log(f"[drivers] {name} at {impl}: {entry['steps']} captured steps "
            f"and 2 eval passes of Trainer.fit against eager train_step and "
            f"eval_step: losses {'equal' if losses_equal else 'DIFFER'}, "
            f"final state (parameters, moments, count, LR, step, dropout "
            f"generator) {'equal' if state_equal else 'DIFFERS'}; launches "
            f"{counts_g} (eager {counts_e}); 2 epochs {wall_g:.3f} s captured"
            f" (captures included), {wall_e:.3f} s eager; {smi}")
        if not (losses_equal and state_equal) or counts_e != counts_g:
            raise AssertionError(f"{name}: the captured steps differ from eager")
        entry["train_replay"] = traced_program(
            torch, f"{name} train replay", trainer.programs["train"],
            lambda: None, drawing=int(exp.model.dropout > 0))
        if name == "mosei_trans":
            entry["eval_replay"] = traced_program(
                torch, f"{name} eval replay", trainer.programs["eval"],
                lambda: None)
        out[name] = entry
    report["drivers"]["captured"] = out


def drivers_runs(torch, exp, cases, *, n, n_test, epochs, train, test, smi,
                 tag, trace=True):
    """run_experiment of `exp` for each (key, impl, keywords) of `cases`
    over the given samples (pipelines._synthetic_data patched to them),
    LayerNorm biases spread from each member's seed (experiment_hooks;
    the keyword nudge=True also moves every initial parameter by one ulp):
    the result, wall, per member-epoch walls, peak memory, launches, the
    staging and masked epochs (the result's driver_stats), and with
    `trace`, for a lockstep driver, its epoch DRV_PROFILED_EPOCH profiled
    whole (lockstep_probe: device busy and idle share over that epoch) and
    one traced replay of its train and eval programs held to their
    ledgers."""
    import gc
    import shutil

    from multimodal_emotion_processing_tpu_torch import pipelines

    kernels = all_kernels()
    runs = {}
    synthetic = pipelines._synthetic_data
    pipelines._synthetic_data = lambda exp_, n_train, n_test_: (train, test)
    try:
        for key, impl, kw in cases:
            kw = dict(kw)
            nudge = kw.pop("nudge", False)
            store_dir = STORES / f"drivers_{tag}_{key}"
            shutil.rmtree(store_dir, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = read_counts(kernels)
            t0 = time.perf_counter()
            with experiment_hooks(torch, spread=True, nudge=nudge), \
                    lockstep_probe(torch, DRV_PROFILED_EPOCH if trace
                                   else None) as probe:
                res = pipelines.run_experiment(
                    exp.name, n_train=n, n_test=n_test, epochs=epochs,
                    impl=impl, quiet=True, checkpoint_dir=str(store_dir),
                    **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = read_counts(kernels)
            peak = torch.cuda.max_memory_allocated() / 2**30
            info = res.driver_stats
            ls = probe["lockstep"]
            probe["lockstep"] = None
            m = len(res.fold_histories)
            device_s = probe.get("device_epoch_s")
            if kw.get("one_dispatch"):
                # its EpochStats carry the run's mean: it fetches nothing
                # until the end; each epoch is timed on the device instead
                per = [t / m for t in device_s]
            elif ls is not None:
                per = [h.seconds / m for h in res.fold_histories[0]]
            else:
                per = [sum(hist[e].seconds for hist in res.fold_histories) / m
                       for e in range(len(res.fold_histories[0]))]
            run = dict(res=res, impl=impl, wall_s=wall, member_epoch_s=per,
                       device_epoch_s=device_s,
                       peak_gb=peak, staging_s=info.get("staging_s"),
                       staged_bytes=info.get("staged_bytes"),
                       masked_epochs=info.get("masked_epochs"),
                       launches={k: after[k] - before[k] for k in after})
            msg = (f"[drivers] {tag} {key} at {impl}: run wall {wall:.1f} s;"
                   " per member-epoch " + ", ".join(
                       f"epoch {e + 1} {t:.3f} s" for e, t in enumerate(per))
                   + " (epoch 1 pays the captures"
                   + (f", epoch {DRV_PROFILED_EPOCH} runs under the profiler"
                      if trace and ls is not None else "") + ")"
                   + (", on the device's timeline: " + ", ".join(
                       f"{t:.3f}" for t in device_s) + " s an epoch"
                      if device_s else "")
                   + f"; peak {peak:.2f} GiB")
            if info.get("staged_bytes"):
                msg += (f"; staged {info['staged_bytes']} bytes in "
                        f"{info['staging_s']:.2f} s")
            if info.get("masked_epochs") is not None:
                msg += f"; masked epochs {info['masked_epochs']}"
            if trace and ls is not None:
                ep = probe["epoch"]
                if ep is None or "idle_share" not in ep:
                    raise AssertionError(f"{tag} {key}: epoch "
                                         f"{DRV_PROFILED_EPOCH} was not "
                                         f"profiled: {ep}")
                tr = traced_program(torch, f"{tag} {key} train replay",
                                    ls.train_program, ls.t.zero_)
                ev = traced_program(torch, f"{tag} {key} eval replay",
                                    ls.eval_program, ls.j.zero_)
                run.update(epoch_profile=ep, epoch_idle_share=ep["idle_share"],
                           replay_busy_ms=tr["device_busy_ms"],
                           eval_replay_busy_ms=ev["device_busy_ms"],
                           steps=ls.n_steps, eval_batches=ls.n_eval)
                msg += (f"; epoch {DRV_PROFILED_EPOCH} profiled whole: device "
                        f"busy {ep['busy_s']:.3f} s of its {ep['window_s']:.3f}"
                        f" s window, idle share {ep['idle_share']:.3f} "
                        f"({ep['device_events']} device events); a train "
                        f"replay {tr['device_busy_ms']:.2f} ms x {ls.n_steps}, "
                        f"an eval replay {ev['device_busy_ms']:.2f} ms x "
                        f"{ls.n_eval}")
            del ls, probe
            runs[key] = run
            log(msg + f"; launches {run['launches']}; {smi}")
    finally:
        pipelines._synthetic_data = synthetic
    return runs


def drivers_losses(res):
    return [[(h.train_loss, h.valid_loss) for h in hist]
            for hist in res.fold_histories]


def drivers_against(exp, runs, key, ref, tag):
    """The experiment phase's bounds of `key` against `ref`: epoch losses
    within EXP_LOSS_TOL (relative), best epochs equal, the ensemble's
    decisions equal wherever a logit lies EXP_MARGIN or more from its
    threshold.  Returns the readings, `within_bounds` among them."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch.eval.ensemble import apply_thresholds

    a, b = runs[key]["res"], runs[ref]["res"]
    rel = max(abs(x - y) / max(abs(y), 1e-30)
              for ha, hb in zip(drivers_losses(a), drivers_losses(b))
              for ea, eb in zip(ha, hb) for x, y in zip(ea, eb))
    th, idx = exp.thresholds, exp.emotion_index
    dec, dec_x = (apply_thresholds(r.logits, th, idx) for r in (a, b))
    cols = np.stack([a.logits[:, i] for i in idx], 1)
    cols_x = np.stack([b.logits[:, i] for i in idx], 1)
    near = np.minimum(np.abs(cols - np.asarray(th)),
                      np.abs(cols_x - np.asarray(th))) < EXP_MARGIN
    flips = int((dec != dec_x).sum())
    names = [f"{exp.name}_{i + 1}" for i in range(len(a.fold_histories))]
    got = dict(max_loss_rel_err=rel,
               best_epochs=[a.store.manifest[n]["epoch"] for n in names],
               best_epochs_ref=[b.store.manifest[n]["epoch"] for n in names],
               decision_flips=flips, decisions=int(dec.size),
               unexplained_flips=int(((dec != dec_x) & ~near).sum()),
               logit_err=normalised_err(a.logits, b.logits))
    got["within_bounds"] = (rel <= EXP_LOSS_TOL
                            and not got["unexplained_flips"]
                            and got["best_epochs"] == got["best_epochs_ref"])
    log(f"[drivers] {tag} {key} against {ref}: epoch losses {rel:.2e} apart "
        f"(bound {EXP_LOSS_TOL:g}); best epochs {got['best_epochs']} "
        f"({got['best_epochs_ref']}); {flips} of {dec.size} decisions differ,"
        f" {got['unexplained_flips']} of them with both logits {EXP_MARGIN:g} "
        f"or more from the threshold; logits {got['logit_err']:.2e} apart")
    return got


def drivers_same_run(runs, key, ref, tag):
    import numpy as np

    a, b = runs[key]["res"], runs[ref]["res"]
    equal = (drivers_losses(a) == drivers_losses(b)
             and np.array_equal(a.logits, b.logits))
    log(f"[drivers] {tag} {key} against {ref}: epoch losses and the "
        f"ensemble's logits {'equal' if equal else 'DIFFER'} bit for bit")
    if not equal:
        raise AssertionError(f"{key} differs from {ref}")
    return equal


def drivers_held_against_xla(torch, report, smi):
    """Every driver at pallas_fused held to the experiment phase's bounds
    at that phase's cell (mosei_trans, 512 pairs, 4 folds of 128, 2
    epochs, 128 test pairs): the host-fed lockstep and scan_steps=4
    against the sequential host-fed run_experiment at xla; the
    device-resident and one-dispatch drivers, whose shuffles are drawn on
    the card, against the device-resident run at xla."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset

    exp = configs.get("mosei_trans")
    train = synthetic_dataset(exp.name, exp.model, EXP_N_TRAIN, seed=0)
    test = synthetic_dataset(exp.name, exp.model, EXP_N_TEST, seed=1)
    cases = (("sequential_xla", "xla", {"vmap_folds": False}),
             ("lockstep", "pallas_fused", {"vmap_folds": True}),
             ("scan4", "pallas_fused", {"vmap_folds": True, "scan_steps": 4}),
             ("device_resident_xla", "xla",
              {"vmap_folds": True, "device_resident": True}),
             ("device_resident", "pallas_fused",
              {"vmap_folds": True, "device_resident": True}),
             ("one_dispatch", "pallas_fused",
              {"vmap_folds": True, "one_dispatch": True}))
    runs = drivers_runs(torch, exp, cases, n=EXP_N_TRAIN, n_test=EXP_N_TEST,
                        epochs=EXP_EPOCHS, train=train, test=test, smi=smi,
                        tag="cell", trace=False)
    held = {key: drivers_against(exp, runs, key, ref, "cell")
            for key, ref in (("lockstep", "sequential_xla"),
                             ("scan4", "sequential_xla"),
                             ("device_resident", "device_resident_xla"),
                             ("one_dispatch", "device_resident_xla"))}
    report["drivers"]["held_against_xla"] = held
    bad = [k for k, v in held.items() if not v["within_bounds"]]
    if bad:
        raise AssertionError(f"outside the experiment bounds against xla: "
                             f"{bad}")


def drivers_at_fold_size(torch, report, smi):
    """The drivers at the reference's fold size (mosei_trans, 4 folds of
    4096 pairs, 3 epochs, 512 test pairs) through run_experiment: the
    host-fed lockstep, with scan_steps=4, device-resident and one-dispatch
    at pallas_fused, each timed over epoch 2, profiled over epoch 3 and
    traced;
    scan_steps=4 bit-equal to the lockstep, one-dispatch to
    device-resident; the lockstep held against the sequential host-fed
    run at xla and device-resident against the device-resident run at xla
    (held_at_fold_size), beside the witness of how far rounding alone
    carries these 576 steps; the sequential host-fed driver at
    pallas_fused on member 1 (the cut: its three epochs, epoch 3
    profiled), bit-equal to the lockstep's member 1, its epoch 2 beside
    the lockstep's (what sets run_experiment's vmap_folds default).
    Returns the lockstep run's store and the test samples."""
    import random

    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.train import engine
    from multimodal_emotion_processing_tpu_torch.train.kfold import contiguous_folds

    exp = configs.get("mosei_trans")
    m, tcfg = exp.model, exp.train
    if (tcfg.n_folds, tcfg.fold_size, tcfg.batch_size, m.dim) != (
            DRV_FOLDS, DRV_FOLD, MT_BATCH, 96):
        raise AssertionError(f"unexpected config {exp}")
    n = DRV_FOLDS * DRV_FOLD
    t0 = time.perf_counter()
    train = synthetic_dataset(exp.name, m, n, seed=0)
    test = synthetic_dataset(exp.name, m, DRV_N_TEST, seed=1)
    pair_bytes = sum(np.asarray(v).nbytes for v in train[0].values())
    gen_s = time.perf_counter() - t0
    log(f"[drivers] {n} synthetic pairs ({pair_bytes} bytes a pair, "
        f"{n * pair_bytes / 1e9:.3f} GB) and {DRV_N_TEST} test pairs made in "
        f"{gen_s:.1f} s; {DRV_FOLDS} folds of {DRV_FOLD}, {DRV_EPOCHS} "
        f"epochs, B {tcfg.batch_size}")
    resident = {"vmap_folds": True, "device_resident": True}
    cases = (("lockstep", "pallas_fused", {"vmap_folds": True}),
             ("sequential_xla", "xla", {"vmap_folds": False}),
             ("scan4", "pallas_fused", {"vmap_folds": True, "scan_steps": 4}),
             ("device_resident", "pallas_fused", resident),
             ("device_resident_xla", "xla", resident),
             ("device_resident_xla_nudged", "xla", {**resident, "nudge": True}),
             ("one_dispatch", "pallas_fused",
              {"vmap_folds": True, "one_dispatch": True}))
    traced = {"lockstep", "scan4", "device_resident", "one_dispatch"}
    runs = {}
    for case in cases:
        runs.update(drivers_runs(
            torch, exp, (case,), n=n, n_test=DRV_N_TEST, epochs=DRV_EPOCHS,
            train=train, test=test, smi=smi, tag="fold",
            trace=case[0] in traced))
    checks = {"scan4_equals_lockstep": drivers_same_run(
                  runs, "scan4", "lockstep", "fold"),
              "one_dispatch_equals_device_resident": drivers_same_run(
                  runs, "one_dispatch", "device_resident", "fold")}
    held = {key: drivers_against(exp, runs, key, ref, "fold")
            for key, ref in (("lockstep", "sequential_xla"),
                             ("device_resident", "device_resident_xla"),
                             ("device_resident_xla_nudged",
                              "device_resident_xla"))}
    lock1 = runs["lockstep"]["res"].fold_histories[0]
    seq1_x = runs["sequential_xla"]["res"].fold_histories[0]
    drift = {s: abs(lock1[0].step_losses[s - 1] - seq1_x[0].step_losses[s - 1])
             / abs(seq1_x[0].step_losses[s - 1])
             for s in (1, 8, 64, len(lock1[0].step_losses))}
    checks["member_1_step_loss_drift"] = drift
    log("[drivers] fold lockstep against sequential_xla, member 1's epoch-1 "
        "step losses, relative: " + ", ".join(
            f"step {s} {d:.2e}" for s, d in drift.items()))

    # the sequential host-fed baseline at pallas_fused: member 1
    with experiment_hooks(torch, spread=True):
        samples = list(train)
        random.Random(0).shuffle(samples)
        va, tr_ranges = contiguous_folds(n, DRV_FOLDS, DRV_FOLD)[0]
        fold_train = [samples[j] for r in tr_ranges for j in r]
        profiled = {}

        def profile_epoch(epoch, stats):
            # Trainer.fit logs an epoch after its losses were fetched
            if epoch == DRV_PROFILED_EPOCH - 2:
                profiled["p"] = EpochProfile(torch)
                profiled["p"].start()
            elif epoch == DRV_PROFILED_EPOCH - 1:
                profiled["epoch"] = profiled.pop("p").stop()

        trainer = engine.Trainer(exp, tcfg, impl="pallas_fused",
                                 device="cuda", log_cb=profile_epoch)
        state = engine.init_state(exp, tcfg, tcfg.seed, device="cuda")
        release_driver_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        state, hist = trainer.fit(
            Batcher(fold_train, tcfg.batch_size, seed=1),
            Batcher(samples[va], tcfg.batch_size, shuffle=False),
            state=state, epochs=DRV_EPOCHS)
        torch.cuda.synchronize()
    ep = profiled["epoch"]
    step = traced_program(torch, "fold sequential train replay",
                          trainer.programs["train"], lambda: None)
    seq = dict(member_epoch_s=[h.seconds for h in hist],
               epoch_profile=ep, epoch_idle_share=ep.get("idle_share"),
               replay_busy_ms=step.get("device_busy_ms"),
               peak_gb=torch.cuda.max_memory_allocated() / 2**30,
               equals_lockstep_member_1=all(
                   h.step_losses == lk.step_losses
                   and h.valid_loss == lk.valid_loss
                   for h, lk in zip(hist, lock1)) and len(hist) == len(lock1))
    del trainer, state
    log(f"[drivers] fold sequential host-fed baseline at pallas_fused "
        f"(member 1 only; the cut): " + ", ".join(
            f"epoch {e + 1} {h.seconds:.3f} s" for e, h in enumerate(hist))
        + f" a member-epoch, {hist[0].steps} steps; epoch "
        f"{DRV_PROFILED_EPOCH} profiled whole: device busy {ep['busy_s']:.3f}"
        f" s of its {ep['window_s']:.3f} s window, idle share "
        f"{ep['idle_share']:.3f}; its losses "
        + ("equal" if seq["equals_lockstep_member_1"] else "DIFFER from")
        + " the lockstep's member 1 bit for bit; peak "
        f"{seq['peak_gb']:.2f} GiB; {smi}")
    lock_s = runs["lockstep"]["member_epoch_s"][DRV_TIMED_EPOCH - 1]
    seq_s = hist[DRV_TIMED_EPOCH - 1].seconds
    default = {"lockstep_s": lock_s, "sequential_s": seq_s,
               "lockstep_no_slower": lock_s <= seq_s}
    log(f"[drivers] fold vmap_folds: epoch {DRV_TIMED_EPOCH} of the "
        f"lockstep {lock_s:.3f} s a member-epoch against the sequential "
        f"driver's {seq_s:.3f} s (bit-equal): the lockstep is "
        + ("no slower" if default["lockstep_no_slower"] else "slower")
        + f"; {smi}")
    report["drivers"]["fold_size"] = {
        "pairs": n, "pair_bytes": pair_bytes, "data_s": gen_s,
        "checks": checks, "held": held, "sequential": seq,
        "vmap_folds_default": default,
        "runs": {k: {kk: vv for kk, vv in r.items() if kk != "res"}
                 for k, r in runs.items()}}
    if not seq["equals_lockstep_member_1"]:
        raise AssertionError("the lockstep's member 1 differs from the "
                             "sequential driver")
    bad = [k for k in ("lockstep", "device_resident")
           if not held_at_fold_size(held[k])]
    if bad:
        raise AssertionError(f"outside the fold-size bounds against xla: "
                             f"{bad}")
    return runs["lockstep"]["res"].store, test


def held_at_fold_size(got) -> bool:
    """drivers_against's readings within the fold size's bounds: epoch
    losses FOLD_LOSS_TOL, best epochs equal, at most FOLD_FLIP_SHARE of the
    decisions flipped (rounding alone flips some there: the witness)."""
    return (got["max_loss_rel_err"] <= FOLD_LOSS_TOL
            and got["decision_flips"] <= FOLD_FLIP_SHARE * got["decisions"]
            and got["best_epochs"] == got["best_epochs_ref"])


def release_driver_memory(torch) -> int:
    """Collect what the last driver run left unreferenced and give the
    allocator's free blocks back; returns the bytes still allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def drivers_accumulation(torch, report, smi):
    """accum_steps 1, 2 and 4 at mosei_trans_s1024 (flash, bf16 over f32
    masters, B 64): step-1 gradients against the unaccumulated step's and
    each step's peak memory, over what was allocated before it (the
    model's parameters and the batch) and in all."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.train import engine

    exp = configs.get("mosei_trans_s1024")
    tcfg = exp.train
    if (tcfg.batch_size, tcfg.compute_dtype, exp.model.attn_impl,
            exp.model.dropout) != (TRAIN_BATCH, "bfloat16", "flash", 0.0):
        raise AssertionError(f"unexpected config {exp}")
    samples = synthetic_dataset(exp.name, exp.model, tcfg.batch_size, seed=0)
    batch = to_device(next(iter(Batcher(samples, tcfg.batch_size,
                                        shuffle=False)())), "cuda")
    state = engine.init_state(exp, tcfg, 0, device="cuda")
    model = state.model
    model.train()
    params = [p for _, p in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    out, grads = {}, {}
    for a in ACC_STEPS:
        base = release_driver_memory(torch)
        torch.cuda.reset_peak_memory_stats()
        if a == 1:
            loss = engine.batch_loss(model, tcfg, batch, impl="flash")
            g = torch.autograd.grad(loss, params, allow_unused=True)
        else:
            loss, g = engine.accum_value_and_grad(
                model, tcfg, batch, impl="flash", accum_steps=a)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        grads[a] = {n: x for n, x in zip(names, g) if x is not None}
        out[a] = {"loss": float(loss.detach()), "peak_gb": peak / 2**30,
                  "step_peak_gb": (peak - base) / 2**30}
        del loss, g
    for a in ACC_STEPS[1:]:
        err = gradient_errors(grads[a], grads[1])
        worst = max(e["rel_l2"] for e in err.values())
        out[a]["grad_rel_l2_vs_1"] = worst
        if worst > ACC_TOL:
            raise AssertionError(f"accum_steps={a}: gradients {worst:.2e} "
                                 f"from the unaccumulated step")
    log("[drivers] accumulation at mosei_trans_s1024 (flash, bf16, B 64): "
        + "; ".join(f"accum_steps {a}: loss {o['loss']:.6f}, peak "
                    f"{o['peak_gb']:.2f} GiB ({o['step_peak_gb']:.2f} over "
                    "what the step found allocated)"
                    + (f", step-1 gradients {o['grad_rel_l2_vs_1']:.2e} "
                       f"(rel L2, bound {ACC_TOL:g})" if a > 1 else "")
                    for a, o in out.items()) + f"; {smi}")
    report["drivers"]["accumulation"] = out


def drivers_staged_prediction(torch, report, smi, store, test):
    """predict_all_staged against predict_all, bit for bit, on the 4
    restored members of the lockstep run (mosei_trans, pallas_fused) and on
    4 restored seeded ren_mme members; run_predict(device_resident=True)
    against run_predict on the first store."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs, pipelines
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore

    out = {}
    ren = configs.get("ren_mme")
    ren_store = CheckpointStore(str(STORES / "drivers_ren_mme"))
    for i in range(4):
        ren_store.save_params(f"ren_mme_{i + 1}",
                              build_model(ren, device="cuda", seed=i),
                              imported=False)
    for name, st, samples in (
            ("mosei_trans", store, test),
            ("ren_mme", ren_store, synthetic_dataset("ren_mme", ren.model,
                                                     100, seed=1))):
        exp = configs.get(name)
        members, losses = pipelines._restore_members(name, exp, st, "cuda")
        ens = pipelines._make_ensemble(name, members, losses,
                                       impl="pallas_fused")
        bs = exp.train.batch_size
        t0 = time.perf_counter()
        loop = ens.predict_all(Batcher(samples, bs, shuffle=False))
        loop_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        staged = ens.predict_all_staged(samples, bs)
        staged_s = time.perf_counter() - t0
        equal = bool(np.array_equal(loop, staged))
        out[name] = {"members": ens.k, "rows": int(staged.shape[0]),
                     "equal": equal, "predict_all_s": loop_s,
                     "staged_s": staged_s}
        log(f"[drivers] predict_all_staged, {name} ({ens.k} restored "
            f"members, {staged.shape[0]} samples): "
            f"{'equal to' if equal else 'DIFFERS from'} predict_all bit for "
            f"bit; first calls {staged_s:.3f} s staged, {loop_s:.3f} s "
            f"per batch (captures included); {smi}")
        if not equal:
            raise AssertionError(f"{name}: predict_all_staged differs")
    report["drivers"]["staged_prediction"] = out


def drivers_sweep(torch, report, smi):
    """The sweep over SWEEP_LRS on a 1,024-pair split (the first eighth
    validates), 2 epochs: its member at the config's lr equals
    fit_fully_compiled bit for bit."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.train.device_epochs import fit_fully_compiled
    from multimodal_emotion_processing_tpu_torch.train.sweep import run_lr_sweep

    exp = configs.get("mosei_trans")
    tcfg = exp.train
    if tcfg.lr not in SWEEP_LRS:
        raise AssertionError(f"the sweep leaves out the config's lr {tcfg.lr}")
    samples = synthetic_dataset(exp.name, exp.model, SWEEP_PAIRS, seed=2)
    n_va = SWEEP_PAIRS // 8
    valid, train = samples[:n_va], samples[n_va:]
    release_driver_memory(torch)
    torch.cuda.reset_peak_memory_stats()
    res = run_lr_sweep(train, valid, exp, tcfg, lrs=SWEEP_LRS,
                       epochs=SWEEP_EPOCHS, impl="pallas_fused")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    _, hist, best, best_epoch, best_loss = fit_fully_compiled(
        exp, tcfg, train, valid, epochs=SWEEP_EPOCHS, impl="pallas_fused")
    single_s = time.perf_counter() - t0
    mem = res.members[SWEEP_LRS.index(tcfg.lr)]
    equal = ([(h.train_loss, h.valid_loss) for h in mem.history]
             == [(h.train_loss, h.valid_loss) for h in hist]
             and (mem.best_epoch, mem.best_valid_loss) == (best_epoch, best_loss)
             and all(torch.equal(mem.best_params[k], best[k]) for k in best))
    log(f"[drivers] sweep over lrs {SWEEP_LRS} ({len(train)} train / "
        f"{len(valid)} valid pairs, {SWEEP_EPOCHS} epochs): {res.seconds:.2f} "
        f"s, winner lr {res.members[res.winner].lr:g}, peak {peak:.2f} GiB; "
        f"one fit_fully_compiled run {single_s:.2f} s; the member at lr "
        f"{tcfg.lr:g} {'equals' if equal else 'DIFFERS from'} it bit for "
        f"bit; {smi}")
    if not equal:
        raise AssertionError("the sweep's member differs from the single run")
    report["drivers"]["sweep"] = {
        "seconds": res.seconds, "single_run_s": single_s, "peak_gb": peak,
        "table": res.table(), "member_equals_single_run": equal}


def phase_drivers(torch, report):
    """Phase drivers: the captured steps against eager, the drivers at the
    reference's fold size, accumulation at s1024, staged prediction and the
    sweep.  Every kernel counted over the whole phase (the counts set to 0
    at its start and read at its end); each kernel of these paths must have
    launched.  Returns the counts."""
    import shutil

    report["drivers"] = {}
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    kernels = all_kernels()
    reset_counts(kernels)
    drivers_captured(torch, report, smi)
    drivers_held_against_xla(torch, report, smi)
    store, test = drivers_at_fold_size(torch, report, smi)
    drivers_accumulation(torch, report, smi)
    drivers_staged_prediction(torch, report, smi, store, test)
    drivers_sweep(torch, report, smi)
    launches = read_counts(kernels)
    report["drivers"]["wall_s"] = time.perf_counter() - t0
    report["drivers"]["launches"] = launches
    log(f"[drivers] phase wall {report['drivers']['wall_s']:.1f} s; launches "
        f"{launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels of the drivers' paths never launched: "
                             f"{missing}")
    shutil.rmtree(STORES, ignore_errors=True)
    return launches


# the tools phase: the port's CLI tools at full width.  doctor's GEMM
# shares may not read above TOOLS_SHARE_MAX of their peaks; summary's
# totals must equal the built models' counts and the JAX models' counts
# this script already holds (TOOLS_PARAMS); the ren_mme round trip exports
# TOOLS_MEMBERS seeded members with export-torch, imports them into a
# fresh store and runs acceptance over a written Ren-MME tree at
# pallas_fused, the ensemble's logits held against xla at EXP_LOGIT_TOL and
# its decisions equal but within EXP_MARGIN of a threshold; the robot
# golden demo at pallas over TOOLS_DEMO_CLIPS from gate-set members, its
# probabilities within ROBOT_TOL of xla; tune at TOOLS_TUNE_ARGS, no arm in
# error; remat's step-1 gradients at s1024 (flash, bf16, B TRAIN_BATCH) the
# same bits as without it, or within REMAT_GRAD_TOL (normalised) where a
# kernel's reduction order is not fixed; short trains (TOOLS_TRAIN_ARGS)
# with --tuned, --profile-dir and --debug-nans
TOOLS_ROOT = ROOT / "chip_smoke_out" / "tools"
TOOLS_SHARE_MAX = 1.05
TOOLS_PARAMS = {"mosei_trans": MT_PARAMS, "mosei_realformer": RF_PARAMS,
                "rencecps": RC_PARAMS, "ren_mme": REN_PARAMS,
                "robot_demo": ROBOT_PARAMS, "mosei_trans_s1024": S1024_PARAMS}
TOOLS_MEMBERS = 4
TOOLS_DEMO_CLIPS = ("clip0[0]", "clip3[0]")
TOOLS_TUNE_ARGS = ("mosei_trans_s1024", "--arms", "scan,remat,impl",
                   "--steps", "4", "--reps", "2")
REMAT_GRAD_TOL = 1e-6
TOOLS_TRAIN_ARGS = ("--epochs", "2", "--n-train", "256", "--n-test", "32",
                    "--set", "train.n_folds=2", "--quiet")


def run_cli(argv):
    """cli.main(argv) with its stdout kept: (return value or SystemExit
    code, the printed text)."""
    import io

    from multimodal_emotion_processing_tpu_torch import cli

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        try:
            out = cli.main([str(a) for a in argv])
        except SystemExit as e:
            out = e.code
    return out, text.getvalue()


def tools_doctor(torch, report, smi):
    """`doctor`: its one JSON line; every floor positive, every GEMM share
    at most TOOLS_SHARE_MAX of its peak."""
    out, text = run_cli(["doctor", "--json-only"])
    rec = json.loads(text.strip().splitlines()[-1])
    report["tools"]["doctor"] = rec
    log(f"[tools] doctor: {json.dumps(rec)}; {smi}")
    floors = ("launch_floor_ms", "graph_replay_floor_ms", "h2d_pageable_gb_s",
              "h2d_pinned_gb_s", "sync_ms", "sync_fetch_ms")
    bad = [k for k in floors if not (rec.get(k) or 0) > 0]
    if bad:
        raise AssertionError(f"doctor: not positive: {bad}")
    shares = {k: rec[k] for k in rec if k.endswith("_peak_share")}
    over = {k: v for k, v in shares.items() if v is None or v > TOOLS_SHARE_MAX}
    if over:
        raise AssertionError(f"doctor: GEMM shares over {TOOLS_SHARE_MAX}: {over}")


def tools_summary(torch, report, smi):
    """`summary` of the five families and s1024: each total equal to the
    built model's parameter count and to the JAX model's (TOOLS_PARAMS)."""
    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.models import build_model

    rows = {}
    for name, want in TOOLS_PARAMS.items():
        out, _ = run_cli(["summary", name])
        built = sum(p.numel() for p in build_model(configs.get(name)).parameters())
        rows[name] = {"total": out["total"], "built": built, "jax": want,
                      "flops_per_sample": out["flops_per_sample"]}
        if not out["total"] == built == want:
            raise AssertionError(f"summary {name}: {rows[name]}")
    report["tools"]["summary"] = rows
    log("[tools] summary totals (= built = JAX): " + ", ".join(
        f"{n} {r['total']:,} ({r['flops_per_sample']['forward']:.4g} forward "
        f"FLOPs a sample)" for n, r in rows.items()))
    torch.cuda.empty_cache()


def tools_round_trip(torch, report, smi):
    """ren_mme: TOOLS_MEMBERS seeded members at the reference width through
    export-torch and import-torch (bit-equal), then `acceptance` over a
    written Ren-MME tree at pallas_fused; the same evaluation at
    pallas_fused and xla from the imported store (logits, decisions, the
    acceptance's metrics)."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs, pipelines
    from multimodal_emotion_processing_tpu_torch.eval.acceptance import (
        REFERENCE_FOLD_LOSSES)
    from multimodal_emotion_processing_tpu_torch.eval.ensemble import apply_thresholds
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore

    exp = configs.get("ren_mme")
    src, dst, pts = (TOOLS_ROOT / d for d in ("src", "dst", "pt"))
    store = CheckpointStore(str(src))
    members = [build_model(exp, seed=i) for i in range(TOOLS_MEMBERS)]
    losses = REFERENCE_FOLD_LOSSES["ren_mme"]["losses"]
    for i, m in enumerate(members):
        store.save_params(f"ren_mme_{i + 1}", m, valid_loss=losses[i],
                          imported=False)
    paths, _ = run_cli(["export-torch", "ren_mme", "--checkpoint-dir", src,
                        "--out", pts])
    names, _ = run_cli(["import-torch", "ren_mme", *paths,
                        "--checkpoint-dir", dst])
    imported = CheckpointStore(str(dst))
    for i, (m, name, path) in enumerate(zip(members, names, paths)):
        want = {k: v.cpu() for k, v in m.state_dict().items()}
        for got in (imported.restore_params(name), torch.load(path)):
            if list(got) != list(want) or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"{name}: the round trip changed bits")
        if imported.manifest[name]["valid_loss"] != losses[i] \
                or not imported.manifest[name].get("imported"):
            raise AssertionError(f"{name}: manifest {imported.manifest[name]}")
    tree = TOOLS_ROOT / "ren_mme_tree"
    write_ren_mme_tree(tree, exp.model, np.random.default_rng(REAL_SEED))
    kernels = all_kernels()
    before = read_counts(kernels)
    accepted = TOOLS_ROOT / "acceptance_ren_mme.json"
    code, _ = run_cli(["acceptance", "ren_mme", "--data-root", tree,
                       "--checkpoint-dir", dst, "--impl", "pallas_fused",
                       "-o", accepted])
    fused = read_counts(kernels)["fused_block"] - before["fused_block"]
    rep = json.loads(accepted.read_text())
    if code != 0 or not rep.get("ok") or fused == 0:
        raise AssertionError(f"acceptance ren_mme: exit {code}, ok "
                             f"{rep.get('ok')}, {fused} fused_block launches")
    runs = {impl: pipelines.run_experiment(
                "ren_mme", synthetic_data=False, data_root=str(tree),
                checkpoint_dir=str(dst), epochs=0, impl=impl, quiet=True)
            for impl in ("pallas_fused", "xla")}
    got, ref = runs["pallas_fused"], runs["xla"]
    err = normalised_err(got.logits, ref.logits)
    th, idx = list(exp.thresholds), exp.emotion_index
    dec, dec_x = (apply_thresholds(r.logits, th, idx) for r in (got, ref))
    cols, cols_x = (np.stack([r.logits[:, i] for i in idx], 1)
                    for r in (got, ref))
    near = np.minimum(np.abs(cols - np.asarray(th)),
                      np.abs(cols_x - np.asarray(th))) < EXP_MARGIN
    unexplained = int(((dec != dec_x) & ~near).sum())
    same_metrics = rep["metrics"] == json.loads(json.dumps(got.report))
    report["tools"]["round_trip"] = {
        "members": names, "files": [str(p) for p in paths],
        "fused_block_launches": fused, "logit_err": err,
        "decision_flips": int((dec != dec_x).sum()),
        "unexplained_flips": unexplained, "decisions": int(dec.size),
        "metrics_equal": same_metrics, "micro_f1": got.report["micro_f1"]}
    log(f"[tools] ren_mme export-torch -> import-torch: {len(names)} members "
        f"bit-equal; acceptance at pallas_fused ok ({fused} fused_block "
        f"launches, micro F1 {got.report['micro_f1']:.6f}); ensemble logits "
        f"{err:.2e} from xla (bound {EXP_LOGIT_TOL:g}), "
        f"{int((dec != dec_x).sum())} of {dec.size} decisions differ, "
        f"{unexplained} of them {EXP_MARGIN:g} or more from the threshold; "
        f"{smi}")
    if err > EXP_LOGIT_TOL or unexplained or not same_metrics:
        raise AssertionError("ren_mme acceptance against xla: "
                             f"{report['tools']['round_trip']}")


def tools_golden_demo(torch, report, smi):
    """robot_demo: TOOLS_MEMBERS seeded members with their gates set, saved
    to a store; `acceptance` over a written robot tree at pallas; the
    clips' unrounded probabilities at pallas against xla (ROBOT_TOL), and
    the report's rounded ones equal to the pallas ones rounded."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch import configs, pipelines
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.serve import StreamingPredictor
    from multimodal_emotion_processing_tpu_torch.train.checkpoint import CheckpointStore

    exp = configs.get("robot_demo")
    tree, ck = TOOLS_ROOT / "robot_tree", TOOLS_ROOT / "robot_store"
    rng = np.random.default_rng(REAL_SEED)
    write_ren_tree(tree, rng, exp.model.l_dim)
    write_robot_tree(tree, exp.model, rng)
    members = [build_model(exp, seed=i) for i in range(TOOLS_MEMBERS)]
    set_gates(torch, members)
    store = CheckpointStore(str(ck))
    for i, m in enumerate(members):
        store.save_params(f"robot_demo_{i + 1}", m, valid_loss=1.3 + i / 100,
                          imported=False)
    kernels = all_kernels()
    before = read_counts(kernels)
    accepted = TOOLS_ROOT / "acceptance_robot.json"
    code, _ = run_cli(["acceptance", "robot_demo", "--data-root", tree,
                       "--checkpoint-dir", ck, "--impl", "pallas",
                       "--demo-clips", *TOOLS_DEMO_CLIPS, "-o", accepted])
    scored = read_counts(kernels)["scored_fwd"] - before["scored_fwd"]
    rep = json.loads(accepted.read_text())
    if code != 0 or not rep.get("ok") or scored == 0:
        raise AssertionError(f"acceptance robot_demo: exit {code}, ok "
                             f"{rep.get('ok')}, {scored} scored_fwd launches")
    samples, _, ctx = pipelines.load_real_data(exp, str(tree))
    by_name = {ctx["names"][int(s["name_idx"])]: s for s in samples}
    probs = {impl: {c: StreamingPredictor(members, exp.thresholds, impl=impl)
                    .predict(by_name[c])[1] for c in TOOLS_DEMO_CLIPS}
             for impl in ("pallas", "xla")}
    err = max(float(np.abs(probs["pallas"][c] - probs["xla"][c]).max())
              for c in TOOLS_DEMO_CLIPS)
    rounded = all(rep["golden_demo"]["clips"][c][n] == round(float(p), 2)
                  for c in TOOLS_DEMO_CLIPS
                  for n, p in zip(exp.emotion_names, probs["pallas"][c]))
    report["tools"]["golden_demo"] = {
        "clips": rep["golden_demo"]["clips"], "max_prob_err": err,
        "scored_fwd_launches": scored, "rounded_equal": rounded}
    log(f"[tools] robot_demo acceptance at pallas ({scored} scored_fwd "
        f"launches): golden demo {rep['golden_demo']['clips']}; "
        f"probabilities {err:.2e} from xla (bound {ROBOT_TOL:g}); {smi}")
    if err > ROBOT_TOL or not rounded:
        raise AssertionError(f"golden demo: {report['tools']['golden_demo']}")


def remat_gradients(torch, report, smi):
    """mosei_trans_s1024 (flash, bf16), one eager step at B TRAIN_BATCH from
    the same weights and batch with remat off and on: the step-1 gradients,
    the peak memory the step added and each kernel's launches."""
    import dataclasses

    from multimodal_emotion_processing_tpu_torch import configs
    from multimodal_emotion_processing_tpu_torch.data.loader import Batcher, to_device
    from multimodal_emotion_processing_tpu_torch.data.synthetic import synthetic_dataset
    from multimodal_emotion_processing_tpu_torch.models import build_model
    from multimodal_emotion_processing_tpu_torch.train import engine

    exp = configs.get("mosei_trans_s1024")
    batch = to_device(next(iter(Batcher(synthetic_dataset(
        exp.name, exp.model, TRAIN_BATCH, seed=3), TRAIN_BATCH,
        shuffle=False)())), "cuda")
    kernels = all_kernels()
    rows, grads = {}, {}
    for remat in (False, True):
        e = dataclasses.replace(exp, model=dataclasses.replace(
            exp.model, remat=remat))
        model = build_model(e, seed=0).train()
        params = list(model.parameters())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts(kernels)
        loss = engine.batch_loss(model, e.train, batch, impl="flash")
        g = torch.autograd.grad(loss, params, allow_unused=True)
        torch.cuda.synchronize()
        after = read_counts(kernels)
        rows[remat] = {"peak_bytes": torch.cuda.max_memory_allocated() - base,
                       "loss": float(loss.detach()),
                       "launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}
        grads[remat] = [None if x is None else x.float().cpu() for x in g]
        del model, params, loss, g
        torch.cuda.empty_cache()
    equal = worst = 0
    for a, b in zip(grads[True], grads[False]):
        if a is None and b is None:
            continue
        if torch.equal(a, b):
            equal += 1
        else:
            worst = max(worst, float((a - b).abs().max())
                        / max(1.0, float(b.abs().max())))
    n = sum(b is not None for b in grads[False])
    out = {"off": rows[False], "on": rows[True], "tensors": n,
           "bit_equal_tensors": equal, "max_norm_err": worst,
           "loss_equal": rows[True]["loss"] == rows[False]["loss"]}
    report["tools"]["remat"] = out
    log(f"[tools] remat at mosei_trans_s1024 (flash, bf16, B {TRAIN_BATCH}, "
        f"one eager step): step-1 gradients {equal} of {n} tensors bit-equal"
        f", the rest within {worst:.2e} (bound {REMAT_GRAD_TOL:g}), loss "
        f"equal {out['loss_equal']}; peak memory the step added "
        f"{rows[False]['peak_bytes'] / 2**30:.3f} GiB off, "
        f"{rows[True]['peak_bytes'] / 2**30:.3f} GiB on; launches a step "
        f"off {rows[False]['launches']}, on {rows[True]['launches']}; {smi}")
    fwd_off = rows[False]["launches"].get("flash_fwd", 0)
    if (worst > REMAT_GRAD_TOL or not out["loss_equal"]
            or rows[True]["launches"].get("flash_fwd", 0) != 2 * fwd_off
            or not fwd_off):
        raise AssertionError(f"remat: {out}")


def tools_tune(torch, report, smi):
    """`tune` at TOOLS_TUNE_ARGS: the record, no arm in error; then the
    remat gradient check.  Returns the record's path."""
    path = TOOLS_ROOT / "tuned_s1024.json"
    t0 = time.perf_counter()
    rec, _ = run_cli(["tune", *TOOLS_TUNE_ARGS, "-o", path])
    wall = time.perf_counter() - t0
    report["tools"]["tune"] = rec
    errors = {k: v for k, v in rec["measured"].items()
              if isinstance(v, dict) and "error" in v}
    log(f"[tools] tune {' '.join(TOOLS_TUNE_ARGS)} in {wall:.1f} s: "
        f"measured {json.dumps(rec['measured'])}; winners "
        f"{rec['winners']}; {rec['device']}, {rec['power_limit']}")
    if errors:
        raise AssertionError(f"tune arms in error: {errors}")
    remat_gradients(torch, report, smi)
    return path


def tools_train(torch, report, smi, tuned):
    """Short trains through `cli train`: mosei_trans_s1024 with --tuned (the
    applied knobs logged), mosei_trans at pallas_fused with --profile-dir
    (the traces exist and name fused_block), and with --debug-nans and a
    NaN in one training feature (it must raise, naming the module)."""
    import numpy as np

    from multimodal_emotion_processing_tpu_torch import cli, pipelines
    from multimodal_emotion_processing_tpu_torch.bench.autotune import apply_tuned

    out = report["tools"]["train"] = {}
    argv = ["train", "mosei_trans_s1024", "--tuned", tuned, *TOOLS_TRAIN_ARGS]
    applied = apply_tuned(cli.build_parser().parse_args(
        [str(a) for a in argv]), str(tuned))
    t0 = time.perf_counter()
    res, _ = run_cli(argv)
    out["tuned"] = {"applied": applied, "wall_s": time.perf_counter() - t0,
                    "valid_losses": [h[-1].valid_loss
                                     for h in res.fold_histories]}
    log(f"[tools] train mosei_trans_s1024 --tuned: applied {applied}; "
        f"{out['tuned']}")
    if not all(np.isfinite(out["tuned"]["valid_losses"])):
        raise AssertionError(f"tuned train: {out['tuned']}")

    prof = TOOLS_ROOT / "profile"
    run_cli(["train", "mosei_trans", "--impl", "pallas_fused",
             "--profile-dir", prof, *TOOLS_TRAIN_ARGS])
    traces = sorted(prof.glob("*.json"))
    named = [p.name for p in traces if "fused_block" in p.read_text()]
    out["profile"] = {"traces": [p.name for p in traces],
                      "bytes": [p.stat().st_size for p in traces],
                      "naming_fused_block": named}
    log(f"[tools] train mosei_trans --profile-dir: {len(traces)} traces "
        f"({out['profile']['bytes']} bytes), {len(named)} naming fused_block")
    if not traces or len(named) != len(traces):
        raise AssertionError(f"--profile-dir: {out['profile']}")

    synthetic = pipelines._synthetic_data

    def poisoned(exp, n_train, n_test, seed=0):
        train, test = synthetic(exp, n_train, n_test, seed)
        train[0]["l"][1, 3, 7] = np.nan
        return train, test

    pipelines._synthetic_data = poisoned
    try:
        run_cli(["train", "mosei_trans", "--impl", "pallas_fused",
                 "--debug-nans", *TOOLS_TRAIN_ARGS])
    except FloatingPointError as e:
        out["debug_nans"] = str(e)
    else:
        raise AssertionError("--debug-nans: a NaN feature trained without "
                             "an error")
    finally:
        pipelines._synthetic_data = synthetic
    log(f"[tools] train mosei_trans --debug-nans with a NaN feature raised: "
        f"{out['debug_nans']}")
    if "unify_dimension.linguistic" not in out["debug_nans"]:
        raise AssertionError("--debug-nans named another module")


def phase_tools(torch, report):
    """Phase tools: doctor, summary, the export/import round trip and
    acceptance at ren_mme, the robot golden demo, tune at s1024 with the
    remat check, and the short trains with --tuned, --profile-dir and
    --debug-nans.  Every kernel counted over the whole phase; each must
    have launched.  Returns the counts."""
    import shutil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["tools"] = {}
    smi = nvidia_smi_line()
    shutil.rmtree(TOOLS_ROOT, ignore_errors=True)
    TOOLS_ROOT.mkdir(parents=True)
    t0 = time.perf_counter()
    kernels = all_kernels()
    reset_counts(kernels)
    tools_doctor(torch, report, smi)
    tools_summary(torch, report, smi)
    tools_round_trip(torch, report, smi)
    tools_golden_demo(torch, report, smi)
    tuned = tools_tune(torch, report, smi)
    tools_train(torch, report, smi, tuned)
    launches = read_counts(kernels)
    report["tools"]["wall_s"] = time.perf_counter() - t0
    report["tools"]["launches"] = launches
    log(f"[tools] phase wall {report['tools']['wall_s']:.1f} s; launches "
        f"{launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels of the tools' paths never launched: "
                             f"{missing}")
    shutil.rmtree(TOOLS_ROOT, ignore_errors=True)
    return launches


KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "scored_fwd",
                "scored_bwd_dq", "scored_bwd_dkv", "fused_block")


def _kernel_category(name: str) -> str:
    low = name.lower()
    for kernel in KERNEL_NAMES:
        if kernel in low:
            return kernel
    if "memcpy" in low or "memset" in low:
        return "copies"
    # cuBLAS's GEMMs on Hopper are named nvjet_* (seen in this script's
    # profile), older ones *gemm* / cutlass / xmma
    if any(t in low for t in ("nvjet", "gemm", "cutlass", "xmma")):
        return "gemm"
    # the optimizer's _foreach ops (multi_tensor_apply) and _foreach_norm's
    # cleanup pass
    if "multi_tensor_apply" in low or "lpnorm" in low:
        return "optimizer"
    return "other"


def profile_breakdown(torch, fn, reps: int = 3):
    """Device time by kernel category, host wall time and the device's idle
    share over `reps` calls of fn, from torch.profiler's CUDA kernel events.
    Reported as not measured where the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_cat, by_kernel, n_kernels = {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        cat = _kernel_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3 / reps
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us / 1e3 / reps
        n_kernels += 1
    busy = sum(by_cat.values())
    out = {"wall_ms": wall_ms, "reps": reps}
    if busy <= 0.0:
        out["device"] = "not measured: the profiler recorded no device time"
        log(f"[profile] wall {wall_ms:.2f} ms; device time not measured")
        return out
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    out.update(device_busy_ms=busy, device_idle_share=max(0.0, 1 - busy / wall_ms),
               launches_per_call=n_kernels / reps, by_category_ms=by_cat,
               top_kernels_ms=dict(top))
    log(f"[profile] wall {wall_ms:.2f} ms/call, device busy {busy:.2f} ms "
        f"(idle share {out['device_idle_share']:.3f}), "
        f"{n_kernels / reps:.0f} device ops/call; by category "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_cat.items())))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from multimodal_emotion_processing_tpu_torch.utils import native

    report = {}
    failed = []
    smi = nvidia_smi_line()
    log(f"[device] {smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    sources = sorted(p.stem for p in native.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    built = native.build(sources)
    report["build_s"] = time.perf_counter() - t0
    report["build"] = built
    log(f"[device] built {sources} in {report['build_s']:.1f} s")
    for name, info in built.items():
        kernels = ptxas_kernels(info["ptxas"])
        info["kernels"] = kernels
        log(f"[device] {name}: registers / bytes spilled per kernel: "
            + ", ".join(f"{k} {r}/{sp}" for k, r, sp in kernels))
    tensor_cores = {}
    for name in ("flash_fwd", "flash_bwd"):
        counts = tensor_core_counts(built[name]["path"])
        tensor_cores[name] = counts
        if not counts:
            log(f"[device] {name}: tensor-core instructions not measured "
                "(no cuobjdump)")
            continue
        mma = {fn: n for fn, n in counts.items() if "mma_kernel" in fn}
        log(f"[device] {name}: {sum(counts.values())} HMMA/HGMMA instructions "
            f"in cuobjdump -sass, {sum(mma.values())} of them in the "
            f"{len(mma)} bf16 tensor-core kernels, "
            f"{sum(counts.values()) - sum(mma.values())} in the other "
            f"{len(counts) - len(mma)}")
        if not mma or min(mma.values()) == 0:
            failed.append("device")
            log(f"[device] FAIL: a bf16 flash kernel of {name} has no "
                "tensor-core instruction")
    # the score-chained libraries: every kernel runs every product as
    # split-TF32 mma.sync, without spilling
    for name in ("scored_fwd", "scored_bwd", "fused_block"):
        counts = tensor_core_counts(built[name]["path"])
        tensor_cores[name] = counts
        # the dh-256 bucket (no model's head width) may spill a few bytes
        spilled = [(k, sp) for k, _, sp in built[name]["kernels"]
                   if sp and ",256" not in k]
        log(f"[device] {name}: "
            + (f"{sum(counts.values())} HMMA instructions in cuobjdump -sass "
               f"over its {len(counts)} kernels, fewest "
               f"{min(counts.values())}" if counts
               else "tensor-core instructions not measured (no cuobjdump)")
            + f"; {len(spilled)} kernels spill up to dh 128")
        if counts and min(counts.values()) == 0:
            failed.append("device")
            log(f"[device] FAIL: a kernel of {name} has no tensor-core "
                "instruction")
        if (name == "fused_block" and counts
                and sum(counts.values()) <= FUSED_SCORE_DOTS_HMMA):
            failed.append("device")
            log(f"[device] FAIL: fused_block has {sum(counts.values())} HMMA "
                f"instructions, no more than its score dots alone "
                f"({FUSED_SCORE_DOTS_HMMA}): P.V or the epilogue is off the "
                "tensor cores")
        if spilled:
            failed.append("device")
            log(f"[device] FAIL: {name} spills: {spilled}")
    report["tensor_core_instructions"] = tensor_cores

    summaries, launches = None, {}
    for phase, fn in (("kernels", phase_kernels), ("train", phase_train),
                      ("serve", phase_serve), ("serve_robot", phase_serve_robot),
                      ("train_realformer", phase_train_realformer),
                      ("serve_paragraph", phase_serve_paragraph),
                      ("train_fused", phase_train_fused),
                      ("serve_ren_mme", phase_serve_ren_mme),
                      ("train_ren_mme", phase_train_ren_mme),
                      ("train_robot", phase_train_robot),
                      ("train_rencecps", phase_train_rencecps),
                      ("experiment", phase_experiment),
                      ("experiment_families", phase_experiment_families),
                      ("real_data", phase_real_data),
                      ("serve_io", phase_serve_io),
                      ("drivers", phase_drivers),
                      ("tools", phase_tools)):
        try:
            result = fn(torch, report)
        except Exception:
            traceback.print_exc()
            failed.append(phase)
            continue
        if phase == "kernels":
            summaries = result
        else:
            launches[phase] = result

    OUT_JSON.parent.mkdir(parents=True, exist_ok=True)
    report["failed_phases"] = failed
    OUT_JSON.write_text(json.dumps(report, indent=1, default=str))
    if failed:
        print(f"FAIL: phases {failed}", file=sys.stderr)
        return 1
    def experiment_paths(name):
        return {p: launches[p][name]
                for p in ("experiment", "experiment_families", "real_data",
                          "drivers", "tools")}

    def tc_count(library, kernel):
        return sum(n for fn, n in report["tensor_core_instructions"].get(
            library, {}).items() if kernel in fn)

    fa_py = "multimodal_emotion_processing_tpu/ops/flash_attention.py"
    pa_py = "multimodal_emotion_processing_tpu/ops/pallas_attention.py"
    kernels = []
    for name, source, replaces, also in (
            ("flash_fwd", "flash_fwd.cu", f"{fa_py}:208", [f"{fa_py}:431"]),
            ("flash_bwd_dq", "flash_bwd.cu", f"{fa_py}:568", [f"{fa_py}:321"]),
            ("flash_bwd_dkv", "flash_bwd.cu", f"{fa_py}:596", [f"{fa_py}:321"])):
        summ = summaries[name]
        by_path = {"train": launches["train"][name]}
        if name == "flash_fwd":
            by_path["serve"] = launches["serve"]
            by_path["serve_io"] = launches["serve_io"][name]
        by_path.update(experiment_paths(name))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"multimodal_emotion_processing_tpu_torch/csrc/{source}",
            "replaces": replaces, "also_replaces": also,
            "instruction": f"{FLASH_MMA} for every product in bf16 up to dh "
                           "128; scalar f32 FMA in f32 and at dh 129-256",
            "tensor_core_instructions": sum(
                n for fn, n in report["tensor_core_instructions"].get(
                    source.removesuffix(".cu"), {}).items()
                if name.removeprefix("flash_") + "_mma_kernel" in fn),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": summ["max_abs_err"],
            "ms": summ["ms"], "plain_ms": summ["plain_ms"],
            "bound_ms": summ["bound_ms"], "bound_by": summ["bound_by"],
            "library_ms": summ["library_ms"],
            "timed_at": (f"sum over the nine s1024 stream shapes, B={SERVE_BUCKET}, bf16"
                         if name == "flash_fwd" else
                         f"sum over the nine s1024 stream shapes, B={TRAIN_BATCH}, "
                         "bf16; plain_ms (flash_backward_plain) and library_ms "
                         "(SDPA forward+backward minus forward) cover the whole "
                         "backward, dq, dk and dv")})
    summ = summaries["scored_fwd"]
    by_path = {"serve_robot": launches["serve_robot"],
               "train_realformer": launches["train_realformer"]["scored_fwd"],
               "serve_paragraph": launches["serve_paragraph"],
               "train_ren_mme": launches["train_ren_mme"]["scored_fwd"],
               "train_robot": launches["train_robot"]["scored_fwd"],
               "serve_io": launches["serve_io"]["scored_fwd"],
               **experiment_paths("scored_fwd")}
    kernels.append({
        "name": "scored_fwd", "route": "cuda",
        "source": "multimodal_emotion_processing_tpu_torch/csrc/scored_fwd.cu",
        "replaces": f"{pa_py}:190", "instruction": SCORED_INSTRUCTION,
        "tensor_core_instructions": tc_count("scored_fwd", "scored_fwd_kernel"),
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": summ["max_abs_err"],
        "max_score_rel_err": summ["max_score_rel_err"],
        "ms": summ["ms"], "device_ms": summ["device_ms"],
        "plain_ms": summ["plain_ms"],
        "bound_ms": summ["bound_ms"], "bound_by": summ["bound_by"],
        "library_ms": summ["library_ms"],
        "timed_at": (f"sum over the {summ['calls_timed']} calls of one "
                     f"robot_demo member forward (nine stream shapes x two "
                     f"chained blocks), B={SERVE_BUCKET}, f32; ms by CUDA "
                     "events around the wrapper's calls (host launch cost "
                     "included), device_ms the kernel's own time from "
                     "torch.profiler; library_ms is SDPA with the float bias c*S_prev - 1e8(1-mask), which "
                     "computes ctx and writes no S")})
    for name in ("scored_bwd_dq", "scored_bwd_dkv"):
        summ = summaries[name]
        by_path = {"train_realformer": launches["train_realformer"][name],
                   "train_fused": launches["train_fused"]["main"][name],
                   "train_fused_chained":
                       launches["train_fused"]["chained"][name],
                   "train_ren_mme": launches["train_ren_mme"][name],
                   "train_robot": launches["train_robot"][name],
                   **experiment_paths(name)}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "multimodal_emotion_processing_tpu_torch/csrc/scored_bwd.cu",
            "replaces": f"{pa_py}:350", "instruction": SCORED_INSTRUCTION,
            "tensor_core_instructions": tc_count("scored_bwd", name + "_kernel"),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": summ["max_abs_err"],
            "max_norm_err": summ["max_norm_err"],
            **{k: v for k, v in summ.items() if k.endswith("_term_scale_err")},
            "ms": summ["ms"], "device_ms": summ["device_ms"],
            "plain_ms": summ["plain_ms"],
            "bound_ms": summ["bound_ms"], "bound_by": summ["bound_by"],
            "library_ms": summ["library_ms"],
            "pair_ms": summaries["scored_bwd_pair"]["ms"],
            "pair_mosei_trans": summaries["scored_bwd_pair"]["mosei_trans"],
            "timed_at": (f"sum over the {summ['calls_timed']} calls of one "
                         f"mosei_realformer train step (nine 50x50 stream "
                         f"shapes x two chained blocks), B={RF_CLIPS} clips, "
                         "f32; ms by CUDA events around the kernel's launch "
                         "on inputs checked once, pair_ms around the "
                         "scored_backward_kernel wrapper (checks and both "
                         "launches), device_ms from torch.profiler; plain_ms "
                         "(scored_backward_plain) and library_ms (SDPA "
                         "forward+backward minus forward with the float bias "
                         "c*S_prev - 1e8(1-mask); no dS_prev, no dc) cover "
                         "the whole backward")})
    summ = summaries["fused_block"]
    by_path = {"train_fused": launches["train_fused"]["main"]["fused_block"],
               "train_fused_chained":
                   launches["train_fused"]["chained"]["fused_block"],
               "serve_ren_mme": launches["serve_ren_mme"],
               "train_ren_mme": launches["train_ren_mme"]["fused_block"],
               "serve_io": launches["serve_io"]["fused_block"],
               **experiment_paths("fused_block")}
    train = summ["train"]
    kernels.append({
        "name": "fused_block", "route": "cuda",
        "source": "multimodal_emotion_processing_tpu_torch/csrc/fused_block.cu",
        "replaces": "multimodal_emotion_processing_tpu/ops/fused_block.py:109",
        "instruction": SCORED_INSTRUCTION + "; launched as thread-block "
                       "clusters of min(H, 8) blocks, one per head, ctx and "
                       "x exchanged through distributed shared memory",
        "tensor_core_instructions": tc_count("fused_block", "fused_block_kernel"),
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        "max_abs_err": summ["max_abs_err"],
        "max_score_rel_err": summ["max_score_rel_err"],
        "scores_equal_scored_fwd": summ["scores_equal_scored_fwd"],
        "ms": train["ms"], "device_ms": train["device_ms"],
        "plain_ms": train["plain_ms"],
        "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
        "bound_split_tf32_ms": train["bound_split_tf32_ms"],
        "library_ms": train["library_ms"],
        "bwd_ms": train["bwd_ms"], "plain_bwd_ms": train["plain_bwd_ms"],
        "stats_m_equal_scored_fwd": summ["stats_m_equal_scored_fwd"],
        "max_stats_l_rel_err": summ["max_stats_l_rel_err"],
        "repeat_bits_equal": summ["repeat_bits_equal"],
        "blocks": train["blocks"],
        "serve": summ["serve"],
        "timed_at": (f"sum over the {train['calls_timed']} mosei_trans stream "
                     f"shapes (one grid of a train step's forward), B={MT_BATCH},"
                     " f32, as the train step calls it (no S_prev, no S, the "
                     "ctx residual written); ms by CUDA events around the "
                     "wrapper's calls, device_ms from torch.profiler; "
                     "library_ms is a composite, SDPA with the float bias "
                     "-1e8(1-mask) then F.linear and F.layer_norm timed as one "
                     "sequence (no single PyTorch call computes the block; it "
                     "writes no S); bwd_ms the backward through FusedMinusBlock "
                     "(scored_bwd kernels + plain epilogue products), "
                     "plain_bwd_ms autograd through fused_block_plain; "
                     "bound_ms at 67 TFLOP/s of scalar f32, "
                     "bound_split_tf32_ms at 495/3 TFLOP/s, the rate of the "
                     "kernel's split-TF32 products; blocks per launch; serve: "
                     f"the same sums over the nine ren_mme shapes at "
                     f"B={SERVE_BUCKET}, no ctx residual")})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
