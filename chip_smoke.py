#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rtm3d_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py    # from the repository root
    python3 chip_smoke.py --kernel-ab DIR [--check-only] [--out FILE]

With no arguments it drives the port's main paths and checks them, in
phases of one JSON line each; any failure exits non-zero:
  device   the card (nvidia-smi name and power limit), torch and CUDA versions;
  build    compiles rtm3d_tpu_torch/csrc/*.cu (nvcc, one process per source)
           and fails if ptxas reports a spill store or load in any kernel,
           or if a conv_s8 kernel's SASS (cuobjdump) holds no warpgroup MMA
           (GMMA); then the host C++ libraries, csrc/geometry.cc (the AP
           evaluator's overlap) and csrc/preproc.cc (the fused warp) (c++);
  lm_*     the LM kernel against its plain PyTorch version on the card at
           the detect path's lane counts (M = 25,600 and 38,400 for batch
           128 x top-K 100, the second call's third init being the first
           call's solution), accept-mask agreement >= 99.9% and, where both
           accept, cost within 1e-3 on >= 99.9% (per lane at the prior, per
           detection without it), CUDA-event times and the fp32 bound, the
           launch geometry (threads per detection, block size, blocks);
  logits   full-width DLA-34 1280x384 fp32 forward, port on the GPU against
           the port on the CPU (TF32 off), max |d| <= 1e-4 of max |logit|;
  serve    DLA-34 1280x384 batch 128 bf16 detect through Detector, distinct
           uint8 frames per call, a KITTI K: exactly 2 LM launches and 2
           KFPN fusion launches per call, finite outputs of the right shapes, images/s from CUDA events;
  profile  torch.profiler over two serving calls: device time by kernel,
           idle share; the full table goes to chip_smoke_out/serve_profile.json;
  splat    the heatmap splat kernel against its plain PyTorch version at the
           training path's shape (B 32, N 64, C 3, 96x320, the inputs
           build_targets makes from the train batch) and on an edge batch
           (centers off the map, R = 0, an all-masked image, noise slots, two
           classes on one center): max |d| <= 1e-6 and the same pixels equal
           to 1.0; CUDA-event times, bytes, operations and the bound, the
           mean live slots per tile;
  kfpn_fuse  the KFPN fusion kernel (csrc/kfpn_fuse.cu) at the detect
           path's maps, x0 and three upsampled maps of 256 x 104 x 320
           (1280x416 at stride 4) in bf16, channels_last, at b32 and b1:
           its error against the float64 fusion no larger than PyTorch's
           bf16 composition's (max and mean), z channels_last, two runs
           bit-equal, two launches a call; CUDA-event ms of the kernel, of
           the plain version (kfpn_fuse_reference) and of the composition,
           each pass's device ms (torch.profiler), the bytes and the bound
           at 3.35 TB/s;
  dcn      the DCN kernel (csrc/dcn.cu) at ResNet-101-DCN's layer shapes at
           1280x416 b32 bf16 (256 x 26 x 80 and 512 x 13 x 40, channels_last),
           at the init's offsets (0.1 px) and at 2 px RMS: every output
           within a bf16 ulp of the plain version (dcn_reference), give or
           take a tap rounded the other way (2e-3 of the largest output),
           the mean gap under 1e-5 of the largest, two runs bit-equal, one
           launch a call; CUDA-event ms of the kernel and of the plain
           version, the operations and the bound at 989 TFLOP/s; then one
           b32 bf16 ResNet-101-DCN detect call through Detector at
           1280x416: 26 kernel launches and 2 KFPN fusion launches, finite
           outputs, its ms and peak memory;
  train_fp32  DLA-34 384x128 batch 2 fp32 (TF32 off), one make_train_step on
           the GPU against the same step on the CPU, same seed-0 weights and
           batch: loss and aux within 1e-4 relative, gradients within
           this network's float32 noise floor (whole gradient <= 5e-2 and
           each tensor <= 1e-1 relative in L2; on the CPU float32 against
           float64 differs by 0.95% and at most 1.3%, GPU against CPU by
           2.1% and 3.2% on the H100);
  train    configs/rtm3d_dla34_kitti_tpu.yaml's model and solver at full
           width, DLA-34 1280x384 (tools/bench_train.py's frame shape)
           batch 32 bf16 autocast, EMA, MAX_OBJS 64,
           synthetic uint8 frames and label blocks (a quarter of the slots
           masked, a tenth noise): 3 warm-up steps, 10 timed steps on
           distinct batches, 2 eval-loss steps; finite loss and aux, one
           splat launch per step and no KFPN fusion launch; then 20 steps on one batch with
           WARMUP_ITERS 0, whose loss must fall; images/s, ms per step and
           peak memory;
  train_profile  torch.profiler over two train steps, the table to
           chip_smoke_out/train_profile.json;
  remat    TPU.REMAT (nn/layers.py::remat_segment): remat_check, one DLA-34
           384x128 b2 fp32 step with REMAT against the same step without,
           TF32 off and deterministic algorithms, the loss, aux and each
           gradient within REMAT_GATE_REL; then the train phase's config
           and shape with REMAT, 10 timed steps: ms a step and peak memory
           beside the train phase's, one splat launch a step, and the peak
           below the train phase's;
  bench    python -m rtm3d_tpu_torch.tools.bench (DLA-34 1280x384 b128
           bf16, images/s) and --b1 (p50 ms of 30 batch-1 calls), each
           tool's JSON line as it prints it: 2 LM launches a call, finite
           outputs;
  latency  python -m rtm3d_tpu_torch.tools.bench_latency: DLA-34 bf16 at b1,
           8 and 32, the same with --int8, ResNet-18 fp32 at b1 and 8, 30
           calls each, p50/p90/p99 from CUDA events (reports to
           chip_smoke_out/latency_*.json): 2 LM launches a call, and 52
           quantize and conv_s8 launches an int8 call;
  data     training from files through ``python -m rtm3d_tpu_torch.cli.train``
           (``cli.train.main``, in this process): the port's generator
           writes a KITTI-layout tree of 128 train and 20 test frames of
           375x1242 (KITTI's size) under chip_smoke_out/data (data_tree);
           configs/rtm3d_dla34_kitti_tpu.yaml, overriding only the data
           path, the weights dir, CHECKPOINT_MODE start and MAX_EPOCH 2:
           DLA-34 1280x416 b32 bf16, EMA, 4 workers, device warp and device
           cache (train_cli_device); a resume to MAX_EPOCH 3 that must
           restore every tensor bit-equal before its first step, start at
           epoch 2 and leave the pointer on its last save (resume);
           configs/rtm3d_dla34_kitti.yaml for 1 epoch of 8 steps, fp32 b16,
           host augmentation (train_cli_host). After each mode's run, a
           few batches built in this process: the host's ms for each
           (data_*_parent), the splat against its plain version on the
           first one's labels (splat_data_shape_device: B 32, 104x320;
           splat_data_shape_host: B 16), and torch.profiler over two steps
           on it (data_profile, data_profile_host; the tables to
           chip_smoke_out/), whose kernel time gives the device's idle
           share over the run's last epoch. Gates: finite losses,
           img_size [1280, 416], one splat launch per train and eval
           batch, the splat as in the splat phase.
  detect_cli  detect and evaluate from files (``cli.detect.main``,
           ``cli.evaluate.main``, in this process) on the data phase's tree
           with the device-mode run's last checkpoint (its EMA):
           detect_cli_device, configs/rtm3d_dla34_kitti_tpu.yaml as it stands
           (bf16, device warp, 4 workers) over the 128 train frames at batch
           32, the checkpoint's vertex head set to draw a car
           DEVICE_CAR_DEPTH m ahead on the row where a pilot run (the car on
           the optical axis) finds the network's peaks (so that the LM
           converges and accepts lanes): device and wall images/s, each batch's call and the loop's
           wait for it; gates: a result file per frame, img_size [1280, 416],
           2 KFPN fusion launches and 2 LM launches per batch, each LM launch on its own lanes (M = 6,400
           and 9,600) with at least one lane accepted, against the plain LM
           as in the lm phases (accept decisions, accepted costs); then those
           shapes on synthetic lanes (lm_M6400_prior20, lm_M9600_prior0).
           detect_cli_parity,
           configs/rtm3d_dla34_kitti.yaml (fp32, TF32 off, host resampling),
           4 test frames at batch 3, the score and residual thresholds lifted
           and the checkpoint's vertex head set to draw a car (so the LM
           converges), on the card and on the CPU: the lines matched by
           (class, 2D box) within PARITY_GATE; witnesses on the card, the
           plain LM in the kernel's place (the kernel's lines within
           PARITY_GATE of its) and the kernel run wrong on purpose (no
           prior, half the prior, 2 and 4 iterations), each of which must
           leave PARITY_GATE. evaluate, ``--skip-detect``
           over the test split: the parity run's results and the ground
           truth written as results (score 1.0); gates: 36 finite keys, 100
           on every key with a valid ground-truth box, the same table with
           the plain overlap; the seconds of each.
  int8_kernel  the int8 kernels (csrc/int8_conv.cu: quantize, conv_s8) on
           every distinct conv shape of full-width DLA-34 at 1280x416
           (configs/rtm3d_dla34_kitti_tpu.yaml; a meta-device forward finds
           them, the 2 dead projections included): at batch 2, per-tensor
           and per-channel scales, fp32 and bf16 inputs, bit-equal to the
           plain versions (ops/int8_conv.py); at batch 32 in bf16 with a
           per-tensor scale, bit-equal again, and CUDA-event times of the
           kernels, the plain versions, F.unfold + torch._int_mm and
           cuDNN's bf16 conv, and the bound (int8 ops at 1,979 TOP/s or
           bytes at 3.35 TB/s), summed over the 52 convs one served
           forward runs int8; each row names the kernel variant its shape
           takes (ops/int8_conv.py::conv_variant); then ResNet-18's conv
           shapes that DLA-34 lacks (configs/rtm3d_resnet18_kitti.yaml) at
           batch 2, bit-equal again, untimed;
  int8_logits  DLA-34 1280x416 b2 under configs/rtm3d_dla34_kitti.yaml
           (fp32, TF32 off), mse scales, the int8 network on the card and
           on the CPU: conv by conv, each int8 conv's own input on the card
           through the CPU's plain versions gives the card's int8 input and
           output bit for bit, and witnesses made wrong on purpose
           (truncation, weight scales per input channel) must break that
           (half-away-from-zero rounding is reported); free-running,
           finite logits, and reported: the share of conv inputs that
           quantize equally and each logit's gaps, beside int8's own gap
           from float;
  int8_cli cli.detect --int8 on the data phase's tree under the TPU config
           with detect_cli_device's weights: calibrate (mse, 2 batches) and
           save the scales, the gate line; again from the saved scales
           (byte-identical files); --int8-3d-anyway (2 LM launches a batch,
           each accepting lanes and held to the plain LM as in
           detect_cli_device); cli.evaluate --int8 --int8-guard 0.5
           over the test split (three finite tables; the guard's verdict is
           recorded); 52 quantize and conv_s8 launches per int8 call, 2
           KFPN fusion launches per forward of the three cli.detect runs
           (calibration's sweeps and the gate's steps included); the
           steady int8 call against the bf16 one at b32 (2D), and
           torch.profiler over two int8 calls (chip_smoke_out/int8_profile.json);
  fast_preproc, mosaic  the data phase's host-mode run again with
           DATASET.FAST_PREPROC (the fused host C++ warp, csrc/preproc.cc)
           and with IS_MOSAIC (on 4 loader workers): finite losses, one
           splat launch a step and eval batch, host ms a batch and wall
           img/s beside the cv2 run's;
  bench_train  python -m rtm3d_tpu_torch.tools.bench_train: step-only b32
           bf16, step-only b16 fp32 and --e2e on the data phase's tree at
           b16 with 4 loader workers (1280x416): one splat launch a step;
  real_parity  python -m rtm3d_tpu_torch.tools.real_parity, a dry run on the
           data phase's 20 test frames at min overlap 0.3 and min height
           0, with detect_cli_device's weights, top-K REAL_PARITY_TOPK,
           the int8 leg and a bootstrap (the report to chip_smoke_out/
           real_parity.json): 20 files and accepted detections on each
           leg, 27 cells on each grid, 2 LM launches a batch, 52 of each
           int8 kernel an int8 batch; each cell's port-minus-reference
           delta within REAL_PARITY_DELTA; the port's and the reference's
           lines, each way, with the same boxes and scores
           (REAL_PARITY_GATE); each leg's 3D boxes reprojected onto its 2D
           boxes within REAL_PARITY_GATE's reproj_px;
  resnet18 configs/rtm3d_resnet18_kitti.yaml as shipped (fp32, TF32 off,
           IS_RECT, so 1280x416 on these frames; pretrained with no file)
           on the data phase's tree: resnet18_train, cli.train.main for 1
           epoch at b16 (8 steps, 2 eval batches; gates as the data phase's
           runs, and that it trained from init), step ms and peak memory,
           the splat against its plain version on the first batch's labels;
           resnet18_detect, cli.detect.main over the 128 train frames at b16
           with no --checkpoint: DETECTOR.CHECKPOINT's .msgpack does not
           exist and the trained .pt beside it (its vertex head set as in
           detect_cli_device) must be served; gates: a result file per
           frame, 2 LM launches per batch, each held against the plain LM;
           export_detect_{decode,forward,decode_cpu_made}, cli.export.main
           of that .pt at b16 (with and without --with-decode on the card,
           and --with-decode on the CPU for --platforms cpu,cuda), each
           served by cli.detect.main --from-export: the model run's lines
           within PARITY_GATE, 2 LM launches per batch, export seconds and
           artifact MB; export_calls, the forward artifact's logits within
           1e-4 of the largest of the eager model's, and the first and
           steady detect call from each artifact beside the eager step's;
           stats, cli.stats.main --vis-targets over the train split: the
           JSON keys, 4 overlays, one splat launch each. torch.profiler
           over two train steps and two eager detect calls
           (resnet18_train_profile, resnet18_detect_profile; the tables to
           chip_smoke_out/).
  ddp_fp32 data parallelism (rtm3d_tpu_torch/parallel/dist.py): two rank
           processes of this script sharing the card over gloo (NCCL refuses
           two ranks on one device), DLA-34 384x128, global batch 4, fp32
           with TF32 off, lr DDP_FP32_LR, 3 steps, against one rank on the
           same batches in this process (DDP_GATE: each step's loss, step
           1's gradient; the parameters and BN statistics after 3 steps);
           the ranks' parameters hash equal after each step; a witness with
           the BatchNorm sync turned off must leave the gates;
  ddp_full two gloo ranks sharing the card at the train phase's full width
           (1280x384 bf16, EMA, MAX_OBJS 64), global batch 32, 3 warm-up and
           5 timed steps: finite losses equal on both ranks, one splat launch
           a rank a step, the splat against its plain version; per-rank ms a
           step, the gradient and a BN-sized all-reduce timed alone, peak
           memory a process (not a scaling figure);
  spatial  the spatial mesh axis (rtm3d_tpu_torch/parallel/spatial.py): two
           gloo ranks sharing the card as a 1 x 2 data x spatial grid of the
           TPU config's DLA-34, each on its band of every frame's rows,
           against one rank in this process: (i) fp32 (TF32 off) b2
           1280x384, 3 steps (DDP_GATE; the parameters within 2 x the
           summed learning rates; the ranks' hashes equal) and a zero-halo
           witness that must leave the gates; (iii) one fp32 step at
           1280x416, bands 224 + 192; (ii) b32 bf16, 2 warm-up and 5 timed
           steps: ms a rank step, the halo exchanges' collectives and MB a
           step, peak memory a process beside one rank's; one splat launch
           a rank a step, the splat against its plain version; whether gloo
           takes CUDA tensors in all_gather (not a scaling figure);
  ddp_cli  python -m torch.distributed.run --nproc-per-node 1 (NCCL, world
           size 1): cli.train --multihost on the data phase's tree (the TPU
           config, 1 epoch; the data phase's gates, its step spans beside the
           data phase's), and cli.detect on detect_cli_device's weights,
           whose result files must equal that run's;
  ap_parity_production  python -m rtm3d_tpu_torch.tools.ap_parity --production
           (run_production_parity) at the JAX record's recipe
           (docs/experiments/prod_r5_report.json: ResNet-18, input 512 on
           512x384 frames, b8, lr 1e-3, seed 20, 64 train frames served,
           no augmentation, the int8 leg, a bootstrap of 100), its 64
           train frames cut to AP_PROD["num_train"], its 10,000 steps to
           AP_PROD_STEPS and its 10x drops at 5,000 and 8,000 to
           AP_PROD_LR_DROPS (the last two phases; PARITY.md gives the drops,
           the JAX report does not), trained under TF32 and served with
           TF32 off, in a fresh work dir (the report to
           chip_smoke_out/ap_parity_production.json).
           Gates (AP_PROD_GATE): the last loss under a hundredth of the
           first; one splat launch a step, 2 LM launches a port and int8
           batch, one quantize and one conv_s8 launch an int8 conv an int8
           batch; each float leg accepts a quarter of the split's labelled
           Car/Pedestrian/Cyclist objects, the two float legs' counts
           within 25% of the larger, the int8 leg at least 1; Car bbox
           moderate non-zero on both float legs; no moderate cell's
           port-minus-reference delta below -10 points;
  ap_parity_tools  on that work dir: diag_same_weights, solver_tune on its
           rows, precision_ladder (fp32, tf32, bf16) and the int8_variants
           policy sweep (the summaries to chip_smoke_out/
           ap_parity_tools.json). Gates (AP_TOOLS_GATE): every candidate
           of each pipeline matched in the other; max |d score| <= 1e-3
           and max |d vertex| <= 0.05 px; gate flips at most 30% of the
           matched; solver_tune's deployed row equal to diag's LM costs
           within 1e-5; the ladder's fp32 rung writes results_port's lines;
           every int8_variants row with one of each int8 kernel an int8
           conv a batch and 2 LM launches a batch.
  ap_parity_side_by_side  python -m rtm3d_tpu_torch.tools.ap_parity (the
           side-by-side mode, run_ap_parity) at the JAX 100-step record's
           recipe (docs/experiments/ap_parity_100step_report.json: ResNet-18,
           input 256 on 256x192 frames, 64 train and 16 test frames, b8, lr
           1e-3, seed 20, 100 steps, drift over 50), in a fresh work dir:
           the port (TF32) and the seed-5 torch twin (fp32, the reference's
           loss and optimizer) trained from the twin's init on the same
           augmented batches, then the port, reference, int8 and samew legs
           (the report to chip_smoke_out/ap_parity_side_by_side.json).
           Gates (AP_SBS_GATE): both losses fall; the reference leg's first
           loss within a stated tolerance of the record's 1,218.7838; the
           JAX harness's drift bounds (drift[0] < 5e-3, the first 10 steps
           < 5e-2, every step < 0.5, the last losses within 25%); two
           splat launches a step (the port's step, the reference leg's
           target build); 2 LM launches a port, int8 and samew batch; one
           quantize and one conv_s8 launch an int8 conv an int8 batch. The
           twin's SHA-256 against the CPU's (tools/twin.py::TWIN_SHA256)
           is recorded: if it differs, the first loss is not comparable.
  The device line also carries a probe: NCCL's version, whether gloo takes
  CUDA tensors in all_reduce and broadcast, whether tensorstore and orbax
  import.
Then the seconds of each phase, the kernels line, the nvidia-smi line and,
last, {"ok": true, ...}. Needs one CUDA device; without one it exits
non-zero and prints no result.

With --kernel-ab it compares the CUDA kernels of another version of the
port with this one's instead, on the same card: DIR holds that version's
``rtm3d_tpu_torch`` package (from PR 2 on; for example ``git archive <rev>
rtm3d_tpu_torch | tar -x -C DIR``). Each version runs in a process of its
own that imports its package and goes through its public wrappers
(``lm_solve``, ``splat_heatmap``, ``quantize``, ``conv_s8``), in turns
old, new, new, old: ptxas's registers and spills, agreement with the plain
versions as above, the LM at M = 25,600 (prior 20) and 38,400 (prior 0)
with CUDA events, the splat at B 32, N 64, C 3, 96x320 with torch.profiler
device time (and, to show where its time goes, with every slot masked out,
beside a PyTorch fill of the same output), and the int8 kernels on each
distinct conv shape a served DLA-34 forward runs int8, at b32 1280x416 in
bf16 (each version packs its weights with its own pack_weight and is held
bit-equal to its own plain versions), with CUDA events, per shape and
summed over the forward beside the bound. Then the SASS of each LM
kernel's iteration loop and of each conv kernel by opcode (cuobjdump,
where the toolkit has it). --check-only runs each version once, untimed.
A line per record; all of them go to FILE (chip_smoke_out/kernel_ab.json).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from rtm3d_tpu_torch.utils.measure import (
    BATCH, FRAME_H, FRAME_W, ITERS, K_KITTI, PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS, PEAK_INT8_OPS, TOPK,
    TRAIN_BATCH, TRAIN_OBJS, compare_result_dirs, cuboid_vertex_bias, cuda_time_ms, graph_device_ms, int_mm_conv,
    kernel_device_ms, lm_agreement, nvidia_smi, reprojection_px, splat_edge_inputs, state_tensors, synthetic_labels,
    synthetic_lanes, unequal,
)

H, W = FRAME_H, FRAME_W
SERVE_CALLS = 6
LM_REPLACES = "rtm3d_tpu/ops/lm_solver.py:35"
SPLAT_REPLACES = "rtm3d_tpu/ops/splat.py:26"
DATA_TRAIN, DATA_TEST, KITTI_HW = 128, 20, (375, 1242)  # frames of the data phase's tree
KITTI_RECT = [1280, 416]  # IS_RECT's input on KITTI-sized frames
TRAIN_WARMUP, TRAIN_TIMED, LOSS_FALL_STEPS = 3, 10, 20
AB_LM_REPS, AB_SPLAT_REPS, AB_INT8_REPS = 20, 100, 10
DETECT_BATCH = 32  # detect_cli_device: the train split's 128 frames in 4 batches
# detect_cli_device's vertex head: a car this far ahead (utils/measure.py::
# cuboid_vertex_bias), centred on the row where the network's peaks fall.
# The LM accepts a constant pattern only near the row it was drawn for,
# and the 2-epoch network peaks on the frame's top edge, 42 feature rows
# above the principal point: there a car on the optical axis accepts no
# lane at 25 m and 0-3 a launch at 100 m on an H100 (PERF.md)
DEVICE_CAR_DEPTH = 100.0
# the resnet18 phase: configs/rtm3d_resnet18_kitti.yaml as shipped (b16),
# the data phase's tree, 1 epoch; detect and export at b16
RESNET_CONFIG = "rtm3d_resnet18_kitti.yaml"
RESNET_TRAIN_BATCH = RESNET_DETECT_BATCH = 16
PARITY_FRAMES, PARITY_BATCH = 4, 3  # detect_cli_parity: 2 batches, the second padded
# detect_cli_parity: GPU against CPU, on converged boxes 20-28 m deep: class
# and box to the format's last digit on >= 99% of lines, the score (4
# decimals) on all; the largest |d| of angles, dim and loc 5x what an H100
# gives (0.01, 0.02, 0.08). The plain LM in the kernel's place on the card
# parts from the CPU as far (0.01, 0.01, 0.08), and from the kernel by 0.01,
# 0.01, 0.07: rounding alone moves a fit whose depth the objective barely
# fixes. Kernels made wrong (no prior, half the prior, 2 or 4 iterations)
# part by at least 0.91, 2.64 and 9.13, which the gate must catch.
PARITY_GATE = {"box_agree_share": 0.99, "score": 1e-4 + 1e-9, "angle": 0.05, "dim": 0.1, "loc": 0.4}
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
INT8_REPLACES = "no TPU kernel; XLA's int8 conv at rtm3d_tpu/nn/quant.py:254-262"
KFPN_FUSE_REPLACES = "no TPU kernel; XLA's fusion of rtm3d_tpu/nn/kfpn.py"
KFPN_FUSE_MAP = (256, 104, 320)  # the KFPN's maps at stride 4 of the benchmark cells' 1280x416 frames
DCN_REPLACES = "no TPU kernel; the JAX package has no deformable convolution"
DCN_LAYERS = ((256, 26, 80, 23), (512, 13, 40, 3))  # ResNet-101-DCN at 1280x416: channels, map, layers a forward
DCN_BATCH = 32
MOSAIC_WORKERS = 4
INT8_CHECK_BATCH = 2  # int8_kernel: the batch of the bit-equality checks (the plain conv runs in float64)
# int8_logits: DLA-34 1280x416 b2 fp32 (TF32 off), mse scales, the int8 network on the card against the CPU.
# Conv by conv on the card's own inputs: bit-equal. Free-running the logits are only reported beside int8's own
# gap from float: an ulp on either side of a rounding edge travels (int8_logits_phase), so an H100 measured
# 0.024-0.120 relative L2 card against CPU, as far as int8 from float (0.027-0.126), and a truncating network
# 0.27: a bound there would not part sound from wrong (PERF.md).
INT8_LOGITS_GATE = {"conv_by_conv_equal": True, "logits_finite": True}
GATE_LINE = re.compile(r"float 2D detections (\d+), int8 (\d+), matched (\d+) \(recall ([0-9.]+)\)")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def lm_phase(lm, uv, x0, kp, n_det: int, prior_weight: float) -> dict:
    """Kernel against plain version on the same lanes: ``n_det`` detections
    times the inits stacked along the lane axis, as solve_bbox3d lays them."""
    m = uv.shape[1]
    xk, ck = lm.lm_solve(uv, x0, kp, iters=ITERS, prior_weight=prior_weight)
    torch.cuda.synchronize()
    xr, cr = lm.lm_solve_reference(uv, x0, kp, iters=ITERS, prior_weight=prior_weight)
    ck, cr = ck[0].cpu().numpy(), cr[0].cpu().numpy()
    if not (np.isfinite(ck).all() and np.isfinite(xk.cpu().numpy()).all()):
        raise AssertionError(f"LM kernel: non-finite output at M={m}")

    lane = lm_agreement(ck, cr)
    # what the detect path gates on: per detection, the least cost over its inits
    det = lm_agreement(ck.reshape(-1, n_det).min(0), cr.reshape(-1, n_det).min(0))
    kernel_ms = cuda_time_ms(lambda: lm.lm_solve(uv, x0, kp, iters=ITERS, prior_weight=prior_weight), 20, 2)
    plain_ms = cuda_time_ms(lambda: lm.lm_solve_reference(uv, x0, kp, iters=ITERS, prior_weight=prior_weight), 3)
    flops, nbytes = lm.lm_flops(m, ITERS, prior_weight), lm.lm_bytes(m)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    blocks, threads = lm.lm_launch_geometry(m, torch.cuda.get_device_properties(0).multi_processor_count)
    rec = {
        "M": m, "detections": n_det, "prior_weight": prior_weight,
        "lanes_per_detection": 1,  # the kernel's design: one thread per detection
        "block_threads": threads, "blocks": blocks,
        "lane_accept_agreement": lane[0], "lane_cost_within_1e-3": lane[1],
        "lane_max_abs_cost_diff_accepted": lane[2],
        "detection_accept_agreement": det[0], "detection_cost_within_1e-3": det[1],
        "detection_max_abs_cost_diff_accepted": det[2],
        "accepted_frac": float((cr < 0.1).mean()),
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "flops": flops, "bytes": nbytes,
        "bound_ms": bound_ms, "bound_by": "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES else "bytes",
    }
    emit(f"lm_M{m}_prior{prior_weight:g}", **rec)
    # FMA contraction rounds differently from the plain version, and a lane
    # now and then settles in another minimum: the accept decision must agree
    # on >= 99.9%, and the cost within 1e-3 on >= 99.9% of what both accept.
    # With the prior the problem is well posed and each lane is held to it.
    # Without it the objective has an exact scale gauge and lanes part on
    # rounding alone (the JAX package's own two versions part too), so the
    # per-detection decision is held to it.
    held = lane if prior_weight > 0 else det
    if held[0] < 0.999 or held[1] < 0.999:
        raise AssertionError(f"LM kernel disagrees with its plain version: {rec}")
    rec["x"], rec["cost"] = xk, ck
    return rec


def held_agreement(ck, cr, n_det: int, prior_weight: float):
    """``lm_agreement`` of kernel and plain costs as the gates hold it: per
    lane at the prior, per detection (the least cost over its inits, ``n_det``
    detections) without it."""
    if prior_weight > 0:
        return lm_agreement(ck, cr)
    return lm_agreement(ck.reshape(-1, n_det).min(0), cr.reshape(-1, n_det).min(0))


def lm_held(lm, calls, n_det: int) -> list:
    """Each LM call kept from a detect run, ``(uv, x0, kp, iters, lam0,
    prior_weight, kernel cost)``, against the plain version on the same lanes
    (``held_agreement``)."""
    out = []
    for uv, x0, kp, iters, lam0, pw, cost in calls:
        ck = cost[0].cpu().numpy()
        cr = lm.lm_solve_reference(uv, x0, kp, iters, lam0, pw)[1][0].cpu().numpy()
        a = held_agreement(ck, cr, n_det, pw)
        out.append({"M": uv.shape[1], "prior_weight": pw, "finite": bool(np.isfinite(ck).all()),
                    "accept_agreement": a[0], "cost_within_1e-3": a[1], "max_abs_cost_diff_accepted": a[2],
                    "accepted_frac": float((cr < 0.1).mean()),
                    "accepted_lanes": int((ck < 0.1).sum()), "accepted_lanes_plain": int((cr < 0.1).sum()),
                    # reported, not gated: every lane, accepted or not
                    "all_lanes_cost_within_1e-3_rel": float(
                        (np.abs(ck - cr) <= 1e-3 * np.maximum(np.abs(cr), 1.0)).mean())})
    return out


def lm_detect_pair(lm, n_det: int, dim_ref, prior_weight: float, seed: int = 0) -> tuple:
    """The detect path's two LM calls (decode/solve3d.py) on synthetic lanes
    of ``n_det`` detections, each through ``lm_phase``: 2 inits at the prior,
    then 3 inits without it, the third being the first call's best solution."""
    uv, x0, kp = synthetic_lanes(np.random.RandomState(seed), n_det, dim_ref)
    uv2, x02, kp2 = (t[:, : 2 * n_det].contiguous() for t in (uv, x0, kp))
    first = lm_phase(lm, uv2, x02, kp2, n_det, prior_weight)
    best = torch.from_numpy(first.pop("cost").reshape(2, n_det).argmin(0)).cuda()
    x_prior = first.pop("x").reshape(8, 2, n_det).gather(1, best[None, None].expand(8, 1, n_det))[:, 0]
    second = lm_phase(lm, uv, torch.cat([x02, x_prior], 1).contiguous(), kp, n_det, 0.0)
    return first, second


def logits_phase(cfg_base, nn_model) -> None:
    import copy

    from rtm3d_tpu_torch.decode.peaks import decode_detections
    from rtm3d_tpu_torch.train.step import normalize_images

    cfg = cfg_base.clone()
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0)).eval()
    img = torch.from_numpy((np.random.RandomState(1).rand(1, H, W, 3) * 255).astype(np.uint8))
    x = normalize_images(img, cfg).permute(0, 3, 1, 2)
    gpu = copy.deepcopy(model).cuda().to(memory_format=torch.channels_last)
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = model(x)
        cpu_s = time.perf_counter() - t0
        got = gpu(x.cuda())
        torch.cuda.synchronize()
        d_ref = decode_detections(ref, topk=TOPK)
        d_got = decode_detections(got, topk=TOPK)
    rec, worst = {"cpu_forward_s": cpu_s}, 0.0
    for name, g, r in zip(("main_kf", "offset_fr_main", "main_offset", "vertex_offset"), got, ref):
        if tuple(g.shape) != tuple(r.shape) or not torch.isfinite(g).all():
            raise AssertionError(f"logits {name}: shape {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        rel = ((g.float().cpu() - r).abs().max() / r.abs().max()).item()
        rec[f"{name}_rel_err"] = rel
        worst = max(worst, rel)
    score_err = (d_got["scores"].cpu() - d_ref["scores"]).abs().max().item()
    rec["scores_max_abs_err"] = score_err
    emit("logits", **rec)
    if worst > 1e-4 or score_err > 1e-4:
        raise AssertionError(f"GPU fp32 logits disagree with the CPU: {rec}")


def serve_phase(cfg_base, nn_model, lm, splat, kf, Detector) -> dict:
    cfg = cfg_base.clone()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    det = Detector(cfg, nn_model.create_model(cfg, torch.Generator().manual_seed(0)), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    frames = [
        torch.randint(0, 256, (BATCH, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen)
        for _ in range(SERVE_CALLS + 1)
    ]
    K = torch.from_numpy(np.tile(K_KITTI, (BATCH, 1, 1))).cuda()
    out = det(frames[-1], K)  # warm-up: cuDNN plans, the kernel library
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lm.lm_solve.launches = splat.splat_heatmap.launches = kf.kfpn_fuse.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for f in frames[:SERVE_CALLS]:
        out = det(f, K)  # returns host numpy: each call ends in a sync
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, splat_launches = lm.lm_solve.launches, splat.splat_heatmap.launches
    kfpn_launches = kf.kfpn_fuse.launches
    dev_ms = start.elapsed_time(end)

    shapes = {"cls": (BATCH, TOPK), "scores": (BATCH, TOPK), "valid": (BATCH, TOPK),
              "m_proj": (BATCH, TOPK, 2), "v_proj": (BATCH, TOPK, 8, 2), "bbox2d": (BATCH, TOPK, 4),
              "ry": (BATCH, TOPK), "dim": (BATCH, TOPK, 3), "loc": (BATCH, TOPK, 3),
              "cost": (BATCH, TOPK), "accepted": (BATCH, TOPK)}
    for k, shp in shapes.items():
        if out[k].shape != shp:
            raise AssertionError(f"serve: {k} has shape {out[k].shape}, expected {shp}")
        if out[k].dtype.kind == "f" and not np.isfinite(out[k]).all():
            raise AssertionError(f"serve: {k} has non-finite values")
    # the network's operations per image (all in convolutions), counted by
    # PyTorch's FlopCounterMode on meta tensors
    with FlopCounterMode(display=False) as counter, torch.inference_mode():
        nn_model.create_model(cfg).to("meta")(torch.empty(1, 3, H, W, device="meta"))
    net_flops = counter.get_total_flops()
    rec = {
        "batch": BATCH, "input": f"{W}x{H}", "dtype": "bfloat16", "calls": SERVE_CALLS,
        "images_per_s": BATCH * SERVE_CALLS / (dev_ms / 1e3),
        "ms_per_call": dev_ms / SERVE_CALLS,
        "net_gflop_per_image": net_flops / 1e9,
        "net_tflops_achieved": net_flops * BATCH * SERVE_CALLS / (dev_ms / 1e3) / 1e12,
        "net_bound_ms_per_call": net_flops * BATCH / PEAK_BF16_FLOPS * 1e3,
        "wall_images_per_s": BATCH * SERVE_CALLS / wall_s,
        "lm_launches": launches, "lm_launches_per_call": launches / SERVE_CALLS, "kfpn_launches": kfpn_launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "valid_frac": float(out["valid"].mean()), "accepted_frac": float(out["accepted"].mean()),
    }
    emit("serve", **rec)
    if launches != 2 * SERVE_CALLS or splat_launches != 0 or kfpn_launches != 2 * SERVE_CALLS:
        raise AssertionError(f"serve: {launches} LM and {kfpn_launches} KFPN fusion launches in {SERVE_CALLS} "
                             f"calls, expected 2 of each per call (and {splat_launches} splat launches, expected none)")
    profile_calls("profile", lambda: det(frames[0], K), 2, "chip_smoke_out/serve_profile.json")
    return rec


def profile_calls(phase: str, call, calls: int, path: str) -> dict:
    """torch.profiler over ``calls`` runs of ``call()``: device time by kernel
    name and the device's busy share of the wall time; the table goes to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [
        {"name": e.key[:120], "device_us": e.self_device_time_total, "count": e.count}
        for e in prof.key_averages() if e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["device_us"])
    # an aten:: row's device time is that of its kernels, which have rows too
    busy = sum(r["device_us"] for r in rows if not r["name"].startswith("aten::"))
    os.makedirs("chip_smoke_out", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"wall_us": wall_us, "device_us": busy, "kernels": rows}, f, indent=1)
    rec = {"calls": calls, "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": (1 - busy / wall_us) if wall_us > 0 and busy > 0 else "not measured",
           "top": [r for r in rows if not r["name"].startswith("aten::")][:15]}
    emit(phase, **rec)
    return rec


def splat_phase(splat, inputs, feat_hw, num_classes: int, name: str) -> dict:
    """Kernel against plain version on the same inputs: max |d| <= 1e-6 and
    the same set of pixels equal to 1.0 (what the focal loss counts)."""
    got = splat.splat_heatmap(*inputs, feat_hw, num_classes)
    torch.cuda.synchronize()
    ref = splat.splat_heatmap_reference(*inputs, feat_hw, num_classes)
    err = (got - ref).abs().max().item()
    ones_equal = bool(torch.equal(got == 1.0, ref == 1.0))
    # back to back from Python the wrapper's host work outruns the kernel, so
    # the per-call event time is host-bound; the kernel's own device time
    # comes from the profiler
    call_ms = cuda_time_ms(lambda: splat.splat_heatmap(*inputs, feat_hw, num_classes), 50, 3)
    kernel_ms, timed_by = kernel_device_ms(lambda: splat.splat_heatmap(*inputs, feat_hw, num_classes), 20,
                                           "splat_kernel")
    # the same launches from one CUDA graph: kernels and the gaps between them
    graph_ms = graph_device_ms(lambda: splat.splat_heatmap(*inputs, feat_hw, num_classes), 20)
    plain_ms = cuda_time_ms(lambda: splat.splat_heatmap_reference(*inputs, feat_hw, num_classes), 5, 1)
    B, N = inputs[1].shape
    nbytes = splat.splat_bytes(B, N, feat_hw, num_classes)
    flops = splat.splat_flops(inputs[0], inputs[3], inputs[4], feat_hw)
    bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES) * 1e3
    tile = splat.splat_tile_shape()
    live = splat.splat_live_slots(inputs[0], inputs[3], inputs[4], feat_hw, tile).float()
    rec = {
        "shape": [B, N, num_classes, *feat_hw], "max_abs_err": err, "ones_equal": ones_equal,
        "tile": list(tile), "tiles": live.numel(), "mean_live_slots_per_tile": live.mean().item(),
        "ones": int((ref == 1.0).sum().item()), "nonzero_frac": float((ref > 0).float().mean().item()),
        "kernel_ms": kernel_ms, "kernel_us": kernel_ms * 1e3, "timed_by": timed_by, "graph_ms": graph_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
        "bound_by": "operations" if flops / PEAK_FP32_FLOPS > nbytes / PEAK_BYTES else "bytes",
    }
    emit(f"splat_{name}", **rec)
    if not torch.isfinite(got).all() or err > 1e-6 or not ones_equal:
        raise AssertionError(f"splat kernel disagrees with its plain version: {rec}")
    return rec


def kfpn_fusion_maps(batch: int):
    """x0 and three upsampled maps as the detect path holds them at 1280x416
    (``KFPN_FUSE_MAP``, channels_last, bf16); the upsampled maps at three
    times x0's spread, so that the softmax weights are peaked."""
    g = torch.Generator(device="cuda").manual_seed(0)
    maps = [torch.randn((batch, *KFPN_FUSE_MAP[1:], KFPN_FUSE_MAP[0]), generator=g, device="cuda")
            .mul_(3.0 if i else 1.0).bfloat16().permute(0, 3, 1, 2) for i in range(4)]
    return maps[0], maps[1:]


def composed_fusion(x0, ups):
    """The KFPN's composed loop (nn/kfpn.py), in the maps' dtype."""
    z = x0
    for u in ups:
        b, c, h, w = u.shape
        z = z + u * torch.softmax(u.reshape(b, c, h * w), -1).reshape(b, c, h, w)
    return z


def kfpn_fuse_phase(kf) -> dict:
    """The fusion kernel against the float64 fusion, beside the bf16
    composition, at b32 and b1; times and the bound (module docstring)."""
    recs = {}
    for batch in (32, 1):
        x0, ups = kfpn_fusion_maps(batch)
        before = kf.kfpn_fuse.launches
        z = kf.kfpn_fuse(x0, ups)
        torch.cuda.synchronize()
        launches = kf.kfpn_fuse.launches - before
        again = kf.kfpn_fuse(x0, ups)
        exact = kf.kfpn_fuse_reference(x0.double(), [u.double() for u in ups])
        err = (z.double() - exact).abs()
        plain_err = (composed_fusion(x0, ups).double() - exact).abs()
        errs = {"max_abs_err": err.max().item(), "mean_abs_err": err.mean().item(),
                "composed_max_abs_err": plain_err.max().item(), "composed_mean_abs_err": plain_err.mean().item()}
        del exact, err, plain_err
        nbytes = kf.kfpn_fuse_bytes(batch, KFPN_FUSE_MAP[0], KFPN_FUSE_MAP[1:], len(ups), x0.element_size())
        stats_ms, timed_by = kernel_device_ms(lambda: kf.kfpn_fuse(x0, ups), 20, "stats_kernel")
        apply_ms, _ = kernel_device_ms(lambda: kf.kfpn_fuse(x0, ups), 20, "apply_kernel")
        rec = {
            "shape": [batch, *KFPN_FUSE_MAP], "ups": len(ups), "dtype": str(x0.dtype), **errs,
            "channels_last": z.is_contiguous(memory_format=torch.channels_last), "bit_equal": torch.equal(z, again),
            "launches_per_call": launches,
            "kernel_ms": cuda_time_ms(lambda: kf.kfpn_fuse(x0, ups), 20, 3),
            "stats_ms": stats_ms, "apply_ms": apply_ms, "timed_by": timed_by,
            "plain_ms": cuda_time_ms(lambda: kf.kfpn_fuse_reference(x0, ups), 5, 1),
            "composed_ms": cuda_time_ms(lambda: composed_fusion(x0, ups), 10, 2),
            "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
        }
        emit(f"kfpn_fuse_b{batch}", **rec)
        if (launches != 2 or not rec["channels_last"] or not rec["bit_equal"]
                or not errs["max_abs_err"] <= errs["composed_max_abs_err"]
                or not errs["mean_abs_err"] <= errs["composed_mean_abs_err"]):
            raise AssertionError(f"kfpn_fuse kernel: {rec}")
        recs[batch] = rec
        del x0, ups, z, again
        torch.cuda.empty_cache()
    return recs


def dcn_inputs(batch: int, channels: int, hw, rms: float, seed: int = 0):
    """x, the offset conv's raw output and a xavier-bounded 3x3 weight as
    the detect path holds them (channels_last, bf16): offsets normal at
    ``rms`` px, mask logits standard normal."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((batch, *hw, channels), generator=g, device="cuda")
    om = torch.randn((batch, *hw, 27), generator=g, device="cuda")
    om[..., :18] *= rms
    w = (torch.rand((channels, 3, 3, channels), generator=g, device="cuda") * 2 - 1) * (6.0 / (18 * channels)) ** 0.5
    return [t.bfloat16().permute(0, 3, 1, 2) for t in (x, om, w)]


def dcn_phase(dcn_ops, nn_model, Detector, cfg_base) -> dict:
    """The DCN kernel against its plain version at b32, times and the
    bound; then the b32 ResNet-101-DCN network once (module docstring)."""
    recs = {}
    for channels, fh, fw, layers in DCN_LAYERS:
        for rms in (0.1, 2.0):
            x, om, w = dcn_inputs(DCN_BATCH, channels, (fh, fw), rms)
            before = dcn_ops.modulated_deform_conv.launches
            y = dcn_ops.modulated_deform_conv(x, om, w)
            torch.cuda.synchronize()
            launches = dcn_ops.modulated_deform_conv.launches - before
            p = dcn_ops.dcn_reference(x, om, w).double()
            gap = (y.double() - p).abs()
            top = p.abs().max().item()
            flops = dcn_ops.dcn_flops(DCN_BATCH, channels, channels, (fh, fw))
            rec = {"shape": [DCN_BATCH, channels, fh, fw], "offsets_rms_px": rms, "dtype": "bfloat16",
                   "launches_per_call": launches, "max_gap": gap.max().item(), "mean_gap": gap.mean().item(),
                   "within_an_ulp": bool((gap <= 2 ** -7 * p.abs() + 2e-3 * top).all()), "largest_output": top,
                   "bit_equal": torch.equal(y, dcn_ops.modulated_deform_conv(x, om, w)),
                   "kernel_ms": cuda_time_ms(lambda: dcn_ops.modulated_deform_conv(x, om, w), 20, 3),
                   "flops": flops, "bound_ms": flops / PEAK_BF16_FLOPS * 1e3, "bound_by": "operations",
                   "layers_a_forward": layers}
            if rms == 0.1:
                rec["plain_ms"] = cuda_time_ms(lambda: dcn_ops.dcn_reference(x, om, w), 3, 1)
            rec["roofline_pct"] = 100 * rec["bound_ms"] / rec["kernel_ms"]
            emit(f"dcn_{channels}_rms{rms}", **rec)
            if (launches != 1 or not rec["within_an_ulp"] or not rec["bit_equal"]
                    or not rec["mean_gap"] <= 1e-5 * top):
                raise AssertionError(f"dcn kernel: {rec}")
            recs[(channels, rms)] = rec
            del x, om, w, y, p, gap
            torch.cuda.empty_cache()
    cfg = cfg_base.clone()
    cfg.MODEL.BACKBONE, cfg.MODEL.KFNs = "RESNET-101-DCN", ["layer1", "layer2", "layer3", "layer4"]
    cfg.INPUT_SIZE, cfg.TPU.COMPUTE_DTYPE = (1280, 416), "bfloat16"
    det = Detector(cfg, nn_model.create_model(cfg, torch.Generator().manual_seed(0)), device="cuda")
    frames = torch.randint(0, 256, (DCN_BATCH, 416, 1280, 3), dtype=torch.uint8, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    K = torch.from_numpy(np.tile(K_KITTI, (DCN_BATCH, 1, 1))).cuda()
    det(frames, K)  # warm-up: cuDNN plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = dcn_ops.modulated_deform_conv.launches
    ms = cuda_time_ms(lambda: det(frames, K), 1, 0)
    out = det(frames, K)
    net = {"batch": DCN_BATCH, "input": "1280x416", "call_ms": ms,
           "dcn_launches_per_call": (dcn_ops.modulated_deform_conv.launches - before) // 2,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "finite": all(np.isfinite(v).all() for v in out.values() if v.dtype.kind == "f")}
    emit("dcn_network", **net)
    if net["dcn_launches_per_call"] != 26 or not net["finite"]:
        raise AssertionError(f"dcn network: {net}")
    del det, frames
    torch.cuda.empty_cache()
    return {"layers": recs, "network": net}


def train_fp32_phase(cfg_base, nn_model, step_mod, state_mod) -> None:
    """One train step of DLA-34 at 384x128 batch 2 in fp32 on the GPU against
    the same step on the CPU. The float32 gradient of this network at random
    init is noisy: on the CPU, float32 against float64 differs by 0.95% of
    the whole gradient (L2) and by up to 1.3% in one tensor; GPU against CPU
    by 2.1% and 3.2% on an H100. So the gradients are held at 5e-2
    and 1e-1 in L2 (a wrong backward is off by O(1)); loss and aux at 1e-4
    relative."""
    cfg = cfg_base.clone()
    cfg.INPUT_SIZE = (384, 128)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    batch = {"image": torch.from_numpy((rng.rand(2, 128, 384, 3) * 255).astype(np.uint8)),
             "labels": synthetic_labels(rng, 2, TRAIN_OBJS, scale=0.3)}
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        state = state_mod.TrainState.create(model, cfg, device=dev)
        state, m = step_mod.make_train_step(cfg, device=dev)(state, batch)
        grads = {k: p.grad.detach().double().cpu() for k, p in state.model.named_parameters()}
        out[dev] = (m["loss"].item(), m["loss_items"].double().cpu(), grads, time.perf_counter() - t0)
    (lg, ag, gg, tg), (lc, ac, gc, tc) = out["cuda"], out["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    aux_rel = ((ag - ac).abs() / ac.abs().clamp(min=1e-12)).max().item()
    per = {k: ((gg[k] - gc[k]).norm() / gc[k].norm()).item() for k in gc if gc[k].norm() > 0}
    flat_g, flat_c = torch.cat([g.flatten() for g in gg.values()]), torch.cat([g.flatten() for g in gc.values()])
    total = ((flat_g - flat_c).norm() / flat_c.norm()).item()
    worst = max(per, key=per.get)
    max_rel = {k: ((gg[k] - gc[k]).abs().max() / gc[k].abs().max()).item() for k in per}
    rec = {"input": "384x128", "batch": 2, "loss_gpu": lg, "loss_cpu": lc, "loss_rel": loss_rel,
           "aux_max_rel": aux_rel, "grad_l2_rel_total": total, "grad_l2_rel_worst": per[worst],
           "grad_l2_rel_worst_tensor": worst, "grad_l2_rel_median": float(np.median(list(per.values()))),
           "grad_max_over_tensor_max_worst": max(max_rel.values()),
           "grad_max_over_tensor_max_median": float(np.median(list(max_rel.values()))),
           "gpu_step_s": tg, "cpu_step_s": tc}
    emit("train_fp32", **rec)
    if not np.isfinite(lg) or loss_rel > 1e-4 or aux_rel > 1e-4 or per[worst] > 1e-1 or total > 5e-2:
        raise AssertionError(f"train step on the GPU disagrees with the CPU: {rec}")


def train_batches() -> list:
    """The train and remat phases' distinct synthetic batches on the card:
    uint8 frames and label blocks (a quarter of the slots masked, a tenth
    noise), seeded."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    rng = np.random.RandomState(4)
    return [
        {"image": torch.randint(0, 256, (TRAIN_BATCH, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen),
         "labels": {k: v.cuda() for k, v in synthetic_labels(rng, TRAIN_BATCH, TRAIN_OBJS).items()}}
        for _ in range(TRAIN_WARMUP + TRAIN_TIMED)
    ]


def train_phase(nn_model, step_mod, state_mod, load_config, lm, splat, kf) -> dict:
    """configs/rtm3d_dla34_kitti_tpu.yaml at full width on distinct synthetic
    batches, then the loss-falls check on one repeated batch."""
    cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "configs", "rtm3d_dla34_kitti_tpu.yaml"))
    # tools/bench_train.py's synthetic 372x1242 frames under IS_RECT give
    # 1280x384; KITTI's own frames, 370-376 px tall, give 1280x416 (the
    # longest side to 1280, each side up to a multiple of 32): the data phase
    cfg.INPUT_SIZE = (W, H)
    cfg.BATCH_SIZE, cfg.DATASET.MAX_OBJS = TRAIN_BATCH, TRAIN_OBJS  # the file's 32 and the default 64
    batches = train_batches()
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0))
    state = state_mod.TrainState.create(model, cfg, device="cuda")
    step = step_mod.make_train_step(cfg, device="cuda")
    eval_step = step_mod.make_eval_loss_step(cfg, device="cuda")
    for b in batches[:TRAIN_WARMUP]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    lm.lm_solve.launches = splat.splat_heatmap.launches = kf.kfpn_fuse.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    t0 = time.perf_counter()
    start.record()
    for b in batches[TRAIN_WARMUP:]:
        state, m = step(state, b)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    train_launches, train_lm = splat.splat_heatmap.launches, lm.lm_solve.launches
    dev_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    splat.splat_heatmap.launches = 0
    evals = [eval_step(state, b) for b in batches[:2]]
    torch.cuda.synchronize()
    eval_launches = splat.splat_heatmap.launches
    # the train and eval-loss steps compose the KFPN fusion (autograd,
    # autocast): no launch of its kernel
    kfpn_launches = kf.kfpn_fuse.launches

    losses = torch.stack([m["loss"] for m in metrics]).cpu()
    aux = torch.stack([m["loss_items"] for m in metrics] + [e["loss_items"] for e in evals]).cpu()
    rec = {
        "batch": TRAIN_BATCH, "input": f"{W}x{H}", "dtype": "bfloat16 autocast", "ema": True,
        "max_objs": TRAIN_OBJS, "timed_steps": TRAIN_TIMED,
        "images_per_s": TRAIN_BATCH * TRAIN_TIMED / (dev_ms / 1e3), "ms_per_step": dev_ms / TRAIN_TIMED,
        "wall_images_per_s": TRAIN_BATCH * TRAIN_TIMED / wall_s, "peak_mem_gb": peak_gb,
        "splat_launches": train_launches, "lm_launches": train_lm, "eval_splat_launches": eval_launches,
        "kfpn_launches": kfpn_launches, "loss_first": losses[0].item(), "loss_last": losses[-1].item(),
        "eval_loss": [e["loss"].item() for e in evals],
        "num_targets": int(metrics[0]["num_targets"].item()),
    }
    del state, metrics, evals
    torch.cuda.empty_cache()

    # the loss falls on one repeated batch
    fall_cfg = cfg.clone()
    fall_cfg.SOLVER.WARMUP_ITERS = 0
    state = state_mod.TrainState.create(model, fall_cfg, device="cuda")
    step = step_mod.make_train_step(fall_cfg, device="cuda")
    fall = []
    for _ in range(LOSS_FALL_STEPS):
        state, m = step(state, batches[0])
        fall.append(m["loss"])
    fall = torch.stack(fall).cpu()
    rec["repeated_batch_loss"] = [round(v, 4) for v in fall.tolist()]
    emit("train", **rec)
    if not (torch.isfinite(losses).all() and torch.isfinite(aux).all() and torch.isfinite(fall).all()):
        raise AssertionError(f"train: non-finite loss or aux {rec}")
    if train_launches != TRAIN_TIMED or eval_launches != 2 or train_lm != 0 or kfpn_launches != 0:
        raise AssertionError(f"train: expected one splat launch per step and no LM or KFPN fusion launch, got {rec}")
    if not fall[-1] < fall[0]:
        raise AssertionError(f"train: the loss did not fall over {LOSS_FALL_STEPS} steps on one batch: {rec}")
    profile_calls("train_profile", lambda: step(state, batches[1]), 2, "chip_smoke_out/train_profile.json")
    return rec


def cli_record(out: dict, batch: int, workers: int, launches: int) -> dict:
    """One cli.train.main run: its epochs' losses and counts, and over its
    last epoch the wall images/s (loader included), each step's span on
    the stream from CUDA events (host waits inside a step, such as the
    photometric seeds' read, are in the span), the share of the train
    loop's wall time outside those spans, and the host's ms to build a
    batch in the loader's workers. The device's own idle share needs the
    kernel time: ``device_idle_share`` below."""
    hist, last = out["history"], out["history"][-1]
    span_ms = sum(last["step_span_ms"])
    wall_ms = last["train_wall_s"] * 1e3
    return {
        "img_size": out["img_size"], "batch": batch, "workers": workers, "start_epoch": out["start_epoch"],
        "steps": [h["steps"] for h in hist], "eval_batches": [h["eval_batches"] for h in hist],
        "train_loss": [h["train_loss"][-1] for h in hist], "eval_loss": [h["eval_loss"][-1] for h in hist],
        "train_aux": [h["train_loss"] for h in hist], "num_targets": [h["num_targets"] for h in hist],
        "cache_gb": out["cache_bytes"] / 1e9,
        "last_epoch_wall_ms": wall_ms,
        "last_epoch_wall_images_per_s": batch * last["steps"] / last["train_wall_s"],
        "last_epoch_step_span_ms": span_ms, "last_epoch_step_span_ms_per_step": span_ms / last["steps"],
        "last_epoch_step_span_ms_each": last["step_span_ms"],
        "last_epoch_outside_step_share": 1.0 - span_ms / wall_ms,
        "host_ms_per_batch": 1e3 * float(np.mean([s for h in hist for s in h["build_s"]])),
        "last_epoch_loader_wait_ms": [1e3 * w for w in last["wait_s"]],
        "splat_launches": launches,
    }


def check_cli_run(name: str, rec: dict, launches: int, out: dict) -> None:
    hist = out["history"]
    losses = [v for h in hist for v in h["train_loss"] + (h["eval_loss"] or [])]
    want = sum(h["steps"] + h["eval_batches"] for h in hist)
    if not all(np.isfinite(losses)) or not hist or any(h["steps"] == 0 for h in hist):
        raise AssertionError(f"{name}: a loss is not finite or an epoch ran no step: {rec}")
    if out["img_size"] != KITTI_RECT:
        raise AssertionError(f"{name}: img_size {out['img_size']}, expected {KITTI_RECT} on KITTI frames")
    if launches != want:
        raise AssertionError(f"{name}: {launches} splat launches, expected one per train and eval batch ({want})")


def data_phase(splat, load_config, generate_kitti, cli_train) -> tuple:
    """Training from files through the port's CLI: a KITTI-layout tree,
    the device mode with a resume, and the host mode; after each mode's
    run, ``parent_batches``. Returns the runs' records and the splat
    checks at the data path's shapes."""
    from rtm3d_tpu_torch.data.kitti import create_dataset
    from rtm3d_tpu_torch.data.loader import DataLoader, prefetch_to_device
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.train.step import make_train_step

    root = os.path.abspath(os.path.join("chip_smoke_out", "data"))
    shutil.rmtree(root, ignore_errors=True)
    tree = os.path.join(root, "kitti")
    t0 = time.perf_counter()
    generate_kitti(tree, DATA_TRAIN, DATA_TEST, KITTI_HW, max_objs=8, seed=20)
    seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(tree) for f in fs)
    emit("data_tree", frames=DATA_TRAIN + DATA_TEST, train=DATA_TRAIN, test=DATA_TEST, hw=list(KITTI_HW),
         bytes=nbytes, seconds=seconds)
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    recs, splats = {}, {}

    def run(name, config, weights, mode, epochs, on_start=None):
        cfg = load_config(os.path.join(configs, config))
        argv = ["--model-config", os.path.join(configs, config), "--data-path", tree,
                "--set", "TRAINING.WEIGHTS", weights, "TRAINING.CHECKPOINT_MODE", mode, "SOLVER.MAX_EPOCH", str(epochs)]
        splat.splat_heatmap.launches = 0
        out = cli_train.main(argv, on_start=on_start)
        torch.cuda.synchronize()
        launches = splat.splat_heatmap.launches
        recs[name] = cli_record(out, int(cfg.BATCH_SIZE), int(cfg.get("num_workers", 0)), launches)
        emit(name, **recs[name])
        check_cli_run(name, recs[name], launches, out)
        return out

    def parent_batches(name, config, out, count, profile):
        """``count`` train batches of ``config`` built by a loader in this
        process (no workers, nothing else running): the host's ms for each,
        the first being its first build. On the first batch: the splat
        against its plain version at the run's shape and labels, and two
        train steps of ``out``'s state under the profiler, whose kernel
        time a step gives the device's idle share over the run's last
        epoch (1 - kernel ms a step x steps / the epoch's wall ms)."""
        cfg = load_config(os.path.join(configs, config))
        cfg.INPUT_SIZE = tuple(out["img_size"])
        ds = create_dataset(tree, cfg, is_training=True, split="train")
        cache = torch.from_numpy(ds.canvas_array()).cuda() if ds.device_cache else None
        loader = DataLoader(ds, int(cfg.BATCH_SIZE), seed=20)
        batches = list(prefetch_to_device(itertools.islice(iter(loader), count), "cuda"))
        build_ms = [1e3 * s for s in loader.build_seconds]
        down = int(cfg.MODEL.DOWN_SAMPLE)
        feat_hw = (cfg.INPUT_SIZE[1] // down, cfg.INPUT_SIZE[0] // down)
        inputs = heatmap_inputs(batches[0]["labels"], float(down), cfg.DATASET.GAUSSIAN_GEN_TYPE,
                                cfg.DATASET.BBOX_AREA_MAX, cfg.DATASET.BBOX_AREA_MIN)
        splats[name] = splat_phase(splat, inputs, feat_hw, len(cfg.DATASET.OBJs), f"data_shape_{name}")
        step = make_train_step(cfg, device="cuda")
        state = out["state"]
        prof = profile_calls(profile, lambda: step(state, batches[0], cache), 2, f"chip_smoke_out/{profile}.json")
        rec = recs[f"train_cli_{name}"]
        kernel_ms = prof["device_busy_ms"] / prof["calls"]
        steps = rec["steps"][-1]
        emit(f"data_{name}_parent", batch=int(cfg.BATCH_SIZE), build_ms=build_ms,
             steady_build_ms=float(np.mean(build_ms[1:])), kernel_ms_per_step=kernel_ms,
             last_epoch_device_idle_share=1.0 - kernel_ms * steps / rec["last_epoch_wall_ms"],
             last_epoch_outside_step_share=rec["last_epoch_outside_step_share"])

    weights = os.path.join(root, "weights_device")
    out = run("train_cli_device", "rtm3d_dla34_kitti_tpu.yaml", weights, "start", 2)
    saved = state_tensors(out["state"])
    first_eval = [h["eval_loss"][-1] for h in out["history"]]
    parent_batches("device", "rtm3d_dla34_kitti_tpu.yaml", out, 4, "data_profile")
    del out
    torch.cuda.empty_cache()

    restored = {}

    def on_start(state, start_epoch):
        restored["start_epoch"] = start_epoch
        restored["unequal"] = unequal(state_tensors(state), saved)
        restored["tensors"] = sum(torch.is_tensor(v) for v in saved.values())

    out = run("resume", "rtm3d_dla34_kitti_tpu.yaml", weights, "resume", 3, on_start=on_start)
    save_dir = os.path.join(weights, "DLA-34")
    files = sorted(os.listdir(save_dir))
    with open(os.path.join(save_dir, "last_checkpoint")) as f:
        pointer = os.path.basename(f.read().strip())
    epoch2_best = out["history"][0]["eval_loss"][-1] < min(first_eval)
    want_pointer = "model_best.pt" if epoch2_best else "model_0000002.pt"
    emit("resume_check", start_epoch=restored.get("start_epoch"), tensors_compared=restored.get("tensors"),
         unequal=restored.get("unequal", ["on_start was not called"])[:10], files=files, last_checkpoint=pointer,
         expected_last_checkpoint=want_pointer)
    if restored.get("start_epoch") != 2 or out["start_epoch"] != 2 or restored.get("unequal"):
        raise AssertionError(f"resume: not bit-equal from epoch 2: {restored.get('unequal')}")
    if pointer != want_pointer or files != ["last_checkpoint", "model_0000000.pt", "model_0000001.pt",
                                            "model_0000002.pt", "model_best.pt"]:
        raise AssertionError(f"resume: last_checkpoint {pointer} (expected {want_pointer}), files {files}")
    del out, saved
    torch.cuda.empty_cache()

    out = run("train_cli_host", "rtm3d_dla34_kitti.yaml", os.path.join(root, "weights_host"), "start", 1)
    parent_batches("host", "rtm3d_dla34_kitti.yaml", out, 3, "data_profile_host")
    del out
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "weights_host"), ignore_errors=True)
    # the device-mode run's last checkpoint (EMA on) serves the detect_cli phase
    return recs, splats, tree, os.path.join(save_dir, pointer)


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def echoed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` and what it printed, which still goes to
    stdout."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def detect_run(lm, cli_detect, argv, route=None):
    """cli.detect.main(argv), the LM launches it made and what it printed;
    with ``route``, every LM call of the run goes through ``route(lm_solve,
    uv, x0, kp, iters, lam0, prior_weight)`` (solve3d.py looks lm_solve up
    at each call)."""
    solve = lm.lm_solve
    if route is not None:
        # the kernel's wrapper counts on whatever lm_solve names when it
        # launches: during the run, the stand-in
        lm.lm_solve = functools.partial(route, solve)
    lm.lm_solve.launches = 0
    try:
        out, printed = echoed(cli_detect.main, argv)
        torch.cuda.synchronize()
        launches = lm.lm_solve.launches
    finally:
        lm.lm_solve = solve
    return out, launches, printed


def keeper(calls: list):
    """A ``detect_run`` route that keeps each LM call's lanes and costs in
    ``calls``, to hold the kernel against its plain version afterwards."""
    def keep(solve, uv, x0, kp, iters=ITERS, lam0=1e-3, prior_weight=0.0):
        x, cost = solve(uv, x0, kp, iters, lam0, prior_weight)
        calls.append((uv, x0, kp, iters, lam0, prior_weight, cost))
        return x, cost

    return keep


def car_head(sd: dict, K, depth: float = 25.0, row: float | None = None) -> dict:
    """``sd`` with its vertex head drawing a car (zero weights, the bias of
    ``cuboid_vertex_bias``): every peak regresses a near-cuboid, on which
    the LM converges."""
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.weight"].zero_()
    sd["detect_header.offset_fr_main_header.offset_fr_main_head.bias"].copy_(
        torch.from_numpy(cuboid_vertex_bias(K, depth=depth, row=row)))
    return sd


def peak_row(calls, bias, n_det: int) -> float:
    """The median feature row of the peaks of a detect run whose vertex
    head drew the constant ``bias`` (16,): each detection's regressed
    vertices are its peak (sub-pixel centre) plus the bias, times 4."""
    rows = [c[0][8:16, :n_det].mean(0).cpu().numpy() / 4.0 - bias[1::2].mean() for c in calls]
    return float(np.median(np.concatenate(rows)))


def detect_cli_phase(lm, kf, load_config, cli_detect, cli_evaluate, tree: str, checkpoint: str) -> dict:
    """Detect and evaluate from files through the port's CLIs, in this
    process, on the data phase's tree and the device-mode run's checkpoint:
    detect_cli_device, detect_cli_parity and evaluate (see the module's
    docstring). Returns the LM launches of the two detect runs on the card,
    the KFPN fusion launches of the gated device run and the records."""
    from rtm3d_tpu_torch.data.kitti import create_dataset
    from rtm3d_tpu_torch.eval.ap import DIFFICULTY, parse_kitti_line
    from rtm3d_tpu_torch.train.checkpoint import load_torch_weights

    root = os.path.dirname(tree)
    configs = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
    recs = {}
    detect = functools.partial(detect_run, lm, cli_detect)

    # detect_cli_device: the TPU config as it stands (bf16, device warp, 4
    # workers), the checkpoint's vertex head set to draw a car so that the
    # LM converges and accepts lanes; each LM call's lanes and costs are
    # kept, to hold the kernel against its plain version at this path's
    # shapes after the run. A pilot run with the car on the optical axis
    # (25 m, as detect_cli_parity draws it) finds the row where the
    # network's peaks fall (the vertex head does not move them); the
    # gated run draws the car DEVICE_CAR_DEPTH m ahead on that row.
    device_cfg = os.path.join(configs, "rtm3d_dla34_kitti_tpu.yaml")
    dcfg = load_config(device_cfg)
    n_det = DETECT_BATCH * int(dcfg.DETECTOR.TOPK_CANDIDATES)
    K_dev = create_dataset(tree, dcfg, is_training=False, split="train")[0]["calib"].reshape(3, 3)
    device_weights = os.path.join(root, "device_weights.pt")
    device_argv = ["--model-config", device_cfg, "--data-path", tree, "--split", "train", "--batch-size",
                   str(DETECT_BATCH), "--checkpoint", device_weights]
    pilot = []
    torch.save(car_head(load_torch_weights(checkpoint)[0], K_dev), device_weights)
    detect(device_argv + ["--out-dir", os.path.join(root, "results_pilot")], keeper(pilot))
    row = peak_row([c for c in pilot if c[5] > 0], cuboid_vertex_bias(K_dev), n_det)
    pilot_accepted = [int((c[6] < 0.1).sum()) for c in pilot]
    calls = []
    torch.save(car_head(load_torch_weights(checkpoint)[0], K_dev, DEVICE_CAR_DEPTH, row), device_weights)
    out_dir = os.path.join(root, "results_device")
    kf.kfpn_fuse.launches = 0
    summary, launches, _ = detect(device_argv + ["--out-dir", out_dir], keeper(calls))
    kfpn_launches = kf.kfpn_fuse.launches
    held = lm_held(lm, calls, n_det)
    batches = len(summary["batch_s"])
    steady = summary["batch_s"][1:]
    rec = {"config": "rtm3d_dla34_kitti_tpu.yaml", "img_size": summary["img_size"], "batch": DETECT_BATCH,
           "images": summary["images"], "batches": batches, "result_files": len(os.listdir(out_dir)),
           "device_images_per_s": summary["device_images_per_s"], "wall_images_per_s": summary["wall_images_per_s"],
           "steady_device_images_per_s": DETECT_BATCH * len(steady) / sum(steady) if steady else None,
           "device_s": summary["device_s"], "wall_s": summary["wall_s"],
           "outside_detect_share": 1.0 - summary["device_s"] / summary["wall_s"],
           "batch_ms": [1e3 * t for t in summary["batch_s"]], "wait_ms": [1e3 * t for t in summary["wait_s"]],
           "first_wait_ms": 1e3 * summary["wait_s"][0], "lm_launches": launches, "kfpn_launches": kfpn_launches,
           "vertex_head": f"car {DEVICE_CAR_DEPTH:g} m ahead on feature row {row:.2f}",
           "pilot_accepted_lanes_car_on_axis_25m": pilot_accepted, "accepted_lanes": [h["accepted_lanes"] for h in held],
           "lm_held": held}
    recs["detect_cli_device"] = rec
    emit("detect_cli_device", **rec)
    if (summary["images"] != DATA_TRAIN or rec["result_files"] != DATA_TRAIN or summary["img_size"] != KITTI_RECT
            or launches != 2 * batches or len(held) != launches or kfpn_launches != 2 * batches):
        raise AssertionError(f"detect_cli_device: expected a result file for each of {DATA_TRAIN} frames, "
                             f"img_size {KITTI_RECT} and 2 LM and 2 KFPN fusion launches per batch: {rec}")
    # every launch on the lanes the CLI made: lanes accepted, the accept
    # decisions and the accepted costs as the lm phases hold them
    if not all(h["finite"] and h["accepted_lanes"] >= 1 and h["accepted_lanes_plain"] >= 1
               and h["accept_agreement"] >= 0.999 and h["cost_within_1e-3"] >= 0.999 for h in held):
        raise AssertionError(f"detect_cli_device: a launch accepts no lane, or the LM kernel disagrees with its "
                             f"plain version on the CLI's lanes: {held}")
    # device_weights stays for the int8_cli phase, which removes it
    # the same shapes on synthetic lanes that straddle the accept threshold
    lm_detect_pair(lm, n_det, np.asarray(dcfg.DETECTOR.dim_ref, np.float32), float(dcfg.DETECTOR.DIM_PRIOR_WEIGHT), 1)

    # detect_cli_parity: the host config (fp32, TF32 off), 4 test frames at
    # batch 3 (a padded tail), on the card and on the CPU with the same
    # weights: the checkpoint's, its vertex head set to draw a car
    with open(os.path.join(tree, "ImageSets", "test.txt")) as f:
        test_names = sorted(f.read().split())
    with open(os.path.join(tree, "ImageSets", "parity.txt"), "w") as f:
        f.write("\n".join(test_names[:PARITY_FRAMES]) + "\n")
    host_cfg = os.path.join(configs, "rtm3d_dla34_kitti.yaml")
    lifted = ["DETECTOR.SCORE_THRESH", "0.0", "DETECTOR.RESIDUAL_THRESH", "1e9"]
    cfg = load_config(host_cfg, lifted)
    K = create_dataset(tree, cfg, is_training=False, split="parity")[0]["calib"].reshape(3, 3)
    weights = os.path.join(root, "parity_weights.pt")
    torch.save(car_head(load_torch_weights(checkpoint)[0], K), weights)
    argv = ["--model-config", host_cfg, "--data-path", tree, "--split", "parity", "--batch-size",
            str(PARITY_BATCH), "--checkpoint", weights]
    gpu_dir, cpu_dir = os.path.join(root, "results_parity_gpu"), os.path.join(root, "results_parity_cpu")
    gpu, parity_launches, _ = detect(argv + ["--out-dir", gpu_dir, "--set", *lifted])
    t0 = time.perf_counter()
    cli_detect.main(argv + ["--out-dir", cpu_dir, "--device", "cpu", "--set", *lifted])
    cpu_s = time.perf_counter() - t0
    names = test_names[:PARITY_FRAMES]
    cmp = compare_result_dirs(cpu_dir, gpu_dir, names)
    # witnesses on the card, each against the CPU's lines: the plain LM in
    # the kernel's place (what the card's rounding alone moves), and the
    # kernel run wrong on purpose (what a fault in it would move)
    routes = {
        "plain_on_card": lambda solve, uv, x0, kp, iters=ITERS, lam0=1e-3, prior_weight=0.0:
            lm.lm_solve_reference(uv, x0, kp, iters, lam0, prior_weight),
        "kernel_no_prior": lambda solve, uv, x0, kp, iters=ITERS, lam0=1e-3, prior_weight=0.0:
            solve(uv, x0, kp, iters, lam0, 0.0),
        "kernel_half_prior": lambda solve, uv, x0, kp, iters=ITERS, lam0=1e-3, prior_weight=0.0:
            solve(uv, x0, kp, iters, lam0, prior_weight / 2),
        "kernel_iters4": lambda solve, uv, x0, kp, iters=ITERS, lam0=1e-3, prior_weight=0.0:
            solve(uv, x0, kp, 4, lam0, prior_weight),
        "kernel_iters2": lambda solve, uv, x0, kp, iters=ITERS, lam0=1e-3, prior_weight=0.0:
            solve(uv, x0, kp, 2, lam0, prior_weight),
    }
    witnesses, witness_launches = {}, {}
    for name, route in routes.items():
        wdir = os.path.join(root, f"results_parity_{name}")
        witness_launches[name] = detect(argv + ["--out-dir", wdir, "--set", *lifted], route)[1]
        witnesses[name] = compare_result_dirs(cpu_dir, wdir, names)
    # the kernel against the plain LM on the same card: the kernel alone
    kernel_vs_plain = compare_result_dirs(os.path.join(root, "results_parity_plain_on_card"), gpu_dir, names)
    fields = ("angle", "dim", "loc")
    # a kernel made wrong must part from the CPU by more than the gate
    caught = {n: any(w["max_abs"][k] > PARITY_GATE[k] for k in fields) for n, w in witnesses.items()
              if n != "plain_on_card"}
    rec = {"config": "rtm3d_dla34_kitti.yaml", "frames": PARITY_FRAMES, "batch": PARITY_BATCH,
           "img_size": gpu["img_size"], "batches": len(gpu["batch_s"]), "lm_launches": parity_launches,
           "cpu_run_s": cpu_s, **cmp, "gate": PARITY_GATE,
           "witnesses": {n: {"max_abs": w["max_abs"], "pose_agree_share": w["pose_agree_share"],
                             "lines": w["lines_got"], "lm_launches": witness_launches[n]} for n, w in witnesses.items()},
           "kernel_vs_plain_on_card": {"max_abs": kernel_vs_plain["max_abs"],
                                       "pose_agree_share": kernel_vs_plain["pose_agree_share"]},
           "gate_catches": caught}
    recs["detect_cli_parity"] = rec
    emit("detect_cli_parity", **rec)
    worst = cmp["max_abs"]
    if (cmp["lines"] != cmp["lines_got"] or cmp["lines"] != PARITY_FRAMES * int(cfg.DETECTOR.TOPK_CANDIDATES)
            or cmp["box_agree_share"] < PARITY_GATE["box_agree_share"] or parity_launches != 2 * len(gpu["batch_s"])
            or any(worst[k] > PARITY_GATE[k] for k in ("score", *fields))):
        raise AssertionError(f"detect_cli_parity: the card's result lines disagree with the CPU's: {rec}")
    if any(kernel_vs_plain["max_abs"][k] > PARITY_GATE[k] for k in ("score", *fields)):
        raise AssertionError(f"detect_cli_parity: the kernel's lines disagree with the plain LM's on the card: {rec}")
    if witness_launches["plain_on_card"] != 0 or not all(caught.values()):
        raise AssertionError(f"detect_cli_parity: a kernel made wrong stays within the gate: {rec}")

    # evaluate: the parity run's results and the ground truth written as
    # results (score 1.0), over the test split, by the CLI (C++ overlap);
    # then the same table with the plain overlap
    gt_dir = os.path.join(tree, "training", "label_2")
    gt_results = os.path.join(root, "results_gt")
    os.makedirs(gt_results, exist_ok=True)
    for name in test_names:
        with open(os.path.join(gt_dir, f"{name}.txt")) as f:
            lines = [l + " 1.0000" for l in f.read().splitlines() if l]
        with open(os.path.join(gt_results, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
    ev = ["--model-config", host_cfg, "--data-path", tree, "--split", "test", "--skip-detect"]
    t0 = time.perf_counter()
    table = cli_evaluate.main(ev + ["--out-dir", gpu_dir])
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = cli_evaluate.score(cfg, gt_dir, gpu_dir, test_names, impl="plain")
    plain_s = time.perf_counter() - t0
    gt_table = cli_evaluate.main(ev + ["--out-dir", gt_results])
    # the keys with a valid ground-truth box: each must score 100 on itself
    gts = [parse_kitti_line(l, False) for n in test_names
           for l in open(os.path.join(gt_dir, f"{n}.txt")).read().splitlines() if l]
    valid = [f"{c}_{m}_{d}" for c in cfg.DATASET.OBJs for d, (h, occ, trunc) in DIFFICULTY.items()
             if any(o["type"] == c and o["bbox"][3] - o["bbox"][1] >= h and o["occluded"] <= occ
                    and o["truncated"] <= trunc for o in gts) for m in ("bbox", "aos", "bev", "3d")]
    rec = {"split": "test", "images": len(test_names), "keys": len(table), "cpp_s": cpp_s, "plain_s": plain_s,
           "plain_equal": plain == table, "table": table, "gt_keys_with_valid_gt": len(valid),
           "gt_min_on_valid": min(gt_table[k] for k in valid) if valid else None}
    recs["evaluate"] = rec
    emit("evaluate", **rec)
    if (len(table) != 36 or not all(np.isfinite(v) for v in list(table.values()) + list(gt_table.values()))
            or not valid or any(gt_table[k] != 100.0 for k in valid) or not rec["plain_equal"]):
        raise AssertionError(f"evaluate: a key is not finite, the ground truth does not score 100 on itself, "
                             f"or the plain overlap gives another table: {rec}")
    shutil.rmtree(os.path.dirname(os.path.dirname(checkpoint)), ignore_errors=True)  # weights_device
    os.remove(weights)
    return {"launches": recs["detect_cli_device"]["lm_launches"] + parity_launches,
            "kfpn_launches": recs["detect_cli_device"]["kfpn_launches"], "records": recs,
            "max_abs_err": max(h["max_abs_cost_diff_accepted"] for h in held), "device_weights": device_weights}


def resnet18_phase(lm, splat, load_config, cli_train, cli_detect, cli_export, cli_stats, tree: str, smi: str) -> dict:
    """configs/rtm3d_resnet18_kitti.yaml as shipped (fp32, IS_RECT,
    ``pretrained`` with no file) on the data phase's tree: train, detect
    from the trained file through the config's own checkpoint path, export
    and serve from the artifacts, dataset statistics. See the module's
    docstring. Returns the kernels' launches by path and the records."""
    from rtm3d_tpu_torch.data.kitti import create_dataset
    from rtm3d_tpu_torch.data.loader import DataLoader
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.nn.model import create_model
    from rtm3d_tpu_torch.train.checkpoint import load_detect_weights
    from rtm3d_tpu_torch.train.step import make_detect_step, make_detect_step_from_export, make_train_step

    root = os.path.join(os.path.dirname(tree), "resnet18")
    shutil.rmtree(root, ignore_errors=True)
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", RESNET_CONFIG)
    cfg = load_config(config)
    recs, launches = {}, {}

    # train: 1 epoch as shipped, the batch as RESNET_TRAIN_BATCH says
    weights = os.path.join(root, "weights")
    argv = ["--model-config", config, "--data-path", tree, "--set", "TRAINING.WEIGHTS", weights,
            "SOLVER.MAX_EPOCH", "1", "BATCH_SIZE", str(RESNET_TRAIN_BATCH)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splat.splat_heatmap.launches = 0
    out, printed = echoed(cli_train.main, argv)
    torch.cuda.synchronize()
    launches["resnet18_train"] = splat.splat_heatmap.launches
    rec = cli_record(out, RESNET_TRAIN_BATCH, int(cfg.get("num_workers", 0)), launches["resnet18_train"])
    spans = out["history"][-1]["step_span_ms"]
    rec.update(card=smi, config=RESNET_CONFIG, dtype=str(cfg.TPU.COMPUTE_DTYPE), config_batch=int(cfg.BATCH_SIZE),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, step_ms_first=spans[0],
               step_ms_steady=float(np.mean(spans[1:])) if len(spans) > 1 else None,
               trained_from_init="training from init" in printed)
    recs["resnet18_train"] = rec
    emit("resnet18_train", **rec)
    check_cli_run("resnet18_train", rec, launches["resnet18_train"], out)
    if not rec["trained_from_init"]:
        raise AssertionError("resnet18_train: pretrained with an empty CHECKPOINT_FILE did not train from init")
    # the splat against its plain version on the first train batch's labels
    tcfg = load_config(config)
    tcfg.INPUT_SIZE = tuple(out["img_size"])
    batch = next(iter(DataLoader(create_dataset(tree, tcfg, is_training=True, split="train"), RESNET_TRAIN_BATCH,
                                 seed=20)))
    labels = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in batch["labels"].items()}
    down = int(cfg.MODEL.DOWN_SAMPLE)
    feat_hw = (tcfg.INPUT_SIZE[1] // down, tcfg.INPUT_SIZE[0] // down)
    inputs = heatmap_inputs(labels, float(down), cfg.DATASET.GAUSSIAN_GEN_TYPE, cfg.DATASET.BBOX_AREA_MAX,
                            cfg.DATASET.BBOX_AREA_MIN)
    splat_check = splat_phase(splat, inputs, feat_hw, len(cfg.DATASET.OBJs), "data_shape_resnet18")
    # where a step's time goes: two steps of the trained state on that batch
    step = make_train_step(tcfg, device="cuda")
    profile_calls("resnet18_train_profile", lambda: step(out["state"], batch), 2,
                  "chip_smoke_out/resnet18_train_profile.json")
    del out, batch, step
    torch.cuda.empty_cache()

    # detect from the trained file through the config's own path (a
    # .msgpack that does not exist, the port's .pt beside it), the vertex
    # head set to draw a car as in detect_cli_device
    pt = os.path.join(weights, cfg.MODEL.BACKBONE, "model_best.pt")
    K = create_dataset(tree, tcfg, is_training=False, split="train")[0]["calib"].reshape(3, 3)
    payload = torch.load(pt, map_location="cpu", weights_only=True)
    car_head(payload["model"], K, DEVICE_CAR_DEPTH)
    if payload["ema"] is not None:
        car_head(payload["ema"], K, DEVICE_CAR_DEPTH)
    torch.save(payload, pt)
    names = sorted(open(os.path.join(tree, "ImageSets", "train.txt")).read().split())
    n_det = RESNET_DETECT_BATCH * int(cfg.DETECTOR.TOPK_CANDIDATES)
    common = ["--model-config", config, "--data-path", tree, "--split", "train", "--batch-size",
              str(RESNET_DETECT_BATCH)]

    def served(name, extra):
        calls = []
        out_dir = os.path.join(root, f"results_{name}")
        summary, n, printed = detect_run(lm, cli_detect, common + ["--out-dir", out_dir] + extra, keeper(calls))
        held = lm_held(lm, calls, n_det)
        batches = len(summary["batch_s"])
        rec = {"card": smi, "img_size": summary["img_size"], "batch": RESNET_DETECT_BATCH, "images": summary["images"],
               "batches": batches, "result_files": len(os.listdir(out_dir)),
               "device_images_per_s": summary["device_images_per_s"],
               "wall_images_per_s": summary["wall_images_per_s"], "call_ms": [1e3 * t for t in summary["batch_s"]],
               "steady_call_ms": 1e3 * float(np.mean(summary["batch_s"][1:])), "lm_launches": n,
               "accepted_lanes": [h["accepted_lanes"] for h in held], "lm_held": held}
        if (summary["images"] != DATA_TRAIN or rec["result_files"] != DATA_TRAIN
                or summary["img_size"] != KITTI_RECT or n != 2 * batches or len(held) != n):
            emit(name, **rec)
            raise AssertionError(f"{name}: expected a result file for each of {DATA_TRAIN} frames, img_size "
                                 f"{KITTI_RECT} and 2 LM launches per batch: {rec}")
        if not all(h["finite"] and h["accept_agreement"] >= 0.999 and h["cost_within_1e-3"] >= 0.999 for h in held):
            emit(name, **rec)
            raise AssertionError(f"{name}: the LM kernel disagrees with its plain version: {held}")
        return rec, out_dir, printed

    missing = os.path.join(weights, cfg.MODEL.BACKBONE, "model_best.msgpack")
    rec, model_dir, printed = served("resnet18_detect", ["--set", "DETECTOR.CHECKPOINT", missing])
    rec["found_pt_beside_msgpack"] = "serving the port's checkpoint" in printed
    launches["resnet18_detect"] = rec["lm_launches"]
    recs["resnet18_detect"] = rec
    emit("resnet18_detect", **rec)
    if not rec["found_pt_beside_msgpack"]:
        raise AssertionError("resnet18_detect: the config's checkpoint path did not serve the trained .pt")

    # export (with and without decode, on the card; with decode on the CPU
    # for cpu,cuda), then serve each through cli.detect --from-export
    w, h = rec["img_size"]
    size = ["--set", "INPUT_SIZE", f"({w}, {h})"]
    exports, export_launches = {}, 0
    for name, extra in (("decode", ["--with-decode"]), ("forward", []),
                        ("decode_cpu_made", ["--with-decode", "--device", "cpu", "--platforms", "cpu,cuda"])):
        art = os.path.join(root, f"{name}.pt2")
        made = cli_export.main(["--model-config", config, "--output", art, "--checkpoint", pt, "--batch-size",
                                str(RESNET_DETECT_BATCH), *extra, *size])
        srec, out_dir, _ = served(f"export_detect_{name}", ["--from-export", art])
        export_launches += srec["lm_launches"]
        cmp = compare_result_dirs(model_dir, out_dir, names)
        srec.update(export_s=made["seconds"], artifact_mb=made["bytes"] / 1e6, platforms=made["platforms"],
                    vs_model={k: cmp[k] for k in ("lines", "lines_got", "box_agree_share", "max_abs")})
        exports[name] = srec
        emit(f"export_detect_{name}", **srec)
        worst = cmp["max_abs"]
        if (cmp["lines"] != cmp["lines_got"] or cmp["box_agree_share"] < PARITY_GATE["box_agree_share"]
                or any(worst[k] > PARITY_GATE[k] for k in ("score", "angle", "dim", "loc"))):
            raise AssertionError(f"export_detect_{name}: the artifact's result lines disagree with the model's: "
                                 f"{srec}")
    launches["export_detect"] = export_launches
    recs["export_detect"] = exports

    # the forward artifact's logits against the eager model's, and detect
    # calls from the artifact beside the eager step's: the first after the
    # load, then steady
    from rtm3d_tpu_torch.cli.export import load_exported

    ecfg = load_config(config)
    ecfg.INPUT_SIZE = (w, h)
    model = create_model(ecfg)
    load_detect_weights(pt, model)
    gen = torch.Generator(device="cuda").manual_seed(7)
    frames = torch.randint(0, 256, (RESNET_DETECT_BATCH, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
    Kb = torch.from_numpy(np.tile(np.asarray(K, np.float32), (RESNET_DETECT_BATCH, 1, 1))).cuda()
    art = load_exported(os.path.join(root, "forward.pt2"), "cuda")
    eager = make_detect_step(model, ecfg, device="cuda")
    with torch.inference_mode():
        x = ((frames.float() / 255.0 - torch.tensor(ecfg.DATASET.MEAN, device="cuda"))
             / torch.tensor(ecfg.DATASET.STD, device="cuda"))
        got = art(x)
        net = model.cuda().to(memory_format=torch.channels_last).eval()
        ref = net(x.permute(0, 3, 1, 2))
    rel = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item() for g, r in zip(got, ref)]
    del net, x, got, ref

    def timed(step):
        out = []
        for _ in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _ = {k: v.cpu() for k, v in step(frames, Kb).items()}  # ends in host memory, as a caller's
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return {"first_call_ms": out[0], "steady_call_ms": float(np.mean(out[1:]))}

    lm.lm_solve.launches = 0
    calls_ms = {"artifact_forward": timed(make_detect_step_from_export(art, ecfg, device="cuda")),
                "artifact_decode": timed(make_detect_step_from_export(
                    load_exported(os.path.join(root, "decode.pt2"), "cuda"), ecfg, device="cuda")),
                "eager": timed(eager)}
    torch.cuda.synchronize()
    timed_launches = lm.lm_solve.launches
    rec = {"card": smi, "batch": RESNET_DETECT_BATCH, "input": f"{w}x{h}", "logits_rel_err": rel,
           "calls": calls_ms, "lm_launches_per_call": timed_launches / 12}
    recs["export_calls"] = rec
    emit("export_calls", **rec)
    if max(rel) > 1e-4 or timed_launches != 2 * 12:
        raise AssertionError(f"export_calls: the artifact's logits leave the fp32 gate (1e-4 of the largest), or a "
                             f"call made other than 2 LM launches: {rec}")
    profile_calls("resnet18_detect_profile", lambda: eager(frames, Kb), 2, "chip_smoke_out/resnet18_detect_profile.json")
    del art, eager, model, frames
    for name in exports:
        os.remove(os.path.join(root, f"{name}.pt2"))
    torch.cuda.empty_cache()

    # dataset statistics, with the target overlays drawn by the splat kernel
    vis = os.path.join(root, "vis_targets")
    splat.splat_heatmap.launches = 0
    st = cli_stats.main(["--model-config", config, "--data-path", tree, "--vis-targets", vis])
    torch.cuda.synchronize()
    launches["stats"] = splat.splat_heatmap.launches
    keys = {"BBOX_AREA_MAX", "BBOX_AREA_MIN", "VERTEX_OFFSET_INFER", "num_images", "num_objects"}
    rec = {"card": smi, **{k: st[k] for k in sorted(keys)}, "overlays": len(st.get("overlays", [])),
           "splat_launches": launches["stats"]}
    recs["stats"] = rec
    emit("stats", **rec)
    if (not keys <= set(st) or st["num_images"] != DATA_TRAIN or rec["overlays"] != 4
            or launches["stats"] != rec["overlays"] or not all(os.path.exists(p) for p in st["overlays"])):
        raise AssertionError(f"stats: missing keys or overlays, or other than one splat launch per overlay: {rec}")
    shutil.rmtree(weights, ignore_errors=True)
    held = [hh for r in [recs["resnet18_detect"], *exports.values()] for hh in r["lm_held"]]
    return {"launches": launches, "records": recs, "splat_max_abs_err": splat_check["max_abs_err"],
            "lm_max_abs_err": max(hh["max_abs_cost_diff_accepted"] for hh in held)}


def int8_convs(quant, nn_model, load_config, config: str = "rtm3d_dla34_kitti_tpu.yaml") -> list:
    """Every conv of the full-width network under ``config`` (DLA-34 by
    default) at 1280x416 (a forward on the meta device, calibration's
    sweep, so the dead projections are in): its shape and whether a serving
    forward runs it int8 (``quant.conv_shapes``: the dead projections run in
    no forward, INT8_SKIP's stay float)."""
    cfg = load_config(os.path.join(CONFIGS, config))
    cfg.INPUT_SIZE = tuple(KITTI_RECT)
    w, h = KITTI_RECT
    with torch.device("meta"):
        model = nn_model.create_model(cfg).eval()
    return quant.conv_shapes(model, h, w, tuple(cfg.TPU.INT8_SKIP))


def int8_shape_groups(convs: list) -> dict:
    """{(cin, cout, k, stride, pad, dil, h, w): {"convs", "served"}}: the
    distinct conv shapes of ``convs``, how many convs have each, and how
    many of those a served forward runs int8."""
    groups = {}
    for c in convs:
        sig = (c["cin"], c["cout"], c["k"], c["stride"], c["pad"], c["dil"], c["h"], c["w"])
        g = groups.setdefault(sig, {"convs": 0, "served": 0})
        g["convs"] += 1
        g["served"] += int(c["served"])
    return groups


def int8_case(int8, sig: tuple, seed: int) -> tuple:
    """A conv of shape ``sig`` made from ``seed``: the generator, Cp, the
    int8 weights, packed, out_scale and bias; then the checks at
    INT8_CHECK_BATCH: quantize and conv_s8 against their plain versions,
    per-tensor and per-channel scales, fp32 and bf16 inputs, and the
    scales."""
    cin, cout, k, stride, pad, dil, h, w = sig
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cp = int8.padded_channels(cin)
    wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, device="cuda", dtype=torch.int8)
    packed = int8.pack_weight(wq)
    out_scale = torch.rand(cout, generator=gen, device="cuda") * 1e-3
    bias = torch.randn(cout, generator=gen, device="cuda")
    scales = {"per_tensor": torch.full((cin,), 3.0 / 127.0, device="cuda"),
              "per_channel": torch.rand(cin, generator=gen, device="cuda") * 0.05 + 0.005}
    x = torch.randn((INT8_CHECK_BATCH, cin, h, w), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    checks = {}
    for mode, scale in scales.items():
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            q, qr = int8.quantize(xd, scale, cp), int8.quantize_reference(xd, scale, cp)
            y = int8.conv_s8(q, packed, (k, k), stride, pad, dil, out_scale, bias, dtype)
            yr = int8.conv_s8_reference(qr, packed, (k, k), stride, pad, dil, out_scale, bias, dtype)
            torch.cuda.synchronize()
            checks[f"{mode}_{str(dtype)[6:]}"] = {
                "quantize_equal": bool(torch.equal(q, qr)), "conv_equal": bool(torch.equal(y, yr)),
                "quantize_max_abs_err": (q.int() - qr.int()).abs().max().item(),
                "max_abs_err": (y.float() - yr.float()).abs().max().item(), "finite": bool(torch.isfinite(y).all())}
    return gen, cp, wq, packed, out_scale, bias, scales, checks


def int8_kernel_phase(int8, convs: list, smi: str, check_convs: list = ()) -> dict:
    """quantize and conv_s8 against their plain versions on every distinct
    conv shape of ``convs``, at INT8_CHECK_BATCH, per-tensor and
    per-channel scales, fp32 and bf16 inputs: bit-equal. Then at the detect
    batch in bf16 (the served type), per-tensor: bit-equal again, and
    CUDA-event times of the kernels, the
    plain versions, the library yardstick (F.unfold + torch._int_mm) and
    cuDNN's bf16 conv, and the bound, each summed over one served forward
    (the convs that run int8 there, each as often as it runs). Each row
    names the kernel variant its shape takes (``conv_variant``). The shapes
    of ``check_convs`` (ResNet-18's) that ``convs`` lacks are checked at
    INT8_CHECK_BATCH only, untimed."""
    import torch.nn.functional as F

    groups = int8_shape_groups(convs)
    rows, failed = [], []
    for i, (sig, g) in enumerate(groups.items()):
        cin, cout, k, stride, pad, dil, h, w = sig
        gen, cp, wq, packed, out_scale, bias, scales, checks = int8_case(int8, sig, 100 + i)
        # times at the detect batch, bf16 as served, per-tensor scale
        xb = torch.randn((DETECT_BATCH, cin, h, w), generator=gen, device="cuda", dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        scale = scales["per_tensor"]
        qb = int8.quantize(xb, scale, cp)
        wb = torch.randn((cout, cin, k, k), generator=gen, device="cuda", dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        conv = functools.partial(int8.conv_s8, qb, packed, (k, k), stride, pad, dil, out_scale, bias, torch.bfloat16)
        plain = functools.partial(int8.conv_s8_reference, qb, packed, (k, k), stride, pad, dil, out_scale, bias,
                                  torch.bfloat16)
        # bit-equal at the served batch too: M = 32*Ho*Wo spans the kernel's whole grid
        qr, y, yr = int8.quantize_reference(xb, scale, cp), conv(), plain()
        torch.cuda.synchronize()
        checks["served_batch_per_tensor_bfloat16"] = {
            "quantize_equal": bool(torch.equal(qb, qr)), "conv_equal": bool(torch.equal(y, yr)),
            "quantize_max_abs_err": (qb.int() - qr.int()).abs().max().item(),
            "max_abs_err": (y.float() - yr.float()).abs().max().item(), "finite": bool(torch.isfinite(y).all())}
        del qr, y, yr
        t = {"quantize_ms": cuda_time_ms(lambda: int8.quantize(xb, scale, cp), 5, 1),
             "conv_ms": cuda_time_ms(conv, 5, 1),
             "plain_quantize_ms": cuda_time_ms(lambda: int8.quantize_reference(xb, scale, cp), 1, 1),
             "plain_conv_ms": cuda_time_ms(plain, 1, 0),
             "library_ms": cuda_time_ms(lambda: int_mm_conv(qb, wq, stride, pad, dil), 2, 1),
             "cudnn_bf16_ms": cuda_time_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=pad, dilation=dil), 5, 1)}
        ops = int8.conv_s8_ops(DETECT_BATCH, cin, h, w, cout, (k, k), stride, pad, dil)
        nbytes = int8.conv_s8_bytes(DETECT_BATCH, cin, h, w, cout, (k, k), stride, pad, dil, 2)
        qbytes = int8.quantize_bytes(DETECT_BATCH, cin, h, w, 2)
        variant = int8.conv_variant(DETECT_BATCH, h, w, cp, cout, (k, k), stride, pad, dil, packed.shape[1])
        row = {"cin": cin, "cout": cout, "k": k, "stride": stride, "pad": pad, "dil": dil, "hw": [h, w],
               "variant": variant["name"], "convs": g["convs"], "served_per_forward": g["served"], "checks": checks, **t,
               "ops": ops, "bytes": nbytes, "conv_bound_ms": max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3,
               "conv_bound_by": "operations" if ops / PEAK_INT8_OPS > nbytes / PEAK_BYTES else "bytes",
               "quantize_bytes": qbytes, "quantize_bound_ms": qbytes / PEAK_BYTES * 1e3}
        row["conv_tops"] = ops / (t["conv_ms"] / 1e3) / 1e12
        rows.append(row)
        if not all(c["quantize_equal"] and c["conv_equal"] and c["finite"] for c in checks.values()):
            failed.append(row)
        del xb, qb, wb, conv, plain
        torch.cuda.empty_cache()
    extra = []
    for i, sig in enumerate(s for s in int8_shape_groups(check_convs) if s not in groups):
        cin, cout, k, stride, pad, dil, h, w = sig
        _, cp, _, packed, _, _, _, checks = int8_case(int8, sig, 200 + i)
        variant = int8.conv_variant(INT8_CHECK_BATCH, h, w, cp, cout, (k, k), stride, pad, dil, packed.shape[1])
        extra.append({"cin": cin, "cout": cout, "k": k, "stride": stride, "pad": pad, "dil": dil, "hw": [h, w],
                      "variant": variant["name"], "checks": checks})
        if not all(c["quantize_equal"] and c["conv_equal"] and c["finite"] for c in checks.values()):
            failed.append(extra[-1])
        torch.cuda.empty_cache()

    def total(key):
        return sum(r[key] * r["served_per_forward"] for r in rows)

    ops_bound = sum(r["ops"] / PEAK_INT8_OPS * 1e3 * r["served_per_forward"] for r in rows)
    bytes_bound = sum(r["bytes"] / PEAK_BYTES * 1e3 * r["served_per_forward"] for r in rows)
    rec = {"card": smi, "model": "DLA-34 rtm3d_dla34_kitti_tpu.yaml", "input": f"{KITTI_RECT[0]}x{KITTI_RECT[1]}",
           "convs": len(convs), "distinct_shapes": len(rows), "served_int8_convs_per_forward": sum(
               r["served_per_forward"] for r in rows), "check_batch": INT8_CHECK_BATCH, "time_batch": DETECT_BATCH,
           "forward": {k: total(k) for k in ("quantize_ms", "conv_ms", "plain_quantize_ms", "plain_conv_ms",
                                             "library_ms", "cudnn_bf16_ms", "conv_bound_ms", "quantize_bound_ms")},
           "forward_conv_bound_by": "operations" if ops_bound > bytes_bound else "bytes",
           "max_abs_err": max(c["max_abs_err"] for r in rows + extra for c in r["checks"].values()),
           "quantize_max_abs_err": max(c["quantize_max_abs_err"] for r in rows + extra for c in r["checks"].values()),
           "rows": rows, "checked_only": {"model": "ResNet-18 rtm3d_resnet18_kitti.yaml", "shapes": extra}}
    emit("int8_kernel", **rec)
    if failed:
        raise AssertionError(f"int8_kernel: a kernel disagrees with its plain version: {failed}")
    return rec


def int8_logits_phase(int8, quant, nn_model, load_config, normalize_images, smi: str) -> dict:
    """DLA-34 at 1280x416 b2 under configs/rtm3d_dla34_kitti.yaml (fp32, TF32
    off), mse scales calibrated on the card, INT8_SKIP applied: the int8
    network on the card (the kernels) and on the CPU (the plain versions).

    Conv by conv: each int8 conv's own float input, recorded on the card,
    goes through the CPU's plain quantize and conv; the card's int8 input
    and output must equal them bit for bit (INT8_LOGITS_GATE
    ``conv_by_conv_equal``). Witnesses on the card, on the same recorded
    inputs, that quantize or pack wrong on purpose must break that equality
    (truncation; weight scales per input channel); half-away-from-zero
    rounding differs on exact ties only, and is reported.

    Free-running: the card's and the CPU's networks each on their own
    float activations. An fp32 difference of an ulp that puts one input on
    the other side of a rounding edge changes one int8 value, which moves
    the next conv's outputs by a step and their inputs across edges in turn:
    the two int8 networks part far more than the two float ones, as far as
    int8 parts from float. So the card's logits are held to be finite only,
    and reported: the share of conv inputs that quantize equally and each
    logit's gaps beside the int8 network's own gap from the float one (on
    the CPU)."""
    import copy

    cfg = load_config(os.path.join(CONFIGS, "rtm3d_dla34_kitti.yaml"))
    cfg.INPUT_SIZE = tuple(KITTI_RECT)
    w, h = KITTI_RECT
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0)).eval()
    frames = torch.from_numpy((np.random.RandomState(8).rand(2, h, w, 3) * 255).astype(np.uint8))
    x = normalize_images(frames, cfg)
    scales = quant.calibrate_act_scales(copy.deepcopy(model).cuda(), [x.cuda()], method="mse")
    qmodel = quant.quantize_model(model, quant.skip_scales(scales, tuple(cfg.TPU.INT8_SKIP)))
    gpu_net = copy.deepcopy(qmodel).cuda().to(memory_format=torch.channels_last).eval()
    names = ("main_kf", "offset_fr_main", "main_offset", "vertex_offset")

    def forward(net, xin):
        """The logits on the CPU, and each QuantConv's (input, int8 input,
        output) on the CPU, in call order."""
        kept, hooks = [], []
        orig = int8.quantize

        def keep_q(t, scale, cpad):
            q = orig(t, scale, cpad)
            kept[-1][1] = q.cpu()
            return q

        keep_q.launches = 0  # the kernel's wrapper counts on whatever quantize names
        for m in net.modules():
            if isinstance(m, quant.QuantConv):
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, a: kept.append([a[0].to("cpu", copy=True), None, None, mod])))
                hooks.append(m.register_forward_hook(lambda mod, a, o: kept[-1].__setitem__(2, o.to("cpu", copy=True))))
        int8.quantize = keep_q
        try:
            with torch.inference_mode():
                logits = [t.float().cpu() for t in net(xin.permute(0, 3, 1, 2))]
        finally:
            int8.quantize = orig
            for hk in hooks:
                hk.remove()
        return logits, kept

    def gaps(got, want):
        return {n: {"rel_l2": ((g - c).norm() / c.norm()).item(), "max_abs_rel": ((g - c).abs().max() / c.abs().max()).item()}
                for n, g, c in zip(names, got, want)}

    gpu, kept_gpu = forward(gpu_net, x.cuda())
    t0 = time.perf_counter()
    cpu, kept_cpu = forward(qmodel, x)
    cpu_s = time.perf_counter() - t0
    with torch.inference_mode():
        float_cpu = [t.float() for t in model(x.permute(0, 3, 1, 2))]
    total = sum(k[1].numel() for k in kept_cpu)

    # conv by conv: the card's convs against the CPU's plain versions on the
    # card's own inputs
    by_name = {id(m): n for n, m in gpu_net.named_modules()}
    order = [by_name[id(k[3])] for k in kept_gpu]
    cpu_by_name = dict(qmodel.named_modules())
    plain = []
    with torch.inference_mode():
        for name, (xin, _, _, _) in zip(order, kept_gpu):
            mod = cpu_by_name[name]
            scale, _, _, _ = mod.pack()
            plain.append((int8.quantize_reference(xin, scale, int8.padded_channels(mod.in_channels)), mod(xin)))
    q_equal = sum(int((k[1] == p[0]).sum()) for k, p in zip(kept_gpu, plain))
    y_equal = all(torch.equal(k[2], p[1]) for k, p in zip(kept_gpu, plain))

    def rounded(fn):
        def quantize(t, scale, cpad):
            v = t.permute(0, 2, 3, 1).float() / scale
            q = fn(v).clamp_(-127, 127).to(torch.int8)
            return torch.nn.functional.pad(q, (0, cpad - q.shape[-1])).contiguous()
        return quantize

    @torch.no_grad()
    def pack_s_w_per_input_channel(conv):
        scale, _, out_scale, bias = orig_pack(conv)
        w_ = conv.weight.detach().float()
        s_in = (w_.abs().amax(dim=(0, 2, 3)) / torch.tensor(127.0, device=w_.device)).clamp_min(1e-12)
        wq = torch.round(w_ / s_in[None, :, None, None]).clamp_(-127, 127).to(torch.int8)
        return scale, int8.pack_weight(wq), out_scale, bias

    orig_quantize, orig_pack = int8.quantize, quant.QuantConv.pack
    gpu_mods = dict(gpu_net.named_modules())
    witnesses = {}
    for wname, variant in (("half_away_from_zero", rounded(lambda v: torch.sign(v) * torch.floor(v.abs() + 0.5))),
                           ("truncate", rounded(torch.trunc)), ("s_w_per_input_channel", None)):
        if variant is None:
            quant.QuantConv.pack = pack_s_w_per_input_channel
        else:
            variant.launches = 0
            int8.quantize = variant
        unequal_convs = 0
        try:
            with torch.inference_mode():
                for name, (xin, _, _, _), (_, y_plain) in zip(order, kept_gpu, plain):
                    mod = gpu_mods[name]
                    mod._packed = None
                    unequal_convs += not torch.equal(mod(xin.cuda()).cpu(), y_plain)
                    mod._packed = None
        finally:
            int8.quantize, quant.QuantConv.pack = orig_quantize, orig_pack
        witnesses[wname] = {"convs_unequal": unequal_convs, "caught": unequal_convs > 0}
    rec = {"card": smi, "input": f"{w}x{h}", "batch": 2, "dtype": "float32, TF32 off", "scales": "mse",
           "quantized_convs": len(kept_cpu), "quantized_values": total,
           "conv_by_conv": {"quantized_equal_share": q_equal / total, "outputs_equal": y_equal},
           "free_running": {"quantized_equal_share": sum(int((a[1] == b[1]).sum())
                                                         for a, b in zip(kept_gpu, kept_cpu)) / total,
                            "convs_with_an_unequal_input": sum(not torch.equal(a[1], b[1])
                                                               for a, b in zip(kept_gpu, kept_cpu)),
                            "logits_card_vs_cpu": gaps(gpu, cpu), "logits_int8_vs_float_cpu": gaps(cpu, float_cpu)},
           "logits_finite": all(bool(torch.isfinite(t).all()) for t in gpu),
           "cpu_forward_s": cpu_s, "gate": INT8_LOGITS_GATE, "witnesses": witnesses}
    emit("int8_logits", **rec)
    if q_equal != total or not y_equal or not rec["logits_finite"]:
        raise AssertionError(f"int8_logits: the card's int8 network leaves the gate: {rec}")
    if not (witnesses["truncate"]["caught"] and witnesses["s_w_per_input_channel"]["caught"]):
        raise AssertionError(f"int8_logits: a network quantized wrong on purpose passes conv by conv: {rec}")
    del gpu_net, kept_gpu, kept_cpu, plain
    torch.cuda.empty_cache()
    return rec


def int8_cli_phase(lm, int8, kf, quant, nn_model, load_config, cli_detect, cli_evaluate, tree: str, weights: str,
                   served_convs: int, smi: str) -> dict:
    """int8 serving through the port's CLIs on the data phase's tree,
    configs/rtm3d_dla34_kitti_tpu.yaml as it stands (1280x416, b32, bf16,
    device warp), the device-mode checkpoint with detect_cli_device's vertex
    head: calibrate (mse, 2 batches) and save the scales, serve 2D, the gate
    line; serve again from the saved scales (byte-identical files); serve
    with --int8-3d-anyway (2 LM launches a batch, each accepting lanes and
    held to the plain LM);
    evaluate --int8 --int8-guard 0.5 on the test split. Then the steady int8
    call against the bf16 call at the same shape (CUDA events) and
    torch.profiler over two int8 calls (chip_smoke_out/int8_profile.json).
    Every int8 detect call launches quantize and conv_s8 ``served_convs``
    times, and every forward of the network with autograd off, int8 or
    float (calibration's fp32 sweeps, the gate's two steps, serving), the
    KFPN fusion kernel twice."""
    root = os.path.dirname(tree)
    config = os.path.join(CONFIGS, "rtm3d_dla34_kitti_tpu.yaml")
    cfg = load_config(config)
    n_det = DETECT_BATCH * int(cfg.DETECTOR.TOPK_CANDIDATES)
    scales_file = os.path.join(root, "int8_scales.json")
    common = ["--model-config", config, "--data-path", tree, "--split", "train", "--batch-size", str(DETECT_BATCH),
              "--checkpoint", weights, "--int8"]
    recs, launches, kfpn = {}, {}, {}

    def run(name, extra, route=None):
        int8.quantize.launches = int8.conv_s8.launches = kf.kfpn_fuse.launches = 0
        out_dir = os.path.join(root, f"results_{name}")
        summary, n_lm, printed = detect_run(lm, cli_detect, common + ["--out-dir", out_dir] + extra, route)
        launches[name] = {"quantize": int8.quantize.launches, "conv_s8": int8.conv_s8.launches, "lm": n_lm}
        kfpn[name] = kf.kfpn_fuse.launches
        batches = len(summary["batch_s"])
        rec = {"card": smi, "img_size": summary["img_size"], "images": summary["images"], "batches": batches,
               "result_files": len(os.listdir(out_dir)), "call_ms": [1e3 * t for t in summary["batch_s"]],
               "steady_call_ms": 1e3 * float(np.mean(summary["batch_s"][1:])),
               "device_images_per_s": summary["device_images_per_s"], "wall_images_per_s": summary["wall_images_per_s"],
               "launches": launches[name], "kfpn_launches": kfpn[name]}
        if summary["images"] != DATA_TRAIN or rec["result_files"] != DATA_TRAIN or summary["img_size"] != KITTI_RECT:
            emit(name, **rec)
            raise AssertionError(f"{name}: expected a result file for each of {DATA_TRAIN} frames at {KITTI_RECT}")
        return rec, out_dir, printed, batches

    rec, dir1, printed, batches = run("int8_cli_calibrated", ["--calib-scales", scales_file])
    gate = GATE_LINE.search(printed)
    rec.update(gate_line=next((l for l in printed.splitlines() if "int8 gate" in l), None),
               calibrated="int8: calibrated 58 conv activation scales (mse)" in printed,
               serving_2d="int8: serving 2D-only" in printed,
               gate={k: float(v) for k, v in zip(("float", "int8", "matched", "recall"), gate.groups())} if gate else None)
    recs["int8_cli_calibrated"] = rec
    emit("int8_cli_calibrated", **rec)
    # the gate's 2 calibration batches run the int8 step too; the network
    # runs batches + 8 times: the 2 batches through mse calibration's two
    # fp32 sweeps and the gate's float and int8 steps, then serving
    want = served_convs * (batches + 2)
    if (not rec["calibrated"] or not rec["serving_2d"] or gate is None or not os.path.exists(scales_file)
            or launches["int8_cli_calibrated"] != {"quantize": want, "conv_s8": want, "lm": 0}
            or kfpn["int8_cli_calibrated"] != 2 * (batches + 8)):
        raise AssertionError(f"int8_cli_calibrated: no calibration, gate line or scales file, or other than "
                             f"{served_convs} int8 convs and 2 KFPN fusion launches per forward and no LM: {rec}")

    rec, dir2, printed, batches = run("int8_cli_loaded", ["--calib-scales", scales_file])
    names = sorted(os.listdir(dir1))
    rec["files_byte_identical"] = names == sorted(os.listdir(dir2)) and all(
        open(os.path.join(dir1, n), "rb").read() == open(os.path.join(dir2, n), "rb").read() for n in names)
    rec["gate_skipped_notice"] = "int8 gate skipped" in printed
    recs["int8_cli_loaded"] = rec
    emit("int8_cli_loaded", **rec)
    want = served_convs * batches
    if (not rec["files_byte_identical"] or not rec["gate_skipped_notice"]
            or launches["int8_cli_loaded"] != {"quantize": want, "conv_s8": want, "lm": 0}
            or kfpn["int8_cli_loaded"] != 2 * batches):
        raise AssertionError(f"int8_cli_loaded: the scales from disk serve other files, or the launches are off: {rec}")

    calls = []
    rec, _, _, batches = run("int8_cli_3d", ["--calib-scales", scales_file, "--int8-3d-anyway", "--int8-no-gate"],
                             keeper(calls))
    held = lm_held(lm, calls, n_det)
    rec.update(accepted_lanes=[hh["accepted_lanes"] for hh in held], lm_held=held)
    recs["int8_cli_3d"] = rec
    emit("int8_cli_3d", **rec)
    want = served_convs * batches
    if (launches["int8_cli_3d"] != {"quantize": want, "conv_s8": want, "lm": 2 * batches} or len(held) != 2 * batches
            or kfpn["int8_cli_3d"] != 2 * batches
            or not all(hh["finite"] and hh["accepted_lanes"] >= 1 and hh["accepted_lanes_plain"] >= 1
                       and hh["accept_agreement"] >= 0.999 and hh["cost_within_1e-3"] >= 0.999 for hh in held)):
        raise AssertionError(f"int8_cli_3d: other than 2 LM and 2 KFPN fusion launches a batch, a launch accepts "
                             f"no lane, or the LM kernel disagrees with its plain version on the int8 lanes: {rec}")

    # evaluate --int8 --int8-guard 0.5 over the test split: the guard's
    # verdict is recorded (exit code 3 carries the three tables)
    int8.quantize.launches = int8.conv_s8.launches = lm.lm_solve.launches = 0
    ev = ["--model-config", config, "--data-path", tree, "--split", "test", "--checkpoint", weights, "--batch-size",
          str(DETECT_BATCH), "--int8", "--int8-guard", "0.5", "--out-dir", os.path.join(root, "results_int8_eval")]
    t0 = time.perf_counter()
    try:
        tables, tripped = echoed(cli_evaluate.main, ev)[0], False
    except cli_evaluate.Int8GuardTripped as e:
        tables, tripped = e.results, True
    torch.cuda.synchronize()
    launches["int8_evaluate"] = {"quantize": int8.quantize.launches, "conv_s8": int8.conv_s8.launches,
                                 "lm": lm.lm_solve.launches}
    rec = {"card": smi, "split": "test", "seconds": time.perf_counter() - t0, "guard": 0.5, "guard_tripped": tripped,
           "tables": tables, "launches": launches["int8_evaluate"]}
    recs["int8_evaluate"] = rec
    emit("int8_evaluate", **rec)
    if (sorted(tables) != ["delta", "float", "int8"] or not all(
            len(t) == 36 and all(np.isfinite(v) for v in t.values()) for t in tables.values())
            or launches["int8_evaluate"]["conv_s8"] == 0):
        raise AssertionError(f"int8_evaluate: expected three finite 36-key tables: {rec}")

    # the steady int8 call against the bf16 call, 2D as the int8 default serves
    from rtm3d_tpu_torch.train.checkpoint import load_detect_weights
    from rtm3d_tpu_torch.train.step import make_detect_step

    cfg.INPUT_SIZE = tuple(KITTI_RECT)
    model = nn_model.create_model(cfg)
    load_detect_weights(weights, model)
    scales = quant.skip_scales(quant.load_act_scales(scales_file), tuple(cfg.TPU.INT8_SKIP))
    steps = {"int8": make_detect_step(quant.quantize_model(model, scales), cfg, with_3d=False, device="cuda"),
             "bf16": make_detect_step(model, cfg, with_3d=False, device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(9)
    frames = torch.randint(0, 256, (DETECT_BATCH, KITTI_RECT[1], KITTI_RECT[0], 3), dtype=torch.uint8, device="cuda",
                           generator=gen)
    K = torch.from_numpy(np.tile(K_KITTI, (DETECT_BATCH, 1, 1))).cuda()
    calls_ms = {}
    for name in ("bf16", "int8", "int8", "bf16"):  # in turns
        out = []
        for _ in range(4):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _ = {k: v.cpu() for k, v in steps[name](frames, K).items()}
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        calls_ms.setdefault(name, []).append({"first_call_ms": out[0], "steady_call_ms": float(np.mean(out[1:]))})
    prof = profile_calls("int8_profile", lambda: steps["int8"](frames, K), 2, "chip_smoke_out/int8_profile.json")
    int8_ms = float(np.mean([c["steady_call_ms"] for c in calls_ms["int8"]]))
    bf16_ms = float(np.mean([c["steady_call_ms"] for c in calls_ms["bf16"]]))
    rec = {"card": smi, "batch": DETECT_BATCH, "input": f"{KITTI_RECT[0]}x{KITTI_RECT[1]}", "with_3d": False,
           "calls": calls_ms, "int8_steady_call_ms": int8_ms, "bf16_steady_call_ms": bf16_ms,
           "int8_over_bf16": int8_ms / bf16_ms, "int8_profile_device_ms": prof["device_busy_ms"] / prof["calls"]}
    recs["int8_calls"] = rec
    emit("int8_calls", **rec)
    del steps, model, frames
    torch.cuda.empty_cache()
    # the weights stay for the ddp_cli phase, which main removes after it
    return {"records": recs, "launches": launches, "kfpn_launches": kfpn}


def fused_warp_vs_cv2(tree: str, cfg) -> dict:
    """On one frame of the tree, one thread: ms of the fused warp (resize
    and pad to the 1280x416 frame, normalised float32 out:
    data/native.py::warp_normalize) against the cv2 path's resize and pad
    (uint8 out: the host config normalises on the device)."""
    from rtm3d_tpu_torch.data import image_io, native

    name = sorted(open(os.path.join(tree, "ImageSets", "train.txt")).read().split())[0]
    img = image_io.imread(os.path.join(tree, "training", "image_2", f"{name}.png"))
    h0, w0 = img.shape[:2]
    (sw, sh), r = KITTI_RECT, KITTI_RECT[0] / max(h0, w0)
    nw, nh = int(w0 * r), int(h0 * r)
    pad_w, pad_h = (sw - nw) // 2, (sh - nh) // 2
    M = np.array([[r, 0, pad_w], [0, r, pad_h]], np.float32)

    def cv2_path():
        out = np.full((sh, sw, 3), image_io.mean_color(img), np.uint8)
        out[pad_h:pad_h + nh, pad_w:pad_w + nw] = image_io.resize_linear(img, (nw, nh))
        return out

    def timed(fn, reps=10):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    return {"fused_warp_ms": timed(lambda: native.warp_normalize(img, M, (sh, sw), cfg.DATASET.MEAN, cfg.DATASET.STD)),
            "cv2_resize_pad_ms": timed(cv2_path), "frame": [h0, w0]}


def host_variants_phase(splat, load_config, cli_train, tree: str, cv2_rec: dict) -> dict:
    """The data phase's host-mode run (configs/rtm3d_dla34_kitti.yaml, b16, one
    loader thread, 1 epoch) again, with DATASET.FAST_PREPROC (the fused host
    C++ resample), and with IS_MOSAIC on MOSAIC_WORKERS loader workers:
    finite losses, one splat launch a step and eval batch; host ms a batch
    and wall img/s beside the cv2 run's."""
    root = os.path.dirname(tree)
    config = os.path.join(CONFIGS, "rtm3d_dla34_kitti.yaml")
    cfg = load_config(config)
    recs = {}
    # mosaic reads 4 frames a sample: 4 loader workers keep its epoch short
    for name, sets in (("fast_preproc", ["DATASET.FAST_PREPROC", "True"]),
                       ("mosaic", ["IS_MOSAIC", "True", "num_workers", str(MOSAIC_WORKERS)])):
        weights = os.path.join(root, f"weights_{name}")
        argv = ["--model-config", config, "--data-path", tree, "--set", "TRAINING.WEIGHTS", weights,
                "TRAINING.CHECKPOINT_MODE", "start", "SOLVER.MAX_EPOCH", "1", *sets]
        splat.splat_heatmap.launches = 0
        out = cli_train.main(argv)
        torch.cuda.synchronize()
        n = splat.splat_heatmap.launches
        rec = cli_record(out, int(cfg.BATCH_SIZE), MOSAIC_WORKERS if name == "mosaic" else int(cfg.get("num_workers", 0)),
                         n)
        rec.update(cv2_host_ms_per_batch=cv2_rec["host_ms_per_batch"],
                   cv2_last_epoch_wall_images_per_s=cv2_rec["last_epoch_wall_images_per_s"])
        if name == "fast_preproc":
            rec.update(fused_warp_vs_cv2(tree, cfg))
        recs[name] = rec
        emit(name, **rec)
        check_cli_run(name, rec, n, out)
        del out
        shutil.rmtree(weights, ignore_errors=True)
        torch.cuda.empty_cache()
    return recs


# -- TPU.REMAT, and the port's own tools (rtm3d_tpu_torch/tools/) --
REMAT_CHECK_HW, REMAT_CHECK_BATCH = (384, 128), 2  # remat_check: train_fp32's frame and batch
REMAT_GATE_REL = 1e-6  # remat_check: losses and each gradient, REMAT against none, TF32 off, deterministic
LATENCY_ITERS = 30
# real_parity: the reference leg solves each detection with scipy on the
# host, so top-K bounds its seconds: at the tool's default of 100 the leg
# took 55.2 and 60.2 s of host time on the card's machine, over the 60 s
# this phase may spend on it (PERF.md); 50 halves its solves
REAL_PARITY_TOPK, REAL_PARITY_BATCH, REAL_PARITY_BOOTSTRAP = 50, 8, 50
# the dry run's bars, as tests/test_torch_real_parity.py scores its tree:
# the devkit's bars leave every cell of synthetic frames at 0
REAL_PARITY_BARS = {"min_overlap": 0.3, "min_height": 0.0}
# |port - reference| in AP points a cell: tests/test_ap_parity.py's bound
# for the same weights through two serving stacks
REAL_PARITY_DELTA = 5.0
# real_parity: each leg's lines matched to the other's line of its frame
# and class with the nearest 2D box (compare_result_dirs). The legs share
# the network, the pixels and the decode, so a shared detection's box and
# score agree to the format's last digit; they differ in the solver, whose
# residual decides acceptance, so a line near RESIDUAL_THRESH may be on one
# leg only. Each leg's 3D boxes reproject onto their 2D boxes (the decoded
# vertices) within reproj_px: the scipy objective has no dimension prior,
# so its box may be the LM's at another scale (tests/test_detect_parity.py
# holds the two solvers alike only up to that scale); the fit to the
# vertices is what both must give. On KITTI's geometry the format's two
# decimals move a label's corners by up to 0.73 px, a yaw 0.05 rad off by
# 8.8 px (tests/test_torch_real_parity.py).
REAL_PARITY_GATE = {"box_agree_share": 0.9, "score": 1e-4 + 1e-9, "reproj_px": 2.0}


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, no autotuning, and torch's
    deterministic implementations (a warning where an op has none)."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


def remat_phase(cfg_base, nn_model, step_mod, state_mod, load_config, splat, trained: dict) -> dict:
    """TPU.REMAT. remat_check: one DLA-34 384x128 b2 fp32 step with REMAT
    against the same step without, same weights and batch, TF32 off and
    deterministic algorithms: the loss, aux and each gradient within
    REMAT_GATE_REL. remat: the train phase's config and shape (1280x384 b32
    bf16, EMA) with REMAT: ms a step and peak memory beside the train
    phase's, one splat launch a step; the REMAT peak must be below the
    train phase's (else REMAT saves nothing on this card)."""
    cfg = cfg_base.clone()
    cfg.INPUT_SIZE = REMAT_CHECK_HW
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = nn_model.create_model(cfg, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(3)
    w, h = REMAT_CHECK_HW
    batch = {"image": torch.from_numpy((rng.rand(REMAT_CHECK_BATCH, h, w, 3) * 255).astype(np.uint8)),
             "labels": synthetic_labels(rng, REMAT_CHECK_BATCH, TRAIN_OBJS, scale=0.3)}
    runs = {}
    with deterministic():
        for remat in (False, True):
            cfg.TPU.REMAT = remat
            state = state_mod.TrainState.create(model, cfg, device="cuda")
            state, m = step_mod.make_train_step(cfg, device="cuda")(state, batch)
            runs[remat] = (m["loss_items"].double().cpu(),
                           {k: p.grad.detach().double().cpu() for k, p in state.model.named_parameters()
                            if p.grad is not None})
    (aux_off, g_off), (aux_on, g_on) = runs[False], runs[True]
    aux_rel = ((aux_on - aux_off).abs() / aux_off.abs().clamp(min=1e-30)).max().item()
    per = {k: ((g_on[k] - g_off[k]).norm() / g_off[k].norm()).item() for k in g_off if g_off[k].norm() > 0}
    rec = {"input": f"{w}x{h}", "batch": REMAT_CHECK_BATCH, "loss_off": aux_off[4].item(), "loss_on": aux_on[4].item(),
           "aux_max_rel": aux_rel, "grad_l2_rel_max": max(per.values()),
           "grad_tensors_bit_equal": sum(torch.equal(g_on[k], g_off[k]) for k in g_off), "grad_tensors": len(g_off),
           "gate_rel": REMAT_GATE_REL}
    emit("remat_check", **rec)
    if set(g_on) != set(g_off) or aux_rel > REMAT_GATE_REL or max(per.values()) > REMAT_GATE_REL:
        raise AssertionError(f"remat_check: the step with TPU.REMAT parts from the step without: {rec}")

    cfg = load_config(os.path.join(CONFIGS, "rtm3d_dla34_kitti_tpu.yaml"))
    cfg.INPUT_SIZE = (W, H)
    cfg.BATCH_SIZE, cfg.DATASET.MAX_OBJS = TRAIN_BATCH, TRAIN_OBJS
    cfg.TPU.REMAT = True
    batches = train_batches()
    state = state_mod.TrainState.create(nn_model.create_model(cfg, torch.Generator().manual_seed(0)), cfg,
                                        device="cuda")
    step = step_mod.make_train_step(cfg, device="cuda")
    for b in batches[:TRAIN_WARMUP]:
        state, _ = step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    splat.splat_heatmap.launches = 0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    losses = []
    start.record()
    for b in batches[TRAIN_WARMUP:]:
        state, m = step(state, b)
        losses.append(m["loss"])
    end.record()
    torch.cuda.synchronize()
    launches = splat.splat_heatmap.launches
    ms = start.elapsed_time(end) / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = torch.stack(losses).cpu()
    rec = {"batch": TRAIN_BATCH, "input": f"{W}x{H}", "dtype": "bfloat16 autocast", "ema": True,
           "timed_steps": TRAIN_TIMED, "ms_per_step": ms, "images_per_s": TRAIN_BATCH / (ms / 1e3),
           "peak_mem_gb": peak, "splat_launches": launches,
           "train_phase_ms_per_step": trained["ms_per_step"], "train_phase_peak_mem_gb": trained["peak_mem_gb"],
           "step_time_ratio": ms / trained["ms_per_step"], "peak_ratio": peak / trained["peak_mem_gb"],
           "loss_first": losses[0].item(), "loss_last": losses[-1].item()}
    emit("remat", **rec)
    del state, batches
    torch.cuda.empty_cache()
    if not torch.isfinite(losses).all() or launches != TRAIN_TIMED:
        raise AssertionError(f"remat: a non-finite loss, or other than one splat launch a step: {rec}")
    if not peak < trained["peak_mem_gb"]:
        raise AssertionError(f"remat: the REMAT step's peak is not below the step's without it: {rec}")
    return rec


def bench_phase() -> dict:
    """``python -m rtm3d_tpu_torch.tools.bench`` and ``--b1`` (their lines
    echoed as the tool prints them): 2 LM launches a call, finite outputs."""
    from rtm3d_tpu_torch.tools import bench

    recs = {"b128": bench.main([]), "b1": bench.main(["--b1"])}
    emit("bench", **recs)
    for r in recs.values():
        if r["lm_launches_per_call"] != 2 or not np.isfinite(r["value"]) or not r["value"] > 0:
            raise AssertionError(f"bench: other than 2 LM launches a call, or no finite figure: {recs}")
    if not recs["b128"]["outputs_finite"]:
        raise AssertionError(f"bench: the detect outputs are not finite: {recs}")
    calls = {"b128": bench.ITERS, "b1": bench.B1_ITERS}
    return {"lm_launches": sum(round(r["lm_launches_per_call"] * calls[k]) for k, r in recs.items()), "records": recs}


def latency_phase() -> dict:
    """``python -m rtm3d_tpu_torch.tools.bench_latency``: DLA-34 bf16 at b1,
    8 and 32, the same with --int8, and ResNet-18 fp32 at b1 and 8,
    LATENCY_ITERS calls each; the reports to chip_smoke_out/latency_*.json.
    Gates: 2 LM launches a call, and under --int8 52 quantize and 52
    conv_s8 launches a DLA-34 call."""
    from rtm3d_tpu_torch.tools import bench_latency

    os.makedirs("chip_smoke_out", exist_ok=True)
    runs = {"bf16": ["--batches", "1,8,32"], "int8": ["--batches", "1,8,32", "--int8"],
            "resnet18_fp32": ["--batches", "1,8", "--backbone", "RESNET-18", "--dtype", "float32"]}
    recs, launches = {}, {"lm": 0, "conv_s8": 0, "quantize": 0}
    for name, argv in runs.items():
        report = bench_latency.main(argv + ["--iters", str(LATENCY_ITERS), "--out",
                                            f"chip_smoke_out/latency_{name}.json"])
        recs[name] = {r["batch"]: {"device": r["device"], "wall": r["wall"], "launches_per_call": r["launches_per_call"]}
                      for r in report["results"]}
        convs = 52 if name == "int8" else 0
        for r in report["results"]:
            per = r["launches_per_call"]
            if per["lm"] != 2 or per["conv_s8"] != convs or per["quantize"] != convs:
                raise AssertionError(f"latency_{name}: launches a call {per}, expected 2 LM and {convs} of each int8 "
                                     f"kernel: {r}")
            for k in launches:
                launches[k] += round(per[k] * r["iters"])
    emit("latency", **recs)
    return {"records": recs, "launches": launches}


def bench_train_phase(tree: str) -> dict:
    """``python -m rtm3d_tpu_torch.tools.bench_train``: step-only b32 bf16,
    then step-only b16 fp32 and --e2e on the data phase's tree at b16 with
    4 loader workers. Gates: one splat launch a step, finite losses."""
    from rtm3d_tpu_torch.tools import bench_train

    recs = {"bf16_b32": bench_train.main(["--batch", "32", "--dtype", "bfloat16"])}
    recs["fp32_b16"] = bench_train.main(["--batch", "16", "--e2e", "--data-path", tree, "--workers", "4"])
    lines = [recs["bf16_b32"]["step_only"], recs["fp32_b16"]["step_only"], recs["fp32_b16"]["e2e"]]
    emit("bench_train", **recs)
    if any(l["splat_launches_per_step"] != 1 or not np.isfinite(l["loss"]) for l in lines):
        raise AssertionError(f"bench_train: other than one splat launch a step, or a non-finite loss: {recs}")
    steps = [10, 10, recs["fp32_b16"]["e2e"]["steps"]]  # the tool's 10 timed steps, the e2e epochs' steps
    torch.cuda.empty_cache()
    return {"splat_launches": sum(round(l["splat_launches_per_step"] * n) for l, n in zip(lines, steps)),
            "records": recs}


def real_parity_phase(tree: str, weights: str) -> dict:
    """``python -m rtm3d_tpu_torch.tools.real_parity``, a dry run on the
    data phase's test split (20 frames of 375x1242 at 1280x416) at the dry
    run's bars (REAL_PARITY_BARS) with detect_cli_device's weights (the
    device run's EMA, the vertex head drawing a car), top-K
    REAL_PARITY_TOPK, the int8 leg, a bootstrap of REAL_PARITY_BOOTSTRAP.
    Gates: 20 result files on each leg, an accepted detection on each leg,
    27 cells on each grid, 2 LM launches a batch (and 52 of each int8
    kernel on the int8 leg); every cell's port-minus-reference delta within
    REAL_PARITY_DELTA; the port's lines against the reference's, each way,
    and every leg's 3D boxes against its 2D boxes (REAL_PARITY_GATE)."""
    from rtm3d_tpu_torch.ops import int8_conv
    from rtm3d_tpu_torch.tools import real_parity

    work = os.path.join(os.path.dirname(tree), "real_parity")
    int8_conv.conv_s8.launches = int8_conv.quantize.launches = 0
    t0 = time.perf_counter()
    out = real_parity.run_real_parity(tree, weights, split="test", backbone="DLA-34", input_size=1280,
                                      batch=REAL_PARITY_BATCH, work_dir=work, topk=REAL_PARITY_TOPK,
                                      bootstrap=REAL_PARITY_BOOTSTRAP, with_int8=True, **REAL_PARITY_BARS,
                                      progress=lambda *a: print(*a, file=sys.stderr, flush=True))
    seconds = time.perf_counter() - t0
    int8_launches = {"conv_s8": int8_conv.conv_s8.launches, "quantize": int8_conv.quantize.launches}
    dirs = {leg: os.path.join(work, f"results_{leg}") for leg in ("port", "torch", "int8")}
    files = {leg: len(os.listdir(d)) for leg, d in dirs.items()}
    names = sorted(open(os.path.join(tree, "ImageSets", "test.txt")).read().split())
    agree = {"port_vs_reference": compare_result_dirs(dirs["torch"], dirs["port"], names),
             "reference_vs_port": compare_result_dirs(dirs["port"], dirs["torch"], names)}
    reproj = {leg: reprojection_px(d, names, tree) for leg, d in dirs.items()}
    legs = {k: dict(v) for k, v in out["legs"].items()}
    cells = {grid: {k: c for k, c in out[grid].items() if c["port"] or c["torch"] or c["int8"]}
             for grid in ("ap_r40", "ap_r11")}
    rec = {"config": out["config"], "accepted_counts": out["accepted_counts"], "legs": legs, "files": files,
           "int8_launches": int8_launches, "seconds": seconds, "agreement": agree, "reprojection": reproj,
           "gate": REAL_PARITY_GATE,
           "delta_gate": REAL_PARITY_DELTA, "nonzero_cells": cells,
           "max_abs_delta": max(abs(c["delta"]) for grid in ("ap_r40", "ap_r11") for c in out[grid].values()),
           "car_3d_moderate_r40": out["ap_r40"]["Car_3d_moderate"],
           "grid_cells": {k: len(out[k]) for k in ("ap_r40", "ap_r11")},
           "bootstrap_car_3d": out["bootstrap"]["Car_3d_moderate"]}
    with open(os.path.join("chip_smoke_out", "real_parity.json"), "w") as f:
        json.dump({"report": out, "agreement": agree, "reprojection": reproj}, f, indent=1)
    emit("real_parity", **rec)
    want_int8 = 52 * legs["int8"]["batches"]
    if (set(files.values()) != {DATA_TEST} or min(out["accepted_counts"].values()) < 1
            or rec["grid_cells"] != {"ap_r40": 27, "ap_r11": 27}
            or any(legs[k]["lm_launches"] != 2 * legs[k]["batches"] for k in ("port", "int8"))
            or int8_launches != {"conv_s8": want_int8, "quantize": want_int8}):
        raise AssertionError(f"real_parity: a leg wrote other than {DATA_TEST} files or accepted nothing, a grid "
                             f"other than 27 cells, or other than 2 LM launches a batch: {rec}")
    if rec["max_abs_delta"] > REAL_PARITY_DELTA:
        raise AssertionError(f"real_parity: the port's AP parts from the reference's by more than "
                             f"{REAL_PARITY_DELTA} points: {rec}")
    if any(a["box_agree_share"] < REAL_PARITY_GATE["box_agree_share"] or a["agreed_score"] > REAL_PARITY_GATE["score"]
           for a in agree.values()):
        raise AssertionError(f"real_parity: the port's lines disagree with the reference pipeline's: {rec}")
    if any(r["max_px"] > REAL_PARITY_GATE["reproj_px"] for r in reproj.values()):
        raise AssertionError(f"real_parity: a leg's 3D boxes do not reproject onto its 2D boxes: {rec}")
    return {"lm_launches": legs["port"]["lm_launches"] + legs["int8"]["lm_launches"], "int8_launches": int8_launches,
            "record": rec}


# -- the production same-weights campaign (tools/ap_parity.py --production) and the tools on its work dir --
# the JAX record's recipe (docs/experiments/prod_r5_report.json): ResNet-18, input 512 (512x384 frames and
# input), b8, lr 1e-3, seed 20, the train frames served (eval split train), no augmentation, the int8 leg.
# Cut: its 64 train frames to AP_PROD["num_train"] and its 10,000 steps to AP_PROD_STEPS, its 10x drops at 5,000
# and 8,000 (PARITY.md; the JAX report does not record them) to AP_PROD_LR_DROPS. Cuts tried on an H100 (PERF.md,
# Findings): at a constant LR no line passes the residual gate; with the
# drops the port accepts nearly every labelled object, the scipy reference strands on 4 of the first 8 frames'
# objects (8 frames: 14 against 10, past the 25% gate), and int8 accepted lines at 8 and 12 frames (1; 6-7)
# but none at 10 or 16; so 12 frames (22 labelled objects; 21-22 against 17-18)
AP_PROD = dict(input_size=512, batch=8, lr=1e-3, seed=20, backbone="RESNET-18", num_train=12, num_test=32,
               train_augment=False, eval_split="train", bootstrap=100)
AP_PROD_STEPS, AP_PROD_LR_DROPS = 3000, (2200, 2700)
AP_PROD_FULL = {"steps": 10000, "num_train": 64, "lr_drops": (5000, 8000)}  # the JAX record's
# ap_parity_production: the loss falls 100x; each float leg accepts a quarter of the split's labelled
# Car/Pedestrian/Cyclist objects; the float legs' counts within 25% of the larger (JAX record: 107 and 93);
# the int8 leg accepts; no moderate cell's port-minus-reference delta below -10 points (JAX: all >= 0)
AP_PROD_GATE = {"loss_fall": 100.0, "accepted_share_of_labels": 0.25, "float_counts_rel": 0.25, "int8_min": 1,
                "moderate_delta_min": -10.0}
# ap_parity_tools: both legs fp32 with TF32 off, so scores and vertices agree to float noise (the JAX record's
# 0.0064 and 0.129 px came from the TPU's bf16 passes); flips are expected near cost 0.1 (JAX: 27 of 134)
AP_TOOLS_GATE = {"dscore": 1e-3, "dvert_px": 0.05, "flip_share": 0.30, "deployed_cost": 1e-5}


def labelled_objects(data: str, split: str, classes) -> int:
    """Label lines of ``classes`` over ``split``'s frames."""
    names = open(os.path.join(data, "ImageSets", f"{split}.txt")).read().split()
    return sum(1 for n in names for line in open(os.path.join(data, "training", "label_2", f"{n}.txt"))
               if line.split() and line.split()[0] in classes)


def ap_parity_production_phase(smi: str) -> dict:
    """``run_production_parity`` (rtm3d_tpu_torch/tools/ap_parity.py) at the
    JAX record's recipe (AP_PROD), cut to AP_PROD["num_train"] train frames
    and AP_PROD_STEPS steps with drops at AP_PROD_LR_DROPS, training under
    TF32, serving with TF32 off; a fresh work dir. Gates (AP_PROD_GATE): the loss falls; one splat launch a
    step, 2 LM launches a port and int8 batch, one quantize and one conv_s8
    launch an int8 conv an int8 batch; each float leg accepts a quarter of
    the split's labelled objects, the float legs' counts within 25% of the
    larger, the int8 leg accepts; Car bbox moderate non-zero on both float
    legs; no moderate delta below the floor. The report to
    chip_smoke_out/ap_parity_production.json."""
    from rtm3d_tpu_torch.tools import ap_parity

    work = os.path.abspath(os.path.join("chip_smoke_out", "ap_parity"))
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    out = ap_parity.run_production_parity(work, steps=AP_PROD_STEPS, lr_drops=AP_PROD_LR_DROPS,
                                          save_every=AP_PROD_STEPS, progress=lambda *a: print(*a, file=sys.stderr,
                                                                                                flush=True),
                                          **AP_PROD)
    seconds = time.perf_counter() - t0
    with open(os.path.join("chip_smoke_out", "ap_parity_production.json"), "w") as f:
        json.dump(out, f, indent=1)
    data = os.path.join(work, "kitti")
    labels = labelled_objects(data, AP_PROD["eval_split"], ("Car", "Pedestrian", "Cyclist"))
    counts, legs, train = out["accepted_counts"], out["legs"], out["train"]
    moderate = {k: c for k, c in out["ap"].items() if k.endswith("_moderate")}
    rec = {"recipe": {**AP_PROD, "steps": AP_PROD_STEPS, "lr_drops": list(AP_PROD_LR_DROPS)},
           "cut": {"steps": f"{AP_PROD_STEPS} of the JAX record's {AP_PROD_FULL['steps']}",
                   "num_train": f"{AP_PROD['num_train']} of the JAX record's {AP_PROD_FULL['num_train']}",
                   "lr_drops": f"10x at {list(AP_PROD_LR_DROPS)} of the JAX record's {list(AP_PROD_FULL['lr_drops'])}"},
           "seconds": seconds, "train": train, "loss_first_last": out["loss_first_last"], "accepted_counts": counts,
           "labelled_objects": labels, "legs": legs, "moderate": moderate, "gate": AP_PROD_GATE,
           "bootstrap_car_bbox": out["bootstrap"]["Car_bbox_moderate"], "nvidia_smi": smi}
    emit("ap_parity_production", **rec)
    l0, l1 = out["loss_first_last"]
    q = legs["int8"]
    want_int8 = q["int8_convs"] * q["batches"]
    if (not l1 < l0 / AP_PROD_GATE["loss_fall"] or train["splat_launches"] != train["steps_run"]
            or train["steps_run"] != AP_PROD_STEPS
            or any(legs[k]["lm_launches"] != 2 * legs[k]["batches"] for k in ("port", "int8"))
            or q["conv_s8_launches"] != want_int8 or q["quantize_launches"] != want_int8 or want_int8 == 0):
        raise AssertionError(f"ap_parity_production: the loss did not fall {AP_PROD_GATE['loss_fall']}x, or other "
                             "than one splat launch a step, 2 LM launches a batch or one of each int8 kernel an "
                             f"int8 conv a batch: {rec}")
    floats = (counts["port"], counts["torch"])
    if (min(floats) < AP_PROD_GATE["accepted_share_of_labels"] * labels
            or max(floats) - min(floats) > AP_PROD_GATE["float_counts_rel"] * max(floats)
            or counts["int8"] < AP_PROD_GATE["int8_min"]):
        raise AssertionError(f"ap_parity_production: a float leg accepts under a quarter of the {labels} labelled "
                             f"objects, the float legs' counts part by more than 25%, or int8 accepts none: {rec}")
    car = out["ap"]["Car_bbox_moderate"]
    if not (car["port"] > 0 and car["torch"] > 0) or min(c["delta"] for c in moderate.values()) < \
            AP_PROD_GATE["moderate_delta_min"]:
        raise AssertionError(f"ap_parity_production: Car bbox moderate is 0 on a float leg, or a moderate cell's "
                             f"port-minus-reference delta is below {AP_PROD_GATE['moderate_delta_min']}: {rec}")
    return {"work": work, "launches": {"lm": legs["port"]["lm_launches"] + q["lm_launches"],
                                       "conv_s8": q["conv_s8_launches"], "quantize": q["quantize_launches"],
                                       "splat": train["splat_launches"]}, "record": rec}


def ap_parity_tools_phase(work: str) -> dict:
    """The four tools on ap_parity_production's work dir, at its input,
    batch and eval split: diag_same_weights (--out diag.json),
    solver_tune on it, precision_ladder and the int8_variants policy sweep
    (the summaries to chip_smoke_out/ap_parity_tools.json). Gates
    (AP_TOOLS_GATE): every port candidate matched and none unmatched on
    either side; max |d score| and max |d vertex|; gate flips at most a
    share of the matched; solver_tune's deployed row equal to diag's LM
    costs; precision_ladder's fp32 rung writing results_port's lines;
    every int8_variants row with one quantize and one conv_s8 launch an
    int8 conv a batch and 2 LM launches a batch."""
    from rtm3d_tpu_torch.tools import diag_same_weights, int8_variants, precision_ladder, solver_tune

    kw = dict(input_size=AP_PROD["input_size"], batch=AP_PROD["batch"], eval_split=AP_PROD["eval_split"])
    quiet = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    times = {}
    t0 = time.perf_counter()
    diag_path = os.path.join(work, "diag.json")
    diag = diag_same_weights.run(work, out=diag_path, say=quiet, **kw)
    times["diag"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tune = solver_tune.run(diag_path, out=os.path.join(work, "solver_tune.json"), say=quiet)
    times["solver_tune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ladder = precision_ladder.run(work, say=quiet, **kw)
    times["precision_ladder"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants = int8_variants.run(work, say=quiet, **kw)
    times["int8_variants"] = time.perf_counter() - t0
    rows = {k: v for k, v in variants.items() if isinstance(v, dict) and "launches" in v}
    names = sorted(os.listdir(os.path.join(work, "results_port")))
    same_lines = all(open(os.path.join(work, "results_port_fp32", n)).read()
                     == open(os.path.join(work, "results_port", n)).read() for n in names)
    s = diag["summary"]
    deployed = tune["variants"].get("kernel it40 prior20 (deployed)", {})
    rec = {"seconds": times, "diag": s, "diag_lm_launches": diag["config"]["lm_launches"],
           "solver_tune": {"matched": tune["matched"], "variants": tune["variants"]},
           "precision_ladder": {k: {f: v[f] for f in ("accepted", "worst_abs_dap_vs_torch", "lm_launches")}
                                for k, v in ladder.items() if k in precision_ladder.RUNGS},
           "precision_ladder_fp32_equals_results_port": same_lines, "torch_accepted": ladder["torch_accepted"],
           "int8_variants": {k: {f: v[f] for f in ("accepted", "accepted_frac", "worst_abs_dap", "int8_convs",
                                                   "batches", "launches")} for k, v in rows.items()},
           "float_accepted": variants["float_accepted"], "gate": AP_TOOLS_GATE}
    with open(os.path.join("chip_smoke_out", "ap_parity_tools.json"), "w") as f:
        json.dump(rec, f, indent=1)
    emit("ap_parity_tools", **rec)
    if s["n_matched"] == 0 or s["unmatched"] != {"jax_only": 0, "torch_only": 0}:
        raise AssertionError(f"ap_parity_tools: a candidate of one pipeline is unmatched in the other: {s}")
    if s["max_dscore"] > AP_TOOLS_GATE["dscore"] or s["max_dvert_px"] > AP_TOOLS_GATE["dvert_px"] \
            or s["gate_flips"] > AP_TOOLS_GATE["flip_share"] * s["n_matched"]:
        raise AssertionError(f"ap_parity_tools: scores, vertices or gate flips past {AP_TOOLS_GATE}: {s}")
    if tune["matched"] != s["n_matched"] or not deployed.get("deployed_vs_diag_max_abs", 1.0) <= \
            AP_TOOLS_GATE["deployed_cost"]:
        raise AssertionError(f"ap_parity_tools: solver_tune's deployed row is not diag's LM: {rec['solver_tune']}")
    if not same_lines:
        raise AssertionError("ap_parity_tools: precision_ladder's fp32 rung did not write results_port's lines")
    for name, r in rows.items():
        n = r["int8_convs"] * r["batches"]
        if r["launches"] != {"conv_s8": n, "quantize": n, "lm": 2 * r["batches"]} or n == 0:
            raise AssertionError(f"ap_parity_tools: {name} launched other than one of each int8 kernel an int8 "
                                 f"conv a batch and 2 LM a batch: {r}")
    lm = (diag["config"]["lm_launches"] + sum(v["lm_launches"] for v in tune["variants"].values())
          + sum(v["lm_launches"] for k, v in ladder.items() if k in precision_ladder.RUNGS)
          + sum(r["launches"]["lm"] for r in rows.values()))
    return {"launches": {"lm": lm, "conv_s8": sum(r["launches"]["conv_s8"] for r in rows.values()),
                         "quantize": sum(r["launches"]["quantize"] for r in rows.values())}, "record": rec}


# ap_parity_side_by_side: the JAX 100-step record's recipe (docs/experiments/ap_parity_100step_report.json)
AP_SBS = dict(input_size=256, num_train=64, num_test=16, steps=100, batch=8, lr=1e-3, seed=20, drift_steps=50,
              backbone="RESNET-18")
AP_SBS_RECORD = "docs/experiments/ap_parity_100step_report.json"
# the JAX harness's bounds (tests/test_ap_parity.py:41-47); the reference leg's first loss against the record's
# 1,218.7838: 3.9e-5 relative on an H100 (cv2 4.13, cuDNN fp32), 3.6e-6 on the CPU (cv2 5.0; PERF.md §6)
AP_SBS_GATE = {"drift0": 5e-3, "first10": 5e-2, "every": 0.5, "last_rel": 0.25, "first_loss_rel": 1e-4}


def ap_parity_side_by_side_phase(smi: str) -> dict:
    """``run_ap_parity`` (rtm3d_tpu_torch/tools/ap_parity.py) at AP_SBS in a
    fresh work dir, gated by AP_SBS_GATE and the launch counts (module
    docstring). The report to chip_smoke_out/ap_parity_side_by_side.json."""
    from rtm3d_tpu_torch.tools import ap_parity, twin

    work = os.path.abspath(os.path.join("chip_smoke_out", "ap_parity_side_by_side"))
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    out = ap_parity.run_ap_parity(work, save_every=AP_SBS["steps"],
                                  progress=lambda *a: print(*a, file=sys.stderr, flush=True), **AP_SBS)
    seconds = time.perf_counter() - t0
    with open(os.path.join("chip_smoke_out", "ap_parity_side_by_side.json"), "w") as f:
        json.dump(out, f, indent=1)
    record = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), AP_SBS_RECORD)))
    want_first = record["loss_torch_first_last"][0]
    (p0, p1), (t0_, t1) = out["loss_port_first_last"], out["loss_torch_first_last"]
    drift, legs, train = out["loss_drift_curve"], out["legs"], out["train"]
    q = legs["int8"]
    want_int8 = q["int8_convs"] * q["batches"]
    first_rel = abs(t0_ - want_first) / want_first
    rec = {"recipe": AP_SBS, "seconds": seconds, "train": train,
           "loss_port_first_last": [p0, p1], "loss_torch_first_last": [t0_, t1],
           "record_first_loss": {"torch": want_first, "jax": record["loss_jax_first_last"][0], "rel": first_rel},
           "drift0": drift[0], "max_drift_first_10": max(drift[:10]),
           f"max_drift_first_{AP_SBS['drift_steps']}": max(drift), "final_drift": out["final_drift"],
           "twin_sha256": out["config"]["twin_sha256"],
           "twin_sha256_matches_cpu": out["config"]["twin_sha256"] == twin.TWIN_SHA256[AP_SBS["backbone"]],
           "legs": legs, "accepted_counts": out["accepted_counts"],
           "moderate": {k: c for k, c in out["ap"].items() if k.endswith("_moderate")}, "gate": AP_SBS_GATE,
           "nvidia_smi": smi}
    emit("ap_parity_side_by_side", **rec)
    g = AP_SBS_GATE
    if not (p1 < p0 and t1 < t0_) or first_rel > g["first_loss_rel"]:
        raise AssertionError(f"ap_parity_side_by_side: a loss did not fall, or the reference leg's first loss is "
                             f"more than {g['first_loss_rel']} from the record's {want_first}: {rec}")
    if (drift[0] >= g["drift0"] or max(drift[:10]) >= g["first10"] or max(drift) >= g["every"]
            or abs(p1 - t1) / max(abs(t1), 1e-9) >= g["last_rel"]):
        raise AssertionError(f"ap_parity_side_by_side: the drift leaves the JAX harness's bounds: {rec}")
    steps = AP_SBS["steps"]
    if (train["steps_run"] != steps or train["port"]["splat_launches"] != steps
            or train["torch"]["splat_launches"] != steps
            or any(legs[k]["lm_launches"] != 2 * legs[k]["batches"] for k in ("port", "int8", "samew"))
            or q["conv_s8_launches"] != want_int8 or q["quantize_launches"] != want_int8 or want_int8 == 0):
        raise AssertionError("ap_parity_side_by_side: other than one splat launch a step in each leg's target "
                             "build, 2 LM launches a port, int8 and samew batch, or one of each int8 kernel an "
                             f"int8 conv a batch: {rec}")
    if train["port"]["tf32"] != {"cudnn": True, "matmul": True} or \
            train["torch"]["tf32"] != {"cudnn": False, "matmul": False}:
        raise AssertionError(f"ap_parity_side_by_side: the legs did not train under their TF32 flags: {train}")
    return {"launches": {"lm": sum(legs[k]["lm_launches"] for k in ("port", "int8", "samew")),
                         "conv_s8": q["conv_s8_launches"], "quantize": q["quantize_launches"],
                         "splat": train["port"]["splat_launches"] + train["torch"]["splat_launches"]},
            "record": rec}


# -- data parallelism (parallel/dist.py): two gloo ranks sharing the card, and torchrun at world size 1 --
DDP_WORLD = 2
DDP_FP32_HW, DDP_FP32_BATCH, DDP_FP32_STEPS = (384, 128), 4, 3  # ddp_fp32: train_fp32's frame, global batch 4
DDP_FULL_WARMUP, DDP_FULL_TIMED = 3, 5  # ddp_full: the train phase's config at global batch TRAIN_BATCH
DDP_TIMEOUT_S = 600
# ddp_fp32: two ranks against one on the card, fp32 with TF32 off. The loss of
# each step within 1e-4 relative and step 1's gradient within train_fp32's
# gates (this network's float32 noise). After 3 steps the parameters within
# 2 x the summed learning rates (each Adamax update moves a coordinate by at
# most about lr, so a sign that float32 noise flips costs 2 lr) and each BN
# running statistic within DDP_BN_REL of its tensor's largest value (an
# H100 measured 8.5e-5, a twelfth of it). The
# learning rate is DDP_FP32_LR with no warm-up: at the default schedule's
# first rates (1e-5) the flipped signs move the third step's loss by 2e-4
# (measured on the CPU at 64x64).
DDP_GATE = {"loss_rel": 1e-4, "grad_l2_total": 5e-2, "grad_l2_tensor": 1e-1}
DDP_BN_REL = 1e-3
DDP_FP32_LR = 1e-6


def dist_probe() -> dict:
    """What the card's machine offers data parallelism: NCCL's version,
    whether gloo takes CUDA tensors in all_reduce and broadcast (a gloo
    group of one rank), and whether tensorstore and orbax import (the JAX
    package's checkpoint directories need them)."""
    import importlib

    import torch.distributed as tdist

    out = {"nccl": ".".join(map(str, torch.cuda.nccl.version()))
           if isinstance(torch.cuda.nccl.version(), tuple) else str(torch.cuda.nccl.version())}
    store = os.path.abspath(os.path.join("chip_smoke_out", "ddp", "probe_store"))
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    tdist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1)
    try:
        for name, op in (("all_reduce", tdist.all_reduce), ("broadcast", lambda t: tdist.broadcast(t, 0))):
            try:
                t = torch.full((4,), 3.0, device="cuda")
                op(t)
                torch.cuda.synchronize()
                out[f"gloo_cuda_{name}"] = bool(torch.equal(t.cpu(), torch.full((4,), 3.0)))
            except RuntimeError as e:
                out[f"gloo_cuda_{name}"] = f"refused: {str(e)[:160]}"
    finally:
        tdist.destroy_process_group()
    for mod in ("tensorstore", "orbax.checkpoint"):
        try:
            m = importlib.import_module(mod)
            out[mod] = getattr(m, "__version__", "imports")
        except ImportError as e:
            out[mod] = f"does not import: {str(e)[:120]}"
    return out


def ddp_launch(cmd: list, world: int, tag: str, env_extra=None) -> None:
    """``cmd`` once per rank (``{rank}`` in it replaced), outputs to
    chip_smoke_out/ddp/<tag>.rank<r>.log, waited for with a timeout; every
    process is ended before it returns, and a rank that failed raises with
    its log's end."""
    logdir = os.path.abspath(os.path.join("chip_smoke_out", "ddp"))
    os.makedirs(logdir, exist_ok=True)
    procs = []
    for r in range(world):
        path = os.path.join(logdir, f"{tag}.rank{r}.log")
        log = open(path, "w")
        procs.append((subprocess.Popen([c.replace("{rank}", str(r)) for c in cmd], stdout=log,
                                       stderr=subprocess.STDOUT, env=dict(os.environ, **(env_extra or {}))),
                      log, path))
    try:
        for p, _, _ in procs:
            p.wait(timeout=DDP_TIMEOUT_S)
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            log.close()
    for r, (p, _, path) in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{tag}: rank {r} exited {p.returncode}: {open(path).read()[-3000:]}")


def fp32_ddp_config():
    from rtm3d_tpu_torch import default_config

    cfg = default_config()
    cfg.INPUT_SIZE = DDP_FP32_HW
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.BATCH_SIZE = DDP_FP32_BATCH
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = DDP_FP32_LR, 0
    return cfg


def fp32_ddp_batches(rows: slice) -> list:
    """ddp_fp32's global batches (seeded), ``rows`` of each."""
    rng = np.random.RandomState(6)
    w, h = DDP_FP32_HW
    out = []
    for _ in range(DDP_FP32_STEPS):
        img = (rng.rand(DDP_FP32_BATCH, h, w, 3) * 255).astype(np.uint8)
        labels = synthetic_labels(rng, DDP_FP32_BATCH, TRAIN_OBJS, scale=0.3)
        out.append({"image": torch.from_numpy(img[rows]), "labels": {k: v[rows] for k, v in labels.items()}})
    return out


def fp32_ddp_steps(rows: slice, steps: int = DDP_FP32_STEPS) -> dict:
    """``steps`` train steps of ddp_fp32 on ``rows`` of each global batch,
    from create_model's seed-0 weights, on the card: each step's loss
    items and parameter hash, step 1's gradients, and the parameters and
    BN running statistics after the last."""
    import hashlib

    from rtm3d_tpu_torch.nn.model import create_model
    from rtm3d_tpu_torch.train.state import TrainState
    from rtm3d_tpu_torch.train.step import make_train_step

    cfg = fp32_ddp_config()
    state = TrainState.create(create_model(cfg, torch.Generator().manual_seed(0)), cfg, device="cuda")
    step = make_train_step(cfg, device="cuda")
    out = {"loss_items": [], "digests": [], "lrs": []}
    for i, b in enumerate(fp32_ddp_batches(rows)[:steps]):
        out["lrs"].append(state.schedule(state.updates))
        state, m = step(state, b)
        out["loss_items"].append(m["loss_items"].cpu())
        h = hashlib.sha256()
        for p in state.model.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
        out["digests"].append(h.hexdigest())
        if i == 0:
            out["grads"] = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    out["params"] = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    out["buffers"] = {k: b.detach().cpu() for k, b in state.model.named_buffers() if k.endswith(("_mean", "_var"))}
    return out


def ddp_rank_init(workdir: str, rank: int):
    from rtm3d_tpu_torch.parallel import dist

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # two ranks on one card: NCCL refuses that, so gloo (on CUDA tensors)
    return dist, dist.init_distributed("cuda:0", backend="gloo", init_method=f"file://{workdir}/store", rank=rank,
                                       world_size=DDP_WORLD, timeout=300)


def ddp_fp32_worker(workdir: str, rank: int) -> None:
    """One rank of ddp_fp32: the steps on this rank's rows, then the
    per-rank-BN witness (the sync turned off) for one step."""
    from rtm3d_tpu_torch.nn import layers
    from rtm3d_tpu_torch.ops import splat

    dist, _ = ddp_rank_init(workdir, rank)
    try:
        rows = slice(rank * DDP_FP32_BATCH // DDP_WORLD, (rank + 1) * DDP_FP32_BATCH // DDP_WORLD)
        splat.splat_heatmap.launches = 0
        run = fp32_ddp_steps(rows)
        torch.cuda.synchronize()
        run["splat_launches"] = splat.splat_heatmap.launches
        saved = layers.world_size
        layers.world_size = lambda: 1
        try:
            witness = fp32_ddp_steps(rows, 1)
        finally:
            layers.world_size = saved
        keep = run if rank == 0 else {k: run[k] for k in ("loss_items", "digests", "splat_launches")}
        keep["witness"] = {k: witness[k] for k in ("loss_items", "grads")} if rank == 0 else None
        torch.save(keep, os.path.join(workdir, f"fp32_rank{rank}.pt"))
    finally:
        dist.shutdown()


def ddp_fp32_phase() -> dict:
    """Two gloo ranks on the card against one rank on the same global
    batches (see DDP_GATE); the ranks' parameters hash equal after each
    step; the per-rank-BN witness must leave the gates."""
    workdir = os.path.abspath(os.path.join("chip_smoke_out", "ddp", "fp32"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    ddp_launch([sys.executable, os.path.abspath(__file__), "--ddp-worker", "fp32", workdir, "{rank}"], DDP_WORLD,
               "fp32")
    ranks_s = time.perf_counter() - t0
    one = fp32_ddp_steps(slice(None))
    r0, r1 = (torch.load(os.path.join(workdir, f"fp32_rank{r}.pt"), weights_only=False) for r in range(DDP_WORLD))

    def grads_apart(got):
        want = {k: g.double() for k, g in one["grads"].items()}
        per = {k: ((got[k].double() - g).norm() / g.norm()).item() for k, g in want.items() if g.norm() > 0}
        flat = lambda d: torch.cat([v.double().flatten() for v in d.values()])
        return ((flat(got) - flat(want)).norm() / flat(want).norm()).item(), max(per.values())

    def loss_rel(got):
        return max(((a - b).abs() / b.abs().clamp(min=1e-12)).max().item() for a, b in zip(got, one["loss_items"]))

    total, worst = grads_apart(r0["grads"])
    param_diff = max((r0["params"][k] - v).abs().max().item() for k, v in one["params"].items())
    bn_diff = max(((r0["buffers"][k] - v).abs().max() / v.abs().max().clamp(min=1e-12)).item()
                  for k, v in one["buffers"].items())
    w_total, w_worst = grads_apart(r0["witness"]["grads"])
    w_loss = loss_rel(r0["witness"]["loss_items"])
    param_bound = 2.01 * sum(one["lrs"])
    rec = {"ranks": DDP_WORLD, "backend": "gloo, both ranks on cuda:0", "input": "x".join(map(str, DDP_FP32_HW)),
           "global_batch": DDP_FP32_BATCH, "steps": DDP_FP32_STEPS, "dtype": "float32, TF32 off", "lr": DDP_FP32_LR,
           "loss_rel": max(loss_rel(r0["loss_items"]), loss_rel(r1["loss_items"])),
           "grad_l2_rel_total": total, "grad_l2_rel_worst": worst, "param_max_abs_diff": param_diff,
           "param_bound": param_bound, "bn_max_rel_diff": bn_diff, "bn_rel_gate": DDP_BN_REL,
           "ranks_hash_equal": r0["digests"] == r1["digests"], "gate": DDP_GATE,
           "splat_launches": [r0["splat_launches"], r1["splat_launches"]],
           "witness_per_rank_bn": {"loss_rel": w_loss, "grad_l2_rel_total": w_total, "grad_l2_rel_worst": w_worst},
           "ranks_wall_s": ranks_s}
    emit("ddp_fp32", **rec)
    if (rec["loss_rel"] > DDP_GATE["loss_rel"] or total > DDP_GATE["grad_l2_total"] or worst > DDP_GATE["grad_l2_tensor"]
            or param_diff > param_bound or bn_diff > DDP_BN_REL or not rec["ranks_hash_equal"]):
        raise AssertionError(f"ddp_fp32: two ranks disagree with one, or with each other: {rec}")
    if not (w_loss > DDP_GATE["loss_rel"] and w_total > DDP_GATE["grad_l2_total"]):
        raise AssertionError(f"ddp_fp32: the per-rank-BN witness stays within the gates: {rec}")
    if rec["splat_launches"] != [DDP_FP32_STEPS] * DDP_WORLD:
        raise AssertionError(f"ddp_fp32: expected one splat launch a rank a step: {rec}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"splat_launches": sum(rec["splat_launches"]), "record": rec}


def ddp_full_worker(workdir: str, rank: int) -> None:
    """One rank of ddp_full: the train phase's configuration, half of each
    global batch, DDP_FULL_WARMUP then DDP_FULL_TIMED steps (CUDA events);
    then the splat on the first batch against its plain version, and the
    gradient all-reduce and a BN-sized all-reduce timed alone."""
    from rtm3d_tpu_torch import load_config
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.nn.layers import BatchNorm
    from rtm3d_tpu_torch.nn.model import create_model
    from rtm3d_tpu_torch.ops import splat
    from rtm3d_tpu_torch.train.state import TrainState
    from rtm3d_tpu_torch.train.step import make_train_step

    dist, dev = ddp_rank_init(workdir, rank)
    try:
        cfg = load_config(os.path.join(CONFIGS, "rtm3d_dla34_kitti_tpu.yaml"))
        cfg.INPUT_SIZE = (W, H)
        cfg.BATCH_SIZE, cfg.DATASET.MAX_OBJS = TRAIN_BATCH, TRAIN_OBJS
        local = dist.local_batch_size(TRAIN_BATCH)
        gen = torch.Generator(device="cuda").manual_seed(40 + rank)
        rng = np.random.RandomState(40 + rank)
        batches = [{"image": torch.randint(0, 256, (local, H, W, 3), dtype=torch.uint8, device="cuda", generator=gen),
                    "labels": {k: v.cuda() for k, v in synthetic_labels(rng, local, TRAIN_OBJS).items()}}
                   for _ in range(DDP_FULL_WARMUP + DDP_FULL_TIMED)]
        model = create_model(cfg, torch.Generator().manual_seed(0))
        state = TrainState.create(model, cfg, device="cuda")
        step = make_train_step(cfg, device="cuda")
        dist.warmup_collectives(dev)
        for b in batches[:DDP_FULL_WARMUP]:
            state, _ = step(state, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        splat.splat_heatmap.launches = 0
        events, losses = [], []
        for b in batches[DDP_FULL_WARMUP:]:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, m = step(state, b)
            ev[1].record()
            events.append(ev)
            losses.append(m["loss_items"])
        torch.cuda.synchronize()
        launches = splat.splat_heatmap.launches
        step_ms = [a.elapsed_time(z) for a, z in events]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        bn_calls = sum(isinstance(mod, BatchNorm) for mod in state.model.modules())
        # the gradient all-reduce (one flat fp32 buffer) and one BN-sized
        # all-reduce, each timed alone with the ranks aligned
        flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
        small = torch.zeros(2 * 256 + 1, dtype=torch.float64, device="cuda")
        timed = {}
        for name, t, reps in (("grad_all_reduce_ms", flat, 5), ("bn_all_reduce_ms", small, 50)):
            dist.sync_processes(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                dist.all_reduce_sum(t)
            torch.cuda.synchronize()
            timed[name] = (time.perf_counter() - t0) / reps * 1e3
        labels = batches[0]["labels"]
        feat_hw = (H // 4, W // 4)
        inputs = heatmap_inputs(labels, 4.0, cfg.DATASET.GAUSSIAN_GEN_TYPE, cfg.DATASET.BBOX_AREA_MAX,
                                cfg.DATASET.BBOX_AREA_MIN)
        got = splat.splat_heatmap(*inputs, feat_hw, len(cfg.DATASET.OBJs))
        ref = splat.splat_heatmap_reference(*inputs, feat_hw, len(cfg.DATASET.OBJs))
        rec = {"rank": rank, "local_batch": local, "step_ms": step_ms, "peak_mem_gb": peak_gb,
               "splat_launches": launches, "losses": torch.stack(losses).cpu().tolist(),
               "splat_max_abs_err": (got - ref).abs().max().item(),
               "splat_ones_equal": bool(torch.equal(got == 1.0, ref == 1.0)), "bn_modules": bn_calls,
               "grad_elements": flat.numel(), **timed}
        with open(os.path.join(workdir, f"full_rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.shutdown()


def ddp_full_phase(smi: str) -> dict:
    """Two gloo ranks sharing the card at full width (see ddp_full_worker):
    finite losses equal on both ranks, one splat launch a rank a step, the
    splat against its plain version; per-rank step ms, all-reduce ms, peak
    memory a process. Two ranks on one card over gloo: not a scaling figure."""
    workdir = os.path.abspath(os.path.join("chip_smoke_out", "ddp", "full"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ddp_launch([sys.executable, os.path.abspath(__file__), "--ddp-worker", "full", workdir, "{rank}"], DDP_WORLD,
               "full")
    ranks = [json.load(open(os.path.join(workdir, f"full_rank{r}.json"))) for r in range(DDP_WORLD)]
    losses = [np.asarray(r["losses"]) for r in ranks]
    rec = {"label": "two ranks sharing one card, gloo: not a scaling figure", "card": smi,
           "config": "rtm3d_dla34_kitti_tpu.yaml", "input": f"{W}x{H}", "global_batch": TRAIN_BATCH,
           "dtype": "bfloat16 autocast", "ema": True, "max_objs": TRAIN_OBJS, "timed_steps": DDP_FULL_TIMED,
           "per_rank": [{k: r[k] for k in ("rank", "local_batch", "step_ms", "peak_mem_gb", "splat_launches",
                                           "grad_all_reduce_ms", "bn_all_reduce_ms", "splat_max_abs_err")}
                        for r in ranks],
           "ms_per_step": float(np.mean([np.mean(r["step_ms"]) for r in ranks])),
           "images_per_s": TRAIN_BATCH / (float(np.mean([np.mean(r["step_ms"]) for r in ranks])) / 1e3),
           "bn_modules": ranks[0]["bn_modules"], "grad_elements": ranks[0]["grad_elements"],
           "loss_first": losses[0][0][-1], "loss_last": losses[0][-1][-1],
           "losses_equal_across_ranks": bool(np.array_equal(losses[0], losses[1]))}
    emit("ddp_full", **rec)
    if not (all(np.isfinite(l).all() for l in losses) and rec["losses_equal_across_ranks"]):
        raise AssertionError(f"ddp_full: a loss is not finite, or the ranks' losses differ: {rec}")
    if any(r["splat_launches"] != DDP_FULL_TIMED for r in ranks):
        raise AssertionError(f"ddp_full: expected one splat launch a rank a step: {rec}")
    if any(r["splat_max_abs_err"] > 1e-6 or not r["splat_ones_equal"] for r in ranks):
        raise AssertionError(f"ddp_full: the splat kernel disagrees with its plain version: {rec}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"splat_launches": sum(r["splat_launches"] for r in ranks), "record": rec,
            "splat_max_abs_err": max(r["splat_max_abs_err"] for r in ranks)}


# -- the spatial mesh axis (parallel/spatial.py): two gloo ranks sharing the card as a 1 x 2 grid --
SPATIAL_CONFIG = "rtm3d_dla34_kitti_tpu.yaml"
SPATIAL_HW, SPATIAL_UNEVEN_HW = (W, H), (W, 416)  # bands 192 + 192; 224 + 192
SPATIAL_FP32_BATCH, SPATIAL_FP32_STEPS = 2, 3
SPATIAL_WARMUP, SPATIAL_TIMED = 2, 5  # the bf16 steps at global batch TRAIN_BATCH
# (i) and (iii): the grid against one rank on the card, fp32 with TF32 off,
# at ddp_fp32's gates (DDP_GATE on the losses and step 1's gradient; after
# (i)'s three steps the parameters within 2 x the summed learning rates);
# the zero-halo witness (zero rows at the band edges in place of the
# neighbours') must leave them


def spatial_config(hw, batch: int, dtype: str):
    from rtm3d_tpu_torch import load_config

    cfg = load_config(os.path.join(CONFIGS, SPATIAL_CONFIG))
    cfg.INPUT_SIZE = tuple(hw)
    cfg.BATCH_SIZE, cfg.DATASET.MAX_OBJS = batch, TRAIN_OBJS
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.SOLVER.BASE_LR, cfg.SOLVER.WARMUP_ITERS = DDP_FP32_LR, 0
    return cfg


def spatial_batches(hw, batch: int, steps: int, seed: int) -> list:
    """Seeded global batches of uint8 frames of ``hw`` (drawn on the card)
    and KITTI-like labels (synthetic_labels at 1280 wide), on the card."""
    rng = np.random.RandomState(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w, h = hw
    return [{"image": torch.randint(0, 256, (batch, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen),
             "labels": {k: v.cuda() for k, v in synthetic_labels(rng, batch, TRAIN_OBJS).items()}}
            for _ in range(steps)]


@functools.lru_cache(maxsize=1)
def spatial_template():
    """create_model's seed-0 DLA-34 of the spatial phase, on the CPU, built
    once a process (each run starts from a copy)."""
    from rtm3d_tpu_torch.nn.model import create_model

    return create_model(spatial_config(SPATIAL_HW, 1, "float32"), torch.Generator().manual_seed(0))


def spatial_steps(hw, batch: int, steps: int, dtype: str, seed: int, timed: int = 0, hashes: bool = False) -> dict:
    """``steps`` train steps of DLA-34 from create_model's seed-0 weights on
    the seeded batches, on this process's grid (or none): each step's loss
    items, CUDA-event span and (``hashes``) parameter hash, step 1's
    gradients, the parameters after the last; over the last ``timed``
    steps the peak memory and the halo exchanges' collectives and bytes."""
    import copy
    import hashlib

    from rtm3d_tpu_torch.parallel import spatial
    from rtm3d_tpu_torch.train.state import TrainState
    from rtm3d_tpu_torch.train.step import make_train_step

    cfg = spatial_config(hw, batch, dtype)
    state = TrainState.create(copy.deepcopy(spatial_template()), cfg, device="cuda")
    step = make_train_step(cfg, device="cuda")
    out = {"loss_items": [], "digests": [], "lrs": [], "step_ms": []}
    for i, b in enumerate(spatial_batches(hw, batch, steps, seed)):
        if i == steps - timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            spatial.halo_exchange.collectives = spatial.halo_exchange.bytes = 0
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        out["lrs"].append(state.schedule(state.updates))
        ev[0].record()
        state, m = step(state, b)
        ev[1].record()
        out["loss_items"].append(m["loss_items"].cpu())
        out["step_ms"].append(ev)
        if i == 0:
            out["grads"] = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
        if hashes:
            h = hashlib.sha256()
            for p in state.model.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
            out["digests"].append(h.hexdigest())
    torch.cuda.synchronize()
    out["step_ms"] = [a.elapsed_time(z) for a, z in out["step_ms"]][steps - timed:] if timed else []
    if timed:
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["halo_collectives_per_step"] = spatial.halo_exchange.collectives / timed
        out["halo_mb_per_step"] = spatial.halo_exchange.bytes / timed / 1e6
    out["params"] = {k: p.detach().cpu() for k, p in state.model.named_parameters()}
    return out


def all_gather_probe() -> dict:
    """Whether gloo takes CUDA tensors in all_gather between the two ranks
    (all_reduce is the transport; all_gather is not used). Run last: gloo's
    send on a CUDA tensor hands the device pointer to the socket, and the
    next collective on that pair fails with "writev ... Bad address" (seen
    on an H100), so send/recv is not probed."""
    import torch.distributed as tdist

    try:
        t = torch.full((4,), float(tdist.get_rank() + 1), device="cuda")
        got = [torch.zeros_like(t) for _ in range(2)]
        tdist.all_gather(got, t)
        torch.cuda.synchronize()
        return {"gloo_cuda_all_gather": bool(torch.equal(torch.stack(got).cpu(), torch.tensor([[1.0] * 4, [2.0] * 4])))}
    except RuntimeError as e:
        return {"gloo_cuda_all_gather": f"refused: {str(e)[:160]}"}


def spatial_worker(workdir: str, rank: int) -> None:
    """One rank of the spatial phase, a 1 x 2 grid: (i) the fp32 steps and
    the zero-halo witness, (iii) the uneven bands' step, (ii) the timed
    bf16 steps; the splat launches of all of them; the all_gather probe."""
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.ops import splat
    from rtm3d_tpu_torch.parallel import spatial

    dist, _ = ddp_rank_init(workdir, rank)
    try:
        dist.init_mesh(1, DDP_WORLD)
        rec = {"rank": rank, "seconds": {}}
        t0 = time.perf_counter()
        splat.splat_heatmap.launches = 0
        rec["fp32"] = spatial_steps(SPATIAL_HW, SPATIAL_FP32_BATCH, SPATIAL_FP32_STEPS, "float32", 7, hashes=True)
        saved = spatial.Grid.exchange
        spatial.Grid.exchange = lambda self, up, down: (None, None)
        try:
            rec["witness"] = spatial_steps(SPATIAL_HW, SPATIAL_FP32_BATCH, 1, "float32", 7)
        finally:
            spatial.Grid.exchange = saved
        rec["uneven"] = spatial_steps(SPATIAL_UNEVEN_HW, SPATIAL_FP32_BATCH, 1, "float32", 8)
        rec["seconds"]["fp32_witness_uneven"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bf16 = spatial_steps(SPATIAL_HW, TRAIN_BATCH, SPATIAL_WARMUP + SPATIAL_TIMED, "bfloat16", 9,
                             timed=SPATIAL_TIMED)
        rec["seconds"]["bf16"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        rec["splat_launches"] = splat.splat_heatmap.launches
        rec["bf16"] = {k: v for k, v in bf16.items() if k not in ("grads", "params")}
        labels = spatial_batches(SPATIAL_HW, TRAIN_BATCH, 1, 9)[0]["labels"]
        feat_hw = (H // 4, W // 4)
        inputs = heatmap_inputs(labels)
        got = splat.splat_heatmap(*inputs, feat_hw, 3)
        ref = splat.splat_heatmap_reference(*inputs, feat_hw, 3)
        rec["splat_max_abs_err"] = (got - ref).abs().max().item()
        rec["splat_ones_equal"] = bool(torch.equal(got == 1.0, ref == 1.0))
        if rank:
            for k in ("fp32", "witness", "uneven"):
                rec[k] = {"loss_items": rec[k]["loss_items"], "digests": rec[k]["digests"]}
        rec["probe"] = all_gather_probe()
        torch.save(rec, os.path.join(workdir, f"spatial_rank{rank}.pt"))
    finally:
        dist.shutdown()


def spatial_phase(smi: str) -> dict:
    """The ``spatial`` mesh axis on the card: two gloo ranks sharing it as a
    1 x 2 grid of DLA-34 (the TPU config) at 1280x384 (bands 192 + 192),
    against one rank in this process on the same batches: (i) fp32 with
    TF32 off, 3 steps (DDP_GATE on the losses and step 1's gradient, the
    parameters within 2 x the summed learning rates, the ranks' hashes
    equal; the zero-halo witness must leave the gates); (ii) TRAIN_BATCH
    bf16, SPATIAL_TIMED timed steps: ms a rank step, the halo exchanges'
    collectives and MB a step, each process's peak memory beside one
    rank's; (iii) one fp32 step at 1280x416, bands 224 + 192. Two ranks on
    one card over gloo: not a scaling figure."""
    from rtm3d_tpu_torch.parallel.spatial import band_rows

    workdir = os.path.abspath(os.path.join("chip_smoke_out", "ddp", "spatial"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    ddp_launch([sys.executable, os.path.abspath(__file__), "--ddp-worker", "spatial", workdir, "{rank}"],
               DDP_WORLD, "spatial")
    ranks_s = time.perf_counter() - t0
    r0, r1 = (torch.load(os.path.join(workdir, f"spatial_rank{r}.pt"), weights_only=False) for r in range(DDP_WORLD))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    one = spatial_steps(SPATIAL_HW, SPATIAL_FP32_BATCH, SPATIAL_FP32_STEPS, "float32", 7)
    one_uneven = spatial_steps(SPATIAL_UNEVEN_HW, SPATIAL_FP32_BATCH, 1, "float32", 8)
    torch.cuda.empty_cache()
    one_bf16 = spatial_steps(SPATIAL_HW, TRAIN_BATCH, SPATIAL_WARMUP + SPATIAL_TIMED, "bfloat16", 9,
                             timed=SPATIAL_TIMED)
    one_s = time.perf_counter() - t0

    def gates(got, want, params=True):
        g = {k: v.double() for k, v in want["grads"].items()}
        per = {k: ((got["grads"][k].double() - v).norm() / v.norm()).item() for k, v in g.items() if v.norm() > 0}
        flat = lambda d: torch.cat([v.double().flatten() for v in d.values()])
        out = {"loss_rel": max(((a - b).abs() / b.abs().clamp(min=1e-12)).max().item()
                               for a, b in zip(got["loss_items"], want["loss_items"])),
               "grad_l2_rel_total": ((flat(got["grads"]) - flat(g)).norm() / flat(g).norm()).item(),
               "grad_l2_rel_worst": max(per.values())}
        if params:
            out["param_max_abs_diff"] = max((got["params"][k] - v).abs().max().item()
                                            for k, v in want["params"].items())
            out["param_bound"] = 2.01 * sum(want["lrs"])
        return out

    def within(g):
        return (g["loss_rel"] <= DDP_GATE["loss_rel"] and g["grad_l2_rel_total"] <= DDP_GATE["grad_l2_total"]
                and g["grad_l2_rel_worst"] <= DDP_GATE["grad_l2_tensor"]
                and g.get("param_max_abs_diff", 0.0) <= g.get("param_bound", 0.0))

    fp32 = gates(r0["fp32"], one)
    fp32["loss_rel_rank1"] = gates({**r0["fp32"], "loss_items": r1["fp32"]["loss_items"]}, one)["loss_rel"]
    witness = gates(r0["witness"], one, params=False)  # step 1 against step 1
    uneven = gates(r0["uneven"], one_uneven, params=False)  # one step at lr 1e-6: the loss and the gradient
    bf16 = [r["bf16"] for r in (r0, r1)]
    rec = {"label": "two ranks sharing one card as a 1 x 2 data x spatial grid, gloo: not a scaling figure",
           "card": smi, "config": SPATIAL_CONFIG, "transport": "all_reduce (sum) of an (S, n) buffer over gloo",
           "probe": r0["probe"], "ranks_wall_s": ranks_s, "rank0_seconds": r0["seconds"], "one_rank_wall_s": one_s,
           "fp32": {"input": "x".join(map(str, SPATIAL_HW)), "bands": band_rows(SPATIAL_HW[1], 2, 32),
                    "global_batch": SPATIAL_FP32_BATCH, "steps": SPATIAL_FP32_STEPS, "dtype": "float32, TF32 off",
                    "lr": DDP_FP32_LR, **fp32, "ranks_hash_equal": r0["fp32"]["digests"] == r1["fp32"]["digests"],
                    "gate": DDP_GATE},
           "witness_zero_halo": witness,
           "uneven": {"input": "x".join(map(str, SPATIAL_UNEVEN_HW)), "bands": band_rows(SPATIAL_UNEVEN_HW[1], 2, 32),
                      **uneven},
           "bf16": {"input": "x".join(map(str, SPATIAL_HW)), "global_batch": TRAIN_BATCH, "timed_steps": SPATIAL_TIMED,
                    "per_rank": [{k: b[k] for k in ("step_ms", "peak_mem_gb", "halo_collectives_per_step",
                                                     "halo_mb_per_step")} for b in bf16],
                    "ms_per_rank_step": float(np.mean([np.mean(b["step_ms"]) for b in bf16])),
                    "one_rank_ms_per_step": float(np.mean(one_bf16["step_ms"])),
                    "one_rank_peak_mem_gb": one_bf16["peak_mem_gb"],
                    "losses_equal_across_ranks": all(torch.equal(a, b) for a, b in zip(*(b["loss_items"] for b in bf16))),
                    "loss_first": bf16[0]["loss_items"][0][-1].item(), "loss_last": bf16[0]["loss_items"][-1][-1].item(),
                    "one_rank_loss_last": one_bf16["loss_items"][-1][-1].item()},
           "splat_launches": [r0["splat_launches"], r1["splat_launches"]],
           "splat_max_abs_err": max(r0["splat_max_abs_err"], r1["splat_max_abs_err"])}
    emit("spatial", **rec)
    if not (within(fp32) and fp32["loss_rel_rank1"] <= DDP_GATE["loss_rel"] and rec["fp32"]["ranks_hash_equal"]):
        raise AssertionError(f"spatial: the fp32 grid disagrees with one rank, or its ranks with each other: {rec}")
    if not within(uneven):
        raise AssertionError(f"spatial: the uneven bands' step disagrees with one rank: {rec}")
    if not (witness["loss_rel"] > DDP_GATE["loss_rel"] and witness["grad_l2_rel_total"] > DDP_GATE["grad_l2_total"]):
        raise AssertionError(f"spatial: the zero-halo witness stays within the gates: {rec}")
    losses = [torch.stack(b["loss_items"]) for b in bf16]
    if not (all(torch.isfinite(l).all() for l in losses) and rec["bf16"]["losses_equal_across_ranks"]
            and all(b["halo_collectives_per_step"] > 0 for b in bf16)):
        raise AssertionError(f"spatial: a bf16 loss is not finite, the ranks' losses differ, or no halo moved: {rec}")
    want = SPATIAL_FP32_STEPS + 2 + SPATIAL_WARMUP + SPATIAL_TIMED  # fp32, witness, uneven, bf16
    if rec["splat_launches"] != [want] * DDP_WORLD:
        raise AssertionError(f"spatial: expected one splat launch a rank a step ({want}): {rec}")
    if rec["splat_max_abs_err"] > 1e-6 or not (r0["splat_ones_equal"] and r1["splat_ones_equal"]):
        raise AssertionError(f"spatial: the splat kernel disagrees with its plain version: {rec}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"splat_launches": sum(rec["splat_launches"]), "record": rec,
            "splat_max_abs_err": rec["splat_max_abs_err"]}


def ddp_cli_worker(workdir: str) -> None:
    """The torchrun rank of ddp_cli: ``cli.train.main`` then
    ``cli.detect.main`` on the argument lists of ``workdir/argv.json``
    (each CLI joins the process group and leaves it), the kernel launches
    of each counted; the summaries to ``train.json`` and ``detect.json``
    there. One launch for both: a fresh process is seconds of start-up."""
    from rtm3d_tpu_torch import load_config
    from rtm3d_tpu_torch.cli import detect as cli_detect
    from rtm3d_tpu_torch.cli import train as cli_train
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat

    argv = json.load(open(os.path.join(workdir, "argv.json")))
    cfg = load_config(argv["train"][argv["train"].index("--model-config") + 1])
    splat.splat_heatmap.launches = 0
    out = cli_train.main(argv["train"])
    torch.cuda.synchronize()
    train = cli_record(out, int(cfg.BATCH_SIZE), int(cfg.get("num_workers", 0)), splat.splat_heatmap.launches)
    train["history"] = [{k: h[k] for k in ("steps", "eval_batches", "train_loss", "eval_loss")}
                        for h in out["history"]]
    del out
    torch.cuda.empty_cache()
    lm.lm_solve.launches = 0
    out = cli_detect.main(argv["detect"])
    torch.cuda.synchronize()
    detect = {"images": out["images"], "batches": len(out["batch_s"]), "lm_launches": lm.lm_solve.launches,
              "device_images_per_s": out["device_images_per_s"], "wall_images_per_s": out["wall_images_per_s"],
              "batch_ms": [1e3 * t for t in out["batch_s"]]}
    for name, rec in (("train", train), ("detect", detect)):
        rec["rank"] = int(os.environ["RANK"])
        with open(os.path.join(workdir, f"{name}.json"), "w") as f:
            json.dump(rec, f)


def ddp_cli_phase(tree: str, data_rec: dict, detect_rec: dict, device_weights: str) -> dict:
    """The CLIs under ``python -m torch.distributed.run --nproc-per-node 1``,
    NCCL at world size 1: cli.train --multihost on the data phase's tree
    (the TPU config, 1 epoch), gated as the data phase's runs, its step
    spans beside the data phase's (no process group); cli.detect on the
    detect_cli phase's weights, whose result files must equal
    detect_cli_device's."""
    root = os.path.dirname(tree)
    workdir = os.path.abspath(os.path.join("chip_smoke_out", "ddp", "cli"))
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    config = os.path.join(CONFIGS, "rtm3d_dla34_kitti_tpu.yaml")
    weights = os.path.join(root, "weights_ddp")
    out_dir = os.path.join(root, "results_ddp")
    with open(os.path.join(workdir, "argv.json"), "w") as f:
        json.dump({"train": ["--model-config", config, "--data-path", tree, "--multihost", "--set",
                             "TRAINING.WEIGHTS", weights, "TRAINING.CHECKPOINT_MODE", "start", "SOLVER.MAX_EPOCH", "1"],
                   "detect": ["--model-config", config, "--data-path", tree, "--split", "train", "--batch-size",
                              str(DETECT_BATCH), "--checkpoint", device_weights, "--out-dir", out_dir]}, f)
    ddp_launch([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1",
                os.path.abspath(__file__), "--ddp-worker", "cli", workdir, "0"], 1, "cli")
    train = json.load(open(os.path.join(workdir, "train.json")))
    shutil.rmtree(weights, ignore_errors=True)
    hist = train["history"]
    want = sum(h["steps"] + h["eval_batches"] for h in hist)
    rec = {"launch": "torch.distributed.run --nproc-per-node 1, NCCL, world size 1",
           **{k: v for k, v in train.items() if k != "history"},
           "no_ddp_last_epoch_step_span_ms_each": data_rec["last_epoch_step_span_ms_each"],
           "no_ddp_last_epoch_step_span_ms_per_step": data_rec["last_epoch_step_span_ms_per_step"]}
    emit("ddp_cli_train", **rec)
    losses = [v for h in hist for v in h["train_loss"] + (h["eval_loss"] or [])]
    if not all(np.isfinite(losses)) or train["img_size"] != KITTI_RECT or train["splat_launches"] != want:
        raise AssertionError(f"ddp_cli_train: a loss is not finite, img_size is not {KITTI_RECT}, or not one "
                             f"splat launch per train and eval batch ({want}): {rec}")

    det = json.load(open(os.path.join(workdir, "detect.json")))
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(root, "results_device")))
    cmp = compare_result_dirs(os.path.join(root, "results_device"), out_dir, names)
    identical = all(open(os.path.join(root, "results_device", f"{n}.txt")).read()
                    == open(os.path.join(out_dir, f"{n}.txt")).read() for n in names)
    drec = {**det, "result_files": len(os.listdir(out_dir)), "vs_detect_cli_device": cmp, "files_identical": identical,
            "no_ddp_device_images_per_s": detect_rec["device_images_per_s"], "no_ddp_batch_ms": detect_rec["batch_ms"]}
    emit("ddp_cli_detect", **drec)
    within = (cmp["lines"] == cmp["lines_got"] > 0 and cmp["box_agree_share"] == 1.0
              and all(cmp["max_abs"][k] <= PARITY_GATE[k] for k in ("score", "angle", "dim", "loc")))
    if (det["images"] != DATA_TRAIN or drec["result_files"] != DATA_TRAIN or det["lm_launches"] != 2 * det["batches"]
            or not (identical or within)):
        raise AssertionError(f"ddp_cli_detect: the files differ from detect_cli_device's, or not 2 LM launches "
                             f"a batch: {drec}")
    shutil.rmtree(workdir, ignore_errors=True)
    return {"splat_launches": train["splat_launches"], "lm_launches": det["lm_launches"], "train": rec,
            "detect": drec}


def ptxas_lines(log: str) -> list:
    """ptxas's resource lines (registers, spills) from an nvcc -Xptxas -v log."""
    return [l.strip() for l in log.splitlines() if "registers" in l or "spill" in l]


def int8_ab_rows(int8, shapes: list, timed: bool) -> list:
    """--kernel-ab's int8 kernels of one version (``int8``, its
    ``ops.int8_conv``): each served conv shape at the detect batch in bf16
    with a per-tensor scale, weights packed by the version's own
    ``pack_weight``, the same seeded inputs in every turn; ``quantize`` and
    ``conv_s8`` held bit-equal to the version's plain versions and, if
    ``timed``, CUDA-event times."""
    rows = []
    for i, sh in enumerate(shapes):
        cin, cout, k, stride, pad, dil, h, w = (sh[key] for key in ("cin", "cout", "k", "stride", "pad", "dil", "h", "w"))
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        cp = int8.padded_channels(cin)
        wq = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, device="cuda", dtype=torch.int8)
        packed = int8.pack_weight(wq)
        out_scale = torch.rand(cout, generator=gen, device="cuda") * 1e-3
        bias = torch.randn(cout, generator=gen, device="cuda")
        scale = torch.full((cin,), 3.0 / 127.0, device="cuda")
        xb = torch.randn((DETECT_BATCH, cin, h, w), generator=gen, device="cuda", dtype=torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        quantize = functools.partial(int8.quantize, xb, scale, cp)
        q = quantize()
        conv = functools.partial(int8.conv_s8, q, packed, (k, k), stride, pad, dil, out_scale, bias, torch.bfloat16)
        y = conv()
        torch.cuda.synchronize()
        row = {"cin": cin, "cout": cout, "k": k, "stride": stride, "pad": pad, "dil": dil, "hw": [h, w],
               "served_per_forward": sh["served"],
               "quantize_equal": bool(torch.equal(q, int8.quantize_reference(xb, scale, cp))),
               "conv_equal": bool(torch.equal(y, int8.conv_s8_reference(q, packed, (k, k), stride, pad, dil,
                                                                        out_scale, bias, torch.bfloat16)))}
        if hasattr(int8, "conv_variant"):
            row["variant"] = int8.conv_variant(DETECT_BATCH, h, w, cp, cout, (k, k), stride, pad, dil,
                                               packed.shape[1])["name"]
        del y
        if timed:
            row["quantize_ms"] = cuda_time_ms(quantize, AB_INT8_REPS, 2)
            row["conv_ms"] = cuda_time_ms(conv, AB_INT8_REPS, 2)
        rows.append(row)
        del xb, q, conv, quantize, packed, wq
        torch.cuda.empty_cache()
    return rows


def ab_worker(root: str, timed: bool, int8_shapes: str | None = None) -> None:
    """One turn of --kernel-ab: the kernels of the ``rtm3d_tpu_torch`` package
    under ``root``, built, checked against their plain versions at the main
    paths' shapes and, if ``timed``, timed; the int8 kernels at the served
    conv shapes listed in the JSON file ``int8_shapes`` (``int8_ab_rows``);
    one JSON line."""
    # this script's own package came in with the shared helpers; the turn
    # imports the version under test in its place
    for name in [k for k in sys.modules if k.split(".")[0] == "rtm3d_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, os.path.abspath(root))
    from rtm3d_tpu_torch import default_config
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat
    from rtm3d_tpu_torch.utils import kernel_build

    built = kernel_build.build()
    rec = {"package": os.path.dirname(os.path.dirname(lm.__file__)),
           "ptxas": {n: ptxas_lines(b["log"]) for n, b in built.items()},
           "libraries": {n: str(b["path"]) for n, b in built.items()}, "lm": []}
    cfg = default_config()
    n = BATCH * TOPK
    uv, x0, kp = synthetic_lanes(np.random.RandomState(0), n, np.asarray(cfg.DETECTOR.dim_ref, np.float32))
    cases = [tuple(t[:, : 2 * n].contiguous() for t in (uv, x0, kp)) + (float(cfg.DETECTOR.DIM_PRIOR_WEIGHT),),
             (uv, x0, kp, 0.0)]
    for u, x, k, pw in cases:
        call = lambda: lm.lm_solve(u, x, k, iters=ITERS, prior_weight=pw)
        ck = call()[1][0].cpu().numpy()
        cr = lm.lm_solve_reference(u, x, k, iters=ITERS, prior_weight=pw)[1][0].cpu().numpy()
        held = held_agreement(ck, cr, n, pw)
        entry = {"M": u.shape[1], "prior_weight": pw, "finite": bool(np.isfinite(ck).all()),
                 "accept_agreement": held[0], "cost_within_1e-3": held[1]}
        if timed:
            entry["ms"] = cuda_time_ms(call, AB_LM_REPS, 2)
        rec["lm"].append(entry)
    feat_hw = (H // 4, W // 4)
    labels = {k: v.cuda() for k, v in synthetic_labels(np.random.RandomState(5), TRAIN_BATCH, TRAIN_OBJS).items()}
    inputs = heatmap_inputs(labels)
    for name, batch in (("train_shape", inputs), ("edge", splat_edge_inputs(4, TRAIN_OBJS, feat_hw))):
        got = splat.splat_heatmap(*batch, feat_hw, 3)
        ref = splat.splat_heatmap_reference(*batch, feat_hw, 3)
        rec[f"splat_{name}"] = {"max_abs_err": (got - ref).abs().max().item(),
                                "ones_equal": bool(torch.equal(got == 1.0, ref == 1.0))}
    if timed:
        masked_out = list(inputs)
        masked_out[4] = torch.zeros_like(inputs[4])
        out = torch.empty((TRAIN_BATCH, 3, *feat_hw), device="cuda")
        rec["timed_by"] = {}
        for key, fn, kernel in (("splat_ms", lambda: splat.splat_heatmap(*inputs, feat_hw, 3), "splat_kernel"),
                                ("splat_no_live_slot_ms", lambda: splat.splat_heatmap(*masked_out, feat_hw, 3),
                                 "splat_kernel"),
                                ("fill_ms", lambda: out.fill_(0.5), "elementwise")):
            rec[key], rec["timed_by"][key] = kernel_device_ms(fn, AB_SPLAT_REPS, kernel)
    if int8_shapes:
        from rtm3d_tpu_torch.ops import int8_conv as int8

        with open(int8_shapes) as f:
            rec["int8"] = int8_ab_rows(int8, json.load(f), timed)
    print(json.dumps(rec), flush=True)


def sass_functions(lib: str, kernel: str) -> dict:
    """Per function of ``lib`` whose name holds ``kernel``: its SASS
    instructions as (address, opcode, operands), from cuobjdump; None where
    the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return None
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if kernel in m.group(1) else None
            if name:
                funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return funcs


def sass_loop_counts(lib: str, kernel: str) -> dict:
    """Per function whose name holds ``kernel``: its SASS instruction count
    and, over the span of its widest backward branch (the iteration loop),
    the count by opcode."""
    funcs = sass_functions(lib, kernel)
    if funcs is None:
        return {"cuobjdump": "not found"}
    out = {}
    for fn, ins in funcs.items():
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        rec = {"instructions": len(ins)}
        if loops:
            lo, hi = max(loops, key=lambda span: span[1] - span[0])
            by_op = {}
            for addr, op, _ in ins:
                if lo <= addr <= hi:
                    by_op[op.split(".")[0]] = by_op.get(op.split(".")[0], 0) + 1
            rec["loop_instructions"] = sum(by_op.values())
            rec["loop_by_opcode"] = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
        out[fn] = rec
    return out


def sass_opcodes(lib: str, kernel: str) -> dict:
    """Per function whose name holds ``kernel``: its SASS instructions by
    opcode."""
    funcs = sass_functions(lib, kernel)
    if funcs is None:
        return {"cuobjdump": "not found"}
    out = {}
    for fn, ins in funcs.items():
        by_op = {}
        for _, op, _ in ins:
            by_op[op.split(".")[0]] = by_op.get(op.split(".")[0], 0) + 1
        out[fn] = dict(sorted(by_op.items(), key=lambda kv: -kv[1]))
    return out


def gmma_counts(lib: str) -> dict:
    """The warpgroup MMA instructions (``*GMMA``) in each conv kernel of the
    int8 library's SASS."""
    ops = sass_opcodes(lib, "conv_s8_kernel")
    if "cuobjdump" in ops:
        return ops
    return {fn: sum(n for op, n in counts.items() if op.endswith("GMMA")) for fn, counts in ops.items()}


def int8_ab_times(turns: list, smi: str) -> dict:
    """One version's int8 rows over its turns: per shape the mean ms, TOP/s
    and share of the bound of ``conv_s8``, ``quantize``'s ms against its
    bound, and the sums over one served forward."""
    from rtm3d_tpu_torch.ops import int8_conv as int8

    rows = []
    for i, r in enumerate(turns[0]["int8"]):
        h, w = r["hw"]
        args = (DETECT_BATCH, r["cin"], h, w, r["cout"], (r["k"], r["k"]), r["stride"], r["pad"], r["dil"])
        ops, nbytes = int8.conv_s8_ops(*args), int8.conv_s8_bytes(*args, 2)
        bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        conv_ms = float(np.mean([t["int8"][i]["conv_ms"] for t in turns]))
        q_ms = float(np.mean([t["int8"][i]["quantize_ms"] for t in turns]))
        q_bound = int8.quantize_bytes(DETECT_BATCH, r["cin"], h, w, 2) / PEAK_BYTES * 1e3
        rows.append({key: r[key] for key in ("cin", "cout", "k", "stride", "pad", "dil", "hw", "served_per_forward")}
                    | {"variant": r.get("variant"), "conv_ms": conv_ms, "conv_runs_ms": [t["int8"][i]["conv_ms"] for t in turns],
                       "conv_tops": ops / conv_ms / 1e9, "conv_bound_ms": bound, "conv_bound_share": bound / conv_ms,
                       "conv_bound_by": "operations" if ops / PEAK_INT8_OPS > nbytes / PEAK_BYTES else "bytes",
                       "quantize_ms": q_ms, "quantize_bound_ms": q_bound, "quantize_bound_share": q_bound / q_ms})

    def total(key):
        return sum(r[key] * r["served_per_forward"] for r in rows)

    return {"nvidia_smi": smi, "conv_forward_ms": total("conv_ms"), "conv_forward_bound_ms": total("conv_bound_ms"),
            "quantize_forward_ms": total("quantize_ms"), "quantize_forward_bound_ms": total("quantize_bound_ms"),
            "conv_forward_runs_ms": [sum(t["int8"][i]["conv_ms"] * r["served_per_forward"] for i, r in enumerate(rows))
                                     for t in turns],
            "quantize_forward_runs_ms": [sum(t["int8"][i]["quantize_ms"] * r["served_per_forward"]
                                             for i, r in enumerate(rows)) for t in turns],
            "rows": rows}


def kernel_ab(old_root: str, check_only: bool, out_path: str) -> int:
    """--kernel-ab: the package under ``old_root`` against this one, each
    turn in a process of its own; fails if either version fails a gate. A
    turn that fails is reported and the others still run, so one version's
    numbers survive the other's fault."""
    from rtm3d_tpu_torch import load_config
    from rtm3d_tpu_torch.nn import model as nn_model
    from rtm3d_tpu_torch.nn import quant
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat

    roots = {"old": old_root, "new": os.path.dirname(os.path.abspath(__file__))}
    records, runs = [], {"old": [], "new": []}

    def record(kind, **fields):
        records.append({"record": kind, **fields})
        print(json.dumps(records[-1]), flush=True)

    smi = nvidia_smi()
    record("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    # the int8 kernels at the distinct conv shapes one served DLA-34 forward runs int8
    keys = ("cin", "cout", "k", "stride", "pad", "dil", "h", "w")
    shapes = [dict(zip(keys, sig), served=g["served"])
              for sig, g in int8_shape_groups(int8_convs(quant, nn_model, load_config)).items() if g["served"]]
    shapes_path = os.path.join(os.path.dirname(out_path) or ".", "int8_ab_shapes.json")
    os.makedirs(os.path.dirname(shapes_path) or ".", exist_ok=True)
    with open(shapes_path, "w") as f:
        json.dump(shapes, f)
    failed = []
    for tag in ("old", "new") if check_only else ("old", "new", "new", "old"):
        cmd = ([sys.executable, os.path.abspath(__file__), "--ab-worker", roots[tag], "--int8-shapes", shapes_path]
               + ([] if check_only else ["--timed"]))
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:] + proc.stderr[-8000:], file=sys.stderr)
            record("turn_failed", version=tag, returncode=proc.returncode)
            failed.append((tag, "exited", proc.returncode))
            continue
        runs[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        record("turn", version=tag, **runs[tag][-1])
    # a profiler time and a CUDA-graph time (which holds the gaps between
    # launches) are not compared
    sources = sorted({src for turns in runs.values() for t in turns for src in t.get("timed_by", {}).values()})
    if len(sources) > 1:
        failed.append(("timed_by", sources))
    for tag, turns in runs.items():
        if not turns:
            continue
        first = turns[0]
        record("sass", version=tag, lm_solver=sass_loop_counts(first["libraries"]["lm_solver"], "lm_kernel"),
               int8_conv=sass_opcodes(first["libraries"]["int8_conv"], "conv_s8_kernel"))
        for t in turns:
            for r in t["int8"]:
                if not (r["quantize_equal"] and r["conv_equal"]):
                    failed.append((tag, "int8", r))
            for e in t["lm"]:
                if not e["finite"] or e["accept_agreement"] < 0.999 or e["cost_within_1e-3"] < 0.999:
                    failed.append((tag, e))
            for name in ("splat_train_shape", "splat_edge"):
                if t[name]["max_abs_err"] > 1e-6 or not t[name]["ones_equal"]:
                    failed.append((tag, name, t[name]))
        if check_only or len(sources) > 1 or len(turns) < 2:
            continue
        lm_ms = [float(np.mean([t["lm"][i]["ms"] for t in turns])) for i in range(2)]
        lm_bound = [lm.lm_flops(e["M"], ITERS, e["prior_weight"]) / PEAK_FP32_FLOPS * 1e3 for e in first["lm"]]
        splat_bound = splat.splat_bytes(TRAIN_BATCH, TRAIN_OBJS, (H // 4, W // 4), 3) / PEAK_BYTES * 1e3
        mean = lambda key: float(np.mean([t[key] for t in turns]))
        record("times", version=tag, nvidia_smi=smi, splat_timed_by=sources[0],
               lm_ms={e["M"]: ms for e, ms in zip(first["lm"], lm_ms)}, lm_pair_ms=sum(lm_ms),
               lm_pair_bound_ms=sum(lm_bound), lm_pair_over_bound=sum(lm_ms) / sum(lm_bound),
               lm_runs_ms=[[e["ms"] for e in t["lm"]] for t in turns],
               splat_ms=mean("splat_ms"), splat_runs_ms=[t["splat_ms"] for t in turns],
               splat_bound_ms=splat_bound, splat_over_bound=mean("splat_ms") / splat_bound,
               splat_no_live_slot_ms=mean("splat_no_live_slot_ms"), fill_ms=mean("fill_ms"))
        record("int8_times", version=tag, **int8_ab_times(turns, smi))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(records, f, indent=1)
    print(smi, flush=True)
    if failed:
        print(f"kernel-ab: a version fails its gates: {failed}", file=sys.stderr)
        return 1
    return 0


def ddp_worker(argv: list) -> int:
    """``--ddp-worker KIND DIR RANK``: one rank of a ddp phase."""
    kind, where, rank = argv[:3]
    if kind == "fp32":
        ddp_fp32_worker(where, int(rank))
    elif kind == "full":
        ddp_full_worker(where, int(rank))
    elif kind == "spatial":
        spatial_worker(where, int(rank))
    else:
        ddp_cli_worker(where)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--ddp-worker"]:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is visible", file=sys.stderr)
            return 1
        return ddp_worker(sys.argv[2:])
    ap = argparse.ArgumentParser(description="Drive the port on one GPU and check it.")
    ap.add_argument("--kernel-ab", metavar="DIR", help="compare the kernels of the package under DIR with these")
    ap.add_argument("--check-only", action="store_true", help="with --kernel-ab: each version once, untimed")
    ap.add_argument("--out", default="chip_smoke_out/kernel_ab.json", help="with --kernel-ab: the records")
    ap.add_argument("--ab-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--int8-shapes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if args.ab_worker:
        ab_worker(args.ab_worker, args.timed, args.int8_shapes)
        return 0
    if args.kernel_ab:
        return kernel_ab(args.kernel_ab, args.check_only, args.out)
    from rtm3d_tpu_torch import default_config, load_config
    from rtm3d_tpu_torch.api import Detector
    from rtm3d_tpu_torch.cli import detect as cli_detect
    from rtm3d_tpu_torch.cli import evaluate as cli_evaluate
    from rtm3d_tpu_torch.cli import export as cli_export
    from rtm3d_tpu_torch.cli import stats as cli_stats
    from rtm3d_tpu_torch.cli import train as cli_train
    from rtm3d_tpu_torch.data.synthetic import generate_kitti
    from rtm3d_tpu_torch.data.targets import heatmap_inputs
    from rtm3d_tpu_torch.nn import model as nn_model
    from rtm3d_tpu_torch.nn import quant
    from rtm3d_tpu_torch.ops import dcn as dcn_ops
    from rtm3d_tpu_torch.ops import int8_conv as int8
    from rtm3d_tpu_torch.ops import kfpn_fuse as kf
    from rtm3d_tpu_torch.ops import lm_solver as lm
    from rtm3d_tpu_torch.ops import splat
    from rtm3d_tpu_torch.train import state as state_mod
    from rtm3d_tpu_torch.train import step as step_mod
    from rtm3d_tpu_torch.utils import kernel_build

    # fp32 comparisons: no TF32 in cuDNN convs or cuBLAS matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    seconds = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = round(now - t_phase, 2)
        t_phase = now

    smi = nvidia_smi()
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         capability=list(torch.cuda.get_device_capability(0)), dist=dist_probe())

    built = kernel_build.build()  # one nvcc per source, all at once
    # the AP evaluator's host C++ overlap, so that the evaluate phase's
    # seconds hold no build
    host = kernel_build.build_host(["geometry", "preproc"])
    ptxas = {n: ptxas_lines(b["log"]) for n, b in built.items()}
    spills = {n: [l for l in lines if re.search(r"[1-9]\d* bytes spill (stores|loads)", l)]
              for n, lines in ptxas.items()}
    emit("build", seconds=time.perf_counter() - t_phase,
         kernels={n: {"seconds": b["seconds"], "ptxas": ptxas[n]} for n, b in built.items()},
         host={n: {"seconds": b["seconds"], "library": str(b["path"])} for n, b in host.items()})
    if not all(any("registers" in l for l in lines) for lines in ptxas.values()):
        raise AssertionError(f"build: a kernel's ptxas report is missing: {ptxas}")
    if any(spills.values()):
        raise AssertionError(f"build: ptxas reports spills: {spills}")
    # conv_s8 runs on the warpgroup MMA: every conv kernel's SASS holds GMMA instructions
    gmma = gmma_counts(str(built["int8_conv"]["path"]))
    emit("build_sass", int8_conv_gmma=gmma)
    if not gmma or not all(isinstance(n, int) and n > 0 for n in gmma.values()):
        raise AssertionError(f"build: a conv_s8 kernel without warpgroup MMA (GMMA) in its SASS: {gmma}")
    phase_done("build")

    cfg = default_config()
    cfg.INPUT_SIZE = (W, H)
    cfg.DETECTOR.TOPK_CANDIDATES = TOPK
    cfg.DETECTOR.SCORE_THRESH = 0.4
    cfg.DETECTOR.SOLVER_ITERS = ITERS
    prior = float(cfg.DETECTOR.DIM_PRIOR_WEIGHT)  # 20: two solves per detect
    dim_ref = np.asarray(cfg.DETECTOR.dim_ref, np.float32)
    n = BATCH * TOPK
    uv, x0, kp = synthetic_lanes(np.random.RandomState(0), n, dim_ref)
    lm_phase(lm, uv, x0, kp, n, prior)  # M = 38,400 at the prior
    first, second = lm_detect_pair(lm, n, dim_ref, prior)  # M = 25,600 and 38,400
    phase_done("lm")
    logits_phase(cfg, nn_model)
    phase_done("logits")
    served = serve_phase(cfg, nn_model, lm, splat, kf, Detector)
    phase_done("serve_and_profile")

    # the splat at the training path's shape: the inputs build_targets makes
    # from a train batch's label block
    feat_hw = (H // 4, W // 4)
    labels = {k: v.cuda() for k, v in synthetic_labels(np.random.RandomState(5), TRAIN_BATCH, TRAIN_OBJS).items()}
    splat_main = splat_phase(splat, heatmap_inputs(labels), feat_hw, 3, "train_shape")
    splat_edge = splat_phase(splat, splat_edge_inputs(4, TRAIN_OBJS, feat_hw), feat_hw, 3, "edge")
    phase_done("splat")
    fused = kfpn_fuse_phase(kf)
    phase_done("kfpn_fuse")
    dcn_rec = dcn_phase(dcn_ops, nn_model, Detector, cfg)
    phase_done("dcn")
    train_fp32_phase(cfg, nn_model, step_mod, state_mod)
    phase_done("train_fp32")
    trained = train_phase(nn_model, step_mod, state_mod, load_config, lm, splat, kf)
    phase_done("train_and_profile")
    remat = remat_phase(cfg, nn_model, step_mod, state_mod, load_config, splat, trained)
    phase_done("remat")
    benched = bench_phase()
    phase_done("bench")
    latency = latency_phase()
    phase_done("latency")
    from_files, data_splats, tree, checkpoint = data_phase(splat, load_config, generate_kitti, cli_train)
    phase_done("data")
    from_files_detect = detect_cli_phase(lm, kf, load_config, cli_detect, cli_evaluate, tree, checkpoint)
    phase_done("detect_cli")
    resnet = resnet18_phase(lm, splat, load_config, cli_train, cli_detect, cli_export, cli_stats, tree, smi)
    phase_done("resnet18")
    convs = int8_convs(quant, nn_model, load_config)
    int8_kernels = int8_kernel_phase(int8, convs, smi, int8_convs(quant, nn_model, load_config, RESNET_CONFIG))
    phase_done("int8_kernel")
    int8_logits_phase(int8, quant, nn_model, load_config, step_mod.normalize_images, smi)
    phase_done("int8_logits")
    served_convs = sum(c["served"] for c in convs)
    int8_cli = int8_cli_phase(lm, int8, kf, quant, nn_model, load_config, cli_detect, cli_evaluate, tree,
                              from_files_detect["device_weights"], served_convs, smi)
    phase_done("int8_cli")
    host_variants = host_variants_phase(splat, load_config, cli_train, tree, from_files["train_cli_host"])
    phase_done("fast_preproc_and_mosaic")
    train_benched = bench_train_phase(tree)
    phase_done("bench_train")
    parity = real_parity_phase(tree, from_files_detect["device_weights"])
    phase_done("real_parity")
    torch.cuda.empty_cache()  # the ranks below are processes of their own on this card
    ddp_fp32 = ddp_fp32_phase()
    phase_done("ddp_fp32")
    ddp_full = ddp_full_phase(smi)
    phase_done("ddp_full")
    spatial_rec = spatial_phase(smi)
    phase_done("spatial")
    ddp_cli = ddp_cli_phase(tree, from_files["train_cli_device"], from_files_detect["records"]["detect_cli_device"],
                            from_files_detect["device_weights"])
    os.remove(from_files_detect["device_weights"])
    phase_done("ddp_cli")
    ap_prod = ap_parity_production_phase(smi)
    phase_done("ap_parity_production")
    ap_tools = ap_parity_tools_phase(ap_prod["work"])
    phase_done("ap_parity_tools")
    ap_sbs = ap_parity_side_by_side_phase(smi)
    phase_done("ap_parity_side_by_side")
    emit("seconds", **seconds, total=round(sum(seconds.values()), 2))

    pair = (first, second)
    int8_lm = {k: v["lm"] for k, v in int8_cli["launches"].items()}
    int8_launches = {k: {"quantize": v["quantize"], "conv_s8": v["conv_s8"]} for k, v in int8_cli["launches"].items()}
    int8_launches["latency_int8"] = {k: latency["launches"][k] for k in ("quantize", "conv_s8")}
    int8_launches["real_parity_int8"] = parity["int8_launches"]
    for name, rec in (("ap_parity_production", ap_prod), ("ap_parity_tools", ap_tools),
                      ("ap_parity_side_by_side", ap_sbs)):
        int8_launches[name] = {k: rec["launches"][k] for k in ("quantize", "conv_s8")}
    tool_lm = {"bench": benched["lm_launches"], "latency": latency["launches"]["lm"],
               "real_parity": parity["lm_launches"], "ap_parity_production": ap_prod["launches"]["lm"],
               "ap_parity_tools": ap_tools["launches"]["lm"],
               "ap_parity_side_by_side": ap_sbs["launches"]["lm"]}
    fwd = int8_kernels["forward"]
    print(json.dumps({"kernels": [{
        "name": "lm_solver",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/lm_solver.cu",
        "replaces": LM_REPLACES,
        # 2 per detect call: the serve phase's calls, the detect CLI's
        # batches, the ResNet-18 detect run's and the runs from its
        # artifacts, the int8 runs with 3D (--int8-3d-anyway, evaluate),
        # the tools' timed calls (bench, bench_latency) and real_parity's
        # batches (the port and int8 legs), the detect CLI under torchrun
        "launches": (served["lm_launches"] + from_files_detect["launches"]
                     + resnet["launches"]["resnet18_detect"] + resnet["launches"]["export_detect"]
                     + sum(int8_lm.values()) + sum(tool_lm.values()) + ddp_cli["lm_launches"]),
        "launches_by_path": {"serve": served["lm_launches"], "detect_cli": from_files_detect["launches"],
                             "resnet18_detect": resnet["launches"]["resnet18_detect"],
                             "export_detect": resnet["launches"]["export_detect"], **int8_lm, **tool_lm,
                             "ddp_cli_detect": ddp_cli["lm_launches"]},
        # the largest cost gap where both accept: the lm phases' lanes and
        # every launch of detect_cli_device and of the resnet18 phase's
        # detect runs; the times are those of the pair of launches at
        # M=25,600 (prior 20) and M=38,400 (prior 0)
        "max_abs_err": max([r["detection_max_abs_cost_diff_accepted"] for r in pair]
                           + [from_files_detect["max_abs_err"], resnet["lm_max_abs_err"]]),
        "ms": sum(r["kernel_ms"] for r in pair),
        "plain_ms": sum(r["plain_ms"] for r in pair),
        "bound_ms": sum(r["bound_ms"] for r in pair),
        "bound_by": first["bound_by"],
        "library_ms": None,
    }, {
        "name": "splat",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/splat.cu",
        "replaces": SPLAT_REPLACES,
        # one launch per train step and eval batch: the timed steps of the
        # train and remat phases, the data phase's three runs of the CLI, the
        # FAST_PREPROC and mosaic runs and the ResNet-18 run; one per overlay
        # of cli.stats --vis-targets; bench_train's timed steps; one per rank
        # per step of the ddp phases, and per train and eval batch of the
        # train CLI under torchrun
        "launches": (trained["splat_launches"] + remat["splat_launches"]
                     + sum(r["splat_launches"] for r in from_files.values())
                     + sum(r["splat_launches"] for r in host_variants.values())
                     + resnet["launches"]["resnet18_train"] + resnet["launches"]["stats"]
                     + train_benched["splat_launches"] + ap_prod["launches"]["splat"]
                     + ap_sbs["launches"]["splat"]
                     + ddp_fp32["splat_launches"] + ddp_full["splat_launches"] + ddp_cli["splat_launches"]
                     + spatial_rec["splat_launches"]),
        "launches_by_path": {"train": trained["splat_launches"], "remat": remat["splat_launches"],
                             "bench_train": train_benched["splat_launches"],
                             "ap_parity_production": ap_prod["launches"]["splat"],
                             "ap_parity_side_by_side": ap_sbs["launches"]["splat"],
                             **{k: r["splat_launches"] for k, r in from_files.items()},
                             **{k: r["splat_launches"] for k, r in host_variants.items()},
                             "resnet18_train": resnet["launches"]["resnet18_train"],
                             "stats": resnet["launches"]["stats"], "ddp_fp32": ddp_fp32["splat_launches"],
                             "ddp_full": ddp_full["splat_launches"], "ddp_cli_train": ddp_cli["splat_launches"],
                             "spatial": spatial_rec["splat_launches"]},
        # at the train phase's shape, on the edge batch and at both data
        # modes' and the ResNet-18 run's shapes and labels, and on each
        # ddp_full rank's first batch
        "max_abs_err": max([r["max_abs_err"] for r in (splat_main, splat_edge, *data_splats.values())]
                           + [resnet["splat_max_abs_err"], ddp_full["splat_max_abs_err"],
                              spatial_rec["splat_max_abs_err"]]),
        "ms": splat_main["kernel_ms"],
        # "profiler" (the kernel alone) or "graph" (kernel_device_ms)
        "timed_by": splat_main["timed_by"],
        "plain_ms": splat_main["plain_ms"],
        "bound_ms": splat_main["bound_ms"],
        "bound_by": splat_main["bound_by"],
        "library_ms": None,
    }, {
        "name": "int8_quantize",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/int8_conv.cu",
        "replaces": INT8_REPLACES,
        # once per int8 conv of each int8 detect call: the int8_cli phase's
        # CLI runs and the int8 detect of evaluate --int8, bench_latency
        # --int8's timed calls and real_parity's int8 leg
        "launches": sum(v["quantize"] for v in int8_launches.values()),
        "launches_by_path": {k: v["quantize"] for k, v in int8_launches.items()},
        # bit-equal on every distinct conv shape (int8_kernel); the times are
        # summed over the int8 convs of one b32 1280x416 bf16 forward
        "max_abs_err": int8_kernels["quantize_max_abs_err"],
        "ms": fwd["quantize_ms"],
        "plain_ms": fwd["plain_quantize_ms"],
        "bound_ms": fwd["quantize_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "int8_conv",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/int8_conv.cu",
        "replaces": INT8_REPLACES,
        "launches": sum(v["conv_s8"] for v in int8_launches.values()),
        "launches_by_path": {k: v["conv_s8"] for k, v in int8_launches.items()},
        "max_abs_err": int8_kernels["max_abs_err"],
        "ms": fwd["conv_ms"],
        "plain_ms": fwd["plain_conv_ms"],
        "bound_ms": fwd["conv_bound_ms"],
        "bound_by": int8_kernels["forward_conv_bound_by"],
        # im2col (F.unfold) + torch._int_mm on the same convs
        "library_ms": fwd["library_ms"],
        "cudnn_bf16_ms": fwd["cudnn_bf16_ms"],
    }, {
        "name": "kfpn_fuse",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/kfpn_fuse.cu",
        "replaces": KFPN_FUSE_REPLACES,
        # 2 per forward of the port's eager network on the card with
        # autograd off, counted from 0 on each path: the serve phase's
        # calls, the detect CLI's gated device run, the int8 CLI runs
        # (calibration and gate forwards included); none in the train
        # phase's steps and eval-loss steps
        "launches": (served["kfpn_launches"] + from_files_detect["kfpn_launches"]
                     + sum(int8_cli["kfpn_launches"].values()) + trained["kfpn_launches"]),
        "launches_by_path": {"serve": served["kfpn_launches"], "detect_cli_device": from_files_detect["kfpn_launches"],
                             **int8_cli["kfpn_launches"], "train": trained["kfpn_launches"]},
        # the kfpn_fuse phase, at b32 and b1 against the float64 fusion;
        # the times at b32
        "max_abs_err": max(r["max_abs_err"] for r in fused.values()),
        "ms": fused[32]["kernel_ms"],
        "plain_ms": fused[32]["plain_ms"],
        "bound_ms": fused[32]["bound_ms"],
        "bound_by": "bytes",
        # PyTorch's composition of the same fusion (the KFPN's composed loop)
        "library_ms": fused[32]["composed_ms"],
    }, {
        "name": "dcn",
        "route": "cuda",
        "source": "rtm3d_tpu_torch/csrc/dcn.cu",
        "replaces": DCN_REPLACES,
        # 26 per ResNet-101-DCN forward with autograd off on the card: the
        # dcn phase's two b32 detect calls
        "launches": 2 * dcn_rec["network"]["dcn_launches_per_call"],
        "launches_by_path": {"dcn_network": 2 * dcn_rec["network"]["dcn_launches_per_call"]},
        # against the plain version in bf16 at both layer shapes and offset
        # scales; the times summed over one b32 1280x416 forward's 26 layers
        # at the init's offsets
        "max_abs_err": max(r["max_gap"] for r in dcn_rec["layers"].values()),
        "ms": sum(dcn_rec["layers"][(c, 0.1)]["kernel_ms"] * n for c, _, _, n in DCN_LAYERS),
        "plain_ms": sum(dcn_rec["layers"][(c, 0.1)]["plain_ms"] * n for c, _, _, n in DCN_LAYERS),
        "bound_ms": sum(dcn_rec["layers"][(c, 0.1)]["bound_ms"] * n for c, _, _, n in DCN_LAYERS),
        "bound_by": "operations",
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
