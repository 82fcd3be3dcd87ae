"""On-card smoke run of the PyTorch / CUDA port (lvv_tpu_torch) on one H100.

    python3 chip_smoke.py [--only PHASE[,PHASE...]]

With no flag every phase runs. `--only` runs the named ones of kernels,
main-path, lidar-bev, detector-train, detector-zoo, detector-camera,
detector-two-stage, detector-waymo, detector-mppnet, detector-focal,
serving, sam1280, serving-runtime, train-step, trainer (lidar-bev and
serving bring main-path with them; the kernel build is skipped when only
the phases of NO_KERNELS run, and the kernels line, which needs every
path's launches, is printed only when every phase ran); the last line is
the same.

1. Prints the card (nvidia-smi name and power limit), the torch and CUDA
   versions, and builds every CUDA kernel from the sources in this checkout
   (one nvcc per source, all at once).
2. Holds each hand-written kernel against its plain PyTorch version at the
   shapes each driven path gives it (the kernels that no path runs, K-h's
   fused and small forms and its streaming form at 112x112 (SAM 1792²),
   K-l's window alternates with their q·R prep,
   K-m's prepped global attention and the bisect scripts' kernels B-1 /
   B-2, at the shapes and inputs of the benchmarks that time them), in
   bf16 on the card, and times kernel, plain version and (where one
   PyTorch call computes the same function) the library call with CUDA
   events (K-j and K-k: torch._weight_int8pack_mm, where this torch has a
   CUDA kernel for it); K-l's five rows, K-h's fused form, K-f and K-g
   also print `kernel_only_ms`, the launch alone on operands their
   wrapper's glue or prep kernel made beforehand (K-f: the weights
   quantized; K-g also `prep_ms` and its prep's agreement with
   `qk8_operands`), K-a's add form `norm[add]` (a residual add and the
   RMS norm after it, one launch) is also held bit-equal to x + y on its
   s; K-a (both forms), K-b and K-f take fp32 scale and bias, as the
   model keeps its norms' parameters, each with a trap (the parameters
   rounded to bf16 first) its tolerance must fail, K-b prints
   `unfused_ms`, the unfused bf16 sequence (F.layer_norm, F.linear, GELU,
   F.linear, add) on its inputs, a reference the port never calls, and K-i
   its own `unfused_ms` (quantize_rows, quantize_weight, torch._int_mm, the
   fp32 rescale and bias) beside `rows_ms` and `weight_prep_ms`, the two
   quantization passes of its launch alone. A
   disagreement beyond the stated tolerance, a trap that the tolerance
   passes, or a wrapper that did not launch its kernel, fails the run; so
   does a spill that ptxas reports for the d-64 window and K-h kernels or
   for any kernel of the GEMM core (K-b, K-f, K-i), the int8 p@v core, K-j,
   K-k or K-g. Then one line per A/B benchmark of the JAX
   package that times K-l, K-m, B-1 or B-2 (`winattn-ab[...]`,
   `gattn-prep-ab`): per-call ms of each variant beside the kernel SAM
   runs for that function (K-c for the windows, K-d for the 64x64 grid) on
   the benchmark's inputs, and the benchmark's numcheck, the max |diff|
   against that kernel, where the variant computes that function. Then
   the `norm-host` line: the host's time per call of K-a's wrappers at the
   decode's [1, 896] (norm, add_norm, and the pair x + y; norm that the
   add form replaces), a loop of 2,000 calls with the queue kept short.
3. Drives the float main path: `greedy_generate` of
   VQAModel(default_config()) in bf16 with seeded random weights on
   bench.py's inputs (6 views at 1024², BEV [1, 128, 180, 180], 24 prompt
   tokens, 32 new tokens). Launch counts are reset just before a run and
   read just after it, and must equal the counts derived from the model
   (every kernel of the path launched). The tokens of repeated runs must
   agree, and the prefill logits must be finite and agree with the same
   weights run through the plain PyTorch path.
4. Drives bench.py's serving path the same way: quant8 on SAM and CLIP
   (the W8A8 MLP kernel under LVV_Q8_SCOPE "mlp"), the same seeded weights,
   and the packed int8 decode (prepare_serving_params_fused). Its prefill
   logits and first decode step's logits must agree with the same path with
   every kernel swapped for its plain version. Then, on that model:
   bench.py's stream ("bench-stream": greedy_generate_multi over G = 8
   copies of its frame, printed with bench.py's keys; every group's tokens
   must equal the serving path's), a batch of 8 frames of
   benchmarks/serving_bench.py's inputs with one prompt cut short
   ("serving-batch[8]": launches, repeated tokens, and every row's logits
   against every kernel swapped for its plain version), and uint8 frames
   of nuScenes' size through greedy_generate_multi ("u8-check": the
   preprocessing on the card against the CPU's, tokens against
   greedy_generate on the preprocessed views).
5. Runs the same serving model under SAM's other int8 scopes,
   LVV_Q8_SCOPE="mlp,dense,attn" (W8A8 projections K-i, int8 p@v K-d8) and
   "mlp,dense,qk" (K-i, int8 scores K-g), each checked as in 4 and printed
   on a `serving-path[scope]` line.
6. Drives the same two models with SAM at 1280² (DeepSeek-OCR's "Large"
   resolution: an 80x80 global grid, which fails the head-packed test, so
   the 4 global layers run K-h, the head-split rel-pos kernel): the float
   path ("main-path[sam1280]") and the serving model under
   LVV_Q8_SCOPE="mlp,dense,attn" with the packed int8 decode, where K-h
   takes its int8 p@v arm ("serving-path[sam1280,mlp,dense,attn]"). Both
   are checked as in 4: launch counts, repeated tokens, and prefill and
   first-step logits against every kernel swapped for its plain version.
7. Drives the serving runtime on configs/vqa_nuscenes_serving.json (read
   by the port's `config.load`; quant8 SAM and CLIP, a 772-token prefix,
   LoRA 16 / 8) with seeded weights: "serving-checkpoint" (save_checkpoint
   under build/, ModelLoader.load_all on the card, every tensor
   bit-equal); "serving-engine[8]" (ServingEngine with the packed int8
   decode, 12 requests of uint8 nuScenes-size frames and distinct
   questions from 3 threads: launches equal expected_launches per
   dispatched bucket, every answer equal to greedy_generate on its padded
   bucket, each bucket's prefill and first-step logits against every
   kernel swapped for its plain version, latencies, frames/s and device
   busy);
   "continuous[8]" (ContinuousServingEngine: a burst of 8 equal to
   greedy_generate at the slab's cache length, 4 staggered admissions
   reported against batch 1, launches per admission and slab step);
   "serve-http" (the serve CLI's handler on 127.0.0.1: /healthz,
   /v1/stats, a POST equal to the engine's answer and to greedy_generate's
   tokens, a 400, a 404); and "infer-cli" (the infer CLI on the checkpoint
   as a subprocess, exit 0, and through its `main` in this process, whose
   launches are counted; answers equal to greedy_generate's tokens; answer
   texts carry their token ids, `ids_as_text`, where random weights would
   give empty byte strings). The kernels of these phases are checked at
   the preset's shapes in 2 (VATVision's and VATLiDAR's 384 queries, the
   901-token prefill, buckets of 1, 4 and 8 frames).
3a. Right after the float path, on its model, the LiDAR BEV producer
   ("lidar-bev"): VoxelNeXtDetector at default_config()'s full width
   (a seeded 300,000-point surface cloud, 0.075 m voxels over +-54 m,
   160,000 voxels, channels 16-128, fp32) on the card: the stage split
   (voxelize, backbone, head, decode + NMS; p50 of 3 after a warm-up), the
   call's p50, peak memory, one profiled call's device busy and idle, each
   stage's demand against its capacity (telemetry on); the same cloud and
   weights through the port on the CPU (every stage's active ids equal,
   the BEV within BEV_REL_TOL, the same detections within BOX_ABS_TOL);
   the [128, 180, 180] BEV through greedy_generate (launches as derived,
   logits against the plain kernels); and `python -m
   lvv_tpu_torch.tools.precompute_bev` as a subprocess over 2 synthetic
   sweeps under build/ (two float16 files, then a rerun that skips both),
   reading them through the native host I/O library (native/lvv_io.cpp,
   built with g++ at first use; its path printed on a `native-io` line).
3b. Then VoxelNeXt training ("detector-train") at default_config()'s full
   width (fp32, TF32 off; the same surface clouds, their 24 vehicle boxes
   as gts, padded to 128): (a) one "bn" step at batch 1 on the card
   against the port's CPU step from the same weights (the loss, each
   parameter group's gradient, the running statistics; a trap, the batch
   moments detached, has to fail each group's bound by 10x); (b) in each
   norm mode 4 steps at batch 2 on one batch through the CLI's chain
   (s/step p50 of the last 3, samples/s, peak memory, the losses, which
   must fall, one profiled step's device busy and idle, the vel / iou
   parameters moved by weight decay alone); (c) `python -m
   lvv_tpu_torch.tools.train_detector --synthetic --steps 2 --save-every
   1` as a subprocess and through its `main` (exit 0, checkpoints that
   reload bit-equal, the reloaded detector's detections equal to the
   trained one's); (d) the bucketed step's pick on a cloud: the smallest
   bucket that drops nothing, checked by telemetry on the card. No
   hand-written kernel lies on this path (its launches are counted: none).
3c. Then the nuScenes dense-BEV detectors ("detector-zoo"):
   PointPillars, CenterPoint, SECOND and TransFusion, each at its
   configs/nuscenes_*.json preset's full width (fp32, TF32 off, seeded
   weights, ZOO_PRESETS' biases) on lidar_cloud's 300,000-point surface
   cloud. Each one's detect: the stage split (voxelize, the sparse or
   pillar trunk, the 2D trunk, the head, decode) p50 of 3 after a warm-up,
   peak memory, one profiled call's device busy and idle, the detection
   count, and the same call through the port on the CPU (sparse stage ids
   equal, BEV and head outputs within BEV_REL_TOL, detections within
   BOX_ABS_TOL; TransFusion's query picks counted against the CPU's and,
   where any differ, the card's head run again on the CPU's picks).
   TransFusion's detect launches K-e's fp32 form twice and K-a six times
   (counted from zero around its first call). Each family trains:
   ZOO_STEPS steps at batch ZOO_BATCH (s/step p50, samples/s, peak, one
   profiled step, the launches of one step, a loss below the first);
   TransFusion and SECOND then take a step at batch 1 on the card and on
   the CPU from the same weights with every ReLU gate and TransFusion's
   query picks replayed from the card's (loss within DET_LOSS_TOL, each
   group's gradient within
   DET_GRAD_TOL; the gates and picks the CPU would have taken otherwise,
   and the Hungarian matches that differ, counted). Then `python -m
   lvv_tpu_torch.tools.train_detector --config
   configs/nuscenes_transfusion_lidar.json --synthetic --steps 2
   --save-every 1` at tiny_config()'s sizes as a subprocess, its
   checkpoint reloaded bit-equal. K-e's fp32 form and K-a on fp32 x are
   checked in 2 at TransFusion's shapes (FP32_REL_L2_TOL; the scale
   dropped, a single TF32 pass in place of K-e's 3xTF32, or the norm
   parameters rounded to bf16, must fail it).
3d. Then the camera-input detectors ("detector-camera"), each at its
   preset's full width (fp32, TF32 off, seeded weights): BEVFusion at
   configs/nuscenes_bevfusion.json (lidar_cloud's 300,000 points at 0.075
   m, 160,000 voxels; six 256 x 704 views drawn from the seed, on a ring
   at nuScenes' camera yaws, 1.5 m up, f = 560 px) through Swin-T, the
   FPN, the depth projection, the LSS lift and bev_pool, the fuser, the 2D
   trunk and TransFusion's head; CaDDN at configs/kitti_caddn.json (one
   375 x 1242 image, KITTI's published P2 and LiDAR-to-camera transform,
   a 440 x 500 x 4 lattice). Each one's detect: the stage split p50 of 3
   after a warm-up, peak memory, one profiled call's device busy and idle,
   the detection count, and the same call through the port on the CPU
   (BEVFusion's LiDAR stage ids and depth maps equal, its frustum bins
   counted, BEVs and head outputs within BEV_REL_TOL, detections within
   BOX_ABS_TOL, the query picks counted and, where any differ, the card's
   head run again on the CPU's picks; the depth pixels a view). BEVFusion's
   detect launches K-a 27 times (Swin-T's 21 LayerNorms of width 384, 768
   and 1536, the head's 6) and K-e's fp32 form twice, counted from zero
   and matched against the count derived from its module tree
   (`camera_derived_launches`); CaDDN's launches none. K-a is checked in
   2 at Swin's fp32 shapes (SWIN_NORMS, eps 1e-5, FP32_REL_L2_TOL and the
   bf16-rounded-parameter trap).
3e. Then the two-stage detectors ("detector-two-stage"): PV-RCNN,
   PV-RCNN++, Part-A², Voxel R-CNN (its LiDAR trunk), SECOND-IoU and
   PointRCNN at their configs/kitti_*.json presets' full width (fp32, TF32
   off, seeded weights; a 1408 x 1600 x 40 grid, 40,000 voxels, channels
   16-128) on a seeded 120,000-point surface scene in KITTI's range,
   zero-padded to 300,000 rows. Each one's detect: the stage split
   (voxelize, 3D trunk, 2D trunk + RPN, proposal decode + NMS, FPS
   keypoints, second-stage pooling, RoI head, refine; PointRCNN's
   PointNet++, point head, decode + NMS, pooling, RoI head, refine) p50 of
   3 after a warm-up, peak memory, one profiled call's device busy and
   idle, the detections, the share of the kept RoIs' pooled cells that
   hold a feature, the second stage's ops alone at its shapes (FPS, the
   ball query, PointRCNN's kNN and RoI-aware pool), and the same call
   through the port on the CPU: its own FPS samples, ball-query lists and
   kNN indices equal to the card's, the RPN's top-K and NMS keeps replayed
   from the card and the CPU's own counted (sparse stage ids equal, BEV /
   RPN / RoI outputs within BEV_REL_TOL, detections within BOX_ABS_TOL).
   The RPN's boxes are the size of their anchors. Each family trains
   ZOO_STEPS steps at batch ZOO_BATCH (s/step, samples/s, peak, idle, a
   step below the first); PV-RCNN and PointRCNN also at batch 1, card
   against CPU with every ReLU gate, top-K pick and NMS keep replayed from
   the card and the sampling picks equal (loss within DET_LOSS_TOL, each
   top-level group's gradient within DET_GRAD_TOL). None of them launches
   a hand-written kernel (checked).
   Then the train CLI on configs/kitti_pv_rcnn.json at tiny_config()'s
   sizes as a subprocess, its checkpoint reloaded bit-equal.
3f. Then the Waymo detectors ("detector-waymo"): PillarNet, DSVT-pillar
   and DSVT-voxel at configs/waymo_*.json's full width (fp32, TF32 off,
   seeded weights; PillarNet's 1504² pillars, DSVT's 470² grid, 470² x
   32 voxels with ZPoolAttention between its four stages) on waymo_cloud's
   ~180,000-point ray-cast scene (a 64-beam LiDAR over ground, vehicles
   and walls) in the presets' 300,000 rows. Each detect: the stage split
   (VFE or voxelizer, sparse 2D trunk or DSVT stages, collapse + BEV
   trunk, head, decode + NMS; p50 of 3 after a warm-up), peak memory, one
   profiled call's device busy and idle, the telemetry of every
   capacity-bound op (no drops), the sets each DSVT block uses against
   max_sets and the host planner's count, and the same call on the CPU
   (voxel ids, each point's voxel and every block's set tables equal, BEV
   and head outputs within BEV_REL_TOL, detections within BOX_ABS_TOL);
   the trap, DSVT's x layer over y-sorted sets, has to miss BEV_REL_TOL.
   Each trains ZOO_STEPS steps at batch ZOO_BATCH, then one step at batch
   1 card against CPU with every ReLU gate and segment-max winner replayed
   (on a 30,000-point cloud, the capacities cut to it, the card's step
   dropping nothing: WAYMO_CPU_STEP). None launches a hand-written kernel
   (checked).
3g. Then MPPNet ("detector-mppnet") at configs/waymo_mppnet_4frames.json's
   full width (4 frames of 75,000 rows, 32 samples a (proposal, frame),
   d_model 64, two layers of four heads): waymo_cloud's scene with its
   vehicles moving, frame by frame, along seeded velocities. The detect
   at R = 32 and 83 proposals: the stage split (trajectories, pool over
   the 4 frames, head, refine), the share of (proposal, frame) pairs that
   hold points, and the same call on the CPU (pooled points and empty mask
   equal, outputs within MPPNET_REL_TOL); training at batch 2, then batch
   1 card against CPU on the same RoI-sampling draws and gates; MPPNetE2E
   on a 6-frame stream (the bank equal to the CPU's after each push, the
   detections within MPPNET_REL_TOL); the 16-frame preset builds 4 frames.
3h. Then Voxel R-CNN's focal / multimodal trunk ("detector-focal") at
   configs/kitti_voxel_rcnn_car_focal_multimodal.json's full width on
   kitti_cloud and a 375 x 1242 image with a KITTI-like projection: the
   direct call with image and proj (stage split: voxelize, image, the
   focal trunk, 2D + RPN, decode + NMS, pool, RoI head, refine; each focal
   conv's spawned sites), the detect without the image against the CPU
   (stage ids and spawned ids equal, picks replayed, outputs within
   FOCAL_REL_TOL), training at batch 2 (LiDAR-only, as JAX's step) and
   batch 1 against the CPU, the multimodal call's loss and gradients
   against the CPU (the image branch's non-zero), and a zero-image trap.
   Neither phase launches a hand-written kernel (checked).
8. Trains at full width: default_config() in bf16 with fp32 masters,
   TrainConfig's batch 4 (six 1024² views each, BEV [128, 180, 180],
   ByteTokenizer text of 128 prompt and 96 answer tokens: a 1,765-token
   sequence, one row shorter). "train-step": step 1's loss and each
   optimizer group's gradient against the same step with every kernel
   swapped for its plain version (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) and
   against a trap (the LoRA scaling dropped) that the bound has to fail;
   one step to warm up, after which every trainable tensor's gradient is
   non-zero; TRAIN_STEPS timed steps (launches of one counted and equal to
   the forward's: the backward recomputes in plain PyTorch, as the JAX
   package's VJPs do), s/step, answer tokens/s, peak memory, one profiled
   step's device busy and idle; the frozen weights bit-equal afterwards.
   "trainer": Trainer.train() for one epoch over 16 synthetic QA rows on 8
   BEV .npy files under build/ (3 steps, a validation batch, 2 inference
   samples), its checkpoints, and a second Trainer that resumes bit-equal;
   the checkpoint's bytes and the save / load times. The kernels of the
   step are also checked at its shapes in 2 (the LLM's causal attention
   with a ragged row, its add + RMS norms, CLIP's MLP over 24 views).

Prints the per-kernel JSON line (`launches`: the most of one generate or
train step in any driven path, the run that `ms` times; each path's own,
bench-stream's dispatch of G generates and the continuous engine's and the
trainer's totals included, in `launches_by_path`), then the card
line, then as its last line
{"ok": true, "device": {...}}. Any failure raises (non-zero exit, no result
line). TF32 is off for matmuls and convolutions (both paths compute in the
stated dtypes). Needs torch with CUDA and nvcc (CUDA_HOME or PATH).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense bf16 tensor-core peak
INT8_OPS = 1979e12                 # dense int8 tensor-core peak
FP32_FLOPS = 67e12                 # fp32 outside the tensor cores
TF32_FLOPS = 495e12                # dense TF32 tensor-core peak
# Kernel vs plain version, both bf16 out of fp32 math. Elementwise
# |err| <= BF16_TOL * (|plain| + rms(plain)): 4 bf16 ulps of the value, or
# of the output's scale where the value is near 0 (attention outputs are
# averages far below 1). The two round at different points (the attention
# kernels round the unnormalised probabilities to bf16 for p·v, the plain
# version the normalised ones; the MLP kernel rounds its pre-activation) and
# each rounding is worth up to one ulp. Over the whole output the relative
# L2 error must stay under REL_L2_TOL, so a wrong kernel cannot hide in
# elements that are near 0.
BF16_TOL = 1.0 / 32
REL_L2_TOL = 1.0 / 128
# The W8A8 MLP (K-f) against its plain version: the same elementwise rule,
# which admits an int8 rounding flip (kernel and plain version compute LN
# and the activation in another order, so a value on a rounding boundary of
# y8 or h8 may land one step apart; one flip moves an output by at most one
# or two bf16 ulps), and a relative L2 of 1/512 over the output. Flips are
# rare and leave the relative L2 near 3e-4; a wrong scale moves every
# output: a single whole-row scale of h for CLIP's two 2048-wide chunks
# gives ~7e-3, which the elementwise rule alone would pass
# (tests/test_torch_gpu.py::test_q8_tolerance_sees_a_wrong_h_scale).
Q8_REL_L2_TOL = 1.0 / 512
# K-a and K-b with fp32 scale and bias, as the model keeps its norms'
# parameters: a relative L2 of 1e-3. The kernels take the parameters as
# they are, so they sit near 1e-5 (K-a) and 3e-4 (K-b, its pre-activation
# rounded at another point); the same parameters rounded to bf16 first (the
# trap `bf16_params`, at a scale of 1 + 0.1·N) move the output ~3e-3 and
# have to fail it. K-f keeps Q8_REL_L2_TOL, which the trap (~8e-3) fails
# too.
PARAM_REL_L2_TOL = 1e-3
# The int8 p@v arm (K-d8) against its plain version: both take q·k as exact
# products summed in fp32 in another order, so a p on a rounding boundary of
# p8 may land one step apart; one step moves an output by at most
# sp / 127 · |v| / l <= max|v| / 127, which the elementwise rule adds on top
# of BF16_TOL. The relative L2 stays REL_L2_TOL: a single whole-row scale of
# p in place of the 1024-column groups gives ~5e-2 on these inputs and has
# to fail it. K-h's int8 arm takes the same rule and trap. K-i and K-g need
# no allowance: K-i's plain version is its arithmetic exactly (K-i:
# per-tensor scale of x ~1.4e-2 must fail Q8_REL_L2_TOL), and K-g's int8
# scores are exact on both sides (the float scores of K-d, ~4e-2 away, must
# fail REL_L2_TOL). K-g's attention is held to its plain version on its prep
# kernel's operands: the prep sums q·Rh and q·Rw in another order than
# cuBLAS, so a q8 byte of `qk8_operands` may sit one step apart, which moves
# a peaked row's outputs past 4 ulps; the prep is held to `qk8_operands`
# itself (qk8_prep_notes), and the whole function to REL_L2_TOL.
SCOPES = ("mlp,dense,attn", "mlp,dense,qk")
# the 1280² paths: the float path, and the serving model under this scope
LARGE, LARGE_SCOPE = 1280, "mlp,dense,attn"
NEW_TOKENS, PROMPT_LEN, EOS_ID = 32, 24, 2
# a train step: TrainConfig's batch and its text block, 128 prompt tokens,
# 96 answer tokens and eos
TRAIN_BATCH, TRAIN_TEXT = 4, 128 + 96 + 1
# (views or windows, grid side, heads, head dim) of the JAX package's A/B
# benchmarks of K-l (benchmarks/winattn_*_micro.py: SAM-B's 150 windows of
# 14x14 at 1024²) and K-m (benchmarks/gattn_prep_micro.py: 6 views of 64x64)
WINDOWS, GLOBAL = (6 * 25, 14, 12, 64), (6, 64, 12, 64)
# each K-l benchmark's variants: (its result key, variant, options)
WINATTN_AB = {
    "winattn_fused_micro": [("fused2", "fused2", {}),
                            ("fused_wc1", "fused", {"wchunk": 1}),
                            ("fused_wc5", "fused", {"wchunk": 5})],
    "winattn_v3_micro": [("v3_edot", "v3", {"bias_mode": "edot"}),
                         ("v3_bcast", "v3", {"bias_mode": "bcast"})],
    "winattn_v4_micro": [("v4", "v4", {})],
    "winattn_v2_micro": [(f"phased_g{g}" + ("_bdot" if bt else ""), "phased",
                          {"gwin": g, "batched": bt})
                         for g in (1, 2, 5) for bt in (False, True)],
}


def kh_whole_row_trap(q, k, v, q_rh, q_rw, **kw):
    """K-h's int8 arm with one p scale for each whole row (a kv tile as
    wide as the sequence) in place of the 1024-column tiles: the trap its
    tolerance must fail."""
    from lvv_tpu_torch.ops import attention as A
    s = q.shape[2]
    return A.flash_attention_relpos_plain(
        q, k, v, q_rh, q_rw, **dict(kw, block_k=-(-s // 128) * 128))


def bias2_gather_trap(qkv, *, heads, scale, qrh, qrw, eh, ew, **_):
    """B-1's bias2 with its expanders read as one-hot, i.e. a gather of
    qrh's column kv // win and qrw's column kv % win as K-l's row kernels
    read their tables, in place of the dense products qrh @ eh and qrw @ ew:
    the trap its tolerance must fail."""
    import math
    import torch
    from lvv_tpu_torch.ops import attention as A
    s = qkv.shape[1]
    cols = torch.arange(s, device=qkv.device)
    win = math.isqrt(s)
    onehot = [torch.nn.functional.one_hot(c, eh.shape[0]).T.to(eh.dtype)
              for c in (cols // win, cols % win)]
    return A.window_attention_bisect_plain(
        qkv, variant="bias2", heads=heads, scale=scale, qrh=qrh, qrw=qrw,
        eh=onehot[0], ew=onehot[1])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls after one warm-up. The
    stream first spins for ~0.2 ms per call, so the host has queued every
    call before the start event runs: small kernels are timed on the
    device, not at the rate the host can launch them."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


_BENCH_INPUTS: dict = {}


def benchmark_inputs(torch, b: int, g: int, heads: int, d: int):
    """The A/B benchmarks' inputs, drawn as they draw them (numpy
    default_rng(0): qkv N(0, 1) [b, g², 3·heads·d], then rel_h and rel_w
    0.3·N(0, 1) [g, g, d]), in bf16 on the card; made once per shape."""
    import numpy as np
    key = (b, g, heads, d)
    if key not in _BENCH_INPUTS:
        rng = np.random.default_rng(0)
        arrs = (rng.normal(size=(b, g * g, 3 * heads * d)),
                rng.normal(size=(g, g, d)) * 0.3,
                rng.normal(size=(g, g, d)) * 0.3)
        _BENCH_INPUTS[key] = tuple(torch.from_numpy(a).to(
            torch.bfloat16).cuda() for a in arrs)
    return _BENCH_INPUTS[key]


def bisect_inputs(torch):
    """The bisect scripts' inputs (benchmarks/winattn_bisect2.py:45-49):
    numpy default_rng(0), qkv N(0, 1) [150, 196, 2304], rel_h and rel_w
    0.3·N(0, 1) [14, 14, 64], qrh 0.3·N(0, 1) [150, 12, 196, 16], eh
    0.1·N(0, 1) [16, 196], in that order; bf16 on the card. Returns (qkv,
    qrh, eh)."""
    import numpy as np
    b, g, heads, d = WINDOWS
    rng = np.random.default_rng(0)
    qkv = rng.normal(size=(b, g * g, 3 * heads * d))
    rng.normal(size=(g, g, d))
    rng.normal(size=(g, g, d))
    qrh = rng.normal(size=(b, heads, g * g, 16)) * 0.3
    eh = rng.normal(size=(16, g * g)) * 0.1
    return tuple(torch.from_numpy(a).to(torch.bfloat16).cuda()
                 for a in (qkv, qrh, eh))


def head_major(qkv, heads: int, i: int):
    """Part i (q, k, v) of packed qkv [B, S, 3C] as a head-major copy
    [B, H, S, d], as the B-2 script transposes it."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    return qkv[..., i * c:(i + 1) * c].reshape(b, s, heads, c // heads) \
        .transpose(1, 2).contiguous()


def ab_lines(torch) -> None:
    """The JAX package's A/B benchmarks of K-l and K-m on the port: per-call
    ms of each variant beside the kernel SAM runs for the same function
    (K-c, `relpos_attention[14x14]`, for the windows; K-d,
    `relpos_attention[64x64]`, for the global grid) on the benchmark's
    inputs, and its numcheck (max |diff| against that kernel). Prints one
    line per benchmark; a non-finite output fails the run."""
    from lvv_tpu_torch.ops import attention as A

    def run(ref, variants, kw):
        ms, numcheck = {}, {}
        for key, fn in variants.items():
            out = fn().float()
            if not torch.isfinite(out).all():
                raise AssertionError(f"A/B {key}: non-finite output")
            if ref is not None:
                numcheck[key] = float((out - ref).abs().max())
            ms[key] = timed_ms(fn, 20)
        return dict(ms=ms, numcheck=numcheck, **kw)

    b, g, heads, d = WINDOWS
    qkv, rh, rw = benchmark_inputs(torch, *WINDOWS)
    kw = dict(scale=d ** -0.5, heads=heads)
    packed = {"packed": lambda: A.relpos_attention(qkv, rh, rw, **kw)}
    ref = packed["packed"]().float()
    base = run(None, packed, {})["ms"]
    for bench, variants in WINATTN_AB.items():
        line = run(ref, {key: functools.partial(
            getattr(A, f"window_attention_{kind}"), qkv, rh, rw, win=g,
            **kw, **opts) for key, kind, opts in variants},
            dict(benchmark=f"benchmarks/{bench}.py",
                 shape=f"qkv [{b},{g * g},{3 * heads * d}]"))
        line["ms"] = {**base, **line["ms"]}
        print(f"winattn-ab[{bench}]", json.dumps(line), flush=True)
    # B-1 and B-2 (benchmarks/winattn_bisect{2,3}.py): the scripts time
    # their variants only; B-2's rows include the copies to head-major and
    # back, as the script's do (bisect3.py:165-174)
    qkv_b, qrh, eh = bisect_inputs(torch)
    kw_b = dict(heads=heads, scale=d ** -0.5)
    shape = dict(shape=f"qkv [{b},{g * g},{3 * heads * d}]")
    line = run(None, {v: functools.partial(
        A.window_attention_bisect, qkv_b, variant=v, qrh=qrh, qrw=qrh,
        eh=eh, ew=eh, **kw_b) for v in A.BISECT_VARIANTS},
        dict(benchmark="benchmarks/winattn_bisect2.py", **shape))
    line["ms"] = {**base, **line["ms"]}
    print("winattn-ab[winattn_bisect2]", json.dumps(line), flush=True)

    def hmaj():
        o = A.window_attention_hmaj(*(head_major(qkv_b, heads, i)
                                      for i in range(3)), scale=d ** -0.5)
        return o.transpose(1, 2).reshape(b, g * g, heads * d)
    # the script's two schedules, hmaj_loop and hmaj_bdot, are one function
    # and one launch on the card: timed once
    line = run(None, {"hmaj": hmaj},
               dict(benchmark="benchmarks/winattn_bisect3.py",
                    hmaj_is=["hmaj_loop", "hmaj_bdot"], **shape))
    line["ms"] = {**base, **line["ms"]}
    print("winattn-ab[winattn_bisect3]", json.dumps(line), flush=True)
    del qkv_b, qrh, eh

    b, g, heads, d = GLOBAL
    qkv, rh, rw = benchmark_inputs(torch, *GLOBAL)
    kw = dict(scale=d ** -0.5, heads=heads)
    glue = functools.partial(A.relpos_attention, qkv, rh, rw, **kw)
    ref = glue().float()
    line = run(ref, {"hpacked_prepped": functools.partial(
        A.flash_attention_relpos_hpacked_prepped, qkv, rh, rw, grid_w=g,
        **kw)}, dict(benchmark="benchmarks/gattn_prep_micro.py",
                     shape=f"qkv [{b},{g * g},{3 * heads * d}]"))
    line["ms"] = {"hpacked_glue": timed_ms(glue, 20), **line["ms"]}
    print("gattn-prep-ab", json.dumps(line), flush=True)
    _BENCH_INPUTS.clear()


HOST_CALLS = 2000


def host_us(torch, fn, calls: int = HOST_CALLS) -> float:
    """The host's time a call of fn (us, host clock): `calls` calls after a
    warm-up, synchronising every 50 so that the launch queue stays short
    and the host never waits on a full queue."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(calls):
        fn()
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def norm_host(torch) -> dict:
    """K-a's wrappers' host time a call at the decode's shape, x and y [1,
    896] bf16 (the decode is host-bound: a wrapper's host time is part of
    its cost): `norm`, `add_norm`, and the pair it replaces, PyTorch's
    x + y then `norm`. norm_prep_ab.py times the same three beside those of
    another checkout (e.g. one whose `norm` is the Triton kernel this one
    replaced)."""
    from lvv_tpu_torch.ops import fused_mlp as M
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y = (torch.randn(1, 896, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    s = torch.ones(896, dtype=torch.bfloat16, device="cuda")
    return dict(
        shape="[1,896] bf16", calls=HOST_CALLS,
        norm_us=host_us(torch, lambda: M.norm(x, s, eps=1e-6, rms=True)),
        add_norm_us=host_us(torch, lambda: M.add_norm(x, y, s, eps=1e-6,
                                                      rms=True)),
        pair_us=host_us(torch, lambda: M.norm(x + y, s, eps=1e-6, rms=True)))


# --------------------------------------------------------------- kernels --

def qk8_prep_notes(got, want) -> dict:
    """K-g's prep kernel against `qk8_operands` on the card: k8 and sk
    must be bit-equal (the same roundings); q8, sq and qrw take q·Rh and
    q·Rw as sums in another order than cuBLAS's, so a q8 byte may move one
    step (not more) and a bf16 value one ulp. Returns the shares of equal
    values and the largest differences."""
    import torch
    q8, k8, sq, sk, qrw = got
    if not (torch.equal(k8, want[1]) and torch.equal(sk, want[3])):
        raise AssertionError("qk8_prep: k8 / sk differ from qk8_operands")
    step = int((q8.int() - want[0].int()).abs().max())
    if step > 1:
        raise AssertionError(f"qk8_prep: a q8 byte {step} steps off")
    return dict(prep_q8_equal_share=float((q8 == want[0]).float().mean()),
                prep_q8_max_step=step,
                prep_sq_equal_share=float((sq == want[2]).float().mean()),
                prep_qrw_equal_share=float((qrw == want[4]).float().mean()),
                prep_qrw_max_abs_diff=float((qrw - want[4]).abs().max()))


def kernel_cases(torch):
    """(row, label, launches per greedy_generate, setup, resolution) at the
    shapes of the paths at SAM's 1024² and 1280², of serving-batch[8]
    (resolution (1024, 8)) and of the serving runtime's phases on the
    serving preset, a bucket of b frames (resolution ("preset", b));
    resolution None: a form that no path runs, timed per call. setup() -> dict(kernel, plain, library, flops, bytes,
    peak)."""
    import torch.nn.functional as F
    from lvv_tpu_torch.ops import attention as A
    from lvv_tpu_torch.ops import fused_mlp as M
    from lvv_tpu_torch.ops import quant as Q
    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    def fp32(*shape, std=1.0):      # a norm parameter, fp32 as the model's
        return torch.randn(shape, generator=gen, device=dev) * std

    def param_trap(plain, *params):
        # the plain version with the fp32 norm parameters rounded to bf16
        # first: the tolerance has to see it
        return {"bf16_params": lambda: plain(*(
            None if t is None else t.to(bf).float() for t in params))}

    def norm_case(n, c, rms):
        def setup():
            x, s, b = rnd(n, c), 1 + fp32(c, std=0.1), fp32(c, std=0.1)
            bias = None if rms else b
            # PyTorch's fused CUDA norms take no fp32 parameters beside
            # bf16 x (layer_norm refuses them, rms_norm falls back to
            # several kernels): the yardstick call gets them in bf16
            sb, bb = s.to(bf), b.to(bf)
            lib = ((lambda: F.rms_norm(x, (c,), sb, 1e-6)) if rms else
                   (lambda: F.layer_norm(x, (c,), sb, bb, 1e-6)))
            return dict(
                notes={"library": ("F.rms_norm" if rms else "F.layer_norm")
                       + ", parameters in bf16"},
                kernel=lambda: M.norm(x, s, bias, eps=1e-6, rms=rms),
                plain=lambda: M.norm_plain(x, s, bias, eps=1e-6, rms=rms),
                library=lib, flops=7 * n * c, peak=FP32_FLOPS,
                bytes=2 * 2 * n * c + 4 * 2 * c,
                rel_l2_tol=PARAM_REL_L2_TOL,
                traps=param_trap(lambda s, b: M.norm_plain(
                    x, s, b, eps=1e-6, rms=rms), s, bias))
        return setup

    def norm_f32_case(n, c, eps=1e-6):
        # K-a on fp32 x with fp32 parameters (the query heads' LayerNorms,
        # Swin's at eps 1e-5)
        def setup():
            x, s, b = fp32(n, c), 1 + fp32(c, std=0.1), fp32(c, std=0.1)
            return dict(
                kernel=lambda: M.norm(x, s, b, eps=eps),
                plain=lambda: M.norm_plain(x, s, b, eps=eps),
                library=lambda: F.layer_norm(x, (c,), s, b, eps),
                flops=7 * n * c, peak=FP32_FLOPS,
                bytes=4 * 2 * n * c + 4 * 2 * c,
                rel_l2_tol=FP32_REL_L2_TOL,
                traps=param_trap(lambda s, b: M.norm_plain(
                    x, s, b, eps=eps), s, b))
        return setup

    def add_norm_case(n, c):
        # K-a's add form as Qwen calls it: a residual add, then RMSNorm
        def setup():
            x, y, s = rnd(n, c), rnd(n, c), 1 + fp32(c, std=0.1)
            sb = s.to(bf)               # the yardstick's scale, as norm_case

            def exact(got):
                if not torch.equal(got[:n * c].view(n, c), x + y):
                    raise AssertionError(f"add_norm [{n},{c}]: s is not "
                                         "bit-equal to x + y")
                return {"s_bit_equal_to_x_plus_y": True}
            return dict(
                kernel=lambda: flat(M.add_norm(x, y, s, eps=1e-6, rms=True)),
                plain=lambda: flat(M.add_norm_plain(x, y, s, eps=1e-6,
                                                    rms=True)),
                timed_kernel=lambda: M.add_norm(x, y, s, eps=1e-6, rms=True),
                timed_plain=lambda: M.add_norm_plain(x, y, s, eps=1e-6,
                                                     rms=True),
                library=lambda: F.rms_norm(x + y, (c,), sb, 1e-6),
                notes={"library": "a sequence of two calls: x + y, then "
                                  "F.rms_norm, its scale in bf16"},
                check=exact, flops=8 * n * c, peak=FP32_FLOPS,
                bytes=2 * 4 * n * c + 4 * c,
                rel_l2_tol=PARAM_REL_L2_TOL,
                traps=param_trap(lambda s: flat(M.add_norm_plain(
                    x, y, s, eps=1e-6, rms=True)), s))
        return setup

    def mlp_case(n, c, h, act):
        def setup():
            x = rnd(n, c)
            p = (1 + fp32(c, std=0.1), fp32(c, std=0.1),
                 rnd(c, h, std=c ** -0.5), rnd(h, std=0.1),
                 rnd(h, c, std=h ** -0.5), rnd(c, std=0.1))
            ls, lb, w1, b1, w2, b2 = p
            w1t, w2t = w1.t(), w2.t()       # F.linear's [out, in] views
            lsb, lbb = ls.to(bf), lb.to(bf)

            def unfused():                  # a reference of several calls
                y = F.layer_norm(x, (c,), lsb, lbb, 1e-6)
                z = F.linear(y, w1t, b1)
                z = (F.gelu(z, approximate="tanh") if act == "gelu"
                     else z * torch.sigmoid(1.702 * z))
                return x + F.linear(z, w2t, b2)
            return dict(
                kernel=lambda: M.ln_mlp_residual(x, *p, eps=1e-6, act=act),
                plain=lambda: M.ln_mlp_residual_plain(x, *p, eps=1e-6,
                                                      act=act),
                library=None, flops=4 * n * c * h, peak=BF16_FLOPS,
                bytes=2 * (2 * n * c + 2 * c * h + c + h) + 4 * 2 * c,
                rel_l2_tol=PARAM_REL_L2_TOL,
                traps=param_trap(lambda ls, lb: M.ln_mlp_residual_plain(
                    x, ls, lb, *p[2:], eps=1e-6, act=act), ls, lb),
                info={"unfused_ms": unfused})
        return setup

    def q8_case(n, c, h, act):
        # the function as the model calls it: float weights in, quantized
        # per call by the wrapper, then the kernel
        def setup():
            x = rnd(n, c)
            p = (1 + fp32(c, std=0.1), fp32(c, std=0.1),
                 rnd(c, h, std=c ** -0.5), rnd(h, std=0.1),
                 rnd(h, c, std=h ** -0.5), rnd(c, std=0.1))
            block_h = M.q8_block_h(c, h, 2)
            w1t, s1 = M.quantize_weight_t(p[2])
            w2t, s2 = M.quantize_weight_t(p[4])
            case = dict(
                kernel=lambda: M.ln_mlp_residual_q8(x, *p, eps=1e-6, act=act),
                plain=lambda: M.ln_mlp_residual_q8_plain(x, *p, eps=1e-6,
                                                         act=act),
                library=None, flops=4 * n * c * h, peak=INT8_OPS,
                bytes=2 * (2 * n * c + 2 * c * h + c + h) + 4 * 2 * c,
                rel_l2_tol=Q8_REL_L2_TOL,
                traps=param_trap(lambda ls, lb: M.ln_mlp_residual_q8_plain(
                    x, ls, lb, *p[2:], eps=1e-6, act=act), p[0], p[1]),
                kernel_only=lambda: M.ln_mlp_residual_q8_launch(
                    x, p[0], p[1], w1t, s1, p[3], w2t, s2, p[5],
                    block_h=block_h, eps=1e-6, act=act))
            if block_h < h:                    # h has per-chunk row scales
                case["traps"]["whole_row_h_scale"] = (
                    lambda: M.ln_mlp_residual_q8_plain(
                        x, *p, eps=1e-6, act=act, block_h=h))
            return case
        return setup

    # the one PyTorch call of K-j's and K-k's function, where this torch has
    # a CUDA kernel for it (a yardstick the port never calls)
    int8pack = torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::_weight_int8pack_mm", "CUDA")

    def int8_case(m, k, n, nk=False):
        # The decode streams ~0.5 GB of int8 weights a step, so each product
        # finds its weight outside the 50 MB L2: the timed calls rotate
        # through enough copies of the weight to exceed it.
        def setup():
            x = rnd(m, k)
            weights = []
            for _ in range(max(1, -(-128 * 2 ** 20 // (k * n)))):
                if nk:      # the tied table [n, k], per-row scales
                    t = Q.quantize_rows_table(rnd(n, k, std=0.02))
                    weights.append((t["q"], t["s"]))
                else:
                    weights.append(Q.quantize_weight(rnd(k, n, std=k ** -0.5)))
            fn, plain = ((Q.quantized_matmul_nk, Q.quantized_matmul_nk_plain)
                         if nk else
                         (Q.quantized_matmul, Q.quantized_matmul_plain))
            turn = iter(range(10 ** 9))

            def rotating(f, ws=weights):
                return lambda: f(x, *ws[next(turn) % len(ws)])
            w0, s0 = weights[0]
            case = dict(kernel=lambda: fn(x, *weights[0]),
                        plain=lambda: plain(x, *weights[0]),
                        timed_kernel=rotating(fn), timed_plain=rotating(plain),
                        library=None, flops=2 * m * k * n, peak=FP32_FLOPS,
                        bytes=k * n + 4 * n + 2 * (m * k + m * n),
                        # each column's scale on its neighbour's column
                        traps={"rolled_scale": lambda: plain(
                            x, w0, s0.roll(1))},
                        notes={"library": "torch._weight_int8pack_mm (bf16 "
                                          "scales), [N, K] weight copies"
                               if int8pack else "none (no CUDA kernel in "
                               f"torch {torch.__version__})"})
            if int8pack:
                packs = [(w if nk else w.t().contiguous(), sc.to(x.dtype))
                         for w, sc in weights]
                case["library"] = rotating(torch._weight_int8pack_mm, packs)
            return case
        return setup

    def flash_case(sq, sk, hq, hkv, d, causal, b=1, short=None):
        # short: (row, kv_len) of a prompt cut short in a batch's prefill
        def setup():
            # q / k / v as views of the projections, as the model passes them
            q = rnd(b, sq, hq * d).view(b, sq, hq, d).transpose(1, 2)
            k = rnd(b, sk, hkv * d).view(b, sk, hkv, d).transpose(1, 2)
            v = rnd(b, sk, hkv * d).view(b, sk, hkv, d).transpose(1, 2)
            kv_len = torch.full((b,), sk, dtype=torch.int32, device=dev)
            mask = None
            if short:
                kv_len[short[0]] = short[1]
                # SDPA's yardstick of the same function: causal and kv_len
                # as one boolean mask
                i = torch.arange(sk, device=dev)
                mask = ((i[None, :] <= i[:, None])[None]
                        & (i[None, None, :] < kv_len[:, None, None]))[:, None]
            kl = kv_len if causal else None
            rep = hq // hkv
            kr, vr = (t.repeat_interleave(rep, 1) for t in (k, v))
            pairs = b * sq * sk / (2 if causal else 1)
            # a causal row over few keys is a sum of few p·v terms: the two
            # versions round p to bf16 at different points (each up to 2^-8
            # of p, the p of a row summing to 1), which moves such an output
            # by up to max|v| / 128 where |out| may be near 0
            extra = float(v.abs().max()) / 128 if causal else 0.0
            # the kv splits of the kernel's grid, and the blocks they give
            splits = A.flash_splits(b, hq, sq, sk)
            return dict(
                notes=dict(kv_splits=splits,
                           blocks=-(-sq // 128) * hq * b * splits),
                kernel=lambda: A.flash_attention(q, k, v, causal=causal,
                                                 kv_len=kl),
                plain=lambda: A.flash_attention_plain(q, k, v, causal=causal,
                                                      kv_len=kl),
                library=lambda: F.scaled_dot_product_attention(
                    q, kr, vr, attn_mask=mask,
                    is_causal=causal and mask is None),
                flops=4 * pairs * d * hq, peak=BF16_FLOPS,
                bytes=2 * b * (2 * sq * hq * d + 2 * sk * hkv * d),
                abs_extra=extra)
        return setup

    def flash_f32_case(sq, sk, h, d, b=1):
        # K-e's fp32 form, q / k / v as views of the fp32 projections; its
        # products run in 3xTF32, three TF32 passes a product
        def setup():
            q, k, v = (fp32(b, s, h * d).view(b, s, h, d).transpose(1, 2)
                       for s in (sq, sk, sk))
            plan = A.flash_f32_plan(b, h, sq, sk, d)
            flops = 4 * b * sq * sk * d * h

            def f64_gaps(got):
                # both fp32 results against the function in float64
                w = torch.softmax(q.double() @ k.double().transpose(-1, -2)
                                  * d ** -0.5, -1) @ v.double()
                plain = A.flash_attention_plain(q, k, v).double()
                return {name: float((x.double() - w).norm() / w.norm())
                        for name, x in (("f64_rel_l2", got),
                                        ("plain_f64_rel_l2", plain))}
            return dict(
                check=f64_gaps,
                notes=dict(kv_splits=plan["splits"], blocks=plan["blocks"],
                           rows_a_block=plan["rows"], keys_a_tile=plan["keys"],
                           fp32_fma_bound_ms=flops / FP32_FLOPS * 1e3,
                           library="SDPA on fp32, TF32 off"),
                kernel=lambda: A.flash_attention(q, k, v),
                plain=lambda: A.flash_attention_plain(q, k, v),
                library=lambda: F.scaled_dot_product_attention(q, k, v),
                flops=3 * flops, peak=TF32_FLOPS,
                bytes=4 * b * h * d * (2 * sq + 2 * sk),
                rel_l2_tol=FP32_REL_L2_TOL,
                traps={"scale_dropped": lambda: A.flash_attention_plain(
                    q, k, v, scale=1.0),
                       "single_tf32": lambda: A.flash_attention_tf32_plain(
                    q, k, v, passes=1)})
        return setup

    def relpos_case(b, g, heads, d):
        def setup():
            s, c = g * g, heads * d
            qkv = rnd(b, s, 3 * c, std=0.5)
            rh, rw = rnd(g, g, d, std=0.1), rnd(g, g, d, std=0.1)
            q, k, v = A._split_qkv(qkv, heads)
            kw = dict(heads=heads, scale=d ** -0.5)
            # the plain version and the bias take fp32 [S, S] a (view,
            # head): global views 6 at a time (each view is independent, as
            # in plain_kernels), windows at once
            part = 6 if s > 512 else b
            bias = torch.empty(b, heads, s, s, dtype=bf, device=dev)
            for i in range(0, b, part):
                bias[i:i + part] = A.relpos_bias(q[i:i + part], rh, rw, g)
            return dict(
                kernel=lambda: A.relpos_attention(qkv, rh, rw, **kw),
                plain=lambda: torch.cat([
                    A.relpos_attention_plain(x, rh, rw, **kw)
                    for x in qkv.split(part)]),
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias),
                flops=b * heads * (4 * s * s * d + 2 * s * 2 * g * d),
                peak=BF16_FLOPS, bytes=2 * (b * s * 4 * c + 2 * g * g * d))
        return setup

    def w8a8_case(m, k, n):
        def setup():
            x, w, b = rnd(m, k), rnd(k, n, std=k ** -0.5), rnd(n, std=0.1)

            def per_tensor_x():
                """the trap: one scale for all of x in place of one a row"""
                xf = x.float()
                sx = torch.clamp_min(xf.abs().max() / 127.0, 1e-8)
                xq = torch.clamp(torch.round(xf / sx), -127, 127)
                wq, sw = Q.quantize_weight(w)
                return (Q.int8_exact(xq, wq) * sx * sw + b.float()).to(bf)

            def unfused():
                """the function as a sequence of PyTorch calls (a yardstick
                the port never calls): both quantizations, cuBLAS's int8
                product, the fp32 rescale and bias"""
                x8, sx = Q.quantize_rows(x)
                wq, sw = Q.quantize_weight(w)
                z = torch._int_mm(x8, wq).float()
                return ((z * sx) * sw + b.float()).to(bf)
            return dict(
                kernel=lambda: Q.w8a8_matmul(x, w, b),
                plain=lambda: Q.int8_dot(x, w, b), library=None,
                info={"unfused_ms": unfused,
                      "rows_ms": lambda: Q.w8a8_rows(x),
                      "weight_prep_ms": lambda: M.quantize_weight_t(w),
                      "info_bf16_matmul_ms_not_same_function":
                          lambda: torch.matmul(x, w) + b},
                notes={"library": "none: no one PyTorch call computes W8A8 "
                                  "with a per-row dynamic scale of x "
                                  "(unfused_ms: the unfused sequence)"},
                flops=2 * m * k * n, peak=INT8_OPS,
                bytes=2 * (m * k + k * n + n + m * n),
                rel_l2_tol=Q8_REL_L2_TOL,
                traps={"per_tensor_x_scale": per_tensor_x})
        return setup

    def relpos_q8_case(b, g, heads, d, qk8):
        # std 1 gives peaked rows, where the quantization of p matters
        def setup():
            s, c = g * g, heads * d
            qkv = rnd(b, s, 3 * c)
            rh, rw = rnd(g, g, d, std=0.1), rnd(g, g, d, std=0.1)
            kw = dict(heads=heads, scale=d ** -0.5)
            pair = b * heads * 2 * s * s * d
            bias = b * heads * 2 * s * 2 * g * d
            case = dict(library=None, bytes=2 * (b * s * 4 * c + 2 * g * g * d))
            if qk8:
                # the attention against its plain version on the prep's
                # operands (the same exact scores); the prep against
                # qk8_operands (qk8_prep_notes)
                ops = A.qk8_prep(qkv, rh, rw, **kw)
                prepped = A.qk8_prep_operands(ops, s)
                case.update(
                    kernel=lambda: A.relpos_attention_qk8(qkv, rh, rw, **kw),
                    plain=lambda: A.qk8_attention_plain(qkv, prepped,
                                                        heads=heads),
                    notes=qk8_prep_notes(prepped, A.qk8_operands(
                        qkv, rh, rw, **kw)),
                    # the whole function, the prep's q·R sums apart
                    rel_l2_refs={"whole_plain": lambda: (
                        A.relpos_attention_qk8_plain(qkv, rh, rw, **kw))},
                    flops=pair * 128 // d + pair,
                    ops_ms=(pair * 128 // d / INT8_OPS
                            + pair / BF16_FLOPS) * 1e3,
                    traps={"float_scores": lambda: A.relpos_attention_plain(
                        qkv, rh, rw, **kw)},
                    # the attention launch alone, on the prep's operands
                    kernel_only=lambda: A.qk8_attend(qkv, ops, heads=heads,
                                                     grid_w=g),
                    info={"prep_ms": lambda: A.qk8_prep(qkv, rh, rw, **kw)})
            else:
                case.update(
                    kernel=lambda: A.relpos_attention(
                        qkv, rh, rw, pv_int8=True, pv_group=1024, **kw),
                    plain=lambda: A.relpos_attention_plain(
                        qkv, rh, rw, pv_int8=True, pv_group=1024, **kw),
                    flops=2 * pair + bias,
                    ops_ms=((pair + bias) / BF16_FLOPS
                            + pair / INT8_OPS) * 1e3,
                    abs_extra=float(qkv[..., 2 * c:].abs().max()) / 127,
                    traps={"whole_row_p_scale": lambda: A.relpos_attention_plain(
                        qkv, rh, rw, pv_int8=True, pv_group=s, **kw)})
                # the launch alone, on v's int8 operands made beforehand
                pv8 = A.pv8_v_operands(qkv[..., 2 * c:].view(b, s, heads, d),
                                       1)
                case["kernel_only"] = lambda: A._relpos_launch(
                    qkv, rh, rw, pv_group=1024, pv8=pv8, **kw)
            return case
        return setup

    def kh_case(b, g, heads, d, quant8=False, bq=4096, bk=1024):
        # K-h on head-split views of a packed projection, as SAM passes
        # them; std 1 gives the int8 arm peaked rows (see relpos_q8_case)
        def setup():
            s = g * g
            qkv = rnd(b, s, 3 * heads * d, std=1.0 if quant8 else 0.5)
            q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
            ops = (q, k, v, rnd(b, heads, s, g, std=0.5),
                   rnd(b, heads, s, g, std=0.5))
            kw = dict(scale=d ** -0.5, grid_w=g, block_q=bq, block_k=bk,
                      quant8=quant8)
            pair = b * heads * 2 * s * s * d
            case = dict(
                kernel=lambda: A.flash_attention_relpos(*ops, **kw),
                plain=lambda: A.flash_attention_relpos_plain(*ops, **kw),
                library=None, bytes=2 * b * heads * s * (4 * d + 2 * g),
                flops=2 * pair, peak=BF16_FLOPS)
            form, kv_end, tile = A.kh_form(s, d, g, bq, bk)
            # the launch alone, on the operands its glue made (the fused
            # form's q_aug, k_aug, width table; the int8 arm's v8t, sv)
            pv8 = A.pv8_v_operands(v, 2) if quant8 else None
            name = (f"flash_attention_relpos{'_fused' * (form == 'fused')}"
                    f"{'_pv8' * quant8}[{g}x{g}]")
            if form == "fused":
                fo = A.fused_operands(q, k, ops[3], ops[4], scale=kw["scale"],
                                      grid_w=g)
                case["kernel_only"] = lambda: A._kh_launch(
                    A._KH_MODES["fused"], name, fo[0], fo[1], v, None, fo[2],
                    scale=kw["scale"], grid_w=g, d=d, kv_end=s,
                    group=bk if quant8 else 0, pv8=pv8)
            elif quant8:
                case["kernel_only"] = lambda: A._kh_launch(
                    A._KH_MODES["stream"], name, *ops, scale=kw["scale"],
                    grid_w=g, d=d, kv_end=kv_end, group=tile, pv8=pv8)
            if quant8:
                case.update(ops_ms=(pair / BF16_FLOPS + pair / INT8_OPS) * 1e3,
                            abs_extra=float(v.abs().max()) / 127,
                            traps={"whole_row_p_scale":
                                   lambda: kh_whole_row_trap(*ops, **kw)})
            else:
                # SDPA with the [S, S] bias materialised in bf16
                cols = torch.arange(s, device=dev)
                bias = torch.empty(b, heads, s, s, dtype=bf, device=dev)
                for i in range(b):
                    bias[i] = (ops[3][i][..., cols // g]
                               + ops[4][i][..., cols % g])
                case["library"] = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias)
            return case
        return setup

    def sdpa_bias(qkv, rh, rw, heads, g):
        """SDPA with SAM's rel-pos bias materialised in bf16, from packed
        qkv (the yardstick of the K-c / K-d rows)."""
        q, k, v = A._split_qkv(qkv, heads)
        bias = A.relpos_bias(q, rh, rw, g).to(bf)
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias)

    def flat(outs):
        return torch.cat([t.reshape(-1) for t in outs])

    def window_case(kind, **opts):
        # a K-l variant at its A/B benchmark's shape and inputs; its ms
        # holds the wrapper's glue (v4: its prep kernel)
        def setup():
            b, g, heads, d = WINDOWS
            qkv, rh, rw = benchmark_inputs(torch, *WINDOWS)
            kw = dict(scale=d ** -0.5, heads=heads, win=g, **opts)
            s, c = g * g, heads * d
            # the launch alone, on the rows its glue made (kernel_only_ms)
            rows = A._window_glue(kind, qkv, rh, rw, heads, g, False)
            return dict(
                kernel=lambda: getattr(A, f"window_attention_{kind}")(
                    qkv, rh, rw, **kw),
                plain=lambda: getattr(A, f"window_attention_{kind}_plain")(
                    qkv, rh, rw, **kw),
                kernel_only=lambda: A._window_rows_launch(
                    kind, qkv, *rows, heads=heads, win=g, scale=d ** -0.5,
                    prescale=kind in ("fused", "fused2")),
                library=sdpa_bias(qkv, rh, rw, heads, g),
                also=("qr_prep[rows]",) if kind == "v4" else (),
                flops=b * heads * (4 * s * s * d + 2 * s * 2 * g * d),
                peak=BF16_FLOPS, bytes=2 * (b * s * 4 * c + 2 * g * g * d))
        return setup

    def window_prep_case():
        def setup():
            b, g, heads, d = WINDOWS
            qkv, rh, rw = benchmark_inputs(torch, *WINDOWS)
            kw = dict(heads=heads, win=g)
            s, c, kp = g * g, heads * d, A._kpad(g)
            # one einsum over the gathered tables makes both rows
            cols = torch.arange(s, device=qkv.device)
            tg = torch.cat([A._log2e_table(rh, bf)[cols // g],
                            A._log2e_table(rw, bf)[cols % g]], 1)
            q4 = qkv[..., :c].view(b, s, heads, d)
            return dict(
                library=None, info={"einsum_q_r_only_ms": lambda: torch.einsum(
                    "bshd,skd->bshk", q4, tg)},
                notes={"library": "none: no one PyTorch call computes both "
                                  "padded row tensors (einsum_q_r_only_ms: "
                                  "one einsum over the gathered tables, "
                                  "unpadded)"},
                kernel=lambda: flat(A.window_bias_prep(qkv, rh, rw, **kw)),
                plain=lambda: flat(A.window_bias_prep_plain(qkv, rh, rw,
                                                            **kw)),
                timed_kernel=lambda: A.window_bias_prep(qkv, rh, rw, **kw),
                timed_plain=lambda: A.window_bias_prep_plain(qkv, rh, rw,
                                                             **kw),
                flops=2 * b * s * heads * 2 * g * d, peak=BF16_FLOPS,
                bytes=2 * (b * s * c + 2 * g * g * d + 2 * b * s * heads * kp))
        return setup

    def hpacked_prep_case(mode):
        def setup():
            b, g, heads, d = GLOBAL
            qkv, rh, rw = benchmark_inputs(torch, *GLOBAL)
            kw = dict(heads=heads, grid_w=g, scale=d ** -0.5, modes=(mode,))
            s, c = g * g, heads * d
            # one einsum makes the same q·R rows (not the copied lanes)
            q5 = qkv[..., :c].view(b, g, g, heads, d)
            eq, tab = (("bGwnc,Gkc->bGwnk", rh) if mode == "qk"
                       else ("bGwnc,wkc->bGwnk", rw))
            tab = A._log2e_table(tab, bf)
            n_out = 2 if mode == "qk" else 1
            return dict(
                kernel=lambda: flat(A.hpacked_prep(qkv, rh, rw, **kw)),
                plain=lambda: flat(A.hpacked_prep_plain(qkv, rh, rw, **kw)),
                timed_kernel=lambda: A.hpacked_prep(qkv, rh, rw, **kw),
                timed_plain=lambda: A.hpacked_prep_plain(qkv, rh, rw, **kw),
                # not the function: the q·R lanes alone
                library=None, info={"einsum_q_r_only_ms": lambda: torch.einsum(
                    eq, q5, tab)},
                notes={"library": "none: no one PyTorch call computes the "
                                  "lane blocks (einsum_q_r_only_ms: the "
                                  "q·R product alone)"},
                flops=2 * b * s * heads * g * d, peak=BF16_FLOPS,
                bytes=2 * (2 * b * s * c + g * g * d
                           + n_out * b * s * heads * 128))
        return setup

    def prepped_case():
        # K-m from qkv: its two prep launches, then K-h's fused mode
        def setup():
            b, g, heads, d = GLOBAL
            qkv, rh, rw = benchmark_inputs(torch, *GLOBAL)
            kw = dict(scale=d ** -0.5, grid_w=g, heads=heads)
            s, c = g * g, heads * d
            return dict(
                kernel=lambda: A.flash_attention_relpos_hpacked_prepped(
                    qkv, rh, rw, **kw),
                plain=lambda: A.flash_attention_relpos_hpacked_prepped_plain(
                    qkv, rh, rw, **kw),
                library=sdpa_bias(qkv, rh, rw, heads, g),
                also=("qr_prep[qk]", "qr_prep[v]"),
                # the kernel rounds p against the running maximum of 64-key
                # tiles, the plain version (as the TPU) of 1024-key tiles;
                # on these peaked rows (qkv N(0, 1)) an output is a sum of
                # few p·v terms, each rounding worth up to 2^-9·max|v|
                abs_extra=float(qkv[..., 2 * c:].abs().max()) / 128,
                flops=b * heads * (4 * s * s * d + 2 * s * 2 * g * d),
                peak=BF16_FLOPS, bytes=2 * (b * s * 4 * c + 2 * g * g * d))
        return setup

    def bisect_case(variant):
        # B-1 at its script's shape and inputs (the script passes qrh for
        # both rows and eh for both expanders)
        def setup():
            b, g, heads, d = WINDOWS
            qkv, qrh, eh = bisect_inputs(torch)
            kw = dict(variant=variant, heads=heads, scale=d ** -0.5, qrh=qrh,
                      qrw=qrh, eh=eh, ew=eh)
            s, c = g * g, heads * d
            pair = b * heads * 2 * s * s * d       # one product of S² · d
            case = dict(
                kernel=lambda: A.window_attention_bisect(qkv, **kw),
                plain=lambda: A.window_attention_bisect_plain(qkv, **kw),
                library=None, peak=BF16_FLOPS,
                flops=pair * (1 if variant == "dots_qk" else 2),
                bytes=2 * b * s * (3 * c if variant == "dots_qk" else 4 * c))
            if variant in ("softmax", "bias2"):
                q, k, v = A._split_qkv(qkv, heads)
                # rows of few terms (qkv N(0, 1)): p rounded after exp and
                # division taken in another order, as in K-m's case
                case["abs_extra"] = float(v.abs().max()) / 128
                bias = None
                if variant == "bias2":
                    bias = (torch.matmul(qrh.float(), eh.float()) * 2).to(bf)
                    case["flops"] += 2 * b * heads * 2 * s * 16 * s
                    case["bytes"] += 2 * 2 * (b * heads * s * 16 + 16 * s)
                    case["traps"] = {"one_hot_expanders":
                                     lambda: bias2_gather_trap(qkv, **kw)}
                case["library"] = lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=bias, scale=d ** -0.5)
            return case
        return setup

    def hmaj_case():
        # B-2 at its script's shape, on head-major copies of the inputs
        def setup():
            b, g, heads, d = WINDOWS
            qkv = bisect_inputs(torch)[0]
            q, k, v = (head_major(qkv, heads, i) for i in range(3))
            s = g * g
            return dict(
                kernel=lambda: A.window_attention_hmaj(q, k, v,
                                                       scale=d ** -0.5),
                plain=lambda: A.window_attention_hmaj_plain(q, k, v,
                                                            scale=d ** -0.5),
                library=lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=d ** -0.5),
                abs_extra=float(v.abs().max()) / 128,
                flops=b * heads * 4 * s * s * d, peak=BF16_FLOPS,
                bytes=2 * b * heads * s * 4 * d)
        return setup

    # a Qwen pass runs 49 RMS norms: the first layer's input norm alone, the
    # other 48 after a residual add, in K-a's add form
    adds = 2 * 24
    layer_steps = 24 * NEW_TOKENS
    large = [       # every shape of the 1280² paths
        ("norm", "LN SAM [38400,768]", 12, norm_case(38400, 768, False)),
        ("norm", "LN SAM neck [38400,256]", 2, norm_case(38400, 256, False)),
        ("norm", "LN CLIP [2406,1024]", 25, norm_case(2406, 1024, False)),
        ("norm", "LN adapter [2400,2048]", 1, norm_case(2400, 2048, False)),
        ("norm", "LN VATVision [1200,2048]", 15,
         norm_case(1200, 2048, False)),
        ("norm", "LN VATVision out [1200,896]", 1,
         norm_case(1200, 896, False)),
        ("norm", "LN VATLiDAR [768,896]", 14, norm_case(768, 896, False)),
        ("norm", "LN VATLiDAR in [32400,896]", 1,
         norm_case(32400, 896, False)),
        ("norm", "RMS prefill [1996,896]", 1, norm_case(1996, 896, True)),
        ("norm", "RMS decode [1,896]", NEW_TOKENS, norm_case(1, 896, True)),
        ("norm[add]", "add + RMS prefill [1996,896]", adds,
         add_norm_case(1996, 896)),
        ("norm[add]", "add + RMS decode [1,896]", adds * NEW_TOKENS,
         add_norm_case(1, 896)),
        ("ln_mlp_residual", "SAM [38400,768]x[768,3072] gelu", 12,
         mlp_case(38400, 768, 3072, "gelu")),
        ("ln_mlp_residual", "CLIP [2406,1024]x[1024,4096] quick_gelu", 24,
         mlp_case(2406, 1024, 4096, "quick_gelu")),
        ("flash_attention", "VATVision self q1200 kv1200 8h d256", 4,
         flash_case(1200, 1200, 8, 8, 256, False)),
        ("flash_attention", "VATVision cross q1200 kv2400 8h d256", 4,
         flash_case(1200, 2400, 8, 8, 256, False)),
        ("flash_attention", "VATLiDAR cross q768 kv32400 8h d112", 4,
         flash_case(768, 32400, 8, 8, 112, False)),
        ("flash_attention", "Qwen prefill causal 1996 14/2h d64", 24,
         flash_case(1996, 1996, 14, 2, 64, True)),
        ("relpos_attention[14x14]", "windows [216,196,2304] 12h d64", 8,
         relpos_case(216, 14, 12, 64)),
        ("flash_attention_relpos[80x80]",
         "global [6,12,6400,64] tiles 4096/1024", 4, kh_case(6, 80, 12, 64)),
        ("ln_mlp_residual_q8", "SAM [38400,768]x[768,3072] gelu", 12,
         q8_case(38400, 768, 3072, "gelu")),
        ("ln_mlp_residual_q8", "CLIP [2406,1024]x[1024,4096] quick_gelu", 24,
         q8_case(2406, 1024, 4096, "quick_gelu")),
        ("int8_matmul", "decode qkv [1,896]x[896,1152]", layer_steps,
         int8_case(1, 896, 1152)),
        ("int8_matmul", "decode o [1,896]x[896,896]", layer_steps,
         int8_case(1, 896, 896)),
        ("int8_matmul", "decode gate|up [1,896]x[896,9728]", layer_steps,
         int8_case(1, 896, 9728)),
        ("int8_matmul", "decode down [1,4864]x[4864,896]", layer_steps,
         int8_case(1, 4864, 896)),
        ("int8_matmul_nk", "decode unembed [1,896]x[151940,896]^T",
         NEW_TOKENS, int8_case(1, 896, 151940, nk=True)),
        ("w8a8_matmul", "windowed qkv [42336,768]x[768,2304]", 8,
         w8a8_case(42336, 768, 2304)),
        ("w8a8_matmul", "windowed proj [42336,768]x[768,768]", 8,
         w8a8_case(42336, 768, 768)),
        ("w8a8_matmul", "global qkv [38400,768]x[768,2304]", 4,
         w8a8_case(38400, 768, 2304)),
        ("w8a8_matmul", "global proj [38400,768]x[768,768]", 4,
         w8a8_case(38400, 768, 768)),
        ("flash_attention_relpos_pv8[80x80]",
         "global [6,12,6400,64] tiles 4096/1024, int8 groups of 1024", 4,
         kh_case(6, 80, 12, 64, quant8=True)),
    ]
    win_label = "windows [150,196,2304] 12h d64 (benchmarks/winattn_{}.py)"
    unused = [      # forms that no path runs (launches 0 on every one)
        ("flash_attention_relpos_fused[64x64]",
         "[6,12,4096,64] tiles 4096/1024 (benchmarks/gattn_fused_micro.py)",
         0, kh_case(6, 64, 12, 64)),
        ("flash_attention_relpos_fused_pv8[64x64]",
         "[6,12,4096,64] tiles 4096/1024, int8 groups of 1024 "
         "(benchmarks/gattn_fused_micro.py)", 0,
         kh_case(6, 64, 12, 64, quant8=True)),
        ("flash_attention_relpos_mh[14x14]",
         "[150,12,196,64] tiles 256 (benchmarks/sam_block_bisect.py)", 0,
         kh_case(150, 14, 12, 64, bq=256, bk=256)),
        ("flash_attention_relpos[112x112]", "global [1,12,12544,64] tiles "
         "1024/1024 (SAM at 1792², sam.img_size 1792)", 0,
         kh_case(1, 112, 12, 64, bq=1024, bk=1024)),
        ("window_attention_rows[fused]", win_label.format("fused_micro"), 0,
         window_case("fused")),
        ("window_attention_rows[fused2]", win_label.format("fused_micro"), 0,
         window_case("fused2")),
        ("window_attention_rows[v3]", win_label.format("v3_micro"), 0,
         window_case("v3")),
        ("window_attention_rows[v4]",
         win_label.format("v4_micro") + ", with its prep", 0,
         window_case("v4")),
        ("qr_prep[rows]", "[150,196,2304] -> q·Rh, q·Rw rows 2x[150,196,192]"
         " (window_attention_v4's prep)", 0, window_prep_case()),
        ("window_attention_rows[phased]", win_label.format("v2_micro"), 0,
         window_case("phased")),
        ("qr_prep[qk]", "[6,4096,2304] -> q_aug, k_aug [6,4096,1536] "
         "(benchmarks/gattn_prep_micro.py)", 0, hpacked_prep_case("qk")),
        ("qr_prep[v]", "[6,4096,2304] -> v_aug [6,4096,1536] "
         "(benchmarks/gattn_prep_micro.py)", 0, hpacked_prep_case("v")),
        ("flash_attention_relpos_hpacked_prepped[64x64]",
         "global [6,4096,2304] 12h d64 tiles 4096/1024, with its prep "
         "(benchmarks/gattn_prep_micro.py)", 0, prepped_case()),
    ] + [(f"window_attention_rows[{v}]",
          "windows [150,196,2304] 12h d64 (benchmarks/winattn_bisect2.py)",
          0, bisect_case(v)) for v in A.BISECT_VARIANTS] + [
        ("window_attention_rows[hmaj]", "head-major q, k, v [150,12,196,64] "
         "(benchmarks/winattn_bisect3.py)", 0, hmaj_case())]
    # serving-batch[n]: bench.py's serving model (SAM 1024², LVV_Q8_SCOPE
    # "mlp", the packed int8 decode) at batch n, the prompt of one row cut
    # short: each wrapper launches as often a generate as at batch 1, over n
    # times the rows, and the prefill's kv_len differs by row
    n, pre = SERVING_BATCH, 1564
    short = (RAGGED_ROW, pre - PROMPT_LEN + RAGGED_LEN)
    batch = [
        ("norm", f"LN SAM [{n * 24576},768]", 12,
         norm_case(n * 24576, 768, False)),
        ("norm", f"LN SAM neck [{n * 24576},256]", 2,
         norm_case(n * 24576, 256, False)),
        ("norm", f"LN CLIP [{n * 1542},1024]", 25,
         norm_case(n * 1542, 1024, False)),
        ("norm", f"LN adapter [{n * 1536},2048]", 1,
         norm_case(n * 1536, 2048, False)),
        ("norm", f"LN VATVision [{n * 768},2048]", 15,
         norm_case(n * 768, 2048, False)),
        ("norm", f"LN VAT out [{n * 768},896]", 15,
         norm_case(n * 768, 896, False)),
        ("norm", f"LN VATLiDAR in [{n * 32400},896]", 1,
         norm_case(n * 32400, 896, False)),
        ("norm", f"RMS prefill [{n * pre},896]", 1,
         norm_case(n * pre, 896, True)),
        ("norm", f"RMS decode [{n},896]", NEW_TOKENS, norm_case(n, 896, True)),
        ("norm[add]", f"add + RMS prefill [{n * pre},896]", adds,
         add_norm_case(n * pre, 896)),
        ("norm[add]", f"add + RMS decode [{n},896]", adds * NEW_TOKENS,
         add_norm_case(n, 896)),
        ("ln_mlp_residual_q8", f"SAM [{n * 24576},768]x[768,3072] gelu", 12,
         q8_case(n * 24576, 768, 3072, "gelu")),
        ("ln_mlp_residual_q8",
         f"CLIP [{n * 1542},1024]x[1024,4096] quick_gelu", 24,
         q8_case(n * 1542, 1024, 4096, "quick_gelu")),
        ("flash_attention", f"VATVision cross {n}x q768 kv1536 8h d256", 4,
         flash_case(768, 1536, 8, 8, 256, False, b=n)),
        ("flash_attention", f"VATLiDAR cross {n}x q768 kv32400 8h d112", 4,
         flash_case(768, 32400, 8, 8, 112, False, b=n)),
        ("flash_attention", f"Qwen prefill causal {n}x {pre} 14/2h d64, "
         f"row {short[0]} kv_len {short[1]}", 24,
         flash_case(pre, pre, 14, 2, 64, True, b=n, short=short)),
        ("relpos_attention[14x14]", f"windows [{n * 150},196,2304] 12h d64",
         8, relpos_case(n * 150, 14, 12, 64)),
        ("relpos_attention[64x64]", f"global [{n * 6},4096,2304] 12h d64", 4,
         relpos_case(n * 6, 64, 12, 64)),
        ("int8_matmul", f"decode qkv [{n},896]x[896,1152]", layer_steps,
         int8_case(n, 896, 1152)),
        ("int8_matmul", f"decode o [{n},896]x[896,896]", layer_steps,
         int8_case(n, 896, 896)),
        ("int8_matmul", f"decode gate|up [{n},896]x[896,9728]", layer_steps,
         int8_case(n, 896, 9728)),
        ("int8_matmul", f"decode down [{n},4864]x[4864,896]", layer_steps,
         int8_case(n, 4864, 896)),
        ("int8_matmul_nk", f"decode unembed [{n},896]x[151940,896]^T",
         NEW_TOKENS, int8_case(n, 896, 151940, nk=True)),
    ]
    # the serving runtime's phases on SERVING_PRESET (SAM 1024², LVV_Q8_SCOPE
    # "mlp", the packed int8 decode) in buckets of PRESET_BATCHES frames:
    # VATVision's 384 queries over 1,536 image tokens, VATLiDAR's 384 over
    # 32,400 BEV cells, and a prefill of the 772-token prefix and the
    # engines' ENGINE_PROMPT-token prompts, under the flash kernel's 1,024
    # keys; a shape that another path shares keeps its label there and is
    # measured once. Each bucket's counts must add up to expected_launches
    # of the preset.
    from lvv_tpu_torch.models.vqa import _prefix_len
    preset = preset_config().model
    pre_p = _prefix_len(preset) + ENGINE_PROMPT

    def preset_cases(n):
        return [
            ("norm", f"LN SAM [{n * 24576},768]", 12,
             norm_case(n * 24576, 768, False)),
            ("norm", f"LN SAM neck [{n * 24576},256]", 2,
             norm_case(n * 24576, 256, False)),
            ("norm", f"LN CLIP [{n * 1542},1024]", 25,
             norm_case(n * 1542, 1024, False)),
            ("norm", f"LN adapter [{n * 1536},2048]", 1,
             norm_case(n * 1536, 2048, False)),
            ("norm", f"LN VATVision [{n * 384},2048]", 15,
             norm_case(n * 384, 2048, False)),
            ("norm", f"LN VAT out [{n * 384},896]", 15,
             norm_case(n * 384, 896, False)),
            ("norm", f"LN VATLiDAR in [{n * 32400},896]", 1,
             norm_case(n * 32400, 896, False)),
            ("norm", f"RMS prefill [{n * pre_p},896]", 1,
             norm_case(n * pre_p, 896, True)),
            ("norm", f"RMS decode [{n},896]", NEW_TOKENS,
             norm_case(n, 896, True)),
            ("norm[add]", f"add + RMS prefill [{n * pre_p},896]", adds,
             add_norm_case(n * pre_p, 896)),
            ("norm[add]", f"add + RMS decode [{n},896]", adds * NEW_TOKENS,
             add_norm_case(n, 896)),
            ("ln_mlp_residual_q8", f"SAM [{n * 24576},768]x[768,3072] gelu",
             12, q8_case(n * 24576, 768, 3072, "gelu")),
            ("ln_mlp_residual_q8",
             f"CLIP [{n * 1542},1024]x[1024,4096] quick_gelu", 24,
             q8_case(n * 1542, 1024, 4096, "quick_gelu")),
            ("flash_attention", f"VATVision cross {n}x q384 kv1536 8h d256",
             4, flash_case(384, 1536, 8, 8, 256, False, b=n)),
            ("flash_attention", f"VATLiDAR cross {n}x q384 kv32400 8h d112",
             4, flash_case(384, 32400, 8, 8, 112, False, b=n)),
            ("relpos_attention[14x14]",
             f"windows [{n * 150},196,2304] 12h d64", 8,
             relpos_case(n * 150, 14, 12, 64)),
            ("relpos_attention[64x64]",
             f"global [{n * 6},4096,2304] 12h d64", 4,
             relpos_case(n * 6, 64, 12, 64)),
            ("int8_matmul", f"decode qkv [{n},896]x[896,1152]", layer_steps,
             int8_case(n, 896, 1152)),
            ("int8_matmul", f"decode o [{n},896]x[896,896]", layer_steps,
             int8_case(n, 896, 896)),
            ("int8_matmul", f"decode gate|up [{n},896]x[896,9728]",
             layer_steps, int8_case(n, 896, 9728)),
            ("int8_matmul", f"decode down [{n},4864]x[4864,896]",
             layer_steps, int8_case(n, 4864, 896)),
            ("int8_matmul_nk", f"decode unembed [{n},896]x[151940,896]^T",
             NEW_TOKENS, int8_case(n, 896, 151940, nk=True)),
        ]
    by_preset = {n: preset_cases(n) for n in PRESET_BATCHES}
    want = expected_launches(preset, serving=True, prompt_len=ENGINE_PROMPT)
    for n, cases in by_preset.items():
        got = collections.Counter()
        for row, _, count, _ in cases:
            for name in {row, PART_OF.get(row, row)}:
                got[name] += count
        if dict(got) != want:
            raise AssertionError(f"the preset's cases at batch {n} launch "
                                 f"{dict(got)}, its path {want}")
    # a train step at batch TRAIN_BATCH (default_config(), TrainConfig's 128
    # prompt and 96 answer tokens: a 1,765-token sequence, one row cut
    # short): the LLM forward's causal attention and its add + RMS norms, and
    # CLIP's MLP over 6 views a row (its other shapes are the 1024² path's
    # at 4x the rows); launches per step
    t_seq = _prefix_len(config(1024, False)) + TRAIN_TEXT
    train = [
        ("flash_attention",
         f"train causal {TRAIN_BATCH}x{t_seq} 14/2h d64 ragged", 24,
         flash_case(t_seq, t_seq, 14, 2, 64, True, b=TRAIN_BATCH,
                    short=(TRAIN_BATCH - 1, t_seq - 65))),
        ("norm[add]", f"train add + RMS [{TRAIN_BATCH * t_seq},896]", adds,
         add_norm_case(TRAIN_BATCH * t_seq, 896)),
        ("ln_mlp_residual",
         f"train CLIP [{TRAIN_BATCH * 6 * 257},1024]x[1024,4096] quick_gelu",
         24, mlp_case(TRAIN_BATCH * 6 * 257, 1024, 4096, "quick_gelu")),
    ]
    # TransFusion's detect at its preset (fp32, detector-zoo): its two
    # cross-attentions, 200 queries over the 180 x 180 BEV tokens (K-e's
    # fp32 form), and its six LayerNorms at width 128 (K-a on fp32 x);
    # BEVFusion's (detector-camera) runs the same head on its fused BEV and
    # Swin-T's LayerNorms of width 384, 768 and 1536 (CAMERA_CASES)
    head = [
        ("flash_attention[fp32]", "query head cross q200 kv32400 4h d32 "
         "fp32", 2, flash_f32_case(200, 32400, 4, 32)),
        ("norm", "LN query head [200,128] fp32", 6,
         norm_f32_case(200, 128)),
    ]
    camera = head + [("norm", f"LN Swin {where} [{n},{c}] fp32 eps 1e-5",
                      count, norm_f32_case(n, c, 1e-5))
                     for where, n, c, count in SWIN_NORMS]
    # the 1024² list: every shape of its four batch-1 paths
    return [c + (1024,) for c in [
        ("norm", "LN SAM [24576,768]", 12, norm_case(24576, 768, False)),
        ("norm", "LN SAM neck [24576,256]", 2, norm_case(24576, 256, False)),
        ("norm", "LN CLIP [1542,1024]", 25, norm_case(1542, 1024, False)),
        ("norm", "LN adapter [1536,2048]", 1, norm_case(1536, 2048, False)),
        ("norm", "LN VATVision [768,2048]", 15, norm_case(768, 2048, False)),
        ("norm", "LN VAT out [768,896]", 15, norm_case(768, 896, False)),
        ("norm", "LN VATLiDAR in [32400,896]", 1,
         norm_case(32400, 896, False)),
        ("norm", "RMS prefill [1564,896]", 1, norm_case(1564, 896, True)),
        ("norm", "RMS decode [1,896]", NEW_TOKENS, norm_case(1, 896, True)),
        ("norm[add]", "add + RMS prefill [1564,896]", adds,
         add_norm_case(1564, 896)),
        ("norm[add]", "add + RMS decode [1,896]", adds * NEW_TOKENS,
         add_norm_case(1, 896)),
        ("ln_mlp_residual", "SAM [24576,768]x[768,3072] gelu", 12,
         mlp_case(24576, 768, 3072, "gelu")),
        ("ln_mlp_residual", "CLIP [1542,1024]x[1024,4096] quick_gelu", 24,
         mlp_case(1542, 1024, 4096, "quick_gelu")),
        ("flash_attention", "VATVision cross q768 kv1536 8h d256", 4,
         flash_case(768, 1536, 8, 8, 256, False)),
        ("flash_attention", "VATLiDAR cross q768 kv32400 8h d112", 4,
         flash_case(768, 32400, 8, 8, 112, False)),
        ("flash_attention", "Qwen prefill causal 1564 14/2h d64", 24,
         flash_case(1564, 1564, 14, 2, 64, True)),
        ("relpos_attention[14x14]", "windows [150,196,2304] 12h d64", 8,
         relpos_case(150, 14, 12, 64)),
        ("relpos_attention[64x64]", "global [6,4096,2304] 12h d64", 4,
         relpos_case(6, 64, 12, 64)),
        ("ln_mlp_residual_q8", "SAM [24576,768]x[768,3072] gelu", 12,
         q8_case(24576, 768, 3072, "gelu")),
        ("ln_mlp_residual_q8", "CLIP [1542,1024]x[1024,4096] quick_gelu", 24,
         q8_case(1542, 1024, 4096, "quick_gelu")),
        ("int8_matmul", "decode qkv [1,896]x[896,1152]", layer_steps,
         int8_case(1, 896, 1152)),
        ("int8_matmul", "decode o [1,896]x[896,896]", layer_steps,
         int8_case(1, 896, 896)),
        ("int8_matmul", "decode gate|up [1,896]x[896,9728]", layer_steps,
         int8_case(1, 896, 9728)),
        ("int8_matmul", "decode down [1,4864]x[4864,896]", layer_steps,
         int8_case(1, 4864, 896)),
        ("int8_matmul_nk", "decode unembed [1,896]x[151940,896]^T",
         NEW_TOKENS, int8_case(1, 896, 151940, nk=True)),
        ("w8a8_matmul", "windowed qkv [29400,768]x[768,2304]", 8,
         w8a8_case(29400, 768, 2304)),
        ("w8a8_matmul", "windowed proj [29400,768]x[768,768]", 8,
         w8a8_case(29400, 768, 768)),
        ("w8a8_matmul", "global qkv [24576,768]x[768,2304]", 4,
         w8a8_case(24576, 768, 2304)),
        ("w8a8_matmul", "global proj [24576,768]x[768,768]", 4,
         w8a8_case(24576, 768, 768)),
        ("relpos_attention_pv8[64x64]", "global [6,4096,2304] 12h d64 "
         "groups of 1024", 4, relpos_q8_case(6, 64, 12, 64, qk8=False)),
        ("relpos_attention_qk8[64x64]", "global [6,4096,2304] 12h d64", 4,
         relpos_q8_case(6, 64, 12, 64, qk8=True)),
    ]] + [c + ((1024, n),) for c in batch] + [
        c + (LARGE,) for c in large] + [
        c + (("preset", b),) for b, cases in by_preset.items()
        for c in cases] + [c + (("train", TRAIN_BATCH),) for c in train] + [
        c + (("zoo", "TransFusion"),) for c in head] + [
        c + (("camera", "BEVFusion"),) for c in camera] + [
        c + (None,) for c in unused]


ROWS = {
    "norm": ("cuda", "lvv_tpu_torch/kernels/csrc/norm.cu",
             "lvv_tpu/ops/fused_mlp.py:203"),
    # the add form fuses the residual add before _rms_only_kernel's norm
    "norm[add]": ("cuda", "lvv_tpu_torch/kernels/csrc/norm.cu",
                  "lvv_tpu/ops/fused_mlp.py:209"),
    "ln_mlp_residual": ("cuda", "lvv_tpu_torch/kernels/csrc/ln_mlp_residual.cu",
                        "lvv_tpu/ops/fused_mlp.py:56"),
    "flash_attention": ("cuda", "lvv_tpu_torch/kernels/csrc/flash_attention.cu",
                        "lvv_tpu/ops/attention.py:82"),
    # K-e's fp32 form, as _flash_padded (:188) runs _flash_kernel on fp32
    "flash_attention[fp32]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_f32.cu",
        "lvv_tpu/ops/attention.py:82"),
    "relpos_attention[14x14]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/relpos_attention.cu",
        "lvv_tpu/ops/attention.py:1018"),
    "relpos_attention[64x64]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/relpos_attention.cu",
        "lvv_tpu/ops/attention.py:682"),
    "ln_mlp_residual_q8": (
        "cuda", "lvv_tpu_torch/kernels/csrc/ln_mlp_residual_q8.cu",
        "lvv_tpu/ops/fused_mlp.py:124"),
    "int8_matmul": ("cuda", "lvv_tpu_torch/kernels/csrc/int8_matmul.cu",
                    "lvv_tpu/ops/quant.py:283"),
    "int8_matmul_nk": ("cuda", "lvv_tpu_torch/kernels/csrc/int8_matmul_nk.cu",
                       "lvv_tpu/ops/quant.py:78"),
    "w8a8_matmul": ("cuda", "lvv_tpu_torch/kernels/csrc/w8a8_matmul.cu",
                    "lvv_tpu/ops/quant.py:184"),
    "relpos_attention_pv8[64x64]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/relpos_attention.cu",
        "lvv_tpu/ops/attention.py:717"),
    "relpos_attention_qk8[64x64]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/relpos_attention_qk8.cu",
        "lvv_tpu/ops/attention.py:738"),
    "flash_attention_relpos[80x80]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:269"),
    "flash_attention_relpos_pv8[80x80]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:336"),
    "flash_attention_relpos_fused[64x64]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:553"),
    "flash_attention_relpos_fused_pv8[64x64]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:592"),
    "flash_attention_relpos_mh[14x14]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:363"),
    "flash_attention_relpos[112x112]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:269"),
    "window_attention_rows[fused]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        "lvv_tpu/ops/attention.py:1138"),
    "window_attention_rows[fused2]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        "lvv_tpu/ops/attention.py:1247"),
    "window_attention_rows[v3]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        "lvv_tpu/ops/attention.py:1793"),
    "window_attention_rows[v4]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        "lvv_tpu/ops/attention.py:1561"),
    "window_attention_rows[phased]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        "lvv_tpu/ops/attention.py:1654"),
    "qr_prep[rows]": ("cuda", "lvv_tpu_torch/kernels/csrc/qr_prep.cu",
                      "lvv_tpu/ops/attention.py:1493"),
    "qr_prep[qk]": ("cuda", "lvv_tpu_torch/kernels/csrc/qr_prep.cu",
                    "lvv_tpu/ops/attention.py:1352"),
    "qr_prep[v]": ("cuda", "lvv_tpu_torch/kernels/csrc/qr_prep.cu",
                   "lvv_tpu/ops/attention.py:1382"),
    "flash_attention_relpos_hpacked_prepped[64x64]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/flash_attention_relpos.cu",
        "lvv_tpu/ops/attention.py:682"),
    **{f"window_attention_rows[{v}]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        f"benchmarks/winattn_bisect2.py:{line}")
       for v, line in (("dots_qk", 72), ("dots_qk_pv", 80), ("softmax", 76),
                       ("bias2", 65))},
    "window_attention_rows[hmaj]": (
        "cuda", "lvv_tpu_torch/kernels/csrc/window_attention_rows.cu",
        "benchmarks/winattn_bisect3.py:116"),
}


# rows whose launches are also launches of another row, and whose times
# count in that row too: the add form is a launch of K-a
PART_OF = {"norm[add]": "norm"}


def agreement(got, want, rel_l2_tol: float = REL_L2_TOL,
              abs_extra: float = 0.0):
    """(ok, max abs error, relative L2) of a kernel's output against its
    plain version: finite, elementwise within BF16_TOL of (|plain| +
    rms(plain)) plus abs_extra, and within rel_l2_tol relative L2
    overall."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > (BF16_TOL * (want.abs() + want.square().mean().sqrt())
                 + abs_extra)
    rel_l2 = float((got - want).norm() / want.norm())
    ok = (bool(torch.isfinite(got).all()) and not bool(bad.any())
          and rel_l2 <= rel_l2_tol)
    return ok, float(err.max()), rel_l2


def check_kernels(torch) -> dict:
    """Each case: kernel vs plain (raise past the tolerance), then timings;
    a shape that two resolutions share is measured once. Returns, per row
    and resolution (or (resolution, batch)), totals over one
    greedy_generate's launches (per call for resolution None)."""
    totals = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                  library_ms=0.0, has_library=True, bytes_ms=0.0, ops_ms=0.0)
    rows = {name: {} for name in ROWS}
    measured = {}
    for row, label, count, setup, res in kernel_cases(torch):
        if (row, label) not in measured:
            measured[row, label] = check_case(torch, row, label, count, setup)
        line, ok, has_library = measured[row, label]
        weight = count if res else 1
        for name in (row, PART_OF.get(row)):
            if name is None:
                continue
            r = rows[name].setdefault(res, dict(totals))
            r["max_abs_err"] = max(r["max_abs_err"], line["max_abs_err"])
            for key in ("bytes_ms", "ops_ms", "bound_ms", "ms", "plain_ms"):
                r[key] += weight * line[key]
            if has_library:
                r["library_ms"] += weight * line["library_ms"]
            else:
                r["has_library"] = False
    return rows


def check_case(torch, row, label, count, setup) -> tuple:
    """One case: agreement with the plain version (and each trap's failure),
    then kernel / plain / library times; prints its kernel-check line.
    Returns (line, ok, has_library)."""
    from lvv_tpu_torch import kernels
    case = setup()
    names = (row, *case.get("also", ()))
    before = [kernels.launches[n] for n in names]
    got = case["kernel"]()
    torch.cuda.synchronize()
    for n, b in zip(names, before):
        if kernels.launches[n] == b:
            raise AssertionError(f"{row} {label}: the wrapper did not "
                                 f"launch {n}")
    want = case["plain"]()
    rel_tol = case.get("rel_l2_tol", REL_L2_TOL)
    extra = case.get("abs_extra", 0.0)
    ok, max_err, rel_l2 = agreement(got, want, rel_tol, extra)
    bytes_ms = case["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = (case["ops_ms"] if "ops_ms" in case
              else case["flops"] / case["peak"] * 1e3)
    line = dict(kernel=row, shape=label, launches_per_call=count,
                max_abs_err=max_err, rel_l2=rel_l2,
                tol="4 bf16 ulps of (|plain| + rms(plain))"
                    + (f" + {extra:.4g}" if extra else "")
                    + f"; rel L2 1/{round(1 / rel_tol)}",
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms), **case.get("notes", {}))
    if "check" in case:                # exact parts of the function
        line.update(case["check"](got))
    # references held by the relative L2 alone
    for name, ref in case.get("rel_l2_refs", {}).items():
        _, _, ref_l2 = agreement(got, ref(), rel_tol, extra)
        line[f"{name}_rel_l2"] = ref_l2
        ok = ok and ref_l2 <= rel_tol
    # the tolerance has to see a wrong function: each trap must fail it
    for name, trap in case.get("traps", {}).items():
        trap_ok, _, trap_l2 = agreement(got, trap(), rel_tol, extra)
        line[f"{name}_rel_l2"] = trap_l2
        if trap_ok:
            raise AssertionError(f"{row} {label}: the tolerance passes "
                                 f"the trap {name}")
    del got, want
    line["ms"] = timed_ms(case.get("timed_kernel", case["kernel"]), 20)
    line["plain_ms"] = timed_ms(case.get("timed_plain", case["plain"]), 3)
    line["library_ms"] = (timed_ms(case["library"], 10)
                          if case["library"] else None)
    for key, fn in case.get("info", {}).items():   # yardsticks and parts
        line[key] = timed_ms(fn, 10)
    if "kernel_only" in case:          # the launch without the wrapper's glue
        line["kernel_only_ms"] = timed_ms(case["kernel_only"], 20)
    print("kernel-check", json.dumps(line), flush=True)
    if not ok:
        raise AssertionError(f"{row} {label}: kernel disagrees with its "
                             f"plain version (max abs err {max_err})")
    has_library = case["library"] is not None
    del case
    torch.cuda.empty_cache()
    return line, ok, has_library


# ------------------------------------------------------------- main path --

def bench_inputs(cfg):
    """bench.py's inputs: numpy seed 0, BEV normal, views in [-1, 1],
    prompt ids < 1000."""
    import numpy as np
    b, t = 1, PROMPT_LEN
    c, (h, w) = cfg.bev_channels, cfg.bev_hw
    s = cfg.sam.img_size
    rng = np.random.default_rng(0)
    bev = rng.normal(size=(b, c, h, w)).astype(np.float32)
    images = rng.uniform(-1, 1, (b, 6, 3, s, s)).astype(np.float32)
    prompt = rng.integers(0, 1000, (b, t)).astype(np.int64)
    return bev, images, np.ones((b, 6), bool), prompt, np.full((b,), t)


def global_kind(cfg, names) -> str:
    """The kernel (launch-count name) of SAM's global layers: the model's
    three-way test on the grid (models/sam.py SAMAttention), with the scope
    names `names`."""
    from lvv_tpu_torch.models import sam
    from lvv_tpu_torch.ops.attention import kh_tiles
    s = cfg.sam
    g, hd = s.img_size // s.patch_size, s.embed_dim // s.num_heads
    if g * g <= 512:                                  # a window's branch
        kind = "relpos_attention"
    elif sam._hpacked_ok(g, g, hd):
        kind = ("relpos_attention_qk8" if "qk" in names else
                "relpos_attention_pv8" if "attn" in names else
                "relpos_attention")
    elif kh_tiles(g * g, 4096, 1024)[0] <= 512:
        kind = "flash_attention_relpos_mh"
    else:
        kind = ("flash_attention_relpos_pv8" if "attn" in names else
                "flash_attention_relpos")
    return f"{kind}[{g}x{g}]"


def expected_launches(cfg, serving: bool = False, scope: str = "mlp",
                      prompt_len: int = PROMPT_LEN,
                      packed: bool = None, new_tokens: int = None) -> dict:
    """Kernel launches of one greedy_generate at batch 1, from the model's
    structure (every norm width there is a multiple of 128), for prompts
    `prompt_len` wide and `new_tokens` decode steps (NEW_TOKENS; 0: the
    forward of a train step over a text block `prompt_len` wide, whose
    backward launches no kernel). The serving path runs the W8A8 MLP in place of the
    bf16 one and (unless `packed` is False) the packed int8 decode: 4 int8
    products a layer and one int8 unembed a step. Its other SAM scopes add
    the W8A8 qkv / proj projections ("dense", 2 a block) and change the
    global layers' kernel (`global_kind`): at 64x64, K-g ("qk", which wins)
    or K-d8 ("attn"); at 80x80, K-h's int8 arm ("attn")."""
    from lvv_tpu_torch.models.vqa import _prefix_len, sam_grid_side
    s, c, vv, vl, llm = (cfg.sam, cfg.clip, cfg.vat_vision, cfg.vat_lidar,
                         cfg.llm)
    packed = serving if packed is None else packed
    steps = NEW_TOKENS if new_tokens is None else new_tokens
    n_global = len(s.global_attn_indexes)
    encode = (s.depth + 2                       # ln1 per block + neck LNs
              + 1 + c.num_layers                # pre_ln + ln1 per layer
              + 1                               # adapter
              + 3 * vv.n_blocks + 4             # VATVision
              + 1 + 3 * vl.n_blocks + 2)        # VATLiDAR
    per_llm_pass = 2 * llm.num_layers + 1
    names = set(scope.split(","))
    # `attention` takes the flash kernel once kv reaches 1024 tokens: the
    # VAT blocks' self-attention over their queries (VATVision's 1,200 at
    # 1280², not its 768 at 1024²) and cross-attention over the image
    # tokens / BEV cells, and the prefill (not the serving preset's: 772
    # prefix tokens and a 129-token prompt)
    n_tok = cfg.adapter.num_views * sam_grid_side(cfg) ** 2
    kv_lens = ((vv.n_blocks, n_tok // vv.compression_factor),
               (vv.n_blocks, n_tok),
               (vl.n_blocks, vl.n_queries),
               (vl.n_blocks, cfg.bev_hw[0] * cfg.bev_hw[1]),
               (llm.num_layers, _prefix_len(cfg) + prompt_len))
    want = collections.Counter({
        "norm": encode + per_llm_pass * (1 + steps),
        # every Qwen norm but the first layer's input norm follows an add
        "norm[add]": (per_llm_pass - 1) * (1 + steps),
        "flash_attention": sum(n for n, kv in kv_lens if kv >= 1024),
        f"relpos_attention[{s.window_size}x{s.window_size}]":
            s.depth - n_global})
    want[global_kind(cfg, names)] += n_global
    if not serving:
        want["ln_mlp_residual"] = s.depth + c.num_layers
    else:
        want["ln_mlp_residual_q8"] = s.depth + c.num_layers
        if "dense" in names:
            want["w8a8_matmul"] = 2 * s.depth
    if packed and steps:
        want["int8_matmul"] = 4 * llm.num_layers * steps
        want["int8_matmul_nk"] = steps
    return dict(want)


def decode_step_launches(cfg) -> dict:
    """Kernel launches of one packed int8 decode step (every row of a
    batch or a slab at once)."""
    per_llm_pass = 2 * cfg.llm.num_layers + 1
    return {"norm": per_llm_pass, "norm[add]": per_llm_pass - 1,
            "int8_matmul": 4 * cfg.llm.num_layers, "int8_matmul_nk": 1}


@contextlib.contextmanager
def plain_path():
    """Route the model through the plain PyTorch versions on the card (the
    JAX package's off-TPU path: unfused erf-GELU MLPs, materialised rel-pos
    bias, reference attention)."""
    from lvv_tpu_torch.models import layers, qwen, sam
    from lvv_tpu_torch.ops import attention as A
    from lvv_tpu_torch.ops import fused_mlp as M
    saved = (M.kernel_ok, sam._relpos_kernel_ok, layers.norm_fast,
             layers.attention, sam.attention, qwen.attention)
    M.kernel_ok = sam._relpos_kernel_ok = lambda *a: False
    layers.norm_fast = M.norm_plain
    layers.attention = sam.attention = qwen.attention = A.attention_reference
    try:
        yield
    finally:
        (M.kernel_ok, sam._relpos_kernel_ok, layers.norm_fast,
         layers.attention, sam.attention, qwen.attention) = saved


@contextlib.contextmanager
def plain_kernels():
    """Keep every dispatch of the model and swap each kernel wrapper for its
    plain version (on the card: quant8 stays on, the plain W8A8 MLP runs
    where the kernel would)."""
    import torch
    from lvv_tpu_torch.models import sam
    from lvv_tpu_torch.ops import attention as A
    from lvv_tpu_torch.ops import fused_mlp as M
    from lvv_tpu_torch.ops import quant as Q

    def mlp_plain(*args, quant8=False, **kw):
        return (M.ln_mlp_residual_q8_plain if quant8
                else M.ln_mlp_residual_plain)(*args, **kw)

    def by_views(fn):
        """fn over 6 global views at a time: the plain versions materialise
        the [S, S] bias, 4.8 GB in fp32 for 6 views of 64x64, so a batch of
        frames would not fit at once; each view is independent (windows,
        S <= 512, go in one call)."""
        return lambda qkv, *a, **kw: torch.cat(
            [fn(part, *a, **kw) for part in (
                qkv.split(6) if qkv.shape[1] > 512 else (qkv,))])
    swaps = [(M, "norm", M.norm_plain),
             (M, "add_norm", M.add_norm_plain),
             (M, "ln_mlp_residual", mlp_plain),
             (A, "flash_attention", A.flash_attention_plain),
             (sam, "relpos_attention", by_views(A.relpos_attention_plain)),
             (sam, "relpos_attention_qk8",
              by_views(A.relpos_attention_qk8_plain)),
             (sam, "flash_attention_relpos", A.flash_attention_relpos_plain),
             (sam, "w8a8_matmul", Q.int8_dot),
             (Q, "quantized_matmul", Q.quantized_matmul_plain),
             (Q, "quantized_matmul_nk", Q.quantized_matmul_nk_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def drive(torch, model, args, params_decode, want) -> dict:
    """Warm-up, then three timed greedy_generate runs; the launch counts of
    the first (reset just before it) must equal `want`, and every run must
    give the same tokens. Adds the stage split, the device's busy time and
    idle share, and the peak memory."""
    from lvv_tpu_torch import greedy_generate, kernels

    def generate():
        toks, lens = greedy_generate(model, *args, max_new_tokens=NEW_TOKENS,
                                     eos_id=EOS_ID,
                                     params_decode=params_decode)
        torch.cuda.synchronize()
        return toks, lens

    generate()                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    t0 = time.perf_counter()
    toks, lens = generate()
    times = [time.perf_counter() - t0]
    counts = {k: v for k, v in kernels.launches.items() if v}
    for _ in range(2):
        t0 = time.perf_counter()
        again, _ = generate()
        times.append(time.perf_counter() - t0)
        if not torch.equal(again, toks):
            raise AssertionError("greedy tokens differ between runs")
    peak = torch.cuda.max_memory_allocated()
    if counts != want:
        raise AssertionError(f"launch counts {counts} != expected {want}")
    stage_s = dict(encode=[], prefill=[])
    for _ in range(3):                  # encode alone, then encode + prefill
        for stage, fn in (("encode", lambda: model.encode_prefix(
                *args[:3]).float().sum().item()),
                ("prefill", lambda: prefill_logits(torch, model, args))):
            t0 = time.perf_counter()
            with torch.inference_mode():
                fn()
            torch.cuda.synchronize()
            stage_s[stage].append(time.perf_counter() - t0)
    device = device_busy(torch, generate)
    times.sort()
    encode_s = sorted(stage_s["encode"])[1]
    prefill_s = sorted(stage_s["prefill"])[1]
    return dict(tokens=toks[0].tolist() if len(toks) == 1 else toks.tolist(),
                lengths=lens.tolist(),
                times_s=times, p50_s=times[1], frames_per_s=1 / times[1],
                encode_p50_s=encode_s, llm_prefill_s=prefill_s - encode_s,
                decode_s=times[1] - prefill_s, **device,
                device_idle_share=1 - device["device_busy_s"] / times[1],
                peak_mem_gib=peak / 2 ** 30, launches=counts)


def cache_tokens(cfg, prompt_len: int = PROMPT_LEN) -> int:
    """KV-cache length of one generate on prompts `prompt_len` wide, as
    greedy_generate sizes it (1,996 prefill tokens at SAM 1280², 1,564 at
    1024², 901 on the serving preset's 129-token prompts)."""
    from lvv_tpu_torch.models.vqa import _prefix_len
    return _prefix_len(cfg) + prompt_len + NEW_TOKENS + 8


def prefill_logits(torch, model, args, cache=None):
    """Last prefill logits [B, V] in fp32 (fills `cache` when given)."""
    from lvv_tpu_torch.models.qwen import init_cache
    with torch.inference_mode():
        if cache is None:
            cache = init_cache(model.cfg.llm, args[3].shape[0],
                               cache_tokens(model.cfg, args[3].shape[1]),
                               dtype=model.dtype, device="cuda")
        return model.prefill(args[0], args[1], args[2], args[3],
                             args[4].int(), cache).float()


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def first_logits(torch, model, args, packed, token=None) -> tuple:
    """Prefill logits, then the first decode step's logits (packed int8
    decode when `packed`, else the float one), fed `token` or the prefill's
    argmax. Returns (prefill, step, token)."""
    from lvv_tpu_torch.models.decode_fused import fused_decode_step
    from lvv_tpu_torch.models.qwen import init_cache
    cfg = model.cfg
    cache = init_cache(cfg.llm, args[3].shape[0],
                       cache_tokens(cfg, args[3].shape[1]),
                       dtype=model.dtype, device="cuda")
    pre = prefill_logits(torch, model, args, cache)
    nxt = pre.argmax(-1) if token is None else token
    with torch.inference_mode():
        if packed:
            step = fused_decode_step(cfg.llm, model.dtype,
                                     packed["_fused_decode"], nxt, cache)
        else:
            step = model.decode_step(nxt, cache)
    return pre, step.float(), nxt


def against_plain_kernels(torch, model, args, packed) -> tuple:
    """Prefill and first-step logits of the path against the same path with
    every kernel swapped for its plain version. Returns (report, prefill
    logits)."""
    from lvv_tpu_torch import kernels
    pre, step, nxt = first_logits(torch, model, args, packed)
    before = dict(kernels.launches)
    with plain_kernels():
        pre_plain, step_plain, _ = first_logits(torch, model, args, packed,
                                                nxt)
    if dict(kernels.launches) != before:
        raise AssertionError("a kernel launched under plain_kernels()")
    for t in (pre, step, pre_plain, step_plain):
        if not torch.isfinite(t).all():
            raise AssertionError("non-finite logits")
    report = dict(
        logits_shape=list(pre.shape),
        logits_rel_l2_vs_plain=rel_l2(pre, pre_plain),
        logits_max_abs_vs_plain=float((pre - pre_plain).abs().max()),
        step_logits_rel_l2_vs_plain=rel_l2(step, step_plain),
        step_logits_max_abs_vs_plain=float((step - step_plain).abs().max()),
    )
    if pre.shape[0] > 1:          # every row on its own
        report.update(
            logits_rel_l2_vs_plain_by_row=[
                rel_l2(a, b) for a, b in zip(pre, pre_plain)],
            step_logits_rel_l2_vs_plain_by_row=[
                rel_l2(a, b) for a, b in zip(step, step_plain)])
    return report, pre


def config(img_size: int, quant8: bool):
    """default_config() with SAM at img_size; quant8 on SAM and CLIP (the
    serving model) or not."""
    import dataclasses
    from lvv_tpu_torch import default_config
    cfg = default_config().model
    return dataclasses.replace(
        cfg, sam=dataclasses.replace(cfg.sam, img_size=img_size,
                                     quant8=quant8),
        clip=dataclasses.replace(cfg.clip, quant8=quant8))


def run_float_path(torch, img_size: int = 1024) -> tuple:
    """The float main path: default_config() (SAM at img_size), float
    decode. At 1024² its prefill logits are held to the plain PyTorch path
    (materialised rel-pos bias); at 1280², where that bias would take
    5.9 GB a layer, its prefill and first-step logits are held to the same
    path with every kernel swapped for its plain version. Returns its
    report, its prefill logits and the model."""
    from lvv_tpu_torch import VQAModel
    cfg = config(img_size, quant8=False)
    model = VQAModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    args = [torch.as_tensor(a, device="cuda") for a in bench_inputs(cfg)]
    report = drive(torch, model, args, None, expected_launches(cfg))
    if img_size != 1024:
        checks, fast = against_plain_kernels(torch, model, args, None)
        report.update(img_size=img_size, **checks)
        return report, fast, model
    fast = prefill_logits(torch, model, args)
    with plain_path():
        slow = prefill_logits(torch, model, args)
    if not (torch.isfinite(fast).all() and torch.isfinite(slow).all()):
        raise AssertionError("non-finite prefill logits")
    report.update(logits_shape=list(fast.shape),
                  logits_rel_l2_vs_plain=rel_l2(fast, slow),
                  logits_max_abs_vs_plain=float((fast - slow).abs().max()))
    return report, fast, model


def serving_model(torch, img_size: int = 1024):
    """bench.py's serving model: quant8 on SAM and CLIP, the float path's
    seeded weights and inputs, and the packed int8 decode tree."""
    from lvv_tpu_torch import VQAModel, prepare_serving_params_fused
    cfg = config(img_size, quant8=True)
    model = VQAModel(cfg, dtype=torch.bfloat16, device="cuda", seed=0)
    args = [torch.as_tensor(a, device="cuda") for a in bench_inputs(cfg)]
    return cfg, model, args, prepare_serving_params_fused(model)


@contextlib.contextmanager
def q8_scope_env(scope: str):
    """LVV_Q8_SCOPE=scope while the block runs (the model reads it at each
    call)."""
    import os
    from lvv_tpu_torch.config import q8_scope
    os.environ["LVV_Q8_SCOPE"] = scope
    try:
        if q8_scope() != frozenset(scope.split(",")):
            raise AssertionError(f"LVV_Q8_SCOPE is not read as {scope!r}")
        yield
    finally:
        del os.environ["LVV_Q8_SCOPE"]


def run_serving_path(torch, served, scope: str, ref_logits,
                     ref_name: str) -> tuple:
    """The serving model under LVV_Q8_SCOPE=scope (read at each call): the
    driven run, then its prefill and first decode step's logits against the
    same scope with every kernel swapped for its plain version. Returns the
    report and the prefill logits; `ref_logits` (another path's) are
    compared as information."""
    cfg, model, args, packed = served
    with q8_scope_env(scope):
        report = drive(torch, model, args, packed,
                       expected_launches(cfg, serving=True, scope=scope))
        checks, pre = against_plain_kernels(torch, model, args, packed)
    report.update(scope=scope, img_size=cfg.sam.img_size, **checks,
                  **{f"prefill_logits_rel_l2_vs_{ref_name}":
                     rel_l2(pre, ref_logits)})
    return report, pre


# bench.py's stream: G copies of its frame per greedy_generate_multi
# dispatch (LVV_BENCH_STREAM_G); benchmarks/serving_bench.py's largest batch
# of its default sweep (1, 2, 4, 8), and the row whose prompt is cut short
# there so that the prefill's per-row kv_len and last position differ
STREAM_G, SERVING_BATCH, SERVING_SWEEP = 8, 8, (1, 2, 4, 8)
RAGGED_ROW, RAGGED_LEN = 5, 17
NUSCENES_HW = (900, 1600)          # nuScenes camera frames, uint8 RGB
PREPROCESS_TOL = 1e-5


def run_bench_stream(torch, served, serving: dict) -> dict:
    """bench.py's headline (bench.py:121-140) on the serving model under
    LVV_Q8_SCOPE "mlp": its frame stacked STREAM_G times through
    greedy_generate_multi at B = 1, one warm-up, then two timed dispatches;
    stream = their time / (2·G), value = 1 / min(stream, p50) frames/s with
    the serving path's p50. Every group's tokens must equal the serving
    path's, and the launches of one dispatch G times its counts. Groups run
    one after the other from the host: no resident-program amortisation."""
    from lvv_tpu_torch import greedy_generate_multi, kernels
    cfg, model, args, packed = served
    xs = [a[None].expand(STREAM_G, *a.shape) for a in args]

    def dispatch():
        return greedy_generate_multi(model, *xs, max_new_tokens=NEW_TOKENS,
                                     eos_id=EOS_ID, params_decode=packed)[0]
    with q8_scope_env("mlp"):
        dispatch()
        torch.cuda.synchronize()
        kernels.launches.clear()
        t0 = time.perf_counter()
        outs = [dispatch()]
        counts = {k: v for k, v in kernels.launches.items() if v}
        outs.append(dispatch())
        torch.cuda.synchronize()
        stream = (time.perf_counter() - t0) / (2 * STREAM_G)
    want = {k: STREAM_G * v for k, v in
            expected_launches(cfg, serving=True).items()}
    if counts != want:
        raise AssertionError(f"bench-stream launch counts {counts} != "
                             f"{want}")
    for toks in outs:
        if toks.shape != (STREAM_G, 1, NEW_TOKENS) or any(
                t[0].tolist() != serving["tokens"] for t in toks):
            raise AssertionError("bench-stream: a group's tokens differ from "
                                 "the serving path's on the same frame")
    p50 = serving["p50_s"]
    return dict(metric="vqa_e2e_frames_per_sec_per_chip",
                value=1 / min(stream, p50), unit="frames/s",
                p50_latency_s=p50, stream_s_per_frame=stream, G=STREAM_G,
                launches=counts)


def serving_batch_inputs(cfg, b: int, ragged=((RAGGED_ROW, RAGGED_LEN),)):
    """benchmarks/serving_bench.py's inputs for batch b (:72-77): numpy
    default_rng(0) drawn through its sweep of batches in order (bev N(0, 1),
    views U(-1, 1), 24-token prompts < 1000), so b distinct frames; then
    the prompt of each (row, length) in `ragged` is cut to that length
    (right-padded)."""
    import numpy as np
    c, (h, w) = cfg.bev_channels, cfg.bev_hw
    s = cfg.sam.img_size
    rng = np.random.default_rng(0)
    for n in SERVING_SWEEP[:SERVING_SWEEP.index(b) + 1]:
        bev = rng.normal(size=(n, c, h, w)).astype(np.float32)
        images = rng.uniform(-1, 1, (n, 6, 3, s, s)).astype(np.float32)
        prompt = rng.integers(0, 1000, (n, PROMPT_LEN)).astype(np.int64)
    plen = np.full((b,), PROMPT_LEN)
    for row, n in ragged:
        plen[row] = n
    return bev, images, np.ones((b, 6), bool), prompt, plen


def run_serving_batch(torch, served) -> dict:
    """The serving model (LVV_Q8_SCOPE "mlp") at B = SERVING_BATCH on
    serving_bench.py's inputs with one ragged prompt: the driven run (launch
    counts as at batch 1: each wrapper runs once per layer for the whole
    batch; identical tokens on repeated runs), then every row's prefill and
    first-step logits against the same batch with every kernel swapped for
    its plain version."""
    cfg, model, _, packed = served
    args = [torch.as_tensor(a, device="cuda")
            for a in serving_batch_inputs(cfg, SERVING_BATCH)]
    with q8_scope_env("mlp"):
        report = drive(torch, model, args, packed,
                       expected_launches(cfg, serving=True))
        checks, _ = against_plain_kernels(torch, model, args, packed)
    report.update(batch=SERVING_BATCH, s_per_batch=report["p50_s"],
                  frames_s=SERVING_BATCH / report["p50_s"],
                  ragged_row=dict(row=RAGGED_ROW, prompt_len=RAGGED_LEN),
                  **checks)
    return report


def run_u8_check(torch, served) -> dict:
    """greedy_generate_multi at G = 2, B = 1 on uint8 frames of nuScenes'
    size [2, 1, 6, 900, 1600, 3] (numpy default_rng(0)) with bench.py's bev
    and prompt: its preprocessing on the card is held to the same function
    on the CPU in float32 (within PREPROCESS_TOL: the same filter weights
    summed in another order, on values in [-1, 1]), and each group's tokens
    must equal greedy_generate's on those preprocessed views."""
    import numpy as np
    from lvv_tpu_torch import (greedy_generate, greedy_generate_multi,
                               preprocess_views)
    cfg, model, args, packed = served
    g = 2
    frames = np.random.default_rng(0).integers(
        0, 256, (g, 1, 6, *NUSCENES_HW, 3), dtype=np.uint8)
    rest = [a[None].expand(g, *a.shape) for a in args]
    size = cfg.sam.img_size
    errs, views = [], []
    for f in frames:
        card = preprocess_views(torch.as_tensor(f[0], device="cuda"), size)
        cpu = preprocess_views(torch.as_tensor(f[0]), size)
        errs.append(float((card.cpu() - cpu).abs().max()))
        views.append(card[None])
    if max(errs) > PREPROCESS_TOL:
        raise AssertionError(f"u8 preprocessing on the card vs the CPU: "
                             f"{max(errs)}")
    with q8_scope_env("mlp"):
        toks, lens = greedy_generate_multi(
            model, rest[0], frames, *rest[2:], max_new_tokens=NEW_TOKENS,
            eos_id=EOS_ID, params_decode=packed)
        for i in range(g):
            want, _ = greedy_generate(model, args[0], views[i], *args[2:],
                                      max_new_tokens=NEW_TOKENS,
                                      eos_id=EOS_ID, params_decode=packed)
            if not torch.equal(want, toks[i]):
                raise AssertionError(f"u8 group {i}: tokens differ from "
                                     "greedy_generate on its views")
    return dict(frames=list(frames.shape), img_size=size,
                preprocess_max_abs_err_vs_cpu=max(errs),
                preprocess_tol=PREPROCESS_TOL, tokens=toks[:, 0].tolist(),
                lengths=lens[:, 0].tolist())


# ------------------------------------------------------- serving runtime --

# The serving preset the repository ships (configs/vqa_nuscenes_serving.json,
# `_base_` vqa_nuscenes_large.json): quant8 SAM and CLIP, VATVision
# compression 4, 384 LiDAR queries, LoRA ranks 16 / 8 from the defaults; a
# 772-token prefix. The engines pack each question into a 129-token prompt
# (max_prompt 128 + 1) with the port's ByteTokenizer.
SERVING_PRESET = "configs/vqa_nuscenes_serving.json"
PRESET_DIR = REPO / "build" / "serving_preset"
ENGINE_BATCH, ENGINE_THREADS, ENGINE_FRAMES, ENGINE_PROMPT = 8, 3, 4, 129
# the buckets the phases below dispatch: serving-engine's warm-up, its
# partial and full buckets, serve-http's and infer-cli's single requests,
# the continuous engine's admissions of 1 and 8 and its 8-slot decode
PRESET_BATCHES = (1, 4, 8)
# long enough that the 12 submissions of the three threads meet in one
# full bucket and one of 4
ENGINE_WAIT_MS = 200.0
QUESTIONS = (
    "What is directly ahead of the ego vehicle?",
    "How many pedestrians are near the crosswalk?",
    "Is there a parked truck on the right?",
    "What color is the traffic light?",
    "Are there cyclists behind the car?",
    "Is the road wet?",
    "Which lane is the bus in?",
    "How far away is the nearest car?",
    "Is there construction on the left?",
    "What is the ego vehicle doing?",
    "Are any vehicles turning?",
    "Is it safe to change lanes?")


def preset_config():
    """SERVING_PRESET read by the port's `config.load`."""
    from lvv_tpu_torch import config as C
    return C.load(C.VQAConfig, REPO / SERVING_PRESET)


def preset_checkpoint(torch) -> tuple:
    """serving-checkpoint: the serving preset read by the port's `load`, a
    model with seeded weights built from it as ModelLoader builds one,
    `save_checkpoint` under build/, then `ModelLoader(...).load_all()` on
    the card; every tensor must come back bit-equal. Returns (report,
    loader, loaded model); the saved model is freed."""
    from lvv_tpu_torch import config as C
    from lvv_tpu_torch.inference import ModelLoader, save_checkpoint
    from lvv_tpu_torch.models.vqa import _prefix_len
    cfg = preset_config()
    shutil.rmtree(PRESET_DIR, ignore_errors=True)
    PRESET_DIR.mkdir(parents=True)
    C.save(cfg, PRESET_DIR / "config.json")
    model = ModelLoader(PRESET_DIR).build_model()
    want = model.state_dict()
    t0 = time.perf_counter()
    save_checkpoint(model, cfg, PRESET_DIR)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = ModelLoader(PRESET_DIR)
    loaded, _ = loader.load_all()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = loaded.state_dict()
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if got.keys() != want.keys() or differ:
        raise AssertionError(f"serving-checkpoint: tensors differ after the "
                             f"round trip: {differ[:5]}")
    m = cfg.model
    report = dict(
        config=SERVING_PRESET, dtype=m.dtype,
        lora_ranks=dict(llm=m.llm_lora.r, clip=m.clip_lora.r),
        prefix_tokens=_prefix_len(m), tensors=len(want),
        parameters=sum(v.numel() for v in want.values()),
        model_pt_bytes=(PRESET_DIR / "model.pt").stat().st_size,
        save_s=save_s, load_s=load_s, device=str(loaded.device),
        bit_equal=True)
    del model, want
    torch.cuda.empty_cache()
    return report, loader, loaded


def engine_requests(cfg, tok) -> list:
    """len(QUESTIONS) requests over ENGINE_FRAMES frames (numpy
    default_rng(1): BEV N(0, 1), six uint8 views of nuScenes' size), one
    distinct question each, packed by `tok` into 129-token prompts; host
    arrays, as a client sends them."""
    import numpy as np
    from lvv_tpu_torch.data import pack_text
    rng = np.random.default_rng(1)
    c, (h, w) = cfg.bev_channels, cfg.bev_hw
    frames = [(rng.normal(size=(c, h, w)).astype(np.float32),
               rng.integers(0, 256, (6, *NUSCENES_HW, 3), dtype=np.uint8))
              for _ in range(ENGINE_FRAMES)]
    out = []
    for i, q in enumerate(QUESTIONS):
        ids, _, n, _ = pack_text(tok, q, None, 128, 0)
        bev, u8 = frames[i % ENGINE_FRAMES]
        out.append(dict(bev=bev, images=u8, view_valid=np.ones(6, bool),
                        text_ids=ids, text_len=n))
    return out


def bucket_args(torch, model, rows, bucket) -> list:
    """`rows` padded to `bucket` with clones of row 0, as the engines pad
    them, on the card (uint8 views preprocessed there) -> greedy_generate's
    five inputs."""
    from lvv_tpu_torch.inference.server import _preprocess
    rows = list(rows) + [rows[0]] * (bucket - len(rows))

    def stack(key):
        return torch.stack([torch.as_tensor(r[key], device="cuda")
                            for r in rows])
    images = stack("images")
    if images.dtype == torch.uint8:
        images = _preprocess(images, model.cfg.sam.img_size)
    lens = torch.tensor([r["text_len"] for r in rows], dtype=torch.int32,
                        device="cuda")
    return [stack("bev").float(), images, stack("view_valid"),
            stack("text_ids"), lens]


def direct_generate(torch, model, rows, bucket, packed, max_cache=None):
    """greedy_generate on `rows` padded to `bucket` (bucket_args) -> each
    real row's tokens up to its length."""
    from lvv_tpu_torch import greedy_generate
    from lvv_tpu_torch.data import ByteTokenizer
    toks, out = greedy_generate(
        model, *bucket_args(torch, model, rows, bucket),
        max_new_tokens=NEW_TOKENS,
        eos_id=ByteTokenizer(model.cfg.llm.special_tokens).eos_id,
        params_decode=packed, max_cache=max_cache)
    toks, out = toks.cpu().tolist(), out.cpu().tolist()
    return [toks[i][:out[i]] for i in range(len(rows))]


def first_difference(a, b):
    """The first step at which two token lists differ (None if equal)."""
    if a == b:
        return None
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def scaled(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items() if v * n}


def added(*parts: dict) -> dict:
    out = collections.Counter()
    for p in parts:
        out.update(p)
    return {k: v for k, v in out.items() if v}


def engine_workload(eng, reqs) -> tuple:
    """ENGINE_THREADS client threads, started together, submit `reqs` to
    `eng` (request i from thread i mod ENGINE_THREADS) -> (tokens, futures,
    wall s, latency s a request)."""
    import threading
    n = len(reqs)
    futs, t_sub, t_done = [None] * n, [0.0] * n, [0.0] * n
    start = threading.Barrier(ENGINE_THREADS)

    def client(c):
        start.wait()
        for i in range(c, n, ENGINE_THREADS):
            r = reqs[i]
            t_sub[i] = time.perf_counter()
            futs[i] = eng.submit(r["bev"], r["images"], r["view_valid"],
                                 r["text_ids"], r["text_len"])
            futs[i].add_done_callback(
                lambda _, i=i: t_done.__setitem__(i, time.perf_counter()))
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(ENGINE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("serving-engine: a client hung")
    got = [f.result(timeout=600)[0] for f in futs]
    wall = time.perf_counter() - t0
    return got, futs, wall, sorted(d - s for s, d in zip(t_sub, t_done))


def record_buckets(eng, in_flight=None) -> list:
    """The futures of each bucket `eng` dispatches, in order, appended to
    the list returned; the number of earlier buckets not yet answered at
    each dispatch appended to `in_flight`."""
    dispatched, dispatch = [], eng._dispatch

    def recorded(batch):
        if in_flight is not None:
            in_flight.append(sum(not all(f.done() for f in b)
                                 for b in dispatched))
        dispatched.append([r.future for r in batch])
        return dispatch(batch)
    eng._dispatch = recorded
    return dispatched


def run_serving_engine(torch, model, tok, packed) -> dict:
    """serving-engine[8]: ServingEngine(max_batch=8, max_new_tokens=32) over
    the loaded preset with the packed int8 decode (the serve CLI's
    defaults), LVV_Q8_SCOPE "mlp". After a one-request warm-up, three
    threads submit the 12 requests (host arrays, uint8 views). Launches
    must equal `expected_launches` of the preset for every dispatched
    bucket; each answer must equal greedy_generate's on its padded bucket
    (the engine's dispatches are recorded), and each bucket's prefill and
    first-step logits are held to the same batch with every kernel swapped
    for its plain version. A second, profiled run of the same workload
    gives the device's busy time. A third, on an engine with
    pipeline_depth 2 (the next bucket issued before the last one's tokens
    are fetched), must dispatch a bucket while another is in flight,
    launch the same kernels per bucket and give each answer
    greedy_generate's on its padded bucket; its latencies, and whether
    its answers equal the first run's, are reported beside."""
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.inference import ServingEngine
    cfg = model.cfg
    reqs = engine_requests(cfg, tok)
    width = reqs[0]["text_ids"].shape[0]
    per_bucket = expected_launches(cfg, serving=True, prompt_len=width)
    kw = dict(max_batch=ENGINE_BATCH, max_wait_ms=ENGINE_WAIT_MS,
              max_new_tokens=NEW_TOKENS, params_decode=packed)
    wants = {}

    def check_buckets(buckets, futs, got, sizes, tag):
        """Each answer against greedy_generate on its padded bucket (one
        generate a distinct bucket) -> [(rows, size)]."""
        index = {id(f): i for i, f in enumerate(futs)}
        out = []
        for bucket in buckets:
            rows = [index[id(f)] for f in bucket]
            size = next(b for b in sizes if b >= len(rows))
            if (tuple(rows), size) not in wants:
                wants[tuple(rows), size] = direct_generate(
                    torch, model, [reqs[i] for i in rows], size, packed)
            for i, w in zip(rows, wants[tuple(rows), size]):
                if got[i] != w:
                    raise AssertionError(
                        f"serving-engine{tag}: request {i} (bucket {rows}) "
                        f"differs from greedy_generate on its padded bucket "
                        f"at step {first_difference(got[i], w)}")
            out.append((rows, size))
        return out

    with q8_scope_env("mlp"):
        with ServingEngine(model, tok, **kw) as eng:
            dispatched = record_buckets(eng)
            r = reqs[0]
            eng.submit(r["bev"], r["images"], r["view_valid"], r["text_ids"],
                       r["text_len"]).result(timeout=600)      # warm-up
            before = eng.stats()["batches"]
            dispatched.clear()
            kernels.launches.clear()
            got, futs, wall, lat = engine_workload(eng, reqs)
            counts = {k: v for k, v in kernels.launches.items() if v}
            buckets = list(dispatched)
            n_batches = eng.stats()["batches"] - before
            busy = device_busy(torch, lambda: engine_workload(eng, reqs))
            stats = eng.stats()
            bucket_sizes, depth = eng.buckets, eng.pipeline_depth
        with ServingEngine(model, tok, pipeline_depth=2, **kw) as eng:
            in_flight = []
            dispatched2 = record_buckets(eng, in_flight)
            kernels.launches.clear()
            got2, futs2, wall2, lat2 = engine_workload(eng, reqs)
            counts2 = {k: v for k, v in kernels.launches.items() if v}
            depth2 = dict(pipeline_depth=eng.pipeline_depth,
                          batches=eng.stats()["batches"],
                          in_flight_at_dispatch=in_flight)
        if counts != scaled(per_bucket, n_batches):
            raise AssertionError(f"serving-engine: launch counts {counts} "
                                 f"!= {n_batches} x {per_bucket}")
        if depth2["pipeline_depth"] != 2 or max(in_flight) != 1 or \
                counts2 != scaled(per_bucket, depth2["batches"]):
            raise AssertionError(f"serving-engine at pipeline_depth 2: "
                                 f"{depth2}, launch counts {counts2}")
        check_buckets(dispatched2, futs2, got2, bucket_sizes,
                      " at pipeline_depth 2")
        vs_plain = []
        for rows, size in check_buckets(buckets, futs, got, bucket_sizes, ""):
            checks, _ = against_plain_kernels(
                torch, model,
                bucket_args(torch, model, [reqs[i] for i in rows], size),
                packed)
            vs_plain.append(dict(bucket=size, **checks))
    worst = {key: max(c[key] for c in vs_plain)
             for key in ("logits_rel_l2_vs_plain",
                         "step_logits_rel_l2_vs_plain")}
    by_row = {f"{key}_by_row": [x for c in vs_plain
                                for x in c.get(f"{key}_by_row", [])]
              for key in worst}
    return dict(
        config=SERVING_PRESET, requests=len(reqs), threads=ENGINE_THREADS,
        max_batch=ENGINE_BATCH, max_wait_ms=ENGINE_WAIT_MS,
        pipeline_depth=depth, prompt_width=width,
        buckets=[len(b) for b in buckets],
        equal_to_padded_bucket=len(reqs),
        wall_s=wall, frames_per_s=len(reqs) / wall,
        request_latency_p50_s=lat[len(lat) // 2],
        request_latency_max_s=lat[-1],
        **busy, device_idle_share=1 - busy["device_busy_s"] / wall,
        answer_lengths=[len(t) for t in got], stats=stats,
        **worst, **by_row,
        vs_plain_by_bucket=vs_plain,
        depth2=dict(**depth2, buckets=[len(b) for b in dispatched2],
                    wall_s=wall2, frames_per_s=len(reqs) / wall2,
                    request_latency_p50_s=lat2[len(lat2) // 2],
                    request_latency_max_s=lat2[-1],
                    equal_to_padded_bucket=len(reqs),
                    tokens_equal_to_depth1=got2 == got),
        launches=per_bucket, launches_total=counts)


def run_continuous(torch, model, tok, packed) -> dict:
    """continuous[8]: ContinuousServingEngine(slots=8, chunk_steps=8) on the
    same model and decode tree. A burst of 8 requests (sensors already on
    the card, submitted with the interpreter's switch interval raised so
    that they reach the queue together) is admitted at once and must give
    greedy_generate's tokens on those 8 at the slab's cache length; then 4
    staggered admissions (each submitted once the one before has streamed
    its first chunk), reported against their batch-1 answers. Launches:
    the prefill's of `expected_launches` per admission and one packed
    decode step's per slab step."""
    import threading
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.inference import ContinuousServingEngine
    cfg = model.cfg
    reqs = [dict(r, bev=torch.as_tensor(r["bev"], device="cuda"),
                 images=torch.as_tensor(r["images"], device="cuda"),
                 view_valid=torch.as_tensor(r["view_valid"], device="cuda"))
            for r in engine_requests(cfg, tok)]
    width = reqs[0]["text_ids"].shape[0]
    step = decode_step_launches(cfg)
    prefill = added(expected_launches(cfg, serving=True, prompt_len=width),
                    scaled(step, -NEW_TOKENS))
    slots, chunk = ENGINE_BATCH, 8

    def want_counts(st, before):
        adm = st["admission_batches"] - before["admission_batches"]
        steps = chunk * (st["decode_chunks"] - before["decode_chunks"])
        return added(scaled(prefill, adm), scaled(step, steps))

    with q8_scope_env("mlp"), ContinuousServingEngine(
            model, tok, slots=slots, chunk_steps=chunk,
            max_new_tokens=NEW_TOKENS, params_decode=packed) as eng:
        def submit(r, **kw):
            return eng.submit(r["bev"], r["images"], r["view_valid"],
                              r["text_ids"], r["text_len"], **kw)
        max_cache = eng.max_cache(width)
        before = eng.stats()
        kernels.launches.clear()
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1.0)
        try:
            t0 = time.perf_counter()
            futs = [submit(r) for r in reqs[:slots]]
        finally:
            sys.setswitchinterval(interval)
        burst = [f.result(timeout=600)[0] for f in futs]
        burst_s = time.perf_counter() - t0
        st = eng.stats()
        burst_counts = {k: v for k, v in kernels.launches.items() if v}
        if st["admission_batches"] - before["admission_batches"] != 1:
            raise AssertionError("continuous: the burst was not admitted at "
                                 "once")
        if burst_counts != want_counts(st, before):
            raise AssertionError(f"continuous: burst launches {burst_counts}"
                                 f" != {want_counts(st, before)}")
        before = st
        kernels.launches.clear()
        staggered, t0 = [], time.perf_counter()
        for r in reqs[slots:slots + 4]:
            streamed = threading.Event()
            f = submit(r, on_tokens=lambda _, e=streamed: e.set())
            while not (streamed.wait(0.01) or f.done()):
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("continuous: no chunk streamed")
            staggered.append(f)
        stag = [f.result(timeout=600)[0] for f in staggered]
        stag_s = time.perf_counter() - t0
        st = eng.stats()
        stag_counts = {k: v for k, v in kernels.launches.items() if v}
    if stag_counts != want_counts(st, before):
        raise AssertionError(f"continuous: staggered launches {stag_counts}"
                             f" != {want_counts(st, before)}")
    want = direct_generate(torch, model, reqs[:slots], slots, packed,
                           max_cache)
    for i, (a, b) in enumerate(zip(burst, want)):
        if a != b:
            raise AssertionError(
                f"continuous: burst request {i} differs from greedy_generate "
                f"of the 8 at step {first_difference(a, b)}")
    alone = [direct_generate(torch, model, [r], 1, packed, max_cache)[0]
             for r in reqs[slots:slots + 4]]
    return dict(
        slots=slots, chunk_steps=chunk, max_cache=max_cache,
        burst=slots, burst_equal_to_greedy=slots, burst_s=burst_s,
        burst_frames_per_s=slots / burst_s,
        staggered=len(stag), staggered_s=stag_s,
        staggered_equal_to_batch1=sum(a == b for a, b in zip(stag, alone)),
        staggered_first_difference=[first_difference(a, b)
                                    for a, b in zip(stag, alone)],
        stats=st, launches=added(burst_counts, stag_counts))


@contextlib.contextmanager
def ids_as_text():
    """ByteTokenizer.decode gives the ids themselves ("id id ..."), so an
    answer's text carries its tokens: random weights pick ids that the
    byte decode mostly drops, and two empty answers would compare equal."""
    from lvv_tpu_torch.data import tokenizer as T
    decode = T.ByteTokenizer.decode
    T.ByteTokenizer.decode = lambda self, ids: " ".join(map(str, ids))
    try:
        yield
    finally:
        T.ByteTokenizer.decode = decode


def text_request(model, tok, question, bev) -> dict:
    """The request the engines and the infer CLI make of a question and a
    BEV with no camera paths (every view zero and invalid)."""
    from lvv_tpu_torch.inference.server import _text_request_arrays
    images, valid, ids, n = _text_request_arrays(model.cfg, tok, question,
                                                 None)
    return dict(bev=bev, images=images, view_valid=valid, text_ids=ids,
                text_len=n)


def run_serve_http(torch, model, tok, packed) -> dict:
    """serve-http: the serve CLI's handler over a ServingEngine (packed
    decode, LVV_Q8_SCOPE "mlp") on 127.0.0.1, port 0, in a thread: /healthz,
    one POST /v1/vqa on a BEV .npy under build/ (its answer, the ids under
    `ids_as_text`, must equal the engine's for the same question, views
    invalid as the CLI submits them, and greedy_generate's on that
    request), /v1/stats, a 400 (missing BEV) and a 404. Launches: one
    bucket for the POST and one for the engine's own answer."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer
    import numpy as np
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.inference import ServingEngine
    from lvv_tpu_torch.tools.serve_vqa import make_handler
    bev = engine_requests(model.cfg, tok)[0]["bev"]
    root = REPO / "build" / "serve_http"
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "frame.npy", bev)
    per_bucket = expected_launches(model.cfg, serving=True,
                                   prompt_len=ENGINE_PROMPT)
    with q8_scope_env("mlp"), ids_as_text(), ServingEngine(
            model, tok, max_batch=ENGINE_BATCH, max_new_tokens=NEW_TOKENS,
            params_decode=packed) as eng:
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng, root))
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{srv.server_port}"

        def call(path, body=None):
            data = None if body is None else json.dumps(body).encode()
            try:
                with urllib.request.urlopen(base + path, data,
                                            timeout=600) as resp:
                    return resp.status, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())
        try:
            kernels.launches.clear()
            health = call("/healthz")
            t0 = time.perf_counter()
            post = call("/v1/vqa", {"question": QUESTIONS[0],
                                    "bev_path": "frame.npy"})
            post_s = time.perf_counter() - t0
            stats = call("/v1/stats")
            missing = call("/v1/vqa", {"question": QUESTIONS[0],
                                       "bev_path": "missing.npy"})
            unknown = call("/v2/nothing")
            want = eng.generate(QUESTIONS[0], bev, timeout=600)
            counts = {k: v for k, v in kernels.launches.items() if v}
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        direct = direct_generate(torch, model, [text_request(
            model, tok, QUESTIONS[0], bev)], 1, packed)[0]
    checks = {"healthz": health == (200, {"ok": True}),
              "post": post[0] == 200 and post[1].get("answer") == want,
              "answer = greedy_generate": bool(direct) and want == " ".join(
                  map(str, direct)),
              "stats": stats[0] == 200 and stats[1].get("requests") == 1,
              "missing bev 400": missing[0] == 400,
              "unknown path 404": unknown[0] == 404,
              "launches": counts == scaled(per_bucket, 2)}
    if not all(checks.values()):
        raise AssertionError(f"serve-http: {checks}; post {post}, launches "
                             f"{counts}")
    return dict(checks=checks, post_latency_s=post_s,
                server_latency_s=post[1]["latency_s"],
                answer_tokens=len(direct), launches=per_bucket)


def run_infer_cli(torch, model, tok) -> dict:
    """infer-cli: the infer CLI on build/serving_preset with two questions
    (its defaults: the float decode, LVV_Q8_SCOPE "mlp"), run twice: as
    `python -m lvv_tpu_torch.tools.infer_vqa ...` in a subprocess on the
    card, which must exit 0, and through its `main` in this process under
    `ids_as_text`, the launch counts reset just before and read just
    after, which must be those of `expected_launches` with the float
    decode for each question. The in-process answers must be
    greedy_generate's tokens on each question's request, and each
    subprocess answer their byte decode; both write their rows to
    --out."""
    import io
    import numpy as np
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.tools import infer_vqa
    root = REPO / "build" / "infer_cli"
    root.mkdir(parents=True, exist_ok=True)
    reqs = [text_request(model, tok, q, r["bev"]) for q, r in zip(
        QUESTIONS, engine_requests(model.cfg, tok)[:2])]
    rows = []
    for i, r in enumerate(reqs):
        np.save(root / f"bev{i}.npy", r["bev"])
        rows.append({"question": QUESTIONS[i],
                     "bev_path": str(root / f"bev{i}.npy")})
    (root / "questions.json").write_text(json.dumps(rows))

    def argv(out):
        return ["--checkpoint", str(PRESET_DIR), "--questions",
                str(root / "questions.json"), "--max-new-tokens",
                str(NEW_TOKENS), "--out", str(root / out)]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lvv_tpu_torch.tools.infer_vqa",
         *argv("answers.json")],
        cwd=REPO, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"infer-cli exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    buf = io.StringIO()
    with q8_scope_env("mlp"), ids_as_text(), contextlib.redirect_stdout(buf):
        kernels.launches.clear()
        t0 = time.perf_counter()
        infer_vqa.main(argv("answers_in_process.json"))
        main_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launches.items() if v}
    torch.cuda.empty_cache()
    with q8_scope_env("mlp"):
        want = [direct_generate(torch, model, [r], 1, None)[0] for r in reqs]

    def printed(text):
        return [json.loads(ln) for ln in text.splitlines()
                if ln.startswith("{")]
    sub, mine = printed(proc.stdout), printed(buf.getvalue())
    checks = {
        "rows written": sub == json.loads(
            (root / "answers.json").read_text()) and mine == json.loads(
            (root / "answers_in_process.json").read_text()),
        "questions": [r["question"] for r in sub] == [
            r["question"] for r in mine] == list(QUESTIONS[:len(rows)]),
        "in-process = greedy_generate": all(want) and [
            r["answer"] for r in mine] == [" ".join(map(str, w))
                                           for w in want],
        "subprocess = its byte decode": [r["answer"] for r in sub] == [
            tok.decode(w) for w in want]}
    per_generate = expected_launches(model.cfg, serving=True,
                                     prompt_len=ENGINE_PROMPT, packed=False)
    checks["launches"] = counts == scaled(per_generate, len(rows))
    if not all(checks.values()):
        raise AssertionError(f"infer-cli: {checks}; subprocess rows {sub}, "
                             f"in-process rows {mine}, launches {counts}")
    return dict(checks=checks, rows=len(sub), subprocess_s=cli_s,
                in_process_s=main_s, answer_tokens=[len(w) for w in want],
                launches=per_generate, launches_total=counts)


# -------------------------------------------------------------- lidar-bev --

LIDAR_DIR = REPO / "build" / "lidar_bev"
LIDAR_POINTS = 300000
# The producer on the card against the same cloud and weights through the
# port on the CPU: every stage's active ids equal (they come from sorts and
# cumsums), the dense BEV within BEV_REL_TOL relative L2 (fp32 sums in
# another order through 25 conv layers), and the detections: the same
# count and, ordered by position, boxes within BOX_ABS_TOL (metres,
# radians, m/s). Seeded weights leave every heatmap score at about
# sigmoid(-4.6), under the 0.1 threshold, so both copies take a heatmap
# bias of -1 and a size bias of -1.5: the decode then keeps boxes ~0.2 m
# wide, apart at the 0.6 m stride-8 spacing, and NMS suppresses a site's
# other classes (IoU 1) without IoUs near its 0.2 threshold. The
# precompute tool's float16 file is held to the card's BEV within
# BEV_F16_REL_TOL (float16 rounding).
BEV_REL_TOL = 1e-4
BOX_ABS_TOL = 1e-3
BEV_F16_REL_TOL = 1e-3


def surface_cloud(rng, n: int, extent: float, z0: float = -2.0,
                  z1: float = 2.0, boxes=None):
    """A max-density surface scene: ground disc, walls, vehicle boxes (the
    script's own copy of benchmarks/capacity_stress.py:36-63). A `boxes`
    list receives each vehicle's box (x, y, z, dx, dy, dz, heading, vx,
    vy); the points do not depend on it."""
    import numpy as np
    parts = []
    n_ground = int(n * 0.45)
    r = extent * np.sqrt(rng.uniform(0, 1, n_ground))
    th = rng.uniform(0, 2 * np.pi, n_ground)
    parts.append(np.stack([r * np.cos(th), r * np.sin(th),
                           z0 + rng.normal(0, 0.03, n_ground)], 1))
    n_wall = int(n * 0.35)
    for seg in np.array_split(np.arange(n_wall), 12):
        cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        ang = rng.uniform(0, np.pi)
        along = rng.uniform(-8, 8, len(seg))
        parts.append(np.stack(
            [cx + along * np.cos(ang) + rng.normal(0, 0.02, len(seg)),
             cy + along * np.sin(ang) + rng.normal(0, 0.02, len(seg)),
             rng.uniform(z0, z1, len(seg))], 1))
    n_box = n - n_ground - n_wall
    for seg in np.array_split(np.arange(n_box), 24):
        cx, cy = rng.uniform(-extent * 0.8, extent * 0.8, 2)
        if boxes is not None:
            boxes.append([cx, cy, z0 + 0.9, 4.4, 2.0, 1.8, 0.0, 0.0, 0.0])
        parts.append(np.stack(
            [cx + rng.uniform(-2.2, 2.2, len(seg)),
             cy + rng.uniform(-1.0, 1.0, len(seg)),
             z0 + rng.uniform(0, 1.8, len(seg))], 1))
    pts = np.concatenate(parts)[:n]
    return np.concatenate([pts, rng.uniform(0, 1, (len(pts), 1))],
                          1).astype(np.float32)


def lidar_cloud(cfg, seed: int = 0, boxes=None):
    """(points [max_points, 4] float32, n): a seeded surface cloud of
    LIDAR_POINTS points over +-54 m, zero-padded to the voxelizer's
    max_points (its vehicles' boxes into `boxes`, when given)."""
    import numpy as np
    pts = surface_cloud(np.random.default_rng(seed), LIDAR_POINTS, 54.0,
                        boxes=boxes)
    out = np.zeros((cfg.voxelize.max_points, 4), np.float32)
    out[:len(pts)] = pts
    return out, len(pts)


def write_sweeps(root, clouds, version: str = "v1.0-mini") -> list:
    """Minimal nuScenes tables under root/version for `clouds` ([N, 4]
    arrays): one keyframe sample each, its LIDAR_TOP sweep written as a
    .pcd.bin of N x 5 float32 (x, y, z, intensity, ring 0). Returns the
    sample tokens."""
    import numpy as np
    root = pathlib.Path(root)
    (root / version).mkdir(parents=True, exist_ok=True)
    (root / "samples" / "LIDAR_TOP").mkdir(parents=True, exist_ok=True)
    samples, sweeps = [], []
    for i, pts in enumerate(clouds):
        name = f"samples/LIDAR_TOP/sweep{i}.pcd.bin"
        raw = np.zeros((len(pts), 5), np.float32)
        raw[:, :4] = pts[:, :4]
        raw.tofile(root / name)
        samples.append(dict(token=f"sample-{i}", scene_token="scene-0",
                            timestamp=i, prev="", next=""))
        sweeps.append(dict(token=f"sd-{i}", sample_token=f"sample-{i}",
                           calibrated_sensor_token="cs-lidar",
                           ego_pose_token=f"pose-{i}", filename=name,
                           fileformat="pcd", is_key_frame=True,
                           timestamp=i, prev="", next=""))
    tables = dict(
        category=[], instance=[], sample_annotation=[],
        ego_pose=[dict(token=f"pose-{i}", translation=[0.0, 0.0, 0.0],
                       rotation=[1.0, 0.0, 0.0, 0.0], timestamp=i)
                  for i in range(len(clouds))],
        scene=[dict(token="scene-0", name="scene-0000", log_token="log-0",
                    nbr_samples=len(clouds),
                    first_sample_token=samples[0]["token"],
                    last_sample_token=samples[-1]["token"])],
        sensor=[dict(token="sensor-lidar", channel="LIDAR_TOP",
                     modality="lidar")],
        calibrated_sensor=[dict(token="cs-lidar", sensor_token="sensor-lidar",
                                translation=[0.0, 0.0, 0.0],
                                rotation=[1.0, 0.0, 0.0, 0.0],
                                camera_intrinsic=[])],
        sample=samples, sample_data=sweeps)
    for name, rows in tables.items():
        (root / version / f"{name}.json").write_text(json.dumps(rows))
    return [s["token"] for s in samples]


def lidar_detector(torch, cfg, device):
    """The producer at default_config()'s width with seeded weights, the
    heatmap and size biases set as BEV_REL_TOL's note says."""
    from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
    det = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                            device=device, seed=0)
    with torch.no_grad():
        det.head.hm_head_bias.fill_(-1.0)
        det.head.dim_head_bias.fill_(-1.5)
    return det


def produce(torch, det, pts, n, trace=None):
    """points -> (the forward's dict, detections), synchronised."""
    from lvv_tpu_torch.models.voxelnext import decode_detections
    with torch.no_grad():
        out = det(pts, n, trace=trace)
        dets = decode_detections(out["preds"], det.det_cfg, det.vox_cfg,
                                 det.det_cfg.spatial_stride)
    if pts.is_cuda:
        torch.cuda.synchronize()
    return out, dets


def lidar_stage_s(torch, det, pts, n) -> dict:
    """One producer call on the card stage by stage, each ending in a
    synchronise: seconds of voxelize, backbone (its dense BEV included),
    head, decode + NMS."""
    from lvv_tpu_torch.models.voxelnext import decode_detections
    from lvv_tpu_torch.ops.sparse import to_dense
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return res

    def backbone(st):
        bev = det.backbone(st)
        to_dense(bev)
        return bev
    with torch.no_grad():
        st = timed("voxelize", lambda: det.voxelize(pts, n))
        bev = timed("backbone", lambda: backbone(st))
        preds = timed("head", lambda: det.head(bev))
        timed("decode_nms", lambda: decode_detections(
            preds, det.det_cfg, det.vox_cfg, det.det_cfg.spatial_stride))
    return out


def by_position(dets):
    """The kept boxes [count, 9] on the host, ordered by (x, y)."""
    import numpy as np
    boxes = dets.boxes[:int(dets.count)].cpu().numpy()
    return boxes[np.lexsort((boxes[:, 1], boxes[:, 0]))]


def run_precompute(torch, clouds, want_bev) -> dict:
    """The port's precompute_bev as a subprocess over 2 sweeps under
    LIDAR_DIR: two float16 [128, 180, 180] files (the first held to
    `want_bev`, the card's BEV of the same cloud and seed), then a rerun
    that skips both."""
    import numpy as np
    shutil.rmtree(LIDAR_DIR, ignore_errors=True)
    root, out = LIDAR_DIR / "nusc", LIDAR_DIR / "bev"
    tokens = write_sweeps(root, clouds)
    cmd = [sys.executable, "-m", "lvv_tpu_torch.tools.precompute_bev",
           "--dataroot", str(root), "--version", "v1.0-mini", "--out",
           str(out), "--split", "val", "--batch", "2"]
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=600,
                              env=dict(os.environ, PYTHONPATH=str(REPO)))
        runs.append((proc, time.perf_counter() - t0))
        if proc.returncode:
            raise AssertionError(f"precompute_bev exit {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
    files = [out / "val" / f"{t}.npy" for t in tokens]
    bevs = [np.load(f) for f in files]
    first = torch.from_numpy(bevs[0].astype(np.float32))
    loader = [ln.split(": ", 1)[1] for ln in runs[0][0].stdout.splitlines()
              if ln.startswith("point loader: ")]
    checks = {
        "files": all(b.shape == (128, 180, 180) and b.dtype == np.float16
                     and np.isfinite(b).all() for b in bevs),
        "first run wrote 2": "2 samples to process" in runs[0][0].stdout,
        "rerun skipped both": "0 samples to process" in runs[1][0].stdout,
        "read through the native library": len(loader) == 1
        and pathlib.Path(loader[0]).name.startswith("liblvv_io-")
        and pathlib.Path(loader[0]).exists()}
    f16_rel = rel_l2(first, want_bev.cpu())
    checks["first file = the card's BEV"] = f16_rel <= BEV_F16_REL_TOL
    if not all(checks.values()):
        raise AssertionError(f"precompute_bev: {checks} (rel L2 {f16_rel}); "
                             f"{runs[0][0].stdout[-1000:]}")
    shutil.rmtree(LIDAR_DIR)
    print(f"native-io: built and used {loader[0]}", flush=True)
    return dict(checks=checks, first_file_rel_l2=f16_rel,
                native_loader=loader[0],
                stdout=runs[0][0].stdout.strip().splitlines(),
                run_s=runs[0][1], rerun_s=runs[1][1])


def run_lidar_bev(torch, model) -> dict:
    """The LiDAR BEV producer at default_config()'s full width on the card
    (300,000 points, 160,000 voxels, [128, 180, 180] out): p50 of 3 runs of
    each stage after a warm-up, the whole call's p50, peak memory, one
    profiled call's device busy and idle; each stage's demand against its
    capacity (telemetry on); the same cloud and weights through the port on
    the CPU (ids, BEV, detections); the BEV through greedy_generate of the
    float model `model` (launches as derived, logits against the plain
    kernels); the precompute tool as a subprocess."""
    from lvv_tpu_torch import default_config, greedy_generate, kernels
    from lvv_tpu_torch.ops import sparse as S
    cfg = default_config()
    pts_np, n = lidar_cloud(cfg)
    det = lidar_detector(torch, cfg, "cuda")
    pts = torch.from_numpy(pts_np).to(det.device)
    produce(torch, det, pts, n)                       # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    trace = []
    t0 = time.perf_counter()
    out, dets = produce(torch, det, pts, n, trace)
    call_s = [time.perf_counter() - t0]
    peak = torch.cuda.max_memory_allocated()
    bev = out["bev_dense"]
    nx, ny, _ = det.voxel_grid().grid_size
    stride = cfg.model.voxelnext.spatial_stride
    shape = (cfg.model.voxelnext.out_channels, ny // stride, nx // stride)
    if tuple(bev.shape) != shape or not torch.isfinite(bev).all():
        raise AssertionError(f"bev_dense {tuple(bev.shape)}: not finite "
                             f"{list(shape)}")
    # the BEV into the VQA model: launches counted from the producer's run
    args = [torch.as_tensor(a, device=bev.device)
            for a in bench_inputs(model.cfg)]
    args[0] = bev[None]
    toks, lens = greedy_generate(model, *args, max_new_tokens=NEW_TOKENS,
                                 eos_id=EOS_ID)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launches.items() if v}
    if counts != expected_launches(model.cfg):
        raise AssertionError(f"lidar-bev launches {counts} != expected "
                             f"{expected_launches(model.cfg)}")
    vqa, _ = against_plain_kernels(torch, model, args, None)
    for _ in range(2):
        t0 = time.perf_counter()
        produce(torch, det, pts, n)
        call_s.append(time.perf_counter() - t0)
    stages = [lidar_stage_s(torch, det, pts, n) for _ in range(3)]
    stage_p50 = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
    device = device_busy(torch, lambda: produce(torch, det, pts, n))
    S.reset_overflow_log()
    S.set_overflow_debug(True)
    try:
        produce(torch, det, pts, n)
    finally:
        S.set_overflow_debug(False)
    capacity = S.overflow_log()
    S.reset_overflow_log()
    # the same cloud and weights through the port on the CPU
    cpu = lidar_detector(torch, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    trace_cpu = []
    t0 = time.perf_counter()
    out_cpu, dets_cpu = produce(torch, cpu, torch.from_numpy(pts_np), n,
                                trace_cpu)
    cpu_s = time.perf_counter() - t0
    ids_equal = {name: torch.equal(a.ids.cpu(), b.ids)
                 for (name, a), (_, b) in zip(trace, trace_cpu)}
    bev_rel = rel_l2(bev.cpu(), out_cpu["bev_dense"])
    boxes, boxes_cpu = by_position(dets), by_position(dets_cpu)
    box_err = (float(abs(boxes - boxes_cpu).max())
               if boxes.shape == boxes_cpu.shape and len(boxes) else None)
    checks = {"stage ids equal": all(ids_equal.values()),
              "bev within BEV_REL_TOL": bev_rel <= BEV_REL_TOL,
              "detection count": int(dets.count) == int(dets_cpu.count),
              "boxes within BOX_ABS_TOL": box_err is not None
              and box_err <= BOX_ABS_TOL}
    if not all(checks.values()):
        raise AssertionError(f"lidar-bev vs the CPU: {checks}; ids "
                             f"{ids_equal}, bev rel L2 {bev_rel}, counts "
                             f"{int(dets.count)} / {int(dets_cpu.count)}, "
                             f"box err {box_err}")
    del cpu, out_cpu, dets_cpu, trace_cpu
    active = {name: int(t.num_active()) for name, t in trace}
    report = dict(
        points=n, voxels=active["stage1"], grid=list(det.voxel_grid().grid_size),
        capacities=[cfg.voxelize.max_voxels, *det.backbone.capacities],
        active_sites=active, bev_shape=list(bev.shape),
        call_s=sorted(call_s), call_p50_s=sorted(call_s)[1],
        stage_p50_s=stage_p50, peak_mem_gib=peak / 2 ** 30, **device,
        device_idle_share=1 - device["device_busy_s"] / sorted(call_s)[1],
        capacity_demand={k: v for k, v in sorted(capacity.items())},
        checks=checks, stage_ids_equal_cpu=ids_equal,
        bev_rel_l2_vs_cpu=bev_rel, detections=int(dets.count),
        box_max_abs_vs_cpu=box_err, cpu_call_s=cpu_s,
        tokens=toks[0].tolist(), launches=counts, **vqa)
    second, n2 = lidar_cloud(cfg, seed=1)
    report["precompute_bev"] = run_precompute(
        torch, [pts_np[:n], second[:n2]], bev)
    return report


# --------------------------------------------------------- detector-train --

DET_DIR = REPO / "build" / "detector_train"
# VoxelNeXt training at default_config()'s full width (fp32, TF32 off). One
# step at batch 1 in each norm mode, all from the same weights, cloud and
# gts: in float64 on the card (the reference), in float32 on the card as a
# user runs it, and in float32 on the card and on the CPU with every ReLU's
# gate replayed from the float64 step. A ReLU whose input lies within
# float32 rounding of 0 takes its gate from the rounding: at these weights
# a few such entries per norm mode (inputs 2e-8 to 1e-7 of their layer's
# largest) each carry up to ~2e-3 of their layer's gradient norm, and
# every stage before them inherits that (`detector_grad_audit.py`, PERF.md
# §6). With the gates replayed, the loss within DET_LOSS_TOL relative, the
# running statistics within DET_STAT_TOL, and each parameter group's
# gradient (backbone stages, BEV output, each head branch; all its tensors
# as one vector) within DET_GRAD_TOL relative L2, card against CPU and
# each against float64; the user's float32 step is printed beside them with
# the count of gates it takes otherwise. The conv biases that a "bn" norm
# subtracts out again have an analytically zero gradient (float32 noise,
# different on each device): left out of their groups and held under
# DET_CANCELLED_TOL of the global gradient norm. The trap, the card's "bn"
# step with the batch moments detached (taken as constants, as a
# F.batch_norm over detached statistics would) and the same gates, drops
# their share of every gradient below the deepest norm and has to fail
# each group's bound by 10x.
DET_LOSS_TOL = 1e-5
DET_GRAD_TOL = 1e-4
DET_STAT_TOL = 1e-5
DET_CANCELLED_TOL = 1e-4
DET_BATCH, DET_STEPS, DET_LR, MAX_GT = 2, 4, 1e-3, 128
# capacity buckets (max_voxels, stage capacities) for the bucketed step:
# default_config()'s 3/4 rule, the nuScenes schedule with a 250k voxelizer,
# and a larger one
DET_BUCKETS = ((160000, (120000, 90000, 67500, 50625, 37968)),
               (250000, (440000, 240000, 96000, 32000, 12000)),
               (320000, (600000, 320000, 128000, 48000, 16000)))


def detector_config(norm: str):
    import dataclasses
    from lvv_tpu_torch import default_config
    cfg = default_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, voxelnext=dataclasses.replace(cfg.model.voxelnext,
                                                 norm=norm)))


def detector_batch(cfg, seeds, cloud=lidar_cloud) -> dict:
    """`cloud`'s surface clouds (lidar_cloud's unless told) and their
    vehicle boxes (class 0), padded to MAX_GT with a mask."""
    import numpy as np
    out = {k: [] for k in ("points", "num_points", "gt_boxes", "gt_labels",
                           "gt_mask")}
    for seed in seeds:
        boxes = []
        pts, n = cloud(cfg, seed, boxes=boxes)
        gt = np.zeros((MAX_GT, 9), np.float32)
        gt[:len(boxes)] = boxes
        mask = np.zeros(MAX_GT, bool)
        mask[:len(boxes)] = True
        for key, v in zip(out, (pts, n, gt, np.zeros(MAX_GT, np.int32),
                                mask)):
            out[key].append(v)
    return {k: np.stack(v) for k, v in out.items()}


def detector_groups(det) -> dict:
    """{group: [parameter names]}: stage1 (conv_input, res1), stage2-6
    (down_i, res_i+1), bev (conv_out, shared_conv), each head branch."""
    groups = collections.defaultdict(list)
    for name, _ in det.named_parameters():
        part = name.split(".")
        if part[0] == "head":
            groups["head." + part[1].split("_conv")[0].split("_head")[0]
                   ].append(name)
        elif part[1] in ("conv_input", "res1"):
            groups["stage1"].append(name)
        elif part[1] in ("conv_out", "shared_conv"):
            groups["bev"].append(name)
        elif part[1].startswith("down"):             # down_i opens stage i + 1
            groups[f"stage{int(part[1][4:]) + 1}"].append(name)
        else:                                         # res_i
            groups[f"stage{int(part[1][3:])}"].append(name)
    return dict(groups)


def detector_step(torch, det, batch, steps: int = 1):
    """`steps` train steps of `det` on `batch` through the CLI's chain ->
    (the metrics of each as floats, {name: gradient on the host or None}
    of the last)."""
    from lvv_tpu_torch.train.detector import make_detector_train_step
    from lvv_tpu_torch.train.optim import detector_optimizer
    tx = detector_optimizer(DET_LR, DET_STEPS)
    step = make_detector_train_step(det, tx, det.det_cfg, det.vox_cfg)
    state = (det, tx.init(dict(det.named_parameters())))
    metrics = []
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    grads = {n: None if p.grad is None else p.grad.cpu()
             for n, p in det.named_parameters()}
    return metrics, grads


def cancelled_biases(det) -> list:
    """The conv biases that a "bn" norm right after subtracts out."""
    if det.det_cfg.norm != "bn":
        return []
    return [n for n, _ in det.named_parameters()
            if n.endswith(".bias") and not n.endswith("_head_bias")]


def group_rel_l2(torch, groups, got, want, skip=()) -> dict:
    """Each group's gradient as one vector, the names in `skip` left out:
    ||got - want|| / ||want|| (None where neither has one; ||got|| where
    want is zero)."""
    out = {}
    for g, names in groups.items():
        pairs = [(got[n], want[n]) for n in names if n not in skip]
        if all(a is None and b is None for a, b in pairs):
            out[g] = None
            continue
        a = torch.cat([x.reshape(-1) for x, _ in pairs])
        b = torch.cat([y.reshape(-1) for _, y in pairs])
        out[g] = rel_l2(a, b) if b.any() else float(a.norm())
    return out


@contextlib.contextmanager
def detached_moments():
    """The trap: the "bn" train form with its batch moments detached."""
    from lvv_tpu_torch.models import voxelnext as V
    plain = V.masked_moments
    V.masked_moments = lambda f, valid: tuple(
        t.detach() for t in plain(f, valid))
    try:
        yield
    finally:
        V.masked_moments = plain


@contextlib.contextmanager
def relu_gates(torch, det, record=None, replay=None):
    """The ReLU of each of `det`'s conv layers, in call order: its gate
    (x > 0 on the valid rows) appended to `record`, and, given `replay` (a
    recorded list), taken from there instead of from x: x · gate."""
    from lvv_tpu_torch.models.voxelnext import SparseConvLayer
    relu, inside, calls = torch.relu, [], [0]

    def gated(x):
        if not inside:
            return relu(x)
        i, calls[0] = calls[0], calls[0] + 1
        if record is not None:
            record.append(x.detach() > 0)
        if replay is None:
            return relu(x)
        return x * replay[i].to(x.device, x.dtype)

    def enter(*_):
        inside.append(1)

    def leave(_, __, out):
        inside.pop()
        if record is not None:         # padded rows leave as zeros anyway
            record[-1] &= out.valid[:, None]
    hooks = []
    for m in det.modules():
        if isinstance(m, SparseConvLayer):
            hooks.append(m.register_forward_pre_hook(enter))
            hooks.append(m.register_forward_hook(leave))
    torch.relu = gated
    try:
        yield
    finally:
        torch.relu = relu
        for h in hooks:
            h.remove()


def detector_against_cpu(torch, norm: str) -> dict:
    """(a) One step at batch 1 in `norm` mode: in float64 on the card (its
    gates recorded), in float32 on the card as it runs (its gates counted
    against those), and in float32 on the card and on the CPU with the
    float64 step's gates; under "bn" also the trap on the card."""
    from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
    cfg = detector_config(norm)
    batch = detector_batch(cfg, (0,))
    det = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                            device="cuda", seed=0)
    start = {k: v.clone() for k, v in det.state_dict().items()}
    ref = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                            device="cuda").double()
    ref.load_state_dict(start)
    gates, own = [], []
    with relu_gates(torch, ref, record=gates):
        _, ref_g = detector_step(torch, ref, batch)
    del ref
    t0 = time.perf_counter()
    with relu_gates(torch, det, record=own):
        user_m, user_g = detector_step(torch, det, batch)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    differ = sum(int((a != b).sum()) for a, b in zip(own, gates))
    del own
    det.load_state_dict(start)
    with relu_gates(torch, det, replay=gates):
        card_m, card_g = detector_step(torch, det, batch)
    card_stats = {n: b.cpu() for n, b in det.named_buffers()}
    cpu = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    t0 = time.perf_counter()
    with relu_gates(torch, cpu, replay=gates):
        cpu_m, cpu_g = detector_step(torch, cpu, batch)
    cpu_s = time.perf_counter() - t0
    groups = detector_groups(det)
    skip = cancelled_biases(det)
    rel = {pair: group_rel_l2(torch, groups, a, b, skip) for pair, a, b in (
        ("card-cpu", card_g, cpu_g), ("card-fp64", card_g, ref_g),
        ("cpu-fp64", cpu_g, ref_g))}
    over = {pair: [g for g, v in r.items()
                   if v is not None and v > DET_GRAD_TOL]
            for pair, r in rel.items()}
    user = group_rel_l2(torch, groups, user_g, ref_g, skip)
    total = float(torch.cat([g.reshape(-1) for g in cpu_g.values()
                             if g is not None]).norm())

    def share(grads):                   # the cancelled biases' norm, of G
        kept = [grads[n] for n in skip if grads[n] is not None]
        return float(torch.cat(kept).norm()) / total if kept else 0.0
    cancelled = {"card": share(card_g), "cpu": share(cpu_g),
                 "card_own_gates": share(user_g)}
    stat_err = max([float((card_stats[n] - b).abs().max())
                    for n, b in cpu.named_buffers()], default=0.0)
    loss_rel = abs(card_m[0]["loss"] - cpu_m[0]["loss"]) / abs(
        cpu_m[0]["loss"])
    user_loss_rel = abs(user_m[0]["loss"] - cpu_m[0]["loss"]) / abs(
        cpu_m[0]["loss"])
    del cpu
    checks = {
        "loss within DET_LOSS_TOL, own and replayed gates": max(
            loss_rel, user_loss_rel) <= DET_LOSS_TOL,
        "group gradients within DET_GRAD_TOL, card / CPU / fp64": not any(
            over.values()),
        "vel / iou without gradients": rel["card-cpu"]["head.vel"] is None
        and rel["card-cpu"]["head.iou"] is None,
        "running statistics within DET_STAT_TOL": stat_err <= DET_STAT_TOL,
        "cancelled biases under DET_CANCELLED_TOL": max(
            cancelled.values()) <= DET_CANCELLED_TOL}
    report = dict(norm=norm, loss_card=card_m[0]["loss"],
                  loss_cpu=cpu_m[0]["loss"], loss_rel=loss_rel,
                  loss_card_own_gates=user_m[0]["loss"],
                  group_grad_rel_l2=rel, relu_entries=sum(
                      int(g.numel()) for g in gates),   # padded rows too
                  gates_differing_from_fp64=differ,
                  own_gates_group_rel_l2_vs_fp64=user,
                  stat_max_abs=stat_err, cancelled_biases=cancelled,
                  global_grad_norm=total, card_step_s=card_s,
                  cpu_step_s=cpu_s, gts=int(batch["gt_mask"].sum()))
    worst = max(v for r in rel.values() for v in r.values() if v is not None)
    own_worst = max(v for v in user.values() if v is not None)
    print(f"detector-train[{norm}]: with the float64 step's gates, groups "
          f"card / CPU / fp64 within {worst:.2e}; with its own ({differ} of "
          f"{report['relu_entries']} gates differ) {own_worst:.2e} from "
          f"fp64", flush=True)
    if norm == "bn":
        det.load_state_dict(start)
        with detached_moments(), relu_gates(torch, det, replay=gates):
            _, trap_g = detector_step(torch, det, batch)
        trap = group_rel_l2(torch, groups, trap_g, cpu_g, skip)
        trap_worst = max(v for v in trap.values() if v is not None)
        # over the groups with a gradient (a stage whose norm sees a single
        # row has none: its output is ln_bias)
        trap_margin = min(v / DET_GRAD_TOL for g, v in trap.items()
                          if v is not None and any(
                              cpu_g[n] is not None and cpu_g[n].any()
                              for n in groups[g] if n not in skip))
        cancelled["trap"] = share(trap_g)
        checks["detached-moments trap fails each group's bound by 10x"] = (
            trap_margin > 10)
        print(f"detector-trap: detached batch moments, group rel L2 up to "
              f"{trap_worst:.3e}, each at least {trap_margin:.1f}x its "
              f"bound ({DET_GRAD_TOL:.0e})", flush=True)
        report.update(trap_group_grad_rel_l2=trap, trap_worst=trap_worst,
                      trap_margin=trap_margin)
    del gates
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-train[{norm}] vs the CPU: {checks}; "
                             f"over {over}; {report}")
    return report


def detector_timed(torch, norm: str) -> dict:
    """(b) DET_STEPS steps at batch DET_BATCH on one batch (the first a
    warm-up, the rest timed), then one profiled step."""
    from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
    from lvv_tpu_torch.train.detector import make_detector_train_step
    from lvv_tpu_torch.train.optim import detector_optimizer
    cfg = detector_config(norm)
    batch = detector_batch(cfg, range(DET_BATCH))
    det = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                            device="cuda", seed=0)
    tx = detector_optimizer(DET_LR, DET_STEPS + 1)
    step = make_detector_train_step(det, tx, cfg.model.voxelnext,
                                    cfg.voxelize)
    state = (det, tx.init(dict(det.named_parameters())))
    idle = {n: p.detach().clone() for n, p in det.named_parameters()
            if n.split(".")[1].startswith(("vel_", "iou_"))}
    losses, step_s = [], []
    for i in range(DET_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    timed = sorted(step_s[1:])
    p50 = timed[len(timed) // 2]
    print(f"detector-train[{norm}] profile of one step:", flush=True)
    device = device_busy(torch, lambda: (step(state, batch),
                                         torch.cuda.synchronize()))
    # vel / iou: no gradient, so AdamW's weight decay alone moves them
    # (those that start at zero stay there)
    no_grad = [n for n, p in det.named_parameters() if p.grad is None]
    decayed = [n for n in idle
               if not torch.equal(idle[n], det.get_parameter(n).detach())]
    checks = {"losses fall": losses[-1] < losses[0]
              and all(math.isfinite(x) for x in losses),
              "vel / iou updated by weight decay alone":
              sorted(no_grad) == sorted(idle) and len(idle) == 12
              and sorted(decayed) == sorted(n for n, t in idle.items()
                                            if t.any())}
    if not all(checks.values()):
        raise AssertionError(f"detector-train[{norm}]: {checks}; losses "
                             f"{losses}, no grad {no_grad}")
    return dict(checks=checks, losses=losses, step_s=step_s, s_per_step_p50=p50,
                samples_per_s=DET_BATCH / p50, peak_mem_gib=peak / 2 ** 30,
                **device, device_idle_share=1 - device["device_busy_s"] / p50,
                no_gradient_tensors=len(no_grad),
                no_gradient_elements=sum(idle[n].numel() for n in idle),
                weight_decay_only_tensors=len(decayed),
                weight_decay_only_elements=sum(int(idle[n].count_nonzero())
                                               for n in decayed),
                last_metrics={k: float(v) for k, v in m.items()})


def detector_cli(torch) -> dict:
    """(c) The CLI as a subprocess and through its `main` in this process
    (`--synthetic --steps 2 --save-every 1`, tiny_config(), on the card):
    exit 0, its log and final line; each run's last checkpoint restored
    into a new detector bit-equal to what it saved; the restored
    in-process detector's detect (every scored box through NMS) equal to
    the trained one's."""
    import dataclasses

    import numpy as np
    from lvv_tpu_torch import tiny_config
    from lvv_tpu_torch.models.voxelnext import VoxelNeXtDetector
    from lvv_tpu_torch.tools import train_detector
    from lvv_tpu_torch.train.checkpoints import CheckpointManager
    shutil.rmtree(DET_DIR, ignore_errors=True)
    argv = ["--synthetic", "--steps", "2", "--save-every", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lvv_tpu_torch.tools.train_detector", *argv,
         "--out", str(DET_DIR / "sub")], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(REPO)))
    sub_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"train_detector exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    final = json.loads(lines[-1])
    det, metrics = train_detector.main(argv + ["--out", str(DET_DIR / "in")])
    cfg = tiny_config()
    restored = {}
    for run in ("sub", "in"):
        ckpt = CheckpointManager(DET_DIR / run / "checkpoints")
        fresh = VoxelNeXtDetector(cfg.model.voxelnext, cfg.voxelize,
                                  device="cuda", seed=7)
        ckpt.restore("step_2", fresh)
        saved = torch.load(DET_DIR / run / "checkpoints" / "step_2" /
                           "state" / "state.pt", map_location="cuda")
        restored[run] = (fresh, all(torch.equal(saved[k], v) for k, v in
                                    fresh.state_dict().items()))
    pts = torch.from_numpy(train_detector.synthetic_batch(
        np.random.default_rng(0), 1, cfg.voxelize.max_points // 4, 8,
        cfg.voxelize.point_range)["points"][0]).cuda()
    n = cfg.voxelize.max_points // 4
    # the seeded tiny model scores no box above the threshold: both
    # detectors send every scored box through NMS, so that boxes compare
    for d in (det, restored["in"][0]):
        d.det_cfg = dataclasses.replace(d.det_cfg, score_thresh=-1.0)
    want = det.detect(pts, n)
    got = restored["in"][0].detect(pts, n)
    same_state = all(torch.equal(a, b) for a, b in zip(
        det.state_dict().values(), restored["in"][0].state_dict().values()))
    # same weights; the voxelizer's and segment sums' atomics may order a
    # voxel's float adds differently from one call to the next. The
    # forwards' BEV and head outputs are held too.
    with torch.no_grad():
        outs = [d.eval()(pts, n) for d in (det, restored["in"][0])]
    detect_err = max(float((a.float() - b.float()).abs().max())
                     for a, b in zip(got, want))
    forward_err = max(
        float((outs[0]["bev_dense"] - outs[1]["bev_dense"]).abs().max()),
        *(float((outs[0]["preds"][k].features
                 - outs[1]["preds"][k].features).abs().max())
          for k in outs[0]["preds"]))
    checks = {
        "exit 0, 2 log lines, final line": final["steps"] == 2
        and [ln.split()[0] for ln in lines[:2]] == ["[0]", "[1]"]
        and math.isfinite(final["final_loss"]),
        "checkpoints step_1, step_2": all(
            (DET_DIR / r / "checkpoints" / s).is_dir()
            for r in ("sub", "in") for s in ("step_1", "step_2")),
        "reloads bit-equal": restored["sub"][1] and restored["in"][1]
        and same_state,
        "reloaded detect = in-process detect, boxes kept": int(
            want.count) > 0 and int(got.count) == int(want.count)
        and torch.equal(got.labels, want.labels)
        and detect_err <= 1e-6 and forward_err <= 1e-6}
    loss_gap = abs(final["final_loss"] - metrics["loss"]) / abs(
        metrics["loss"])
    if not all(checks.values()):
        raise AssertionError(f"train_detector CLI: {checks}; "
                             f"{proc.stdout[-1500:]}")
    shutil.rmtree(DET_DIR)
    return dict(checks=checks, subprocess_s=sub_s, log=lines,
                in_process_final_loss=metrics["loss"],
                subprocess_vs_in_process_loss_rel=loss_gap,
                detections=int(want.count), detect_max_abs=detect_err,
                forward_max_abs=forward_err,
                bit_equal=detect_err == 0 and forward_err == 0)


def detector_bucket_pick(torch) -> dict:
    """(d) The bucketed step's pick on one surface cloud: the smallest of
    DET_BUCKETS whose capacities hold the host planner's demands; on the
    card, a train step in that bucket drops no site (telemetry) and a
    forward in the one below drops some."""
    from lvv_tpu_torch.ops import sparse as S
    from lvv_tpu_torch.ops.voxelize import VoxelGrid
    from lvv_tpu_torch.train.detector import make_bucketed_detector_train_step
    from lvv_tpu_torch.train.optim import detector_optimizer
    cfg = detector_config("ln")
    batch = detector_batch(cfg, (0,))
    tx = detector_optimizer(DET_LR, DET_STEPS)
    t0 = time.perf_counter()
    steps, pick = make_bucketed_detector_train_step(
        "VoxelNeXt", cfg.model.voxelnext, cfg.voxelize, tx, DET_BUCKETS,
        device="cuda")
    chosen = pick(batch["points"], batch["num_points"])
    pick_s = time.perf_counter() - t0
    grid = VoxelGrid.create(cfg.voxelize.point_range,
                            cfg.voxelize.voxel_size)
    demands = S.plan_capacity_demand(
        batch["points"][0][:int(batch["num_points"][0])], grid)
    dropped = {}
    S.reset_overflow_log()
    S.set_overflow_debug(True)
    try:
        det = steps[chosen].det
        steps[chosen]((det, tx.init(dict(det.named_parameters()))), batch)
        dropped["chosen"] = {k: v["dropped"] for k, v in
                             S.overflow_log().items()}
        if chosen:
            S.reset_overflow_log()
            below = steps[chosen - 1].det
            with torch.no_grad():
                below(torch.from_numpy(batch["points"][0]).cuda(),
                      int(batch["num_points"][0]), return_dense_bev=False)
            dropped["below"] = {k: v["dropped"] for k, v in
                                S.overflow_log().items()}
    finally:
        S.set_overflow_debug(False)
        S.reset_overflow_log()
    checks = {"a bucket below the largest": chosen < len(DET_BUCKETS) - 1,
              "no drop in the chosen bucket": not any(
                  dropped["chosen"].values()),
              "the bucket below drops": chosen == 0 or any(
                  dropped["below"].values())}
    if not all(checks.values()):
        raise AssertionError(f"bucket pick: {checks}; chosen {chosen}, "
                             f"demands {demands}, dropped {dropped}")
    return dict(checks=checks, chosen=chosen, bucket=DET_BUCKETS[chosen],
                demands=demands, dropped=dropped, pick_s=pick_s)


def run_detector_train(torch) -> dict:
    """VoxelNeXt training on the card at default_config()'s full width:
    (a) card against CPU and float64 in each norm mode, (b) timed steps in
    each norm mode, (c) the CLI, (d) the bucketed step's pick. (The native loader is checked in
    lidar-bev's precompute subprocess.)"""
    from lvv_tpu_torch import kernels
    kernels.launches.clear()
    report = {}
    for norm in ("bn", "ln"):
        report[f"against_cpu[{norm}]"] = detector_against_cpu(torch, norm)
        torch.cuda.empty_cache()
    for norm in ("ln", "bn"):
        report[f"timed[{norm}]"] = detector_timed(torch, norm)
        torch.cuda.empty_cache()
    report["cli"] = detector_cli(torch)
    report["bucket_pick"] = detector_bucket_pick(torch)
    torch.cuda.empty_cache()
    # no hand-written kernel lies on the detector's path
    report["launches"] = {k: v for k, v in kernels.launches.items() if v}
    return report


# ---------------------------------------------------------- detector-zoo --

ZOO_DIR = REPO / "build" / "detector_zoo"
# The nuScenes dense-BEV families at their presets' full width (fp32, TF32
# off, seeded weights) on lidar_cloud's 300,000-point surface cloud: the
# detector's call (p50 of 3 staged calls after a warm-up), one profiled
# call, and the same call through the port on the CPU from the same weights
# (sparse stage ids equal; the BEV and each head output within
# BEV_REL_TOL relative L2; detections as lidar-bev holds them). Seeded
# weights score nothing above the 0.1 threshold, so each detector's class
# or heatmap bias is set to -1 and its boxes made small (CenterPoint's size
# bias -1.5: 0.22 m boxes at its 0.6 m cells; PointPillars' -2.5 at its
# 0.2 m cells; SECOND's box branch scaled down to its bias, sizes e^-3 of
# the anchors'; TransFusion's size bias -1.5, where its head's e^b would
# reach metres whose float32 rounding alone is near BOX_ABS_TOL), so that
# NMS compares no IoU near its 0.2 threshold; and
# the heading's cosine channel takes a bias of 4, so that no heading is an
# atan2 of two values near 0 (where a 1e-6 difference in the head's
# outputs moves it by more than BOX_ABS_TOL).
ZOO_PRESETS = {"PointPillars": "configs/nuscenes_pp_multihead.json",
               "CenterPoint": "configs/nuscenes_centerpoint_voxel0075.json",
               "SECOND": "configs/nuscenes_second_multihead.json",
               "TransFusion": "configs/nuscenes_transfusion_lidar.json"}
# every family trains at batch ZOO_BATCH (ZOO_STEPS steps, the first a
# warm-up); these also at batch 1 on the card against the CPU from the
# same weights, every ReLU's gate and (TransFusion) the 200 query picks
# replayed on the CPU from the card's step: the loss within DET_LOSS_TOL,
# each group's gradient (backbone3d, backbone2d, head) within DET_GRAD_TOL
ZOO_TRAIN = ("TransFusion", "SECOND")
ZOO_BATCH, ZOO_STEPS = 2, 4
# K-e's fp32 form against its plain version (true fp32, TF32 off): the
# kernel's 3xTF32 products keep ~22 bits of each operand and sum in
# another order, and its kv splits combine partial softmax states, ~5e-7
# relative L2 at TransFusion's shape (emulated on the CPU); dropping the
# scale gives ~1 and one TF32 pass ~4.5e-4, and both have to fail
FP32_REL_L2_TOL = 1e-5


def zoo_config(family: str):
    from lvv_tpu_torch import config as C
    return C.load(C.VQAConfig, REPO / ZOO_PRESETS[family])


def zoo_detector(torch, family: str, cfg, device):
    """The family at its preset's width with seeded weights and the biases
    ZOO_PRESETS' note sets."""
    from lvv_tpu_torch.models.registry import build_detector
    det = build_detector(family, cfg.model.voxelnext, cfg.voxelize,
                         device=device, seed=0)
    head = det.head
    with torch.no_grad():
        if family in ("PointPillars", "CenterPoint"):
            head.hm.bias.fill_(-1.0)
            head.dim.bias.fill_(-2.5 if family == "PointPillars" else -1.5)
            head.rot.bias[1] = 4.0
        elif family == "SECOND":
            head.cls.bias.fill_(-1.0)
            head.box.kernel.mul_(1e-3)
            head.box.bias.view(-1, 7)[:, 3:6] = -3.0
        else:
            head.cls.bias.fill_(-1.0)
            head.box.bias[3:6] = -1.5
            head.box.bias[7] = 4.0
    return det


def zoo_staged(torch, det, pts, n, trace=None) -> tuple:
    """One call stage by stage (voxelize, trunk3d, trunk2d, head, decode),
    each ending in a synchronise where on the card -> (seconds by stage,
    the forward's dict, detections)."""
    sync = torch.cuda.synchronize if pts.is_cuda else (lambda: None)
    secs, x = {}, None
    with torch.no_grad():
        for i, (name, fn) in enumerate(det.stages(trace)):
            t0 = time.perf_counter()
            x = fn(pts, n) if i == 0 else fn(x)
            sync()
            secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dets = det.decode(x)
        sync()
        secs["decode"] = time.perf_counter() - t0
    return secs, x, dets


def zoo_outputs(out) -> dict:
    """The forward's float tensors to compare: the BEV and each head
    output."""
    got = {"bev_dense": out["bev_dense"]}
    got.update({f"preds.{k}": v for k, v in out["preds"].items()
                if v.is_floating_point()})
    return got


def timed_detect(torch, tag: str, det, pts, n, first=contextlib.nullcontext,
                 zoo_staged=zoo_staged) -> tuple:
    """`det`'s call on the card stage by stage (`zoo_staged` unless told:
    a function of (torch, det, pts, n, trace)): a warm-up, three calls
    (the first traced, inside `first()`, its launches counted from zero
    and the peak memory read after it), one profiled -> (report: the
    call's and each stage's p50, peak, device busy and idle, detections,
    launches; the first call's forward dict, detections and trace)."""
    from lvv_tpu_torch import kernels
    zoo_staged(torch, det, pts, n)                      # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    trace = []
    with first():
        stages = [zoo_staged(torch, det, pts, n, trace)]
    launches = {k: v for k, v in kernels.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    stages += [zoo_staged(torch, det, pts, n) for _ in range(2)]
    totals = sorted(sum(s[0].values()) for s in stages)
    stage_p50 = {k: sorted(s[0][k] for s in stages)[1]
                 for k in stages[0][0]}
    _, out, dets = stages[0]
    del stages
    print(f"{tag} profile of one call:", flush=True)
    device = device_busy(torch, lambda: zoo_staged(torch, det, pts, n))
    report = dict(points=n, call_s=totals, call_p50_s=totals[1],
                  stage_p50_s=stage_p50, peak_mem_gib=peak / 2 ** 30,
                  **device,
                  device_idle_share=1 - device["device_busy_s"] / totals[1],
                  detections=int(dets.count), launches=launches)
    return report, out, dets, trace


def zoo_detect(torch, family: str) -> dict:
    """The family's call on the card, timed and profiled, against the same
    call through the port on the CPU."""
    cfg = zoo_config(family)
    pts_np, n = lidar_cloud(cfg)
    det = zoo_detector(torch, family, cfg, "cuda")
    pts = torch.from_numpy(pts_np).cuda()
    report, out, dets, trace = timed_detect(
        torch, f"detector-zoo[{family}]", det, pts, n)
    launches = report["launches"]
    cpu = zoo_detector(torch, family, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    trace_cpu = []
    t0 = time.perf_counter()
    _, out_cpu, dets_cpu = zoo_staged(torch, cpu, torch.from_numpy(pts_np),
                                      n, trace_cpu)
    cpu_s = time.perf_counter() - t0
    ids_equal = {name: torch.equal(a.ids.cpu(), b.ids)
                 for (name, a), (_, b) in zip(trace, trace_cpu)}
    report.update(grid=list(det.voxel_grid().grid_size),
                  bev_shape=list(out["bev_dense"].shape), cpu_call_s=cpu_s,
                  stage_ids_equal_cpu=ids_equal)
    if family == "TransFusion":
        picks, picks_cpu = (o["preds"]["top_idx"].cpu()
                            for o in (out, out_cpu))
        differ = len(set(picks_cpu.tolist()) - set(picks.tolist()))
        report["query_picks_differing"] = differ
        if differ:      # the card's head again, on the CPU's picks
            with torch.no_grad():
                x = pts
                for i, (_, fn) in enumerate(det.stages()[:3]):
                    x = fn(pts, n) if i == 0 else fn(x)
                out = {"bev_dense": x, "preds": det.head(
                    x, picks_cpu.to(x.device))}
                dets = det.decode(out)
    rels = {k: rel_l2(v.float().cpu(), zoo_outputs(out_cpu)[k].float())
            for k, v in zoo_outputs(out).items()}
    boxes, boxes_cpu = by_position(dets), by_position(dets_cpu)
    box_err = (float(abs(boxes - boxes_cpu).max())
               if boxes.shape == boxes_cpu.shape and len(boxes) else None)
    checks = {"stage ids equal": all(ids_equal.values()),
              "BEV and head outputs within BEV_REL_TOL": max(
                  rels.values()) <= BEV_REL_TOL,
              "detection count": int(dets.count) == int(dets_cpu.count),
              "boxes within BOX_ABS_TOL": box_err is not None
              and box_err <= BOX_ABS_TOL,
              "finite BEV": bool(torch.isfinite(out["bev_dense"]).all())}
    if family == "TransFusion":
        checks["K-e fp32 and K-a launched, 2 and 6 a detect"] = (
            launches == {"flash_attention[fp32]": 2, "norm": 6})
    else:
        checks["no hand-written kernel on the path"] = launches == {}
    report.update(rel_l2_vs_cpu=rels, box_max_abs_vs_cpu=box_err,
                  checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"detector-zoo[{family}]: {checks}; {report}")
    return report


@contextlib.contextmanager
def zoo_gates(torch, record=None, replay=None, own=None):
    """Every torch.relu in call order: its gate (x > 0) appended to
    `record`; given `replay` (a recorded list), x · that gate instead, and
    the count of gates that x would have taken otherwise added to
    `own[0]`."""
    relu, calls = torch.relu, [0]

    def gated(x):
        i, calls[0] = calls[0], calls[0] + 1
        if record is not None:
            record.append((x.detach() > 0).cpu())
        if replay is None:
            return relu(x)
        gate = replay[i].to(x.device)
        if own is not None:
            own[0] += int(((x.detach() > 0) != gate).sum())
        return x * gate.to(x.dtype)
    torch.relu = gated
    try:
        yield
    finally:
        torch.relu = relu


@contextlib.contextmanager
def zoo_picks(torch, det, log, replay=None, own=None):
    """TransFusion's query picks appended to log["idx"] and its Hungarian
    matches to log["match"], in call order; given `replay` (another run's
    picks), the head takes those, and the count of picks it would have
    taken otherwise is added to own["queries"]."""
    from lvv_tpu_torch.models import transfusion as T
    head, calls = det.head, [0]
    plain_match = T.hungarian_one_to_one

    def forward(bev, top_idx=None):
        i, calls[0] = calls[0], calls[0] + 1
        idx = None if replay is None else replay[i].to(bev.device)
        out = type(head).forward(head, bev, idx)
        log["idx"].append(out["top_idx"].cpu())
        if replay is not None:
            peak = torch.sigmoid(out["hm"].float()).amax(-1).reshape(-1)
            mine = set(T.top_k(peak, len(idx))[1].tolist())
            own["queries"] = own.get("queries", 0) + len(
                mine - set(replay[i].tolist()))
        return out

    def match(cost, mask):
        got = plain_match(cost, mask)
        log["match"].append(got[0].cpu())
        return got
    head.forward, T.hungarian_one_to_one = forward, match
    try:
        yield
    finally:
        del head.forward
        T.hungarian_one_to_one = plain_match


def zoo_step(torch, det, batch, gates, picks=None, replay=None,
             picker=None):
    """One train step of `det` (the CLI's chain) with every ReLU gate
    recorded into `gates`, or with `replay` = (gates, picks) of another
    run taken instead; the family's picks logged into `picks` by
    `picker(log, replayed, own)` (TransFusion's queries and matches,
    `zoo_picks`, unless told) -> (metrics as floats, gradients on the
    host, the gates and {kind: picks} that differ from the replayed
    ones)."""
    from lvv_tpu_torch.train.detector import make_detector_train_step
    from lvv_tpu_torch.train.optim import detector_optimizer
    tx = detector_optimizer(DET_LR, ZOO_STEPS)
    step = make_detector_train_step(det, tx, det.det_cfg, det.vox_cfg)
    picker = picker or (lambda log, rep, own: zoo_picks(torch, det, log,
                                                        rep, own))
    own_g, own_p = [0], {}
    with contextlib.ExitStack() as ctx:
        ctx.enter_context(zoo_gates(
            torch, None if replay else gates, replay and replay[0], own_g))
        if picks is not None:
            ctx.enter_context(picker(picks, replay and replay[1], own_p))
        _, m = step((det, tx.init(dict(det.named_parameters()))), batch)
    grads = {k: None if p.grad is None else p.grad.cpu()
             for k, p in det.named_parameters()}
    return {k: float(v) for k, v in m.items()}, grads, own_g[0], own_p


def timed_train(torch, tag: str, det, batch, make_step=None) -> dict:
    """ZOO_STEPS train steps of `det` on `batch` (the CLI's chain, the
    first a warm-up; the launches of the second counted), one profiled ->
    {losses, s/step p50, samples/s, peak, device busy and idle, launches
    a step, checks: the losses finite and a step below the first}.
    `make_step(det, tx)` builds the step (default: make_detector_train_step
    on the detector's configs)."""
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.train.detector import make_detector_train_step
    from lvv_tpu_torch.train.optim import detector_optimizer
    tx = detector_optimizer(DET_LR, ZOO_STEPS + 1)
    step = (make_step(det, tx) if make_step else
            make_detector_train_step(det, tx, det.det_cfg, det.vox_cfg))
    state = (det, tx.init(dict(det.named_parameters())))
    losses, step_s = [], []
    for i in range(ZOO_STEPS):
        if i == 1:
            torch.cuda.reset_peak_memory_stats()
            kernels.launches.clear()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        if i == 1:
            launches = {k: v for k, v in kernels.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    p50 = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"{tag} profile of one train step:", flush=True)
    device = device_busy(torch, lambda: (step(state, batch),
                                         torch.cuda.synchronize()))
    del step, state
    # a step lowers the loss: on one batch at DET_LR the query head's loss
    # need not fall at every step (TransFusion's rises again by the fourth)
    checks = {"losses finite, a step below the first at batch 2": min(
        losses[1:]) < losses[0] and all(math.isfinite(x) for x in losses)}
    return dict(losses=losses, step_s=step_s, s_per_step_p50=p50,
                samples_per_s=ZOO_BATCH / p50,
                peak_mem_gib=peak / 2 ** 30, **device,
                device_idle_share=1 - device["device_busy_s"] / p50,
                launches_per_step=launches, checks=checks)


def zoo_train(torch, family: str) -> dict:
    """The family's train step at batch ZOO_BATCH (`timed_train`); for the
    ZOO_TRAIN families also a step at batch 1 on the card against the CPU
    (`zoo_against_cpu`)."""
    cfg = zoo_config(family)
    batch = detector_batch(cfg, range(ZOO_BATCH))
    det = zoo_detector(torch, family, cfg, "cuda")
    start = {k: v.clone() for k, v in det.state_dict().items()}
    report = timed_train(torch, f"detector-zoo[{family}]", det, batch)
    checks = report.pop("checks")
    launches = report["launches_per_step"]
    if family == "TransFusion":
        checks["K-e fp32 and K-a launched, 2 and 6 a sample"] = (
            launches == {"flash_attention[fp32]": 2 * ZOO_BATCH,
                         "norm": 6 * ZOO_BATCH})
    else:
        checks["no hand-written kernel on the path"] = launches == {}
    if family in ZOO_TRAIN:
        det.load_state_dict(start)
        report.update(zoo_against_cpu(torch, family, cfg, det, start,
                                      {k: v[:1] for k, v in batch.items()}))
        checks.update(report.pop("checks"))
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-zoo[{family}] train: {checks}; "
                             f"{report}")
    return report


def zoo_against_cpu(torch, family: str, cfg, det, start, one) -> dict:
    """A step of `det` (at `start`) on batch `one`, then the same step on
    the CPU from the same weights with every ReLU gate and (TransFusion)
    the query picks replayed from the card's: the loss, each group's
    gradient, the gates, picks and Hungarian matches the CPU would have
    taken otherwise."""
    tf = family == "TransFusion"
    gates = []
    logs = [{"idx": [], "match": []} for _ in range(2)] if tf else [None] * 2
    card_m, card_g, _, _ = zoo_step(torch, det, one, gates, logs[0])
    cpu = zoo_detector(torch, family, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    t0 = time.perf_counter()
    cpu_m, cpu_g, gates_differ, picks_differ = zoo_step(
        torch, cpu, one, None, logs[1],
        replay=(gates, logs[0]["idx"] if tf else None))
    cpu_s = time.perf_counter() - t0
    # TransFusion's heatmap only picks the queries: no gradient reaches it
    # (JAX's is zero)
    no_grad = sorted(k for k, g in card_g.items() if g is None)
    groups = collections.defaultdict(list)
    for name in cpu_g:
        if name not in no_grad:
            groups[name.split(".")[0]].append(name)
    rel = group_rel_l2(torch, dict(groups), card_g, cpu_g)
    loss_rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    checks = {"loss card vs CPU within DET_LOSS_TOL": loss_rel
              <= DET_LOSS_TOL,
              "group gradients within DET_GRAD_TOL": all(
                  v is not None and v <= DET_GRAD_TOL for v in rel.values()),
              "gradients where the loss reaches, on both devices": (
                  no_grad == (["head.hm.bias", "head.hm.kernel"] if tf
                              else [])
                  and no_grad == sorted(k for k, g in cpu_g.items()
                                        if g is None))}
    report = dict(loss_card=card_m["loss"], loss_cpu=cpu_m["loss"],
                  loss_rel=loss_rel, group_grad_rel_l2=rel,
                  relu_entries=sum(int(g.numel()) for g in gates),
                  cpu_own_gates_differing=gates_differ, cpu_step_s=cpu_s,
                  checks=checks)
    if tf:
        report["cpu_own_picks_differing"] = picks_differ.get("queries", 0)
        report["hungarian_matches_differing"] = sum(
            int((a != b).sum()) for a, b in zip(*(g["match"] for g in logs)))
    print(f"detector-zoo[{family}] train: batch 1 card vs CPU on the card's "
          f"gates: loss {loss_rel:.2e}, groups {rel}; the CPU's own gates "
          f"differ at {gates_differ} of {report['relu_entries']}", flush=True)
    return report


def zoo_tiny_overrides() -> list:
    """--set pairs that cut a preset to tiny_config()'s sizes."""
    import dataclasses
    from lvv_tpu_torch import tiny_config
    cfg = tiny_config()
    det = dataclasses.asdict(cfg.model.voxelnext)
    pairs = [f"voxelize.{k}={json.dumps(v)}"
             for k, v in dataclasses.asdict(cfg.voxelize).items()]
    pairs += [f"model.voxelnext.{k}={json.dumps(det[k])}"
              for k in ("channels", "out_channels", "num_classes",
                        "class_names", "nms_pre_max", "nms_post_max")]
    return [x for p in pairs for x in ("--set", p)]


def zoo_cli(torch, family: str = "TransFusion", preset: str | None = None,
            out_dir=ZOO_DIR, loss_key: str = "tf_cls_loss") -> dict:
    """`python -m lvv_tpu_torch.tools.train_detector --config PRESET
    --synthetic --steps 2 --save-every 1` (TransFusion's preset unless
    told) at tiny_config()'s sizes (--set) as a subprocess on the card:
    exit 0, the preset's family (its `_detector` key) with its loss term
    `loss_key` in the log, both checkpoints, the last restored into a new
    detector bit-equal."""
    from lvv_tpu_torch import config as C
    from lvv_tpu_torch.models.registry import build_detector
    from lvv_tpu_torch.train.checkpoints import CheckpointManager
    shutil.rmtree(out_dir, ignore_errors=True)
    preset = preset or ZOO_PRESETS[family]
    sets = zoo_tiny_overrides()
    argv = ["--config", preset, "--synthetic", "--steps", "2",
            "--save-every", "1", "--out", str(out_dir / "cli"), *sets]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lvv_tpu_torch.tools.train_detector", *argv],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    sub_s = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"train_detector exit {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    final = json.loads(lines[-1])
    cfg = C.load(C.VQAConfig, REPO / preset, sets[1::2])
    fresh = build_detector(family, cfg.model.voxelnext, cfg.voxelize,
                           device="cuda", seed=7)
    ckpt = out_dir / "cli" / "checkpoints"
    CheckpointManager(ckpt).restore("step_2", fresh)
    saved = torch.load(ckpt / "step_2" / "state" / "state.pt",
                       map_location="cuda")
    checks = {"exit 0, 2 log lines, final line": final["steps"] == 2
              and [ln.split()[0] for ln in lines[:2]] == ["[0]", "[1]"]
              and math.isfinite(final["final_loss"])
              and loss_key in lines[0],
              "checkpoints step_1, step_2": all(
                  (ckpt / s).is_dir() for s in ("step_1", "step_2")),
              "reloads bit-equal": set(saved) == set(fresh.state_dict())
              and all(torch.equal(saved[k], v)
                      for k, v in fresh.state_dict().items())}
    if not all(checks.values()):
        raise AssertionError(f"train_detector CLI ({preset}): {checks}; "
                             f"{proc.stdout[-1500:]}")
    shutil.rmtree(out_dir)
    return dict(checks=checks, subprocess_s=sub_s, log=lines)


def run_detector_zoo(torch) -> dict:
    """The nuScenes dense-BEV families on the card: each one's detect at
    its preset's width against the CPU, each one's train step (TransFusion's
    and SECOND's also against the CPU), and the train CLI on TransFusion's
    preset. `launches`: TransFusion's detect's (the path's kernels)."""
    report = {}
    for family in ZOO_PRESETS:
        report[f"detect[{family}]"] = zoo_detect(torch, family)
        torch.cuda.empty_cache()
    for family in ZOO_PRESETS:
        report[f"train[{family}]"] = zoo_train(torch, family)
        torch.cuda.empty_cache()
    report["cli"] = zoo_cli(torch)
    report["launches"] = report["detect[TransFusion]"]["launches"]
    return report


# ------------------------------------------------------- detector-camera --

# The camera-input families at their presets' full width (fp32, TF32 off,
# seeded weights): BEVFusion (Swin-T over six 256 x 704 views, the LSS
# lift-splat onto the LiDAR trunk's 180 x 180 BEV, ConvFuser, the 2D trunk
# and TransFusion's head) on lidar_cloud's 300,000-point surface cloud,
# and CaDDN on one 375 x 1242 image; each one's detect split by stage
# (p50 of 3 after a warm-up), one profiled call, and the same call through
# the port on the CPU from the same weights, held as detector-zoo holds
# its families (BEV_REL_TOL, BOX_ABS_TOL; BEVFusion's LiDAR stage ids and
# depth maps equal: the projection is elementwise fp32 in one order on
# both devices). bev_pool's 1.49M frustum points add into their bins with
# float atomics on the card, in another order than the CPU's: a few ulps
# of each bin, well inside BEV_REL_TOL. The heads' biases are set as
# ZOO_PRESETS' note says (BEVFusion's as TransFusion's, CaDDN's as
# SECOND's), so that the decodes keep boxes away from NMS's threshold.
CAMERA_PRESETS = {"BEVFusion": "configs/nuscenes_bevfusion.json",
                  "CaDDN": "configs/kitti_caddn.json"}
# nuScenes' six cameras: yaws (degrees, front first), their 256 x 704 crop
# (BEVFusion's image_hw) with a focal length of that crop's scale, 1.5 m
# above the LiDAR origin
NUSCENES_CAM_YAWS = (0.0, -55.0, 55.0, -110.0, 110.0, 180.0)
NUSCENES_CAM = dict(hw=(256, 704), focal=560.0, height=1.5)
# KITTI's published image size and calibration of its 2011_09_26 drives
# (P2's focal lengths and principal point; Tr_velo_to_cam)
KITTI_HW = (375, 1242)
KITTI_P2 = (721.5377, 721.5377, 609.5593, 172.854)
KITTI_VELO_TO_CAM = ((7.533745e-03, -9.999714e-01, -6.166020e-04,
                      -4.069766e-03),
                     (1.480249e-02, 7.280733e-04, -9.998902e-01,
                      -7.631618e-02),
                     (9.998621e-01, 7.523790e-03, 1.480755e-02,
                      -2.717806e-01))
# K-a's launches in BEVFusion's Swin-T at 6 x 256 x 704 (widths that are a
# multiple of 128): (where, rows, width, launches a detect); the query
# head adds its 6 at [200, 128] and K-e fp32's 2 (kernel_cases)
SWIN_NORMS = (("downsample0", 6 * 32 * 88, 384, 1),
              ("downsample1", 6 * 16 * 44, 768, 1),
              ("stage 2 and out_norm2", 6 * 16 * 44, 384, 13),
              ("downsample2", 6 * 8 * 22, 1536, 1),
              ("stage 3 and out_norm3", 6 * 8 * 22, 768, 5))


def camera_rig(torch):
    """BEVFusion's six views: (intrinsics [6, 3, 3], cam2lidar [6, 4, 4])
    (camera x right, y down, z forward)."""
    import numpy as np
    h, w = NUSCENES_CAM["hw"]
    f = NUSCENES_CAM["focal"]
    ks, ms = [], []
    for deg in NUSCENES_CAM_YAWS:
        yaw = math.radians(deg)
        m = np.eye(4)
        m[:3, 0] = (math.sin(yaw), -math.cos(yaw), 0.0)
        m[:3, 1] = (0.0, 0.0, -1.0)
        m[:3, 2] = (math.cos(yaw), math.sin(yaw), 0.0)
        m[:3, 3] = (0.0, 0.0, NUSCENES_CAM["height"])
        ks.append([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
        ms.append(m)
    return (torch.tensor(np.asarray(ks), dtype=torch.float32),
            torch.tensor(np.asarray(ms), dtype=torch.float32))


def camera_detector(torch, family: str, cfg, device):
    """The family at its preset's width with seeded weights and the biases
    CAMERA_PRESETS' note sets."""
    from lvv_tpu_torch.models.registry import build_detector
    det = build_detector(family, cfg.model.voxelnext, cfg.voxelize,
                         device=device, seed=0)
    head = det.head
    with torch.no_grad():
        head.cls.bias.fill_(-1.0)
        if family == "BEVFusion":
            head.box.bias[3:6] = -1.5
            head.box.bias[7] = 4.0
        else:
            head.box.kernel.mul_(1e-3)
            head.box.bias.view(-1, 7)[:, 3:6] = -3.0
    return det


def camera_inputs(torch, family: str, cfg, device) -> tuple:
    """The family's forward arguments on `device`, from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    if family == "BEVFusion":
        pts, n = lidar_cloud(cfg)
        k, m = camera_rig(torch)
        images = rng.standard_normal((len(NUSCENES_CAM_YAWS), 3,
                                      *NUSCENES_CAM["hw"]), np.float32)
        args = (torch.from_numpy(pts), n, torch.from_numpy(images), k, m)
    else:
        fx, fy, cx, cy = KITTI_P2
        k = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        l2c = torch.eye(4)
        l2c[:3] = torch.tensor(KITTI_VELO_TO_CAM)
        image = rng.standard_normal((3, *KITTI_HW), np.float32)
        args = (torch.from_numpy(image), k, l2c)
    return tuple(a.to(device) if hasattr(a, "to") else a for a in args)


def camera_derived_launches(det) -> dict:
    """The hand-written kernels a detect launches, from the module tree:
    K-a for every `layers.LayerNorm` of a width that is a multiple of 128
    (each runs once), K-e fp32 for each query-head layer whose
    cross-attention reaches the flash rule's 1,024 keys."""
    from lvv_tpu_torch.models.layers import LayerNorm
    from lvv_tpu_torch.models.transfusion import TransFusionHead
    out = {}
    norms = sum(1 for m in det.modules() if isinstance(m, LayerNorm)
                and m.scale.numel() % 128 == 0)
    if norms:
        out["norm"] = norms
    if isinstance(getattr(det, "head", None), TransFusionHead):
        h, w = det.vtransform.bev_hw
        if h * w >= 1024:
            out["flash_attention[fp32]"] = det.head.num_layers
    return out


def camera_staged(torch, det, args, trace=None) -> tuple:
    """One call stage by stage (det.stages(), then decode), each ending in
    a synchronise where on the card -> (seconds by stage, the state, the
    forward's dict, detections)."""
    sync = torch.cuda.synchronize if det.device.type == "cuda" \
        else (lambda: None)
    secs = {}
    with torch.no_grad():
        s = det.inputs(*args)
        for name, fn in det.stages(trace):
            t0 = time.perf_counter()
            fn(s)
            sync()
            secs[name] = time.perf_counter() - t0
        out = det.outputs(s)
        t0 = time.perf_counter()
        dets = det.decode(out)
        sync()
        secs["decode"] = time.perf_counter() - t0
    return secs, s, out, dets


def camera_outputs(out) -> dict:
    """The forward's float tensors to compare."""
    got = {k: v for k, v in out.items()
           if k in ("bev_dense", "cam_bev", "lidar_bev", "depth_logits")}
    got.update({f"preds.{k}": v for k, v in out["preds"].items()
                if v.is_floating_point()})
    return got


def camera_detect(torch, family: str) -> dict:
    """The family's detect on the card, timed and profiled, against the
    same call through the port on the CPU."""
    from lvv_tpu_torch import config as C
    from lvv_tpu_torch import kernels
    cfg = C.load(C.VQAConfig, REPO / CAMERA_PRESETS[family])
    det = camera_detector(torch, family, cfg, "cuda")
    args = camera_inputs(torch, family, cfg, "cuda")
    camera_staged(torch, det, args)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    trace = []
    stages = [camera_staged(torch, det, args, trace)]
    launches = {k: v for k, v in kernels.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    stages += [camera_staged(torch, det, args) for _ in range(2)]
    totals = sorted(sum(x[0].values()) for x in stages)
    stage_p50 = {k: sorted(x[0][k] for x in stages)[1]
                 for k in stages[0][0]}
    _, state, out, dets = stages[0]
    del stages[1:]
    print(f"detector-camera[{family}] profile of one call:", flush=True)
    device = device_busy(torch, lambda: camera_staged(torch, det, args))
    cpu = camera_detector(torch, family, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    args_cpu = camera_inputs(torch, family, cfg, "cpu")
    trace_cpu = []
    t0 = time.perf_counter()
    _, state_cpu, out_cpu, dets_cpu = camera_staged(torch, cpu, args_cpu,
                                                    trace_cpu)
    cpu_s = time.perf_counter() - t0
    report = dict(call_s=totals, call_p50_s=totals[1],
                  stage_p50_s=stage_p50, peak_mem_gib=peak / 2 ** 30,
                  **device,
                  device_idle_share=1 - device["device_busy_s"] / totals[1],
                  detections=int(dets.count), cpu_call_s=cpu_s,
                  launches=launches)
    checks = {}
    if family == "BEVFusion":
        derived = camera_derived_launches(det)
        ids_equal = {name: torch.equal(a.ids.cpu(), b.ids)
                     for (name, a), (_, b) in zip(trace, trace_cpu)}
        depth = state["depth_maps"]
        hf, wf = state["feats"].shape[2:]
        ids, ok = det.vtransform.bev_ids(hf, wf, state["intrinsics"],
                                         state["cam2lidar"])
        ids_cpu, ok_cpu = cpu.vtransform.bev_ids(
            hf, wf, state_cpu["intrinsics"], state_cpu["cam2lidar"])
        report.update(
            views=list(args[2].shape), bev_shape=list(out["bev_dense"].shape),
            grid=list(det.voxel_grid().grid_size),
            depth_pixels_per_view=(depth > 0).sum((1, 2, 3)).tolist(),
            frustum_points=int(ok.numel()),
            frustum_points_in_bev=int(ok.sum()),
            frustum_bins_differing_cpu=int(
                ((ids != ids_cpu.cuda()) & ok).sum()
                + (ok != ok_cpu.cuda()).sum()),
            stage_ids_equal_cpu=ids_equal, derived_launches=derived)
        picks, picks_cpu = (o["preds"]["top_idx"].cpu()
                            for o in (out, out_cpu))
        differ = len(set(picks_cpu.tolist()) - set(picks.tolist()))
        report["query_picks_differing"] = differ
        if differ:      # the card's head again, on the CPU's picks
            with torch.no_grad():
                out = dict(out, preds=det.head(state["bev_dense"],
                                               picks_cpu.cuda()))
                dets = det.decode(out)
        checks.update({
            "LiDAR stage ids equal": all(ids_equal.values()),
            "depth maps equal": torch.equal(depth.cpu(),
                                            state_cpu["depth_maps"]),
            "every view has depth pixels": bool(
                ((depth > 0).sum((1, 2, 3)) > 0).all()),
            "K-a and K-e fp32 launched as derived, 27 and 2": (
                launches == derived
                == {"norm": 27, "flash_attention[fp32]": 2}),
            "Swin's K-a cases add up to its launches": sum(
                x[3] for x in SWIN_NORMS) + 6 == derived.get("norm")})
    else:
        report.update(image=list(args[0].shape),
                      bev_shape=list(out["bev_dense"].shape),
                      lattice_points=int(det.lattice[..., 0].numel()),
                      anchors=int(out["anchors"].shape[0]))
        checks["no hand-written kernel on the path"] = (
            launches == {} == camera_derived_launches(det))
    rels = {k: rel_l2(v.float().cpu(), camera_outputs(out_cpu)[k].float())
            for k, v in camera_outputs(out).items()}
    boxes, boxes_cpu = by_position(dets), by_position(dets_cpu)
    box_err = (float(abs(boxes - boxes_cpu).max())
               if boxes.shape == boxes_cpu.shape and len(boxes) else None)
    checks.update({
        "BEVs and head outputs within BEV_REL_TOL": max(
            rels.values()) <= BEV_REL_TOL,
        "detection count": int(dets.count) == int(dets_cpu.count),
        "boxes within BOX_ABS_TOL": box_err is not None
        and box_err <= BOX_ABS_TOL,
        "finite BEV": bool(torch.isfinite(out["bev_dense"]).all())})
    report.update(rel_l2_vs_cpu=rels, box_max_abs_vs_cpu=box_err,
                  checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"detector-camera[{family}]: {checks}; "
                             f"{report}")
    return report


def run_detector_camera(torch) -> dict:
    """BEVFusion and CaDDN on the card at their presets' width against the
    CPU. `launches`: BEVFusion's detect's (the path's kernels)."""
    report = {}
    for family in CAMERA_PRESETS:
        report[f"detect[{family}]"] = camera_detect(torch, family)
        torch.cuda.empty_cache()
    report["launches"] = report["detect[BEVFusion]"]["launches"]
    return report


# ----------------------------------------------------- detector-two-stage --

TWO_STAGE_DIR = REPO / "build" / "detector_two_stage"
# The two-stage families at their KITTI presets' full width (fp32, TF32
# off, seeded weights: channels 16-128, a 1408 x 1600 x 40 grid of 0.05 x
# 0.05 x 0.1 m voxels, 40,000 voxels, 1,000 boxes before NMS and 83 after)
# on a seeded surface cloud of TWO_STAGE_POINTS points (about one HDL-64E
# sweep; surface_cloud's scene over +-38 m moved into KITTI's range x in
# [0, 70.4], zero-padded to the presets' 300,000 rows): each detect split
# by stage (p50 of 3 after a warm-up), one profiled call, and the same call
# through the port on the CPU from the same weights (the sparse stages'
# ids equal; the BEV, RPN and RoI outputs within BEV_REL_TOL relative L2;
# detections as detector-zoo holds them). The first stage's anchor head
# takes a class bias of -1 (scores above the 0.1 threshold) and a box
# kernel shrunk by 1e-3 (boxes the size of their anchors, so that the
# second stage pools over whole cars); PointRCNN's point head takes the
# heading's cosine bias of 4. The discrete picks are recorded on the card:
# the CPU's own farthest-point samples, ball-query lists and kNN indices
# must equal them, and the RPN's top-K and NMS keeps, where near-equal
# scores may order apart, are replayed on the CPU, which counts the picks
# it would have made otherwise, as detector-zoo replays TransFusion's
# queries.
TWO_STAGE_PRESETS = {"PVRCNN": "configs/kitti_pv_rcnn.json",
                     "PVRCNNPlusPlus": "configs/kitti_pv_rcnn_plusplus.json",
                     "PartA2": "configs/kitti_parta2.json",
                     "VoxelRCNN": "configs/kitti_voxel_rcnn_car.json",
                     "SECONDNetIoU": "configs/kitti_second_iou.json",
                     "PointRCNN": "configs/kitti_pointrcnn.json"}
TWO_STAGE_POINTS = 120000
KITTI_X0 = 35.2          # the scene's centre moved to the middle of x
# these also train at batch 1 on the card against the CPU, every ReLU
# gate and pick replayed (loss within DET_LOSS_TOL, each group within
# DET_GRAD_TOL)
TWO_STAGE_TRAIN = ("PVRCNN", "PointRCNN")
# the families whose detect also times the second stage's ops alone (the
# FPS and ball query at the cloud's shapes are the same op for every
# family)
TWO_STAGE_OPS = ("PVRCNN", "PointRCNN")
# the modules whose picks two_stage_picks records and replays, and the
# functions each takes them from
PICK_SITES = (("pointnet2", ("farthest_point_sample", "ball_query", "knn")),
              ("pv_rcnn", ("farthest_point_sample", "ball_query")),
              ("pv_rcnn_pp", ("farthest_point_sample", "ball_query")),
              ("anchor_head", ("top_k", "nms")),
              ("point_rcnn", ("nms",)))
SAMPLING = ("farthest_point_sample", "ball_query", "knn")
SAMPLES_BY_FAMILY = {"PVRCNN": SAMPLING[:2], "PVRCNNPlusPlus": SAMPLING[:2],
                     "PointRCNN": SAMPLING}


def kitti_cloud(cfg, seed: int = 0, boxes=None):
    """(points [max_points, 4] float32, n): TWO_STAGE_POINTS points of
    surface_cloud's scene over +-38 m, ground at -1.7 m, moved by KITTI_X0
    along x (its vehicles' boxes into `boxes`, moved alike)."""
    import numpy as np
    found = []
    pts = surface_cloud(np.random.default_rng(seed), TWO_STAGE_POINTS, 38.0,
                        z0=-1.7, z1=0.9, boxes=found)
    pts[:, 0] += KITTI_X0
    if boxes is not None:
        boxes += [[b[0] + KITTI_X0, *b[1:]] for b in found]
    out = np.zeros((cfg.voxelize.max_points, 4), np.float32)
    out[:len(pts)] = pts
    return out, len(pts)


def two_stage_config(family: str):
    from lvv_tpu_torch import config as C
    return C.load(C.VQAConfig, REPO / TWO_STAGE_PRESETS[family])


def two_stage_detector(torch, family: str, cfg, device):
    """The family at its preset's width with seeded weights and the biases
    TWO_STAGE_PRESETS' note sets."""
    from lvv_tpu_torch.models.registry import build_detector
    det = build_detector(family, cfg.model.voxelnext, cfg.voxelize,
                         device=device, seed=0)
    with torch.no_grad():
        if family == "PointRCNN":
            det.point_head.box.bias[7] = 4.0
        else:
            head = {"PartA2": lambda: det.head,
                    "SECONDNetIoU": lambda: det.second.head}.get(
                        family, lambda: det.rpn)()
            head.cls.bias.fill_(-1.0)
            head.box.kernel.mul_(1e-3)
    return det


@contextlib.contextmanager
def two_stage_picks(torch, log, replay=None, own=None, sites=PICK_SITES):
    """Every call of `sites`' functions (PICK_SITES unless told): its
    index outputs appended to
    log[name] (on the host) in call order; given `replay` (another run's
    log), the count of entries that differ from it is added to own[name],
    and the RPN's top-K and NMS calls return the replayed picks instead
    (their scores taken at the replayed indices). The sampling ops'
    (SAMPLING) own picks are kept: they must equal the replayed ones."""
    import importlib
    from lvv_tpu_torch.ops import nms as N
    from lvv_tpu_torch.ops import sampling as S
    plain = {"farthest_point_sample": S.farthest_point_sample,
             "ball_query": S.ball_query, "knn": S.knn, "top_k": N.top_k,
             "nms": N.nms}
    calls = collections.Counter()

    def wrap(name):
        fn = plain[name]

        def picked(*args, **kw):
            got = fn(*args, **kw)
            mine = got if isinstance(got, tuple) else (got,)
            i, calls[name] = calls[name], calls[name] + 1
            if replay is None:
                log.setdefault(name, []).append(tuple(t.cpu() for t in mine))
                return got
            want = tuple(t.to(mine[0].device) for t in replay[name][i])
            own[name] = own.get(name, 0) + sum(
                int((a != b).sum()) for a, b in zip(mine, want)
                if not a.is_floating_point())
            if name in SAMPLING:
                return got
            if name == "top_k":
                return args[0][want[1]], want[1]
            scores = args[1]                               # nms
            if kw.get("valid") is not None:
                scores = torch.where(kw["valid"], scores, -torch.inf)
            keep = want[0]
            return keep, want[1], torch.where(
                keep >= 0, scores[keep.clamp_min(0).long()], -torch.inf)
        return picked
    patched = []
    for mod, names in sites:
        m = importlib.import_module(f"lvv_tpu_torch.models.{mod}")
        for name in names:
            patched.append((m, name, getattr(m, name)))
            setattr(m, name, wrap(name))
    try:
        yield
    finally:
        for m, name, fn in patched:
            setattr(m, name, fn)


def sampling_checks(family: str, picks: dict, own: dict) -> dict:
    """The sampling ops ran where the family has them, and the CPU's own
    picks equal the card's."""
    ran = {k for k in SAMPLING if picks.get(k)}
    return {"sampling ops ran": ran == set(SAMPLES_BY_FAMILY.get(family, ())),
            "the CPU's own FPS / ball-query / kNN picks equal the card's":
            all(own.get(k, 0) == 0 for k in SAMPLING)}


def two_stage_outputs(out) -> dict:
    """The forward's float tensors to compare: the BEV, the RPN's or
    point head's outputs, the keypoint features, the pooled RoI features
    and the RoI head's outputs."""
    got = {k: out[k] for k in ("bev_dense", "keypoint_features", "pooled",
                               "iou_logits", "point_features") if k in out}
    for group in ("rpn_preds", "preds", "point_preds", "roi_preds"):
        got.update({f"{group}.{k}": v for k, v in out.get(group, {}).items()
                    if v.is_floating_point()})
    return got


def pooled_cells_filled(det, out, dets) -> float:
    """The share of the kept RoIs' pooled cells (grid³ a RoI; SECOND-IoU's
    BEV samples grid²) whose feature vector is not all zero."""
    head = det.iou_head if hasattr(det, "iou_head") else det.roi_head
    cells = head.grid ** (2 if hasattr(det, "iou_head") else 3)
    pooled = out["pooled"]
    kept = pooled.reshape(pooled.shape[0], cells, -1)[dets.labels >= 0]
    return float(kept.ne(0).any(-1).float().mean())


def two_stage_ops(torch, det, family, pts, n) -> dict:
    """The second stage's ops alone at this family's shapes on the card,
    ms a call (`timed_ms`, 3 calls): farthest-point sampling and the ball
    query over the raw cloud; PointRCNN's later FPS levels, its kNN from
    the cloud to 512 samples and its RoI-aware pool of 64 RoIs."""
    from lvv_tpu_torch.ops import pool, sampling
    valid = torch.arange(pts.shape[0], device=pts.device) < n
    xyz = pts[:, :3].contiguous()
    kp = xyz[sampling.farthest_point_sample(xyz, 512, valid)]
    out = {"fps_512_of_cloud_ms": timed_ms(
        lambda: sampling.farthest_point_sample(xyz, 512, valid), 3),
        "ball_query_512x16_of_cloud_ms": timed_ms(
            lambda: sampling.ball_query(kp, xyz, 0.8, 16, valid), 3)}
    if family == "PointRCNN":
        out["fps_levels_ms"] = [timed_ms(
            lambda m=m, k=k: sampling.farthest_point_sample(xyz[:m], k), 3)
            for m, k in ((512, 128), (128, 32), (32, 16))]
        out["knn_cloud_to_512_ms"] = timed_ms(
            lambda: sampling.knn(xyz, kp, 3), 3)
        with torch.no_grad():
            s = det.stages()
            feats = s[0][1](pts, n)["point_features"]
            rois = torch.cat([kp[:64], torch.full_like(kp[:64], 2.0),
                              torch.zeros_like(kp[:64, :1])], 1)
        out["roiaware_pool_64_rois_ms"] = timed_ms(
            lambda: pool.roiaware_pool3d(xyz, feats, rois, 4,
                                         valid_points=valid), 3)
    return out


def two_stage_detect(torch, family: str) -> dict:
    """The family's detect on the card, timed and profiled, against the
    same call through the port on the CPU with the card's picks
    replayed."""
    cfg = two_stage_config(family)
    pts_np, n = kitti_cloud(cfg)
    det = two_stage_detector(torch, family, cfg, "cuda")
    pts = torch.from_numpy(pts_np).cuda()
    picks = {}
    report, out, dets, trace = timed_detect(
        torch, f"detector-two-stage[{family}]", det, pts, n,
        lambda: two_stage_picks(torch, picks))
    ops = (two_stage_ops(torch, det, family, pts, n)
           if family in TWO_STAGE_OPS else None)
    cpu = two_stage_detector(torch, family, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    trace_cpu, own = [], {}
    t0 = time.perf_counter()
    with two_stage_picks(torch, {}, picks, own):
        _, out_cpu, dets_cpu = zoo_staged(torch, cpu,
                                          torch.from_numpy(pts_np), n,
                                          trace_cpu)
    cpu_s = time.perf_counter() - t0
    ids_equal = {name: torch.equal(a.ids.cpu(), b.ids)
                 for (name, a), (_, b) in zip(trace, trace_cpu)}
    rels = {k: rel_l2(v.float().cpu(), two_stage_outputs(out_cpu)[k].float())
            for k, v in two_stage_outputs(out).items()}
    boxes, boxes_cpu = by_position(dets), by_position(dets_cpu)
    box_err = (float(abs(boxes - boxes_cpu).max())
               if boxes.shape == boxes_cpu.shape and len(boxes) else None)
    report.update(cpu_call_s=cpu_s, stage_ids_equal_cpu=ids_equal,
                  picks={k: sum(int(t[0].numel()) for t in v)
                         for k, v in picks.items()},
                  cpu_own_picks_differing=own, ops_ms=ops,
                  pooled_cells_filled=pooled_cells_filled(det, out, dets),
                  rel_l2_vs_cpu=rels, box_max_abs_vs_cpu=box_err)
    if "bev_dense" in out:
        report["bev_shape"] = list(out["bev_dense"].shape)
    checks = {"stage ids equal": bool(trace) == (family != "PointRCNN")
              and all(ids_equal.values()),
              "outputs within BEV_REL_TOL": max(rels.values())
              <= BEV_REL_TOL,
              "detection count": int(dets.count) == int(dets_cpu.count)
              and int(dets.count) > 0,
              "boxes within BOX_ABS_TOL": box_err is not None
              and box_err <= BOX_ABS_TOL,
              "finite detections": bool(torch.isfinite(dets.boxes).all()
                                        and torch.isfinite(dets.scores).all()),
              "no hand-written kernel on the path":
              report["launches"] == {},
              **sampling_checks(family, picks, own)}
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-two-stage[{family}]: {checks}; "
                             f"{report}")
    return report


def two_stage_train(torch, family: str) -> dict:
    """The family's train step at batch ZOO_BATCH (`timed_train`); for
    TWO_STAGE_TRAIN also a step at batch 1 on the card against the CPU."""
    cfg = two_stage_config(family)
    batch = detector_batch(cfg, range(ZOO_BATCH), kitti_cloud)
    det = two_stage_detector(torch, family, cfg, "cuda")
    start = {k: v.clone() for k, v in det.state_dict().items()}
    report = timed_train(torch, f"detector-two-stage[{family}]", det, batch)
    checks = report.pop("checks")
    checks["no hand-written kernel on the path"] = (
        report["launches_per_step"] == {})
    if family in TWO_STAGE_TRAIN:
        det.load_state_dict(start)
        report.update(two_stage_against_cpu(
            torch, family, cfg, det, start,
            {k: v[:1] for k, v in batch.items()}))
        checks.update(report.pop("checks"))
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-two-stage[{family}] train: "
                             f"{checks}; {report}")
    return report


def two_stage_against_cpu(torch, family, cfg, det, start, one,
                          picker=None, tag=None) -> dict:
    """A step of `det` (at `start`) on batch `one`, then the same step on
    the CPU from the same weights with every ReLU gate, top-K pick and
    NMS keep replayed from the card's (`picker(log, replayed, own)`:
    two_stage_picks unless told; its sampling picks must equal the
    card's): the loss, each top-level group's gradient, and the gates and
    picks the CPU would have taken otherwise."""
    gates, picks = [], {}
    picker = picker or (lambda log, replayed, own: two_stage_picks(
        torch, log, replayed, own))
    card_m, card_g, _, _ = zoo_step(torch, det, one, gates, picks,
                                    picker=picker)
    cpu = two_stage_detector(torch, family, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    t0 = time.perf_counter()
    cpu_m, cpu_g, gates_differ, picks_differ = zoo_step(
        torch, cpu, one, None, {}, replay=(gates, picks), picker=picker)
    cpu_s = time.perf_counter() - t0
    no_grad = sorted(k for k, g in card_g.items() if g is None)
    groups = collections.defaultdict(list)
    for name in cpu_g:
        if name not in no_grad:
            groups[name.split(".")[0]].append(name)
    rel = group_rel_l2(torch, dict(groups), card_g, cpu_g)
    loss_rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    checks = {"loss card vs CPU within DET_LOSS_TOL": loss_rel
              <= DET_LOSS_TOL,
              "group gradients within DET_GRAD_TOL": all(
                  v is not None and v <= DET_GRAD_TOL for v in rel.values()),
              "the same parameters without a gradient on both devices":
              no_grad == sorted(k for k, g in cpu_g.items() if g is None),
              **sampling_checks(family, picks, picks_differ)}
    report = dict(loss_card=card_m["loss"], loss_cpu=cpu_m["loss"],
                  loss_rel=loss_rel, group_grad_rel_l2=rel,
                  relu_entries=sum(int(g.numel()) for g in gates),
                  cpu_own_gates_differing=gates_differ,
                  cpu_own_picks_differing=picks_differ, cpu_step_s=cpu_s,
                  no_gradient=no_grad, checks=checks)
    print(f"{tag or f'detector-two-stage[{family}]'} train: batch 1 card "
          f"vs CPU on the "
          f"card's gates and picks: loss {loss_rel:.2e}, groups {rel}; the "
          f"CPU's own gates differ at {gates_differ} of "
          f"{report['relu_entries']}, picks {picks_differ}", flush=True)
    return report


def run_detector_two_stage(torch) -> dict:
    """The two-stage families on the card: each one's detect at its KITTI
    preset's width against the CPU, each one's train step (PV-RCNN's and
    PointRCNN's also against the CPU), and the train CLI on PV-RCNN's
    preset. `launches`: none of them launches a hand-written kernel."""
    report = {}
    for family in TWO_STAGE_PRESETS:
        report[f"detect[{family}]"] = two_stage_detect(torch, family)
        torch.cuda.empty_cache()
    for family in TWO_STAGE_PRESETS:
        report[f"train[{family}]"] = two_stage_train(torch, family)
        torch.cuda.empty_cache()
    report["cli"] = zoo_cli(torch, "PVRCNN", TWO_STAGE_PRESETS["PVRCNN"],
                            TWO_STAGE_DIR, "roi_cls_loss")
    report["launches"] = {}
    return report


# ------------------------------------------------------- detector-waymo --

# PillarNet and DSVT (pillar and voxel) at their Waymo presets' full width
# (fp32, TF32 off, seeded weights) on waymo_cloud's scene. Each detect is
# split by stage (the VFE or voxelizer, the sparse 2D trunk or the DSVT
# stages, the z-collapse and BEV trunk, the head, decode + NMS; p50 of 3
# after a warm-up), one profiled call, and the same call through the port
# on the CPU from the same weights: the voxel or pillar ids and each
# point's voxel equal, every DSVT block's (set_row, col, ok) tables for both
# axes equal, the sparse stages' ids equal, the BEV and head outputs within
# BEV_REL_TOL, the detections as detector-zoo holds them. With telemetry on,
# every capacity-bound op (the VFE, the set partitions, the sparse convs,
# the collapse) must drop nothing; the sets each block uses are reported
# against max_sets, and the host planner's count (`plan_max_sets`, bucket 1)
# on each stage's input must fit. The trap: DSVT with its second layer taken
# over the y-sorted sets again (the rotation dropped) must miss BEV_REL_TOL.
# Each preset trains at batch ZOO_BATCH (timed_train), then one step at
# batch 1 on the card and on the CPU with every ReLU gate and every segment
# max's winners (the VFE's, ZPoolAttention's query) replayed from the card's
# (loss within DET_LOSS_TOL, each group's gradient within DET_GRAD_TOL);
# that step is taken on a smaller cloud at capacities cut to it
# (WAYMO_CPU_STEP), so that the CPU's backward stays short. No hand-written kernel lies on these
# paths: DSVT's attention has 36 or 48 keys (or ZPoolAttention's bias), the
# plain path under the JAX package's rule (checked: no launches). The
# heatmap bias is -1 and the size bias makes boxes smaller than a decode
# cell (-1.5 at PillarNet's 0.8 m cells, -2.5 at DSVT's 0.32 m), the
# heading's cosine bias 4, as ZOO_PRESETS' note explains.
WAYMO_PRESETS = {"waymo_pillarnet": "configs/waymo_pillarnet.json",
                 "waymo_dsvt_pillar": "configs/waymo_dsvt_pillar.json",
                 "waymo_dsvt_voxel": "configs/waymo_dsvt_voxel.json"}
# waymo_cloud: a 64-beam spinning LiDAR 2.1 m above the ground plane, its
# beams at Waymo's top LiDAR's elevations (+2.4 to -17.6 degrees), cast onto
# the ground, WAYMO_VEHICLES vehicle boxes and WAYMO_WALLS walls within
# +-70 m; WAYMO_AZIMUTHS columns give ~180,000 returns inside the +-75 m
# range (the points land in rings, as a real sweep's do: ~18,000 pillars at
# 0.32 m, where a uniform disc of as many points fills ~67,000)
WAYMO_POINTS = 180000
WAYMO_AZIMUTHS = 3300
WAYMO_ELEVATION_DEG = (2.4, -17.6)
WAYMO_SENSOR_Z = 2.1
WAYMO_VEHICLES, WAYMO_WALLS = 32, 16
# each preset's batch-1 card-vs-CPU step: a 30,000-point cloud, at the
# preset's widths with capacities cut to that cloud (its tensors are sized
# by capacity, not by points: at the voxel preset's 300,000 rows, 150,000
# voxels and 5,120 sets the CPU's step took 69-73 s on the 8-core host of
# an H100 machine; PillarNet's and DSVT-pillar's full-capacity steps
# 13.6 / 23.9 s on a faster one). The card's recording step runs with
# the capacity telemetry on, and nothing may drop. Bounds: voxels or
# pillars <= points; DSVT-voxel's sets a stage <= 41 x 41 windows (every
# stage's window spans its whole z extent) + ceil(32,768 / 48) = 2,364 <
# 2,560, DSVT-pillar's <= 41 x 41 + ceil(30,720 / 36) = 2,535 < 2,560;
# PillarNet's strided stages keep 3/4 of 65,536, 3/4 of that, ...
WAYMO_CPU_STEP = {"waymo_pillarnet": dict(points=30000, max_points=32768,
                                          max_voxels=65536),
                  "waymo_dsvt_pillar": dict(points=30000, max_points=32768,
                                            max_voxels=30720,
                                            dsvt_max_sets=2560),
                  "waymo_dsvt_voxel": dict(points=30000, max_points=32768,
                                           max_voxels=32768,
                                           dsvt_max_sets=2560)}
WAYMO_SCENES: dict = {}


def waymo_cloud(cfg, seed: int = 0, boxes=None, points: int = WAYMO_POINTS):
    """(points [max_points, 4] float32, n): the seeded scene's returns of
    about `points` rays' worth (WAYMO_AZIMUTHS scaled), x y z and an
    intensity, zero-padded to the voxelizer's max_points; the vehicles'
    boxes (x, y, z, 4.4, 2.0, 1.8, 0, 0, 0) into `boxes`. Each scene is
    cast once (WAYMO_SCENES) and copied out."""
    key = (seed, points, cfg.voxelize.max_points)
    if key not in WAYMO_SCENES:
        WAYMO_SCENES[key] = _cast_waymo_scene(cfg, seed, points)
    pts, n, found = WAYMO_SCENES[key]
    if boxes is not None:
        boxes += [list(b) for b in found]
    return pts.copy(), n


def _cast_waymo_scene(cfg, seed: int, points: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    solids, found = [], []
    while len(found) < WAYMO_VEHICLES:
        cx, cy = rng.uniform(-70.0, 70.0, 2)
        if math.hypot(cx, cy) >= 6.0:
            found.append([cx, cy, 0.9, 4.4, 2.0, 1.8, 0.0, 0.0, 0.0])
            solids.append([cx - 2.2, cy - 1.0, 0.0, cx + 2.2, cy + 1.0, 1.8])
    while len(solids) < WAYMO_VEHICLES + WAYMO_WALLS:
        cx, cy = rng.uniform(-70.0, 70.0, 2)
        hx, hy = (8.0, 0.15) if rng.uniform() < 0.5 else (0.15, 8.0)
        if math.hypot(cx, cy) >= 10.0:
            solids.append([cx - hx, cy - hy, 0.0, cx + hx, cy + hy, 3.0])
    cols = max(round(WAYMO_AZIMUTHS * points / WAYMO_POINTS), 1)
    el = np.radians(np.linspace(*WAYMO_ELEVATION_DEG, 64))
    az = (np.linspace(0, 2 * np.pi, cols, endpoint=False)
          + rng.uniform(0, 2 * np.pi / cols))
    el, az = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], -1).reshape(-1, 3)
    o = np.array([0.0, 0.0, WAYMO_SENSOR_Z])
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d[:, 2] < 0, -WAYMO_SENSOR_Z / d[:, 2], np.inf)
        inv = 1.0 / d
        for b in np.asarray(solids):              # slab test per box
            t1, t2 = (b[:3] - o) * inv, (b[3:] - o) * inv
            near = np.nanmax(np.minimum(t1, t2), 1)
            far = np.nanmin(np.maximum(t1, t2), 1)
            t = np.where((near <= far) & (near > 0) & (near < t), near, t)
    p = o + d * t[:, None]
    keep = (np.isfinite(t) & (np.abs(p[:, 0]) < 75.0)
            & (np.abs(p[:, 1]) < 75.0))
    n = int(keep.sum())
    out = np.zeros((cfg.voxelize.max_points, 4), np.float32)
    out[:n, :3] = p[keep] + rng.normal(0, 0.02, (n, 3))
    out[:n, 3] = rng.uniform(0, 1, n)
    return out, n, found


def waymo_config(preset: str):
    from lvv_tpu_torch import config as C
    return C.load(C.VQAConfig, REPO / WAYMO_PRESETS[preset])


def waymo_detector(torch, preset: str, cfg, device):
    """The preset's family with seeded weights and the biases the note
    above sets."""
    from lvv_tpu_torch import config as C
    from lvv_tpu_torch.models.registry import build_detector
    name = C.load_file(REPO / WAYMO_PRESETS[preset])["_detector"]
    det = build_detector(name, cfg.model.voxelnext, cfg.voxelize,
                         device=device, seed=0)
    with torch.no_grad():
        det.head.hm.bias.fill_(-1.0)
        det.head.dim.bias.fill_(-1.5 if name == "PillarNet" else -2.5)
        det.head.rot.bias[1] = 4.0
    return det


@contextlib.contextmanager
def dsvt_sets(torch, log, rotation: bool = True):
    """Every set partition of DSVT's blocks, in call order: its (set_row,
    col, ok) and the voxels' valid mask appended to `log` (on the host);
    `rotation` False (the trap) takes the y-sorted sets for the x layer
    too."""
    from lvv_tpu_torch.models import dsvt as D
    plain = D.rotated_set_partition

    def partition(wid, inner, valid, window, set_size, max_sets, axis):
        got = plain(wid, inner, valid, window, set_size, max_sets,
                    axis if rotation else "y")
        if log is not None:
            log.append(tuple(t.cpu() for t in (*got, valid)))
        return got
    D.rotated_set_partition = partition
    try:
        yield
    finally:
        D.rotated_set_partition = plain


@contextlib.contextmanager
def waymo_winners(torch, log, replay=None, own=None):
    """The segment maxes of the VFE and ZPoolAttention's group max, in call
    order: each one's winners (the entries equal to their segment's max)
    appended to log["max"] on the host; given `replay` (another run's log),
    each max is the mean of its replayed winners instead (the max itself
    where they are this run's own; a tie's gradient split evenly, as JAX's
    scatter-max rule and torch's amax split it), and the winners this run
    would have taken otherwise are counted into own["max"]."""
    from lvv_tpu_torch.models import dsvt as D
    from lvv_tpu_torch.models import vfe as V
    from lvv_tpu_torch.ops.segment import segment_sum
    plain_seg, plain_group, calls = V.segment_max, D.group_max, [0]

    def winners(mine):
        i, calls[0] = calls[0], calls[0] + 1
        if replay is None:
            log.setdefault("max", []).append(mine.cpu())
            return None
        want = replay["max"][i].to(mine.device)
        own["max"] = own.get("max", 0) + int((mine != want).sum())
        return want

    def seg_max(data, seg, num):
        out = plain_seg(data, seg, num)
        ids = seg.long()
        won = winners(data.detach() == out.detach()[ids])
        if won is None:
            return out
        total = segment_sum(torch.where(won, data, 0.0), ids, num)
        count = segment_sum(won.to(data.dtype), ids, num)
        return torch.where(count > 0, total / count.clamp_min(1),
                           -torch.inf)

    def group_max(pre, filled):
        q = plain_group(pre, filled)
        won = winners((pre.detach() == q.detach()[:, None])
                      & filled[..., None])
        if won is None:
            return q
        mean = (torch.where(won, pre, 0.0).sum(1)
                / won.sum(1).clamp_min(1).to(pre.dtype))
        return torch.where(filled.any(1)[:, None], mean, 0.0)
    V.segment_max, D.group_max = seg_max, group_max
    try:
        yield
    finally:
        V.segment_max, D.group_max = plain_seg, plain_group


def waymo_voxels(torch, det, pts, n):
    """The detector's voxels: DSVT's DynamicVoxelVFE, PillarNet's
    voxelize_mean (coords, each point's voxel)."""
    from lvv_tpu_torch.ops.voxelize import voxelize_mean
    grid, cap = det.voxel_grid(), det.vox_cfg.max_voxels
    with torch.no_grad():
        vox = (det.vfe(pts, n, grid, cap) if hasattr(det, "vfe")
               else voxelize_mean(pts, n, grid, max_voxels=cap))
    return vox


def dsvt_plan(det, vox, trace) -> dict:
    """{block: (the host planner's exact set count on the block's input,
    max_sets)}: the voxels feed the first block, a block or reduction's
    output the next."""
    from lvv_tpu_torch.models.dsvt import plan_max_sets
    from lvv_tpu_torch.ops.sparse import from_voxels
    grid = det.voxel_grid().grid_size
    st = from_voxels(vox.coords, vox.features, grid)
    plans = {}
    for name, out in trace:
        blk = getattr(det.backbone3d, name)
        if hasattr(blk, "window"):
            plans[name] = (plan_max_sets(st.ids.cpu().numpy(), st.grid,
                                         blk.window, blk.set_size, bucket=1),
                           blk.max_sets)
        st = out
    return plans


def waymo_detect(torch, preset: str) -> tuple:
    """The preset's detect on the card, timed and profiled, its tables and
    telemetry, against the same call through the port on the CPU, and the
    DSVT trap -> (report, the CPU's detector at the card's weights)."""
    from lvv_tpu_torch.ops import sparse as S
    clock = [time.perf_counter()]
    part_s = {}

    def lap(name):
        now = time.perf_counter()
        part_s[name], clock[0] = now - clock[0], now
    cfg = waymo_config(preset)
    pts_np, n = waymo_cloud(cfg)
    det = waymo_detector(torch, preset, cfg, "cuda")
    dsvt = hasattr(det, "vfe")
    pts = torch.from_numpy(pts_np).cuda()
    lap("cloud and card build")
    sets = []
    report, out, dets, trace = timed_detect(
        torch, f"detector-waymo[{preset}]", det, pts, n,
        lambda: dsvt_sets(torch, sets))
    lap("timed detect and profile")
    S.set_overflow_debug(True)
    S.reset_overflow_log()
    det.detect(pts, n)
    telemetry = S.overflow_log()
    S.set_overflow_debug(False)
    cpu = waymo_detector(torch, preset, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    pts_cpu = torch.from_numpy(pts_np)
    lap("telemetry and CPU build")
    trace_cpu, sets_cpu = [], []
    t0 = time.perf_counter()
    with dsvt_sets(torch, sets_cpu):
        cpu_stage_s, out_cpu, dets_cpu = zoo_staged(torch, cpu, pts_cpu, n,
                                                    trace_cpu)
    cpu_s = time.perf_counter() - t0
    lap("CPU detect")
    vox, vox_cpu = (waymo_voxels(torch, d, p, n)
                    for d, p in ((det, pts), (cpu, pts_cpu)))
    ids_equal = {name: torch.equal(a.ids.cpu(), b.ids)
                 for (name, a), (_, b) in zip(trace, trace_cpu)}
    voxels_equal = all(torch.equal(getattr(vox, k).cpu(),
                                   getattr(vox_cpu, k))
                       for k in ("coords", "point_voxel", "num_points"))
    tables_equal = len(sets) == len(sets_cpu) and all(
        all(torch.equal(a, b) for a, b in zip(x, y))
        for x, y in zip(sets, sets_cpu))
    rels = {k: rel_l2(v.float().cpu(), zoo_outputs(out_cpu)[k].float())
            for k, v in zoo_outputs(out).items()}
    boxes, boxes_cpu = by_position(dets), by_position(dets_cpu)
    box_err = (float(abs(boxes - boxes_cpu).max())
               if boxes.shape == boxes_cpu.shape and len(boxes) else None)
    dropped = {k: v["dropped"] for k, v in telemetry.items() if v["dropped"]}
    report.update(points=n, grid=list(det.voxel_grid().grid_size),
                  voxels=int(vox.num_voxels),
                  bev_shape=list(out["bev_dense"].shape), cpu_call_s=cpu_s,
                  cpu_stage_s=cpu_stage_s,
                  stage_ids_equal_cpu=ids_equal, telemetry=telemetry,
                  rel_l2_vs_cpu=rels, box_max_abs_vs_cpu=box_err)
    checks = {"voxel ids and each point's voxel equal": voxels_equal,
              "stage ids equal": bool(trace) and all(ids_equal.values()),
              "BEV and head outputs within BEV_REL_TOL": max(
                  rels.values()) <= BEV_REL_TOL,
              "detection count": int(dets.count) == int(dets_cpu.count)
              and int(dets.count) > 0,
              "boxes within BOX_ABS_TOL": box_err is not None
              and box_err <= BOX_ABS_TOL,
              "nothing dropped (telemetry)": bool(telemetry)
              and not dropped,
              "no hand-written kernel on the path":
              report["launches"] == {}}
    if dsvt:
        blocks = [nm for nm, is_block in det.backbone3d.names if is_block]
        used = [int(row[ok].unique().numel()) for row, _, ok, _ in sets]
        lost = [int((valid & ~ok).sum()) for _, _, ok, valid in sets]
        plans = dsvt_plan(det, vox, trace)
        with torch.no_grad(), dsvt_sets(torch, None, rotation=False):
            trap = det(pts, n)
        trap_rel = rel_l2(trap["bev_dense"].float().cpu(),
                          out_cpu["bev_dense"].float())
    lap("voxels, tables, plans and trap")
    report["seconds_by_part"] = part_s
    if dsvt:
        labels = [f"{b}.{axis}" for b in blocks for axis in ("y", "x")]
        report.update(
            sets_used=dict(zip(labels, used)),
            max_sets=det.backbone3d.max_sets, sets_dropped=sum(lost),
            planned_sets=plans, trap_bev_rel_l2=trap_rel)
        checks.update({
            "every block's (set_row, col, ok) equal on both axes":
            tables_equal and len(sets) == 2 * len(blocks),
            "no set drops": sum(lost) == 0,
            "the host planner's sets fit max_sets": all(
                need <= cap for need, cap in plans.values()),
            "trap (rotation dropped) misses BEV_REL_TOL":
            trap_rel > BEV_REL_TOL})
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-waymo[{preset}]: {checks}; {report}")
    return report, cpu


def waymo_train(torch, preset: str, cpu) -> dict:
    """The preset's train step at batch ZOO_BATCH (`timed_train`), then a
    step at batch 1 on the card against `cpu` (the same family on the CPU,
    reloaded with the card's starting weights)."""
    cfg = waymo_config(preset)
    batch = detector_batch(cfg, range(ZOO_BATCH), waymo_cloud)
    det = waymo_detector(torch, preset, cfg, "cuda")
    start = {k: v.clone() for k, v in det.state_dict().items()}
    t0 = time.perf_counter()
    report = timed_train(torch, f"detector-waymo[{preset}]", det, batch)
    report["timed_train_s"] = time.perf_counter() - t0
    checks = report.pop("checks")
    checks["no hand-written kernel on the path"] = (
        report["launches_per_step"] == {})
    del batch
    det.load_state_dict(start)
    cut = WAYMO_CPU_STEP.get(preset)
    points = WAYMO_POINTS
    if cut:             # the same weights at the cut capacities
        import dataclasses
        points = cut["points"]
        sets = ({"dsvt_max_sets": cut["dsvt_max_sets"]}
                if "dsvt_max_sets" in cut else {})
        cfg = dataclasses.replace(cfg, voxelize=dataclasses.replace(
            cfg.voxelize, max_points=cut["max_points"],
            max_voxels=cut["max_voxels"]), model=dataclasses.replace(
            cfg.model, voxelnext=dataclasses.replace(cfg.model.voxelnext,
                                                     **sets)))
        det = waymo_detector(torch, preset, cfg, "cuda")
        det.load_state_dict(start)
        cpu = waymo_detector(torch, preset, cfg, "cpu")
    one = detector_batch(cfg, (0,), functools.partial(waymo_cloud,
                                                      points=points))
    report.update(waymo_against_cpu(torch, preset, det, cpu, start, one))
    report["cpu_step_points"] = int(one["num_points"][0])
    report["cpu_step_capacities"] = dict(
        max_points=cfg.voxelize.max_points,
        max_voxels=cfg.voxelize.max_voxels,
        max_sets=getattr(getattr(det, "backbone3d", None), "max_sets",
                         None))
    checks.update(report.pop("checks"))
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-waymo[{preset}] train: {checks}; "
                             f"{report}")
    return report


def waymo_against_cpu(torch, preset, det, cpu, start, one) -> dict:
    """A step of `det` (at `start`) on batch `one`, then the same step on
    the CPU from the same weights with every ReLU gate and every segment
    max's winners replayed from the card's: the loss, each group's
    gradient (the VFE, each DSVT block or sparse stage, the BEV trunk, the
    head), and the gates and winners the CPU would have taken
    otherwise."""
    from lvv_tpu_torch.ops import sparse as S
    gates, winners = [], {}

    def picker(log, replayed, own):
        return waymo_winners(torch, log, replayed, own)
    S.set_overflow_debug(True)
    S.reset_overflow_log()
    t0 = time.perf_counter()
    card_m, card_g, _, _ = zoo_step(torch, det, one, gates, winners,
                                    picker=picker)
    card_s = time.perf_counter() - t0
    telemetry = S.overflow_log()
    S.set_overflow_debug(False)
    dropped = {k: v["dropped"] for k, v in telemetry.items() if v["dropped"]}
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    t0 = time.perf_counter()
    cpu_m, cpu_g, gates_differ, winners_differ = zoo_step(
        torch, cpu, one, None, {}, replay=(gates, winners), picker=picker)
    cpu_s = time.perf_counter() - t0
    groups = collections.defaultdict(list)
    for name in cpu_g:
        part = name.split(".")
        deep = part[0] in ("backbone3d", "backbone2d_sparse")
        groups[".".join(part[:2] if deep else part[:1])].append(name)
    rel = group_rel_l2(torch, dict(groups), card_g, cpu_g)
    loss_rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    no_grad = sorted(k for k, g in card_g.items() if g is None)
    checks = {"loss card vs CPU within DET_LOSS_TOL": loss_rel
              <= DET_LOSS_TOL,
              "group gradients within DET_GRAD_TOL": all(
                  v is not None and v <= DET_GRAD_TOL for v in rel.values()),
              "every parameter has a gradient on both devices":
              no_grad == [] == sorted(k for k, g in cpu_g.items()
                                      if g is None),
              "the card's step drops nothing (telemetry)": bool(telemetry)
              and not dropped}
    report = dict(loss_card=card_m["loss"], loss_cpu=cpu_m["loss"],
                  step_telemetry=telemetry,
                  loss_rel=loss_rel, group_grad_rel_l2=rel,
                  relu_entries=sum(int(g.numel()) for g in gates),
                  cpu_own_gates_differing=gates_differ,
                  max_entries=sum(int(w.numel())
                                  for w in winners.get("max", [])),
                  cpu_own_winners_differing=winners_differ.get("max", 0),
                  card_recording_step_s=card_s, cpu_step_s=cpu_s,
                  checks=checks)
    print(f"detector-waymo[{preset}] train: batch 1 card vs CPU on the "
          f"card's gates and winners: loss {loss_rel:.2e}, groups {rel}; "
          f"the CPU's own gates differ at {gates_differ} of "
          f"{report['relu_entries']}, winners at "
          f"{report['cpu_own_winners_differing']}", flush=True)
    return report


def run_detector_waymo(torch) -> dict:
    """PillarNet and DSVT at their Waymo presets on the card: each one's
    detect against the CPU, each one's train step at batch ZOO_BATCH and
    at batch 1 against the CPU. `launches`: none of them launches a
    hand-written kernel."""
    report = {}
    for preset in WAYMO_PRESETS:
        t0 = time.perf_counter()
        report[f"detect[{preset}]"], cpu = waymo_detect(torch, preset)
        torch.cuda.empty_cache()
        report[f"train[{preset}]"] = waymo_train(torch, preset, cpu)
        torch.cuda.empty_cache()
        report[f"seconds[{preset}]"] = time.perf_counter() - t0
    report["launches"] = {}
    return report


# ------------------------------------------------------ detector-mppnet --

# MPPNet at configs/waymo_mppnet_4frames.json's full width (4 frames, 32
# samples a (proposal, frame), d_model 64, two layers of four heads; fp32,
# TF32 off, seeded weights) on a 4-frame stack of max_points // 4 = 75,000
# rows a frame: waymo_cloud's scene cast with that many rays' worth, its
# vehicles given seeded velocities (N(0, 4) m/s a component), and frame t
# (0 the current one) with each vehicle's returns moved back t · 0.1 s
# along its velocity, so that the trajectories land on points. Proposals:
# the vehicles' boxes (centres off by N(0, 0.1) m) with their velocities,
# then boxes of a vehicle's size at random places in the range, R = 32
# (the JAX CLI's n_rois) and R = 83 (the config's nms_post_max, what a
# first stage of this repo hands on). Each detect is split by stage (p50
# of 3 after a warm-up), profiled once, and held against the same call on
# the CPU: the pooled points and the empty mask equal, the outputs within
# MPPNET_REL_TOL relative L2. Training: batch 2 (the CLI's chain), then
# batch 1 on the card and on the CPU on the same RoI-sampling draws with
# every ReLU gate replayed (loss within DET_LOSS_TOL, each group within
# DET_GRAD_TOL). MPPNetE2E on the same weights runs a MPPNET_STREAM-frame
# stream through its bank on both devices: the bank equal after each push,
# the detections within MPPNET_REL_TOL. No hand-written kernel lies on the
# path (its attention holds 4 x 32 = 128 keys, its LayerNorm is 64 wide).
MPPNET_PRESETS = {"4frames": "configs/waymo_mppnet_4frames.json",
                  "16frames": "configs/waymo_mppnet_16frames.json",
                  "e2e": "configs/waymo_mppnet_e2e.json"}
MPPNET_ROIS = (32, 83)
MPPNET_STREAM = 6
MPPNET_DT = 0.1
MPPNET_REL_TOL = 1e-5
MPPNET_FIELDS = ("boxes", "scores", "labels", "count")


def mppnet_config(which: str = "4frames"):
    from lvv_tpu_torch import config as C
    return C.load(C.VQAConfig, REPO / MPPNET_PRESETS[which])


def mppnet_scene(cfg, seed: int = 0, frames: int = 4, now: int = 0):
    """(frame_points [frames, P, 4], frame_counts [frames], the vehicles'
    boxes [V, 9] at time `now`), P = max_points // 4: frame t holds the
    scene at time (now - t) · MPPNET_DT, each vehicle's returns moved by
    that time along its velocity."""
    import numpy as np
    per = cfg.voxelize.max_points // 4
    found = []
    pts, n = waymo_cloud(cfg, seed, boxes=found, points=per)
    n = min(n, per)
    boxes = np.asarray(found, np.float32)
    boxes[:, 7:9] = np.random.default_rng(seed + 100).normal(
        0, 4.0, (len(boxes), 2))
    xyz = pts[:n, :3]
    half = boxes[None, :, 3:6] / 2 + 0.05
    inside = (np.abs(xyz[:, None] - boxes[None, :, :3]) <= half).all(-1)
    owner = np.where(inside.any(1), inside.argmax(1), -1)
    moved = owner >= 0
    fp = np.zeros((frames, per, 4), np.float32)
    for t in range(frames):
        f = pts[:per].copy()
        f[:n][moved, :2] += ((now - t) * MPPNET_DT
                             * boxes[owner[moved], 7:9])
        fp[t] = f
    at_now = boxes.copy()
    at_now[:, :2] += now * MPPNET_DT * boxes[:, 7:9]
    return fp, np.full(frames, n, np.int32), at_now


def mppnet_proposals(boxes, r: int, seed: int = 0) -> dict:
    """r proposals: the vehicles' boxes, centres off by N(0, 0.1) m, then
    vehicle-sized boxes at random places (scores 0.3-0.9, class 0)."""
    import numpy as np
    rng = np.random.default_rng(seed + 200)
    k = min(len(boxes), r)
    pb = np.zeros((r, 9), np.float32)
    pb[:k] = boxes[:k]
    pb[:k, :3] += rng.normal(0, 0.1, (k, 3))
    pb[k:, :2] = rng.uniform(-70.0, 70.0, (r - k, 2))
    pb[k:, 2:6] = (0.9, 4.4, 2.0, 1.8)
    pb[k:, 7:9] = rng.normal(0, 4.0, (r - k, 2))
    return {"boxes": pb,
            "scores": rng.uniform(0.3, 0.9, r).astype(np.float32),
            "labels": np.zeros(r, np.int32), "count": np.int32(r)}


def mppnet_detector(torch, cfg, device, which: str = "MPPNet"):
    from lvv_tpu_torch.models.registry import build_detector
    return build_detector(which, cfg.model.voxelnext, cfg.voxelize,
                          device=device, seed=0)


def as_dets(torch, props: dict, device):
    from lvv_tpu_torch.models.voxelnext import Detections
    return Detections(*(torch.as_tensor(props[k]).to(device)
                        for k in MPPNET_FIELDS))


def mppnet_staged(torch, det, frames, proposals, trace=None) -> tuple:
    """One MPPNet call stage by stage (trajectories, pool, head, refine),
    each ending in a synchronise where on the card -> (seconds by stage,
    the state dict, detections)."""
    sync = torch.cuda.synchronize if det.device.type == "cuda" \
        else (lambda: None)
    secs = {}
    with torch.no_grad():
        for i, (name, fn) in enumerate(det.stages()):
            t0 = time.perf_counter()
            s = fn(*frames, proposals) if i == 0 else fn(s)
            sync()
            secs[name] = time.perf_counter() - t0
    return secs, s, s["detections"]


def mppnet_rels(torch, out, out_cpu) -> dict:
    """The head's outputs and the refined boxes and scores, card against
    CPU, relative L2."""
    got = {"cls": (out["preds"]["cls"], out_cpu["preds"]["cls"]),
           "reg": (out["preds"]["reg"], out_cpu["preds"]["reg"])}
    for k in ("boxes", "scores"):
        got[k] = (getattr(out["detections"], k),
                  getattr(out_cpu["detections"], k))
    return {k: rel_l2(a.float().cpu(), b.float()) for k, (a, b) in
            got.items()}


def mppnet_detect(torch, r: int) -> dict:
    """MPPNet's detect on the card with r proposals, timed and profiled,
    against the same call on the CPU."""
    cfg = mppnet_config()
    fp, fc, boxes = mppnet_scene(cfg)
    props = mppnet_proposals(boxes, r)
    det = mppnet_detector(torch, cfg, "cuda")
    frames = (torch.from_numpy(fp).cuda(), torch.from_numpy(fc).cuda())
    report, out, dets, _ = timed_detect(
        torch, f"detector-mppnet[R={r}]", det, frames,
        as_dets(torch, props, "cuda"), zoo_staged=mppnet_staged)
    report.pop("points")
    cpu = mppnet_detector(torch, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    t0 = time.perf_counter()
    _, out_cpu, dets_cpu = mppnet_staged(
        torch, cpu, (torch.from_numpy(fp), torch.from_numpy(fc)),
        as_dets(torch, props, "cpu"))
    cpu_s = time.perf_counter() - t0
    filled = float((~out["empty"]).float().mean())
    rels = mppnet_rels(torch, out, out_cpu)
    report.update(points_per_frame=int(fc[0]), frames=int(fp.shape[0]),
                  proposals=r, vehicles=len(boxes),
                  pairs_with_points=filled, cpu_call_s=cpu_s,
                  rel_l2_vs_cpu=rels)
    checks = {"pooled points equal the CPU's": torch.equal(
                  out["pooled"].cpu(), out_cpu["pooled"]),
              "empty mask equal": torch.equal(out["empty"].cpu(),
                                              out_cpu["empty"]),
              "some (proposal, frame) pairs hold points": filled > 0,
              "outputs within MPPNET_REL_TOL": max(rels.values())
              <= MPPNET_REL_TOL,
              "labels and count equal": torch.equal(
                  dets.labels.cpu(), dets_cpu.labels)
              and int(dets.count) == int(dets_cpu.count) == r,
              "finite detections": bool(torch.isfinite(dets.boxes).all()
                                        and torch.isfinite(dets.scores).all()),
              "no hand-written kernel on the path":
              report["launches"] == {}}
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-mppnet[R={r}]: {checks}; {report}")
    return report


def mppnet_batch(cfg, seeds, r: int = MPPNET_ROIS[0]) -> dict:
    """The train step's batch over `seeds`' scenes: frame stacks, r
    proposals, the vehicles as gts (class 0) padded to MAX_GT, and seeded
    RoI-sampling draws [B, 2, r]."""
    import numpy as np
    rows = []
    for seed in seeds:
        fp, fc, boxes = mppnet_scene(cfg, seed)
        p = mppnet_proposals(boxes, r, seed)
        gt = np.zeros((MAX_GT, 9), np.float32)
        gt[:len(boxes)] = boxes
        rows.append({"frame_points": fp, "frame_counts": fc,
                     "prop_boxes": p["boxes"], "prop_scores": p["scores"],
                     "prop_labels": p["labels"], "prop_count": p["count"],
                     "gt_boxes": gt,
                     "gt_mask": np.arange(MAX_GT) < len(boxes)})
    out = {k: np.stack([row[k] for row in rows]) for k in rows[0]}
    out["draws"] = np.random.default_rng(7).uniform(
        size=(len(rows), 2, r)).astype(np.float32)
    return out


def mppnet_step(torch, det, batch, gates, replay=None) -> tuple:
    """One MPPNet train step (the CLI's chain) with every ReLU gate
    recorded into `gates`, or replayed from `replay` -> (metrics as
    floats, gradients on the host, gates that differ from the replayed
    ones)."""
    from lvv_tpu_torch.train.detector import make_mppnet_train_step
    from lvv_tpu_torch.train.optim import detector_optimizer
    tx = detector_optimizer(DET_LR, ZOO_STEPS)
    step = make_mppnet_train_step(det, tx)
    own = [0]
    with zoo_gates(torch, None if replay else gates, replay, own):
        _, m = step((det, tx.init(dict(det.named_parameters()))), batch)
    grads = {k: None if p.grad is None else p.grad.cpu()
             for k, p in det.named_parameters()}
    return {k: float(v) for k, v in m.items()}, grads, own[0]


def mppnet_train(torch) -> dict:
    """MPPNet's train step at batch ZOO_BATCH (`timed_train`), then batch
    1 on the card against the CPU on the same draws and gates."""
    from lvv_tpu_torch.train.detector import make_mppnet_train_step
    cfg = mppnet_config()
    batch = mppnet_batch(cfg, range(ZOO_BATCH))
    det = mppnet_detector(torch, cfg, "cuda")
    start = {k: v.clone() for k, v in det.state_dict().items()}
    report = timed_train(torch, "detector-mppnet", det, batch,
                         make_step=make_mppnet_train_step)
    checks = report.pop("checks")
    checks["no hand-written kernel on the path"] = (
        report["launches_per_step"] == {})
    det.load_state_dict(start)
    one = {k: v[:1] for k, v in batch.items()}
    gates = []
    card_m, card_g, _ = mppnet_step(torch, det, one, gates)
    cpu = mppnet_detector(torch, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    t0 = time.perf_counter()
    cpu_m, cpu_g, differ = mppnet_step(torch, cpu, one, None, gates)
    cpu_s = time.perf_counter() - t0
    groups = collections.defaultdict(list)
    for name in cpu_g:
        groups[".".join(name.split(".")[:2])].append(name)
    rel = group_rel_l2(torch, dict(groups), card_g, cpu_g)
    loss_rel = abs(card_m["loss"] - cpu_m["loss"]) / abs(cpu_m["loss"])
    checks.update({
        "loss card vs CPU within DET_LOSS_TOL": loss_rel <= DET_LOSS_TOL,
        "group gradients within DET_GRAD_TOL": all(
            v is not None and v <= DET_GRAD_TOL for v in rel.values()),
        "every parameter has a gradient on both devices": all(
            g is not None for g in (*card_g.values(), *cpu_g.values()))})
    report.update(loss_card=card_m["loss"], loss_cpu=cpu_m["loss"],
                  loss_rel=loss_rel, group_grad_rel_l2=rel,
                  relu_entries=sum(int(g.numel()) for g in gates),
                  cpu_own_gates_differing=differ, cpu_step_s=cpu_s,
                  checks=checks)
    print(f"detector-mppnet train: batch 1 card vs CPU on the same draws "
          f"and the card's gates: loss {loss_rel:.2e}, worst group "
          f"{max(rel.values()):.2e}; the CPU's own gates differ at {differ} "
          f"of {report['relu_entries']}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"detector-mppnet train: {checks}; {report}")
    return report


def mppnet_stream(torch, weights) -> dict:
    """MPPNetE2E (MPPNet's weights) over MPPNET_STREAM consecutive frames
    on the card and on the CPU: each step's bank equal, its detections
    within MPPNET_REL_TOL; the card's step p50 after the first."""
    from lvv_tpu_torch import kernels
    cfg = mppnet_config("e2e")
    e2e = mppnet_detector(torch, cfg, "cuda", "MPPNetE2E")
    e2e.load_state_dict(weights)
    cpu = mppnet_detector(torch, cfg, "cpu", "MPPNetE2E")
    cpu.load_state_dict({k: v.cpu() for k, v in weights.items()})
    per = cfg.voxelize.max_points // 4
    bank, bank_cpu = e2e.create_bank(per), cpu.create_bank(per)
    kernels.launches.clear()
    step_s, banks_equal, rels = [], [], []
    for k in range(MPPNET_STREAM):
        fp, fc, boxes = mppnet_scene(cfg, frames=1, now=k)
        props = mppnet_proposals(boxes, MPPNET_ROIS[0])
        pts = torch.from_numpy(fp[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            bank, dets = e2e(bank, pts.cuda(), int(fc[0]),
                             as_dets(torch, props, "cuda"))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        with torch.no_grad():
            bank_cpu, dets_cpu = cpu(bank_cpu, pts, int(fc[0]),
                                     as_dets(torch, props, "cpu"))
        banks_equal.append(torch.equal(bank.points.cpu(), bank_cpu.points)
                           and torch.equal(bank.counts.cpu(),
                                           bank_cpu.counts))
        rels.append(max(rel_l2(dets.boxes.cpu(), dets_cpu.boxes),
                        rel_l2(dets.scores.cpu(), dets_cpu.scores)))
    launches = {k: v for k, v in kernels.launches.items() if v}
    checks = {"bank equal the CPU's after every push": all(banks_equal),
              "detections within MPPNET_REL_TOL at every step":
              max(rels) <= MPPNET_REL_TOL,
              "the bank holds the last three frames":
              int((bank.counts > 0).sum()) == 3,
              "no hand-written kernel on the path": launches == {}}
    report = dict(frames=MPPNET_STREAM, step_s=step_s,
                  step_p50_s=sorted(step_s[1:])[len(step_s[1:]) // 2],
                  rel_l2_vs_cpu_by_step=rels, checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"detector-mppnet[e2e]: {checks}; {report}")
    return report


def run_detector_mppnet(torch) -> dict:
    """MPPNet at its 4-frame preset on the card: the detect at R = 32 and
    83 against the CPU, training, MPPNetE2E's stream, and the 16-frame
    preset's frame count (4, as JAX's registry builds it)."""
    report = {f"detect[R={r}]": mppnet_detect(torch, r)
              for r in MPPNET_ROIS}
    torch.cuda.empty_cache()
    report["train"] = mppnet_train(torch)
    torch.cuda.empty_cache()
    weights = mppnet_detector(torch, mppnet_config(), "cuda").state_dict()
    report["e2e"] = mppnet_stream(torch, weights)
    frames16 = mppnet_detector(torch, mppnet_config("16frames"), "meta")
    report["16frames_builds_frames"] = frames16.num_frames
    if frames16.num_frames != 4:
        raise AssertionError("the 16-frame preset should run 4 frames")
    report["launches"] = {}
    return report


# ------------------------------------------------------- detector-focal --

# Voxel R-CNN with its focal / multimodal trunk at configs/
# kitti_voxel_rcnn_car_focal_multimodal.json's full width (fp32, TF32
# off, seeded weights, the RPN's biases as TWO_STAGE_PRESETS' note sets;
# focal_spawn 128) on kitti_cloud's scene and one seeded 375 x 1242 image.
# `proj` is KITTI's P2 · R0_rect · Tr_velo_to_cam (its 2011_09_26 drives)
# after the affine map that takes the focal trunk's centres back to metric
# (x, y, z): the trunk projects delinearize's (z, y, x) coordinates times
# the voxel size in (x, y, z) order (a reference trait, ROADMAP.md queue
# 3), so that with KITTI's matrix alone almost no voxel would land in the
# image; the phase reports the share that does. The direct call with image
# and proj is split by stage (p50 of 3 after a warm-up), profiled once,
# and reports each focal conv's spawned sites against focal_spawn. The
# detect without the image (what `detect` and the train step run) is held
# against the CPU: stage ids and every focal conv's spawned ids equal, the
# RPN's top-K, NMS keeps and the focal convs' top-K replayed on the CPU
# (its own picks counted), outputs within FOCAL_REL_TOL. Training: batch 2
# (JAX's step, LiDAR-only), then batch 1 card vs CPU with gates and picks
# replayed; the multimodal call's loss and gradients card vs CPU (one CPU
# forward serves the direct call's output check, its gradients and the
# trap: the card's call on a zero image must miss FOCAL_REL_TOL against
# it); the image branch's gradients non-zero on both.
FOCAL_PRESET = "configs/kitti_voxel_rcnn_car_focal_multimodal.json"
KITTI_R0_RECT = ((9.999239e-01, 9.837760e-03, -7.445048e-03),
                 (-9.869795e-03, 9.999421e-01, -4.278459e-03),
                 (7.402527e-03, 4.351614e-03, 9.999631e-01))
KITTI_P2_T = (4.485728e+01, 2.163791e-01, 2.745884e-03)
FOCAL_REL_TOL = 1e-5
# seeded weights spawn a focal conv's whole focal_spawn (128) where its
# importance bias is 0 (every conv of the image call, both later convs
# of the LiDAR-only one: its V·26 candidates hold thousands above 0.5); at
# -1 the spawn stays partial where the scene is sparse
FOCAL_IMPORTANCE_BIAS = -1.0
FOCAL_SITES = (*PICK_SITES, ("focal_conv", ("top_k",)))


@contextlib.contextmanager
def roi_winners(torch, log, replay=None, own=None):
    """Voxel R-CNN's RoI head max over each lattice point's neighbours, in
    call order: its winners (the finite entries equal to the max) appended
    to log["max"] on the host; given `replay`, each max is the mean of the
    replayed winners instead (a tie's gradient split evenly, as torch's
    amax and jnp.max split it), and the winners this run would have taken
    otherwise are counted into own["max"]. Near-ties there, within
    float32 rounding, send a scale's gradient to another neighbour."""
    from lvv_tpu_torch.models import voxel_rcnn as V
    plain, calls = V.neighbour_max, [0]

    def nmax(h):
        out = plain(h)
        won = (h.detach() == out.detach()[:, None]) & torch.isfinite(
            h.detach())
        i, calls[0] = calls[0], calls[0] + 1
        if replay is None:
            log.setdefault("max", []).append(won.cpu())
            return out
        want = replay["max"][i].to(h.device)
        own["max"] = own.get("max", 0) + int((won != want).sum())
        cnt = want.sum(1)
        mean = torch.where(want, h, 0.0).sum(1) / cnt.clamp_min(1)
        return torch.where(cnt > 0, mean, -torch.inf)
    V.neighbour_max = nmax
    try:
        yield
    finally:
        V.neighbour_max = plain


@contextlib.contextmanager
def focal_picks(torch, log, replay=None, own=None):
    """two_stage_picks over FOCAL_SITES (the RPN's top-K and NMS, each
    focal conv's top-K) and the RoI head's neighbour winners."""
    with two_stage_picks(torch, log, replay, own, FOCAL_SITES), \
            roi_winners(torch, log, replay, own):
        yield


def focal_config():
    from lvv_tpu_torch import config as C
    return C.load(C.VQAConfig, REPO / FOCAL_PRESET)


def focal_proj(cfg):
    """[3, 4] float32: P2 · R0_rect · Tr_velo_to_cam · A, A the affine map
    from the trunk's centres (c0, c1, c2) = (z, y, x) · voxel size + origin
    back to metric (x, y, z)."""
    import numpy as np
    fx, fy, cx, cy = KITTI_P2
    p2 = np.array([[fx, 0, cx, KITTI_P2_T[0]], [0, fy, cy, KITTI_P2_T[1]],
                   [0, 0, 1, KITTI_P2_T[2]]])
    r0 = np.eye(4)
    r0[:3, :3] = KITTI_R0_RECT
    tr = np.eye(4)
    tr[:3] = KITTI_VELO_TO_CAM
    vs = cfg.voxelize.voxel_size
    lo = cfg.voxelize.point_range[:3]
    a = np.zeros((4, 4))
    a[0, 2], a[0, 3] = vs[0] / vs[2], lo[0] - lo[2] * vs[0] / vs[2]
    a[1, 1] = 1.0
    a[2, 0], a[2, 3] = vs[2] / vs[0], lo[2] - lo[0] * vs[2] / vs[0]
    a[3, 3] = 1.0
    return (p2 @ r0 @ tr @ a).astype(np.float32)


def focal_detector(torch, cfg, device):
    """Voxel R-CNN at the focal preset with seeded weights, the RPN's
    biases as TWO_STAGE_PRESETS' note sets them and each focal conv's
    importance bias FOCAL_IMPORTANCE_BIAS."""
    from lvv_tpu_torch.models.focal_conv import FocalSparseConv
    det = two_stage_detector(torch, "VoxelRCNN", cfg, device)
    with torch.no_grad():
        for m in det.modules():
            if isinstance(m, FocalSparseConv):
                m.importance.bias.fill_(FOCAL_IMPORTANCE_BIAS)
    return det


def focal_staged(torch, det, pts, n, trace=None, image=None, proj=None,
                 spawned=None) -> tuple:
    """zoo_staged with the image and proj passed to the stages."""
    sync = torch.cuda.synchronize if pts.is_cuda else (lambda: None)
    secs, x = {}, None
    with torch.no_grad():
        for i, (name, fn) in enumerate(det.stages(trace, image, proj,
                                                  spawned)):
            t0 = time.perf_counter()
            x = fn(pts, n) if i == 0 else fn(x)
            sync()
            secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dets = det.decode(x)
        sync()
        secs["decode"] = time.perf_counter() - t0
    return secs, x, dets


def spawned_counts(spawned) -> list:
    from lvv_tpu_torch.ops.sparse import SENTINEL
    return [int((s != SENTINEL).sum()) for s in spawned]


def focal_inputs(torch, cfg) -> tuple:
    """(points, n, image [375, 1242, 3] in [0, 1), proj) on the host."""
    import numpy as np
    pts, n = kitti_cloud(cfg)
    image = np.random.default_rng(0).uniform(
        size=(*KITTI_HW, 3)).astype(np.float32)
    return (torch.from_numpy(pts), n, torch.from_numpy(image),
            torch.from_numpy(focal_proj(cfg)))


def in_image_share(torch, det, pts, n, image, proj) -> float:
    """The share of conv_input's voxels that the multimodal focal conv
    sees inside the image (layer1's stride)."""
    from lvv_tpu_torch.models import semseg as SS
    from lvv_tpu_torch.ops.sparse import build_subm_rulebook, delinearize
    with torch.no_grad():
        s = det.stages()[0][1](pts, n)
        st = det.backbone3d.conv_input(s["st0"],
                                       build_subm_rulebook(s["st0"]))
        uv, front = SS.project_voxels_to_image(
            delinearize(st.ids, st.grid), det.vox_cfg.voxel_size,
            det.vox_cfg.point_range, SS.scale_pixels(proj, 0.25))
        h, w = image.shape[0] // 4, image.shape[1] // 4
        ok = (front & st.valid & (uv[:, 0] >= 0) & (uv[:, 0] < w)
              & (uv[:, 1] >= 0) & (uv[:, 1] < h))
    return float(ok.sum()) / max(int(st.valid.sum()), 1)


def focal_detect(torch) -> dict:
    """The direct call with image and proj on the card, timed and
    profiled; the detect without the image against the CPU with the picks
    replayed."""
    cfg = focal_config()
    pts_h, n, image_h, proj_h = focal_inputs(torch, cfg)
    det = focal_detector(torch, cfg, "cuda")
    pts, image, proj = (t.cuda() for t in (pts_h, image_h, proj_h))
    staged = functools.partial(focal_staged, image=image, proj=proj)
    report, _, dets, _ = timed_detect(
        torch, "detector-focal[image]", det, pts, n, zoo_staged=staged)
    spawned = []
    focal_staged(torch, det, pts, n, image=image, proj=proj,
                 spawned=spawned)
    counts = spawned_counts(spawned)
    share = in_image_share(torch, det, pts, n, image, proj)
    # the detect without the image, card and CPU, picks replayed
    picks, trace, sp_card = {}, [], []
    with two_stage_picks(torch, picks, sites=FOCAL_SITES):
        _, out_l, dets_l = focal_staged(torch, det, pts, n, trace,
                                        spawned=sp_card)
    cpu = focal_detector(torch, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in det.state_dict().items()})
    trace_cpu, own, sp_cpu = [], {}, []
    t0 = time.perf_counter()
    with two_stage_picks(torch, {}, picks, own, FOCAL_SITES):
        _, out_c, dets_c = focal_staged(torch, cpu, pts_h, n, trace_cpu,
                                        spawned=sp_cpu)
    cpu_s = time.perf_counter() - t0
    ids_equal = {name: torch.equal(a.ids.cpu(), b.ids)
                 for (name, a), (_, b) in zip(trace, trace_cpu)}
    spawn_equal = len(sp_card) == len(sp_cpu) == 3 and all(
        torch.equal(a.cpu(), b) for a, b in zip(sp_card, sp_cpu))
    rels = {k: rel_l2(v.float().cpu(), two_stage_outputs(out_c)[k].float())
            for k, v in two_stage_outputs(out_l).items()}
    boxes, boxes_cpu = by_position(dets_l), by_position(dets_c)
    box_err = (float(abs(boxes - boxes_cpu).max())
               if boxes.shape == boxes_cpu.shape and len(boxes) else None)
    report.update(points=n, image_hw=list(KITTI_HW),
                  voxels_in_image_share=share,
                  spawned_by_conv=counts, focal_spawn=cfg.model.voxelnext.
                  focal_spawn, lidar_only=dict(
                      detections=int(dets_l.count), cpu_call_s=cpu_s,
                      stage_ids_equal_cpu=ids_equal,
                      spawned_by_conv=spawned_counts(sp_card),
                      cpu_own_picks_differing=own, rel_l2_vs_cpu=rels,
                      box_max_abs_vs_cpu=box_err))
    checks = {"image stage ran": "image" in report["stage_p50_s"],
              "some voxels in the image": share > 0,
              "a focal conv spawned 0 < n < focal_spawn": any(
                  0 < c < cfg.model.voxelnext.focal_spawn for c in counts),
              "four focal convs with the image, three without":
              len(counts) == 4,
              "LiDAR-only: stage ids equal": bool(trace)
              and all(ids_equal.values()),
              "LiDAR-only: spawned ids equal": spawn_equal,
              "LiDAR-only: outputs within FOCAL_REL_TOL": max(rels.values())
              <= FOCAL_REL_TOL,
              "LiDAR-only: detection count": int(dets_l.count)
              == int(dets_c.count) > 0,
              "LiDAR-only: boxes within BOX_ABS_TOL": box_err is not None
              and box_err <= BOX_ABS_TOL,
              "finite detections": bool(torch.isfinite(dets.boxes).all()),
              "no hand-written kernel on the path":
              report["launches"] == {}}
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-focal: {checks}; {report}")
    return report


def focal_image_grads(torch, cfg, det, start, one) -> dict:
    """The multimodal call's loss and gradients on the card and on the
    CPU (gates and picks replayed), at `start`, on batch `one`'s gts: the
    direct call's outputs card vs CPU, the loss and each group's gradient,
    the image branch's gradients non-zero on both; the trap: the card's
    call on a zero image against the CPU's outputs."""
    pts, n, image, proj = focal_inputs(torch, cfg)
    gt = [torch.from_numpy(one[k][0]) for k in ("gt_boxes", "gt_labels",
                                                "gt_mask")]

    def loss_grads(model, device, gates, picks, replay=None):
        own_g, own_p = [0], {}
        model.zero_grad(set_to_none=True)
        model.train()
        with zoo_gates(torch, None if replay else gates,
                       replay and replay[0], own_g), \
                focal_picks(torch, picks, replay and replay[1], own_p):
            out = model(pts.to(device), n, image=image.to(device),
                        proj=proj.to(device))
        loss, _ = model.loss(out, *(t.to(device) for t in gt))
        loss.backward()
        model.eval()
        grads = {k: None if p.grad is None else p.grad.cpu()
                 for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return out, float(loss.detach()), grads, own_g[0], own_p
    det.load_state_dict(start)
    gates, picks = [], {}
    out_g, loss_g, grads_g, _, _ = loss_grads(det, "cuda", gates, picks)
    cpu = focal_detector(torch, cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in start.items()})
    t0 = time.perf_counter()
    out_c, loss_c, grads_c, gates_differ, picks_differ = loss_grads(
        cpu, "cpu", None, {}, (gates, picks))
    cpu_s = time.perf_counter() - t0
    groups = collections.defaultdict(list)
    for name in grads_c:
        part = name.split(".")
        groups[".".join(part[:2] if part[0] == "backbone3d" else
                        part[:1])].append(name)
    rel = group_rel_l2(torch, dict(groups), grads_g, grads_c)
    rels = {k: rel_l2(v.detach().float().cpu(),
                      two_stage_outputs(out_c)[k].detach().float())
            for k, v in two_stage_outputs(out_g).items()}
    with torch.no_grad():
        _, trap, _ = focal_staged(torch, det, pts.cuda(), n,
                                  image=torch.zeros_like(image).cuda(),
                                  proj=proj.cuda())
    trap_rel = rel_l2(trap["bev_dense"].float().cpu(),
                      out_c["bev_dense"].detach().float())
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    checks = {"image call's outputs card vs CPU within FOCAL_REL_TOL":
              max(rels.values()) <= FOCAL_REL_TOL,
              "image loss card vs CPU within DET_LOSS_TOL": loss_rel
              <= DET_LOSS_TOL,
              "image gradients within DET_GRAD_TOL": all(
                  v is not None and v <= DET_GRAD_TOL for v in rel.values()),
              "semseg gradients non-zero on both devices": all(
                  d[k] is not None and float(d[k].abs().sum()) > 0
                  for d in (grads_g, grads_c) for k in groups["semseg"]),
              "trap (zero image) misses FOCAL_REL_TOL": trap_rel
              > FOCAL_REL_TOL}
    report = dict(loss_card=loss_g, loss_cpu=loss_c, loss_rel=loss_rel,
                  group_grad_rel_l2=rel, rel_l2_vs_cpu=rels,
                  trap_zero_image_bev_rel_l2=trap_rel,
                  cpu_own_gates_differing=gates_differ,
                  cpu_own_picks_differing=picks_differ, cpu_call_s=cpu_s,
                  checks=checks)
    print(f"detector-focal image call: card vs CPU on the card's gates and "
          f"picks: outputs {max(rels.values()):.2e}, loss {loss_rel:.2e}, "
          f"semseg {rel.get('semseg')}; zero-image trap {trap_rel:.3e}",
          flush=True)
    return report


def focal_train(torch) -> dict:
    """The train step at batch ZOO_BATCH (LiDAR-only, as JAX's), batch 1
    card vs CPU with gates and picks replayed (the image branch without a
    gradient on both), then the multimodal call's loss and gradients."""
    cfg = focal_config()
    batch = detector_batch(cfg, range(ZOO_BATCH), kitti_cloud)
    det = focal_detector(torch, cfg, "cuda")
    start = {k: v.clone() for k, v in det.state_dict().items()}
    report = timed_train(torch, "detector-focal", det, batch)
    checks = report.pop("checks")
    checks["no hand-written kernel on the path"] = (
        report["launches_per_step"] == {})
    det.load_state_dict(start)
    one = {k: v[:1] for k, v in batch.items()}
    report.update(two_stage_against_cpu(
        torch, "VoxelRCNN", cfg, det, start, one,
        lambda log, replayed, own: focal_picks(torch, log, replayed, own),
        "detector-focal"))
    checks.update(report.pop("checks"))
    checks["the step leaves the image modules without a gradient"] = all(
        name.startswith(("semseg.", "backbone3d.focal_multimodal."))
        for name in report["no_gradient"]) and bool(report["no_gradient"])
    image = focal_image_grads(torch, cfg, det, start, one)
    checks.update(image.pop("checks"))
    report["image_call"] = image
    report["checks"] = checks
    if not all(checks.values()):
        raise AssertionError(f"detector-focal train: {checks}; {report}")
    return report


def run_detector_focal(torch) -> dict:
    """The focal multimodal Voxel R-CNN on the card: the direct call with
    image and proj, the LiDAR-only detect against the CPU, training and
    the multimodal gradients against the CPU. `launches`: none."""
    report = {"detect": focal_detect(torch)}
    torch.cuda.empty_cache()
    report["train"] = focal_train(torch)
    report["launches"] = {}
    return report


# kernels printed by device_busy wherever they rank: PyTorch's bf16 adds
# (the residual adds that K-a's add form takes in) and K-a itself
# ---------------------------------------------------------------- training --

TRAIN_DIR = REPO / "build" / "train_smoke"
# A train step with the kernels against the same step with every kernel
# swapped for its plain version, on the same weights and batch: the loss
# within TRAIN_LOSS_TOL relative, each optimizer group's gradient (all its
# tensors as one vector) within TRAIN_GRAD_TOL relative L2. The two
# forwards differ by bf16 rounding at different points through ~70 layers
# (the generate paths' logits sit ~1.5% apart, LOGITS_REL_TOL 5%); the
# plain side differentiates its norms and MLPs natively and its attention
# through the same recompute (plain_training). The trap, the plain step
# with every LoRA branch's alpha / r dropped (1 in place of 2), halves the
# LoRA B gradients and has to fail the group bound.
TRAIN_LOSS_TOL = 0.01
TRAIN_GRAD_TOL = 0.05
TRAIN_STEPS = 3


def train_config(**train):
    """default_config() with TrainConfig's batch 4, 128 prompt and 96
    answer tokens; `train` overrides train.* fields."""
    from lvv_tpu_torch import config as C
    cfg = C.default_config()
    for key, value in train.items():
        cfg = C.override(cfg, f"train.{key}", value)
    return cfg


def train_batch(torch, cfg):
    """TRAIN_BATCH rows on the card: six 1024² views in [-1, 1], all valid,
    a BEV grid [128, 180, 180] (seeded normal), ByteTokenizer text packed as
    the collator packs it: a question cut to the 128 prompt tokens and an
    answer to the 96 answer tokens and eos (a 225-token text block), the
    last row's answer shorter (a ragged kv_len)."""
    import numpy as np
    from lvv_tpu_torch.data import ByteTokenizer, pack_text
    from lvv_tpu_torch.models.vqa import VQABatch
    t, m = cfg.train, cfg.model
    tok = ByteTokenizer(m.llm.special_tokens)
    rows = []
    for i in range(TRAIN_BATCH):
        question = (f"What stands at the front right of the ego car in scene "
                    f"{i}, and how far away is it? ") * 3
        answer = (f"A white truck parked {i + 9} m ahead at [1.5, 2.0, 0.0, "
                  f"4.2, 1.9, 1.6, 0.3], beside a barrier. ")
        rows.append(pack_text(tok, question, answer * (
            3 if i < TRAIN_BATCH - 1 else 1), t.max_prompt_tokens,
            t.max_answer_tokens))
    ids, labels, lens, _ = (np.stack(x) for x in zip(*rows))
    rng = np.random.default_rng(11)
    s, b = m.sam.img_size, TRAIN_BATCH
    batch = VQABatch(
        bev=rng.standard_normal((b, m.bev_channels, *m.bev_hw),
                                dtype=np.float32),
        images=rng.uniform(-1, 1, (b, 6, 3, s, s)).astype(np.float32),
        view_valid=np.ones((b, 6), bool), text_ids=ids, text_len=lens,
        labels=labels, use_vision=np.asarray(True),
        use_lidar=np.asarray(True))
    return batch.to("cuda")


def group_grads(torch, model, labels, batch) -> tuple:
    """One forward / backward of the model's loss on `batch`, no update ->
    (loss, {group: every gradient of the group in one fp32 vector},
    {tensor name: whether its gradient has a non-zero element})."""
    params = dict(model.named_parameters())
    loss, _, _ = model(batch)
    loss.backward()
    flat, nonzero = {}, {}
    for name, group in labels.items():
        if group == "frozen":
            continue
        g = params[name].grad
        params[name].grad = None
        g = (torch.zeros(params[name].numel(), device="cuda") if g is None
             else g.float().flatten())
        flat.setdefault(group, []).append(g)
        nonzero[name] = bool(g.any())
    return float(loss.detach()), {k: torch.cat(v) for k, v in flat.items()}, nonzero


@contextlib.contextmanager
def plain_training(lora_scaling=None):
    """plain_kernels() for a train step: every kernel swapped for its plain
    version; the norms and the fused MLPs then differentiate natively
    (autograd through the plain versions), the flash attention through
    FlashAttentionFn around its plain forward (native autograd would keep
    every layer's fp32 [B, H, Sq, Sk] scores: ~100 GB at batch 4).
    `lora_scaling`: the trap's value for every LoRA branch's alpha / r."""
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.models import layers
    from lvv_tpu_torch.ops import attention as A
    from lvv_tpu_torch.ops import fused_mlp as M
    from lvv_tpu_torch.ops.autograd import FlashAttentionFn

    def flash(q, k, v, *, causal=False, kv_len=None, scale=None):
        if kernels.wants_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, kv_len, scale)
        return A.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                       scale=scale)
    with plain_kernels():
        saved = (layers.norm_fast, layers.add_norm_fast, A.flash_attention,
                 layers.Dense.forward)
        layers.norm_fast = M.norm_plain
        layers.add_norm_fast = M.add_norm_plain
        A.flash_attention = flash
        if lora_scaling is not None:
            def forward(self, x, kernel=None):
                if self.lora_rank:
                    self.scaling, keep = lora_scaling, self.scaling
                    try:
                        return saved[3](self, x, kernel)
                    finally:
                        self.scaling = keep
                return saved[3](self, x, kernel)
            layers.Dense.forward = forward
        try:
            yield
        finally:
            (layers.norm_fast, layers.add_norm_fast, A.flash_attention,
             layers.Dense.forward) = saved


def grads_against_plain(torch, model, labels, batch) -> dict:
    """Step 1's loss and group gradients: the kernels against the plain
    versions (TRAIN_LOSS_TOL, TRAIN_GRAD_TOL) and against the trap."""
    loss, fast, _ = group_grads(torch, model, labels, batch)
    with plain_training():
        plain_loss, slow, _ = group_grads(torch, model, labels, batch)
    scaling = {m.scaling for m in model.modules()
               if getattr(m, "lora_rank", 0)}
    with plain_training(lora_scaling=1.0):
        trap_loss, trap, _ = group_grads(torch, model, labels, batch)
    out = dict(loss=loss, plain_loss=plain_loss, trap_loss=trap_loss,
               loss_rel_vs_plain=abs(loss - plain_loss) / abs(plain_loss),
               lora_scalings=sorted(scaling),
               grad_rel_l2_vs_plain={g: rel_l2(fast[g], slow[g])
                                     for g in slow},
               trap_grad_rel_l2={g: rel_l2(trap[g], slow[g]) for g in slow},
               grad_norm_by_group={g: float(v.norm()) for g, v in
                                   fast.items()},
               tol=dict(loss_rel=TRAIN_LOSS_TOL, group_rel_l2=TRAIN_GRAD_TOL))
    if not all(map(math.isfinite, (loss, plain_loss))):
        raise AssertionError(f"train-step: non-finite loss {out}")
    if out["loss_rel_vs_plain"] > TRAIN_LOSS_TOL or any(
            v > TRAIN_GRAD_TOL for v in out["grad_rel_l2_vs_plain"].values()):
        raise AssertionError(f"train-step: kernels vs plain versions {out}")
    if all(v <= TRAIN_GRAD_TOL for v in out["trap_grad_rel_l2"].values()):
        raise AssertionError(f"train-step: the tolerance passes the trap "
                             f"{out['trap_grad_rel_l2']}")
    return out


def run_train_step(torch) -> dict:
    """train-step: make_train_step on default_config() at full width
    (LoRA 16 on the LLM, 8 on CLIP, bf16 working weights, fp32 masters),
    batch 4. Step 1's gradients against the plain versions, then the step
    run once to warm up, every trainable tensor's gradient non-zero after
    that update, TRAIN_STEPS timed steps (launches per step against the
    model's), one profiled step, and the frozen weights bit-equal to their
    values before the steps."""
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.models.vqa import _prefix_len
    from lvv_tpu_torch.train import (build_model, create_state,
                                     make_optimizer, make_train_step)
    cfg = train_config()
    model = build_model(cfg, "cuda")
    # the schedule of a 1,000-step run: step 1 is in its 30-step warmup
    tx, labels = make_optimizer(cfg.train.optim, model, 1000)
    state = create_state(model, tx,
                         torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, tx)
    batch = train_batch(torch, cfg)
    params = dict(model.named_parameters())
    frozen = {n: params[n].detach().clone() for n, g in labels.items()
              if g == "frozen"}
    report = grads_against_plain(torch, model, labels, batch)

    def one_step():
        out = step(state, batch)[1]
        torch.cuda.synchronize()
        return out
    t0 = time.perf_counter()
    first = one_step()
    report["first_step_s"] = time.perf_counter() - t0
    _, _, nonzero = group_grads(torch, model, labels, batch)
    zero = sorted(n for n, ok in nonzero.items() if not ok)
    if zero:
        raise AssertionError(f"train-step: zero gradients after an update: "
                             f"{zero[:10]} ({len(zero)})")
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], [first]
    kernels.launches.clear()
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics.append(one_step())
        times.append(time.perf_counter() - t0)
        if i == 0:
            counts = {k: v for k, v in kernels.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg.model, prompt_len=batch.text_ids.shape[1],
                             new_tokens=0)
    if counts != want:
        raise AssertionError(f"train-step launches {counts} != {want}")
    device = device_busy(torch, one_step)
    changed = [n for n, t in frozen.items() if not torch.equal(params[n], t)]
    if changed:
        raise AssertionError(f"train-step: frozen weights changed: "
                             f"{changed[:10]}")
    losses = [float(m["loss"]) for m in metrics]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"train-step: losses {losses}")
    tokens = float(metrics[-1]["tokens"])
    p50 = sorted(times)[len(times) // 2]
    report.update(
        batch=TRAIN_BATCH,
        seq_len=_prefix_len(cfg.model) + int(batch.text_ids.shape[1]),
        text_len=batch.text_len.tolist(),
        trainable_tensors=len(nonzero), frozen_tensors=len(frozen),
        trainable_params=sum(t.numel() for t in state.masters.values()),
        losses=losses, grad_norms=[float(m["grad_norm"]) for m in metrics],
        answer_tokens_per_step=tokens, times_s=times, s_per_step_p50=p50,
        answer_tokens_per_s=tokens / p50, peak_mem_gib=peak / 2 ** 30,
        **device, device_idle_share=1 - device["device_busy_s"] / p50,
        frozen_bit_equal=True, every_trainable_grad_nonzero=True,
        launches=counts)
    del model, state, step, batch, frozen, params
    torch.cuda.empty_cache()
    return report


def write_train_rows(root: pathlib.Path, cfg):
    """The fixture of tests/test_train_loop.py at full width under `root`:
    8 BEV grids [128, 180, 180] as float16 .npy (seeded normal), a caption
    and a det_area grounding QA row for each; returns cfg pointed at them
    (no nuScenes root: the views are missing, so zero-filled and invalid)."""
    import numpy as np
    from lvv_tpu_torch import config as C
    bev_dir = root / "bev"
    bev_dir.mkdir(parents=True)
    c, (h, w) = cfg.model.bev_channels, cfg.model.bev_hw
    rng = np.random.default_rng(0)
    cap, grd = [], []
    for i in range(8):
        tok = f"tok{i:02d}"
        np.save(bev_dir / f"{tok}.npy",
                rng.standard_normal((c, h, w), dtype=np.float32).astype(
                    np.float16))
        cap.append({"sample_token": tok, "question": f"What is in scene {i}?",
                    "answer": f"A car number {i}."})
        grd.append({"sample_token": tok, "question": "Where is the car?",
                    "answer_lidar": "[1, 2, 0, 4, 2, 1.5, 0.1]",
                    "template_type": "det_area"})
    (root / "cap.json").write_text(json.dumps(cap))
    (root / "grd.json").write_text(json.dumps(grd))
    for path, value in (("data.bev_features_dir", str(bev_dir)),
                        ("data.caption_json", str(root / "cap.json")),
                        ("data.grounding_json", str(root / "grd.json")),
                        ("data.nuscenes_root", ""),
                        ("data.val_fraction", 0.25)):
        cfg = C.override(cfg, path, value)
    return cfg


@contextlib.contextmanager
def timed_calls(cls, name: str, into: list):
    """Append the wall time (ending in a synchronise) of every call of
    cls.name while the block runs."""
    import torch
    orig = getattr(cls, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out
    setattr(cls, name, timed)
    try:
        yield
    finally:
        setattr(cls, name, orig)


def run_trainer(torch) -> dict:
    """trainer: Trainer.train() on default_config() at full width over
    write_train_rows' 16 QA rows (12 train, 4 held out: 3 steps of 4, a
    validation batch, 2 inference samples of up to 96 tokens), one epoch,
    its best and latest checkpoints under build/; then a second Trainer on
    the same config resumes from `latest`: its step, masters and working
    weights bit-equal to the first's. Reports the checkpoint's bytes and
    the save / load times, and the run's launches."""
    from lvv_tpu_torch import kernels
    from lvv_tpu_torch.train import CheckpointManager, Trainer
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = train_config(epochs=1, inference_samples=2, log_every=1,
                       output_dir=str(TRAIN_DIR / "run"))
    cfg = write_train_rows(TRAIN_DIR, cfg)
    saves, loads = [], []
    with timed_calls(CheckpointManager, "save", saves), \
            timed_calls(CheckpointManager, "restore", loads):
        t0 = time.perf_counter()
        first = Trainer(cfg)
        build_s = time.perf_counter() - t0
        kernels.launches.clear()
        t0 = time.perf_counter()
        result = first.train()
        train_s = time.perf_counter() - t0
        counts = {k: v for k, v in kernels.launches.items() if v}
        t0 = time.perf_counter()
        second = Trainer(cfg)
        resume_s = time.perf_counter() - t0
    if second.start_step != result["steps"] or not loads:
        raise AssertionError(f"trainer: resumed at {second.start_step}, "
                             f"trained {result['steps']} steps")
    got = dict(second.model.named_parameters())
    for name, t in first.model.named_parameters():
        if not torch.equal(got[name], t):
            raise AssertionError(f"trainer: {name} differs after resume")
    for name, t in first.state.masters.items():
        if not torch.equal(second.state.masters[name], t):
            raise AssertionError(f"trainer: master {name} differs")
    for name in ("norm", "ln_mlp_residual", "flash_attention",
                 "relpos_attention[14x14]", "relpos_attention[64x64]"):
        if not counts.get(name):
            raise AssertionError(f"trainer: {name} never launched")
    hist = result["history"][0]
    latest = TRAIN_DIR / "run" / "checkpoints" / "latest"
    report = dict(
        steps=result["steps"], train_loss=hist["train_loss"],
        val_loss=hist["val_loss"], epoch_s=hist["epoch_seconds"],
        inference=hist["inference"], trainer_build_s=build_s,
        train_s=train_s, resume_trainer_s=resume_s, saves_s=saves,
        load_s=loads[0], checkpoint_bytes=sum(
            f.stat().st_size for f in latest.rglob("*") if f.is_file()),
        checkpoints=sorted(p.name for p in latest.parent.iterdir()),
        history_written=(TRAIN_DIR / "run" / "history.json").exists(),
        resumed_at=second.start_step, launches=counts)
    del first, second
    shutil.rmtree(TRAIN_DIR)
    torch.cuda.empty_cache()
    return report


PROFILE_WATCH = re.compile(
    r"CUDAFunctor_add<c10::BFloat16>|norm_kernel|flash_f32_")


def device_busy(torch, generate) -> dict:
    """One generate under torch.profiler: the device's busy time (sum of
    its kernels' durations; the idle share is taken against the unprofiled
    p50) and the run's wall time with the profiler on. Prints the top
    kernels by device time (names cut to 100 characters), then the
    PROFILE_WATCH kernels below them (`profile-watch`). Only the CUDA
    activity is traced: the host's op events add nothing to these sums
    and made `key_averages` take most of each profiled phase's time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        generate()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in dev) / 1e6
    ranked = sorted(dev, key=lambda e: -e.self_device_time_total)
    for e in ranked[:20]:
        print(f"profile-top {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d}x {e.key[:100]}")
    # the launches that K-a's add form takes in, and K-e's fp32 form,
    # wherever they rank
    for e in ranked[20:]:
        if PROFILE_WATCH.search(e.key):
            print(f"profile-watch {e.self_device_time_total / 1e3:9.3f} ms "
                  f"{e.count:6d}x {e.key[:100]}")
    return dict(profiled_wall_s=wall, device_busy_s=busy_s)


# End to end, bf16 kernel path vs the plain path on the same weights: the
# two differ by bf16 rounding at different points (and tanh- vs erf-GELU in
# SAM's MLPs) through ~70 layers of random weights; 5% relative L2 on the
# last prefill logits leaves room for that and catches a wrong layer.
LOGITS_REL_TOL = 0.05
# the sm_90a window and K-h float kernels whose v is 64 deep (mangled
# win_sm90<64, ...> and kh_stream_sm90<DQ, 64, ...>), every kernel of the
# GEMM core's sources (mlp_gemm_sm90 of K-b, K-f and K-i, mlp_ln_*,
# mlp_quant_h, mlp_combine, mlp_wmax, mlp_wquant, K-i's w8a8_rows), of the
# int8 p@v core, K-j's (qmv_kn), K-k's (qmv_nk_fma, qmv_nk_mma) and K-g's
# (qk8_sm90, qk8_prep), K-a's (norm_kernel) and the q·R preps'
# (qr_lanes_kernel, qr_rows_kernel): ptxas must report no spill for them
NO_SPILL = re.compile(r"win_sm90ILi64E|kh_stream_sm90ILi\d+ELi64E|mlp_|"
                      r"pv8_sm90|pv8_v_|qmv_kn|qk8_|qmv_nk_|w8a8_rows|"
                      r"norm_kernel|qr_lanes_|qr_rows_")


PHASES = ("kernels", "main-path", "lidar-bev", "detector-train",
          "detector-zoo", "detector-camera", "detector-two-stage",
          "detector-waymo", "detector-mppnet", "detector-focal", "serving",
          "sam1280", "serving-runtime", "train-step", "trainer")
# the phases that build no kernel: their paths launch none
NO_KERNELS = {"detector-train", "detector-two-stage", "detector-waymo",
              "detector-mppnet", "detector-focal"}
# lidar-bev feeds its BEV to the float path's model; the serving phases hold
# their logits to the float path's
NEEDS = {"lidar-bev": "main-path", "serving": "main-path"}


def selected_phases(argv=None) -> tuple:
    """The phases to run, in PHASES order: every one, or those that
    `--only a,b` names and what they need."""
    import argparse
    p = argparse.ArgumentParser(description="On-card smoke run of the port.")
    p.add_argument("--only", default=None,
                   help="comma-separated phases of " + ", ".join(PHASES)
                   + " (default: all; the kernels line needs all)")
    only = p.parse_args(argv).only
    if only is None:
        return PHASES
    chosen = {x.strip() for x in only.split(",") if x.strip()}
    if not chosen or chosen - set(PHASES):
        p.error(f"--only takes names of {', '.join(PHASES)}; got {only!r}")
    chosen |= {NEEDS[c] for c in chosen if c in NEEDS}
    return tuple(x for x in PHASES if x in chosen)


def main(argv=None) -> int:
    run = set(selected_phases(argv))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "lvv_tpu_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    from lvv_tpu_torch import kernels
    t0 = time.perf_counter()
    reports = kernels.build_all() if run - NO_KERNELS else {}
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    spills = []
    for name, log in reports.items():
        entry = ""       # the kernel that ptxas reports on next
        for ln in log.splitlines():
            if "Compiling entry function" in ln and "'" in ln:
                entry = " " + ln.split("'")[1]
            elif "registers" in ln or "spill" in ln:
                print(f"  ptxas {name}{entry}: {ln.strip()}")
                if (NO_SPILL.search(entry) and "spill stores" in ln
                        and not ln.strip().endswith(
                            "0 bytes spill stores, 0 bytes spill loads")):
                    spills.append(f"{name}{entry}")
    sys.stdout.flush()
    if spills:
        raise AssertionError(f"kernels that must not spill do: {spills}")

    clock, phase_s = [time.perf_counter()], {}

    def emit(tag: str, report: dict) -> None:
        """Print a phase's line; keep its wall time since the last phase."""
        now = time.perf_counter()
        phase_s[tag], clock[0] = now - clock[0], now
        print(tag, json.dumps(report), flush=True)

    rows = None
    if "kernels" in run:
        rows = check_kernels(torch)
        ab_lines(torch)
        print("norm-host", json.dumps(norm_host(torch)), flush=True)
        phase_s["kernel-checks and A/B lines"] = (time.perf_counter()
                                                  - clock[0])
    clock[0] = time.perf_counter()
    torch.cuda.empty_cache()
    paths = {}
    if "main-path" in run:
        paths["float"], float_logits, model = run_float_path(torch)
        emit("main-path", paths["float"])
        if "lidar-bev" in run:
            paths["lidar-bev"] = run_lidar_bev(torch, model)
            emit("lidar-bev", paths["lidar-bev"])
        del model
        torch.cuda.empty_cache()
    if "detector-train" in run:
        paths["detector-train"] = run_detector_train(torch)
        emit("detector-train", paths["detector-train"])
    if "detector-zoo" in run:
        paths["detector-zoo"] = run_detector_zoo(torch)
        emit("detector-zoo", paths["detector-zoo"])
    if "detector-camera" in run:
        paths["detector-camera"] = run_detector_camera(torch)
        emit("detector-camera", paths["detector-camera"])
    if "detector-two-stage" in run:
        paths["detector-two-stage"] = run_detector_two_stage(torch)
        emit("detector-two-stage", paths["detector-two-stage"])
    for name, phase in (("detector-waymo", run_detector_waymo),
                        ("detector-mppnet", run_detector_mppnet),
                        ("detector-focal", run_detector_focal)):
        if name in run:
            paths[name] = phase(torch)
            emit(name, paths[name])
            torch.cuda.empty_cache()
    if "serving" in run:
        served = serving_model(torch)
        paths["serving"], mlp_logits = run_serving_path(
            torch, served, "mlp", float_logits, "float")
        emit("serving-path", paths["serving"])
        paths["bench-stream"] = run_bench_stream(torch, served,
                                                 paths["serving"])
        emit("bench-stream", paths["bench-stream"])
        name = f"serving-batch[{SERVING_BATCH}]"
        paths[name] = run_serving_batch(torch, served)
        emit(name, paths[name])
        torch.cuda.empty_cache()
        emit("u8-check", run_u8_check(torch, served))
        for scope in SCOPES:
            paths[scope], _ = run_serving_path(torch, served, scope,
                                               mlp_logits, "mlp")
            emit(f"serving-path[{scope}]", paths[scope])
        del served
        torch.cuda.empty_cache()
    if "sam1280" in run:
        large = f"sam{LARGE}"
        paths[large], large_logits, _ = run_float_path(torch, LARGE)
        emit(f"main-path[{large}]", paths[large])
        torch.cuda.empty_cache()
        served = serving_model(torch, LARGE)
        name = f"{large},{LARGE_SCOPE}"
        paths[name], _ = run_serving_path(torch, served, LARGE_SCOPE,
                                          large_logits, f"float_{large}")
        emit(f"serving-path[{name}]", paths[name])
        del served
        torch.cuda.empty_cache()
    if "serving-runtime" in run:
        report, loader, preset = preset_checkpoint(torch)
        emit("serving-checkpoint", report)
        from lvv_tpu_torch import prepare_serving_params_fused
        packed = prepare_serving_params_fused(preset)
        for name, phase in (
                (f"serving-engine[{ENGINE_BATCH}]", run_serving_engine),
                (f"continuous[{ENGINE_BATCH}]", run_continuous),
                ("serve-http", run_serve_http)):
            paths[name] = phase(torch, preset, loader.tokenizer, packed)
            emit(name, paths[name])
        paths["infer-cli"] = run_infer_cli(torch, preset, loader.tokenizer)
        emit("infer-cli", paths["infer-cli"])
        del preset, packed
        shutil.rmtree(PRESET_DIR)
        torch.cuda.empty_cache()
    for name, phase in (("train-step", run_train_step),
                        ("trainer", run_trainer)):
        if name in run:
            paths[name] = phase(torch)
            emit(name, paths[name])
    print("phase-seconds", json.dumps(phase_s), flush=True)
    for name, e2e in paths.items():
        for key in ("logits_rel_l2_vs_plain", "step_logits_rel_l2_vs_plain"):
            worst = max([e2e.get(key, 0.0)] + e2e.get(f"{key}_by_row", []))
            if worst > LOGITS_REL_TOL:
                raise AssertionError(f"{name} path: {key} = {worst:.4f}")
    if run == set(PHASES):
        print(json.dumps({"kernels": kernel_rows(rows, paths)}))
    else:
        print(f"kernels line: not printed (--only ran {sorted(run)})")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernel_rows(rows, paths) -> list:
    """The kernels line's rows: each kernel's check (`rows`) and its
    launches on every driven path (`paths`)."""
    def at(res) -> str:
        if isinstance(res, int):
            return f"SAM {res}²"
        if res[0] in ("zoo", "camera"):
            return f"{res[1]}'s detect at its nuScenes preset (fp32)"
        if res[0] == "train":
            return (f"a train step at batch {res[1]} (its causal attention, "
                    "add + RMS and CLIP MLP shapes only)")
        return (f"the serving preset, batch {res[1]}" if res[0] == "preset"
                else f"SAM {res[0]}², batch {res[1]}")
    out = []
    for name, (route, source, replaces) in ROWS.items():
        by_res = rows[name]
        res = next((r for r in (1024, LARGE, None) if r in by_res),
                   next(iter(by_res)))
        r = by_res[res]
        by_path = {p: e["launches"].get(name, 0) for p, e in paths.items()}
        row = dict(
            name=name, route=route, source=source, replaces=replaces,
            # per generate (or bucket, or train step), as ms: a
            # bench-stream dispatch runs G of them, the continuous engine's
            # and the trainer's runs are totals
            launches=max(k for p, k in by_path.items()
                         if p not in ("bench-stream", "trainer",
                                      f"continuous[{ENGINE_BATCH}]")),
            launches_by_path=by_path,
            max_abs_err=max(t["max_abs_err"] for t in by_res.values()),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            library_ms=r["library_ms"] if r["has_library"] else None,
            times_per=("call (no path runs it)" if res is None
                       else at(res) if isinstance(res, tuple)
                       and res[0] in ("zoo", "camera")
                       else f"generate at {at(res)}"))
        if len(by_res) > 1:
            row["per_generate_at"] = {
                at(k): dict(ms=t["ms"], plain_ms=t["plain_ms"],
                                  bound_ms=t["bound_ms"],
                                  library_ms=t["library_ms"]
                                  if t["has_library"] else None)
                for k, t in by_res.items()}
        out.append(row)
    return out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
