#!/usr/bin/env python3
"""Start-up check of the PyTorch port (vision_transformers_tpu_torch) on one
NVIDIA H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version, runs full-width ViT-S/16 (also with dropout, with the FF
kernel and under the 'block' force), Swin-S (also under 'block' and under
'swin', the map-resident whole layer), Halo-S (also on the gather path),
PVT-S, Twins-SVT-S and DINO DeiT-S/16 against the JAX package's stored
logits, train-step gradients and DINO step, ViT-S/16, Swin-S and DINO
DeiT-S/16 at bf16 (the confs' default precision) against the JAX
package's bf16 and f32, and drives the serving and the training entry
points of the five models and DINO's trainer end to end, ViT-S/16's,
Swin-S's and DINO's also at bf16.

    python3 chip_smoke.py

Phases (each prints its lines and raises on failure, so the script exits
non-zero and prints no ok line):

1. probe   torch / CUDA / nvcc / nvidia-smi / PIL; the card must be sm_90
2. build   nvcc → shared library, one nvcc per source in parallel (timed);
           ptxas's registers and spills, how many kernels spill, and the
           tensor-core instruction counts (cuobjdump -sass: HMMA, HGMMA) of
           every instantiation of the tensor-core attention kernels (B6,
           B3, B8 and the bias-free attention of B1 and B2 on
           attention_tc.cuh; B5a, B5b and B4 on halo_attention_tc.cuh; the
           bias calls of B1, B2 and B9 on window_attention_tc.cuh) and of
           the GEMM core (raises on a copy without one)
3m. gemm   the GEMM core (csrc/gemm_tc.cu, 3xTF32 on wgmma), under every
           projection of B1, B2, B4, B7, B8 and B9, alone through its thin C
           entry: the three forms (row-major A with the epilogue; B9's map
           forms; split-K over Aᵀ storage), every epilogue combination the
           paths use, the weight K-major and N-major, odd small shapes and
           the main paths' products (ViT-S/16 at 25,216 rows, Swin-S stages
           1 and 3 at 64 images, their split-K weight gradients); row forms
           within atol = rtol = 1e-4 of torch.matmul in f32 (TF32 off),
           split-K within 1e-3·max(1, max|plain|) and bit-identical across
           two runs; median ms, TFLOP/s and the bound beside torch.matmul's
           f32 time
3. kernels each forward kernel vs its plain version, f32, atol = rtol = 1e-4
           (same f32 math, another summation order over K ≤ 3072): at an odd
           small shape, at every ViT-S shape phases 5 and 6 give it (48 / 160
           rows serving, 128 rows the trainer's eval) and at the timed ViT-S
           shapes; the whole-layer kernel also with Swin's grouped bias and
           both row scales at an odd small shape and at every Swin-S stage of
           the trainer (64 images) and of its eval (128 images), and the
           attention layer with Twins-SVT-S stage 3's pair mask (B1's bias
           call, 128 images); median ms of kernel and plain version
3b. backward each forward (with saves) + backward kernel vs the plain forward
           + plain backward, with and without row scales; per tensor max |Δ|
           ≤ 1e-3·max(1, max|plain|) (f32 sums over all rows in another
           order); two runs bit-identical; median ms.  The attention layer
           at an odd small shape and at the ViT trainer's B=128 (no bias:
           the packed-row tensor-core attention); the whole layer, with the
           grouped bias, at an odd small shape and at the four Swin-S
           stages of the trainer's 64-image micro-batches, and without one
           at ViT-S/16's widths (8 rows)
3h. halo   the Halo kernels vs their plain versions at two odd small shapes
           and at the four Halo-S @256 stages at 128 images (the trainer's
           batch and its eval's): the whole Halo layer's forward (serving
           call, no saves) with the bias and both row scales, atol = rtol =
           1e-4; the map-resident halo attention's forward, and its time
           beside F.scaled_dot_product_attention with the bias as attn_mask
           on the gathered [b·S, H, w², k²] problem (gather excluded)
3hb.       each Halo kernel's forward (with saves) + backward vs the plain
           forward + plain backward, the layer with and without row scales,
           the halo attention also at heads 64 wide; per tensor ≤
           1e-3·max(1, max|plain|); two runs bit-identical; median ms at
           each stage's training call; the bounds at the tensor-core rate
           (the layer's GEMMs on the GEMM core, its attention and the halo
           attention on halo_attention_tc.cuh)
3b (Twins) the attention layer with Twins' [m, m] pair mask (−1e9 across the
           windows of a packed pair) and a row scale, serving forward,
           training forward and backward vs the plain versions (per tensor
           ≤ 1e-3·max(1, max|plain|), two runs bit-identical), at an odd
           shape (also with the mask's gradient) and at the four Twins-SVT-S
           stages at 128 images (the mask at stages 1-3; stage 4 without
           one, 49 tokens, heads 32 wide, on the packed-row tensor-core
           attention); median ms
3d.        the attention layer with DINO's block mask (−1e9 across the 3
           crops of 37 tokens a packed row; heads 64 wide, so the
           packed-row tensor-core attention with the bias, not the window
           attention): serving forward, training forward and backward vs the
           plain versions (forward atol = rtol = 1e-4, per tensor ≤
           1e-3·max(1, max|plain|), two runs bit-identical, the mask without
           a gradient, each crop's output unmoved by the other crops'
           tokens) at an odd call (2 crops a row, 74 tokens) and at DINO
           DeiT-S/16's local call at 96 images (256 rows of 111 tokens);
           median ms beside the plain version and
           F.scaled_dot_product_attention with the mask as a float attn_mask
           (the attention alone), forward and its autograd backward; then
           the same calls at bf16 (B1's bf16 form with the mask on the
           packed-row attention's bf16 form; the odd call with per-sample
           row scales) within phase 3bf's limits, bit-identical, the median
           ms of the local call beside the plain version and the bound at
           the bf16 rate
3s.        the reduced-kv attention (PVT's SRA, Twins' GSA) on the models'
           strided head views: serving forward and training forward (with
           lse) within atol = rtol = 1e-4, backward per tensor within
           1e-3·max(1, max|plain|) and bit-identical across two runs, at odd
           shapes (M ≠ N, N = 1, 4, 9; heads 64, 32, 24 wide; the bias as
           [M, N], [1, M, N] and [G, M, N] with its gradient, N up to 97)
           and at every PVT-S and Twins-SVT-S call at 128 images; median ms
           beside F.scaled_dot_product_attention on the same problem,
           forward and its autograd backward; bound at the tensor-core rate
3q.        the packed-qkv attention (ViT's dropout path, Swin's forced
           'fused'): serving forward and training forward (with lse) within
           atol = rtol = 1e-4, backward per tensor within 1e-3·max(1,
           max|plain|) and bit-identical across two runs, at odd shapes (no
           bias at D = 64; each bias form — [N, N], [H, N, N], [1, N, N],
           grouped — at D = 32; [H, N, N] and grouped at D = 64), at ViT-S/16's
           training call (B 128) and at Swin-S's four stages at 64 images
           with the grouped bias; median ms beside
           F.scaled_dot_product_attention on [B, H, N, D] views of the same
           qkv, forward and its autograd backward; bound at the tensor-core
           rate
3f.        the FF residual branch (the FF-kernel path): the same checks with
           silu at ViT-S/16's call (M = 25,216 rows, C 384, F 1536) with and
           without the row scale, silu and tanh-gelu at an odd shape; median
           ms of the ViT-S/16 training call
3g.        the gathered halo attention (Halo's gather path): serving forward
           and training forward (with lse) within atol = rtol = 1e-4,
           backward per tensor within 1e-3·max(1, max|plain|) and
           bit-identical across two runs, on neighbourhoods gathered from
           seeded maps as the model gathers them: an odd call (a 12x8 map,
           window 4, halo 3, heads 24 wide), window 8 / halo 5 (324 keys,
           past the keys a block keeps resident), heads 64 wide, the four
           Halo-S stages at 128 images (B' = 8192 / 2048 / 512 / 128
           windows of 64 queries, 144 keys) and stage 1 of the window-4 /
           halo-3 model at 128 images (B' = 32,768 windows of 16 queries,
           100 keys); median ms beside F.scaled_dot_product_attention on the
           same gathered problem; bound at the tensor-core rate
3k.        the attention block (ViT's and Swin's 'block' path): the same
           checks at an odd call ([N, N] bias, Cout 40 ≠ C 48), heads 64
           wide with a grouped bias (odd) and an [H, N, N] bias (ViT-S/16
           widths), ViT-S/16 at B 128 and 64 (no bias) and Swin-S's four
           stages at 64 images with the grouped bias; median ms beside
           F.multi_head_attention_forward (need_weights=False, the same
           weights, the bias as a float mask) and its autograd backward
3w.        the map-resident Swin layer (Swin's 'swin' path) at SWIN_ODD and
           the four Swin-S stage calls of the trainer (64 images), each shifted
           (the grouped layout-native bias) and unshifted (one slab), with
           and without both per-image row scales: serving forward and
           training forward within atol = rtol = 1e-4, backward per tensor
           within 1e-3·max(1, max|plain|) and bit-identical across two
           runs; median ms of the shifted call with row scales beside the
           plain version and beside the whole-layer kernel between the
           torch roll / window partition and unpartition / unroll (the
           'layer1' path's layer), forward with saves and backward
3a.        the tensor-core window attention alone (csrc/window_attention_tc.cuh:
           the attention of B1's bias calls, B2 and B9) through its thin C
           entries, at the four Swin-S stages of the trainer (64 images, the
           shifted layers' grouped bias), Twins-SVT-S stage 3's pair mask (128
           images), SWIN_ODD and 113 tokens in 3 groups, each in B2's
           group-major and B9's sample-major layout: forward (out, lse)
           within atol = rtol = 1e-4, backward (dqkv, dbias) within
           1e-3·max(1, max|plain|) and bit-identical across two runs; median
           ms forward and backward beside the plain version,
           F.scaled_dot_product_attention with the bias as a float attn_mask
           (its backward taking the bias's gradient) and the bound at the
           tensor-core rate
3bf. bf16  the bf16 forms (bf16 activations, weights and biases; f32
           statistics, sums and LN parameters): the GEMM core's (its row
           form with each epilogue the paths use, its f32-out form, its
           split-K form with B's row scale) at odd shapes and ViT-S/16's
           products at 128 images (qkv, out projection, the eval's FF1 /
           FF2, dln, the dW split-K sums), each call's route printed (TMA
           or the register path: only operands off 16-byte rows), the
           products timed on the device (a CUDA graph of 10 calls) beside
           torch.matmul in bf16 with f32 reduction; the promotion check
           (one accumulator over K and the sums promoted every 64 k against
           an f64 product at ViT-S/16's K and the split-K slabs' depths,
           within 1e-3·max(1, max|f64|)); B1 forward (saves, serving) and backward at
           two odd calls (N 17, 33, heads 32 wide) and the ViT-S/16
           trainer's (128 x 197, with and without per-sample row scales),
           B2's serving forward at the same shapes: forward within
           1.6e-2·max(1, max|plain|) (4 bf16 ulps), each gradient within
           3e-2·max(1, max|plain|) and bit-identical across two runs; median
           ms of B1 forward / backward at the trainer's call and B2 at the
           eval's, bounds at the dense bf16 rate (989 TFLOP/s); the
           packed-row attention's bf16 form alone (csrc/attention_bf16_tma.cuh,
           wgmma fed by TMA): forward with and without lse and backward
           against their plain versions at odd shapes (N 1 to 577, heads
           16 to 64 wide), the backward bit-identical across two runs, and
           at ViT-S/16's 128 x 197 timed on the device (a CUDA graph of 10
           calls; the backward with its dq sum) beside
           F.scaled_dot_product_attention's forward and its backward alone
           (torch.autograd.grad on a retained graph) on the same bf16 q, k,
           v, the single-call medians beside; and with the bias (the
           HAS_BIAS instantiations): DINO's block mask at the local call
           (256 x 111, 6 x 64) and a grouped bias (G = 2) over 200 tokens
           whose second block's queries find their first 128-key tile all
           masked, forward and backward against the plain versions,
           bit-identical, timed at DINO's call beside SDPA with the mask as
           a bf16 float attn_mask.  Swin-S (swin_bf16_kernels): B2's bf16
           training forward (saves, the grouped bias, both row scales) and
           backward (every gradient, the bias's among them) and the
           packed-row attention's bf16 backward with the bias's gradient
           alone, at the four Swin-S stage calls of the trainer (64
           images), within the same limits, bit-identical across two runs;
           median ms of B2's forward and backward beside the plain versions
           and the bounds, and the attention's backward with dbias on the
           device beside scaled_dot_product_attention's backward alone with
           the bias as a float attn_mask, the f32 window attention's
           backward with dbias and the bound
3hbf.      Halo-S at bf16 (halo_bf16_kernels): the halo core's bf16
           kernels (E = BF16) as ptxas built them, 0 spill bytes or the
           phase fails; B4's bf16 training forward (saves, the bias, both
           row scales), serving forward and backward at the four Halo-S
           stage calls (128 images), B5a's forward (lse) and backward at
           stage 1 and B5b's at stage 1 and at window 4 / halo 3, each
           against its plain version at bf16 within the same limits, every
           backward bit-identical across two runs; median ms of each beside
           the plain versions and the bounds at the bf16 rate, and for B5a
           / B5b F.scaled_dot_product_attention on the same gathered problem
           (bf16, the bias a float attn_mask), forward and backward with the
           mask's gradient, on the device
4. golden  ViT-S/16 @224 (depth 12), Swin-S @224 (depth 24), Halo-S @256
           (depth 12), PVT-S @224 (depth 16) and Twins-SVT-S @224 (depth
           18), seeded weights, against the JAX logits in
           tests/data/*_port_golden.npz: ViT at 64 rows ('layer') and 256
           rows ('layer1'), Swin at 64 and 128 rows ('layer1'), Halo at 64
           and 128 rows (the whole Halo layer), PVT at 64 and 128 rows with
           its reduced-kv attention forced to 'fused', Twins at 64 and 128
           rows on its default (the attention layer with the mask) and with
           its global attention forced to 'fused', Halo forced to 'gather'
           (64, 128 rows), ViT-S/16 and Swin-S forced to 'block' (64 rows),
           Swin-S forced to 'swin' (64 rows); max |Δ| ≤ 1e-3·max(1,
           max|golden|)
4b. train  one f32 train-step gradient (drop_path 0) of each model on the 2
           golden images tiled to 64 rows (ViT through the attention layer's
           kernels, Swin through the whole layer's, Halo through the whole
           Halo layer's and, forced to 'direct', through the halo
           attention's, PVT through the reduced-kv attention's, Twins
           through the attention layer's with the mask and, with 'fused'
           global attention, the reduced-kv attention's too; ViT with the FF
           kernel on, through the attention layer's and the FF layer's; Swin
           forced to 'fused', through the packed-qkv attention's) against
           tests/data/*_port_train_golden.npz, and ViT at dropout = drop_ff
           = 0.1 forced to 'fused' (the packed-qkv attention's kernels, the
           masks regenerated from the golden's seed) against
           tests/data/vit_s16_port_dropout_train_golden.npz; Halo forced to
           'gather' (the gathered halo attention's kernels), ViT-S/16 and
           Swin-S forced to 'block' (the attention block's) against their
           train goldens, ViT-S/16 with dropout under 'block' against
           the dropout golden, and Swin-S forced to 'swin' (the map-resident
           layer's kernels) against its train golden: loss, gradient norm,
           per-tensor norms and projections, rtol 1e-3
4d. DINO   one f32 DINO step of DeiT-S/16 (depth 12, the head to 65,536)
           under the 'layer' force on 3 seeded images (6 globals at 224, 24
           locals at 96 packed 3 to a row under the mask), seeded student,
           teacher and center, against tests/data/dino_deit_s16_port_golden.npz
           (scripts/make_torch_port_dino_golden.py): the loss, both nets'
           outputs as per-crop norms and projections, the gradient norm and
           each tensor's gradient norm and projection, rtol 1e-3; B1 in every
           layer, with the mask on the locals
4bf. bf16  ViT-S/16 in bf16 (seeded weights, DropPath off) against
           tests/data/vit_s16_bf16_port_golden.npz
           (scripts/make_torch_port_bf16_golden.py: the JAX package at bf16
           on B1 and B2 in interpret mode, and at f32): the golden's two
           images' logits tiled to 64 rows on B1's bf16 form and to 256 rows
           on B2's, and one train step at 64 rows on B1's bf16 forward and
           backward (loss, gradient norms and projections, a few whole
           gradients), each within 3 x the JAX package's own bf16 error;
           DINO DeiT-S/16's step at bf16 under the 'layer' force (B1's bf16
           form in every layer, the locals with the mask) against
           tests/data/dino_deit_s16_bf16_port_golden.npz: the loss's 54
           cross-entropies, the tensors' gradient norms and projections,
           both nets' output norms and projections within 3 x JAX's bf16
           gap, the loss and the gradient norm within 3 x the root mean
           square of JAX's gaps over six seeds; Swin-S at bf16 against
           tests/data/swin_s_bf16_port_golden.npz
           (scripts/make_torch_port_swin_bf16_golden.py): the logits tiled
           to 64 rows and one train step at 64 rows on B2's bf16 forms with
           the grouped bias ('layer1'), within 3 x JAX's bf16 gap (the
           loss's: the root mean square over six seeds)
4hbf.      Halo-S at bf16 against tests/data/halo_s_bf16_port_golden.npz
           (scripts/make_torch_port_halo_bf16_golden.py): the logits tiled
           to 64 rows and one train step at 64 rows on B4's bf16 forms (the
           default 'layer'), within 3 x JAX's bf16 gap (the loss's: the
           root mean square over six seeds)
5. predict the serving path of each model: ``predict.main`` on 48 and then
           160 seeded JPEGs (Halo, PVT — 'fused' — and Twins: 48) with a
           seeded ``.pt:ema``; the launch counters are zeroed just before
           and read just after
6. trainer each model's training path: ``train.main`` f32, batch 128, one
           synthetic epoch (4 train steps, then a valid pass of 256 images)
           — ViT-S/16 from configs/vit-s-16.conf (DropPath 0.1 through the
           attention layer's forward and backward kernels, eval through the
           whole-layer kernel), Swin-S from configs/swin-transformer-s.conf
           (grad_accumulation 2, so 64-image micro-batches, DropPath 0.3,
           forward and backward of the whole-layer kernel), Halo-S from
           tests/data/halo_s_port.conf (DropPath 0.1; 12 forward and 12
           backward whole-Halo-layer launches per step, none of another
           path) and Halo-S forced to 'direct' (the halo attention's forward
           and backward between plain projections), PVT-S from
           tests/data/pvt_s_port.conf with its reduced-kv attention forced
           to 'fused' (DropPath 0.1; 16 forward and 16 backward launches
           per step) and Twins-SVT-S from tests/data/twins_svt_s_port.conf
           on its default (DropPath 0.1; 18 forward and 18 backward
           attention-layer launches per step, 14 + 14 with the mask), ViT-S/16
           with ``arch.dropout=0.1 arch.drop_ff=0.1`` (12 + 12 packed-qkv
           attention launches per step, eval through the whole-layer
           kernel) and ViT-S/16 with the FF kernel on (12 + 12 attention
           layer and 12 + 12 FF layer launches per step), Halo-S forced to
           'gather' and Halo-S with ``arch.window_size=4 arch.halo_size=3``
           on its default dispatch (12 + 12 gathered halo attention launches
           per step each), ViT-S/16 under 'block' without and with dropout
           (12 + 12 attention block launches per step, the valid pass on
           the block too), Swin-S under ``VTX_ATTN_IMPL=swin`` set in the
           environment (24 + 24 map-resident layer launches per
           micro-batch, the valid pass on it too) and Swin-S with
           ``arch.drop_attn=0.1 arch.drop_ff=0.1`` (training on the two
           residual branches with einsum attention, the valid pass on the
           whole-layer kernel); the counters are zeroed just before and
           read just after each; then ``predict.main`` reads the epoch
           checkpoint.  DINO: ``train_dino.main`` f32 from
           configs/dino_deit-s-16.conf at 96 images a step (the conf's 1024
           cut to fit one card), two synthetic epochs of 4 steps, the first
           with the last layer frozen, student_drop_path 0.1: per step and
           layer B1 on the student's 192 global rows and, with the mask, its
           256 packed local rows, forward and backward, and B2 on the
           teacher's 192 global rows (192 + 192 B1 launches, 96 + 96 of them
           with the mask, 96 B2 launches); the steady-state step time.
           ViT-S/16, Swin-S and DINO at the confs' default precision, bf16
           (no precision override): the same launches as their f32 runs,
           every one on the bf16 forms (DINO's locals with the mask, Swin's
           layers with the grouped bias, its gradient on the packed-row
           attention's bf16 backward); the steady-state step, images/s and
           peak memory of each printed beside its f32 run's.  Halo-S at f32
           and at the conf's default precision, bf16, side by side (B4 and
           its bf16 forms), predict serving the bf16 run's checkpoint at bf16
           (``--precision conf``: 12 launches of B4's bf16 forward), then at
           bf16 forced to 'direct' (B5a's bf16 forms); Halo-S forced to
           'gather' runs at bf16 (B5b's bf16 forms), window 4 / halo 3 at f32

The line before the last is the kernels' JSON record: each kernel's
launches on the trainer run that takes it (ViT's for the attention layer,
Swin's for the whole layer, Halo's for the whole Halo layer, Halo's forced
to 'direct' for the halo attention, PVT's forced to 'fused' for the
reduced-kv attention, ViT's with dropout for the packed-qkv attention,
ViT's with the FF kernel for the FF layer, Halo's forced to 'gather' for
the gathered halo attention, ViT's under 'block' for the attention block,
Swin's under ``VTX_ATTN_IMPL=swin`` for the map-resident layer, DINO's
for the attention layer's bias calls, ``+bias``, timed at DINO's local
call, ViT's at bf16 for the bf16 forms, ``[bf16]``, whose bound is at the
bf16 rate, DINO's at bf16 for the bf16 forms with the bias,
``+bias[bf16]``, timed at DINO's local call, Swin-S's at bf16 for B2's
bf16 forms with the bias and the attention's backward with dbias,
``+dbias[bf16]``, timed at the four Swin-S stages, Halo-S's at bf16 for
B4's bf16 forms, timed at the four Halo-S stages, its bf16 runs forced to
'direct' and 'gather' for B5a's and B5b's, timed at stage 1 (B5b at window
4 / halo 3 too), each with the halo core's bf16 kernels' registers and
spills; every path's in ``launches_by_path``) and its
times at a call that run makes (``shape``; other shapes in
``other_shapes``); the last line is ``{"ok": true, "device": {...}}``.
Needs no network and no JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
MODELS = {  # name → (conf, logits golden, train-step golden, depth)
    "ViT-S/16": (os.path.join(ROOT, "configs", "vit-s-16.conf"),
                 os.path.join(DATA, "vit_s16_port_golden.npz"),
                 os.path.join(DATA, "vit_s16_port_train_golden.npz"), 12),
    "Swin-S": (os.path.join(ROOT, "configs", "swin-transformer-s.conf"),
               os.path.join(DATA, "swin_s_port_golden.npz"),
               os.path.join(DATA, "swin_s_port_train_golden.npz"), 24),
    "Halo-S": (os.path.join(DATA, "halo_s_port.conf"),
               os.path.join(DATA, "halo_s_port_golden.npz"),
               os.path.join(DATA, "halo_s_port_train_golden.npz"), 12),
    "PVT-S": (os.path.join(DATA, "pvt_s_port.conf"),
              os.path.join(DATA, "pvt_s_port_golden.npz"),
              os.path.join(DATA, "pvt_s_port_train_golden.npz"), 16),
    "Twins-SVT-S": (os.path.join(DATA, "twins_svt_s_port.conf"),
                    os.path.join(DATA, "twins_svt_s_port_golden.npz"),
                    os.path.join(DATA, "twins_svt_s_port_train_golden.npz"), 18),
}
KERNELS = {  # name → (source, the TPU kernel it replaces)
    "fused_attention_layer": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                              "vision_transformers_tpu/ops/fused_layer.py:116"),
    "fused_attention_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_layer_bwd.cu",
                                  "vision_transformers_tpu/ops/fused_layer.py:183"),
    "fused_transformer_layer": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                "vision_transformers_tpu/ops/fused_layer1.py:91"),
    "fused_transformer_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_layer1_bwd.cu",
                                    "vision_transformers_tpu/ops/fused_layer1.py:181"),
    "fused_halo_layer": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                         "vision_transformers_tpu/ops/fused_halo_layer.py:92"),
    "fused_halo_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                             "vision_transformers_tpu/ops/fused_halo_layer.py:179"),
    "halo_attention_direct": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                              "vision_transformers_tpu/ops/fused_halo.py:252"),
    "halo_attention_direct_bwd": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                                  "vision_transformers_tpu/ops/fused_halo.py:282"),
    "fused_attention": ("vision_transformers_tpu_torch/csrc/fused_attention_qkv.cu",
                        "vision_transformers_tpu/ops/fused_attention.py:67"),
    "fused_attention_bwd": ("vision_transformers_tpu_torch/csrc/fused_attention_qkv.cu",
                            "vision_transformers_tpu/ops/fused_attention.py:92"),
    "fused_attention_qkv": ("vision_transformers_tpu_torch/csrc/fused_attention_qkv.cu",
                            "vision_transformers_tpu/ops/fused_attention.py:313"),
    "fused_attention_qkv_bwd": ("vision_transformers_tpu_torch/csrc/fused_attention_qkv.cu",
                                "vision_transformers_tpu/ops/fused_attention.py:342"),
    "fused_ff_layer": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                       "vision_transformers_tpu/ops/fused_layer.py:701"),
    "fused_ff_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_layer1_bwd.cu",
                           "vision_transformers_tpu/ops/fused_layer.py:743"),
    "halo_attention": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                       "vision_transformers_tpu/ops/fused_halo.py:44"),
    "halo_attention_bwd": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                           "vision_transformers_tpu/ops/fused_halo.py:72"),
    "fused_attention_block": ("vision_transformers_tpu_torch/csrc/fused_attention_qkv.cu",
                              "vision_transformers_tpu/ops/fused_block.py:57"),
    "fused_attention_block_bwd": ("vision_transformers_tpu_torch/csrc/fused_attention_qkv.cu",
                                  "vision_transformers_tpu/ops/fused_block.py:100"),
    "fused_swin_layer": ("vision_transformers_tpu_torch/csrc/fused_swin.cu",
                         "vision_transformers_tpu/ops/fused_swin.py:99"),
    "fused_swin_layer_bwd": ("vision_transformers_tpu_torch/csrc/fused_swin.cu",
                             "vision_transformers_tpu/ops/fused_swin.py:200"),
    # B1's calls with the additive bias, timed at DINO's packed local crops
    # (the block mask at heads 64 wide, on the packed-row core) and counted
    # on the DINO trainer's run
    "fused_attention_layer+bias": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                   "vision_transformers_tpu/ops/fused_layer.py:116"),
    "fused_attention_layer_bwd+bias": ("vision_transformers_tpu_torch/csrc/fused_layer_bwd.cu",
                                       "vision_transformers_tpu/ops/fused_layer.py:183"),
    # the bf16 forms (the JAX package's default precision), timed at the
    # ViT-S/16 trainer's and eval's calls and counted on the bf16 trainer's run
    "fused_attention_layer[bf16]": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                    "vision_transformers_tpu/ops/fused_layer.py:116"),
    "fused_attention_layer_bwd[bf16]": ("vision_transformers_tpu_torch/csrc/fused_layer_bwd.cu",
                                        "vision_transformers_tpu/ops/fused_layer.py:183"),
    "fused_transformer_layer[bf16]": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                      "vision_transformers_tpu/ops/fused_layer1.py:91"),
    # the attention inside B1's and B2's bf16 forms (the JAX kernels' bf16
    # attention, fused_layer.py:116 / :183, fused_layer1.py:91), timed alone
    # at ViT-S/16 and counted on the bf16 trainer's run
    "packed_attention[bf16]": ("vision_transformers_tpu_torch/csrc/attention_bf16_tma.cuh",
                               "vision_transformers_tpu/ops/fused_layer.py:116"),
    "packed_attention_bwd[bf16]": ("vision_transformers_tpu_torch/csrc/attention_bf16_tma.cuh",
                                   "vision_transformers_tpu/ops/fused_layer.py:183"),
    # the bf16 forms with the additive bias: B1 and its attention with
    # DINO's block mask, timed at DINO's local call and counted on the DINO
    # trainer's bf16 run
    "fused_attention_layer+bias[bf16]": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                         "vision_transformers_tpu/ops/fused_layer.py:116"),
    "fused_attention_layer_bwd+bias[bf16]": (
        "vision_transformers_tpu_torch/csrc/fused_layer_bwd.cu",
        "vision_transformers_tpu/ops/fused_layer.py:183"),
    "packed_attention+bias[bf16]": ("vision_transformers_tpu_torch/csrc/attention_bf16_tma.cuh",
                                    "vision_transformers_tpu/ops/fused_layer.py:116"),
    "packed_attention_bwd+bias[bf16]": (
        "vision_transformers_tpu_torch/csrc/attention_bf16_tma.cuh",
        "vision_transformers_tpu/ops/fused_layer.py:183"),
    # Swin-S at bf16: B2's training forward with the saves and the grouped
    # bias, its backward, and the packed-row attention's backward summing the
    # bias's gradient, timed at the four Swin-S stage calls of the trainer
    # (stage 1 first) and counted on the Swin-S trainer's bf16 run
    "fused_transformer_layer+bias[bf16]": ("vision_transformers_tpu_torch/csrc/fused_layer.cu",
                                           "vision_transformers_tpu/ops/fused_layer1.py:526"),
    "fused_transformer_layer_bwd+bias[bf16]": (
        "vision_transformers_tpu_torch/csrc/fused_layer1_bwd.cu",
        "vision_transformers_tpu/ops/fused_layer1.py:606"),
    "packed_attention_bwd+dbias[bf16]": (
        "vision_transformers_tpu_torch/csrc/attention_bf16_tma.cuh",
        "vision_transformers_tpu/ops/fused_layer1.py:606"),
    # Halo-S at bf16: the whole Halo layer's bf16 forms (the GEMM core's bf16
    # form and the halo core's, E = BF16), timed at the four Halo-S stage
    # calls of the trainer (stage 1 first) and counted on the Halo-S
    # trainer's bf16 run; the halo attention's bf16 forms, timed at stage 1
    # (the gathered one at window 4 / halo 3 too) and counted on the bf16
    # trainer runs forced to 'direct' and to 'gather'
    "fused_halo_layer[bf16]": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                               "vision_transformers_tpu/ops/fused_halo_layer.py:92"),
    "fused_halo_layer_bwd[bf16]": ("vision_transformers_tpu_torch/csrc/fused_halo.cu",
                                   "vision_transformers_tpu/ops/fused_halo_layer.py:179"),
    "halo_attention_direct[bf16]": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                                    "vision_transformers_tpu/ops/fused_halo.py:252"),
    "halo_attention_direct_bwd[bf16]": (
        "vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
        "vision_transformers_tpu/ops/fused_halo.py:282"),
    "halo_attention[bf16]": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                             "vision_transformers_tpu/ops/fused_halo.py:44"),
    "halo_attention_bwd[bf16]": ("vision_transformers_tpu_torch/csrc/halo_attention_tc.cuh",
                                 "vision_transformers_tpu/ops/fused_halo.py:72"),
}
# the tensor-core kernels (3xTF32): the attention of csrc/attention_tc.cuh, which
# B6, B3 and B8 run, and of csrc/halo_attention_tc.cuh, which B5a, B5b and B4's
# attention run (mma.sync), and the GEMM core of csrc/gemm_tc.cu, which every
# projection of B1, B2, B4, B7, B8 and B9 runs (wgmma); the build phase counts
# their tensor-core instructions, and their bound takes the f32-accurate
# tensor-core rate
TENSOR_CORE_FUNCTIONS = ("attn_fwd_kernel", "attn_bwd_kernel", "halo_fwd_kernel",
                         "halo_bwd_kernel", "window_fwd_kernel", "window_bwd_kernel",
                         "gemm_tc_kernel", "bf16_attn_fwd_kernel", "bf16_attn_bwd_kernel")
KERNEL_TOL = 1e-4
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd, timeout=60) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# 1. probe
# ---------------------------------------------------------------------------


def probe(torch):
    if not torch.cuda.is_available():
        raise SystemExit("probe: torch.cuda.is_available() is false; "
                         "chip_smoke.py needs an NVIDIA H100")
    from vision_transformers_tpu_torch.ops import _build

    log(f"probe: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    name, cap = torch.cuda.get_device_name(0), torch.cuda.get_device_capability(0)
    log(f"probe: device 0 {name}, capability {cap}, count {torch.cuda.device_count()}")
    if cap != (9, 0):
        raise RuntimeError(f"probe: the kernels are built for sm_90a; device 0 is {cap}")
    nvcc = _build.find_nvcc()
    log(f"probe: {nvcc}: " + run([nvcc, "--version"]).splitlines()[-1])
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = smi.splitlines()[0]
    log(card)
    try:
        import PIL
        has_pil = True
        log(f"probe: PIL {PIL.__version__} imports")
    except ImportError:
        has_pil = False
        log("probe: PIL does not import")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"probe: allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return name, card, has_pil


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def build():
    from vision_transformers_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.2f} s")
    for line in _build.BUILD_LOG.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "warning" in line):
            log(f"build: {line.strip()}")
    entries, spilling = spills(_build.BUILD_LOG)
    log(f"build: {len(spilling)} of {len(entries)} kernels spill (ptxas: spill stores or "
        f"loads > 0)" + "".join(f"\nbuild: spills: {name}" for name in sorted(spilling)))
    tensor_core_counts(_build, lib._name)
    return secs


def spills(build_log):
    """(every kernel ptxas compiled, those whose spill stores or loads are
    not 0), by mangled name, from nvcc's ``-Xptxas -v`` report."""
    entries, spilling, entry = set(), set(), None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            entries.add(entry)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry and (int(m.group(1)) or int(m.group(2))):
            spilling.add(entry)
    return entries, spilling


TMA_KERNEL_ARGS = ("BN", "TA", "TB", "F32OUT", "PROMO")


def gemm_bf16_builds(build_log):
    """Each kernel of the bf16 GEMM's TMA path (csrc/gemm_bf16_tma.cuh) that
    ptxas compiled: its template arguments, registers and spill bytes, from
    nvcc's ``-Xptxas -v`` report."""
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = None
            t = re.search(r"gemm_bf16_tma_kernelI((?:Li-?\d+E)+)E", m.group(1))
            if t:
                args = map(int, re.findall(r"Li(-?\d+)E", t.group(1)))
                cur = {"kernel": "gemm_bf16_tma_kernel<" + ", ".join(
                    f"{k}={v}" for k, v in zip(TMA_KERNEL_ARGS, args)) + ">"}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def attention_bf16_builds(build_log):
    """Each kernel of the bf16 packed-row attention (csrc/attention_bf16_tma.cuh)
    that ptxas compiled: its name, registers and spill bytes, from nvcc's
    ``-Xptxas -v`` report."""
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = None
            t = re.search(r"3abt\d+(bf16_attn_\w+?_kernel)(I(?:L[ib]\d+E)+E)?", m.group(1))
            if t:
                args = ",".join(re.findall(r"L[ib](\d+)E", t.group(2) or ""))
                cur = {"kernel": t.group(1) + (f"<{args}>" if args else "")}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


HALO_KERNEL_ARGS = {"halo_fwd_kernel": ("DH", "SAVE_LSE", "GATHER", "E"),
                    "halo_bwd_kernel": ("DH", "GATHER", "E", "ROUND")}


def halo_bf16_builds(build_log):
    """Each bf16 instantiation (E = 1) of the halo core's kernels
    (csrc/halo_attention_tc.cuh) that ptxas compiled: its template
    arguments, registers and spill bytes, from nvcc's ``-Xptxas -v``
    report."""
    out, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = None
            t = re.search(r"3hta\d+(halo_(?:fwd|bwd)_kernel)I((?:L[ib]\d+E)+)E", m.group(1))
            if t:
                args = dict(zip(HALO_KERNEL_ARGS[t.group(1)],
                                map(int, re.findall(r"L[ib](\d+)E", t.group(2)))))
                if args.get("E") == 1:
                    cur = {"kernel": t.group(1) + "<" + ", ".join(
                        f"{k}={v}" for k, v in args.items()) + ">"}
                    out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def tensor_core_counts(_build, library):
    """The tensor-core instructions in ``cuobjdump -sass`` (HMMA: mma.sync;
    HGMMA: wgmma) of each instantiation of the tensor-core kernels — the
    attention of attention_tc.cuh, halo_attention_tc.cuh and
    window_attention_tc.cuh, in each source that compiles them
    (fused_attention_qkv.cu alone for attention_tc.cuh: B6, B3, B8 and the
    f32 bias-free attention of B1 and B2; fused_halo.cu for B5a, B5b and
    B4; fused_layer.cu / fused_layer_bwd.cu for B1's bias calls, B2 and
    B9), the bf16 packed-row attention's (attention_bf16.cu) and the GEMM
    core's (gemm_tc.cu); raises if one has none, or if attention_tc.cuh's
    kernels come from more than one source."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = run([cuobjdump, "-sass", library], timeout=300)
    pattern = re.compile(r"_GLOBAL__N__\w+?_\d+_(\w+?)_cu_[0-9a-f]+3(?:tca|hta|gtc|wta|abt)\d+("
                         + "|".join(TENSOR_CORE_FUNCTIONS) + r")(?:I((?:L[ib]\d+E)+)E)?")
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            m = pattern.search(line)
            name = None
            if m:
                args = ",".join(re.findall(r"L[ib](\d+)E", m.group(3) or ""))
                name = f"{m.group(1)}.cu {m.group(2)}<{args}>"
                counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name:
            for op in ("HGMMA", "HMMA"):
                if op in line:
                    counts[name][op] += 1
                    break
    if not any(n.endswith(">") and "gemm_tc_kernel" in n for n in counts):
        raise RuntimeError("build: no GEMM core kernel in the library")
    for name, n in sorted(counts.items()):
        log(f"build: {name}: HMMA {n['HMMA']}, HGMMA {n['HGMMA']}")
        if not n["HMMA"] + n["HGMMA"]:
            raise RuntimeError(f"build: {name} has no tensor-core instruction")
    core = sorted({n.split()[0] for n in counts if " attn_" in n})
    log(f"build: attention_tc.cuh's kernels compiled in {', '.join(core)}")
    if core != ["fused_attention_qkv.cu"]:
        raise RuntimeError(f"build: attention_tc.cuh compiled into {core}")


# ---------------------------------------------------------------------------
# work counts and bounds
# ---------------------------------------------------------------------------

H100_TF32X3_FLOPS = 495e12 / 3  # f32-accurate products on the tensor cores (3xTF32)
H100_BF16_FLOPS = 989e12  # dense bf16 products on the tensor cores
H100_BYTES = 3.35e12     # HBM3 rate


def bound(flops, nbytes, peak=H100_TF32X3_FLOPS):
    """(bound_ms, bound_by): the least time for this work on the card, the
    larger of bytes / 3.35 TB/s and operations / ``peak``: for the f32
    kernels 495 / 3 = 165 TFLOP/s — every product of the port's kernels runs
    on the tensor cores in three TF32 passes, which keep f32 accuracy (the
    attention of B1 and B2 without a bias too, since it moved onto the
    packed-row core) —, for the bf16 forms the dense bf16 rate, 989
    TFLOP/s."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attn_fwd_work(B, N, C, H, D, saves=False, groups=0):
    """(operations, bytes) of the attention half's forward: two attention
    products (4·B·H·N²·D; the window attention with the bias, the packed-row
    core without) and four projection products (8·M·C·HD, the GEMM core);
    x, weights (and with ``groups`` the bias [G,
    H, N, N]) in, out written, and with ``saves`` the residuals (qkv, acc,
    mu, rstd, lse) written too."""
    M, HD = B * N, H * D
    flops = 4 * B * H * N * N * D + 8 * M * C * HD
    nbytes = 4 * (2 * M * C + 4 * C * HD + 3 * HD + 3 * C + B + groups * H * N * N)
    if saves:
        nbytes += 4 * (4 * M * HD + 2 * M + B * H * N)
    return flops, nbytes


def sra_fwd_work(B, G, M, N, D, saves=False):
    """(operations, bytes) of the reduced-kv attention's forward: q·kᵀ and
    p·v, 4·B·G·M·N·D; q, k, v read, out (and with ``saves`` lse) written."""
    nbytes = 4 * B * G * (2 * M * D + 2 * N * D + (M if saves else 0))
    return 4 * B * G * M * N * D, nbytes


def sra_bwd_work(B, G, M, N, D):
    """(operations, bytes) of its backward: five products (recomputed
    scores, dv, dp, dq, dk), 10·B·G·M·N·D; q, k, v, out, do and lse read,
    dq, dk and dv written."""
    return 10 * B * G * M * N * D, 4 * B * G * (4 * M * D + 4 * N * D + M)


def qkv_fwd_work(B, N, H, D, groups=0, saves=False):
    """(operations, bytes) of the packed-qkv attention's forward: q·kᵀ and
    p·v, 4·B·H·N²·D; qkv (and with ``groups`` the bias [G, H, N, N]) read,
    out (and with ``saves`` lse) written."""
    HD = H * D
    nbytes = 4 * (4 * B * N * HD + groups * H * N * N + (B * H * N if saves else 0))
    return 4 * B * H * N * N * D, nbytes


def qkv_bwd_work(B, N, H, D, groups=0):
    """(operations, bytes) of its backward: five products (scores, dv, dp,
    dq, dk), 10·B·H·N²·D; qkv, out, lse, do and the bias read, dqkv and
    dextra written."""
    HD = H * D
    return 10 * B * H * N * N * D, 4 * (8 * B * N * HD + B * H * N
                                        + 2 * groups * H * N * N)


def ff_fwd_work(B, N, C, F, row_scale=False, saves=False):
    """(operations, bytes) of the FF residual branch's forward: two GEMMs
    on the tensor cores, 4·M·C·F; x, the LN and FF parameters (and the row scale) read, out (and
    with ``saves`` hid, mu, rstd) written."""
    M = B * N
    nbytes = 4 * (2 * M * C + 2 * C * F + F + 3 * C + (B if row_scale else 0))
    if saves:
        nbytes += 4 * (M * F + 2 * M)
    return 4 * M * C * F, nbytes


def ff_bwd_work(B, N, C, F, row_scale=False):
    """(operations, bytes) of its backward: four GEMMs on the tensor cores,
    8·M·C·F; x, do, the
    saves and the parameters read, dx and the parameter gradients written."""
    M = B * N
    params = 2 * C * F + F + 3 * C + (B if row_scale else 0)
    return 8 * M * C * F, 4 * (3 * M * C + M * F + 2 * M + 2 * params)


def layer_fwd_work(B, N, C, H, D, F, groups=0, row_scales=False, saves=False):
    """(operations, bytes) of the whole layer's forward: the attention half
    plus the FF GEMMs (4·M·C·F); with ``groups`` the bias [G, H, N, N] read,
    with ``saves`` qkv, acc, z, hid and the statistics written."""
    M, HD = B * N, H * D
    flops = 4 * B * H * N * N * D + 8 * M * C * HD + 4 * M * C * F
    nbytes = 4 * (2 * M * C + 4 * C * HD + 2 * C * F + 3 * HD + 5 * C + F
                  + groups * H * N * N + (2 * B if row_scales else 0))
    if saves:
        nbytes += 4 * (4 * M * HD + M * C + M * F + 4 * M + B * H * N)
    return flops, nbytes


def attn_bwd_work(B, N, C, H, D, groups=0):
    """(operations, bytes) of the backward: five attention products
    (recomputed scores, dv, dp, dk, dq) and the four projection products of
    the weight and input gradients (16·M·C·HD); reads x, dz, the
    saves, the weights (and with ``groups`` the bias) once, writes dx and
    the parameter gradients once."""
    M, HD = B * N, H * D
    flops = 10 * B * H * N * N * D + 16 * M * C * HD
    nbytes = 4 * (3 * M * C + 4 * M * HD + 2 * M + B * H * N
                  + 2 * (4 * C * HD + 3 * HD + 3 * C) + 2 * B + groups * H * N * N)
    return flops, nbytes


def layer_bwd_work(B, N, C, H, D, F, groups=0, row_scales=False):
    """(operations, bytes) of the whole layer's backward: the attention
    half's (attn_bwd_work) plus the FF half's four GEMMs (8·M·C·F); reads x,
    do, the saves (qkv, acc, z, hid, statistics, lse), the weights and the
    bias once, writes dx, the parameter gradients and dextra once."""
    M, HD = B * N, H * D
    flops = 10 * B * H * N * N * D + 16 * M * C * HD + 8 * M * C * F
    nbytes = 4 * (3 * M * C + 4 * M * HD + M * C + M * F + 4 * M + B * H * N
                  + 2 * (4 * C * HD + 2 * C * F + 3 * HD + 7 * C + F)
                  + 2 * groups * H * N * N + (4 * B if row_scales else 0))
    return flops, nbytes


def halo_layer_fwd_work(B, H, W, C, nh, D, F, window, halo, row_scales=False,
                       saves=False, a=4):
    """(operations, bytes) of the whole Halo layer's forward on M = B·H·W
    tokens: the four projection GEMMs (8·M·C·HD + 4·M·C·F) and halo
    attention over k² = (w + 2·halo)² positions (4·M·k²·HD); x, the weights
    and the bias [nh, w², k²] read, out written, and with ``saves`` qkv,
    acc, z, hid, the statistics and lse written too.  ``a``: the bytes of an
    activation, weight or bias (2 in the bf16 form; the LN parameters,
    statistics, lse, row scales and the relative-position bias stay 4)."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    flops = 8 * M * C * HD + 4 * M * C * F + 4 * M * k2 * HD
    nbytes = (a * (2 * M * C + 4 * C * HD + 2 * C * F + 2 * C + F)
              + 4 * (4 * C + nh * window * window * k2 + (2 * B if row_scales else 0)))
    if saves:
        nbytes += a * (4 * M * HD + M * C + M * F) + 4 * (4 * M + nh * M)
    return flops, nbytes


def halo_layer_bwd_work(B, H, W, C, nh, D, F, window, halo, row_scales=False, a=4):
    """(operations, bytes) of the whole Halo layer's backward: 16·M·C·HD +
    8·M·C·F of GEMMs and five halo attention products (recomputed scores,
    dv, dp, dk, dq: 10·M·k²·HD); reads x, do, the saves and the weights and bias
    once, writes dx, the parameter gradients (f32) and dbias once; ``a`` as
    in :func:`halo_layer_fwd_work`."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    flops = 16 * M * C * HD + 8 * M * C * F + 10 * M * k2 * HD
    params = 4 * C * HD + 2 * C * F + 6 * C + F
    nbytes = (a * (3 * M * C + 4 * M * HD + M * C + M * F + params) + 4 * params
              + 4 * (4 * M + nh * M + 2 * nh * window * window * k2
                     + (4 * B if row_scales else 0)))
    return flops, nbytes


def halo_attn_fwd_work(B, H, W, nh, D, window, halo, saves=False, a=4):
    """(operations, bytes) of halo attention off the maps: 4·M·k²·HD; q, kv
    and the bias read, out (and with ``saves`` lse) written; ``a`` the bytes
    of an element of q, kv, out."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    nbytes = a * 4 * M * HD + 4 * (nh * window * window * k2 + (nh * M if saves else 0))
    return 4 * M * k2 * HD, nbytes


def halo_attn_bwd_work(B, H, W, nh, D, window, halo, a=4):
    """(operations, bytes) of its backward: five products, 10·M·k²·HD; q,
    kv, out, lse, do and the bias read, dq, dkv and dbias written (the bf16
    form reads no out)."""
    M, HD, k2 = B * H * W, nh * D, (window + 2 * halo) ** 2
    acts = 8 * M * HD if a == 4 else 7 * M * HD
    return 10 * M * k2 * HD, a * acts + 4 * (nh * M + 2 * nh * window * window * k2)


def gather_fwd_work(Bw, M, N, nh, D, saves=False, a=4):
    """(operations, bytes) of the gathered halo attention's forward over Bw
    windows: 4·Bw·M·N·HD; q, kv and the bias read, out (and with ``saves``
    lse) written; ``a`` the bytes of an element of q, kv, out."""
    HD = nh * D
    nbytes = (a * (2 * Bw * M * HD + 2 * Bw * N * HD)
              + 4 * (nh * M * N + (Bw * nh * M if saves else 0)))
    return 4 * Bw * M * N * HD, nbytes


def gather_bwd_work(Bw, M, N, nh, D, a=4):
    """(operations, bytes) of its backward: five products, 10·Bw·M·N·HD; q,
    kv, out, lse, do and the bias read, dq, dkv and dbias written (the bf16
    form reads no out)."""
    HD = nh * D
    acts = (4 if a == 4 else 3) * Bw * M * HD + 4 * Bw * N * HD
    return 10 * Bw * M * N * HD, a * acts + 4 * (Bw * nh * M + 2 * nh * M * N)


def block_fwd_work(B, N, C, H, D, Cout, groups=0, saves=False):
    """(operations, bytes) of the attention block's forward, all on the
    tensor cores: the two projections (2·M·C·3HD + 2·M·HD·Cout) and the
    attention (4·B·H·N²·D);
    x, the weights and biases (and with ``groups`` the bias [G, H, N, N])
    read, out (and with ``saves`` qkv, acc, lse) written."""
    M, HD = B * N, H * D
    flops = 6 * M * C * HD + 2 * M * HD * Cout + 4 * B * H * N * N * D
    nbytes = 4 * (M * C + M * Cout + 3 * C * HD + HD * Cout + 3 * HD + Cout
                  + groups * H * N * N)
    if saves:
        nbytes += 4 * (4 * M * HD + B * H * N)
    return flops, nbytes


def block_bwd_work(B, N, C, H, D, Cout, groups=0):
    """(operations, bytes) of its backward, all on the tensor cores: dWout,
    dacc (4·M·HD·Cout), dWqkv, dx (12·M·C·HD) and five attention products
    (10·B·H·N²·D); x, dout, the
    saves, the weights and the bias read once, dx and the parameter and bias
    gradients written once."""
    M, HD = B * N, H * D
    flops = 4 * M * HD * Cout + 12 * M * C * HD + 10 * B * H * N * N * D
    params = 3 * C * HD + HD * Cout + 3 * HD + Cout
    nbytes = 4 * (2 * M * C + M * Cout + 4 * M * HD + B * H * N + 2 * params
                  + 2 * groups * H * N * N)
    return flops, nbytes


# ---------------------------------------------------------------------------
# 3m. the GEMM core alone vs its plain version
# ---------------------------------------------------------------------------


# the odd small calls: K and N not multiples of 4 or 8, M off the 128-row
# tile, a K of one step, and the map forms on a 7x7 window's row table
GEMM_ODD = ((37, 29, 45), (130, 7, 3), (300, 200, 100), (1000, 64, 48), (777, 96, 384),
            (5, 133, 1536))
GEMM_ODD_SPLITK = ((45, 29, 37), (24, 40, 1000), (96, 288, 5003))


def gemm_main_calls():
    """(label, form, M, N, K, epilogue) of the main paths' products: the
    forward's projections (weights as ``linear.weight.t()`` views, K-major)
    with their epilogues, a data gradient (``dY·W``, the weight read
    N-major) and the split-K weight gradients (``xᵀ·dY``) at ViT-S/16's
    25,216 training rows (128 images of 197 tokens) and Swin-S stages 1 and
    3 at 64 images (200,704 and 12,544 rows)."""
    calls = []
    for model, M, C in (("ViT-S/16", 25216, 384), ("Swin-S stage 1", 200704, 96),
                        ("Swin-S stage 3", 12544, 384)):
        calls += [(f"{model} qkv", "rows", M, 3 * C, C, "bias"),
                  (f"{model} out-proj", "rows", M, C, C, "bias+rs+res"),
                  (f"{model} FF1", "rows", M, 4 * C, C, "bias+silu"),
                  (f"{model} FF2", "rows", M, C, 4 * C, "bias+rs+res"),
                  (f"{model} dX = dqkv·Wqkv", "nmajor", M, C, 3 * C, ""),
                  (f"{model} dWqkv = xᵀ·dqkv", "splitk", C, 3 * C, M, ""),
                  (f"{model} dW1 = xᵀ·dh", "splitk", C, 4 * C, M, ""),
                  (f"{model} dW2 = hᵀ·dy", "splitk", 4 * C, C, M, "")]
    return calls


def gemm_inputs(torch, form, M, N, K, epilogue, seed=0, rs_rows=197):
    """Seeded operands of one call: a [M, K] (split-K: its transpose's
    storage [K, M]), b [K, N] as the path reads it (a weight view
    ``w.t()`` of w [N, K] for the forward, a row-major [K, N] for the data
    and weight gradients), and the epilogue's tensors (a row scale per
    ``rs_rows`` rows)."""
    g = torch.Generator(DEVICE).manual_seed(seed)

    def n(*shape, s=1.0):
        return s * torch.randn(*shape, device=DEVICE, generator=g)

    a = n(K, M) if form == "splitk" else n(M, K)
    if form == "rows":
        b = n(N, K, s=K ** -0.5).t()
    else:
        b = n(K, N, s=1.0 if form == "splitk" else K ** -0.5)
    kw = {}
    if "bias" in epilogue:
        kw["bias"] = n(N, s=0.1)
    if "silu" in epilogue:
        kw["silu"] = True
    if "rs" in epilogue:
        kw["rs"] = 0.5 + torch.rand(-(-M // rs_rows), device=DEVICE, generator=g)
        kw["rs_rows"] = rs_rows
    if "res" in epilogue:
        kw["res"] = n(M, N)
    return a, b, kw


def gemm_check(torch, gm, label, form, a, b, kw, splits, worst):
    """One call against its plain version: atol = rtol = 1e-4 (row forms),
    or ≤ 1e-3·max(1, max|plain|) and bit-identical across two runs
    (split-K).  Returns (error, plain)."""
    if form == "splitk":
        out = gm.gemm(a, b, form="splitk", splits=splits)
        again = gm.gemm(a, b, form="splitk", splits=splits)
        torch.cuda.synchronize()
        plain = gm.gemm_reference(a, b, form="splitk")
        err = (out - plain).abs().max().item()
        lim = 1e-3 * max(1.0, plain.abs().max().item())
        same = torch.equal(out, again)
        log(f"gemm: {label} (split-K, {splits} slabs): max|Δ| {err:.3e} (limit {lim:.3e}), "
            f"two runs bit-identical: {same} {'ok' if err <= lim and same else 'FAIL'}")
        if not (err <= lim and same) or not torch.isfinite(out).all():
            raise RuntimeError(f"gemm: the split-K form disagrees or varies at {label}")
        worst["splitk"] = max(worst["splitk"], err / lim)
        return err, plain
    form_ = "rows" if form == "nmajor" else form
    out = gm.gemm(a, b, **kw, form=form_)
    torch.cuda.synchronize()
    plain = gm.gemm_reference(a, b, **kw, form=form_)
    err = check_close(torch, "gemm", out, plain, label)
    worst["rows"] = max(worst["rows"], err)
    return err, plain


# the passes the core takes in (csrc/common.cuh GemmExtra): odd small shapes,
# then Halo-S stage 1's products at 128 images (524,288 rows, C 96, F 384),
# where B4's forward stages LN₁, LN₂ and silu and its backward's dh GEMM
# takes silu', r₂ and the dr₂ / db₁ partials in its epilogue
GEMM_PASS_ODD = ((37, 29, 45), (130, 7, 3), (300, 200, 100), (777, 96, 384))
HALO1_ROWS = 128 * 64 * 64


def gemm_pass_calls():
    """(label, form, M, N, K, options) of B4's products at Halo-S stage 1."""
    M = HALO1_ROWS
    return [("Halo-S stage 1 qkv, LN₁ staged", "rows", M, 288, 96, "ln"),
            ("Halo-S stage 1 FF1, LN₂ staged", "rows", M, 384, 96, "ln+bias"),
            ("Halo-S stage 1 FF2, silu staged", "rows", M, 96, 384, "act+bias+rs+res"),
            ("Halo-S stage 1 dh = dy·W₂ᵀ, silu' and r₂ with the dr₂ and db₁ partials",
             "nmajor", M, 384, 96, "hid+rs+partials"),
            ("Halo-S stage 1 dW₂ = silu(hid)ᵀ·(r₂ ⊙ dy)", "splitk", 384, 96, M, "act+rs_b"),
            ("Halo-S stage 1 dW₁ = LN₂(z)ᵀ·dh", "splitk", 96, 384, M, "ln")]


def gemm_pass_inputs(torch, form, M, N, K, options, act="silu", seed=0, rs_rows=4096):
    """Seeded operands of one call with the passes' options: ``gemm_inputs``'
    a and b (the epilogue's tensors for ``bias``, ``rs``, ``res``) and
    LayerNorm statistics and parameters (ln: over a's rows, or its k in
    the split-K form), the staged act, B's row scale (rs_b) and a hid
    tile with both partials (hid, partials)."""
    a, b, kw = gemm_inputs(torch, "splitk" if form == "splitk" else form, M, N, K,
                           options.replace("rs_b", ""), seed=seed, rs_rows=rs_rows)
    g = torch.Generator(DEVICE).manual_seed(seed + 1)

    def n(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, device=DEVICE, generator=g)

    tokens, feats = (K, M) if form == "splitk" else (M, K)
    if "ln" in options:
        kw["ln"] = (n(tokens, s=0.3), 0.5 + torch.rand(tokens, device=DEVICE, generator=g),
                    n(feats, s=0.1, mean=1.0), n(feats, s=0.1))
    if "act" in options:
        kw["act_a"] = act
    if "rs_b" in options:
        kw["rs_b"] = 0.5 + torch.rand(-(-K // rs_rows), device=DEVICE, generator=g)
        kw["rs_b_rows"] = rs_rows
    if "hid" in options:
        kw.update(hid=n(M, N), hid_act=act)
    if "partials" in options:
        kw.update(row_partials=True, col_partials=True)
    return a, b, kw


def gemm_pass_check(torch, gm, label, form, a, b, kw, splits, worst):
    """One call with the passes' options against :func:`gemm_reference`
    (the staged values and the partials in the kernel's order): the row
    forms within atol = rtol = 1e-4, the split-K form and the partials
    within 1e-3·max(1, max|plain|) and bit-identical across two runs.
    Returns the output's error."""
    if form == "splitk":
        out = gm.gemm(a, b, form="splitk", splits=splits, **kw)
        again = gm.gemm(a, b, form="splitk", splits=splits, **kw)
        torch.cuda.synchronize()
        plain = gm.gemm_reference(a, b, form="splitk", **kw)
        pairs = [("out", out, again, plain)]
    else:
        form_ = "rows" if form == "nmajor" else form
        res = gm.gemm(a, b, **kw, form=form_)
        torch.cuda.synchronize()
        plain = gm.gemm_reference(a, b, **kw, form=form_)
        if not isinstance(res, tuple):
            err = check_close(torch, "gemm", res, plain, label)
            worst["rows"] = max(worst["rows"], err)
            return err
        again = gm.gemm(a, b, **kw, form=form_)
        err = check_close(torch, "gemm", res[0], plain[0], label)
        worst["rows"] = max(worst["rows"], err)
        pairs = [(name, x, y, p) for name, x, y, p in
                 zip(("row partials", "column partials"), res[1:], again[1:], plain[1:])]
    for name, x, y, p in pairs:
        e = (x - p).abs().max().item()
        lim = 1e-3 * max(1.0, p.abs().max().item())
        same = torch.equal(x, y)
        log(f"gemm: {label}: {name} max|Δ| {e:.3e} (limit {lim:.3e}), two runs "
            f"bit-identical: {same} {'ok' if e <= lim and same else 'FAIL'}")
        if not (e <= lim and same) or not torch.isfinite(x).all():
            raise RuntimeError(f"gemm: {name} disagree or vary at {label}")
        worst["splitk"] = max(worst["splitk"], e / lim)
    return (pairs[0][1] - pairs[0][3]).abs().max().item()


def gemm_pass_kernels(torch, gm, fl, worst):
    """The passes' options at the odd shapes (every option, silu and gelu,
    split-K in one and three slabs), then B4's products at Halo-S stage 1:
    checked, and timed beside the same product without the options and
    ``torch.matmul`` f32.  Returns the timed records."""
    for M, N, K in GEMM_PASS_ODD:
        seed = M + N + K
        for act in ("silu", "gelu"):
            for form, opts in (("rows", "ln+bias"), ("rows", "act+bias+rs+res"),
                               ("nmajor", "hid+rs+partials"), ("nmajor", "hid+partials")):
                a, b, kw = gemm_pass_inputs(torch, form, M, N, K, opts, act, seed, rs_rows=10)
                gemm_pass_check(torch, gm, f"odd {form} M,N,K={M},{N},{K} {opts} ({act})",
                                form, a, b, kw, 1, worst)
            for opts in ("ln", "act+rs_b"):
                for splits in (1, 3):
                    a, b, kw = gemm_pass_inputs(torch, "splitk", M, N, K, opts, act, seed,
                                                rs_rows=10)
                    gemm_pass_check(torch, gm, f"odd split-K M,N,K={M},{N},{K} {opts} "
                                    f"({act}, {splits} slabs)", "splitk", a, b, kw, splits,
                                    worst)
    records = []
    for label, form, M, N, K, opts in gemm_pass_calls():
        a, b, kw = gemm_pass_inputs(torch, form, M, N, K, opts, seed=1)
        splits = fl._splits(M, N, K) if form == "splitk" else 1
        what = f"{label} M,N,K={M},{N},{K} {opts}"
        err = gemm_pass_check(torch, gm, what, form, a, b, kw, splits, worst)
        form_ = "rows" if form == "nmajor" else form
        passes = ("ln", "act_a", "rs_b", "rs_b_rows", "hid", "hid_act", "row_partials",
                  "col_partials")
        bare = {k: v for k, v in kw.items() if k not in passes}
        ms = median_ms_queued(torch, lambda: gm.gemm(a, b, **kw, form=form_, splits=splits))
        bare_ms = median_ms_queued(torch, lambda: gm.gemm(a, b, **bare, form=form_,
                                                          splits=splits))
        lhs = a.t() if form == "splitk" else a
        lib_ms = median_ms_queued(torch, lambda: torch.matmul(lhs, b))
        flops = 2 * M * N * K
        nbytes = 4 * (M * K + K * N + M * N + (M * N if "res" in opts else 0)
                      + (2 * M * N if "hid" in opts else 0))
        bound_ms, by = bound(flops, nbytes)
        log(f"gemm: {what}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), the same "
            f"product without the options {bare_ms:.3f} ms, torch.matmul f32 {lib_ms:.3f} "
            f"ms; bound {bound_ms:.3f} ms ({by}, {100 * bound_ms / ms:.0f}% of it) (median "
            f"of 20 CUDA-event timings of 10 calls in a row)")
        records.append({"shape": what, "max_abs_err": err, "ms": ms, "bare_ms": bare_ms,
                        "tflops": flops / ms / 1e9, "bound_ms": bound_ms, "bound_by": by,
                        "library_ms": lib_ms})
        del a, b, kw, bare
    return records


def gemm_kernels(torch):
    """3m: the GEMM core (csrc/gemm_tc.cu) through its thin C entry, in its
    three forms (row-major A; B9's map forms, the residual read or the output
    written at the map row; split-K over Aᵀ storage), against
    :func:`gemm_reference` (``torch.matmul`` in f32, TF32 off): every
    epilogue combination the paths use (none, bias, bias + silu, bias + row
    scale + residual, the map forms with bias, row scale and residual), the
    weight read K-major (the forward's ``linear.weight.t()``) and N-major
    (the data gradients' ``dY·W``), odd small shapes, and the main paths'
    products at full size (``gemm_main_calls``); then the passes it takes in
    (``gemm_pass_kernels``: the producer's LayerNorm apply, act and row
    scale, the epilogue's silu' with the row and column partials) beside
    their emulation; median ms of 20 CUDA-event timings of 10 calls in a
    row, TFLOP/s, the bound at the f32-accurate tensor-core rate and
    ``torch.matmul``'s f32 time timed the same way on the same operands.
    Returns the timed records."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import gemm as gm

    worst = {"rows": 0.0, "splitk": 0.0}
    for M, N, K in GEMM_ODD:
        for form in ("rows", "nmajor"):
            for epi in ("", "bias", "bias+silu", "rs", "bias+rs+res", "bias+silu+rs+res"):
                a, b, kw = gemm_inputs(torch, form, M, N, K, epi, seed=M + N + K, rs_rows=10)
                gemm_check(torch, gm, f"odd {form} M,N,K={M},{N},{K} {epi or 'no epilogue'}",
                           form, a, b, kw, 1, worst)
    for M, N, K in GEMM_ODD_SPLITK:
        for splits in (1, 3):
            a, b, _ = gemm_inputs(torch, "splitk", M, N, K, "", seed=K)
            gemm_check(torch, gm, f"odd M,N,K={M},{N},{K}", "splitk", a, b, {}, splits, worst)
    # the map forms: 5 images of a 7x7 window's rows, the pixel table a
    # permutation of the 49 rows (B9's window-pair table is one)
    for images, hw, N, K in ((5, 49, 96, 64), (3, 98, 45, 37)):
        M = images * hw
        pix = torch.randperm(hw, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(hw))
        pix = pix.to(torch.int32)
        for form in ("map_res", "map_out"):
            for epi in ("bias+rs+res", "bias+silu", "res"):
                a, b, kw = gemm_inputs(torch, "rows", M, N, K, epi, seed=7, rs_rows=hw)
                gemm_check(torch, gm, f"{form} {images} images x {hw} rows, N,K={N},{K} "
                           f"{epi}", form, a, b, dict(kw, pix=pix), 1, worst)

    records = []
    for label, form, M, N, K, epi in gemm_main_calls():
        a, b, kw = gemm_inputs(torch, form, M, N, K, epi, seed=1)
        splits = fl._splits(M, N, K) if form == "splitk" else 1
        what = f"{label} M,N,K={M},{N},{K}" + (f" {epi}" if epi else "")
        err, plain = gemm_check(torch, gm, what, form, a, b, kw, splits, worst)
        del plain
        form_ = "rows" if form == "nmajor" else form
        ms = median_ms_queued(torch, lambda: gm.gemm(a, b, **kw, form=form_, splits=splits))
        lhs = a.t() if form == "splitk" else a
        lib_ms = median_ms_queued(torch, lambda: torch.matmul(lhs, b))
        flops = 2 * M * N * K
        nbytes = 4 * (M * K + K * N + M * N + (M * N if "res" in epi else 0)
                      + (N if "bias" in epi else 0))
        bound_ms, by = bound(flops, nbytes)
        log(f"gemm: {what}: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
            f"torch.matmul f32 {lib_ms:.3f} ms ({flops / lib_ms / 1e9:.1f} TFLOP/s); bound "
            f"{bound_ms:.3f} ms ({by}, {100 * bound_ms / ms:.0f}% of it) (median of 20 "
            f"CUDA-event timings of 10 calls in a row)")
        records.append({"shape": what, "max_abs_err": err, "ms": ms, "tflops": flops / ms / 1e9,
                        "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms})
        del a, b, kw
    records += gemm_pass_kernels(torch, gm, fl, worst)
    log(f"gemm: worst max|Δ| of the row forms {worst['rows']:.3e}; worst split-K (and "
        f"partials) max|Δ| {worst['splitk']:.3f} of its limit")
    return records


# ---------------------------------------------------------------------------
# 3. kernels vs plain versions
# ---------------------------------------------------------------------------


def layer_args(torch, B, N, C, H, D, F, seed=0):
    """Seeded f32 inputs on the card; weights as transposed views of
    [out, in] matrices, as the model passes ``linear.weight.t()``."""
    rng = np.random.default_rng(seed)
    HD = H * D

    def n(*shape, s=1.0, mean=0.0):
        a = (mean + s * rng.standard_normal(shape)).astype(np.float32)
        return torch.from_numpy(a).to(DEVICE)

    def w(k, m):
        return n(m, k, s=0.05).t()

    return [n(B, N, C), n(C, s=0.1, mean=1.0), n(C, s=0.1),
            w(C, 3 * HD), n(3 * HD, s=0.1), w(HD, C), n(C, s=0.1),
            n(C, s=0.1, mean=1.0), n(C, s=0.1),
            w(C, F), n(F, s=0.1), w(F, C), n(C, s=0.1)]


def median_ms(torch, fn, reps=20, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def median_ms_queued(torch, fn, reps=20, inner=10, warmup=3):
    """median_ms of ``inner`` back-to-back calls, over ``inner``: the calls
    queue on the card, so the host's per-call work (a wrapper's checks and
    allocations) stays out of a short kernel's time."""
    def many():
        for _ in range(inner):
            fn()
    return median_ms(torch, many, reps, warmup) / inner


_WARMUP_STREAM = []


def device_ms(torch, fn, reps=20, inner=10, warmup=3):
    """The device time of one call of fn: ``inner`` calls captured in a CUDA
    graph after ``warmup`` calls, its replays timed with CUDA events (the
    median of ``reps``), over ``inner``.  No host work between the calls or
    before the first: a wrapper's checks, allocations and tensor-map
    encodes stay out of a short kernel's time.  Warm-up and capture run on
    one side stream, until release_timing_stream: cuBLAS keeps a workspace
    per stream (~32 MiB), which a new stream a call would pile up."""
    if not _WARMUP_STREAM:
        _WARMUP_STREAM.append(torch.cuda.Stream())
    side = _WARMUP_STREAM[0]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(inner):
            fn()
    ms = median_ms(torch, graph.replay, reps, 1) / inner
    del graph
    return ms


def release_timing_stream(torch):
    """Drop device_ms's side stream and free cuBLAS's workspaces, so that
    the timing stream's workspace stays out of later phases' peak memory
    (the default stream's comes back at its next product)."""
    torch.cuda.synchronize()
    _WARMUP_STREAM.clear()
    torch._C._cuda_clearCublasWorkspaces()


def vit_shape(B):
    """ViT-S/16 @224 layer shape (B, N, C, H, D, F) at B rows."""
    return (B, 197, 384, 6, 64, 1536)


def swin_stages(images):
    """The whole-layer kernel's calls in Swin-S @224 at ``images`` images,
    one per stage: dicts of the layer shape (rows = groups·images, N = m
    tokens of a packed window pair or window), the window geometry and the
    depth, from configs/swin-transformer-s.conf."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.models.swin import window_pack

    arch = load_config(MODELS["Swin-S"][0]).arch
    win = arch.window_size
    size = arch.image_size[0] // 4
    out = []
    for s in range(4):
        if s:
            size //= 2
        pack = window_pack(win, (size, size))
        groups = (size // win) ** 2 // pack
        out.append(dict(stage=s + 1, size=(size, size), window=win, images=images,
                        groups=groups, depth=arch.depths[s],
                        shape=(groups * images, pack * win * win, arch.dims[s],
                               arch.n_heads[s], arch.dim_head, arch.dim_ffs[s])))
    return out


# the odd small whole-layer call: 3 images of a 6x6 map, 3x3 windows packed in
# pairs (2 groups, m = 18 tokens), head width 24
SWIN_ODD = dict(stage="odd", size=(6, 6), window=3, images=3, groups=2, depth=1,
                shape=(6, 18, 48, 2, 24, 96))


def swin_layer_inputs(torch, call, row_scales, seed=0):
    """Seeded inputs of one whole-layer call: ``layer_args``, the grouped
    bias [G, H, m, m] of a shifted layer built by the port's WindowAttention
    (a std-0.2 table, −1e9 off a pair's diagonal blocks, the shift mask) and,
    with ``row_scales``, two per-image DropPath scales (keep 0.9) tiled over
    the groups as SwinLayer tiles them."""
    from vision_transformers_tpu_torch.models.swin import WindowAttention

    rows, N, C, H, D, F = call["shape"]
    a = layer_args(torch, *call["shape"], seed=seed)
    attn = WindowAttention(C, H, D, call["size"], call["window"], shift=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        attn.rel_pos.weight.normal_(0.0, 0.2, generator=gen)
        extra = attn.to(DEVICE).grouped_bias()
    if extra.shape != (call["groups"], H, N, N):
        raise RuntimeError(f"swin inputs: bias {tuple(extra.shape)} for {call}")
    rs = [None, None]
    if row_scales:
        rng = np.random.default_rng(seed + 100)
        for i in range(2):
            keep = rng.random(call["images"]) < 0.9
            keep[0], keep[-1] = False, True  # both kinds at every shape
            r = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
            rs[i] = r.repeat(call["groups"])
    return a, extra, rs


def check_close(torch, name, out, ref, what):
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"kernels: {name} {what}: bad output")
    err = (out - ref).abs().max().item()
    ok = torch.allclose(out, ref, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    log(f"kernels: {name} {what}: max|kernel-plain| {err:.3e} "
        f"(atol=rtol={KERNEL_TOL}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"kernels: {name} disagrees with its plain version")
    return err


def kernels(torch):
    """3: each forward kernel (serving call, no saves) against its plain
    version at an odd shape, at every ViT shape phases 5 and 6 give it and at
    the timed shapes; the whole-layer kernel also at every Swin-S call, with
    the grouped bias and both row scales.  The training calls (saves) are
    held in 3b.  Returns {kernel: [timed entries]}."""
    from vision_transformers_tpu_torch.ops import fused_layer, fused_layer1

    # (kernel, plain version, the main paths' shapes, the timed shapes)
    ops = {
        "fused_attention_layer": (
            lambda a, H: fused_layer.fused_attention_layer(*a[:7], H),
            lambda a, H: fused_layer.fused_attention_layer_reference(*a[:7], H),
            [vit_shape(48)], [vit_shape(64)]),
        "fused_transformer_layer": (
            lambda a, H: fused_layer1.fused_transformer_layer(*a, H),
            lambda a, H: fused_layer1.fused_transformer_layer_reference(*a, H),
            [vit_shape(160), vit_shape(128)], [vit_shape(256), vit_shape(128)]),
    }
    odd = (3, 37, 48, 2, 24, 96)
    results = {"fused_attention_layer": [], "fused_transformer_layer": []}
    for name, (kernel, plain, main_shapes, timed) in ops.items():
        for shape in dict.fromkeys((odd, *main_shapes, *timed)):
            a = layer_args(torch, *shape)
            out = kernel(a, shape[3])
            torch.cuda.synchronize()
            err = check_close(torch, name, out, plain(a, shape[3]),
                              "B,N,C,H,D,F=" + str(shape))
            if shape in timed:
                H = shape[3]
                ms = median_ms(torch, lambda: kernel(a, H))
                plain_ms = median_ms(torch, lambda: plain(a, H))
                work = attn_fwd_work(*shape[:5]) if name == "fused_attention_layer" \
                    else layer_fwd_work(*shape)
                bound_ms, by = bound(*work)
                log(f"kernels: {name} ViT-S B={shape[0]}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms (median of 20, CUDA events); bound "
                    f"{bound_ms:.3f} ms ({by})")
                results[name].append({
                    "shape": "ViT-S, B,N,C,H,D,F=" + ",".join(map(str, shape)),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None})

    # Swin-S: the grouped bias and both row scales (the eval's calls are
    # timed: the trainer's training calls are timed in 3b)
    name = "fused_transformer_layer"
    calls = [SWIN_ODD] + swin_stages(64) + swin_stages(128)
    for call in calls:
        a, extra, (r1, r2) = swin_layer_inputs(torch, call, row_scales=True)
        H = call["shape"][3]
        out = fused_layer1.fused_transformer_layer(*a, H, extra, r1, r2)
        torch.cuda.synchronize()
        ref = fused_layer1.fused_transformer_layer_reference(*a, H, extra, r1, r2)
        what = (f"Swin stage {call['stage']} at {call['images']} images, "
                f"B,N,C,H,D,F={call['shape']}, G={call['groups']}, row scales")
        err = check_close(torch, name, out, ref, what)
        if call["images"] == 128:
            a, extra, _ = swin_layer_inputs(torch, call, row_scales=False)
            ms = median_ms(torch, lambda: fused_layer1.fused_transformer_layer(*a, H, extra))
            plain_ms = median_ms(
                torch, lambda: fused_layer1.fused_transformer_layer_reference(*a, H, extra))
            bound_ms, by = bound(*layer_fwd_work(*call["shape"], groups=call["groups"]))
            log(f"kernels: {name} Swin stage {call['stage']} eval call (128 images, "
                f"{call['shape'][0]} rows, bias, no saves): kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({by})")
            results[name].append({
                "shape": f"Swin-S stage {call['stage']} eval, B,N,C,H,D,F="
                         + ",".join(map(str, call["shape"])) + f", G={call['groups']}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": by, "library_ms": None})

    # the attention layer with Twins-SVT-S stage 3's pair mask (128 images):
    # B1's bias call, on the window attention
    call = twins_stages(128)[2]
    a, mask, rs, _ = twins_layer_inputs(torch, call)
    H = call["lsa"][3]
    out = fused_layer.fused_attention_layer(*a, H, extra=mask, row_scale=rs)
    torch.cuda.synchronize()
    check_close(torch, "fused_attention_layer", out,
                fused_layer.fused_attention_layer_reference(*a, H, extra=mask, row_scale=rs),
                f"Twins-SVT-S stage 3 B,N,C,H,D={call['lsa'][:5]}, pair mask, row scale")
    return results


# ---------------------------------------------------------------------------
# 3bf. the bf16 forms vs their plain versions
# ---------------------------------------------------------------------------

# one bf16 ulp is 2⁻⁸: a forward within 4 ulps of the largest value, a
# gradient within 3e-2 of it
BF16_FWD_TOL, BF16_BWD_TOL = 1.6e-2, 3e-2
BF16_ODD = ((4, 17, 64, 2, 32, 128), (4, 33, 64, 2, 32, 128))
VIT_TRAIN = (128, 197, 384, 6, 64, 1536)  # the trainer's call: B, N, C, H, D, F


def bf16_args(torch, B, N, C, H, D, F, seed=0):
    """layer_args as the bf16 model passes them: activations, weights and
    biases bf16, the LayerNorm parameters f32."""
    a = layer_args(torch, B, N, C, H, D, F, seed)
    return [t if i in (1, 2, 7, 8) else t.to(torch.bfloat16) for i, t in enumerate(a)]


def bf16_close(torch, what, k, p, tol):
    """max|kernel − plain| within tol·max(1, max|plain|), finite, same shape."""
    k32, p32 = k.float(), p.float()
    if k.shape != p.shape or not torch.isfinite(k32).all():
        raise RuntimeError(f"bf16: {what}: bad shape or non-finite values")
    err = (k32 - p32).abs().max().item()
    lim = tol * max(1.0, p32.abs().max().item())
    log(f"bf16: {what}: max|kernel-plain| {err:.3e} (limit {lim:.3e})")
    if err > lim:
        raise RuntimeError(f"bf16: {what} disagrees with its plain version")
    return err


def b1_bf16_work(B, N, C, H, D, backward=False):
    """(operations, bytes) of B1's bf16 form with the saves (forward) or its
    backward: the activations, weights and biases 2 bytes, the LN
    parameters, statistics, lse and row scale 4."""
    M, HD = B * N, H * D
    small = 4 * (2 * M + B * H * N + 2 * C + B)  # mu, rstd, lse, ln g / b, rs
    params = 4 * C * HD + 3 * HD + C
    if backward:  # x, dz, qkv, acc, the weights read; dx, their gradients, dg, db written
        return (10 * B * H * N * N * D + 16 * M * C * HD,
                2 * (3 * M * C + 4 * M * HD + 2 * params) + small + 4 * (2 * C + B))
    return (4 * B * H * N * N * D + 8 * M * C * HD,
            2 * (2 * M * C + params + 4 * M * HD) + small)


def b2_bf16_work(B, N, C, H, D, F, groups=0, saves=False, backward=False):
    """(operations, bytes) of B2's bf16 serving forward, or with ``saves``
    its training forward (qkv, acc, z, hid bf16 and the LN statistics and
    lse f32 written too, both row scales read), or its ``backward`` (x, do,
    qkv, acc, z, hid and the weights read, dx and the f32 gradients of the
    weights, biases and LN parameters written); with ``groups`` the bias
    [G, H, N, N] f32 read (and its gradient written)."""
    M, HD = B * N, H * D
    params = 4 * C * HD + 2 * C * F + 3 * HD + 2 * C + F
    bias = 4 * groups * H * N * N
    if backward:
        return (10 * B * H * N * N * D + 16 * M * C * HD + 8 * M * C * F,
                2 * (4 * M * C + 4 * M * HD + M * F + params) + 4 * params
                + 4 * (4 * M + B * H * N + 8 * C + 4 * B) + 2 * bias)
    flops = 4 * B * H * N * N * D + 8 * M * C * HD + 4 * M * C * F
    nbytes = 2 * (2 * M * C + params) + 4 * 4 * C + bias
    if saves:
        nbytes += 2 * (4 * M * HD + M * C + M * F) + 4 * (4 * M + B * H * N + 2 * B)
    return flops, nbytes


def gemm_bf16_calls():
    """(label, form, M, N, K, options) of the GEMM core's bf16 checks: odd
    shapes (off 8-element rows: the register path; on 8-element rows: the
    TMA path, the weight K-major or, "nmajor", N-major, ragged M, N and K),
    and ViT-S/16's seven products at the trainer's 128 images as its paths
    call them (qkv and the out projection, FF1 / FF2 of the eval's whole
    layer, the data gradient dln with the weight read in place, the split-K
    weight gradients of both projections)."""
    M = 128 * 197
    return [("odd", "rows", 37, 29, 45, ("bias", "rs", "res")),
            ("odd", "rows", 300, 200, 104, ("bias", "silu")),
            ("odd", "rows", 130, 7, 3, ("f32",)),
            ("odd", "rows", 200, 136, 72, ("bias", "rs", "res", "nmajor")),
            ("odd", "rows", 300, 200, 104, ("f32", "nmajor")),
            ("odd", "rows", 77, 40, 520, ("f32",)),
            ("odd", "splitk", 45, 29, 1000, ()),
            ("odd", "splitk", 48, 40, 1000, ()),
            ("odd", "splitk", 40, 200, 333, ()),
            ("odd", "splitk", 96, 64, 704, ("kmajor",)),
            ("ViT-S/16 qkv", "rows", M, 1152, 384, ("bias",)),
            ("ViT-S/16 out projection", "rows", M, 384, 384, ("bias", "rs", "res")),
            ("ViT-S/16 FF1 (eval)", "rows", M, 1536, 384, ("bias", "silu")),
            ("ViT-S/16 FF2 (eval)", "rows", M, 384, 1536, ("bias", "res")),
            ("ViT-S/16 dln (f32 out)", "rows", M, 384, 1152, ("f32", "nmajor")),
            ("ViT-S/16 dwqkv", "splitk", 384, 1152, M, ()),
            ("ViT-S/16 dwout", "splitk", 384, 384, M, ())]


def plan_text(plan):
    return (f"{plan['route']}" + (f", {plan['bn']} columns, "
                                  f"{'promoted every 64 k' if plan['promote'] else 'one accumulator'}"
                                  f", {plan['stages']} stages" if plan["route"] == "tma" else
                                  f", {plan['bn']} columns"))


def gemm_bf16_kernels(torch):
    """The GEMM core's bf16 form against its plain version, the route it
    took printed (the odd shapes off 8-element rows on the register path,
    the rest by TMA); at ViT-S/16's products timed beside torch.matmul in
    bf16 (f32 reduction) and the bound.  Returns {label: (ms, matmul ms,
    bound ms, plan)} of the products."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import gemm as gm

    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(7)
    timed = {}
    for label, form, M, N, K, opts in gemm_bf16_calls():
        def r(*shape, s=1.0):
            return (s * torch.randn(shape, generator=g, device=DEVICE)).to(bf)
        splitk = form == "splitk"
        a = r(K, M) if splitk else r(M, K)  # split-K: a [K, M], the storage of aᵀ
        if splitk:  # dY [K, N] row-major (N-major), or a transposed view (K-major)
            b = r(N, K).t() if "kmajor" in opts else r(K, N)
        else:  # the forward's w.t() view (K-major), or a data gradient's w (N-major)
            b = r(K, N, s=0.05) if "nmajor" in opts else r(N, K, s=0.05).t()
        kw = {}
        if "bias" in opts:
            kw["bias"] = r(N, s=0.1)
        if "silu" in opts:
            kw["silu"] = True
        if "rs" in opts:
            kw.update(rs=torch.rand(-(-M // 197), generator=g, device=DEVICE) + 0.5,
                      rs_rows=197)
        if "res" in opts:
            kw["res"] = r(M, N)
        if "f32" in opts:
            kw["out_f32"] = True
        splits = fl._splits(M, N, K) if splitk else 1
        if splitk:
            kw["splits"] = splits
        out, plan = gm.gemm_bf16(a, b, form=form, plan=True, **kw)
        torch.cuda.synchronize()
        ref_kw = {k: v for k, v in kw.items() if k != "splits"}
        plain = gm.gemm_bf16_reference(a, b, form=form, **ref_kw)
        f32_out = splitk or "f32" in opts
        tol = 1e-3 if f32_out else BF16_FWD_TOL
        what = f"GEMM core {label} [{M}, {N}, {K}] {form} {'+'.join(opts) or 'plain'}"
        bf16_close(torch, f"{what} (route: {plan_text(plan)})", out, plain, tol)
        if label == "odd":
            continue
        call_ms = median_ms(torch, lambda: gm.gemm_bf16(a, b, form=form, **kw))
        ms = device_ms(torch, lambda: gm.gemm_bf16(a, b, form=form, **kw))
        lhs = a.t() if splitk else a
        lib_ms = device_ms(torch, lambda: torch.matmul(lhs, b))
        nbytes = 2 * (M * K + K * N) + (4 if f32_out else 2) * M * N
        bound_ms, by = bound(2 * M * N * K, nbytes, H100_BF16_FLOPS)
        log(f"bf16: {what}: kernel {ms:.3f} ms device ({call_ms:.3f} a call from the host; "
            f"{plan_text(plan)}), torch.matmul (bf16, f32 reduction) {lib_ms:.3f} ms device, "
            f"bound {bound_ms:.3f} ms ({by})" + (f", {splits} K-slabs" if splitk else ""))
        timed[label] = (ms, lib_ms, bound_ms, plan)
    release_timing_stream(torch)
    return timed


def promotion_check(torch):
    """The bf16 sums with the promotion every 64 k and with one accumulator
    over K (each tile's whole K in the kernel; the promoted kernel on
    64-column tiles, one accumulator on the rule's), against an f64
    product of the same bf16 operands, at ViT-S/16's
    K (384, 1152, 1536) and the split-K slabs' depths at 25,216 rows
    (_splits, in whole 64-deep stages): the error over max(1, max|exact|)
    must stay within the f32-out limit, 1e-3, on the path's rule (one
    accumulator).  Returns {K: (promoted, one accumulator)}."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import gemm as gm

    rows = 128 * 197
    chunks = [-(-(-(-rows // fl._splits(m, n, rows))) // 64) * 64
              for m, n in ((384, 1152), (384, 384))]
    g = torch.Generator(device=DEVICE).manual_seed(11)
    errs = {}
    for K in (384, 1152, 1536, *chunks):
        a = torch.randn(4096, K, generator=g, device=DEVICE).to(torch.bfloat16)
        b = torch.randn(384, K, generator=g, device=DEVICE).to(torch.bfloat16).t()
        exact = a.double() @ b.double()
        scale = max(1.0, exact.abs().max().item())
        pair = []
        for promote in (True, False):
            out, plan = gm.gemm_bf16(a, b, out_f32=True, promote=promote, plan=True)
            torch.cuda.synchronize()
            if plan["promote"] != promote:
                raise RuntimeError(f"bf16 promotion check: asked {promote}, ran {plan}")
            pair.append((out.double() - exact).abs().max().item() / scale)
        log(f"bf16: promotion check K={K} [4096 x 384]: max|sums - f64| / max(1, max|f64|) "
            f"promoted every 64 k {pair[0]:.3e}, one accumulator {pair[1]:.3e} (limit 1e-3)")
        if max(pair) > 1e-3:
            raise RuntimeError(f"bf16 promotion check: K={K} outside the f32-out limit")
        errs[K] = tuple(pair)
    return errs


# the packed-row attention's bf16 form at odd shapes (B, N, H, D): one key
# (no gradient), one 128-key tile, two, the 208-key tile's edges, past the
# 256 keys whose dq is summed in shared memory; heads 16 to 64 wide
PACKED_BF16_ODD = ((2, 1, 2, 16), (2, 17, 3, 40), (2, 65, 2, 64), (2, 129, 3, 32),
                   (2, 193, 2, 64), (2, 208, 2, 40), (2, 257, 2, 16), (2, 577, 2, 64))


def packed_attention_bf16_kernels(torch):
    """The packed-row attention's bf16 form alone (csrc/attention_bf16_tma.cuh,
    through ops/fused_layer.py's thin doors): the forward with and without
    lse and the backward against their plain versions at PACKED_BF16_ODD
    and ViT-S/16's 128 x 197, the backward twice and bit-identical; at
    ViT-S/16 the device times (a CUDA graph of 10 calls; the backward with
    its dq sum and the L / Δ pass before it) beside
    scaled_dot_product_attention's forward and its backward alone
    (torch.autograd.grad on a retained graph, recorded on the timing
    stream) on the same bf16 q, k, v, the single-call medians, the plain
    versions' and the bounds.  Returns (forward record, backward record)."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(19)
    worst = {"fwd": 0.0, "bwd": 0.0}
    B, N, C, H, D, F = VIT_TRAIN
    for b_, n_, h_, d_ in PACKED_BF16_ODD + ((B, N, H, D),):
        route = fl.packed_attention_bf16_route(n_)
        what = (f"packed-row attention B,N,H,D=({b_},{n_},{h_},{d_}) (route: "
                f"{route['key_tile']}-key tiles, dq in {route['dq']})")
        qkv = torch.randn(b_, n_, 3 * h_ * d_, generator=g, device=DEVICE).to(bf)
        do = torch.randn(b_, n_, h_ * d_, generator=g, device=DEVICE).to(bf)
        out, lse = fl.packed_attention_bf16(qkv, h_)
        serving, _ = fl.packed_attention_bf16(qkv, h_, save=False)
        d1 = fl.packed_attention_bf16_bwd(qkv, out, lse, do, h_)
        d2 = fl.packed_attention_bf16_bwd(qkv, out, lse, do, h_)
        torch.cuda.synchronize()
        ref, ref_lse = fl.packed_attention_reference(qkv, h_)
        plain = fl.attention_bwd_reference(qkv, out, lse, do, h_, d_ ** -0.5, dtype=bf)[0]
        if not torch.equal(serving, out):
            raise RuntimeError(f"bf16: {what}: the serving forward differs from the saving one")
        if not torch.equal(d1, d2):
            raise RuntimeError(f"bf16: {what}: dqkv differs between two runs")
        worst["fwd"] = max(worst["fwd"], bf16_close(torch, what + " out", out, ref,
                                                    BF16_FWD_TOL))
        bf16_close(torch, what + " lse", lse, ref_lse, 1e-5)
        worst["bwd"] = max(worst["bwd"], bf16_close(
            torch, what + " dqkv (bit-identical across two runs)", d1, plain, BF16_BWD_TOL))
    # ViT-S/16: the last call's q, k, v
    scale = D ** -0.5
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16_close(torch, "packed-row attention at ViT-S/16 vs SDPA",
               out.view(B, N, H, D).transpose(1, 2), sdpa(q, k, v).detach(), BF16_FWD_TOL)
    ms = {"fwd": device_ms(torch, lambda: fl.packed_attention_bf16(qkv, H)),
          "serving": device_ms(torch, lambda: fl.packed_attention_bf16(qkv, H, save=False)),
          "bwd": device_ms(torch, lambda: fl.packed_attention_bf16_bwd(qkv, out, lse, do, H))}
    call = {"fwd": median_ms(torch, lambda: fl.packed_attention_bf16(qkv, H)),
            "bwd": median_ms(torch, lambda: fl.packed_attention_bf16_bwd(qkv, out, lse, do,
                                                                         H))}
    plain_ms = {"fwd": median_ms(torch, lambda: fl.packed_attention_reference(qkv, H)),
                "bwd": median_ms(torch, lambda: fl.attention_bwd_reference(
                    qkv, out, lse, do, H, scale, dtype=bf))}

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(q, k, v)

    sdpa_ms = {"fwd": device_ms(torch, sdpa_fwd)}
    # its backward alone: the forward recorded on the timing stream, so that
    # autograd runs the backward there, inside the capture
    timing = _WARMUP_STREAM[0]
    timing.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(timing):
        o = sdpa(q, k, v)
    torch.cuda.current_stream().wait_stream(timing)
    dog = do.view(B, N, H, D).transpose(1, 2)
    sdpa_ms["bwd"] = device_ms(torch, lambda: torch.autograd.grad(o, (q, k, v), dog,
                                                                  retain_graph=True))
    del o
    work = 4 * B * H * N * N * D
    bounds = {"fwd": bound(work, 2 * 4 * B * N * H * D + 4 * B * H * N, H100_BF16_FLOPS),
              "bwd": bound(2.5 * work, 2 * 8 * B * N * H * D + 4 * B * H * N, H100_BF16_FLOPS)}
    release_timing_stream(torch)
    log(f"bf16: the packed-row attention alone at ViT-S/16 (128 x 197, 6 heads x 64), device "
        f"ms (a CUDA graph of 10 calls): kernel fwd {ms['fwd']:.4f} (serving, no lse "
        f"{ms['serving']:.4f}), bwd with its dq sum {ms['bwd']:.4f}; "
        f"scaled_dot_product_attention fwd {sdpa_ms['fwd']:.4f}, bwd alone "
        f"{sdpa_ms['bwd']:.4f}; bounds fwd {bounds['fwd'][0]:.4f} ({bounds['fwd'][1]}), bwd "
        f"{bounds['bwd'][0]:.4f} ({bounds['bwd'][1]}); a call from the host fwd "
        f"{call['fwd']:.3f}, bwd {call['bwd']:.3f}; plain fwd {plain_ms['fwd']:.3f}, bwd "
        f"{plain_ms['bwd']:.3f}")
    shape = "ViT-S/16, B,N,H,D=128,197,6,64"
    return tuple({"shape": shape + (", lse" if kind == "fwd" else ", dq summed on chip"),
                  "max_abs_err": worst[kind], "ms": ms[kind], "call_ms": call[kind],
                  "plain_ms": plain_ms[kind], "bound_ms": bounds[kind][0],
                  "bound_by": bounds[kind][1], "library_ms": sdpa_ms[kind],
                  "route": fl.packed_attention_bf16_route(N),
                  **({"serving_ms": ms["serving"]} if kind == "fwd" else {})}
                 for kind in ("fwd", "bwd"))


# the packed-row attention's bf16 form with the additive bias: (label, B,
# N, H, D, the bias) — DINO's local call at 96 images (256 rows of 111
# tokens: 3 crops of 37 under the block-diagonal −1e9 mask), and a grouped
# bias (G = 2) over 200 tokens whose −1e9 blocks leave the second block's
# queries a first 128-key tile all masked
PACKED_BF16_BIAS = (("DINO DeiT-S/16 locals (96 images)", 256, 111, 6, 64, "mask"),
                    ("grouped G=2, a first key tile all masked", 8, 200, 6, 64, "grouped"))


def packed_bias(torch, N, H, kind, g):
    """The bias of a PACKED_BF16_BIAS call, f32 on the card."""
    from vision_transformers_tpu_torch.models.vit import pack_mask

    if kind == "mask":
        return pack_mask(3, N // 3, DEVICE)
    blocks = torch.block_diag(torch.ones(128, 128), torch.ones(N - 128, N - 128)).to(DEVICE)
    return torch.where(blocks > 0, torch.randn(2, H, N, N, generator=g, device=DEVICE), -1e9)


def bias_attention_work(B, N, H, D, G, backward=False):
    """(operations, bytes) of the packed-row attention with a bias [G, H,
    N, N] f32: q, k, v (and dout, out) read and out (dqkv) written in bf16,
    lse 4 bytes a row, the bias read once."""
    work, act, bias = 4 * B * H * N * N * D, 2 * B * N * H * D, 4 * (G * H * N * N + B * H * N)
    return (2.5 * work, 8 * act + bias) if backward else (work, 4 * act + bias)


def packed_attention_bf16_bias_kernels(torch):
    """The packed-row attention's bf16 form with the bias alone
    (csrc/attention_bf16_tma.cuh's HAS_BIAS instantiations, through the thin
    doors): at PACKED_BF16_BIAS the forward with and without lse and the
    backward against their plain versions, the backward twice and
    bit-identical; at DINO's local call the device times (CUDA graphs of 10
    calls; the same call without the bias beside) and
    scaled_dot_product_attention's forward and its backward alone with the
    mask as a float attn_mask (bf16, as SDPA takes it with
    bf16 q, k, v), the single-call medians, the plain versions' and the
    bounds.  Returns (forward record, backward record)."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(23)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for label, B, N, H, D, kind in reversed(PACKED_BF16_BIAS):  # DINO's call last
        extra = packed_bias(torch, N, H, kind, g)
        what = f"packed-row attention + bias, {label}, B,N,H,D=({B},{N},{H},{D})"
        qkv = torch.randn(B, N, 3 * H * D, generator=g, device=DEVICE).to(bf)
        do = torch.randn(B, N, H * D, generator=g, device=DEVICE).to(bf)
        out, lse = fl.packed_attention_bf16(qkv, H, extra=extra)
        serving, _ = fl.packed_attention_bf16(qkv, H, save=False, extra=extra)
        d1 = fl.packed_attention_bf16_bwd(qkv, out, lse, do, H, extra=extra)
        d2 = fl.packed_attention_bf16_bwd(qkv, out, lse, do, H, extra=extra)
        torch.cuda.synchronize()
        ref, ref_lse = fl.packed_attention_reference(qkv, H, extra=extra)
        extra_g = fl.extra_groups(extra, B, H, N)[0]
        plain = fl.attention_bwd_reference(qkv, out, lse, do, H, D ** -0.5, extra_g,
                                           dtype=bf)[0]
        if not torch.equal(serving, out):
            raise RuntimeError(f"bf16: {what}: the serving forward differs from the saving one")
        if not torch.equal(d1, d2):
            raise RuntimeError(f"bf16: {what}: dqkv differs between two runs")
        worst["fwd"] = max(worst["fwd"], bf16_close(torch, what + " out", out, ref,
                                                    BF16_FWD_TOL))
        bf16_close(torch, what + " lse", lse, ref_lse, 1e-5)
        worst["bwd"] = max(worst["bwd"], bf16_close(
            torch, what + " dqkv (bit-identical across two runs)", d1, plain, BF16_BWD_TOL))
    # DINO's local call: the last case's tensors
    G = extra_g.shape[0]
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0))
    mask = extra.to(bf)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf16_close(torch, f"packed-row attention + mask at {label} vs SDPA",
               out.view(B, N, H, D).transpose(1, 2), sdpa(q, k, v, attn_mask=mask).detach(),
               BF16_FWD_TOL)
    ms = {"fwd": device_ms(torch, lambda: fl.packed_attention_bf16(qkv, H, extra=extra)),
          "bwd": device_ms(torch, lambda: fl.packed_attention_bf16_bwd(qkv, out, lse, do, H,
                                                                       extra=extra))}
    call = {"fwd": median_ms(torch, lambda: fl.packed_attention_bf16(qkv, H, extra=extra)),
            "bwd": median_ms(torch, lambda: fl.packed_attention_bf16_bwd(qkv, out, lse, do, H,
                                                                         extra=extra))}
    out0, lse0 = fl.packed_attention_bf16(qkv, H)  # the same call without the bias
    no_bias = {"fwd": device_ms(torch, lambda: fl.packed_attention_bf16(qkv, H)),
               "bwd": device_ms(torch, lambda: fl.packed_attention_bf16_bwd(qkv, out0, lse0, do,
                                                                            H))}
    plain_ms = {"fwd": median_ms(torch, lambda: fl.packed_attention_reference(qkv, H,
                                                                              extra=extra)),
                "bwd": median_ms(torch, lambda: fl.attention_bwd_reference(
                    qkv, out, lse, do, H, D ** -0.5, extra_g, dtype=bf))}

    def sdpa_fwd():
        with torch.no_grad():
            sdpa(q, k, v, attn_mask=mask)

    sdpa_ms = {"fwd": device_ms(torch, sdpa_fwd)}
    timing = _WARMUP_STREAM[0]  # its backward alone, recorded on the timing stream
    timing.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(timing):
        o = sdpa(q, k, v, attn_mask=mask)
    torch.cuda.current_stream().wait_stream(timing)
    dog = do.view(B, N, H, D).transpose(1, 2)
    sdpa_ms["bwd"] = device_ms(torch, lambda: torch.autograd.grad(o, (q, k, v), dog,
                                                                  retain_graph=True))
    del o
    bounds = {kind: bound(*bias_attention_work(B, N, H, D, G, kind == "bwd"), H100_BF16_FLOPS)
              for kind in ("fwd", "bwd")}
    release_timing_stream(torch)
    log(f"bf16: the packed-row attention with DINO's mask alone at {label} ({B} x {N}, "
        f"{H} heads x {D}), device ms (a CUDA graph of 10 calls): kernel fwd {ms['fwd']:.4f}, "
        f"bwd with its dq sum {ms['bwd']:.4f} (the same call without the bias "
        f"{no_bias['fwd']:.4f} / {no_bias['bwd']:.4f}); scaled_dot_product_attention with the "
        f"mask "
        f"fwd {sdpa_ms['fwd']:.4f}, bwd alone {sdpa_ms['bwd']:.4f}; bounds fwd "
        f"{bounds['fwd'][0]:.4f} ({bounds['fwd'][1]}), bwd {bounds['bwd'][0]:.4f} "
        f"({bounds['bwd'][1]}); a call from the host fwd {call['fwd']:.3f}, bwd "
        f"{call['bwd']:.3f}; plain fwd {plain_ms['fwd']:.3f}, bwd {plain_ms['bwd']:.3f}")
    shape = f"{label}, B,N,H,D={B},{N},{H},{D}, block mask"
    return tuple({"shape": shape + (", lse" if kind == "fwd" else ", dq summed on chip"),
                  "max_abs_err": worst[kind], "ms": ms[kind], "call_ms": call[kind],
                  "plain_ms": plain_ms[kind], "bound_ms": bounds[kind][0],
                  "bound_by": bounds[kind][1], "library_ms": sdpa_ms[kind],
                  "no_bias_ms": no_bias[kind],
                  "route": fl.packed_attention_bf16_route(N, bias=True)}
                 for kind in ("fwd", "bwd"))


def bf16_kernels(torch):
    """3bf: the bf16 forms of B1 (forward with saves, serving, backward) and
    B2 (serving) against their plain versions at odd shapes and at the
    ViT-S/16 trainer's and eval's calls (128 images, per-sample row scales),
    the backward twice for bit-identity; the GEMM core's bf16 form at the
    products of those calls, and the packed-row attention's bf16 form alone
    (packed_attention_bf16_kernels).  Returns the timed records of the three
    entries and of the attention's two kernels."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    bf = torch.bfloat16
    products = gemm_bf16_kernels(torch)
    promotion = promotion_check(torch)
    worst = {"fwd": 0.0, "bwd": 0.0, "l1": 0.0}
    for shape in BF16_ODD + (VIT_TRAIN,):
        B, N, C, H, D, F = shape
        a = bf16_args(torch, *shape, seed=B + N)
        for rows_scaled in (False, True):
            r = None
            if rows_scaled:
                r = torch.full((B,), 1 / 0.9, device=DEVICE)
                r[::3] = 0.0  # dropped samples beside kept ones
            what = f"B1 B,N,C,H,D={shape[:5]} rs={rows_scaled}"
            out, saved = fl.fused_attention_layer_fwd(*a[:7], H, row_scale=r)
            dz = torch.randn(B, N, C, device=DEVICE, generator=torch.Generator(
                device=DEVICE).manual_seed(N)).to(bf)
            grads = fl.fused_attention_layer_bwd(saved, dz)
            again = fl.fused_attention_layer_bwd(saved, dz)
            serving = fl.fused_attention_layer(*a[:7], H, row_scale=r)
            torch.cuda.synchronize()
            out_p, saved_p = fl.fused_attention_layer_fwd_reference(*a[:7], H, row_scale=r)
            plain = fl.fused_attention_layer_bwd_reference(saved_p, dz)
            worst["fwd"] = max(worst["fwd"], bf16_close(torch, what + " out", out, out_p,
                                                        BF16_FWD_TOL))
            bf16_close(torch, what + " serving", serving, out_p, BF16_FWD_TOL)
            for name, k, k2, p in zip(GRAD_NAMES, grads, again, plain):
                if p is None:
                    if k is not None:
                        raise RuntimeError(f"bf16: {what} {name} should be None")
                    continue
                if not torch.equal(k, k2):
                    raise RuntimeError(f"bf16: {what} {name} differs between two runs")
                worst["bwd"] = max(worst["bwd"], bf16_close(
                    torch, f"{what} {name} ({k.dtype}, bit-identical across two runs)", k,
                    p, BF16_BWD_TOL))
        a2 = bf16_args(torch, *shape, seed=B)
        out = fl1.fused_transformer_layer(*a2, H)
        torch.cuda.synchronize()
        worst["l1"] = max(worst["l1"], bf16_close(
            torch, f"B2 B,N,C,H,D,F={shape}", out,
            fl1.fused_transformer_layer_reference(*a2, H), BF16_FWD_TOL))

    # the trainer's call (128 images, row scales) and the eval's (128 rows)
    B, N, C, H, D, F = VIT_TRAIN
    a = bf16_args(torch, *VIT_TRAIN, seed=1)
    r = torch.full((B,), 1 / 0.9, device=DEVICE)
    r[::10] = 0.0
    dz = torch.randn(B, N, C, device=DEVICE).to(bf)
    _, saved = fl.fused_attention_layer_fwd(*a[:7], H, row_scale=r)
    _, saved_p = fl.fused_attention_layer_fwd_reference(*a[:7], H, row_scale=r)
    fwd_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd(*a[:7], H, row_scale=r))
    bwd_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd(saved, dz))
    plain_fwd_ms = median_ms(
        torch, lambda: fl.fused_attention_layer_fwd_reference(*a[:7], H, row_scale=r))
    plain_bwd_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd_reference(saved_p,
                                                                                   dz))
    l1_ms = median_ms(torch, lambda: fl1.fused_transformer_layer(*a, H))
    plain_l1_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_reference(*a, H))
    fwd_bound, fwd_by = bound(*b1_bf16_work(B, N, C, H, D), H100_BF16_FLOPS)
    bwd_bound, bwd_by = bound(*b1_bf16_work(B, N, C, H, D, backward=True), H100_BF16_FLOPS)
    l1_bound, l1_by = bound(*b2_bf16_work(*VIT_TRAIN), H100_BF16_FLOPS)
    att_fwd, att_bwd = packed_attention_bf16_kernels(torch)
    bias_fwd, bias_bwd = packed_attention_bf16_bias_kernels(torch)
    log(f"bf16: B1 at the ViT-S/16 trainer's call B,N,C,H,D={VIT_TRAIN[:5]} with row scales "
        f"(median of 20, CUDA events): kernel fwd(saves) {fwd_ms:.3f} + bwd {bwd_ms:.3f} = "
        f"{fwd_ms + bwd_ms:.3f} ms; plain fwd {plain_fwd_ms:.3f} + bwd {plain_bwd_ms:.3f} ms; "
        f"bound (bf16 989 TFLOP/s) fwd {fwd_bound:.3f} ({fwd_by}) + bwd {bwd_bound:.3f} "
        f"({bwd_by}) ms")
    log(f"bf16: B2 at the eval's call (128 rows): kernel {l1_ms:.3f} ms, plain "
        f"{plain_l1_ms:.3f} ms, bound {l1_bound:.3f} ms ({l1_by})")
    shape = "ViT-S/16 trainer, B,N,C,H,D=" + ",".join(map(str, VIT_TRAIN[:5])) + ", row scale"
    return {
        "fused_attention_layer[bf16]": [{
            "shape": shape + ", saves", "max_abs_err": worst["fwd"], "ms": fwd_ms,
            "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
            "library_ms": None,
            # the GEMM core's bf16 form under B1 and B2, product by product
            # (device ms, torch.matmul's, the bound, the route), and its
            # accumulation's error with and without the promotion
            "gemm_products": {k: {"ms": v[0], "matmul_ms": v[1], "bound_ms": v[2], **v[3]}
                              for k, v in products.items()},
            "gemm_promotion_check": {str(k): {"promoted": v[0], "one_accumulator": v[1]}
                                     for k, v in promotion.items()}}],
        "fused_attention_layer_bwd[bf16]": [{
            "shape": shape, "max_abs_err": worst["bwd"], "ms": bwd_ms,
            "plain_ms": plain_bwd_ms, "bound_ms": bwd_bound, "bound_by": bwd_by,
            "library_ms": None}],
        "fused_transformer_layer[bf16]": [{
            "shape": "ViT-S/16 eval, B,N,C,H,D,F=" + ",".join(map(str, VIT_TRAIN)),
            "max_abs_err": worst["l1"], "ms": l1_ms, "plain_ms": plain_l1_ms,
            "bound_ms": l1_bound, "bound_by": l1_by, "library_ms": None}],
        "packed_attention[bf16]": [att_fwd],
        "packed_attention_bwd[bf16]": [att_bwd],
        "packed_attention+bias[bf16]": [bias_fwd],
        "packed_attention_bwd+bias[bf16]": [bias_bwd]}


def swin_bf16_kernels(torch):
    """3bf (Swin-S): B2's bf16 training forward (saves, the grouped bias,
    both row scales) and backward (every gradient, the bias's among them),
    and the packed-row attention's bf16 backward with the bias's gradient
    alone, against their plain versions at the four Swin-S stage calls of
    the trainer (64 images) within BF16_FWD_TOL / BF16_BWD_TOL, each
    backward twice and bit-identical; at each stage the median ms of B2's
    forward and backward (CUDA events) beside the plain versions and the
    bounds at the bf16 rate, and the attention's backward with dbias on the
    device (a CUDA graph of 10 calls) beside scaled_dot_product_attention's
    backward alone with the bias as a float attn_mask (q, k, v's gradients;
    SDPA gives no grouped bias gradient), the f32 window attention's
    backward with dbias (csrc/window_attention_tc.cuh, the f32 path's) and
    the bound.  Returns the three records, stage 1 first."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1
    from vision_transformers_tpu_torch.ops import window_attention as wa

    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=DEVICE).manual_seed(29)
    recs = {"fwd": [], "bwd": [], "att": []}
    for call in swin_stages(64):
        B, N, C, H, D, F = call["shape"]
        G, scale = call["groups"], D ** -0.5
        a32, extra, rs = swin_layer_inputs(torch, call, True, seed=call["stage"])
        a = [t if i in (1, 2, 7, 8) else t.to(bf) for i, t in enumerate(a32)]
        what = f"B2 Swin-S stage {call['stage']} B,N,C,H,D,F={call['shape']} G={G}"
        out, saved = fl1.fused_transformer_layer_fwd(*a, H, extra, *rs)
        do = torch.randn(B, N, C, generator=g, device=DEVICE).to(bf)
        grads = fl1.fused_transformer_layer_bwd(saved, do)
        again = fl1.fused_transformer_layer_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, saved_p = fl1.fused_transformer_layer_fwd_reference(*a, H, extra, *rs)
        plain = fl1.fused_transformer_layer_bwd_reference(saved_p, do)
        err_f = bf16_close(torch, what + " out", out, out_p, BF16_FWD_TOL)
        for name in ("z", "hid"):
            bf16_close(torch, f"{what} {name} (saved)", getattr(saved, name),
                       getattr(saved_p, name), BF16_FWD_TOL)
        err_b = 0.0
        for name, k, k2, p in zip(fl1.GRAD_NAMES, grads, again, plain):
            if not torch.equal(k, k2):
                raise RuntimeError(f"bf16: {what} {name} differs between two runs")
            err_b = max(err_b, bf16_close(
                torch, f"{what} {name} ({k.dtype}, bit-identical across two runs)", k, p,
                BF16_BWD_TOL))
        # the attention's backward with the bias's gradient alone, on the saves
        qkv, acc, lse = saved.qkv, saved.acc, saved.lse
        dout = torch.randn(B, N, H * D, generator=g, device=DEVICE).to(bf)
        d1, db1 = fl.packed_attention_bf16_bwd(qkv, acc, lse, dout, H, extra=extra, dbias=True)
        d2, db2 = fl.packed_attention_bf16_bwd(qkv, acc, lse, dout, H, extra=extra, dbias=True)
        torch.cuda.synchronize()
        if not (torch.equal(d1, d2) and torch.equal(db1, db2)):
            raise RuntimeError(f"bf16: {what} attention backward differs between two runs")
        dq_p, ds = fl.attention_bwd_reference(qkv, acc, lse, dout, H, scale, extra, dtype=bf)
        db_p = ds.reshape(G, B // G, H, N, N).sum(1)
        del ds
        aw = f"packed-row attention bwd + dbias, Swin-S stage {call['stage']} B,N,H,D=" \
             f"({B},{N},{H},{D}) G={G}"
        err_a = max(bf16_close(torch, aw + " dqkv", d1, dq_p.to(bf), BF16_BWD_TOL),
                    bf16_close(torch, aw + " dbias (bit-identical across two runs)", db1, db_p,
                               BF16_BWD_TOL))
        # times: B2 (host-inclusive medians) and the attention's backward alone
        fwd_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_fwd(*a, H, extra, *rs))
        bwd_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_bwd(saved, do))
        plain_fwd = median_ms(torch, lambda: fl1.fused_transformer_layer_fwd_reference(
            *a, H, extra, *rs), reps=5, warmup=1)
        plain_bwd = median_ms(torch, lambda: fl1.fused_transformer_layer_bwd_reference(
            saved_p, do), reps=5, warmup=1)
        att_ms = device_ms(torch, lambda: fl.packed_attention_bf16_bwd(
            qkv, acc, lse, dout, H, extra=extra, dbias=True))
        att_call = median_ms(torch, lambda: fl.packed_attention_bf16_bwd(
            qkv, acc, lse, dout, H, extra=extra, dbias=True))
        att_plain = median_ms(torch, lambda: fl.attention_bwd_reference(
            qkv, acc, lse, dout, H, scale, extra, dtype=bf), reps=5, warmup=1)
        q, k, v = (t.detach().requires_grad_() for t in
                   qkv.view(B, N, 3, H, D).permute(2, 0, 3, 1, 4).unbind(0))
        mask = extra[:, None].expand(G, B // G, H, N, N).reshape(B, H, N, N).to(bf)
        timing = _WARMUP_STREAM[0]  # SDPA's backward alone, on the timing stream
        timing.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(timing):
            o = sdpa(q, k, v, attn_mask=mask)
        torch.cuda.current_stream().wait_stream(timing)
        dog = dout.view(B, N, H, D).transpose(1, 2)
        sdpa_bwd = device_ms(torch, lambda: torch.autograd.grad(o, (q, k, v), dog,
                                                                retain_graph=True))
        del o, q, k, v, mask
        q32 = qkv.float().reshape(B * N, 3 * H * D)
        wo, wl = wa.window_attention_fwd(q32, extra, H, scale)
        dw = dout.float().reshape(B * N, H * D)
        window_bwd = device_ms(torch, lambda: wa.window_attention_bwd(q32, extra, wo, wl, dw,
                                                                      H, scale))
        del q32, wo, wl, dw
        release_timing_stream(torch)
        fb, fby = bound(*b2_bf16_work(B, N, C, H, D, F, G, saves=True), H100_BF16_FLOPS)
        bb, bby = bound(*b2_bf16_work(B, N, C, H, D, F, G, backward=True), H100_BF16_FLOPS)
        aops, abytes = bias_attention_work(B, N, H, D, G, backward=True)
        ab, aby = bound(aops, abytes + 4 * G * H * N * N, H100_BF16_FLOPS)
        log(f"bf16: {what}: B2 fwd(saves) {fwd_ms:.3f} + bwd {bwd_ms:.3f} ms (median of 20, "
            f"CUDA events); plain {plain_fwd:.3f} + {plain_bwd:.3f}; bound (bf16 989 TFLOP/s) "
            f"{fb:.3f} ({fby}) + {bb:.3f} ({bby}); the attention's bwd with dbias on the "
            f"device {att_ms:.4f} ms (a call from the host {att_call:.3f}), SDPA + float mask "
            f"bwd alone {sdpa_bwd:.4f}, the f32 window attention's bwd with dbias "
            f"{window_bwd:.4f}, bound {ab:.4f} ({aby}), plain {att_plain:.3f}")
        shape = (f"Swin-S stage {call['stage']} trainer (64 images), B,N,C,H,D,F="
                 + ",".join(map(str, call["shape"])) + f", G={G}, both row scales")
        recs["fwd"].append({"shape": shape + ", saves", "max_abs_err": err_f, "ms": fwd_ms,
                            "plain_ms": plain_fwd, "bound_ms": fb, "bound_by": fby,
                            "library_ms": None})
        recs["bwd"].append({"shape": shape, "max_abs_err": err_b, "ms": bwd_ms,
                            "plain_ms": plain_bwd, "bound_ms": bb, "bound_by": bby,
                            "library_ms": None})
        recs["att"].append({"shape": f"Swin-S stage {call['stage']}, B,N,H,D={B},{N},{H},{D}"
                                     f", G={G}, dq and dbias on chip",
                            "max_abs_err": err_a, "ms": att_ms, "call_ms": att_call,
                            "plain_ms": att_plain, "bound_ms": ab, "bound_by": aby,
                            "library_ms": sdpa_bwd, "window_f32_ms": window_bwd})
        del a, a32, saved, saved_p, grads, again, plain, d1, d2, db1, db2, dq_p, db_p
    return recs["fwd"], recs["bwd"], recs["att"]


# ---------------------------------------------------------------------------
# 3b. the backward kernels vs their plain versions
# ---------------------------------------------------------------------------


def bwd_args(torch, B, N, C, H, D, rs, seed=1):
    """Seeded forward inputs (weights as transposed views), a row scale of
    dropped / kept samples (keep 0.9) when ``rs``, and the output grad."""
    a = layer_args(torch, B, N, C, H, D, 4 * C, seed=seed)[:7]
    rng = np.random.default_rng(seed + 100)
    r = None
    if rs:
        keep = rng.random(B) < 0.9
        keep[0], keep[-1] = False, True  # both kinds at every shape
        r = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
    dz = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(DEVICE)
    return a, r, dz


def compare_grads(torch, what, names, kernel, again, plain, worst):
    """Per tensor: finite, bit-identical across two kernel runs, within
    1e-3·max(1, max|plain|) of the plain version."""
    for name, k, k2, p in zip(names, kernel, again, plain):
        if p is None:
            if k is not None:
                raise RuntimeError(f"backward {what}: {name} should be None")
            continue
        if k.shape != p.shape or not torch.isfinite(k).all():
            raise RuntimeError(f"backward {what}: bad {name}")
        if not torch.equal(k, k2):
            raise RuntimeError(f"backward {what}: {name} differs between two runs "
                               f"of the kernel")
        err = (k - p).abs().max().item()
        tol = 1e-3 * max(1.0, p.abs().max().item())
        which = "out" if name == "out" else "grads"
        worst[which] = max(worst[which], err)
        log(f"backward: {what} {name}: max|kernel-plain| {err:.3e} (tol {tol:.3e}), "
            f"bit-identical across two runs")
        if err > tol:
            raise RuntimeError(f"backward: {name} disagrees with the plain version")


GRAD_NAMES = ("dx", "dln_scale", "dln_bias", "dwqkv", "dbqkv", "dwout", "dbout", "drs")


def backward_kernel(torch):
    """3b, the attention layer: forward (with saves) + backward kernel
    against the plain forward + plain backward, twice for bit-identity, at
    an odd shape and at the ViT trainer's calls (B=128: layer 0 without a
    row scale, the others with one); returns the timed records of the
    training forward and of the backward."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    train_shape = (128, 197, 384, 6, 64)
    worst = {"out": 0.0, "grads": 0.0}
    for shape, use_rs in (((3, 37, 48, 2, 24), False), ((3, 37, 48, 2, 24), True),
                          (train_shape, False), (train_shape, True)):
        a, rs, dz = bwd_args(torch, *shape, use_rs)
        H = shape[3]
        out, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=rs)
        grads = fl.fused_attention_layer_bwd(saved, dz)
        again = fl.fused_attention_layer_bwd(saved, dz)
        torch.cuda.synchronize()
        out_p, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs)
        plain = fl.fused_attention_layer_bwd_reference(saved_p, dz)
        compare_grads(torch, f"B,N,C,H,D={shape} rs={use_rs}", ("out",) + GRAD_NAMES,
                      (out,) + grads, (out,) + again, (out_p,) + plain, worst)

    a, rs, dz = bwd_args(torch, *train_shape, True)
    H = train_shape[3]
    _, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=rs)
    _, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs)
    fwd_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd(*a, H, row_scale=rs))
    ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd(saved, dz))
    plain_fwd_ms = median_ms(
        torch, lambda: fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs))
    plain_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd_reference(saved_p, dz))
    bwd_ms, by = bound(*attn_bwd_work(*train_shape))
    fwd_bound, fwd_by = bound(*attn_fwd_work(*train_shape, saves=True))
    log(f"backward: B=128 N=197 C=384 H=6 D=64 with rs (median of 20, CUDA events): "
        f"kernel fwd(saves) {fwd_ms:.3f} + bwd {ms:.3f} = {fwd_ms + ms:.3f} ms; "
        f"plain fwd {plain_fwd_ms:.3f} + bwd {plain_ms:.3f} = "
        f"{plain_fwd_ms + plain_ms:.3f} ms; bound fwd {fwd_bound:.3f} + bwd "
        f"{bwd_ms:.3f} ms ({by})")
    shape = "ViT-S, B,N,C,H,D=" + ",".join(map(str, train_shape)) + ", row scale"
    fwd = {"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": fwd_ms,
           "plain_ms": plain_fwd_ms, "bound_ms": fwd_bound, "bound_by": fwd_by,
           "library_ms": None}
    bwd = {"shape": shape, "max_abs_err": worst["grads"], "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bwd_ms, "bound_by": by, "library_ms": None}
    return fwd, bwd


def swin_backward_kernel(torch):
    """3b, the whole layer: training forward (with saves) + backward kernel
    against the plain forward + plain backward, with the grouped bias, twice
    for bit-identity, at an odd shape and at the four Swin-S stages of the
    trainer's 64-image micro-batches, each with and without both row scales;
    then median ms of each stage's call with row scales.  Returns the timed
    entries of the training forward and of the backward, stage 3 (18 of the
    24 layers) first."""
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1

    worst = {"out": 0.0, "grads": 0.0}
    stages = swin_stages(64)
    for call in [SWIN_ODD] + stages:
        for use_rs in (False, True):
            a, extra, (r1, r2) = swin_layer_inputs(torch, call, use_rs, seed=1)
            H = call["shape"][3]
            do = torch.randn(a[0].shape, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(2))
            out, saved = fl1.fused_transformer_layer_fwd(*a, H, extra, r1, r2)
            grads = fl1.fused_transformer_layer_bwd(saved, do)
            again = fl1.fused_transformer_layer_bwd(saved, do)
            torch.cuda.synchronize()
            out_p, saved_p = fl1.fused_transformer_layer_fwd_reference(*a, H, extra, r1, r2)
            plain = fl1.fused_transformer_layer_bwd_reference(saved_p, do)
            what = (f"Swin stage {call['stage']} B,N,C,H,D,F={call['shape']} "
                    f"G={call['groups']} rs={use_rs}")
            compare_grads(torch, what, ("out",) + fl1.GRAD_NAMES, (out,) + grads,
                          (out,) + again, (out_p,) + plain, worst)
            del saved, saved_p, grads, again, plain
    # without a bias (ViT-S/16's widths at 8 rows): the packed-row attention
    shape = vit_shape(8)
    for use_rs in (False, True):
        a = layer_args(torch, *shape, seed=1)
        r = None
        if use_rs:
            r = torch.tensor([0.0] + [1 / 0.9] * (shape[0] - 1), device=DEVICE)
        do = torch.randn(a[0].shape, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(2))
        out, saved = fl1.fused_transformer_layer_fwd(*a, shape[3], None, r, r)
        grads = fl1.fused_transformer_layer_bwd(saved, do)
        again = fl1.fused_transformer_layer_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, saved_p = fl1.fused_transformer_layer_fwd_reference(*a, shape[3], None, r, r)
        plain = fl1.fused_transformer_layer_bwd_reference(saved_p, do)
        compare_grads(torch, f"ViT-S B,N,C,H,D,F={shape} no bias rs={use_rs}",
                      ("out",) + fl1.GRAD_NAMES, (out,) + grads, (out,) + again,
                      (out_p,) + plain, worst)
        del saved, saved_p, grads, again, plain

    fwd, bwd = [], []
    for call in sorted(stages, key=lambda c: c["stage"] != 3):
        a, extra, (r1, r2) = swin_layer_inputs(torch, call, True, seed=1)
        H = call["shape"][3]
        do = torch.randn(a[0].shape, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(2))
        _, saved = fl1.fused_transformer_layer_fwd(*a, H, extra, r1, r2)
        _, saved_p = fl1.fused_transformer_layer_fwd_reference(*a, H, extra, r1, r2)
        f_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_fwd(*a, H, extra, r1, r2))
        b_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_bwd(saved, do))
        pf_ms = median_ms(
            torch, lambda: fl1.fused_transformer_layer_fwd_reference(*a, H, extra, r1, r2))
        pb_ms = median_ms(torch, lambda: fl1.fused_transformer_layer_bwd_reference(saved_p, do))
        kw = dict(groups=call["groups"], row_scales=True)
        fb, fby = bound(*layer_fwd_work(*call["shape"], saves=True, **kw))
        bb, bby = bound(*layer_bwd_work(*call["shape"], **kw))
        log(f"backward: Swin stage {call['stage']} train call (64 images, "
            f"B,N,C,H,D,F={call['shape']}, G={call['groups']}, bias, row scales; median "
            f"of 20, CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; "
            f"plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) "
            f"+ bwd {bb:.3f} ms ({bby})")
        shape = (f"Swin-S stage {call['stage']} train, B,N,C,H,D,F="
                 + ",".join(map(str, call["shape"])) + f", G={call['groups']}, row scales")
        fwd.append({"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": f_ms,
                    "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": None})
        bwd.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                    "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby, "library_ms": None})
        del saved, saved_p
    return fwd, bwd


# ---------------------------------------------------------------------------
# 3w. the map-resident Swin layer vs its plain version
# ---------------------------------------------------------------------------


def swin_map_fwd_work(call, groups, saves=False):
    """(operations, bytes) of the map-resident layer's forward: the whole
    layer's on its images·G window pairs (layer_fwd_work) with the bias
    [groups, H, m, m] and two per-image row scales."""
    flops, nbytes = layer_fwd_work(*call["shape"], groups=groups, saves=saves)
    return flops, nbytes + 4 * 2 * call["images"]


def swin_map_bwd_work(call, groups):
    """(operations, bytes) of its backward (layer_bwd_work), the row scales
    and their gradients per image."""
    flops, nbytes = layer_bwd_work(*call["shape"], groups=groups)
    return flops, nbytes + 4 * 4 * call["images"]


def swin_map_inputs(torch, call, shift, row_scales, seed=0):
    """Seeded inputs of one map-resident layer call at a Swin-S stage: the
    map [images, h, w, C] and the weights of ``layer_args``; a port
    WindowAttention of the stage (std-0.2 table) with its layout-native map
    bias ([G, H, m, m] shifted, [1, H, m, m] not) and its grouped bias
    [G, H, m, m] (the 'layer1' path's); with ``row_scales`` two per-image
    DropPath scales (keep 0.9)."""
    from vision_transformers_tpu_torch.models.swin import WindowAttention

    _, _, C, H, D, F = call["shape"]
    images, (h, w) = call["images"], call["size"]
    a = layer_args(torch, images, h * w, C, H, D, F, seed=seed)
    a[0] = a[0].reshape(images, h, w, C)
    attn = WindowAttention(C, H, D, call["size"], call["window"], shift=shift)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        attn.rel_pos.weight.normal_(0.0, 0.2, generator=gen)
        attn = attn.to(DEVICE)
        map_bias, grouped = attn.map_bias(), attn.grouped_bias()
    rs = [None, None]
    if row_scales:
        rng = np.random.default_rng(seed + 100)
        for i in range(2):
            keep = rng.random(images) < 0.9
            keep[0], keep[-1] = False, True  # both kinds at every shape
            rs[i] = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
    return a, map_bias, grouped, attn, rs


def swin_map_kernels(torch):
    """3w: the map-resident layer's serving forward, forward with saves and
    backward against the plain versions at the four Swin-S stage calls of
    the trainer's 64-image micro-batches, shifted and unshifted, with and
    without row scales (backward twice for bit-identity); then, per stage,
    median ms of the shifted call with row scales: the kernels, the plain
    versions, and the whole-layer kernel with the torch roll / partition
    and unpartition / unroll around it (forward) and their adjoints
    (backward).  Returns the timed entries of the forward and of the
    backward, stage 3 (18 of the 24 layers) first."""
    from vision_transformers_tpu_torch.ops import fused_layer1 as fl1
    from vision_transformers_tpu_torch.ops import fused_swin as fs

    worst = {"out": 0.0, "grads": 0.0}
    stages = swin_stages(64)
    for call in [SWIN_ODD] + stages:
        H = call["shape"][3]
        for shift in (True, False):
            for use_rs in (False, True):
                a, extra, _, _, (r1, r2) = swin_map_inputs(torch, call, shift, use_rs, 1)
                kw = dict(window=call["window"], shift=shift, pack=call["shape"][1] // call["window"] ** 2)
                do = torch.randn(a[0].shape, device=DEVICE,
                                 generator=torch.Generator(DEVICE).manual_seed(2))
                serve = fs.fused_swin_layer(*a, H, extra, r1, r2, **kw)
                out, saved = fs.fused_swin_layer_fwd(*a, H, extra, r1, r2, **kw)
                grads = fs.fused_swin_layer_bwd(saved, do)
                again = fs.fused_swin_layer_bwd(saved, do)
                torch.cuda.synchronize()
                out_p, saved_p = fs.fused_swin_layer_fwd_reference(*a, H, extra, r1, r2,
                                                                   **kw)
                plain = fs.fused_swin_layer_bwd_reference(saved_p, do)
                what = (f"Swin stage {call['stage']} map {call['size']} x {call['images']} images, "
                        f"C,H,D,F={call['shape'][2:]}, {'shifted' if shift else 'unshifted'}"
                        f" bias {tuple(extra.shape)}, rs={use_rs}")
                for name, o in (("serving", serve), ("training", out)):
                    err = check_close(torch, "fused_swin_layer", o, out_p, f"{what} {name}")
                    worst["out"] = max(worst["out"], err)
                compare_grads(torch, what, fs.GRAD_NAMES, grads, again, plain, worst)
                del saved, saved_p, grads, again, plain

    fwd, bwd = [], []
    for call in sorted(stages, key=lambda c: c["stage"] != 3):
        H, G = call["shape"][3], call["groups"]
        a, extra, grouped, attn, (r1, r2) = swin_map_inputs(torch, call, True, True, 1)
        kw = dict(window=call["window"], shift=True, pack=call["shape"][1] // call["window"] ** 2)
        do = torch.randn(a[0].shape, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(2))
        _, saved = fs.fused_swin_layer_fwd(*a, H, extra, r1, r2, **kw)
        _, saved_p = fs.fused_swin_layer_fwd_reference(*a, H, extra, r1, r2, **kw)
        tiled = (r1.repeat(G), r2.repeat(G))

        def b2_fwd():  # the 'layer1' path's layer: partition, B2, unpartition
            out, res = fl1.fused_transformer_layer_fwd(attn.partition(a[0]), *a[1:], H,
                                                       grouped, *tiled)
            return attn.unpartition(out, call["images"]), res

        _, saved_b2 = b2_fwd()

        def b2_bwd():
            g = fl1.fused_transformer_layer_bwd(saved_b2, attn.partition(do))
            return (attn.unpartition(g[0], call["images"]), g[14].reshape(G, -1).sum(0),
                    g[15].reshape(G, -1).sum(0))

        f_ms = median_ms(torch, lambda: fs.fused_swin_layer_fwd(*a, H, extra, r1, r2, **kw))
        b_ms = median_ms(torch, lambda: fs.fused_swin_layer_bwd(saved, do))
        pf_ms = median_ms(
            torch, lambda: fs.fused_swin_layer_fwd_reference(*a, H, extra, r1, r2, **kw))
        pb_ms = median_ms(torch, lambda: fs.fused_swin_layer_bwd_reference(saved_p, do))
        b2f_ms, b2b_ms = median_ms(torch, b2_fwd), median_ms(torch, b2_bwd)
        fb, fby = bound(*swin_map_fwd_work(call, G, saves=True))
        bb, bby = bound(*swin_map_bwd_work(call, G))
        log(f"kernels: fused_swin_layer Swin stage {call['stage']} train call (64 images, "
            f"map {call['size']}, C,H,D,F={call['shape'][2:]}, {G} pairs of "
            f"{call['shape'][1]} tokens per image, shifted, row scales; median of 20, "
            f"CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd "
            f"{pf_ms:.3f} + bwd {pb_ms:.3f} ms; whole-layer kernel between torch roll / "
            f"partition fwd {b2f_ms:.3f} + bwd {b2b_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) "
            f"+ bwd {bb:.3f} ms ({bby})")
        shape = (f"Swin-S stage {call['stage']} train, map {call['size'][0]}x"
                 f"{call['size'][1]} x 64, C,H,D,F=" + ",".join(map(str, call["shape"][2:]))
                 + f", {G} pairs of {call['shape'][1]}, shifted, row scales")
        fwd.append({"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": f_ms,
                    "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": None,
                    "layer1_partition_ms": b2f_ms})
        bwd.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                    "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby, "library_ms": None,
                    "layer1_partition_ms": b2b_ms})
        del saved, saved_p, saved_b2
    return fwd, bwd


# ---------------------------------------------------------------------------
# 3a. the tensor-core window attention alone vs its plain version
# ---------------------------------------------------------------------------


def window_fwd_work(P, N, H, D, G):
    """(operations, bytes) of the window attention's forward: q·kᵀ and p·v,
    4·P·H·N²·D on the tensor cores; qkv and the bias [G, H, N, N] read, out
    and lse written."""
    HD = H * D
    return 4 * P * H * N * N * D, 4 * (4 * P * N * HD + P * H * N + G * H * N * N)


def window_bwd_work(P, N, H, D, G):
    """(operations, bytes) of its backward: five products (scores, dp, dq,
    dk, dv), 10·P·H·N²·D on the tensor cores; qkv, out, do, lse and the bias
    read, dqkv and dbias written."""
    HD = H * D
    return 10 * P * H * N * N * D, 4 * (8 * P * N * HD + P * H * N + 2 * G * H * N * N)


def window_calls():
    """The window attention's calls: the four Swin-S stages of the trainer's
    64-image micro-batches with the shifted layers' grouped bias (B2's and
    B9's), Twins-SVT-S stage 3's pair mask at 128 images (B1's), SWIN_ODD,
    and 113 tokens in 3 groups (past a warp's 16 rows, past one backward
    round of 64, odd); each with (P, N, H, D, G) and how its bias is made."""
    calls = []
    for c in swin_stages(64):
        rows, N, C, H, D, _ = c["shape"]
        calls.append(dict(what=f"Swin-S stage {c['stage']}", P=rows, N=N, H=H, D=D,
                          G=c["groups"], swin=c, timed=True))
    tw = twins_stages(128)[2]
    rows, N, C, H, D, _ = tw["lsa"]
    calls.append(dict(what="Twins-SVT-S stage 3 pair mask", P=rows, N=N, H=H, D=D, G=1,
                      twins=tw, timed=True))
    rows, N, C, H, D, _ = SWIN_ODD["shape"]
    calls.append(dict(what="SWIN_ODD", P=rows, N=N, H=H, D=D, G=SWIN_ODD["groups"],
                      swin=SWIN_ODD, timed=False))
    calls.append(dict(what="odd 113 tokens", P=24, N=113, H=4, D=32, G=3, timed=False))
    return calls


def window_inputs(torch, call, seed=0):
    """qkv [P·N, 3·H·D] and dout [P·N, H·D] (std 1) and the call's bias: a
    port WindowAttention's grouped bias of a shifted layer (std-0.2 table),
    the port LocalAttention's pair mask, or a std-1 table with a −1e9 block."""
    from vision_transformers_tpu_torch.models.swin import WindowAttention
    from vision_transformers_tpu_torch.models.twins import LocalAttention

    P, N, H, D, G = (call[k] for k in ("P", "N", "H", "D", "G"))
    gen = torch.Generator(DEVICE).manual_seed(seed)
    qkv = torch.randn(P * N, 3 * H * D, device=DEVICE, generator=gen)
    dout = torch.randn(P * N, H * D, device=DEVICE, generator=gen)
    if "swin" in call:
        c = call["swin"]
        attn = WindowAttention(c["shape"][2], H, D, c["size"], c["window"], shift=True)
        with torch.no_grad():
            attn.rel_pos.weight.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(seed))
            bias = attn.to(DEVICE).grouped_bias().contiguous()
    elif "twins" in call:
        c = call["twins"]
        win = int(round((N // c["pack"]) ** 0.5))
        mask = LocalAttention(c["lsa"][2], H, D, win).pair_mask(c["pack"], DEVICE)
        bias = mask.float().expand(1, H, N, N).contiguous()
    else:
        bias = torch.randn(G, H, N, N, device=DEVICE, generator=gen)
        bias[..., : N // 2, N // 2:] = -1e9
    if bias.shape != (G, H, N, N):
        raise RuntimeError(f"window inputs: bias {tuple(bias.shape)} for {call['what']}")
    return qkv, dout, bias


def sdpa_window(torch, qkv, bias, call, scale, cyclic):
    """The library's yardstick on the same windows: q, k, v [P, H, N, D] and
    the bias as a float attn_mask [P, H, N, N] (gathered from the leaf
    ``bias`` per window, so the backward takes the bias's gradient); returns
    (forward fn, backward fn) of F.scaled_dot_product_attention."""
    import torch.nn.functional as F

    P, N, H = call["P"], call["N"], call["H"]
    q, k, v = (t.contiguous().requires_grad_() for t in
               qkv.view(P, N, 3, H, -1).permute(2, 0, 3, 1, 4).unbind(0))
    b = bias.clone().requires_grad_()
    p = torch.arange(P, device=DEVICE)
    gi = p % call["G"] if cyclic else p // (P // call["G"])
    mask = bias[gi].contiguous()
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=b[gi], scale=scale)
    do = torch.randn_like(out)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

    def bwd():
        return torch.autograd.grad(out, (q, k, v, b), do, retain_graph=True)

    return fwd, bwd


def window_kernels(torch):
    """3a: the tensor-core window attention (csrc/window_attention_tc.cuh:
    the attention of B1's bias calls, B2 and B9) alone, through its thin C
    entries, at each call of window_calls() in both group layouts (B2's
    group-major windows, B9's sample-major ones): the forward (out and lse)
    within atol = rtol = 1e-4 of the plain version, the backward (dqkv and
    the bias's gradient) within 1e-3·max(1, max|plain|) and bit-identical
    across two runs; at the timed calls (B2's layout) median ms of the
    kernel, the plain version and F.scaled_dot_product_attention with the
    bias as a float attn_mask, forward and backward, beside the bound at the
    tensor-core rate.  Returns the timed records of the forward and of the
    backward."""
    from vision_transformers_tpu_torch.ops import window_attention as wa

    worst = {"out": 0.0, "grads": 0.0}
    fwd_rec, bwd_rec = [], []
    for call in window_calls():
        P, N, H, D, G = (call[k] for k in ("P", "N", "H", "D", "G"))
        qkv, dout, bias = window_inputs(torch, call)
        scale = D ** -0.5
        for cyclic in (False, True):
            what = (f"{call['what']} P,N,H,D,G={P},{N},{H},{D},{G} "
                    f"{'sample-major' if cyclic else 'group-major'}")
            out, lse = wa.window_attention_fwd(qkv, bias, H, scale, cyclic)
            torch.cuda.synchronize()
            out_p, lse_p = wa.window_attention_fwd_reference(qkv, bias, H, scale, cyclic)
            err = check_close(torch, "window_attention", out, out_p, what + " out")
            check_close(torch, "window_attention", lse, lse_p, what + " lse")
            worst["out"] = max(worst["out"], err)
            grads = wa.window_attention_bwd(qkv, bias, out, lse, dout, H, scale, cyclic)
            again = wa.window_attention_bwd(qkv, bias, out, lse, dout, H, scale, cyclic)
            torch.cuda.synchronize()
            plain = wa.window_attention_bwd_reference(qkv, bias, dout, H, scale, cyclic)
            compare_grads(torch, what, ("dqkv", "dbias"), grads, again, plain, worst)
            del grads, again, plain
            if not call["timed"] or cyclic:
                continue
            k_f = median_ms(torch, lambda: wa.window_attention_fwd(qkv, bias, H, scale))
            k_b = median_ms(torch, lambda: wa.window_attention_bwd(qkv, bias, out, lse, dout,
                                                                   H, scale))
            p_f = median_ms(torch, lambda: wa.window_attention_fwd_reference(qkv, bias, H,
                                                                             scale))
            p_b = median_ms(torch, lambda: wa.window_attention_bwd_reference(qkv, bias, dout,
                                                                             H, scale))
            s_fwd, s_bwd = sdpa_window(torch, qkv, bias, call, scale, False)
            l_f, l_b = median_ms(torch, s_fwd), median_ms(torch, s_bwd)
            del s_fwd, s_bwd
            fb, fby = bound(*window_fwd_work(P, N, H, D, G))
            bb, bby = bound(*window_bwd_work(P, N, H, D, G))
            log(f"kernels: window_attention {what} (median of 20, CUDA events): kernel fwd "
                f"{k_f:.3f} + bwd {k_b:.3f} ms; plain fwd {p_f:.3f} + bwd {p_b:.3f} ms; "
                f"scaled_dot_product_attention fwd {l_f:.3f} + bwd {l_b:.3f} ms; bound "
                f"fwd {fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
            shape = f"{call['what']}, P,N,H,D,G={P},{N},{H},{D},{G}"
            fwd_rec.append({"shape": shape + ", lse", "max_abs_err": worst["out"], "ms": k_f,
                            "plain_ms": p_f, "bound_ms": fb, "bound_by": fby,
                            "library_ms": l_f})
            bwd_rec.append({"shape": shape + ", dbias", "max_abs_err": worst["grads"],
                            "ms": k_b, "plain_ms": p_b, "bound_ms": bb, "bound_by": bby,
                            "library_ms": l_b})
        del qkv, dout, bias, out, lse
    for rec in fwd_rec + bwd_rec:
        if rec["bound_ms"] > rec["ms"]:
            raise RuntimeError(f"window attention: {rec['shape']} ran faster than its bound")
    return fwd_rec, bwd_rec


# ---------------------------------------------------------------------------
# 3h / 3hb. the Halo kernels vs their plain versions
# ---------------------------------------------------------------------------


def halo_stages(images):
    """The Halo kernels' calls in Halo-S @256 at ``images`` images, one per
    stage: dicts of the map shape (B, H, W, C, heads, D, F), the window
    geometry and the depth, from tests/data/halo_s_port.conf."""
    from vision_transformers_tpu_torch.config.schema import load_config

    conf = load_config(MODELS["Halo-S"][0])
    arch, size = conf.arch, image_size(conf) // 4
    out = []
    for s in range(4):
        if s:
            size //= 2
        out.append(dict(stage=s + 1, window=arch.window_size, halo=arch.halo_size,
                        depth=arch.depths[s],
                        shape=(images, size, size, arch.dims[s], arch.n_heads[s],
                               arch.dim_head, arch.dim_ffs[s])))
    return out


# the odd small calls: a non-square map with 2·halo = window and heads 24 wide,
# and 3x3 windows (k² = 25 positions) with heads 20 wide
HALO_ODD = [dict(stage="odd", window=4, halo=2, depth=1, shape=(3, 12, 8, 48, 2, 24, 96)),
            dict(stage="odd", window=3, halo=1, depth=1, shape=(2, 6, 9, 40, 2, 20, 80))]
# heads 64 wide, the halo attention alone (the whole layer takes heads up to 32)
HALO_WIDE = dict(stage="odd (heads 64 wide)", window=8, halo=2, depth=1,
                 shape=(2, 16, 16, 128, 2, 64, 256))


def halo_bias(torch, call, seed):
    """[heads, w², k²]: the port's HaloAttention's gathered bias from a
    std-0.2 table."""
    from vision_transformers_tpu_torch.models.halo import HaloAttention

    C, nh, D = call["shape"][3:6]
    attn = HaloAttention(C, nh, D, call["window"], call["halo"])
    with torch.no_grad():
        attn.rel_pos.weight.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(seed))
        return attn.to(DEVICE).relative_bias().contiguous()


def halo_layer_inputs(torch, call, row_scales, seed=0):
    """Seeded inputs of one whole-Halo-layer call: ``layer_args`` without
    the qkv bias, x as the [B, H, W, C] map, the bias and, with
    ``row_scales``, two per-image DropPath scales (keep 0.9)."""
    B, H, W, C, nh, D, F = call["shape"]
    a = layer_args(torch, B, H * W, C, nh, D, F, seed=seed)
    args = [a[0].reshape(B, H, W, C), *a[1:4], *a[5:], halo_bias(torch, call, seed)]
    rs = [None, None]
    if row_scales:
        rng = np.random.default_rng(seed + 100)
        for i in range(2):
            keep = rng.random(B) < 0.9
            keep[0], keep[-1] = False, True  # both kinds at every shape
            rs[i] = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
    return args, rs


def halo_attn_inputs(torch, call, seed=0):
    """Seeded q [B, H, W, HD], kv [B, H, W, 2HD], bias, and an output grad
    (HD = heads·D)."""
    B, H, W, _, nh, D, _ = call["shape"]
    g = torch.Generator(DEVICE).manual_seed(seed)
    q, kv, do = (torch.randn(B, H, W, c, device=DEVICE, generator=g)
                 for c in (nh * D, 2 * nh * D, nh * D))
    return q, kv, halo_bias(torch, call, seed), do


def sdpa_problem(torch, q, kv, bias, call):
    """The same function as the gathered problem of F.scaled_dot_product_attention:
    q [b·S, H, w², D], k / v [b·S, H, k², D], attn_mask = the bias."""
    from vision_transformers_tpu_torch.ops.fused_halo import neighborhoods, windows

    nh, D = call["shape"][4:6]
    w, halo = call["window"], call["halo"]
    heads = lambda t: t.reshape(-1, t.shape[2], nh, D).transpose(1, 2).contiguous()  # noqa: E731
    nb = neighborhoods(kv, w, halo)
    return (heads(windows(q, w)), heads(nb[..., :nh * D]), heads(nb[..., nh * D:]),
            bias[None], 1.0 / D ** 0.5)


def direct_plain_fwd(torch, q, kv, bias, call):
    """The halo attention's plain training forward on the card: (out,
    DirectSaved of the plain version)."""
    from vision_transformers_tpu_torch.ops import fused_halo

    C, nh = q.shape[-1], call["shape"][4]
    w, halo, scale = call["window"], call["halo"], 1.0 / call["shape"][5] ** 0.5
    out, lse = fused_halo.attention_fwd_reference(q, kv[..., :C], kv[..., C:], bias, nh,
                                                  w, halo, scale)
    return out, fused_halo.DirectSaved(q, kv, bias, out, lse, w, halo, nh, scale)


def halo_what(call, extra=""):
    return (f"Halo stage {call['stage']} B,H,W,C,heads,D,F={call['shape']} window "
            f"{call['window']} halo {call['halo']}{extra}")


def halo_kernels(torch):
    """3h: the whole Halo layer's forward (serving call, no saves) with the
    bias and both row scales, and the halo attention's forward, each against
    its plain version at the odd shapes and the Halo-S stages at 128
    images; median ms at every stage (the eval's calls; the trainer's take
    the saves, timed in 3hb) beside the bound and, for the halo attention,
    scaled_dot_product_attention on the gathered problem.  Returns
    {kernel: [timed entries]}."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_halo
    from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl

    results = {"fused_halo_layer": [], "halo_attention_direct": []}
    for call in HALO_ODD + halo_stages(128):
        B, H, W, _, nh, D, _ = call["shape"]
        kw = dict(window=call["window"], halo=call["halo"])
        timed = call["stage"] != "odd"
        a, (r1, r2) = halo_layer_inputs(torch, call, row_scales=True)
        out = fhl.fused_halo_layer(*a, nh, r1, r2, **kw)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_halo_layer", out,
                          fhl.fused_halo_layer_reference(*a, nh, r1, r2, **kw),
                          halo_what(call, ", row scales"))
        if timed:
            a, _ = halo_layer_inputs(torch, call, row_scales=False)
            ms = median_ms(torch, lambda: fhl.fused_halo_layer(*a, nh, **kw))
            plain_ms = median_ms(torch, lambda: fhl.fused_halo_layer_reference(*a, nh, **kw))
            bound_ms, by = bound(*halo_layer_fwd_work(*call["shape"], **kw))
            log(f"kernels: fused_halo_layer Halo stage {call['stage']} eval call (128 "
                f"images, no saves): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; bound "
                f"{bound_ms:.3f} ms ({by})")
            results["fused_halo_layer"].append({
                "shape": f"Halo-S stage {call['stage']} eval, B,H,W,C,heads,D,F="
                         + ",".join(map(str, call["shape"])),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": None})
        del a
        q, kv, bias, _ = halo_attn_inputs(torch, call)
        out = fused_halo.halo_attention_direct(q, kv, bias, **kw, n_head=nh)
        torch.cuda.synchronize()
        ref = fused_halo.halo_attention_direct_reference(q, kv, bias, n_head=nh, **kw)
        err = check_close(torch, "halo_attention_direct", out, ref, halo_what(call))
        if timed:
            ms = median_ms(torch, lambda: fused_halo.halo_attention_direct(
                q, kv, bias, n_head=nh, **kw))
            plain_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_reference(
                q, kv, bias, n_head=nh, **kw))
            qg, kg, vg, mask, scale = sdpa_problem(torch, q, kv, bias, call)
            lib = F_.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
            lib_err = (lib.transpose(1, 2).reshape(-1, nh * D) - fused_halo.windows(
                out, call["window"]).reshape(-1, nh * D)).abs().max().item()
            library_ms = median_ms(torch, lambda: F_.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=mask, scale=scale))
            bound_ms, by = bound(*halo_attn_fwd_work(B, H, W, nh, D, **kw))
            log(f"kernels: halo_attention_direct Halo stage {call['stage']} (128 images): "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, scaled_dot_product_attention "
                f"on the gathered problem {library_ms:.3f} ms (max|Δ| to the kernel "
                f"{lib_err:.3e}); bound {bound_ms:.3f} ms ({by})")
            results["halo_attention_direct"].append({
                "shape": f"Halo-S stage {call['stage']}, B,H,W,C,heads,D="
                         + ",".join(map(str, call["shape"][:6])),
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": by, "library_ms": library_ms})
            del qg, kg, vg, mask, lib
        del q, kv, bias, out, ref
    return results


def halo_backward_kernels(torch):
    """3hb: each Halo kernel's forward (with saves) + backward against the
    plain forward + plain backward, twice for bit-identity, at the odd
    shapes and the four Halo-S stages at 128 images (the layer with and
    without both row scales); then median ms of each stage's training call
    (the layer with row scales).  Returns the timed entries: the layer's
    training forward and backward, the halo attention's forward (with
    saves) and backward."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_halo
    from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl

    worst = {"out": 0.0, "grads": 0.0}
    worst_d = {"out": 0.0, "grads": 0.0}
    stages = halo_stages(128)
    out_rec = {k: [] for k in ("fwd", "bwd", "dfwd", "dbwd")}
    for call in HALO_ODD + stages + [HALO_WIDE]:
        nh = call["shape"][4]
        kw = dict(window=call["window"], halo=call["halo"])
        for use_rs in (False, True) if call is not HALO_WIDE else ():
            a, (r1, r2) = halo_layer_inputs(torch, call, use_rs, seed=1)
            do = torch.randn(a[0].shape, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(2))
            out, saved = fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw)
            grads = fhl.fused_halo_layer_bwd(saved, do)
            again = fhl.fused_halo_layer_bwd(saved, do)
            torch.cuda.synchronize()
            out_p, saved_p = fhl.fused_halo_layer_fwd_reference(*a, nh, r1, r2, **kw)
            plain = fhl.fused_halo_layer_bwd_reference(saved_p, do)
            compare_grads(torch, halo_what(call, f" rs={use_rs}"), ("out",) + fhl.GRAD_NAMES,
                          (out,) + grads, (out,) + again, (out_p,) + plain, worst)
            del saved, saved_p, grads, again, plain
        q, kv, bias, do = halo_attn_inputs(torch, call, seed=3)
        out, saved = fused_halo.halo_attention_direct_fwd(q, kv, bias, n_head=nh, **kw)
        grads = fused_halo.halo_attention_direct_bwd(saved, do)
        again = fused_halo.halo_attention_direct_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, saved_p = direct_plain_fwd(torch, q, kv, bias, call)
        plain = fused_halo.halo_attention_direct_bwd_reference(saved_p, do)
        compare_grads(torch, "direct " + halo_what(call), ("out", "dq", "dkv", "dbias"),
                      (out,) + grads, (out,) + again, (out_p,) + plain, worst_d)
        del saved, saved_p, grads, again, plain

    for call in stages:
        B, H, W, _, nh, D, _ = call["shape"]
        kw = dict(window=call["window"], halo=call["halo"])
        a, (r1, r2) = halo_layer_inputs(torch, call, True, seed=1)
        do = torch.randn(a[0].shape, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(2))
        _, saved = fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw)
        _, saved_p = fhl.fused_halo_layer_fwd_reference(*a, nh, r1, r2, **kw)
        f_ms = median_ms(torch, lambda: fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw))
        b_ms = median_ms(torch, lambda: fhl.fused_halo_layer_bwd(saved, do))
        pf_ms = median_ms(torch, lambda: fhl.fused_halo_layer_fwd_reference(
            *a, nh, r1, r2, **kw))
        pb_ms = median_ms(torch, lambda: fhl.fused_halo_layer_bwd_reference(saved_p, do))
        fb, fby = bound(*halo_layer_fwd_work(*call["shape"], **kw, row_scales=True,
                                             saves=True))
        bb, bby = bound(*halo_layer_bwd_work(*call["shape"], **kw, row_scales=True))
        log(f"backward: fused_halo_layer Halo stage {call['stage']} train call (128 "
            f"images, B,H,W,C,heads,D,F={call['shape']}, bias, row scales; median of 20, "
            f"CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd "
            f"{pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) + bwd {bb:.3f} "
            f"ms ({bby})")
        shape = (f"Halo-S stage {call['stage']} train, B,H,W,C,heads,D,F="
                 + ",".join(map(str, call["shape"])) + ", row scales")
        out_rec["fwd"].append({"shape": shape + ", saves", "max_abs_err": worst["out"],
                               "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb,
                               "bound_by": fby, "library_ms": None})
        out_rec["bwd"].append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                               "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
                               "library_ms": None})
        del saved, saved_p, a

        q, kv, bias, do = halo_attn_inputs(torch, call, seed=3)
        _, saved = fused_halo.halo_attention_direct_fwd(q, kv, bias, n_head=nh, **kw)
        f_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_fwd(
            q, kv, bias, n_head=nh, **kw))
        b_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_bwd(saved, do))
        _, saved_p = direct_plain_fwd(torch, q, kv, bias, call)
        pf_ms = median_ms(torch, lambda: direct_plain_fwd(torch, q, kv, bias, call))
        pb_ms = median_ms(torch, lambda: fused_halo.halo_attention_direct_bwd_reference(
            saved_p, do))
        qg, kg, vg, mask, scale = sdpa_problem(torch, q, kv, bias, call)
        mask = mask.clone()
        leaves = [t.requires_grad_() for t in (qg, kg, vg, mask)]
        lib = F_.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, scale=scale)
        dlib = torch.randn_like(lib)
        lib_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaves, dlib,
                                                              retain_graph=True))
        fb, fby = bound(*halo_attn_fwd_work(B, H, W, nh, D, **kw, saves=True))
        bb, bby = bound(*halo_attn_bwd_work(B, H, W, nh, D, **kw))
        log(f"backward: halo_attention_direct Halo stage {call['stage']} (128 images): "
            f"kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + "
            f"bwd {pb_ms:.3f} ms; scaled_dot_product_attention's backward on the "
            f"gathered problem {lib_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) + bwd "
            f"{bb:.3f} ms ({bby})")
        shape = (f"Halo-S stage {call['stage']}, B,H,W,C,heads,D="
                 + ",".join(map(str, call["shape"][:6])))
        out_rec["dfwd"].append({"shape": shape + ", saves", "max_abs_err": worst_d["out"],
                                "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb,
                                "bound_by": fby, "library_ms": None})
        out_rec["dbwd"].append({"shape": shape, "max_abs_err": worst_d["grads"],
                                "ms": b_ms, "plain_ms": pb_ms, "bound_ms": bb,
                                "bound_by": bby, "library_ms": lib_ms})
        del saved, saved_p, q, kv, bias, do, qg, kg, vg, mask, lib, leaves
    return out_rec["fwd"], out_rec["bwd"], out_rec["dfwd"], out_rec["dbwd"]


# ---------------------------------------------------------------------------
# 3hbf. the halo kernels' bf16 forms (B4, B5a, B5b) vs their plain versions
# ---------------------------------------------------------------------------

# the whole Halo layer's inputs that stay f32 in its bf16 form: the
# LayerNorms' parameters and the relative-position bias
HALO_F32_ARGS = (1, 2, 6, 7, 12)


def halo_bf16_check(torch, what, names, outs, again, plain, tol, worst):
    """Each kernel output finite, bit-identical across two runs, within tol
    of its plain version (:func:`bf16_close`); the worst error into
    ``worst``."""
    for name, k, k2, p in zip(names, outs, again, plain):
        if p is None:
            if k is not None:
                raise RuntimeError(f"bf16: {what} {name} should be None")
            continue
        if not torch.equal(k, k2):
            raise RuntimeError(f"bf16: {what} {name} differs between two runs")
        worst[0] = max(worst[0], bf16_close(
            torch, f"{what} {name} ({k.dtype}, bit-identical across two runs)", k, p, tol))


def halo_sdpa_times(torch, q, k, v, mask, scale, do):
    """scaled_dot_product_attention on the same gathered problem, bf16 with
    the bias as a float attn_mask: (forward ms, backward ms with the
    mask's gradient), on the device (CUDA graphs of 10 calls)."""
    import torch.nn.functional as F_

    leaves = [t.detach().requires_grad_() for t in (q, k, v, mask)]
    with torch.no_grad():
        fwd = device_ms(torch, lambda: F_.scaled_dot_product_attention(
            *leaves[:3], attn_mask=leaves[3], scale=scale))
    timing = _WARMUP_STREAM[0]  # the graph's inputs made on the timing stream
    timing.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(timing):
        o = F_.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=scale)
    torch.cuda.current_stream().wait_stream(timing)
    bwd = device_ms(torch, lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
    del o, leaves
    return fwd, bwd


def halo_bf16_kernels(torch):
    """3hbf: the bf16 forms of the whole Halo layer B4 (training forward with
    the saves and both row scales, serving forward, backward) at the four
    Halo-S stages at 128 images, and of the halo attention B5a (off the
    maps) and B5b (gathered: Halo-S stage 1 and stage 1 at window 4 / halo
    3), forward with lse and backward, against their plain versions at
    bf16 within BF16_FWD_TOL / BF16_BWD_TOL, every backward twice and
    bit-identical; median ms (CUDA events) of each beside the plain
    version, the bound at the bf16 rate and, for B5a / B5b,
    scaled_dot_product_attention on the same gathered problem at bf16 (the
    bias a float attn_mask; forward, and backward with the mask's
    gradient, on the device).  Returns {kernel name: [records]}, the
    trainer's call first."""
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import fused_halo as fh
    from vision_transformers_tpu_torch.ops import fused_halo_layer as fhl

    built = halo_bf16_builds(_build.BUILD_LOG)
    log("bf16: the halo core's bf16 kernels: " + "; ".join(
        f"{k['kernel']} {k.get('registers')} registers, {k.get('spill_bytes')} spill bytes"
        for k in built))
    bf = torch.bfloat16
    recs = {k: [] for k in ("fused_halo_layer[bf16]", "fused_halo_layer_bwd[bf16]",
                            "halo_attention_direct[bf16]", "halo_attention_direct_bwd[bf16]",
                            "halo_attention[bf16]", "halo_attention_bwd[bf16]")}
    stages = halo_stages(128)
    for call in stages:
        B, H, W, C, nh, D, F = call["shape"]
        kw = dict(window=call["window"], halo=call["halo"])
        a32, (r1, r2) = halo_layer_inputs(torch, call, True, seed=call["stage"])
        a = [t if i in HALO_F32_ARGS else t.to(bf) for i, t in enumerate(a32)]
        del a32
        what = halo_what(call, ", bf16, row scales")
        do = torch.randn(B, H, W, C, device=DEVICE,
                         generator=torch.Generator(DEVICE).manual_seed(5)).to(bf)
        out, saved = fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw)
        grads = fhl.fused_halo_layer_bwd(saved, do)
        again = fhl.fused_halo_layer_bwd(saved, do)
        with torch.no_grad():
            serve = fhl.fused_halo_layer(*a, nh, r1, r2, **kw)
        torch.cuda.synchronize()
        out_p, saved_p = fhl.fused_halo_layer_fwd_reference(*a, nh, r1, r2, **kw)
        plain = fhl.fused_halo_layer_bwd_reference(saved_p, do)
        err_f = [0.0]
        halo_bf16_check(torch, what, ("out", "out (serving)", "qkv", "acc", "z", "hid"),
                        (out, serve, saved.qkv, saved.acc, saved.z, saved.hid),
                        (out, serve, saved.qkv, saved.acc, saved.z, saved.hid),
                        (out_p, out_p, saved_p.qkv, saved_p.acc, saved_p.z, saved_p.hid),
                        BF16_FWD_TOL, err_f)
        err_b = [0.0]
        halo_bf16_check(torch, what, fhl.GRAD_NAMES, grads, again, plain, BF16_BWD_TOL, err_b)
        del grads, again, plain, serve
        f_ms = median_ms(torch, lambda: fhl.fused_halo_layer_fwd(*a, nh, r1, r2, **kw))
        b_ms = median_ms(torch, lambda: fhl.fused_halo_layer_bwd(saved, do))
        pf_ms = median_ms(torch, lambda: fhl.fused_halo_layer_fwd_reference(
            *a, nh, r1, r2, **kw), reps=5, warmup=1)
        pb_ms = median_ms(torch, lambda: fhl.fused_halo_layer_bwd_reference(saved_p, do),
                          reps=5, warmup=1)
        fb, fby = bound(*halo_layer_fwd_work(*call["shape"], **kw, row_scales=True,
                                             saves=True, a=2), H100_BF16_FLOPS)
        bb, bby = bound(*halo_layer_bwd_work(*call["shape"], **kw, row_scales=True, a=2),
                        H100_BF16_FLOPS)
        log(f"bf16: fused_halo_layer Halo-S stage {call['stage']} train call (128 images, "
            f"B,H,W,C,heads,D,F={call['shape']}, bias, row scales; median of 20, CUDA "
            f"events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd "
            f"{pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound (bf16 989 TFLOP/s) fwd {fb:.3f} "
            f"({fby}) + bwd {bb:.3f} ms ({bby})")
        shape = (f"Halo-S stage {call['stage']} train, B,H,W,C,heads,D,F="
                 + ",".join(map(str, call["shape"])) + ", row scales")
        recs["fused_halo_layer[bf16]"].append({
            "shape": shape + ", saves", "max_abs_err": err_f[0], "ms": f_ms,
            "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": None})
        recs["fused_halo_layer_bwd[bf16]"].append({
            "shape": shape, "max_abs_err": err_b[0], "ms": b_ms, "plain_ms": pb_ms,
            "bound_ms": bb, "bound_by": bby, "library_ms": None})
        del a, saved, saved_p, out, out_p, do

    # the halo attention alone: B5a at stage 1, B5b at stage 1 and at window
    # 4 / halo 3
    call = stages[0]
    B, H, W, C, nh, D, F = call["shape"]
    kw = dict(window=call["window"], halo=call["halo"])
    q, kv, bias, do = (t if i == 2 else t.to(bf)
                       for i, t in enumerate(halo_attn_inputs(torch, call, seed=3)))
    what = halo_what(call, ", bf16, the attention off the maps")
    out, saved = fh.halo_attention_direct_fwd(q, kv, bias, n_head=nh, **kw)
    grads = fh.halo_attention_direct_bwd(saved, do)
    again = fh.halo_attention_direct_bwd(saved, do)
    torch.cuda.synchronize()
    out_p, saved_p = direct_plain_fwd(torch, q, kv, bias, call)
    plain = fh.halo_attention_direct_bwd_reference(saved_p, do)
    err_f, err_b = [0.0], [0.0]
    halo_bf16_check(torch, what, ("out", "lse"), (out, saved.lse), (out, saved.lse),
                    (out_p, saved_p.lse), BF16_FWD_TOL, err_f)
    halo_bf16_check(torch, what, ("dq", "dkv", "dbias"), grads, again, plain, BF16_BWD_TOL,
                    err_b)
    f_ms = median_ms(torch, lambda: fh.halo_attention_direct_fwd(q, kv, bias, n_head=nh,
                                                                 **kw))
    b_ms = median_ms(torch, lambda: fh.halo_attention_direct_bwd(saved, do))
    pf_ms = median_ms(torch, lambda: direct_plain_fwd(torch, q, kv, bias, call), reps=5,
                      warmup=1)
    pb_ms = median_ms(torch, lambda: fh.halo_attention_direct_bwd_reference(saved_p, do),
                      reps=5, warmup=1)
    qg, kg, vg, mask, scale = sdpa_problem(torch, q, kv, bias, call)
    dog = fh.windows(do, call["window"]).reshape(qg.shape[0], -1, nh, D).transpose(1, 2)
    lf_ms, lb_ms = halo_sdpa_times(torch, qg, kg, vg, mask.to(bf), scale, dog)
    release_timing_stream(torch)
    fb, fby = bound(*halo_attn_fwd_work(B, H, W, nh, D, **kw, saves=True, a=2),
                    H100_BF16_FLOPS)
    bb, bby = bound(*halo_attn_bwd_work(B, H, W, nh, D, **kw, a=2), H100_BF16_FLOPS)
    log(f"bf16: halo_attention_direct Halo-S stage 1 (128 images): kernel fwd(lse) "
        f"{f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; "
        f"scaled_dot_product_attention (bf16, float mask) on the gathered problem fwd "
        f"{lf_ms:.4f} + bwd {lb_ms:.4f} ms on the device; bound fwd {fb:.3f} ({fby}) + "
        f"bwd {bb:.3f} ms ({bby})")
    shape = "Halo-S stage 1, B,H,W,C,heads,D=" + ",".join(map(str, call["shape"][:6]))
    recs["halo_attention_direct[bf16]"].append({
        "shape": shape + ", lse", "max_abs_err": err_f[0], "ms": f_ms, "plain_ms": pf_ms,
        "bound_ms": fb, "bound_by": fby, "library_ms": lf_ms})
    recs["halo_attention_direct_bwd[bf16]"].append({
        "shape": shape, "max_abs_err": err_b[0], "ms": b_ms, "plain_ms": pb_ms,
        "bound_ms": bb, "bound_by": bby, "library_ms": lb_ms})
    del q, kv, bias, do, out, saved, grads, again, out_p, saved_p, plain, qg, kg, vg, mask, dog

    for call in (stages[0], dict(stages[0], stage="1 (window 4, halo 3)", window=4, halo=3)):
        q, kv, bias, do = (t if i == 2 else t.to(bf)
                           for i, t in enumerate(gathered_problem(torch, call)))
        Bw, M, HD = q.shape
        N = kv.shape[1]
        what = halo_what(call, f", bf16, gathered: B'={Bw} M={M} N={N}")
        out, saved = fh.halo_attention_fwd(q, kv, bias, nh)
        grads = fh.halo_attention_bwd(saved, do)
        again = fh.halo_attention_bwd(saved, do)
        with torch.no_grad():
            serve = fh.halo_attention(q, kv, bias, nh)
        torch.cuda.synchronize()
        scale = saved.scale
        out_p, lse_p = fh.gathered_fwd_reference(q, kv, bias, nh, scale)
        plain = fh.gathered_bwd_reference(q, kv, bias, lse_p, do, nh, scale)
        err_f, err_b = [0.0], [0.0]
        halo_bf16_check(torch, what, ("out", "out (serving)", "lse"),
                        (out, serve, saved.lse), (out, serve, saved.lse),
                        (out_p, out_p, lse_p), BF16_FWD_TOL, err_f)
        halo_bf16_check(torch, what, ("dq", "dkv", "dbias"), grads, again, plain,
                        BF16_BWD_TOL, err_b)
        del grads, again, plain, serve
        f_ms = median_ms(torch, lambda: fh.halo_attention_fwd(q, kv, bias, nh))
        b_ms = median_ms(torch, lambda: fh.halo_attention_bwd(saved, do))
        pf_ms = median_ms(torch, lambda: fh.gathered_fwd_reference(q, kv, bias, nh, scale),
                          reps=5, warmup=1)
        pb_ms = median_ms(torch, lambda: fh.gathered_bwd_reference(q, kv, bias, lse_p, do,
                                                                   nh, scale),
                          reps=5, warmup=1)
        heads = lambda t: t.unflatten(-1, (nh, D)).transpose(1, 2).contiguous()  # noqa: E731
        lf_ms, lb_ms = halo_sdpa_times(torch, heads(q), heads(kv[..., :HD]),
                                       heads(kv[..., HD:]), bias[None].to(bf), scale,
                                       heads(do))
        release_timing_stream(torch)
        fb, fby = bound(*gather_fwd_work(Bw, M, N, nh, D, saves=True, a=2), H100_BF16_FLOPS)
        bb, bby = bound(*gather_bwd_work(Bw, M, N, nh, D, a=2), H100_BF16_FLOPS)
        log(f"bf16: halo_attention {what}: kernel fwd(lse) {f_ms:.3f} + bwd {b_ms:.3f} ms; "
            f"plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; scaled_dot_product_attention "
            f"(bf16, float mask) fwd {lf_ms:.4f} + bwd {lb_ms:.4f} ms on the device; bound "
            f"fwd {fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
        shape = f"Halo-S stage {call['stage']}, B',M,N,heads,D={Bw},{M},{N},{nh},{D}"
        recs["halo_attention[bf16]"].append({
            "shape": shape + ", lse", "max_abs_err": err_f[0], "ms": f_ms,
            "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": lf_ms})
        recs["halo_attention_bwd[bf16]"].append({
            "shape": shape, "max_abs_err": err_b[0], "ms": b_ms, "plain_ms": pb_ms,
            "bound_ms": bb, "bound_by": bby, "library_ms": lb_ms})
        del q, kv, bias, do, out, saved, out_p, lse_p
    if len(built) < 6 or any(k.get("spill_bytes", 1) for k in built):
        raise RuntimeError(f"bf16: the halo core's bf16 kernels are missing or spill: {built}")
    return recs


# ---------------------------------------------------------------------------
# 3g. the gathered halo attention (B5b) vs its plain version
# ---------------------------------------------------------------------------


def gather_calls():
    """The gathered halo attention's calls, as dicts of the map shape
    (images, H, W, C, heads, D, F) and the window geometry: an odd small
    call (a non-square 12x8 map, window 4, halo 3, heads 24 wide), one with
    more keys than a block keeps resident (window 8, halo 5: 324 keys), one
    with heads 64 wide, the four Halo-S stages on the gather path at 128
    images (the trainer's batch and its eval's) and stage 1 of the window-4
    / halo-3 model at 128 images (2·halo > window: the default dispatch's
    gather path)."""
    stages = halo_stages(128)
    return ([dict(stage="odd", window=4, halo=3, depth=1, shape=(3, 12, 8, 48, 2, 24, 96)),
             dict(stage="odd (324 keys)", window=8, halo=5, depth=1,
                  shape=(2, 16, 16, 48, 2, 24, 96)),
             dict(HALO_WIDE, stage="odd (heads 64 wide)")]
            + stages + [dict(stages[0], stage="1 (window 4, halo 3)", window=4, halo=3)])


def gathered_problem(torch, call, seed=0):
    """q [B', w², HD] and kv [B', k², 2HD] gathered from seeded maps as the
    model gathers them (zero rows outside the map), the bias [heads, w², k²]
    and an output grad."""
    from vision_transformers_tpu_torch.ops.fused_halo import neighborhoods, windows

    nh, D = call["shape"][4:6]
    w, halo = call["window"], call["halo"]
    q, kv, bias, _ = halo_attn_inputs(torch, call, seed)
    qw = windows(q, w).reshape(-1, w * w, nh * D).contiguous()
    nb = neighborhoods(kv, w, halo).reshape(qw.shape[0], -1, 2 * nh * D).contiguous()
    do = torch.randn(qw.shape, device=DEVICE,
                     generator=torch.Generator(DEVICE).manual_seed(seed + 1))
    return qw, nb, bias, do


def gather_kernels(torch):
    """3g: the gathered halo attention's serving forward (no saves),
    training forward (with lse) and backward against the plain versions,
    the backward twice for bit-identity, at ``gather_calls()``; median ms of
    each timed call's training forward and backward beside the bound, the
    plain versions and F.scaled_dot_product_attention on the same gathered
    problem (the bias as attn_mask; forward, and its autograd backward with
    the mask's gradient).  Returns the timed entries of the forward and the
    backward, Halo-S stage 1 first."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_halo as fh

    worst = {"out": 0.0, "grads": 0.0}
    fwd_rec, bwd_rec = [], []
    for call in gather_calls():
        q, kv, bias, do = gathered_problem(torch, call)
        Bw, M, HD = q.shape
        N = kv.shape[1]
        nh, D = call["shape"][4:6]
        what = halo_what(call, f", B'={Bw} M={M} N={N}")
        with torch.no_grad():
            out = fh.halo_attention(q, kv, bias, nh)
        torch.cuda.synchronize()
        err = check_close(torch, "halo_attention", out,
                          fh.halo_attention_reference(q, kv, bias, nh), what + " (serving)")
        out, saved = fh.halo_attention_fwd(q, kv, bias, nh)
        grads = fh.halo_attention_bwd(saved, do)
        again = fh.halo_attention_bwd(saved, do)
        torch.cuda.synchronize()
        scale = saved.scale
        out_p, lse_p = fh.gathered_fwd_reference(q, kv, bias, nh, scale)
        err = max(err, check_close(torch, "halo_attention", out, out_p, what + " (training)"))
        check_close(torch, "halo_attention", saved.lse, lse_p, what + " lse")
        worst["out"] = max(worst["out"], err)
        plain = fh.gathered_bwd_reference(q, kv, bias, lse_p, do, nh, scale)
        compare_grads(torch, "halo_attention " + what, ("dq", "dkv", "dbias"), grads, again,
                      plain, worst)
        del grads, again, plain
        if not str(call["stage"]).startswith("odd"):
            f_ms = median_ms(torch, lambda: fh.halo_attention_fwd(q, kv, bias, nh))
            b_ms = median_ms(torch, lambda: fh.halo_attention_bwd(saved, do))
            pf_ms = median_ms(torch, lambda: fh.gathered_fwd_reference(q, kv, bias, nh, scale))
            pb_ms = median_ms(torch, lambda: fh.gathered_bwd_reference(
                q, kv, bias, lse_p, do, nh, scale))
            heads = lambda t: t.unflatten(-1, (nh, D)).transpose(1, 2).contiguous()  # noqa: E731
            leaves = [t.requires_grad_() for t in (heads(q), heads(kv[..., :HD]),
                                                   heads(kv[..., HD:]), bias[None].clone())]
            lib = F_.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                                  scale=scale)
            lib_err = (lib.detach().transpose(1, 2).reshape(Bw, M, HD) - out).abs().max().item()
            with torch.no_grad():
                lf_ms = median_ms(torch, lambda: F_.scaled_dot_product_attention(
                    *leaves[:3], attn_mask=leaves[3], scale=scale))
            dlib = heads(do)
            lb_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaves, dlib,
                                                                 retain_graph=True))
            fb, fby = bound(*gather_fwd_work(Bw, M, N, nh, D, saves=True))
            bb, bby = bound(*gather_bwd_work(Bw, M, N, nh, D))
            log(f"kernels: halo_attention {what} (median of 20, CUDA events): kernel "
                f"fwd(lse) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + bwd "
                f"{pb_ms:.3f} ms; scaled_dot_product_attention fwd {lf_ms:.3f} + its "
                f"backward {lb_ms:.3f} ms (max|Δ| to the kernel {lib_err:.3e}); bound fwd "
                f"{fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
            shape = (f"Halo-S stage {call['stage']}, B',M,N,heads,D={Bw},{M},{N},{nh},{D}")
            fwd_rec.append({"shape": shape + ", lse", "max_abs_err": worst["out"], "ms": f_ms,
                            "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby,
                            "library_ms": lf_ms})
            bwd_rec.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                            "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
                            "library_ms": lb_ms})
            del leaves, lib, dlib
        del q, kv, bias, do, out, saved, out_p, lse_p
    return fwd_rec, bwd_rec


# ---------------------------------------------------------------------------
# 3k. the attention block (B8) vs its plain version
# ---------------------------------------------------------------------------


def block_calls():
    """(label, B, N, C, H, D, Cout, the bias or a recipe for it) of 3k's
    calls: an odd call with an [N, N] bias and Cout ≠ C, heads 64 wide with
    a grouped bias (odd) and an [H, N, N] bias (ViT-S/16's widths at 16
    rows), ViT-S/16 under 'block' at 128 rows (the trainer's) and 64 (no
    bias), and Swin-S's four stages at 64 images with the grouped bias of a
    shifted layer."""
    calls = [("odd, [N, N] bias, Cout 40", 6, 37, 48, 2, 24, 40, (37, 37)),
             ("odd, grouped bias (G 2) at D 64, Cout 40", 6, 37, 128, 2, 64, 40,
              (2, 2, 37, 37)),
             ("[H, N, N] bias at D 64, ViT-S/16 widths", 16, 197, 384, 6, 64, 384,
              (6, 197, 197)),
             ("ViT-S/16 B=128", 128, 197, 384, 6, 64, 384, None),
             ("ViT-S/16 B=64", 64, 197, 384, 6, 64, 384, None)]
    for call in swin_stages(64):
        rows, m, C, heads, D, _ = call["shape"]
        calls.append((f"Swin-S stage {call['stage']}, G={call['groups']}", rows, m, C,
                      heads, D, C, call))
    return calls


def block_inputs(torch, B, N, C, H, D, Cout, seed=0):
    """Seeded x, wqkv and wout as transposed views of [out, in] matrices
    (as the models pass ``linear.weight.t()``), bqkv, bout and an output
    grad."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32)).to(DEVICE)

    HD = H * D
    return [n(B, N, C), n(3 * HD, C, s=0.05).t(), n(3 * HD, s=0.1), n(Cout, HD, s=0.05).t(),
            n(Cout, s=0.1)], n(B, N, Cout)


def block_kernels(torch):
    """3k: the attention block's serving forward (no saves), training
    forward (with qkv, acc and lse) and backward against the plain
    versions, the backward twice for bit-identity, at ``block_calls()``;
    median ms of the ViT-S/16 and Swin-S calls beside the bound, the plain
    versions and F.multi_head_attention_forward with the same weights
    (need_weights=False, the bias as a float attn_mask; forward, and its
    autograd backward to x and the four weights).  Returns the timed entries
    of the forward and the backward, ViT-S/16 B=128 first."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_block as fb

    worst = {"out": 0.0, "grads": 0.0}
    fwd_rec, bwd_rec = [], []
    for label, B, N, C, H, D, Cout, bias in block_calls():
        (x, wqkv, bqkv, wout, bout), do = block_inputs(torch, B, N, C, H, D, Cout)
        if isinstance(bias, dict):  # a Swin stage: its grouped bias
            extra = swin_layer_inputs(torch, bias, row_scales=False)[1]
        else:
            extra = None if bias is None else 0.5 * torch.randn(
                *bias, device=DEVICE, generator=torch.Generator(DEVICE).manual_seed(3))
        w = (x, wqkv, bqkv, wout, bout)
        what = f"{label}, B,N,C,H,D,Cout={B},{N},{C},{H},{D},{Cout}"
        with torch.no_grad():
            out = fb.fused_attention_block(*w, H, extra)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_attention_block", out,
                          fb.fused_attention_block_reference(*w, H, extra), what + " (serving)")
        out, saved = fb.fused_attention_block_fwd(*w, H, extra)
        grads = fb.fused_attention_block_bwd(saved, do)
        again = fb.fused_attention_block_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, *res_p = fb.block_fwd_reference(*w, H, saved.extra_g, saved.scale)
        err = max(err, check_close(torch, "fused_attention_block", out, out_p,
                                   what + " (training)"))
        check_close(torch, "fused_attention_block", saved.lse, res_p[2], what + " lse")
        worst["out"] = max(worst["out"], err)
        saved_p = fb.BlockSaved(*w, saved.extra_g, *res_p, H, saved.scale)
        plain = fb.block_bwd_reference(saved_p, do)
        compare_grads(torch, "fused_attention_block " + what, fb.GRAD_NAMES, grads, again,
                      plain, worst)
        del grads, again, plain
        if label.startswith(("ViT", "Swin")):
            groups = 0 if extra is None else saved.extra_g.shape[0]
            f_ms = median_ms(torch, lambda: fb.fused_attention_block_fwd(*w, H, extra))
            b_ms = median_ms(torch, lambda: fb.fused_attention_block_bwd(saved, do))
            pf_ms = median_ms(torch, lambda: fb.block_fwd_reference(
                *w, H, saved.extra_g, saved.scale))
            pb_ms = median_ms(torch, lambda: fb.block_bwd_reference(saved_p, do))
            mask = None if extra is None else saved.extra_g.repeat_interleave(
                B // groups, 0).reshape(B * H, N, N)
            leaves = [t.detach().clone().requires_grad_()
                      for t in (x, wqkv.t(), bqkv, wout.t(), bout)]

            def mha(xl, wi, bi, wo, bo):
                xt = xl.transpose(0, 1)
                return F_.multi_head_attention_forward(
                    xt, xt, xt, C, H, wi, bi, None, None, False, 0.0, wo, bo,
                    training=True, need_weights=False, attn_mask=mask)[0]

            lib = mha(*leaves)
            lib_err = (lib.detach().transpose(0, 1) - out).abs().max().item()
            with torch.no_grad():
                lf_ms = median_ms(torch, lambda: mha(*leaves))
            dlib = do.transpose(0, 1)
            lb_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaves, dlib,
                                                                 retain_graph=True))
            fb_ms, fby = bound(*block_fwd_work(B, N, C, H, D, Cout, groups, saves=True))
            bb_ms, bby = bound(*block_bwd_work(B, N, C, H, D, Cout, groups))
            log(f"kernels: fused_attention_block {what} (median of 20, CUDA events): "
                f"kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + "
                f"bwd {pb_ms:.3f} ms; multi_head_attention_forward fwd {lf_ms:.3f} + its "
                f"backward {lb_ms:.3f} ms (max|Δ| to the kernel {lib_err:.3e}); bound fwd "
                f"{fb_ms:.3f} ({fby}) + bwd {bb_ms:.3f} ms ({bby})")
            fwd_rec.append({"shape": what + ", saves", "max_abs_err": worst["out"],
                            "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb_ms,
                            "bound_by": fby, "library_ms": lf_ms})
            bwd_rec.append({"shape": what, "max_abs_err": worst["grads"], "ms": b_ms,
                            "plain_ms": pb_ms, "bound_ms": bb_ms, "bound_by": bby,
                            "library_ms": lb_ms})
            del leaves, lib, dlib, mask
        del x, wqkv, bqkv, wout, bout, w, do, extra, out, saved, saved_p, out_p, res_p
    return fwd_rec, bwd_rec


# ---------------------------------------------------------------------------
# 3s. the reduced-kv attention (PVT SRA, Twins GSA) vs its plain version
# ---------------------------------------------------------------------------


def pvt_stages(images):
    """The reduced-kv attention's calls in PVT-S @224 at ``images`` images,
    one per stage: dicts of the problem (B, G, M, N, D) — M the stage's
    tokens (the cls token in stage 4), N the conv-reduced ones — and the
    depth, from tests/data/pvt_s_port.conf."""
    from vision_transformers_tpu_torch.config.schema import load_config

    arch = load_config(MODELS["PVT-S"][0]).arch
    size, out = arch.image_size, []
    for s, patch in enumerate((4, 2, 2, 2)):
        size //= patch
        r, last = arch.reductions[s], s == 3
        M = size * size + (1 if last else 0)
        N = (size // r) ** 2 if r > 1 else M
        G = arch.n_heads[s]
        out.append(dict(model="PVT-S", stage=s + 1, depth=arch.depths[s],
                        shape=(images, G, M, N, arch.patch_embed_dims[s] // G)))
    return out


def twins_stages(images):
    """Twins-SVT-S @224 at ``images`` images, one dict per stage: ``gsa``
    the global attention's reduced-kv problem (B, G, M, N, D); ``lsa`` the
    attention layer's call (rows = groups·images, N = m tokens of a packed
    window pair or a window, C, H, D, F) and ``pack``; from
    tests/data/twins_svt_s_port.conf."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.models.twins import LocalAttention

    conf = load_config(MODELS["Twins-SVT-S"][0])
    arch, size, win, out = conf.arch, conf.training.train_size, conf.arch.window_size, []
    for s, patch in enumerate((4, 2, 2, 2)):
        size //= patch
        C, H, D = arch.dims[s], arch.n_heads[s], arch.dim_head
        pack = LocalAttention(C, H, D, win).pack(size // win)
        groups = (size // win) ** 2 // pack
        out.append(dict(model="Twins-SVT-S", stage=s + 1, depth=arch.depths[s], pack=pack,
                        images=images, gsa=(images, H, size * size, (size // win) ** 2, C // H),
                        lsa=(groups * images, pack * win * win, C, H, D, 4 * C)))
    return out


# the odd small reduced-kv problems: M ≠ N, one key (Twins' last stage), four,
# nine, head widths 64, 32 and 24; then the bias in each form ([M, N],
# [1, M, N], [G, M, N]) at odd shapes, one of them past one key tile
SRA_ODD = [dict(model="odd", stage="odd", depth=1, shape=(3, 2, 37, 1, 64)),
           dict(model="odd", stage="odd", depth=1, shape=(2, 3, 70, 4, 32)),
           dict(model="odd", stage="odd", depth=1, shape=(2, 1, 45, 9, 24)),
           dict(model="odd", stage="odd", depth=1, shape=(3, 2, 77, 49, 64), extra="mn"),
           dict(model="odd", stage="odd", depth=1, shape=(2, 3, 70, 9, 32), extra="1mn"),
           dict(model="odd", stage="odd", depth=1, shape=(2, 5, 130, 50, 64), extra="gmn"),
           dict(model="odd", stage="odd", depth=1, shape=(2, 2, 45, 97, 24), extra="gmn")]


def sra_inputs(torch, B, G, M, N, D, extra=None, seed=0):
    """q, k, v and an output grad as the models pass them: [B, G, rows, D]
    head views of a q projection [B, M, G·D], of the two halves of a kv
    projection [B, N, 2·G·D] and of the output projection's input grad;
    with ``extra`` ("mn", "1mn", "gmn") a std-0.5 bias of that form."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    q, kv, do = (torch.randn(B, rows, c * G * D, device=DEVICE, generator=g)
                 for rows, c in ((M, 1), (N, 2), (M, 1)))

    def heads(t):
        return t.reshape(B, -1, G, D).permute(0, 2, 1, 3)

    shape = {None: None, "mn": (M, N), "1mn": (1, M, N), "gmn": (G, M, N)}[extra]
    bias = None if shape is None else 0.5 * torch.randn(*shape, device=DEVICE, generator=g)
    return heads(q), heads(kv[..., :G * D]), heads(kv[..., G * D:]), heads(do), bias


def sra_what(call):
    bias = f", [{call['extra']}] bias" if call.get("extra") else ""
    return f"{call['model']} stage {call['stage']} B,G,M,N,D={call['shape']}{bias}"


def sra_kernels(torch):
    """3s: the reduced-kv attention's serving forward (no saves), training
    forward (with lse) and backward against the plain versions, the
    backward twice for bit-identity, at the odd shapes and at every call of
    PVT-S and of Twins-SVT-S's global attention at 128 images (the trainers'
    batch and their evals'); median ms of each stage's training forward and
    backward beside the bound, the plain versions and
    F.scaled_dot_product_attention on the same problem (forward, and its
    autograd backward).  Returns the timed entries of the forward and the
    backward, PVT-S stage 1 first."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_attention_mod as fa

    worst = {"out": 0.0, "grads": 0.0}
    fwd_rec, bwd_rec = [], []
    calls = SRA_ODD + pvt_stages(128) + [
        dict(model=t["model"], stage=t["stage"], depth=t["depth"], shape=t["gsa"])
        for t in twins_stages(128)]
    for call in calls:
        q, k, v, do, extra = sra_inputs(torch, *call["shape"], call.get("extra"))
        what = sra_what(call)
        with torch.no_grad():
            out = fa.fused_attention(q, k, v, extra)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_attention", out,
                          fa.fused_attention_reference(q, k, v, extra), what + " (serving)")
        out, saved = fa.fused_attention_fwd(q, k, v, extra)
        grads = fa.fused_attention_bwd(saved, do)
        again = fa.fused_attention_bwd(saved, do)
        torch.cuda.synchronize()
        scale = saved.scale
        out_p, lse_p = fa.attention_fwd_reference(q, k, v, extra, scale)
        err = max(err, check_close(torch, "fused_attention", out, out_p, what + " (training)"))
        check_close(torch, "fused_attention", saved.lse, lse_p, what + " lse")
        worst["out"] = max(worst["out"], err)
        plain = fa.attention_bwd_reference(q, k, v, extra, lse_p, do, scale)
        compare_grads(torch, "fused_attention " + what, ("dq", "dk", "dv", "dextra"), grads,
                      again, plain, worst)
        if call["model"] != "odd":
            B, G, M, N, D = call["shape"]
            f_ms = median_ms(torch, lambda: fa.fused_attention_fwd(q, k, v))
            b_ms = median_ms(torch, lambda: fa.fused_attention_bwd(saved, do))
            pf_ms = median_ms(torch, lambda: fa.attention_fwd_reference(q, k, v, None, scale))
            pb_ms = median_ms(torch, lambda: fa.attention_bwd_reference(
                q, k, v, None, lse_p, do, scale))
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            lib = F_.scaled_dot_product_attention(*leaves)
            lib_err = (lib.detach() - out).abs().max().item()
            lf_ms = median_ms(torch, lambda: F_.scaled_dot_product_attention(q, k, v))
            lb_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaves, do,
                                                                 retain_graph=True))
            fb, fby = bound(*sra_fwd_work(*call["shape"], saves=True))
            bb, bby = bound(*sra_bwd_work(*call["shape"]))
            log(f"kernels: fused_attention {what} (median of 20, CUDA events): kernel "
                f"fwd(lse) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + bwd "
                f"{pb_ms:.3f} ms; scaled_dot_product_attention fwd {lf_ms:.3f} + its "
                f"backward {lb_ms:.3f} ms (max|Δ| to the kernel {lib_err:.3e}); bound fwd "
                f"{fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
            shape = f"{call['model']} stage {call['stage']}, B,G,M,N,D=" + ",".join(
                map(str, call["shape"]))
            fwd_rec.append({"shape": shape + ", lse", "max_abs_err": worst["out"], "ms": f_ms,
                            "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby,
                            "library_ms": lf_ms})
            bwd_rec.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                            "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
                            "library_ms": lb_ms})
            del leaves, lib
        del q, k, v, do, extra, out, saved, grads, again, plain, out_p, lse_p
    return fwd_rec, bwd_rec


# the odd small attention-layer call with Twins' mask: 3x3 windows packed in
# pairs (m = 18), 6 rows, heads 16 wide
TWINS_ODD = dict(model="odd", stage="odd", depth=1, pack=2, images=3,
                 lsa=(6, 18, 48, 3, 16, 192))


def twins_layer_inputs(torch, call, seed=1):
    """Seeded inputs of one attention-layer call of Twins' local attention:
    ``layer_args`` (weights as transposed views), the [m, m] pair mask of
    the port's LocalAttention where windows are packed (else None), a
    per-image DropPath scale (keep 0.9) tiled over the window groups, and an
    output grad."""
    from vision_transformers_tpu_torch.models.twins import LocalAttention

    rows, N, C, H, D, F = call["lsa"]
    a = layer_args(torch, rows, N, C, H, D, F, seed=seed)[:7]
    win = int(round((N // call["pack"]) ** 0.5))
    mask = LocalAttention(C, H, D, win).pair_mask(call["pack"], DEVICE)
    rng = np.random.default_rng(seed + 100)
    images = call["images"]
    keep = rng.random(images) < 0.9
    keep[0], keep[-1] = False, True  # both kinds at every shape
    r = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE).repeat(rows // images)
    dz = torch.from_numpy(rng.standard_normal((rows, N, C)).astype(np.float32)).to(DEVICE)
    return a, mask, r, dz


def twins_layer_kernels(torch):
    """3b, the attention layer with Twins' pair mask: the serving forward
    (no saves), the training forward (with saves) and the backward against
    the plain versions, the backward twice for bit-identity, at an odd shape
    (also with the mask's gradient) and at the four Twins-SVT-S stages at
    128 images (the mask at stages 1-3); median ms of each stage's training
    call.  Returns the timed entries of the forward and the backward."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    worst = {"out": 0.0, "grads": 0.0}
    fwd_rec, bwd_rec = [], []
    for call in [TWINS_ODD] + twins_stages(128):
        a, mask, rs, dz = twins_layer_inputs(torch, call)
        H = call["lsa"][3]
        what = (f"{call['model']} stage {call['stage']} B,N,C,H,D={call['lsa'][:5]}, "
                f"{'pair mask' if mask is not None else 'no mask'}, row scale")
        with torch.no_grad():
            out = fl.fused_attention_layer(*a, H, extra=mask, row_scale=rs)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_attention_layer", out, fl.fused_attention_layer_reference(
            *a, H, extra=mask, row_scale=rs), what + " (serving)")
        worst["out"] = max(worst["out"], err)
        for need_dextra in ((False, True) if call["model"] == "odd" else (False,)):
            out, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=rs, extra=mask)
            grads = fl.fused_attention_layer_bwd(saved, dz, need_dextra=need_dextra)
            again = fl.fused_attention_layer_bwd(saved, dz, need_dextra=need_dextra)
            torch.cuda.synchronize()
            out_p, saved_p = fl.fused_attention_layer_fwd_reference(
                *a, H, row_scale=rs, extra_g=saved.extra_g)
            plain = fl.fused_attention_layer_bwd_reference(saved_p, dz, need_dextra=need_dextra)
            compare_grads(torch, f"{what} dextra={need_dextra}",
                          ("out",) + GRAD_NAMES + ("dextra",), (out,) + grads,
                          (out,) + again, (out_p,) + plain, worst)
            del saved_p, grads, again, plain
        if call["model"] != "odd":
            rows, N, C, _, D, _ = call["lsa"]
            groups = 0 if mask is None else 1
            _, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, row_scale=rs,
                                                                 extra_g=saved.extra_g)
            f_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd(
                *a, H, row_scale=rs, extra=mask))
            b_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd(
                saved, dz, need_dextra=False))
            pf_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd_reference(
                *a, H, row_scale=rs, extra_g=saved.extra_g))
            pb_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd_reference(
                saved_p, dz, need_dextra=False))
            fb, fby = bound(*attn_fwd_work(rows, N, C, H, D, saves=True, groups=groups))
            bb, bby = bound(*attn_bwd_work(rows, N, C, H, D, groups=groups))
            log(f"backward: fused_attention_layer Twins stage {call['stage']} train call "
                f"({what}; median of 20, CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd "
                f"{b_ms:.3f} ms; plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound fwd "
                f"{fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
            shape = (f"Twins-SVT-S stage {call['stage']} train, B,N,C,H,D="
                     + ",".join(map(str, call["lsa"][:5]))
                     + (", pair mask" if mask is not None else "") + ", row scale")
            fwd_rec.append({"shape": shape + ", saves", "max_abs_err": worst["out"],
                            "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby,
                            "library_ms": None})
            bwd_rec.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                            "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
                            "library_ms": None})
            del saved_p
        del a, mask, rs, dz, out, saved
    return fwd_rec, bwd_rec


# ---------------------------------------------------------------------------
# 3d. the attention layer (B1) with DINO's block mask at heads 64 wide
# ---------------------------------------------------------------------------


# DINO DeiT-S/16's local call (configs/dino_deit-s-16.conf at 96 images: 768
# local crops of 37 tokens, packed 3 to a row), and an odd one: 2 crops of 37
# a row at a narrow width
DINO_LOCAL = dict(label="DINO DeiT-S/16 locals (96 images)", shape=(256, 111, 384, 6, 64),
                  pack=3)
DINO_ODD = dict(label="odd", shape=(6, 74, 128, 2, 64), pack=2)


def dino_layer_kernels(torch):
    """3d: B1 with the block-diagonal −1e9 mask of packed local crops at
    heads 64 wide (the packed-row core, the mask added in f32 after the
    product): the serving forward (no saves), the training forward (with
    saves) and the backward against the plain versions, the backward twice
    for bit-identity, the mask without a gradient, at an odd call and at
    DINO's local call; each crop's output blind to the others' tokens;
    median ms of the local call beside the plain version and
    F.scaled_dot_product_attention on the same q, k, v with the mask as a
    float attn_mask (forward, and its backward through autograd; the
    attention alone, without the layer's LN and projections).  Returns the
    timed entries of the forward and the backward."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.models.vit import pack_mask
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    worst = {"out": 0.0, "grads": 0.0}
    for call in (DINO_ODD, DINO_LOCAL):
        B, N, C, H, D = call["shape"]
        a, _, dz = bwd_args(torch, B, N, C, H, D, False)
        mask = pack_mask(call["pack"], N // call["pack"], DEVICE)
        what = f"{call['label']} B,N,C,H,D={call['shape']}, block mask"
        with torch.no_grad():
            out = fl.fused_attention_layer(*a, H, extra=mask)
            moved = a[0].clone()
            moved[:, N // call["pack"]:] += 1.0  # every crop but the first
            other = fl.fused_attention_layer(moved, *a[1:], H, extra=mask)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_attention_layer", out, fl.fused_attention_layer_reference(
            *a, H, extra=mask), what + " (serving)")
        worst["out"] = max(worst["out"], err)
        if not torch.equal(other[:, :N // call["pack"]], out[:, :N // call["pack"]]):
            raise RuntimeError(f"kernels: {what}: a crop's output moved with another crop")
        out, saved = fl.fused_attention_layer_fwd(*a, H, extra=mask)
        grads = fl.fused_attention_layer_bwd(saved, dz, need_dextra=False)
        again = fl.fused_attention_layer_bwd(saved, dz, need_dextra=False)
        torch.cuda.synchronize()
        if not torch.isfinite(saved.lse).all():
            raise RuntimeError(f"kernels: {what}: non-finite lse")
        out_p, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, extra_g=saved.extra_g)
        plain = fl.fused_attention_layer_bwd_reference(saved_p, dz, need_dextra=False)
        compare_grads(torch, what, ("out",) + GRAD_NAMES + ("dextra",), (out,) + grads,
                      (out,) + again, (out_p,) + plain, worst)
        del grads, again, plain, saved_p, other, moved
    f_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd(*a, H, extra=mask))
    b_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd(saved, dz, need_dextra=False))
    _, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, extra_g=saved.extra_g)
    pf_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd_reference(
        *a, H, extra_g=saved.extra_g))
    pb_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd_reference(
        saved_p, dz, need_dextra=False))
    del saved_p
    HD = H * D
    leaf = saved.qkv.detach().clone().requires_grad_()
    q, k, v = (leaf[..., i * HD:(i + 1) * HD].unflatten(-1, (H, D)).transpose(1, 2)
               for i in range(3))
    lib = F_.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=saved.scale)
    lib_err = (lib.detach().transpose(1, 2).reshape(B, N, HD) - saved.acc).abs().max().item()
    dlib = torch.randn_like(lib)
    lf_ms = median_ms(torch, lambda: F_.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=saved.scale))
    lb_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaf, dlib, retain_graph=True))
    fb, fby = bound(*attn_fwd_work(B, N, C, H, D, saves=True, groups=1))
    bb, bby = bound(*attn_bwd_work(B, N, C, H, D, groups=1))
    log(f"backward: fused_attention_layer {what} train call (median of 20, CUDA events): "
        f"kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + bwd "
        f"{pb_ms:.3f} ms; scaled_dot_product_attention (the attention alone) fwd "
        f"{lf_ms:.3f} + its backward {lb_ms:.3f} ms (max|Δ| to the kernel's attention "
        f"output {lib_err:.3e}); bound fwd {fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
    shape = f"{DINO_LOCAL['label']}, B,N,C,H,D=" + ",".join(map(str, DINO_LOCAL["shape"])) \
        + ", block mask"
    fwd = {"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": f_ms,
           "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": lf_ms}
    bwd = {"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms, "plain_ms": pb_ms,
           "bound_ms": bb, "bound_by": bby, "library_ms": lb_ms}
    del leaf, q, k, v, lib, dlib, a, dz, out, saved
    return fwd, bwd


def dino_bf16_layer_kernels(torch):
    """3d at bf16: B1's bf16 form with DINO's block mask (the bias on the
    packed-row attention's bf16 form) at an odd call (2 crops a row, 74
    tokens, with per-sample row scales) and at DINO DeiT-S/16's local call
    at 96 images (256 rows of 111 tokens): the serving forward, the training
    forward (with saves) and the backward against the plain versions, the
    backward twice for bit-identity, the mask without a gradient, within
    phase 3bf's limits; each crop's output blind to the others' tokens;
    median ms of the local call beside the plain version and the bound at
    the bf16 rate (the layer's products and its attention with the mask),
    and the attention alone beside scaled_dot_product_attention with the
    mask (phase 3bf's packed_attention+bias[bf16] record).  Returns the
    timed entries of the forward and the backward."""
    from vision_transformers_tpu_torch.models.vit import pack_mask
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    bf = torch.bfloat16
    worst = {"fwd": 0.0, "bwd": 0.0}
    for call, rows_scaled in ((DINO_ODD, True), (DINO_LOCAL, False)):
        B, N, C, H, D = call["shape"]
        a = bf16_args(torch, B, N, C, H, D, 4 * C, seed=N)[:7]
        mask = pack_mask(call["pack"], N // call["pack"], DEVICE)
        r = None
        if rows_scaled:
            r = torch.full((B,), 1 / 0.9, device=DEVICE)
            r[::3] = 0.0
        dz = torch.randn(B, N, C, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(B)).to(bf)
        what = (f"B1 + DINO mask (bf16) {call['label']} B,N,C,H,D={call['shape']} "
                f"rs={rows_scaled}")
        seq = N // call["pack"]
        with torch.no_grad():
            serving = fl.fused_attention_layer(*a, H, extra=mask, row_scale=r)
            moved = a[0].clone()
            moved[:, seq:] += 1.0  # every crop but the first
            other = fl.fused_attention_layer(moved, *a[1:], H, extra=mask, row_scale=r)
        out, saved = fl.fused_attention_layer_fwd(*a, H, row_scale=r, extra=mask)
        grads = fl.fused_attention_layer_bwd(saved, dz, need_dextra=False)
        again = fl.fused_attention_layer_bwd(saved, dz, need_dextra=False)
        torch.cuda.synchronize()
        if not torch.equal(other[:, :seq], serving[:, :seq]):
            raise RuntimeError(f"bf16: {what}: a crop's output moved with another crop")
        out_p, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, row_scale=r,
                                                                extra_g=saved.extra_g)
        plain = fl.fused_attention_layer_bwd_reference(saved_p, dz, need_dextra=False)
        worst["fwd"] = max(worst["fwd"], bf16_close(torch, what + " out", out, out_p,
                                                    BF16_FWD_TOL))
        bf16_close(torch, what + " serving", serving, out_p, BF16_FWD_TOL)
        for name, k, k2, p in zip(GRAD_NAMES + ("dextra",), grads, again, plain):
            if p is None:
                if k is not None:
                    raise RuntimeError(f"bf16: {what} {name} should be None")
                continue
            if not torch.equal(k, k2):
                raise RuntimeError(f"bf16: {what} {name} differs between two runs")
            worst["bwd"] = max(worst["bwd"], bf16_close(
                torch, f"{what} {name} ({k.dtype}, bit-identical across two runs)", k, p,
                BF16_BWD_TOL))
        del grads, again, plain, saved_p, other, moved
    f_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd(*a, H, extra=mask))
    b_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd(saved, dz, need_dextra=False))
    pf_ms = median_ms(torch, lambda: fl.fused_attention_layer_fwd_reference(
        *a, H, extra_g=saved.extra_g))
    _, saved_p = fl.fused_attention_layer_fwd_reference(*a, H, extra_g=saved.extra_g)
    pb_ms = median_ms(torch, lambda: fl.fused_attention_layer_bwd_reference(
        saved_p, dz, need_dextra=False))
    del saved_p
    bias_bytes = 4 * H * N * N  # the mask, one group, read once
    fw, fby = b1_bf16_work(B, N, C, H, D)
    bw, bby = b1_bf16_work(B, N, C, H, D, backward=True)
    fb, fby = bound(fw, fby + bias_bytes, H100_BF16_FLOPS)
    bb, bby = bound(bw, bby + bias_bytes, H100_BF16_FLOPS)
    log(f"bf16: B1 with DINO's mask at {DINO_LOCAL['label']} B,N,C,H,D={DINO_LOCAL['shape']} "
        f"(median of 20, CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; "
        f"plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound (bf16 989 TFLOP/s) fwd "
        f"{fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
    shape = f"{DINO_LOCAL['label']}, B,N,C,H,D=" + ",".join(map(str, DINO_LOCAL["shape"])) \
        + ", block mask"
    fwd = {"shape": shape + ", saves", "max_abs_err": worst["fwd"], "ms": f_ms,
           "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": None}
    bwd = {"shape": shape, "max_abs_err": worst["bwd"], "ms": b_ms, "plain_ms": pb_ms,
           "bound_ms": bb, "bound_by": bby, "library_ms": None}
    del a, dz, out, saved
    return fwd, bwd


# ---------------------------------------------------------------------------
# 3q. the packed-qkv attention (B3) vs its plain version
# ---------------------------------------------------------------------------


def qkv_inputs(torch, B, N, H, D, extra_shape=None, seed=0):
    """Seeded qkv [B, N, 3·H·D], an output grad [B, N, H·D] and, with
    ``extra_shape``, a std-0.5 additive bias of that shape."""
    g = torch.Generator(DEVICE).manual_seed(seed)
    qkv = torch.randn(B, N, 3 * H * D, device=DEVICE, generator=g)
    do = torch.randn(B, N, H * D, device=DEVICE, generator=g)
    extra = None if extra_shape is None else \
        0.5 * torch.randn(*extra_shape, device=DEVICE, generator=g)
    return qkv, extra, do


def qkv_calls():
    """(label, B, N, H, D, the bias or a recipe for it) of every call 3q
    checks: odd shapes without a bias (D = 64) and with each bias form
    (D = 32; two at D = 64), ViT-S/16's training call, and Swin-S's four
    stages at 64 images under a forced 'fused' (the grouped bias of a
    shifted layer)."""
    B, N, H = 3, 37, 2
    calls = [("odd, no bias", B, N, H, 64, None),
             ("odd, [N, N] bias", B, N, H, 32, (N, N)),
             ("odd, [H, N, N] bias", B, N, H, 32, (H, N, N)),
             ("odd, [1, N, N] bias", B, N, H, 32, (1, N, N)),
             ("odd, grouped [3, H, N, N] bias", 6, N, H, 32, (3, H, N, N)),
             ("odd, [H, N, N] bias, heads 64 wide", B, N, H, 64, (H, N, N)),
             ("odd, grouped [2, H, 150, 150] bias, heads 64 wide", 4, 150, H, 64,
              (2, H, 150, 150)),
             ("ViT-S/16 train", 128, 197, 6, 64, None)]
    for call in swin_stages(64):
        rows, m, _, heads, D, _ = call["shape"]
        calls.append((f"Swin-S stage {call['stage']} (fused), G={call['groups']}", rows,
                      m, heads, D, call))
    return calls


def qkv_kernels(torch):
    """3q: the packed-qkv attention's serving forward (no saves), training
    forward (with lse) and backward against the plain versions, the
    backward twice for bit-identity, at ``qkv_calls()``; median ms of the
    ViT-S/16 and Swin-S calls beside the bound, the plain versions and
    F.scaled_dot_product_attention on [B, H, N, D] views of the same qkv
    (forward, and its autograd backward; with the bias as ``attn_mask``, its
    gradient not asked).  Returns the timed entries of the forward and the
    backward, the ViT-S/16 call first."""
    import torch.nn.functional as F_

    from vision_transformers_tpu_torch.ops import fused_attention_mod as fa

    worst = {"out": 0.0, "grads": 0.0}
    fwd_rec, bwd_rec = [], []
    for label, B, N, H, D, bias in qkv_calls():
        if isinstance(bias, dict):  # a Swin stage: its grouped bias
            qkv, _, do = qkv_inputs(torch, B, N, H, D)
            extra = swin_layer_inputs(torch, bias, row_scales=False)[1]
        else:
            qkv, extra, do = qkv_inputs(torch, B, N, H, D, bias)
        what = f"{label}, B,N,H,D={B},{N},{H},{D}"
        with torch.no_grad():
            out = fa.fused_attention_qkv(qkv, H, extra)
        torch.cuda.synchronize()
        err = check_close(torch, "fused_attention_qkv", out,
                          fa.fused_attention_qkv_reference(qkv, H, extra), what + " (serving)")
        out, saved = fa.fused_attention_qkv_fwd(qkv, H, extra)
        grads = fa.fused_attention_qkv_bwd(saved, do)
        again = fa.fused_attention_qkv_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, lse_p = fa.qkv_attention_fwd_reference(qkv, H, saved.extra_g, saved.scale)
        err = max(err, check_close(torch, "fused_attention_qkv", out, out_p,
                                   what + " (training)"))
        check_close(torch, "fused_attention_qkv", saved.lse, lse_p, what + " lse")
        worst["out"] = max(worst["out"], err)
        plain = fa.qkv_attention_bwd_reference(qkv, H, saved.extra_g, do, saved.scale)
        compare_grads(torch, "fused_attention_qkv " + what, ("dqkv", "dextra"), grads,
                      again, plain, worst)
        del grads, again, plain
        if B >= 32:
            groups = 0 if extra is None else saved.extra_g.shape[0]
            f_ms = median_ms(torch, lambda: fa.fused_attention_qkv_fwd(qkv, H, extra))
            b_ms = median_ms(torch, lambda: fa.fused_attention_qkv_bwd(saved, do))
            pf_ms = median_ms(torch, lambda: fa.qkv_attention_fwd_reference(
                qkv, H, saved.extra_g, saved.scale))
            pb_ms = median_ms(torch, lambda: fa.qkv_attention_bwd_reference(
                qkv, H, saved.extra_g, do, saved.scale))
            HD = H * D
            leaf = qkv.detach().clone().requires_grad_()
            q, k, v = (leaf[..., i * HD:(i + 1) * HD].unflatten(-1, (H, D)).transpose(1, 2)
                       for i in range(3))
            mask = None if extra is None else saved.extra_g.repeat_interleave(
                B // saved.extra_g.shape[0], 0)
            lib = F_.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=saved.scale)
            dlib = do.unflatten(-1, (H, D)).transpose(1, 2)
            lib_err = (lib.detach().transpose(1, 2).reshape(B, N, HD) - out).abs().max().item()
            lf_ms = median_ms(torch, lambda: F_.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=saved.scale))
            lb_ms = median_ms(torch, lambda: torch.autograd.grad(lib, leaf, dlib,
                                                                 retain_graph=True))
            fb, fby = bound(*qkv_fwd_work(B, N, H, D, groups, saves=True))
            bb, bby = bound(*qkv_bwd_work(B, N, H, D, groups))
            log(f"kernels: fused_attention_qkv {what} (median of 20, CUDA events): kernel "
                f"fwd(lse) {f_ms:.3f} + bwd {b_ms:.3f} ms; plain fwd {pf_ms:.3f} + bwd "
                f"{pb_ms:.3f} ms; scaled_dot_product_attention fwd {lf_ms:.3f} + its "
                f"backward {lb_ms:.3f} ms (max|Δ| to the kernel {lib_err:.3e}); bound fwd "
                f"{fb:.3f} ({fby}) + bwd {bb:.3f} ms ({bby})")
            shape = f"{label}, B,N,H,D={B},{N},{H},{D}"
            fwd_rec.append({"shape": shape + ", lse", "max_abs_err": worst["out"],
                            "ms": f_ms, "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby,
                            "library_ms": lf_ms})
            bwd_rec.append({"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms,
                            "plain_ms": pb_ms, "bound_ms": bb, "bound_by": bby,
                            "library_ms": lb_ms})
            del leaf, q, k, v, mask, lib, dlib
        del qkv, extra, do, out, saved, out_p, lse_p
    return fwd_rec, bwd_rec


# ---------------------------------------------------------------------------
# 3f. the FF residual branch (B7) vs its plain version
# ---------------------------------------------------------------------------


def ff_inputs(torch, B, N, C, F, row_scale, seed=2):
    """Seeded FF inputs from ``layer_args`` (x, LN₂, w1 / b1 / w2 / b2 as
    the model's transposed weight views), a row scale of dropped / kept
    samples (keep 0.9) and an output grad."""
    a = layer_args(torch, B, N, C, 1, C, F, seed=seed)
    rng = np.random.default_rng(seed + 100)
    r = None
    if row_scale:
        keep = rng.random(B) < 0.9
        keep[0], keep[-1] = False, True  # both kinds at every shape
        r = torch.from_numpy((keep / 0.9).astype(np.float32)).to(DEVICE)
    do = torch.from_numpy(rng.standard_normal((B, N, C)).astype(np.float32)).to(DEVICE)
    return [a[0], *a[7:]], r, do


VIT_FF = (128, 197, 384, 1536)  # ViT-S/16's FF call in training: B, N, C, F


def ff_kernels(torch):
    """3f: the FF residual branch's serving forward, training forward (with
    saves) and backward against the plain versions, the backward twice for
    bit-identity: silu at ViT-S/16's call (M = 128·197 rows, C 384, F 1536)
    with and without the row scale, silu and tanh-gelu at an odd shape;
    median ms of the ViT-S/16 call with the row scale (the trainer's)
    beside the bound and the plain versions.  Returns the timed entries of
    the forward and the backward."""
    from vision_transformers_tpu_torch.ops import fused_layer as fl

    worst = {"out": 0.0, "grads": 0.0}
    vit = VIT_FF
    for shape, act, use_rs in (((3, 37, 48, 96), "silu", True),
                               ((3, 37, 48, 96), "gelu", False),
                               ((3, 37, 48, 96), "gelu", True),
                               (vit, "silu", False), (vit, "silu", True)):
        a, rs, do = ff_inputs(torch, *shape, use_rs)
        what = f"B,N,C,F={shape} {act} rs={use_rs}"
        with torch.no_grad():
            out = fl.fused_ff_layer(*a, act, rs)
        torch.cuda.synchronize()
        worst["out"] = max(worst["out"], check_close(
            torch, "fused_ff_layer", out, fl.fused_ff_layer_reference(*a, act, rs),
            what + " (serving)"))
        out, saved = fl.fused_ff_layer_fwd(*a, act, rs)
        grads = fl.fused_ff_layer_bwd(saved, do)
        again = fl.fused_ff_layer_bwd(saved, do)
        torch.cuda.synchronize()
        out_p, saved_p = fl.fused_ff_layer_fwd_reference(*a, act, rs)
        plain = fl.fused_ff_layer_bwd_reference(saved_p, do)
        compare_grads(torch, "fused_ff_layer " + what, ("out",) + fl.FF_GRAD_NAMES,
                      (out,) + grads, (out,) + again, (out_p,) + plain, worst)
        del saved, saved_p, grads, again, plain
    a, rs, do = ff_inputs(torch, *vit, True)
    _, saved = fl.fused_ff_layer_fwd(*a, "silu", rs)
    _, saved_p = fl.fused_ff_layer_fwd_reference(*a, "silu", rs)
    f_ms = median_ms(torch, lambda: fl.fused_ff_layer_fwd(*a, "silu", rs))
    b_ms = median_ms(torch, lambda: fl.fused_ff_layer_bwd(saved, do))
    pf_ms = median_ms(torch, lambda: fl.fused_ff_layer_fwd_reference(*a, "silu", rs))
    pb_ms = median_ms(torch, lambda: fl.fused_ff_layer_bwd_reference(saved_p, do))
    fb, fby = bound(*ff_fwd_work(*vit, row_scale=True, saves=True))
    bb, bby = bound(*ff_bwd_work(*vit, row_scale=True))
    log(f"backward: fused_ff_layer ViT-S/16 train call (B,N,C,F={vit}, silu, row scale; "
        f"median of 20, CUDA events): kernel fwd(saves) {f_ms:.3f} + bwd {b_ms:.3f} ms; "
        f"plain fwd {pf_ms:.3f} + bwd {pb_ms:.3f} ms; bound fwd {fb:.3f} ({fby}) + bwd "
        f"{bb:.3f} ms ({bby})")
    shape = "ViT-S/16 train, B,N,C,F=" + ",".join(map(str, vit)) + ", silu, row scale"
    return ([{"shape": shape + ", saves", "max_abs_err": worst["out"], "ms": f_ms,
              "plain_ms": pf_ms, "bound_ms": fb, "bound_by": fby, "library_ms": None}],
            [{"shape": shape, "max_abs_err": worst["grads"], "ms": b_ms, "plain_ms": pb_ms,
              "bound_ms": bb, "bound_by": bby, "library_ms": None}])


# ---------------------------------------------------------------------------
# 4. full width against the JAX package's logits
# ---------------------------------------------------------------------------


def seeded_model(torch, conf_path, seed):
    """(the conf, its seeded state_dict, the model on the card in eval)."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.utils.weights import seeded_state_dict, to_torch

    conf = load_config(conf_path)
    sd = to_torch(seeded_state_dict(conf.arch, seed))
    model = conf.arch.make()
    model.load_state_dict(sd, strict=True)
    return conf, sd, model.to(DEVICE).eval()


def image_size(conf):
    """The model's image size; the conf's eval size for a model that has
    none (Twins-SVT)."""
    size = getattr(conf.arch, "image_size", None) or conf.training.valid_size
    return size if isinstance(size, int) else size[0]


def counted_modules():
    """counter name → (its ops module, the counter's name there): each
    kernel's launches, of the attention layer's those that carried the bias
    (``+bias``), of B1's and B2's those of their bf16 forms (``[bf16]``),
    of B1's, B2's and the packed-row attention's bf16 launches those with
    the bias (``+bias[bf16]``), and of the attention's bf16 backward those
    that summed the bias's gradient (``+dbias[bf16]``)."""
    from vision_transformers_tpu_torch.ops import (fused_attention_mod, fused_block,
                                                   fused_halo, fused_halo_layer,
                                                   fused_layer, fused_layer1, fused_swin)

    return {"fused_attention_layer": (fused_layer, "LAUNCHES"),
            "fused_attention_layer_bwd": (fused_layer, "BWD_LAUNCHES"),
            "fused_attention_layer+bias": (fused_layer, "BIAS_LAUNCHES"),
            "fused_attention_layer_bwd+bias": (fused_layer, "BIAS_BWD_LAUNCHES"),
            "fused_transformer_layer": (fused_layer1, "LAUNCHES"),
            "fused_transformer_layer_bwd": (fused_layer1, "BWD_LAUNCHES"),
            "fused_halo_layer": (fused_halo_layer, "LAUNCHES"),
            "fused_halo_layer_bwd": (fused_halo_layer, "BWD_LAUNCHES"),
            "halo_attention_direct": (fused_halo, "LAUNCHES"),
            "halo_attention_direct_bwd": (fused_halo, "BWD_LAUNCHES"),
            "fused_attention": (fused_attention_mod, "LAUNCHES"),
            "fused_attention_bwd": (fused_attention_mod, "BWD_LAUNCHES"),
            "fused_attention_qkv": (fused_attention_mod, "QKV_LAUNCHES"),
            "fused_attention_qkv_bwd": (fused_attention_mod, "QKV_BWD_LAUNCHES"),
            "fused_ff_layer": (fused_layer, "FF_LAUNCHES"),
            "fused_ff_layer_bwd": (fused_layer, "FF_BWD_LAUNCHES"),
            "halo_attention": (fused_halo, "HALO_GATHER_LAUNCHES"),
            "halo_attention_bwd": (fused_halo, "HALO_GATHER_BWD_LAUNCHES"),
            "fused_attention_block": (fused_block, "BLOCK_LAUNCHES"),
            "fused_attention_block_bwd": (fused_block, "BLOCK_BWD_LAUNCHES"),
            "fused_swin_layer": (fused_swin, "LAUNCHES"),
            "fused_swin_layer_bwd": (fused_swin, "BWD_LAUNCHES"),
            "fused_attention_layer[bf16]": (fused_layer, "BF16_LAUNCHES"),
            "fused_attention_layer_bwd[bf16]": (fused_layer, "BF16_BWD_LAUNCHES"),
            "fused_transformer_layer[bf16]": (fused_layer1, "BF16_LAUNCHES"),
            "packed_attention[bf16]": (fused_layer, "PACKED_BF16_LAUNCHES"),
            "packed_attention_bwd[bf16]": (fused_layer, "PACKED_BF16_BWD_LAUNCHES"),
            "fused_attention_layer+bias[bf16]": (fused_layer, "BF16_BIAS_LAUNCHES"),
            "fused_attention_layer_bwd+bias[bf16]": (fused_layer, "BF16_BIAS_BWD_LAUNCHES"),
            "packed_attention+bias[bf16]": (fused_layer, "PACKED_BF16_BIAS_LAUNCHES"),
            "packed_attention_bwd+bias[bf16]": (fused_layer, "PACKED_BF16_BIAS_BWD_LAUNCHES"),
            "fused_transformer_layer_bwd[bf16]": (fused_layer1, "BF16_BWD_LAUNCHES"),
            "fused_transformer_layer+bias[bf16]": (fused_layer1, "BF16_BIAS_LAUNCHES"),
            "fused_transformer_layer_bwd+bias[bf16]": (fused_layer1, "BF16_BIAS_BWD_LAUNCHES"),
            "packed_attention_bwd+dbias[bf16]": (fused_layer, "PACKED_BF16_DBIAS_BWD_LAUNCHES"),
            "fused_halo_layer[bf16]": (fused_halo_layer, "BF16_LAUNCHES"),
            "fused_halo_layer_bwd[bf16]": (fused_halo_layer, "BF16_BWD_LAUNCHES"),
            "halo_attention_direct[bf16]": (fused_halo, "BF16_LAUNCHES"),
            "halo_attention_direct_bwd[bf16]": (fused_halo, "BF16_BWD_LAUNCHES"),
            "halo_attention[bf16]": (fused_halo, "HALO_GATHER_BF16_LAUNCHES"),
            "halo_attention_bwd[bf16]": (fused_halo, "HALO_GATHER_BF16_BWD_LAUNCHES")}


def counts():
    return {k: getattr(mod, attr) for k, (mod, attr) in counted_modules().items()}


def reset_counts():
    for mod, attr in counted_modules().values():
        setattr(mod, attr, 0)


@contextlib.contextmanager
def forced(halo=None, sra=None, attn=None, ff=None):
    """The Halo path ``halo``, the reduced-kv path ``sra``, the attention
    path ``attn`` and the FF-kernel switch ``ff`` (None: the defaults) for
    the duration."""
    from vision_transformers_tpu_torch import ops

    ops.set_halo_impl(halo)
    ops.set_sra_impl(sra)
    ops.set_attention_impl(attn)
    ops.set_ff_kernel(ff)
    try:
        yield
    finally:
        ops.set_halo_impl(None)
        ops.set_sra_impl(None)
        ops.set_attention_impl(None)
        ops.set_ff_kernel(None)


@contextlib.contextmanager
def environ(env):
    """The environment variables ``env`` set for the duration."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def expect_path(before, after, expected, what):
    """Each counter moved by ``expected[name]`` (0 where unnamed)."""
    moved = {k: after[k] - before[k] for k in after}
    want = {k: expected.get(k, 0) for k in after}
    if moved != want:
        raise RuntimeError(f"{what}: expected launches {want}, counted {moved}")


def scaled_counts(expected, n):
    return {k: v * n for k, v in expected.items()}


def path_label(expected, sra=None, halo=None, attn=None, ff=None):
    forced_by = [f"{name} {v}" for name, v in (("halo", halo), ("sra", sra),
                                                ("attention", attn), ("FF kernel", ff)) if v]
    return " + ".join(k for k in expected if "+" not in k) + (
        f" ({', '.join(forced_by)})" if forced_by else "")


def golden(torch, model_name, cases, sra=None, halo=None, attn=None):
    """``cases``: (rows, the launches of each counter in one forward of
    that many rows); ``sra`` / ``halo`` / ``attn`` force the reduced-kv /
    Halo / attention path."""
    from vision_transformers_tpu_torch.predict import predict_batch
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf_path, path, _, depth = MODELS[model_name]
    with np.load(path) as f:
        seed, ref = int(f["seed"]), f["logits"]
    conf, _, model = seeded_model(torch, conf_path, seed)
    size = image_size(conf)
    images = seeded_images(seed, ref.shape[0], size)
    tol = 1e-3 * max(1.0, float(np.abs(ref).max()))
    for rows, expected in cases:
        idx = np.arange(rows) % ref.shape[0]
        before = counts()
        with forced(halo=halo, sra=sra, attn=attn):
            logits, top, _ = predict_batch(model, images[idx], 5, DEVICE)
        expect_path(before, counts(), expected, f"golden {model_name} {rows} rows")
        if logits.shape != (rows, ref.shape[1]) or not np.isfinite(logits).all():
            raise RuntimeError(f"golden: bad logits {logits.shape}")
        err = float(np.abs(logits - ref[idx]).max())
        log(f"golden: {model_name} @{size} depth {depth}, {rows} rows via "
            f"{path_label(expected, sra, halo, attn)}: max|port-JAX| {err:.3e} "
            f"(tol {tol:.3e})")
        if err > tol or not (top[:, 0] == ref[idx].argmax(-1)).all():
            raise RuntimeError("golden: the port disagrees with the JAX logits")


# ---------------------------------------------------------------------------
# 4b. a full-width train step against the JAX package's gradients
# ---------------------------------------------------------------------------


# the ViT-S/16 dropout train golden (scripts/make_torch_port_train_golden.py
# --dropout): dropout = drop_ff = DROPOUT, the masks regenerated from its seed
DROPOUT_GOLDEN = os.path.join(DATA, "vit_s16_port_dropout_train_golden.npz")
DROPOUT = 0.1
GOLDEN_ROWS = 64  # the train goldens' 2 images, tiled


def train_golden(torch, model_name, expected, halo=None, sra=None, attn=None, ff=None,
                 dropout=False):
    """One train step at 64 rows; ``expected`` the launches of each counter
    in it; ``halo`` / ``sra`` / ``attn`` force a Halo / reduced-kv /
    attention path, ``ff`` the FF kernel; ``dropout``: the dropout golden,
    every dropout mask from its seed (the golden's 2 images' masks tiled
    as the images are)."""
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.train import loss as L
    from vision_transformers_tpu_torch.utils.weights import (grad_projections,
                                                             seeded_dropout_masks,
                                                             seeded_state_dict,
                                                             seeded_train_batch,
                                                             supplied_dropout_masks,
                                                             to_torch, vit_dropout_calls)

    conf_path, _, path, depth = MODELS[model_name]
    path = DROPOUT_GOLDEN if dropout else path
    with np.load(path) as f:
        g = {k: f[k] for k in f.files}
    seed, keys, rtol = int(g["seed"]), list(g["keys"]), 1e-3
    conf = load_config(conf_path)
    # the golden is one step with no DropPath: the conf's drop_path off
    rates = dict(dropout=DROPOUT, drop_ff=DROPOUT) if dropout else {}
    arch = dataclasses.replace(conf.arch, drop_path=0.0, **rates)
    model = arch.make()
    model.load_state_dict(to_torch(seeded_state_dict(arch, seed)), strict=True)
    model.to(DEVICE).train()
    size = image_size(conf)
    batch = seeded_train_batch(seed, 2, size, arch.n_class)
    idx = np.arange(GOLDEN_ROWS) % 2  # 64 rows take the kernels; the mean over
    b = {k: torch.from_numpy(v[idx]).to(DEVICE) for k, v in batch.items()}  # copies = 2-row mean
    masks = []
    if dropout:
        shapes, mask_rates = zip(*vit_dropout_calls(arch, 2))
        masks = [torch.from_numpy(m[idx]).to(DEVICE)
                 for m in seeded_dropout_masks(seed, shapes, mask_rates)]
    before = counts()
    with forced(halo, sra, attn, ff), supplied_dropout_masks(masks) as calls:
        logits = model(b["image"].permute(0, 3, 1, 2))
        loss = L.mix_loss(logits, b["label1"].long(), b["label2"].long(), b["ratio"],
                          eps=0.1)
        loss.backward()
    torch.cuda.synchronize()
    if len(calls) != len(masks):
        raise RuntimeError(f"train golden: {len(calls)} dropout calls for "
                           f"{len(masks)} masks")
    expect_path(before, counts(), expected, f"train golden {model_name}, {GOLDEN_ROWS} rows")
    grads = {k: p.grad.double().cpu().numpy() for k, p in model.named_parameters()}
    if sorted(grads) != keys:
        raise RuntimeError("train golden: the port's parameters differ from the golden's")
    norms = np.array([np.linalg.norm(grads[k]) for k in keys])
    projections = grad_projections(grads, seed)
    proj = np.array([projections[k] for k in keys])
    checks = {
        "loss": (float(loss.detach()), float(g["loss"])),
        "grad_norm": (float(np.sqrt((norms ** 2).sum())), float(g["grad_norm"])),
    }
    rel = {k: abs(a - b) / abs(b) for k, (a, b) in checks.items()}
    # a tensor whose JAX gradient is exactly zero (Twins' last-stage query
    # projection: a softmax over one key has no gradient) has no relative
    # error; its norm is held to an absolute limit instead
    zero = g["norms"] == 0
    rel["tensor norms (worst)"] = float(np.max(np.abs(norms - g["norms"])[~zero]
                                               / g["norms"][~zero]))
    rel["projections (worst, of the tensor norm)"] = float(
        np.max(np.abs(proj - g["projections"])[~zero] / g["norms"][~zero]))
    zero_norm, zero_tol = float(norms[zero].max()) if zero.any() else 0.0, 1e-7
    log(f"train golden: {model_name} @{size} depth {depth} f32"
        f"{f', dropout = drop_ff = {DROPOUT} ({len(masks)} masks from the seed)' if dropout else ''}"
        f", {GOLDEN_ROWS} rows via {path_label(expected, sra, halo, attn, ff)}: loss "
        f"{checks['loss'][0]:.6f} (JAX "
        f"{checks['loss'][1]:.6f}), grad_norm {checks['grad_norm'][0]:.5f} (JAX "
        f"{checks['grad_norm'][1]:.5f}); relative "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()) + f" (rtol {rtol})"
        + (f"; {int(zero.sum())} tensors with a zero JAX gradient: largest norm "
           f"{zero_norm:.2e} (tol {zero_tol})" if zero.any() else ""))
    if not all(np.isfinite(v) and v <= rtol for v in rel.values()) or zero_norm > zero_tol:
        raise RuntimeError("train golden: the port's gradients disagree with the JAX package")


# ---------------------------------------------------------------------------
# 4d. a full-width DINO step against the JAX package's
# ---------------------------------------------------------------------------


DINO_CONF = os.path.join(ROOT, "configs", "dino_deit-s-16.conf")
DINO_GOLDEN_SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_dino_golden.py")


def dino_golden(torch):
    """One f32 DINO step of DeiT-S/16 (depth 12, head → 65,536) under the
    'layer' force, on the golden's 3 images (6 globals at 224, 24 locals at
    96 packed 3 to a row: 8 rows under the mask, which the einsum gate would
    otherwise take), seeded weights, center and temperature, against
    tests/data/dino_deit_s16_port_golden.npz: the loss, both nets' outputs
    (per-crop norms and projections), the gradient norm and each tensor's
    gradient norm and projection, rtol 1e-3.  Each of the 12 layers runs B1:
    the teacher on the globals (serving), the student on the globals and,
    with the mask, on the locals, forward and backward."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_torch_port_dino_golden",
                                                  DINO_GOLDEN_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # numpy at import; the port's step imports no JAX
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    fal, falb = "fused_attention_layer", "fused_attention_layer_bwd"
    expected = {fal: 36, fal + "+bias": 12, falb: 24, falb + "+bias": 12}
    before = counts()
    with forced(attn="layer"):
        ours = mod.port_dino_step(int(g["seed"]), DEVICE)
    torch.cuda.synchronize()
    expect_path(before, counts(), expected, "golden DINO")
    if list(ours["keys"]) != list(g["keys"]):
        raise RuntimeError("golden DINO: the port's parameters differ from the golden's")
    rtol, norms = 1e-3, g["norms"]
    rel = {"loss": abs(ours["loss"] - g["loss"]) / abs(g["loss"]),
           "grad_norm": abs(ours["grad_norm"] - g["grad_norm"]) / g["grad_norm"],
           "tensor norms (worst)": float(np.max(np.abs(ours["norms"] - norms) / norms)),
           "projections (worst, of the tensor norm)": float(np.max(
               np.abs(ours["projections"] - g["projections"]) / norms))}
    for net in ("student", "teacher"):
        rel[f"{net} output norms (worst)"] = float(np.max(
            np.abs(ours[f"{net}_norms"] - g[f"{net}_norms"]) / g[f"{net}_norms"]))
        scale = float(np.abs(g[f"{net}_projections"]).max())
        rel[f"{net} output projections (worst, of the largest)"] = float(np.max(
            np.abs(ours[f"{net}_projections"] - g[f"{net}_projections"])) / scale)
    log(f"golden: DINO DeiT-S/16 depth 12, {len(g['student_norms'])} student crops (6 x "
        f"224, 24 x 96 packed 3 to a row) and {len(g['teacher_norms'])} teacher crops via "
        f"{path_label(expected, attn='layer')}: loss {ours['loss']:.6f} (JAX "
        f"{float(g['loss']):.6f}), grad_norm {ours['grad_norm']:.5f} (JAX "
        f"{float(g['grad_norm']):.5f}); relative " + ", ".join(
            f"{k} {v:.2e}" for k, v in rel.items()) + f" (rtol {rtol})")
    if not all(np.isfinite(v) and v <= rtol for v in rel.values()):
        raise RuntimeError("golden DINO: the port disagrees with the JAX package")


# ---------------------------------------------------------------------------
# 4bf. ViT-S/16 at bf16 against the JAX package's bf16 and f32
# ---------------------------------------------------------------------------


BF16_GOLDEN_SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_bf16_golden.py")


def bf16_golden(torch):
    """The bf16 port at full width and depth (seeded weights, DropPath off)
    against tests/data/vit_s16_bf16_port_golden.npz: the logits of the
    golden's two images tiled to 64 rows on B1 ('layer') and to 256 rows on
    B2 ('layer1'), and one bf16 train step at 64 rows on B1's bf16 forward
    and backward; each within GAP_FACTOR times the JAX package's own bf16
    error (its bf16 against its f32)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_torch_port_bf16_golden",
                                                  BF16_GOLDEN_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # numpy at import; the port's side imports no JAX
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    seed = int(g["seed"])
    model = mod.port_model(seed, DEVICE)
    fal, falb, ftl = "fused_attention_layer", "fused_attention_layer_bwd", \
        "fused_transformer_layer"
    for rows, impl, kernel in ((64, "layer", fal), (256, "layer1", ftl)):
        before = counts()
        logits = mod.port_logits(seed, DEVICE, rows, impl, model)
        torch.cuda.synchronize()
        expect_path(before, counts(), {kernel: 12, kernel + "[bf16]": 12,
                                       "packed_attention[bf16]": 12},
                    f"bf16 golden, {rows} rows on {impl}")
        err, lim = mod.check_logits(logits, g, impl)
        log(f"golden: ViT-S/16 bf16 logits, {rows} rows via {kernel} (bf16): max|port - JAX "
            f"bf16| {err:.4e} (limit {mod.GAP_FACTOR} x JAX's bf16 gap = {lim:.4e})")
    before = counts()
    ours = mod.port_train(seed, DEVICE, GOLDEN_ROWS, None, model)
    torch.cuda.synchronize()
    expect_path(before, counts(), {fal: 12, fal + "[bf16]": 12, falb: 12, falb + "[bf16]": 12,
                                   "packed_attention[bf16]": 12,
                                   "packed_attention_bwd[bf16]": 12},
                f"bf16 golden train step, {GOLDEN_ROWS} rows")
    checks = mod.check_train(ours, g)
    log(f"golden: ViT-S/16 bf16 train step, {GOLDEN_ROWS} rows via {fal} (bf16) forward and "
        f"backward: loss {float(ours['loss_port']):.6f} (JAX bf16 "
        f"{float(g['loss_bf16']):.6f}, f32 {float(g['loss_f32']):.6f}); error (limit) "
        + ", ".join(f"{k} {e:.3e} ({lim:.3e})" for k, (e, lim) in checks.items()))


SWIN_BF16_GOLDEN_SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_swin_bf16_golden.py")


def swin_bf16_golden(torch):
    """Swin-S in bf16 (seeded weights, DropPath off) against
    tests/data/swin_s_bf16_port_golden.npz: the golden's two images' logits
    tiled to 64 rows and one train step at 64 rows, both on B2's bf16 forms
    with the grouped bias ('layer1'; the train step's bias gradient on the
    packed-row attention's bf16 backward), each within GAP_FACTOR times the
    JAX package's own bf16 error (the loss's over the golden's seeds)."""
    import importlib.util

    from vision_transformers_tpu_torch.train.trainer import full_precision_products

    full_precision_products()  # as the training entry point sets the products
    spec = importlib.util.spec_from_file_location("make_torch_port_swin_bf16_golden",
                                                  SWIN_BF16_GOLDEN_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # numpy at import; the port's side imports no JAX
    vit = mod.vit_golden()
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    seed = int(g["seed"])
    model = vit.port_model(seed, DEVICE, mod.CONF)
    ftl, ftlb, pa, pab = ("fused_transformer_layer", "fused_transformer_layer_bwd",
                          "packed_attention", "packed_attention_bwd")
    fwd = {ftl: 24, ftl + "[bf16]": 24, ftl + "+bias[bf16]": 24, pa + "[bf16]": 24,
           pa + "+bias[bf16]": 24}
    before = counts()
    logits = vit.port_logits(seed, DEVICE, GOLDEN_ROWS, "layer1", model, mod.CONF)
    torch.cuda.synchronize()
    expect_path(before, counts(), fwd, f"Swin-S bf16 golden, {GOLDEN_ROWS} rows on layer1")
    err, lim = vit.check_logits(logits, g, "layer1")
    log(f"golden: Swin-S bf16 logits, {GOLDEN_ROWS} rows via {ftl} (bf16, the grouped bias): "
        f"max|port - JAX bf16| {err:.4e} (limit {vit.GAP_FACTOR} x JAX's bf16 gap = {lim:.4e})")
    before = counts()
    ours = vit.port_train(seed, DEVICE, GOLDEN_ROWS, "layer1", model, mod.CONF, mod.FULL_KEYS)
    torch.cuda.synchronize()
    expect_path(before, counts(), {**fwd, ftlb: 24, ftlb + "[bf16]": 24,
                                   ftlb + "+bias[bf16]": 24, pab + "[bf16]": 24,
                                   pab + "+bias[bf16]": 24, pab + "+dbias[bf16]": 24},
                f"Swin-S bf16 golden train step, {GOLDEN_ROWS} rows")
    checks = vit.check_train(ours, g, mod.FULL_KEYS, mod.loss_gap(g))
    log(f"golden: Swin-S bf16 train step, {GOLDEN_ROWS} rows via {ftl} (bf16) forward and "
        f"backward: loss {float(ours['loss_port']):.6f} (JAX bf16 "
        f"{float(g['loss_bf16']):.6f}, f32 {float(g['loss_f32']):.6f}); error (limit) "
        + ", ".join(f"{k} {e:.3e} ({lim:.3e})" for k, (e, lim) in checks.items()))


HALO_BF16_GOLDEN_SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_halo_bf16_golden.py")


def halo_bf16_golden(torch):
    """Halo-S in bf16 (seeded weights, DropPath off) against
    tests/data/halo_s_bf16_port_golden.npz: the golden's two images' logits
    tiled to 64 rows and one train step at 64 rows, both on B4's bf16 forms
    (the default 'layer' dispatch), each within GAP_FACTOR times the JAX
    package's own bf16 error (the loss's over the golden's seeds)."""
    import importlib.util

    from vision_transformers_tpu_torch.train.trainer import full_precision_products

    full_precision_products()  # as the training entry point sets the products
    spec = importlib.util.spec_from_file_location("make_torch_port_halo_bf16_golden",
                                                  HALO_BF16_GOLDEN_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # numpy at import; the port's side imports no JAX
    vit = mod.vit_golden()
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    seed = int(g["seed"])
    model = mod.port_model(seed, DEVICE)
    fhl, fhlb = "fused_halo_layer", "fused_halo_layer_bwd"
    fwd = {fhl: 12, fhl + "[bf16]": 12}
    before = counts()
    logits = mod.port_logits(seed, DEVICE, GOLDEN_ROWS, model)
    torch.cuda.synchronize()
    expect_path(before, counts(), fwd, f"Halo-S bf16 golden, {GOLDEN_ROWS} rows")
    err, lim = vit.check_logits(logits, g, "layer")
    log(f"golden: Halo-S bf16 logits, {GOLDEN_ROWS} rows via {fhl} (bf16): max|port - JAX "
        f"bf16| {err:.4e} (limit {vit.GAP_FACTOR} x JAX's bf16 gap = {lim:.4e})")
    before = counts()
    ours = mod.port_train(seed, DEVICE, GOLDEN_ROWS, model)
    torch.cuda.synchronize()
    expect_path(before, counts(), {**fwd, fhlb: 12, fhlb + "[bf16]": 12},
                f"Halo-S bf16 golden train step, {GOLDEN_ROWS} rows")
    checks = vit.check_train(ours, g, mod.FULL_KEYS, mod.loss_gap(g))
    log(f"golden: Halo-S bf16 train step, {GOLDEN_ROWS} rows via {fhl} (bf16) forward and "
        f"backward: loss {float(ours['loss_port']):.6f} (JAX bf16 "
        f"{float(g['loss_bf16']):.6f}, f32 {float(g['loss_f32']):.6f}); error (limit) "
        + ", ".join(f"{k} {e:.3e} ({lim:.3e})" for k, (e, lim) in checks.items()))


DINO_BF16_GOLDEN_SCRIPT = os.path.join(ROOT, "scripts", "make_torch_port_dino_bf16_golden.py")


def dino_bf16_golden(torch):
    """One DINO step of DeiT-S/16 at the conf's default precision, bf16, on
    the golden's 3 images under the 'layer' force (B1's bf16 form in every
    layer: the teacher's globals serving, the student's globals and, with
    the block mask, its 8 packed local rows, forward and backward) against
    tests/data/dino_deit_s16_bf16_port_golden.npz
    (scripts/make_torch_port_dino_bf16_golden.py): the loss's 54
    cross-entropies, each tensor's gradient norm and projection, both nets'
    per-crop output norms and projections, each vector within GAP_FACTOR
    times the JAX package's own bf16-against-f32 gap at the golden's seed,
    the loss and the gradient norm within GAP_FACTOR times the root mean
    square of JAX's gaps over the golden's six seeds; the products set as
    the training entry points set them."""
    import importlib.util

    from vision_transformers_tpu_torch.train.trainer import full_precision_products

    spec = importlib.util.spec_from_file_location("make_torch_port_dino_bf16_golden",
                                                  DINO_BF16_GOLDEN_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # numpy at import; the port's step imports no JAX
    with np.load(mod.GOLDEN) as f:
        g = {k: f[k] for k in f.files}
    fal, falb = "fused_attention_layer", "fused_attention_layer_bwd"
    pa, pab = "packed_attention", "packed_attention_bwd"
    expected = {fal: 36, fal + "+bias": 12, falb: 24, falb + "+bias": 12,
                fal + "[bf16]": 36, fal + "+bias[bf16]": 12, falb + "[bf16]": 24,
                falb + "+bias[bf16]": 12, pa + "[bf16]": 36, pa + "+bias[bf16]": 12,
                pab + "[bf16]": 24, pab + "+bias[bf16]": 12}
    full_precision_products()
    before = counts()
    with forced(attn="layer"):
        ours = mod.port_bf16_step(int(g["seed"]), DEVICE)
    torch.cuda.synchronize()
    expect_path(before, counts(), expected, "golden DINO bf16")
    errors = mod.check(ours, g)
    log(f"golden: DINO DeiT-S/16 bf16 step, depth 12, {len(g['student_norms_bf16'])} student "
        f"and {len(g['teacher_norms_bf16'])} teacher crops via B1's bf16 form (the locals "
        f"with the mask): loss {float(ours['loss']):.6f} (JAX bf16 "
        f"{float(g['loss_bf16']):.6f}, f32 {float(g['loss_f32']):.6f}); error (limit "
        f"{mod.GAP_FACTOR} x JAX's bf16 gap; the scalars' gaps over "
        f"{len(g['gap_seeds'])} seeds) " + ", ".join(
            f"{k} {e:.3e} ({lim:.3e})" for k, (e, lim) in errors.items()))


# ---------------------------------------------------------------------------
# 5. predict end to end (the serving path)
# ---------------------------------------------------------------------------


def check_lines(lines, files, topk):
    if len(lines) != len(files):
        raise RuntimeError(f"predict: {len(lines)} lines for {len(files)} images")
    for line, path in zip(lines, files):
        entry = json.loads(line)
        probs = [t["prob"] for t in entry["topk"]]
        if entry["file"] != path or len(probs) != topk \
                or not all(0.0 < p <= 1.0 for p in probs) or sum(probs) > 1.0 + 1e-4:
            raise RuntimeError(f"predict: bad line {line}")


def write_jpegs(directory, images):
    """Seeded uint8 images as JPEGs of a few widths; returns the paths."""
    from PIL import Image

    files = []
    for i, img in enumerate(images):
        path = os.path.join(directory, f"img{i:03d}.jpg")
        Image.fromarray(img[:, : 200 + (i % 5) * 20]).save(path, quality=90)
        files.append(path)
    return files


def predict_main_path(torch, has_pil, model_name, cases, sra=None):
    """``cases``: (images, the launches of each counter in one forward of
    that many images); ``sra`` forces the reduced-kv path."""
    from vision_transformers_tpu_torch import predict
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf, _, _, _ = MODELS[model_name]
    seed = 7
    full, sd, model = seeded_model(torch, conf, seed)
    size = image_size(full)
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        ckpt = os.path.join(tmp, "ckpt.pt")
        torch.save({"ema": sd}, ckpt)
        noise = seeded_images(seed, 160, 256)
        files = write_jpegs(tmp, noise) if has_pil else []
        if not has_pil:
            log("predict: PIL does not import on this machine, so JPEG decode is "
                "not exercised; predict_batch runs on the seeded uint8 images")
        reset_counts()  # the main path's run starts here
        for n, expected in cases:
            before = counts()
            t0 = time.perf_counter()
            if has_pil:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), forced(sra=sra):
                    predict.main(["--conf", conf, "--checkpoint", f"{ckpt}:ema",
                                  "--topk", "5", "--device", DEVICE, *files[:n]])
                secs = time.perf_counter() - t0
                check_lines(buf.getvalue().splitlines(), files[:n], 5)
            else:
                with forced(sra=sra):
                    _, top, prob = predict.predict_batch(model, noise[:n, :size, :size], 5,
                                                         DEVICE)
                secs = time.perf_counter() - t0
                if not ((prob > 0) & (prob <= 1)).all() or (prob.sum(-1) > 1 + 1e-4).any():
                    raise RuntimeError("predict: bad probabilities")
            expect_path(before, counts(), expected, f"predict {model_name} {n} images")
            log(f"predict: {model_name}, {n} images through "
                f"{'predict.main (JPEG decode, checkpoint load, forward)' if has_pil else 'predict_batch'}"
                f" in {secs:.3f} s = {n / secs:.1f} images/s end to end, via "
                f"{path_label(expected, sra)}")
        launches = counts()  # read just after the main path's run
        off = (256 - size) // 2
        batch = noise[:, off:off + size, off:off + size]
        for n, _ in cases:
            with forced(sra=sra):
                predict.predict_batch(model, batch[:n], 5, DEVICE)  # warm-up
                t0 = time.perf_counter()
                reps = 5
                for _ in range(reps):
                    predict.predict_batch(model, batch[:n], 5, DEVICE)
                secs = (time.perf_counter() - t0) / reps
            log(f"predict: {model_name} predict_batch steady state, {n} uint8 images "
                f"(host→device, forward, top-k back): {secs * 1e3:.2f} ms = "
                f"{n / secs:.1f} images/s")
    for _, expected in cases:
        for kernel in expected:
            if launches[kernel] == 0:
                raise RuntimeError(f"predict: {kernel} was not launched on the serving path")
    log(f"predict: {model_name} launches on the serving path {launches}")
    return launches


# ---------------------------------------------------------------------------
# 6. the trainer end to end (the slices' main paths)
# ---------------------------------------------------------------------------


def train_main_path(torch, has_pil, model_name, expected, overrides=(), halo=None,
                    sra=None, ff=None, attn=None, env=None, precision="f32", steady_out=None,
                    predict_expected=None):
    """``train.main`` at batch 128 for one synthetic epoch, with conf
    ``overrides``, ``halo`` / ``sra`` / ``attn`` forcing a Halo / reduced-kv
    / attention path, ``ff`` the FF kernel and ``env`` environment variables
    set (the dispatch's forces); ``expected`` the launches of each counter
    on that run.  ``precision`` "f32" overrides the conf's; None leaves the
    conf's default (bf16).  With ``predict_expected`` predict serves the
    checkpoint at the trainer's precision (``--precision conf``), its
    launches held to ``predict_expected``; else at f32.  Returns the
    launches; puts the steady-state seconds a step and the peak bytes in
    the dict ``steady_out`` if given."""
    from vision_transformers_tpu_torch import predict, train
    from vision_transformers_tpu_torch.config.schema import load_config
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.train import engine
    from vision_transformers_tpu_torch.utils.weights import seeded_images

    conf_path = MODELS[model_name][0]
    conf = load_config(conf_path, list(overrides))
    label = model_name + "".join(f" ({name} {v})" for name, v in (
        ("halo", halo), ("sra", sra), ("attention", attn), ("FF kernel", ff)) if v) + "".join(
        f" {o}" for o in overrides if not o.startswith("arch.drop_path")) + "".join(
        f" ({k}={v})" for k, v in (env or {}).items())
    step_secs = []
    train_step = engine.train_step

    def timed_step(*args, **kwargs):  # per-step wall time, ended by a sync
        t0 = time.perf_counter()
        out = train_step(*args, **kwargs)
        torch.cuda.synchronize()
        step_secs.append(time.perf_counter() - t0)
        return out

    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        args = ["--conf", conf_path, "--device", DEVICE,
                *([f"precision={precision}"] if precision else []),
                "training.dataloader.batch_size=128", "training.epoch=1",
                "data_backend=synthetic", "log_freq=1", *overrides,
                f"checker.storage=[{{type: local, path: {tmp}}}]"]
        engine.train_step = timed_step
        torch.cuda.reset_peak_memory_stats()
        # torch's default, as a user's process starts: the entry sets its own
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        try:
            with forced(halo, sra, attn, ff), environ(env or {}):
                reset_counts()  # the main path's run starts here
                t0 = time.perf_counter()
                metrics = train.main(args)
                secs = time.perf_counter() - t0
                launches = counts()  # read just after the main path's run
        finally:
            engine.train_step = train_step
        peak = torch.cuda.max_memory_allocated()
        if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
            raise RuntimeError(f"trainer {label}: the entry left bf16 products reducing in bf16")
        want = {k: expected.get(k, 0) for k in launches}
        if launches != want:
            raise RuntimeError(f"trainer {label}: expected launches {want}, "
                               f"counted {launches}")
        if not all(np.isfinite(metrics[k]) for k in ("loss", "valid_loss")):
            raise RuntimeError(f"trainer: non-finite metrics {metrics}")
        ckpt = os.path.join(tmp, "epoch-001.pt")
        if not os.path.isfile(ckpt):
            raise RuntimeError("trainer: no epoch-001.pt")
        steady = np.mean(step_secs[1:])
        dtype = precision or f"{conf.precision} (the conf's default)"
        log(f"trainer: 1 epoch of {label} {dtype} ({len(step_secs)} steps x 128 images, "
            f"grad_accumulation {conf.training.grad_accumulation}, drop_path "
            f"{conf.arch.drop_path}, valid 256 images) in {secs:.2f} s: loss "
            f"{metrics['loss']:.5f}, valid_loss {metrics['valid_loss']:.5f}, prec1 "
            f"{metrics['prec1']:.3f}; trainer images/s {metrics['images_per_sec']:.1f}; "
            f"steps " + ", ".join(f"{t * 1e3:.1f}" for t in step_secs) + " ms; steady "
            f"state (steps 2-{len(step_secs)}) {steady * 1e3:.2f} ms/step = "
            f"{128 / steady:.1f} images/s; max_memory_allocated {peak / 2**30:.2f} GiB")
        log(f"trainer: {label} launches on the main path {launches}")
        # the epoch checkpoint serves (with predict_expected at the trainer's
        # precision)
        noise = seeded_images(11, 48, 256)
        serve_conf = predict_expected is not None
        before = counts()
        if has_pil:
            files = write_jpegs(tmp, noise)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), forced(halo, sra, attn, ff), \
                    environ(env or {}):
                predict.main(["--conf", conf_path, "--checkpoint", f"{ckpt}:model",
                              "--topk", "5", "--device", DEVICE, *files,
                              *(["--precision", "conf"] if serve_conf else []),
                              *(o for o in overrides if o.startswith("arch."))])
            check_lines(buf.getvalue().splitlines(), files, 5)
        else:
            from vision_transformers_tpu_torch.train.trainer import compute_dtype
            from vision_transformers_tpu_torch.utils.weights import load_checkpoint

            model = conf.arch.make(dtype=compute_dtype(conf)) if serve_conf else \
                conf.arch.make()
            model.load_state_dict(load_checkpoint(f"{ckpt}:model"), strict=True)
            size = image_size(conf)
            with forced(halo, sra, attn, ff), environ(env or {}):
                _, _, prob = predict.predict_batch(model.to(DEVICE).eval(),
                                                   noise[:, :size, :size], 5, DEVICE)
            if not ((prob > 0) & (prob <= 1)).all():
                raise RuntimeError("trainer: bad probabilities from the checkpoint")
        if predict_expected is not None:
            expect_path(before, counts(), predict_expected, f"predict {label}")
        log(f"trainer: predict read {label}'s epoch-001.pt:model and classified "
            f"48 images at {conf.precision if serve_conf else 'f32'}")
    if steady_out is not None:
        steady_out.update(seconds=float(steady), peak=peak)
    return launches


def vit_trainers(torch, has_pil):
    """6 (ViT-S/16): the trainer at f32 and at the conf's default precision,
    bf16 — the same launches, every one of the bf16 run on the bf16 forms —
    and the two steady-state steps, images/s and peak memory side by side.
    Returns (f32 launches, bf16 launches)."""
    fal, falb, ftl = "fused_attention_layer", "fused_attention_layer_bwd", \
        "fused_transformer_layer"
    # 4 steps x 12 layers; the valid pass: 2 batches x 12
    expected = {fal: 48, falb: 48, ftl: 24}
    f32_run, bf16_run = {}, {}
    f32 = train_main_path(torch, has_pil, "ViT-S/16", expected, steady_out=f32_run)
    # ... and the attention of each bf16 call on the packed-row core's bf16 form
    bf16 = train_main_path(torch, has_pil, "ViT-S/16",
                           {**expected, **{k + "[bf16]": v for k, v in expected.items()},
                            "packed_attention[bf16]": 48 + 24,
                            "packed_attention_bwd[bf16]": 48},
                           precision=None, steady_out=bf16_run)
    (f32_s, f32_peak), (bf_s, bf_peak) = f32_run.values(), bf16_run.values()
    log(f"trainer: ViT-S/16 at 128 images, steady state in this run: f32 {f32_s * 1e3:.2f} "
        f"ms/step = {128 / f32_s:.1f} images/s, max_memory_allocated "
        f"{f32_peak / 2**30:.2f} GiB; bf16 (the conf's default) {bf_s * 1e3:.2f} ms/step = "
        f"{128 / bf_s:.1f} images/s, max_memory_allocated {bf_peak / 2**30:.2f} GiB")
    return f32, bf16


def swin_trainers(torch, has_pil):
    """6 (Swin-S): the trainer at f32 and at the conf's default precision,
    bf16 — the same launches (4 steps x 2 micro-batches x 24 layers; the
    valid pass 2 x 24), every one of the bf16 run on B2's bf16 forms with
    the grouped bias, its attention's backward summing the bias's gradient
    — and the two steady-state steps, images/s and peak memory side by
    side.  Returns (f32 launches, bf16 launches)."""
    ftl, ftlb = "fused_transformer_layer", "fused_transformer_layer_bwd"
    expected = {ftl: 24 * 2 * 4 + 24 * 2, ftlb: 24 * 2 * 4}
    f32_run, bf16_run = {}, {}
    f32 = train_main_path(torch, has_pil, "Swin-S", expected, steady_out=f32_run)
    bf16 = train_main_path(
        torch, has_pil, "Swin-S",
        {**expected, **{k + s: v for k, v in expected.items() for s in ("[bf16]", "+bias[bf16]")},
         "packed_attention[bf16]": expected[ftl], "packed_attention+bias[bf16]": expected[ftl],
         **{"packed_attention_bwd" + s: expected[ftlb]
            for s in ("[bf16]", "+bias[bf16]", "+dbias[bf16]")}},
        precision=None, steady_out=bf16_run)
    (f32_s, f32_peak), (bf_s, bf_peak) = f32_run.values(), bf16_run.values()
    log(f"trainer: Swin-S at 128 images (2 micro-batches of 64), steady state in this run: "
        f"f32 {f32_s * 1e3:.2f} ms/step = {128 / f32_s:.1f} images/s, max_memory_allocated "
        f"{f32_peak / 2**30:.2f} GiB; bf16 (the conf's default) {bf_s * 1e3:.2f} ms/step = "
        f"{128 / bf_s:.1f} images/s, max_memory_allocated {bf_peak / 2**30:.2f} GiB")
    return f32, bf16


def halo_trainers(torch, has_pil):
    """6 (Halo-S): the trainer at f32 and at the conf's default precision,
    bf16, on the default dispatch ('layer') — the same launches (4 steps x
    12 layers; the valid pass 2 x 12), every one of the bf16 run on B4's
    bf16 forms, predict serving the bf16 run's checkpoint through B4's bf16
    forward (48 images: 12 launches) — with the two steady-state steps,
    images/s and peak memory side by side; then the bf16 run forced to
    'direct' (B5a's bf16 forms between the projections).  Returns (f32
    launches, bf16 launches, bf16 'direct' launches)."""
    fhl, fhlb = "fused_halo_layer", "fused_halo_layer_bwd"
    had, hadb = "halo_attention_direct", "halo_attention_direct_bwd"
    dp = ("arch.drop_path=0.1",)
    expected = {fhl: 12 * 4 + 12 * 2, fhlb: 12 * 4}
    bf16_of = lambda e: {**e, **{k + "[bf16]": v for k, v in e.items()}}  # noqa: E731
    f32_run, bf16_run = {}, {}
    f32 = train_main_path(torch, has_pil, "Halo-S", expected, dp, steady_out=f32_run)
    bf16 = train_main_path(torch, has_pil, "Halo-S", bf16_of(expected), dp, precision=None,
                           steady_out=bf16_run, predict_expected=bf16_of({fhl: 12}))
    (f32_s, f32_peak), (bf_s, bf_peak) = f32_run.values(), bf16_run.values()
    log(f"trainer: Halo-S at 128 images, steady state in this run: f32 {f32_s * 1e3:.2f} "
        f"ms/step = {128 / f32_s:.1f} images/s, max_memory_allocated "
        f"{f32_peak / 2**30:.2f} GiB; bf16 (the conf's default) {bf_s * 1e3:.2f} ms/step = "
        f"{128 / bf_s:.1f} images/s, max_memory_allocated {bf_peak / 2**30:.2f} GiB")
    direct = train_main_path(torch, has_pil, "Halo-S",
                             bf16_of({had: 12 * 4 + 12 * 2, hadb: 12 * 4}), dp, "direct",
                             precision=None, predict_expected=bf16_of({had: 12}))
    return f32, bf16, direct


# DINO at 96 images a step (the conf's 1024 cut: 768 locals pack 3 to a row),
# 2 epochs of 4 synthetic steps, epoch 0 with the last layer frozen
DINO_BATCH, DINO_EPOCHS = 96, 2


def dino_train_main_path(torch, precision="f32", steady_out=None):
    """``train_dino.main`` from configs/dino_deit-s-16.conf at 96 images a
    step for two synthetic epochs (4 steps each; the last layer frozen in
    the first), DropPath 0.1 on the student, at ``precision`` (f32, or
    None: the conf's own, bf16): per step and layer, the student takes B1 on
    its 192 global rows (per-sample row scales) and, with the mask, on its
    256 packed local rows (token-level scales applied outside), forward and
    backward, and the teacher the whole-layer kernel B2 on its 192 global
    rows (forward only); at bf16 every one of them on the bf16 forms.  The
    counters are zeroed just before and read just after; the loss must be
    finite and the epoch checkpoint hold both nets, in f32.  Logs the
    steady-state step time; ``steady_out`` takes it and the peak memory."""
    from vision_transformers_tpu_torch import train_dino
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.train import dino
    from vision_transformers_tpu_torch.utils.weights import load_dino_checkpoint

    steps = 4 * DINO_EPOCHS
    fal, falb, ftl = "fused_attention_layer", "fused_attention_layer_bwd", \
        "fused_transformer_layer"
    expected = {fal: 24 * steps, fal + "+bias": 12 * steps, falb: 24 * steps,
                falb + "+bias": 12 * steps, ftl: 12 * steps}
    if precision is None:  # the same launches, each on its bf16 form
        expected.update({k + "[bf16]": v for k, v in expected.items()})
        expected.update({"packed_attention[bf16]": 36 * steps,
                         "packed_attention+bias[bf16]": 12 * steps,
                         "packed_attention_bwd[bf16]": 24 * steps,
                         "packed_attention_bwd+bias[bf16]": 12 * steps})
    label = "f32" if precision else "bf16 (the conf's default)"
    step_secs = []
    make_step = dino.make_dino_train_step

    def timed_make_step(*args, **kwargs):  # per-step wall time, ended by a sync
        optimizer, step = make_step(*args, **kwargs)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            step_secs.append(time.perf_counter() - t0)
            return out
        return optimizer, timed

    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        args = ["--conf", DINO_CONF, "--device", DEVICE,
                *([f"precision={precision}"] if precision else []),
                f"training.dataloader.batch_size={DINO_BATCH}",
                f"training.epoch={DINO_EPOCHS}", "log_freq=1",
                f"checker.storage=[{{type: local, path: {tmp}}}]"]
        dino.make_dino_train_step = timed_make_step
        torch.cuda.reset_peak_memory_stats()
        # torch's default, as a user's process starts: the entry sets its own
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
        try:
            reset_counts()  # the main path's run starts here
            t0 = time.perf_counter()
            metrics = train_dino.main(args)
            secs = time.perf_counter() - t0
            launches = counts()  # read just after the main path's run
        finally:
            dino.make_dino_train_step = make_step
        peak = torch.cuda.max_memory_allocated()
        if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
            raise RuntimeError("trainer DINO: the entry left bf16 products reducing in bf16")
        want = {k: expected.get(k, 0) for k in launches}
        if launches != want:
            raise RuntimeError(f"trainer DINO: expected launches {want}, counted {launches}")
        if not np.isfinite(metrics["loss"]):
            raise RuntimeError(f"trainer DINO: non-finite metrics {metrics}")
        student, teacher = load_dino_checkpoint(os.path.join(tmp, f"epoch-{DINO_EPOCHS:03d}.pt"))
        if teacher is None or not all(torch.isfinite(v).all() for v in student.values()):
            raise RuntimeError("trainer DINO: the epoch checkpoint lacks a net")
        if not all(v.dtype == torch.float32 for net in (student, teacher)
                   for v in net.values()):
            raise RuntimeError("trainer DINO: the checkpoint's nets are not f32")
    steady = float(np.mean(step_secs[1:]))
    if steady_out is not None:
        steady_out.update(seconds=steady, peak=peak)
    log(f"trainer: {DINO_EPOCHS} epochs of DINO DeiT-S/16 {label} ({len(step_secs)} steps x "
        f"{DINO_BATCH} images: 2 x 224 + 8 x 96 crops each, the locals packed 3 to a row; "
        f"student_drop_path 0.1; epoch 0 with the last layer frozen) in {secs:.2f} s: loss "
        f"{metrics['loss']:.5f}; trainer images/s {metrics['images_per_sec']:.1f}; steps "
        + ", ".join(f"{t * 1e3:.1f}" for t in step_secs) + " ms; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"trainer: DINO {label} steady state (steps 2-{len(step_secs)}): "
        f"{steady * 1e3:.2f} ms/step = {DINO_BATCH / steady:.1f} images/s")
    log(f"trainer: DINO {label} launches on the main path {launches}")
    return launches


def dino_trainers(torch):
    """6 (DINO): the trainer at f32 and at the conf's default precision,
    bf16 — the same launches, every one of the bf16 run on the bf16 forms —
    and the two steady-state steps, images/s and peak memory side by side.
    Returns (f32 launches, bf16 launches)."""
    f32_run, bf16_run = {}, {}
    f32 = dino_train_main_path(torch, "f32", f32_run)
    bf16 = dino_train_main_path(torch, None, bf16_run)
    (f32_s, f32_peak), (bf_s, bf_peak) = f32_run.values(), bf16_run.values()
    log(f"trainer: DINO DeiT-S/16 at {DINO_BATCH} images, steady state in this run: f32 "
        f"{f32_s * 1e3:.2f} ms/step = {DINO_BATCH / f32_s:.1f} images/s, max_memory_allocated "
        f"{f32_peak / 2**30:.2f} GiB; bf16 (the conf's default) {bf_s * 1e3:.2f} ms/step = "
        f"{DINO_BATCH / bf_s:.1f} images/s, max_memory_allocated {bf_peak / 2**30:.2f} GiB")
    return f32, bf16


def main() -> None:
    import torch

    t_start = time.perf_counter()
    phase_secs = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_secs[name] = time.perf_counter() - t0
        return out

    name, _, has_pil = phase("1 probe", probe, torch)
    phase("2 build", build)
    phase("3m GEMM core", gemm_kernels, torch)
    timed = phase("3 kernels", kernels, torch)
    attn_fwd, attn_bwd = phase("3b attention layer", backward_kernel, torch)
    l1_fwd, l1_bwd = phase("3b whole layer", swin_backward_kernel, torch)
    # the record times each kernel at a call its trainer (phase 6) makes
    timed["fused_attention_layer"].insert(0, attn_fwd)
    timed["fused_attention_layer_bwd"] = [attn_bwd]
    timed["fused_transformer_layer"] = l1_fwd + timed["fused_transformer_layer"]
    timed["fused_transformer_layer_bwd"] = l1_bwd
    halo_timed = phase("3h halo", halo_kernels, torch)
    hl_fwd, hl_bwd, hd_fwd, hd_bwd = phase("3hb halo", halo_backward_kernels, torch)
    timed["fused_halo_layer"] = hl_fwd + halo_timed["fused_halo_layer"]
    timed["fused_halo_layer_bwd"] = hl_bwd
    timed["halo_attention_direct"] = halo_timed["halo_attention_direct"] + hd_fwd
    timed["halo_attention_direct_bwd"] = hd_bwd
    tw_fwd, tw_bwd = phase("3b attention layer + mask", twins_layer_kernels, torch)
    timed["fused_attention_layer"] += tw_fwd
    timed["fused_attention_layer_bwd"] += tw_bwd
    dino_fwd, dino_bwd = phase("3d attention layer + DINO mask", dino_layer_kernels, torch)
    timed["fused_attention_layer+bias"] = [dino_fwd]
    timed["fused_attention_layer_bwd+bias"] = [dino_bwd]
    timed["fused_attention_layer+bias[bf16]"], timed["fused_attention_layer_bwd+bias[bf16]"] = (
        [r] for r in phase("3d attention layer + DINO mask, bf16", dino_bf16_layer_kernels,
                           torch))
    timed["fused_attention"], timed["fused_attention_bwd"] = phase(
        "3s reduced-kv", sra_kernels, torch)
    timed["fused_attention_qkv"], timed["fused_attention_qkv_bwd"] = phase(
        "3q packed-qkv attention", qkv_kernels, torch)
    timed["fused_ff_layer"], timed["fused_ff_layer_bwd"] = phase(
        "3f FF layer", ff_kernels, torch)
    timed["halo_attention"], timed["halo_attention_bwd"] = phase(
        "3g gathered halo attention", gather_kernels, torch)
    timed["fused_attention_block"], timed["fused_attention_block_bwd"] = phase(
        "3k attention block", block_kernels, torch)
    timed["fused_swin_layer"], timed["fused_swin_layer_bwd"] = phase(
        "3w map-resident Swin layer", swin_map_kernels, torch)
    phase("3a window attention", window_kernels, torch)
    timed.update(phase("3bf bf16 forms", bf16_kernels, torch))
    (timed["fused_transformer_layer+bias[bf16]"], timed["fused_transformer_layer_bwd+bias[bf16]"],
     timed["packed_attention_bwd+dbias[bf16]"]) = phase("3bf Swin-S bf16", swin_bf16_kernels,
                                                        torch)
    timed.update(phase("3hbf Halo-S bf16", halo_bf16_kernels, torch))
    fal, falb = "fused_attention_layer", "fused_attention_layer_bwd"
    ftl, ftlb = "fused_transformer_layer", "fused_transformer_layer_bwd"
    fhl, fhlb = "fused_halo_layer", "fused_halo_layer_bwd"
    had, hadb = "halo_attention_direct", "halo_attention_direct_bwd"
    fa, fab = "fused_attention", "fused_attention_bwd"
    qkv, qkvb = "fused_attention_qkv", "fused_attention_qkv_bwd"
    ffl, fflb = "fused_ff_layer", "fused_ff_layer_bwd"
    hg, hgb = "halo_attention", "halo_attention_bwd"
    blk, blkb = "fused_attention_block", "fused_attention_block_bwd"
    fsl, fslb = "fused_swin_layer", "fused_swin_layer_bwd"

    def depth(model, *kernels):  # one launch of each kernel per layer
        return {k: MODELS[model][3] for k in kernels}

    # Twins-SVT-S: the attention layer in all 18 layers, with the pair mask
    # in the 14 of stages 1-3; fused GSA adds the reduced-kv kernel in all 18
    twins = {fal: 18, fal + "+bias": 14}
    twins_bwd = {falb: 18, falb + "+bias": 14}
    twins_gsa, twins_gsa_bwd = {**twins, fa: 18}, {**twins_bwd, fab: 18}
    pvt, pvt_bwd = depth("PVT-S", fa), depth("PVT-S", fab)
    phase("4 golden ViT", golden, torch, "ViT-S/16",
          ((64, depth("ViT-S/16", fal)), (256, depth("ViT-S/16", ftl))))
    phase("4 golden Swin", golden, torch, "Swin-S",
          ((64, depth("Swin-S", ftl)), (128, depth("Swin-S", ftl))))
    phase("4 golden Halo", golden, torch, "Halo-S",
          ((64, depth("Halo-S", fhl)), (128, depth("Halo-S", fhl))))
    phase("4 golden PVT fused", golden, torch, "PVT-S", ((64, pvt), (128, pvt)), "fused")
    phase("4 golden Twins", golden, torch, "Twins-SVT-S", ((64, twins), (128, twins)))
    phase("4 golden Twins fused", golden, torch, "Twins-SVT-S",
          ((64, twins_gsa), (128, twins_gsa)), "fused")
    phase("4 golden Halo gather", golden, torch, "Halo-S",
          ((64, depth("Halo-S", hg)), (128, depth("Halo-S", hg))), None, "gather")
    phase("4 golden ViT block", golden, torch, "ViT-S/16", ((64, depth("ViT-S/16", blk)),),
          None, None, "block")
    phase("4 golden Swin block", golden, torch, "Swin-S", ((64, depth("Swin-S", blk)),),
          None, None, "block")
    phase("4 golden Swin swin", golden, torch, "Swin-S", ((64, depth("Swin-S", fsl)),),
          None, None, "swin")
    phase("4d golden DINO", dino_golden, torch)
    phase("4bf golden ViT bf16", bf16_golden, torch)
    phase("4bf golden DINO bf16", dino_bf16_golden, torch)
    phase("4bf golden Swin-S bf16", swin_bf16_golden, torch)
    phase("4hbf golden Halo-S bf16", halo_bf16_golden, torch)
    phase("4b train ViT", train_golden, torch, "ViT-S/16", depth("ViT-S/16", fal, falb))
    phase("4b train Swin", train_golden, torch, "Swin-S", depth("Swin-S", ftl, ftlb))
    phase("4b train Halo", train_golden, torch, "Halo-S", depth("Halo-S", fhl, fhlb))
    phase("4b train Halo direct", train_golden, torch, "Halo-S", depth("Halo-S", had, hadb),
          "direct")
    phase("4b train PVT fused", train_golden, torch, "PVT-S", {**pvt, **pvt_bwd}, None,
          "fused")
    phase("4b train Twins", train_golden, torch, "Twins-SVT-S", {**twins, **twins_bwd})
    phase("4b train Twins fused", train_golden, torch, "Twins-SVT-S",
          {**twins_gsa, **twins_gsa_bwd}, None, "fused")
    phase("4b train ViT dropout fused", train_golden, torch, "ViT-S/16",
          depth("ViT-S/16", qkv, qkvb), None, None, "fused", None, True)
    phase("4b train ViT FF kernel", train_golden, torch, "ViT-S/16",
          depth("ViT-S/16", fal, falb, ffl, fflb), None, None, None, True)
    phase("4b train Swin fused", train_golden, torch, "Swin-S", depth("Swin-S", qkv, qkvb),
          None, None, "fused")
    phase("4b train Halo gather", train_golden, torch, "Halo-S", depth("Halo-S", hg, hgb),
          "gather")
    phase("4b train ViT block", train_golden, torch, "ViT-S/16",
          depth("ViT-S/16", blk, blkb), None, None, "block")
    phase("4b train Swin block", train_golden, torch, "Swin-S", depth("Swin-S", blk, blkb),
          None, None, "block")
    phase("4b train ViT dropout block", train_golden, torch, "ViT-S/16",
          depth("ViT-S/16", blk, blkb), None, None, "block", None, True)
    phase("4b train Swin swin", train_golden, torch, "Swin-S", depth("Swin-S", fsl, fslb),
          None, None, "swin")
    halo_dp = ("arch.drop_path=0.1",)
    paths = {
        "ViT-S/16 predict": phase("5 predict ViT", predict_main_path, torch, has_pil,
                                  "ViT-S/16", ((48, depth("ViT-S/16", fal)),
                                               (160, depth("ViT-S/16", ftl)))),
        "Swin-S predict": phase("5 predict Swin", predict_main_path, torch, has_pil,
                                "Swin-S", ((48, depth("Swin-S", ftl)),
                                           (160, depth("Swin-S", ftl)))),
        "Halo-S predict": phase("5 predict Halo", predict_main_path, torch, has_pil,
                                "Halo-S", ((48, depth("Halo-S", fhl)),)),
        "PVT-S predict": phase("5 predict PVT fused", predict_main_path, torch, has_pil,
                               "PVT-S", ((48, pvt),), "fused"),
        "Twins-SVT-S predict": phase("5 predict Twins", predict_main_path, torch, has_pil,
                                     "Twins-SVT-S", ((48, twins),)),
        # ViT-S/16 at f32 and at the conf's default precision, bf16: the
        # same launches (4 steps x 12 layers; the valid pass: 2 batches x
        # 12), every one of the bf16 run on the bf16 forms
        **dict(zip(("ViT-S/16 train", "ViT-S/16 train (bf16)"), phase(
            "6 trainer ViT f32 + bf16", vit_trainers, torch, has_pil))),
        # Swin-S at f32 and at the conf's default precision, bf16: 4 steps x
        # 2 micro-batches x 24 layers; the valid pass: 2 x 24
        **dict(zip(("Swin-S train", "Swin-S train (bf16)"), phase(
            "6 trainer Swin f32 + bf16", swin_trainers, torch, has_pil))),
        # Halo-S at f32 and at the conf's default precision, bf16: 4 steps x
        # 12 layers (12 forward and 12 backward per step); the valid pass: 2
        # batches x 12; the bf16 run's every launch on B4's bf16 forms; then
        # bf16 forced to 'direct' (B5a's bf16 forms)
        **dict(zip(("Halo-S train", "Halo-S train (bf16)", "Halo-S train (direct, bf16)"),
                   phase("6 trainer Halo f32 + bf16", halo_trainers, torch, has_pil))),
        "Halo-S train (direct)": phase(
            "6 trainer Halo direct", train_main_path, torch, has_pil, "Halo-S",
            {had: 12 * 4 + 12 * 2, hadb: 12 * 4}, halo_dp, "direct"),
        # 4 steps (16 forward and 16 backward per step); the valid pass: 2 x 16
        "PVT-S train (sra fused)": phase(
            "6 trainer PVT fused", train_main_path, torch, has_pil, "PVT-S",
            {**scaled_counts(pvt, 4 + 2), **scaled_counts(pvt_bwd, 4)}, (), None, "fused"),
        # 4 steps x 18 layers, the mask in 14; the valid pass: 2 x 18
        "Twins-SVT-S train": phase(
            "6 trainer Twins", train_main_path, torch, has_pil, "Twins-SVT-S",
            {**scaled_counts(twins, 4 + 2), **scaled_counts(twins_bwd, 4)}, halo_dp),
        # dropout: 4 steps x 12 layers of the packed-qkv attention; the valid
        # pass (no dropout in eval): 2 batches x 12 whole layers
        "ViT-S/16 train (dropout)": phase(
            "6 trainer ViT dropout", train_main_path, torch, has_pil, "ViT-S/16",
            {qkv: 48, qkvb: 48, ftl: 24}, ("arch.dropout=0.1", "arch.drop_ff=0.1")),
        # the FF kernel: 4 steps x 12 layers of both halves; the valid pass
        # as above
        "ViT-S/16 train (FF kernel)": phase(
            "6 trainer ViT FF kernel", train_main_path, torch, has_pil, "ViT-S/16",
            {fal: 48, falb: 48, ffl: 48, fflb: 48, ftl: 24}, (), None, None, True),
        # the gathered halo attention forced, at the conf's precision, bf16:
        # 4 steps x 12 layers; the valid pass: 2 batches x 12; every launch on
        # B5b's bf16 forms
        "Halo-S train (gather, bf16)": phase(
            "6 trainer Halo gather bf16", train_main_path, torch, has_pil, "Halo-S",
            {hg: 12 * 4 + 12 * 2, hgb: 12 * 4, hg + "[bf16]": 12 * 4 + 12 * 2,
             hgb + "[bf16]": 12 * 4}, halo_dp, "gather", None, None, None, None, None, None,
            {hg: 12, hg + "[bf16]": 12}),
        # window 4, halo 3, no force: the default dispatch takes the gathered
        # kernel in all 12 layers
        "Halo-S train (window 4, halo 3)": phase(
            "6 trainer Halo w4 h3", train_main_path, torch, has_pil, "Halo-S",
            {hg: 12 * 4 + 12 * 2, hgb: 12 * 4},
            ("arch.window_size=4", "arch.halo_size=3") + halo_dp),
        # the attention block forced, in training and eval: 4 steps x 12
        # layers; the valid pass: 2 batches x 12
        "ViT-S/16 train (block)": phase(
            "6 trainer ViT block", train_main_path, torch, has_pil, "ViT-S/16",
            {blk: 48 + 24, blkb: 48}, (), None, None, None, "block"),
        "ViT-S/16 train (block, dropout)": phase(
            "6 trainer ViT block dropout", train_main_path, torch, has_pil, "ViT-S/16",
            {blk: 48 + 24, blkb: 48}, ("arch.dropout=0.1", "arch.drop_ff=0.1"), None, None,
            None, "block"),
        # the map-resident layer, forced through the environment: 4 steps x
        # 2 micro-batches x 24 layers; the valid pass: 2 batches x 24
        "Swin-S train (swin)": phase(
            "6 trainer Swin swin", train_main_path, torch, has_pil, "Swin-S",
            {fsl: 24 * 2 * 4 + 24 * 2, fslb: 24 * 2 * 4}, (), None, None, None, None,
            {"VTX_ATTN_IMPL": "swin"}),
        # dropout: training on the two residual branches with einsum
        # attention; the valid pass (no dropout in eval): 2 x 24 whole layers
        "Swin-S train (dropout)": phase(
            "6 trainer Swin dropout", train_main_path, torch, has_pil, "Swin-S",
            {ftl: 24 * 2}, ("arch.drop_attn=0.1", "arch.drop_ff=0.1")),
        # DINO at f32 and at the conf's default precision, bf16: 8 steps x
        # 12 layers of B1 on the student's globals and, with the mask, on
        # its packed locals, forward and backward, and of B2 on the
        # teacher's globals; the bf16 run's every launch on the bf16 forms
        **dict(zip(("DINO train", "DINO train (bf16)"), phase(
            "6 trainer DINO f32 + bf16", dino_trainers, torch))),
    }
    trainer_of = {fal: "ViT-S/16 train", falb: "ViT-S/16 train",
                  ftl: "Swin-S train", ftlb: "Swin-S train",
                  fhl: "Halo-S train", fhlb: "Halo-S train",
                  had: "Halo-S train (direct)", hadb: "Halo-S train (direct)",
                  fa: "PVT-S train (sra fused)", fab: "PVT-S train (sra fused)",
                  qkv: "ViT-S/16 train (dropout)", qkvb: "ViT-S/16 train (dropout)",
                  ffl: "ViT-S/16 train (FF kernel)", fflb: "ViT-S/16 train (FF kernel)",
                  hg: "Halo-S train (window 4, halo 3)",
                  hgb: "Halo-S train (window 4, halo 3)",
                  blk: "ViT-S/16 train (block)", blkb: "ViT-S/16 train (block)",
                  fsl: "Swin-S train (swin)", fslb: "Swin-S train (swin)",
                  fal + "+bias": "DINO train", falb + "+bias": "DINO train",
                  fal + "[bf16]": "ViT-S/16 train (bf16)",
                  falb + "[bf16]": "ViT-S/16 train (bf16)",
                  ftl + "[bf16]": "ViT-S/16 train (bf16)",
                  "packed_attention[bf16]": "ViT-S/16 train (bf16)",
                  "packed_attention_bwd[bf16]": "ViT-S/16 train (bf16)",
                  fal + "+bias[bf16]": "DINO train (bf16)",
                  falb + "+bias[bf16]": "DINO train (bf16)",
                  "packed_attention+bias[bf16]": "DINO train (bf16)",
                  "packed_attention_bwd+bias[bf16]": "DINO train (bf16)",
                  ftl + "+bias[bf16]": "Swin-S train (bf16)",
                  ftlb + "+bias[bf16]": "Swin-S train (bf16)",
                  "packed_attention_bwd+dbias[bf16]": "Swin-S train (bf16)",
                  fhl + "[bf16]": "Halo-S train (bf16)", fhlb + "[bf16]": "Halo-S train (bf16)",
                  had + "[bf16]": "Halo-S train (direct, bf16)",
                  hadb + "[bf16]": "Halo-S train (direct, bf16)",
                  hg + "[bf16]": "Halo-S train (gather, bf16)",
                  hgb + "[bf16]": "Halo-S train (gather, bf16)"}
    # the bf16 layers run the GEMM core's bf16 form (its TMA kernels as
    # built) and the packed-row attention's (its kernels as built)
    from vision_transformers_tpu_torch.ops import _build
    tma_kernels = gemm_bf16_builds(_build.BUILD_LOG)
    attention_kernels = attention_bf16_builds(_build.BUILD_LOG)
    halo_kernels_built = halo_bf16_builds(_build.BUILD_LOG)

    def builds(k):
        if k.startswith("packed_attention"):
            return {"attention_bf16_kernels": attention_kernels}
        if k.startswith("halo_attention") and k.endswith("[bf16]"):
            return {"halo_bf16_kernels": halo_kernels_built}
        if k.startswith("fused_halo_layer") and k.endswith("[bf16]"):
            return {"gemm_bf16_kernels": tma_kernels, "halo_bf16_kernels": halo_kernels_built}
        return {"gemm_bf16_kernels": tma_kernels} if k.endswith("[bf16]") else {}

    record = {"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": rep,
         "launches": paths[trainer_of[k]][k],
         "launches_by_path": {p: c[k] for p, c in paths.items()},
         **timed[k][0], "other_shapes": timed[k][1:], **builds(k)}
        for k, (src, rep) in KERNELS.items()]}
    # a bound is the least time the card could take: no kernel beats it
    shares = {f"{k} {e['shape']}": e["bound_ms"] / e["ms"] for k in KERNELS
              for e in timed[k]}
    worst = max(shares, key=shares.get)
    log(f"bounds: the largest share of its bound a kernel reached: "
        f"{100 * shares[worst]:.1f}% ({worst})")
    if shares[worst] > 1:
        raise RuntimeError(f"bounds: {worst} ran faster than its bound")
    log("phases (s): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_secs.items()))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
