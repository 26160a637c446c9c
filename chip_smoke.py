#!/usr/bin/env python3
"""On-card smoke of the PyTorch port (``incubator_mxnet_tpu_torch``).

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises, prints its traceback and exits non-zero):

1. device — require CUDA; print the card's name and power limit and the
   TF32 flags (both set off: float32 stays float32);
2. build — compile every kernel from ``incubator_mxnet_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once);
3. kernels — each kernel against its plain PyTorch version on the card
   at the main paths' shapes (and, for the row kernels 3-4 and 8-9, at
   ragged widths, a width past 16384 and a row with -inf entries; for
   flash attention, kernel 5 and its dk/dv and dq kernels, at one row,
   cross lengths, ragged tiles, T = 1025, head widths 16 to 128 (40 and
   72 among them), B·H = 1 and a q whose rows the bfloat16 kernels
   load element by element, in both dtypes; then two forward and two
   backward runs at the path's shape bit for bit, and the kernels by
   dtype: float32-FMA for float32, tensor-core for bfloat16; the fused
   1x1's forward, dx and weight gradient (kernels 10-12) and the fused
   3x3's forward, dx and weight gradient (13, 14 and 16) by dtype too,
   every one a tensor-core tile, bf16 for bfloat16 and 3xTF32 for
   float32, each also where it loads rows element by element, and two
   runs bit for bit, as two runs of the LayerNorm and RMSNorm
   backwards; the LayerNorm forward also with float32 gamma and beta on
   bfloat16 x, and both row kernels also where x starts off 16 bytes,
   with the kernels of their wrappers' calls by the profiler's names),
   with the stated tolerances, and its time beside the plain version's, one
   PyTorch library call's and the bound (the fused kernels' in both
   dtypes);
4. BERT-base at full width in process — one forward at B=8, T=128 on
   the card against the same weights on the CPU through the port's
   plain path, and the LayerNorm launch count of that forward;
5. serve — export, ``InferenceServer`` on an ephemeral port with
   buckets 1,2,4,8, 8 HTTP predictions (3 in turn, 5 at once) each
   checked against a direct ``Predictor`` call;
6. train BERT-base at full width (MLM + NSP, Adam) — (a) one step with
   dropout 0 on the card against the same step through the port's CPU
   path (B=4, T=128): the loss, every gradient, the update of every
   weight whose gradient is large, and every weight after the update; (b) 10 steps with dropout 0.1 through ``Trainer.step`` at
   B=16, T=128, whose loss must be finite and fall, with exactly 25
   LayerNorm forward and backward and 2 cross-entropy forward and
   backward launches a step; the median step time; one step profiled
   by kernel family; (c) 3 steps of the model converted to bfloat16 by
   ``amp.convert_block``, as ``examples/train_bert.py --amp`` builds
   it, whose losses must be finite, with the same launches a step, and
   whose LayerNorm and cross-entropy kernels must run their bfloat16
   instances, by the profiler's kernel names;
7. train ResNet-50 v1 (NHWC, fused bottleneck, float32, SGD with
   momentum) — (a) one step at B=4, 224x224, 1000 classes on the card
   against the same step on the CPU: the loss, the logits, every moving
   statistic and every gradient, at a tolerance set above the CPU path's
   own response to a 1e-6 move of its input (measured and printed
   first); and one full-width bottleneck of each kind (stage-1 identity,
   stage-2 projection), every gradient at 1e-4 of its largest value;
   (b) 10 steps of ``examples/train_resnet_fused.py``'s loop at B=128,
   whose loss must be finite and drop below the first step's, with
   exactly 36 launches of each fused matmul + BatchNorm kernel, 16 of
   each fused 3x3 conv + BatchNorm kernel and one of each cross-entropy
   kernel a step; the median step time, img/s, the peak device memory
   and one step profiled by kernel family;
8. the bench path (``incubator_mxnet_tpu_torch.bench``: ResNet-50 v1
   NHWC fused, bfloat16 by AMP, ``FusedTrainStep`` SGD lr 0.1 momentum
   0.9 wd 1e-4, one CUDA graph per batch shape) — (a) float32 at B=8
   with cuDNN deterministic: 4 calls of the step (an eager warm-up that
   captures the graph, then 3 replays) against 4 eager runs of the same
   step code from the same weights: every loss, parameter, moving
   statistic and momentum; (b) bfloat16 at B=128: the launches of one
   eager step (36/36/36, 16/16/16, 1/1) and the capture's count equal
   to them, 2 warm-up and 10 timed replayed steps whose loss must be
   finite and fall below the first step's, the median step time, img/s,
   ``mfu_pct`` and the peak device memory, and one replay profiled by
   kernel family;
9. train the TransformerLM (``models/transformer.py``, attention
   "gspmd", SGD lr 1e-3) — (a) one float32 step at full width (vocab
   32000, d_model 512, 8 heads, 4 layers) at B=2, T=129 on the card
   against the same step on the CPU: the loss and every gradient;
   (b) the default config (bfloat16) at B=32, T=1025: one step with
   exactly 4 / 4 / 9 / 9 / 1 / 1 launches of the softmax forward and
   backward, the RMSNorm forward and backward and the cross-entropy
   forward and backward kernels, then (c) 10 more steps on fresh tokens,
   every loss finite and the first within 0.5 of ln 32000; the median
   step time, tokens/s, the peak device memory and one step profiled by
   kernel family;
10. train the TransformerLM with ``attention="flash"`` — the same three
   parts: (a) the float32 step at B=2, T=129, card against CPU; (b) one
   bfloat16 step at B=32, T=1025 with exactly 4 / 4 / 4 launches of the
   flash forward, dk/dv and dq kernels, 0 / 0 of the softmax kernels and
   9 / 9 / 1 / 1 of RMSNorm and cross-entropy; (c) 10 more steps, every
   loss finite and the first within 0.5 of ln 32000, with the median
   step time, tokens/s, peak memory and one step profiled by family;
11. run-time-compiled CUDA C (``rtc.CudaModule``, NVRTC to a cubin,
   ``cuLaunchKernel``; kernel row 17) — user kernels compiled and
   launched as reference MXNet's rtc is used: an ``extern "C"`` saxpy
   at n = 2^26 + 3 on the current stream and on a side stream, a
   template through ``exports`` for float and ``__half``, a block sum
   with 64 KiB of dynamic shared memory on a ragged length and an
   ``int64_t`` scalar; each against its plain version, then a syntax
   error, a CPU tensor, a wrong dtype, a wrong argument count, a
   non-contiguous tensor and a mangled name without exports, each of
   which must raise, and ``PallasModule`` kernels on the card against
   the CPU; saxpy's time beside its bound, its plain version and
   ``torch.add``, and the host time of one launch;
12. LeNet (``examples/train_mnist.py``'s network at full size, float32)
   — (a) one Adam step on the card against the same step on the CPU,
   the card's layers deferred and given the CPU model's weights by
   ``params_from_jax``; (b) the script's loop, 2 epochs of 128 steps at
   B=64 on its synthetic data, with exactly one launch of each
   cross-entropy kernel a step and every loss finite, the median step
   time, samples/s and 5 steps profiled by kernel family; (c) 60 Adam
   steps on one fixed batch, whose loss must fall from about ln 10 to
   below 1.0 and whose training accuracy must pass 0.9;
13. the kernels line (JSON), then the last line
   ``{"ok": true, "device": {...}}``.

Each main path runs with the launch counters set to 0 just before it
and read just after: serving from phase 4 to the end of phase 5,
BERT training over phase 6 (b) and (c), ResNet training over phase 7
(b), the
bench path over phase 8 (b)'s warm-up and timed steps, the
TransformerLM over phase 9 (b) and (c) and, with flash attention, over
phase 10 (b) and (c), the user kernels over phase 11's compiles and
launches, and LeNet over phase 12 (b).  A graph replay
launches the captured kernels without passing through their wrappers,
so on the bench path the counters hold the eager warm-up step and the
capture.  The kernels line gives each kernel's launches summed over the
paths it ran on; kernels 10-14 and 16 have an entry for each instance,
the float32 3xTF32 tensor-core tile (``..._tf32``) with phase 7's
launches and the bfloat16 tensor-core tile (``..._mma``) with phase
8's.
"""
import copy
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

B, T = 8, 128
BUCKETS = [1, 2, 4, 8]
VALID = [128, 100, 77, 64, 33, 16, 5, 1]
HIDDEN = 768
# training: BERT-base at B=16, T=128 (2048 tokens a step)
TRAIN_B, TRAIN_B_CPU, TRAIN_STEPS = 16, 4, 10
AMP_STEPS = 3   # phase 6 (c): BERT-base converted to bfloat16
ROWS = TRAIN_B * T
# the LayerNorm forward at the serving shapes, then the training step's
LN_SHAPES = [((B * T // 8, HIDDEN), "float32"),
             ((B * T // 4, HIDDEN), "float32"),
             ((B * T // 2, HIDDEN), "float32"),
             ((B * T, HIDDEN), "float32"),
             ((B * T, HIDDEN), "bfloat16"),
             ((ROWS, HIDDEN), "float32"),
             ((ROWS, HIDDEN), "bfloat16"),
             ((1000, 100), "float32"),
             ((3, 4096), "bfloat16")]
# kernel 1's other instances, (shape, x dtype, gamma/beta dtype, offset of
# x in elements): float32 gamma and beta on bfloat16 x, as amp keeps them
# on BERT's bf16 path; a width that fills part of a lane's last chunks; a
# bf16 width that is no multiple of a chunk and x one element past a
# 16-byte boundary, which both load element by element
LN_VARIANTS = [((B * T, HIDDEN), "bfloat16", "float32", 0),
               ((ROWS, HIDDEN), "bfloat16", "float32", 0),
               ((64, 1000), "float32", "float32", 0),
               ((64, 1000), "bfloat16", "bfloat16", 0),
               ((64, 770), "bfloat16", "bfloat16", 0),
               ((64, HIDDEN), "float32", "float32", 1),
               ((64, HIDDEN), "bfloat16", "float32", 1)]
LN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # on y; stats always 1e-5
STAT_TOL = 1e-5

VOCAB = 30522
# Adam at 1e-4, not examples/train_bert.py's default 1e-3: that default
# is tuned for the script's 128-unit model, not for BERT-base.
LR = 1e-4
LN_BWD_SHAPES = [((ROWS, HIDDEN), "float32"), ((ROWS, HIDDEN), "bfloat16"),
                 ((1000, 100), "float32"), ((3, 4096), "bfloat16")]
# dx: float32 1e-5 (sums in another order), bfloat16 2e-2 (one bf16 ulp
# at |dx| ~ 2); dgamma/dbeta: float32 sums over all rows, 1e-5 of the
# largest value
LN_BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_TOL = 1e-5
# the MLM and NSP shapes of the training steps in both dtypes (phase 6's
# float32 run and its bfloat16 pass (c)), then ragged shapes
XENT_SHAPES = [((ROWS, VOCAB), "float32"), ((ROWS, VOCAB), "bfloat16"),
               ((TRAIN_B, 2), "float32"), ((TRAIN_B, 2), "bfloat16"),
               ((1000, 100), "float32"), ((3, 16385), "float32")]
# loss and lse: float32 in both versions, 1e-5; dx: float32 rtol 1e-5,
# atol 1e-6 (one float32 ulp of a row's logsumexp, about 15 here, moves
# exp(x - lse) by about 1e-6 of itself), bfloat16 rtol 8e-3 (one bf16
# ulp of each element, at most 2^-7 of it), atol 1e-6 (entries near 0)
XENT_LOSS_TOL = 1e-5
XENT_DX_TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
               "bfloat16": dict(rtol=8e-3, atol=1e-6)}
# card step vs CPU step: each gradient max|d| <= 1e-3 * max|g| of that
# tensor (float32 sums over 12 layers in another order; the served
# forward agreed to about 3e-5 of its largest value)
GRAD_TOL = 1e-3
# and the update each makes, w_after - w_before, within 1e-2 * lr on
# every element whose gradient is above 1e-2 * max|g| of its tensor:
# a first Adam step there is lr * g / (|g| + 3.2e-7), which the
# gradients' agreement pins to far better than 1e-2 * lr, while a
# skipped, halved or uncorrected update is off by 0.5 * lr or more
UPDATE_TOL = 1e-2

# ResNet-50 v1 training: B=128 (bench.py's first batch), 224x224, 1000
# classes; the card-vs-CPU step at B=4
RESNET_B, RESNET_B_CPU, RESNET_STEPS, IMAGE, CLASSES = 128, 4, 10, 224, 1000
# fused matmul + BN (kernels 10-12) against their plain versions, each
# output's max |kernel - plain| over the largest |plain| of that tensor:
# float32 1e-5 (the same products summed in another order); bfloat16
# 2e-2 (y, dx, dw rounded to bf16: an f32 sum in another order lands one
# bf16 ulp, 2^-8 of a value, away).  The column sums s1, s2, dscale and
# dbias are float32 sums over M rows; held to the same share of their
# largest value, the allowance grows with M as they do.
FMM_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the shapes of the JAX package's tests/test_fused_block.py and its
# ragged one, each with and without the prologue
FMM_TEST_SHAPES = [(256, 128, 128), (200, 96, 72), (1024, 256, 64),
                   (512, 64, 256)]
# the representative launch: stage 1's c3 at B=128, with the prologue
FMM_REP = (RESNET_B * 56 * 56, 64, 256, True)
# the tensor-core tiles of kernels 10, 11 and 12 in both dtypes
# (fused_matmul_bn_{fwd,dx,dw}_mma and _tf32) also at shapes whose rows
# they must load element by element (K or N not a multiple of 8 in
# bfloat16, of 4 in float32), and where dx's columns take several tiles,
# the last ragged, and the forward's K streams in steps, the last
# ragged
FMM_ELEMENT_SHAPES = [(1000, 60, 100), (77, 9, 130), (33, 200, 40)]
FP32_PEAK = 67e12      # FLOP/s of float32 FMA outside the tensor cores
BF16_PEAK = 989e12     # dense bf16 tensor-core FLOP/s
TF32_PEAK = 495e12     # dense tf32 tensor-core FLOP/s
# every float32 tile of kernels 10-16 multiplies on the tensor cores in
# three tf32 products, so its bound counts three times 2*M*K*N
# operations at TF32_PEAK
TF32_PRODUCTS = 3
# card step vs CPU step, ResNet-50 at B=4.  ResNet-50's float32
# forward and backward at a tiny batch amplify rounding: moving the
# input by 1e-6 (a few ulps) moves the CPU path's own logits by about
# 4e-5 of their largest value and each gradient tensor by about 2-3 % of
# its norm (up to 15 % of its largest element), measured at 224x224,
# B=4 (the JAX package's tests/test_fused_block.py reports the same for
# its plain path).  Card and CPU round differently at every operation,
# so they can agree no better.  The script measures that response first
# and requires each bound to sit above it: loss 1e-5 relative; logits
# and moving statistics max|d| <= RESNET_FWD_TOL * max|ref| with the
# CPU's own response at most a tenth of it; each gradient
# ||d|| <= RESNET_GRAD_TOL * ||g|| with the CPU's own worst response at
# most a quarter of it.  The sharp checks are the kernels' (phase 3) and
# the full-width bottlenecks' below.
RESNET_FWD_TOL = 1e-3
RESNET_GRAD_TOL = 0.25
# the fused 3x3 conv + BN (kernels 13-16) against their plain versions at
# FMM_TOL, for the same reasons: at the JAX package's
# tests/test_fused_conv.py shapes (N, H, W, C, C_out), each with and
# without the prologue, and its multi-N-block geometry (C_out 260, the
# TPU's kernel 15)
CONV_TEST_SHAPES = [(2, 8, 8, 16, 24), (3, 6, 6, 16, 16), (2, 14, 14, 32, 16),
                    (2, 5, 9, 16, 8), (16, 6, 6, 16, 260)]
# the representative launch: stage 1's 3x3 at B=128, with the prologue
CONV_REP = (RESNET_B, IMAGE // 4, IMAGE // 4, 64, 64)
# the tensor-core tiles of kernels 13, 14 and 16 in both dtypes
# (fused_conv3_bn_{fwd,dx,dw}_mma and _tf32) also at shapes whose rows
# they must load element by element (C or C_out not a multiple of 8 in
# bfloat16, of 4 in float32), where an image row takes several segments
# (W > 62), and, for the forward and dx, where C > 64 and C_out > 64
# take several chunks of channels and tiles
CONV_ELEMENT_SHAPES = [(2, 5, 9, 12, 20), (2, 7, 7, 5, 64),
                       (1, 3, 130, 8, 8), (1, 2, 70, 72, 24),
                       (2, 6, 6, 80, 200)]
# the bench path: (a) graph replay against the eager step, float32, B=8,
# one warm-up call and 3 replays; every loss, parameter, moving statistic
# and momentum within GRAPH_TOL of the largest |eager| value of its
# tensor.  Both run the same kernels on the same inputs in the same
# order (cuDNN deterministic), so they should agree bit for bit; the
# bound leaves room for one float32 rounding of a step's largest values.
GRAPH_B, GRAPH_CALLS, GRAPH_TOL = 8, 4, 1e-6
# (b) bench.py's configuration at B=128: 2 warm-up steps, 10 timed
BENCH_B, BENCH_WARMUP, BENCH_STEPS = 128, 2, 10
# one bottleneck, card vs CPU: output and moving statistics 1e-5, every
# gradient 1e-4 of its largest value (BN over 12,544 or 3,136 rows is
# well conditioned), or twice the CPU path's own response to a 1e-6 move
# of the input where that is larger: one element of bn2's ReLU mask sits
# at the edge in the stage-1 block, and a move of that size flips it and
# moves the 3x3's weight gradient by 2.3e-3 of its largest value in the
# CPU path itself (measured on the CPU with the parent's 3x3 as well)
BLOCK_TOL, BLOCK_GRAD_TOL = 1e-5, 1e-4
# the TransformerLM (phase 9): TransformerConfig() (vocab 32000, d_model
# 512, 8 heads, 4 layers, d_ff 2048, bfloat16) at B=32, T=1025, the JAX
# example's full size; the card-vs-CPU step in float32 at B=2, T=129
TF_B, TF_T, TF_STEPS, TF_VOCAB, TF_D, TF_H = 32, 1025, 10, 32000, 512, 8
TF_B_CPU, TF_T_CPU = 2, 129
# kernels 3-4 at the attention rows (B·H·T, T), float32, and 8-9 at the
# RMSNorm rows (B·T, D), bfloat16; then ragged widths and one past the
# TPU kernels' 16384, a few rows each, in both dtypes
SM_PATH = (TF_B * TF_H * (TF_T - 1), TF_T - 1)
RMS_PATH = (TF_B * (TF_T - 1), TF_D)
ROW_WIDTHS = [1, 7, 300, 1000, 1024, 16385]
# kernels 8-9's other instances, (rows, cols, x dtype, gamma dtype,
# offset of x in elements): BERT's width in both dtypes, a width that is
# no multiple of a chunk (element loads), float32 gamma on bfloat16 x
# (dgamma in float32) and x one element past a 16-byte boundary
RMS_VARIANTS = [(64, 768, "float32", "float32", 0),
                (64, 768, "bfloat16", "bfloat16", 0),
                (64, 1001, "float32", "float32", 0),
                (64, 1001, "bfloat16", "bfloat16", 0),
                (4096, TF_D, "bfloat16", "float32", 0),
                (64, TF_D, "float32", "float32", 1),
                (64, TF_D, "bfloat16", "bfloat16", 1)]
# kernel against plain version, each output: float32 max|d| <= 1e-6 of
# the largest |plain| value (the same float32 arithmetic, sums in
# another order); bfloat16 within one bf16 ulp of each value (the same
# float32 value rounded once may land on a neighbouring bf16 value)
# plus that float32 allowance.  RMSNorm's dx is a difference of two
# terms that cancel (at width 1 all but eps/x² of them), so its float32
# allowance is 1e-6 of the largest term, max|rrms·g·gamma|
ROW_TOL = 1e-6
# card step vs CPU step, float32, TF32 off: loss 1e-5 relative, every
# gradient max|d| <= 1e-4 of its tensor's largest value
TF_LOSS_TOL, TF_GRAD_TOL = 1e-5, 1e-4
# flash attention (kernel 5 and its dk/dv and dq kernels, phase 3) at the
# TransformerLM's attention, (B, H, T, D) = (32, 8, 1024, 64) causal,
# then ragged cases (B, H, Tq, Tk, D, causal[, pad]): one row; cross
# lengths; ragged tiles; the model's T = 1025; every head width class;
# B·H = 1; D = 40 and 72 (multiples of 8, not of 16); a q whose rows sit
# pad = 3 elements further apart than the model's, so that the bfloat16
# kernels load it element by element
FLASH_PATH = (TF_B, TF_H, TF_T - 1, TF_T - 1, TF_D // TF_H, True)
FLASH_CASES = [(2, 2, 1, 1, 64, True), (2, 3, 70, 150, 32, False),
               (2, 3, 200, 200, 64, True), (1, 4, 1025, 1025, 64, True),
               (2, 2, 300, 300, 16, True), (2, 2, 300, 300, 32, False),
               (2, 2, 300, 300, 128, True), (1, 1, 129, 129, 64, False),
               (2, 2, 300, 300, 40, True), (2, 2, 300, 300, 72, False),
               (2, 2, 300, 300, 64, True, 3)]
# each output against its plain version on the same inputs (the
# backward's from the kernel's own float32 output and lse): float32
# max|d| <= 1e-5 of the largest |plain| value (the same float32 products,
# summed in another order over up to 1025 keys); dq and dk at 1e-5 of
# the size of the two terms whose difference ds = p·(dp − delta)·scale is,
# scale·max|delta|·max|k| (|q| for dk), where that is larger: with one
# key they cancel exactly and dq, dk are rounding noise; bfloat16 within
# one bf16 ulp of each value (2^-8 of it) plus that allowance
FLASH_TOL = 1e-5
# run-time-compiled CUDA C (phase 11, kernel row 17): the user's saxpy,
# y = alpha·x + y in place, at n = 2^26 + 3 float32 with a grid-stride
# loop.  NVRTC contracts alpha·x + y into one FMA (one rounding), so the
# kernel is held to the plain version computed in float64 and rounded
# once to float32: within one float32 ulp of each value (the two differ
# only where rounding twice, through float64, lands on the other
# neighbour).  The __half axpy may round the product and the sum apart:
# one half ulp of each value plus one of alpha·x.  The block sums (64 KiB
# of shared memory a block) against torch.sum over the same blocks:
# 1e-5 of each block's sum of |x| (float32 sums of 16384 terms in another
# order; the worst case of the kernel's order is about 4.3e-6)
RTC_N, RTC_ALPHA = 2 ** 26 + 3, 1.7
RTC_CHUNK = 16384                       # floats a block: 64 KiB
RTC_SUM_N = 37 * RTC_CHUNK + 1234       # ragged: the last block is short
RTC_SUM_TOL = 1e-5
RTC_SAXPY = r"""
extern "C" __global__ void saxpy(const float *x, float *y, float alpha,
                                 int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        y[i] = alpha * x[i] + y[i];
}
"""
RTC_AXPY = r"""
#include <cuda_fp16.h>
template <typename T>
__global__ void axpy(const T *x, T *y, T alpha, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = alpha * x[i] + y[i];
}
"""
RTC_BLOCK_SUM = r"""
extern "C" __global__ void block_sum(const float *x, float *out, int n,
                                     int chunk) {
    extern __shared__ float buf[];
    long long base = (long long)blockIdx.x * chunk;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x)
        buf[i] = base + i < n ? x[base + i] : 0.0f;
    __syncthreads();
    float s = 0.0f;
    for (int i = threadIdx.x; i < chunk; i += blockDim.x) s += buf[i];
    __syncthreads();
    buf[threadIdx.x] = s;
    __syncthreads();
    for (int w = blockDim.x / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = buf[0];
}
"""
RTC_IOTA64 = r"""
extern "C" __global__ void iota64(long long *out, long long start, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = start + 3LL * i;
}
"""
RTC_MANGLED = "__global__ void scale(float *x) { x[threadIdx.x] *= 2.0f; }\n"
RTC_BROKEN = 'extern "C" __global__ void broken(float *x) { x[0] = 1.0f }\n'
# LeNet (phase 12): examples/train_mnist.py's network and loop at full
# size (28x28, B=64, Adam lr 3e-3); (a) one step card vs CPU, float32
# with TF32 off: loss 1e-5 relative, every gradient max|d| <= 1e-4 of its
# tensor's largest value (the same float32 convolutions and products
# summed in another order), updates and weights as phase 6's;
# (b) the script's 2 epochs of 8192 samples (128 steps each); (c) 60
# steps on one fixed batch, the overfit drive: the loss from about
# ln 10 to below 1.0, training accuracy above 0.9
MNIST_B, MNIST_LR, MNIST_N, MNIST_EPOCHS = 64, 3e-3, 8192, 2
MNIST_GRAD_TOL = 1e-4
OVERFIT_STEPS, OVERFIT_LOSS, OVERFIT_ACC = 60, 1.0, 0.9


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def memory_rate(name):
    """Device-memory bytes/s of the SKU, from its published data sheet."""
    if "H200" in name:
        return 4.8e12, "H200: 4.8 TB/s"
    if "NVL" in name:
        return 3.9e12, "H100 NVL: 3.9 TB/s"
    if "PCIe" in name:
        return 2.0e12, "H100 PCIe: 2.0 TB/s"
    return 3.35e12, "H100 SXM5: 3.35 TB/s"


def time_ms(torch, fn, argsets, iters=200, warmup=20):
    """``(device_ms, stream_ms)`` per call of ``fn`` over ``iters`` calls,
    cycling through ``argsets`` (enough distinct inputs that reads miss
    L2).  ``device_ms`` sums the durations of the kernels (and copies)
    the calls ran, from the profiler's device trace; ``stream_ms`` is
    CUDA-event time from first to last call, host gaps included.
    ``device_ms`` is None if the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(*argsets[i % len(argsets)])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    end.record()
    torch.cuda.synchronize()
    stream_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    return (device_us / 1e3 / iters if device_us else None), stream_ms


def offset_copy(torch, a, offset):
    """``a`` copied into a buffer at ``offset`` elements past its start:
    contiguous, but no longer on 16 bytes for an odd offset."""
    if not offset:
        return a
    buf = torch.empty(a.numel() + offset, dtype=a.dtype, device=a.device)
    return buf[offset:].view(a.shape).copy_(a)


def ln_inputs(torch, shape, dtype, seed, device, pdtype=None, offset=0):
    """``(x, gamma, beta)``: x in ``dtype`` (``offset`` elements into its
    buffer), gamma and beta in ``pdtype`` (default x's)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 2.0 + 0.5
    gamma = 1.0 + 0.1 * torch.randn(shape[-1], generator=g)
    beta = 0.1 * torch.randn(shape[-1], generator=g)
    dt = getattr(torch, dtype)
    pdt = getattr(torch, pdtype or dtype)
    return (offset_copy(torch, x.to(device, dt), offset),
            gamma.to(device, pdt), beta.to(device, pdt))


def check_layer_norm(torch, ln, dev):
    """Kernel against plain version at every shape and variant, then the
    kernels of the wrapper's calls by the profiler's names: one kernel,
    with float32 gamma and beta on bfloat16 x too (no cast).  Returns
    the max |Δy| over the main paths' float32 shapes, serving (B·T, 768)
    and training (2048, 768)."""
    path_err = 0.0
    cases = [(shape, dtype, dtype, 0) for shape, dtype in LN_SHAPES]
    for shape, dtype, pdtype, offset in cases + LN_VARIANTS:
        x, g, b = ln_inputs(torch, shape, dtype, 0, dev, pdtype, offset)
        y, mean, rstd = ln.layer_norm_fwd(x, g, b)
        ry, rmean, rrstd = ln.layer_norm_fwd_reference(x, g, b)
        torch.cuda.synchronize()
        tol = LN_TOL[dtype]
        torch.testing.assert_close(y.float(), ry.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(mean, rmean, rtol=STAT_TOL, atol=STAT_TOL)
        torch.testing.assert_close(rstd, rrstd, rtol=STAT_TOL, atol=STAT_TOL)
        err = (y.float() - ry.float()).abs().max().item()
        print(f"layer_norm {shape} {dtype}, gamma/beta {pdtype}, x offset "
              f"{offset}: max|dy|={err:.3e} "
              f"max|dmean|={(mean - rmean).abs().max().item():.3e} "
              f"max|drstd|={(rstd - rrstd).abs().max().item():.3e} "
              f"(tol {tol:g}) ok", flush=True)
        if (shape in ((B * T, HIDDEN), (ROWS, HIDDEN)) and dtype == "float32"
                and not offset):
            path_err = max(path_err, err)
    for shape, dtype, pdtype, offset in (
            ((ROWS, HIDDEN), "float32", "float32", 0),
            ((ROWS, HIDDEN), "bfloat16", "float32", 0),
            ((64, HIDDEN), "bfloat16", "float32", 1)):
        args = ln_inputs(torch, shape, dtype, 0, dev, pdtype, offset)
        names = kernel_names(torch, ln.layer_norm_fwd, args)
        print(f"layer_norm_fwd {shape} {dtype}, gamma/beta {pdtype}, x "
              f"offset {offset} runs {names}", flush=True)
        assert len(names) == 1 and "layer_norm_fwd_warp" in names[0], names
    return path_err


def report(label, times, nbytes, rate, flops=0, peak=FP32_PEAK):
    """Print the times and the bound of one kernel and return the kernels
    line's numbers: each time is the profiler's device time per call,
    or the CUDA-event stream time where the profiler saw none.  The
    bound is the larger of ``nbytes`` at the memory rate and ``flops`` at
    ``peak``; ``bound_by`` says which."""
    byte_ms, op_ms = nbytes / rate * 1e3, flops / peak * 1e3
    bound = max(byte_ms, op_ms)
    bound_by = "bytes" if byte_ms >= op_ms else "operations"
    print(f"{label}: bound_ms={bound:.6f} by {bound_by} (bytes={nbytes} -> "
          f"{byte_ms:.6f} ms; flops={flops} -> {op_ms:.6f} ms); per call, "
          "device time from the profiler trace / CUDA-event stream time:",
          flush=True)
    out = {"bound_ms": bound, "bound_by": bound_by}
    for k, (device, stream) in times.items():
        print(f"  {k}: device {device} stream {stream:.6f}", flush=True)
        if device is None:
            print(f"  {k}: profiler saw no device time; reporting CUDA-"
                  "event time", flush=True)
        out[k] = device if device is not None else stream
    return out


def time_layer_norm(torch, ln, dev, dtype, rate, rows=B * T, pdtype=None):
    """Times at ``rows`` rows of BERT's width (the serving shape by
    default) with gamma and beta in ``pdtype`` (default x's), cycling at
    least 24 input sets and 72 MiB of x so that the reads come from
    device memory, not L2.  The library call gets gamma and beta cast to
    x's dtype before it is timed (the same function)."""
    import torch.nn.functional as F
    cols = HIDDEN
    pdtype = pdtype or dtype
    esize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    n_sets = max(24, -(-(72 << 20) // (rows * cols * esize)))
    sets = [ln_inputs(torch, (rows, cols), dtype, s, dev, pdtype)
            for s in range(n_sets)]
    lib_sets = [(x, g.to(x.dtype), b.to(x.dtype)) for x, g, b in sets]
    times = {
        "ms": time_ms(torch, ln.layer_norm_fwd, sets),
        "plain_ms": time_ms(torch, ln.layer_norm_fwd_reference, sets),
        "library_ms": time_ms(torch, lambda x, g, b: F.layer_norm(
            x, (cols,), g, b, 1e-5), lib_sets)}
    psize = sets[0][1].element_size()
    # x read, y written; gamma and beta read; mean and rstd written
    nbytes = rows * cols * 2 * esize + 2 * cols * psize + 2 * rows * 4
    return report(f"layer_norm ({rows}, {cols}) {dtype}, gamma/beta "
                  f"{pdtype}", times, nbytes, rate)


def ln_bwd_inputs(torch, ln, shape, dtype, seed, dev):
    """``(x, g, gamma, mean, rstd)``: gamma float32, as a parameter is,
    and the statistics of the plain forward."""
    x, gamma, beta = ln_inputs(torch, shape, dtype, seed, dev)
    gamma = gamma.float()
    g = (torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
         .to(dev, x.dtype))
    _, mean, rstd = ln.layer_norm_fwd_reference(x, gamma, beta)
    return x, g, gamma, mean, rstd


def check_layer_norm_bwd(torch, ln, dev):
    """Backward kernel against its plain version at every shape; returns
    the max |d dx| at the training shape, float32."""
    train_err = None
    for shape, dtype in LN_BWD_SHAPES:
        args = ln_bwd_inputs(torch, ln, shape, dtype, 0, dev)
        got = ln.layer_norm_bwd(*args)
        again = ln.layer_norm_bwd(*args)
        want = ln.layer_norm_bwd_reference(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (
            shape, dtype, "two runs differ")
        tol = LN_BWD_TOL[dtype]
        torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                                   atol=tol)
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, want)]
        for name, err, w in zip(("dgamma", "dbeta"), errs[1:], want[1:]):
            scale = w.abs().max().item()
            assert err <= PARAM_TOL * scale, (shape, dtype, name, err, scale)
        print(f"layer_norm_bwd {shape} {dtype}: max|d dx|={errs[0]:.3e} "
              f"(tol {tol:g}) max|d dgamma|={errs[1]:.3e} "
              f"max|d dbeta|={errs[2]:.3e} (tol {PARAM_TOL:g} of max); two "
              "runs bit for bit", flush=True)
        if shape == (ROWS, HIDDEN) and dtype == "float32":
            train_err = errs[0]
    return train_err


def time_layer_norm_bwd(torch, ln, dev, dtype, rate):
    """Times at the training shape (2048, 768), cycling 24 input sets
    (144 MiB of x and g in float32).  The library call is ATen's
    LayerNorm backward on the statistics of ATen's own forward."""
    rows, cols = ROWS, HIDDEN
    sets = [ln_bwd_inputs(torch, ln, (rows, cols), dtype, s, dev)
            for s in range(24)]
    lib_sets = []
    for x, g, gamma, _, _ in sets:
        gam = gamma.to(x.dtype)
        bet = torch.zeros_like(gam)
        _, m, r = torch.native_layer_norm(x, [cols], gam, bet, 1e-5)
        lib_sets.append((g, x, m, r, gam, bet))
    times = {
        "ms": time_ms(torch, ln.layer_norm_bwd, sets),
        "plain_ms": time_ms(torch, ln.layer_norm_bwd_reference, sets),
        "library_ms": time_ms(
            torch, lambda g, x, m, r, gam, bet:
            torch.ops.aten.native_layer_norm_backward(
                g, x, [cols], m, r, gam, bet, [True, True, True]),
            lib_sets)}
    esize = sets[0][0].element_size()
    # x and g read, dx written; gamma, mean and rstd read; dgamma and
    # dbeta written (float32)
    nbytes = 3 * rows * cols * esize + cols * 4 + 2 * rows * 4 + 2 * cols * 4
    return report(f"layer_norm_bwd ({rows}, {cols}) {dtype}", times, nbytes,
                  rate)


def xent_inputs(torch, shape, dtype, seed, dev):
    """``(logits, labels, g)``; labels hold -1 and C + 5 at the ends,
    which both versions clip to 0 and C - 1."""
    n, c = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 3).to(dev, getattr(torch, dtype))
    labels = torch.randint(0, c, (n,), generator=gen, dtype=torch.int32)
    labels[0] = -1
    labels[-1] = c + 5
    g = torch.randn(n, generator=gen)
    return x, labels.to(dev), g.to(dev)


def check_softmax_xent(torch, sx, dev):
    """Both kernels against their plain versions at every shape; returns
    the max |d loss| and max |d dx| at the MLM shape, float32."""
    errs_at_train = None
    for shape, dtype in XENT_SHAPES:
        x, labels, g = xent_inputs(torch, shape, dtype, 0, dev)
        loss, lse = sx.softmax_xent_fwd(x, labels)
        dx = sx.softmax_xent_bwd(x, labels, lse, g)
        rloss, rlse = sx.softmax_xent_fwd_reference(x, labels)
        rdx = sx.softmax_xent_bwd_reference(x, labels, rlse, g)
        torch.cuda.synchronize()
        tol = XENT_DX_TOL[dtype]
        for a, b in ((loss, rloss), (lse, rlse)):
            torch.testing.assert_close(a, b, rtol=XENT_LOSS_TOL,
                                       atol=XENT_LOSS_TOL)
        torch.testing.assert_close(dx.float(), rdx.float(), **tol)
        e_loss = (loss - rloss).abs().max().item()
        e_dx = (dx.float() - rdx.float()).abs().max().item()
        print(f"softmax_xent {shape} {dtype}: max|d loss|={e_loss:.3e} "
              f"max|d lse|={(lse - rlse).abs().max().item():.3e} "
              f"(tol {XENT_LOSS_TOL:g}) max|d dx|={e_dx:.3e} (tol {tol}) "
              "ok", flush=True)
        if shape == (ROWS, VOCAB) and dtype == "float32":
            errs_at_train = e_loss, e_dx
    return errs_at_train


def time_softmax_xent(torch, sx, dev, dtype, rate):
    """Times at the MLM shape (2048, 30522), cycling 3 input sets of
    250 MB each (five times L2).  The library calls are
    ``F.cross_entropy(reduction="none")`` and, for the backward, the two
    ATen ops its autograd runs (``nll_loss_backward`` and
    ``_log_softmax_backward_data``) on its saved log-probabilities."""
    import torch.nn.functional as F
    rows, cols = ROWS, VOCAB
    sets, fwd_sets, lib_sets = [], [], []
    for s in range(3):
        x, labels, g = xent_inputs(torch, (rows, cols), dtype, s, dev)
        lse = sx.softmax_xent_fwd_reference(x, labels)[1]
        sets.append((x, labels, lse, g))
        fwd_sets.append((x, labels))
        lib_sets.append((x, labels.long().clamp(0, cols - 1), g,
                         torch.log_softmax(x, 1)))
    zero = torch.zeros((), device=dev)
    fwd_times = {
        "ms": time_ms(torch, sx.softmax_xent_fwd, fwd_sets),
        "plain_ms": time_ms(torch, sx.softmax_xent_fwd_reference, fwd_sets),
        "library_ms": time_ms(torch, lambda x, lbl, g, lp: F.cross_entropy(
            x, lbl, reduction="none"), lib_sets)}
    bwd_times = {
        "ms": time_ms(torch, sx.softmax_xent_bwd, sets),
        "plain_ms": time_ms(torch, sx.softmax_xent_bwd_reference, sets),
        "library_ms": time_ms(
            torch, lambda x, lbl, g, lp:
            torch.ops.aten._log_softmax_backward_data(
                torch.ops.aten.nll_loss_backward(g, lp, lbl, None, 0, -100,
                                                 zero),
                lp, 1, x.dtype), lib_sets)}
    esize = sets[0][0].element_size()
    # forward: logits and labels read, loss and lse written; backward:
    # logits, labels, lse and g read, dx written
    fwd_bytes = rows * cols * esize + rows * 4 + 2 * rows * 4
    bwd_bytes = 2 * rows * cols * esize + 3 * rows * 4
    return (report(f"softmax_xent_fwd ({rows}, {cols}) {dtype}", fwd_times,
                   fwd_bytes, rate),
            report(f"softmax_xent_bwd ({rows}, {cols}) {dtype}", bwd_times,
                   bwd_bytes, rate))


def row_err(torch, got, want, scale=None, tol=ROW_TOL):
    """``(max|d| / scale, ok)`` of a kernel's output against its plain
    version at ``tol`` of ``scale`` (default max|want|); bfloat16 may
    differ by one bf16 ulp of each value more."""
    assert got.dtype == want.dtype and got.shape == want.shape
    bf16 = want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    if scale is None:
        scale = want.abs().max().item()
    d = (got - want).abs()
    bound = torch.full_like(want, tol * scale)
    if bf16:
        bound += torch.ldexp(torch.ones_like(want),
                             torch.frexp(want.abs())[1] - 8)
    return d.max().item() / max(scale, 1e-30), bool((d <= bound).all())


def row_cases(path):
    """``(rows, cols, dtype)``: the path's shape, then 64 rows at each of
    ROW_WIDTHS (3 past 16384), each in both dtypes."""
    return [(rows, cols, dt) for rows, cols in
            [path] + [(3 if c > 16384 else 64, c) for c in ROW_WIDTHS]
            for dt in ("float32", "bfloat16")]


def softmax_inputs(torch, rows, cols, dtype, dev, seed):
    """``(x, g)`` on the card: x ~ 3·N(0, 1) with the second half of row
    0 at -inf (what the ``length`` mask makes), g ~ N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn(rows, cols, generator=gen, device=dev) * 3).to(dt)
    x[0, max(1, cols // 2):] = float("-inf")
    return x, torch.randn(rows, cols, generator=gen, device=dev).to(dt)


def check_softmax(torch, sm, dev):
    """Kernels 3 and 4 against their plain versions at every case; returns
    the max |d y| and |d dx| at the path's shape, float32."""
    path_err = None
    for rows, cols, dtype in row_cases(SM_PATH):
        x, g = softmax_inputs(torch, rows, cols, dtype, dev, 0)
        y = sm.softmax_fwd(x)
        dx = sm.softmax_bwd(y, g)
        ry = sm.softmax_fwd_reference(x)
        rdx = sm.softmax_bwd_reference(y, g)
        torch.cuda.synchronize()
        (ey, oky), (edx, okdx) = row_err(torch, y, ry), row_err(torch, dx, rdx)
        print(f"softmax ({rows}, {cols}) {dtype}: max|d|/max|ref| y={ey:.2e} "
              f"dx={edx:.2e} (tol {ROW_TOL:g} of max"
              f"{', + 1 bf16 ulp' if dtype == 'bfloat16' else ''})",
              flush=True)
        assert oky and okdx, ((rows, cols, dtype), ey, edx)
        if (rows, cols) == SM_PATH and dtype == "float32":
            path_err = ((y.float() - ry.float()).abs().max().item(),
                        (dx.float() - rdx.float()).abs().max().item())
        del x, g, y, dx, ry, rdx
    return path_err


def time_softmax(torch, sm, dev, rate):
    """Times of kernels 3 and 4 at the attention rows (262144, 1024)
    float32, cycling 2 input sets of 1 GiB each (x; y and g for the
    backward).  The library calls are ``torch.softmax`` and
    ``torch._softmax_backward_data``."""
    rows, cols = SM_PATH
    fwd_sets, bwd_sets = [], []
    for s in range(2):
        x, g = softmax_inputs(torch, rows, cols, "float32", dev, s)
        fwd_sets.append((x,))
        bwd_sets.append((sm.softmax_fwd_reference(x), g))
    fwd = {"ms": time_ms(torch, sm.softmax_fwd, fwd_sets),
           "plain_ms": time_ms(torch, sm.softmax_fwd_reference, fwd_sets),
           "library_ms": time_ms(torch, lambda x: torch.softmax(x, -1),
                                 fwd_sets)}
    bwd = {"ms": time_ms(torch, sm.softmax_bwd, bwd_sets),
           "plain_ms": time_ms(torch, sm.softmax_bwd_reference, bwd_sets),
           "library_ms": time_ms(
               torch, lambda y, g: torch._softmax_backward_data(
                   g, y, -1, y.dtype), bwd_sets)}
    # forward: x read, y written; backward: y and g read, dx written
    n = rows * cols * 4
    out = (report(f"softmax_fwd ({rows}, {cols}) float32", fwd, 2 * n, rate),
           report(f"softmax_bwd ({rows}, {cols}) float32", bwd, 3 * n, rate))
    del fwd_sets, bwd_sets
    return out


def flash_inputs(torch, case, dtype, dev, seed):
    """``(q, k, v, g)`` on the card as the model's heads are: (B, H, T,
    D) transposed views of (B, T, H, D) tensors (q's of a (B, T, H, D +
    pad) tensor where the case gives a pad); q, k ~ 0.5·N(0, 1), v and g
    ~ N(0, 1)."""
    b, h, tq, tk, d, _ = case[:6]
    pad = case[6] if len(case) > 6 else 0
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    out = []
    for t, mul, extra in ((tq, 0.5, pad), (tk, 0.5, 0), (tk, 1.0, 0),
                          (tq, 1.0, 0)):
        x = torch.randn(b, t, h, d + extra, generator=gen, device=dev) * mul
        out.append(x.to(dt)[..., :d].transpose(1, 2))
    return out


def check_flash(torch, fa, dev):
    """Kernel 5 and its backward kernels against their plain versions at
    every case in both dtypes; returns the max |d| of o, of dk and dv,
    and of dq at the path's shape in bfloat16 (the path's dtype)."""
    path_err = None
    for case in [FLASH_PATH] + FLASH_CASES:
        causal = case[5]
        for dtype in ("float32", "bfloat16"):
            q, k, v, g = flash_inputs(torch, case, dtype, dev, 0)
            o, lse = fa.flash_fwd(q, k, v, causal=causal,
                                  out_dtype=torch.float32)
            o_low, _ = fa.flash_fwd(q, k, v, causal=causal)
            dq, dk, dv = fa.flash_bwd(q, k, v, o, lse, g, causal=causal)
            ro, rlse = fa.flash_fwd_reference(q, k, v, causal=causal,
                                              out_dtype=torch.float32)
            rdq, rdk, rdv = fa.flash_bwd_reference(q, k, v, o, lse, g,
                                                   causal=causal)
            torch.cuda.synchronize()
            # ds = p·(dp − delta)·scale: dq and dk at the size of the
            # terms that cancel (FLASH_TOL's note)
            d = case[4]
            delta = (g.float() * o).sum(-1).abs().max().item() * d ** -0.5
            errs = {name: row_err(torch, a, b, max(
                b.float().abs().max().item(), t), FLASH_TOL)
                for name, a, b, t in (
                ("o_f32", o, ro, 0.0), ("o", o_low, ro.to(q.dtype), 0.0),
                ("lse", lse, rlse, 0.0),
                ("dq", dq, rdq, delta * k.float().abs().max().item()),
                ("dk", dk, rdk, delta * q.float().abs().max().item()),
                ("dv", dv, rdv, 0.0))}
            print(f"flash_attention {case} {dtype}: max|d|/max|ref| "
                  + " ".join(f"{n}={e:.2e}" for n, (e, _) in errs.items())
                  + f" (tol {FLASH_TOL:g} of max"
                  f"{', + 1 bf16 ulp' if dtype == 'bfloat16' else ''})",
                  flush=True)
            assert all(ok for _, ok in errs.values()), (case, dtype, errs)
            assert fa._vec16(q, k, v, g) == (d % 8 == 0 and len(case) == 6)
            if case == FLASH_PATH and dtype == "bfloat16":
                # no atomics: a second run gives the same bits
                again = fa.flash_fwd(q, k, v, causal=causal,
                                     out_dtype=torch.float32)
                again_low, _ = fa.flash_fwd(q, k, v, causal=causal)
                assert all(torch.equal(a, b) for a, b in zip(
                    (o, lse, o_low), (*again, again_low))), "flash_fwd repeat"
                again = fa.flash_bwd(q, k, v, o, lse, g, causal=causal)
                assert all(torch.equal(a, b) for a, b in
                           zip((dq, dk, dv), again)), "flash_bwd repeat"
                print(f"flash_fwd, flash_bwd {case} {dtype}: a second run is "
                      "bit for bit the first", flush=True)
                del again, again_low
                path_err = tuple(
                    max((a.float() - b.float()).abs().max().item()
                        for a, b in pairs) for pairs in (
                        [(o_low, ro.to(q.dtype))],
                        [(dk, rdk), (dv, rdv)], [(dq, rdq)]))
            del q, k, v, g, o, lse, o_low, dq, dk, dv, ro, rlse, rdq, rdk, rdv
    check_flash_routes(torch, fa, dev)
    return path_err


def check_flash_routes(torch, fa, dev):
    """The forward's and the backward's kernels by dtype, from the
    profiler's trace of their calls (:func:`kernel_names`): the
    float32-FMA kernels for float32 inputs, the tensor-core kernels
    (``..._mma``) for bfloat16."""
    for dtype, mma in (("float32", False), ("bfloat16", True)):
        q, k, v, g = flash_inputs(torch, (1, 2, 100, 100, 64, True), dtype,
                                  dev, 1)
        o, lse = fa.flash_fwd(q, k, v, causal=True, out_dtype=torch.float32)
        fwd = [n for n in kernel_names(
            torch, lambda: fa.flash_fwd(q, k, v, causal=True,
                                        out_dtype=torch.float32), ())
               if "flash_" in n]
        bwd = [n for n in kernel_names(
            torch, lambda: fa.flash_bwd(q, k, v, o, lse, g, causal=True), ())
               if "flash_" in n]
        print(f"flash_fwd {dtype} runs {fwd}; flash_bwd {dtype} runs {bwd}",
              flush=True)
        for names, parts in ((fwd, ("flash_fwd",)),
                             (bwd, ("flash_bwd_dkdv", "flash_bwd_dq"))):
            assert len(names) == len(parts), (dtype, names)
            for part in parts:
                hits = [n for n in names if part in n]
                assert len(hits) == 1 and ("_mma" in hits[0]) == mma, (
                    dtype, names)


def time_by_kernel(torch, fn, argsets, keys, iters=50, warmup=5):
    """``{key: device ms per call}`` of the kernels whose names hold each
    key, and ``"*"`` for every kernel of the calls, from the profiler's
    device trace over ``iters`` calls of ``fn`` cycling ``argsets``; plus
    ``"stream"``, the CUDA-event time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    device_ms, stream_ms = time_ms(torch, fn, argsets, iters, warmup)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    out = {key: None for key in keys}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key in keys:
                if key in e.name:
                    out[key] = (out[key] or 0.0) + \
                        e.time_range.elapsed_us() / 1e3 / iters
    out["*"], out["stream"] = device_ms, stream_ms
    return out


def time_flash(torch, fa, dev, rate):
    """Times of kernel 5 and its two backward kernels at the path's shape
    in bfloat16, as the path calls them (the forward writes the float32
    output it keeps for delta), cycling 2 input sets (128 MiB each).
    The plain versions compute the whole forward and the whole backward;
    the library calls are ``F.scaled_dot_product_attention(is_causal=
    True)`` and its autograd backward, timed only (the port never calls
    them).  Bounds: each input read once and each output written once at
    the memory rate; the products this run's causal mask keeps (T(T+1)/2
    (q, k) pairs a head, 2·D FLOP a pair a product) at the bf16 tensor-
    core peak, with the float32-FMA time of the same FLOPs beside it.
    The rate printed counts those products; beside it, with the second
    products of the hi + lo split (p·v in the forward; p·dO, ds·q and
    ds·k in the backward)."""
    import torch.nn.functional as F
    b, h, t, _, d, causal = FLASH_PATH
    sets, bwd_sets, lib_sets = [], [], []
    for s in range(2):
        q, k, v, g = flash_inputs(torch, FLASH_PATH, "bfloat16", dev, s)
        o, lse = fa.flash_fwd(q, k, v, causal=causal,
                              out_dtype=torch.float32)
        sets.append((q, k, v))
        bwd_sets.append((q, k, v, o, lse, g))
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        lib_sets.append((F.scaled_dot_product_attention(
            *leaves, is_causal=True), *leaves, g))

    def fwd(q, k, v):
        return fa.flash_fwd(q, k, v, causal=causal, out_dtype=torch.float32)

    def fwd_plain(q, k, v):
        return fa.flash_fwd_reference(q, k, v, causal=causal,
                                      out_dtype=torch.float32)

    def bwd(q, k, v, o, lse, g):
        return fa.flash_bwd(q, k, v, o, lse, g, causal=causal)

    def bwd_plain(q, k, v, o, lse, g):
        return fa.flash_bwd_reference(q, k, v, o, lse, g, causal=causal)

    def lib_bwd(o, q, k, v, g):
        return torch.autograd.grad(o, (q, k, v), g, retain_graph=True)

    fwd_t = time_by_kernel(torch, fwd, sets, ["flash_fwd"])
    bwd_t = time_by_kernel(torch, bwd, bwd_sets,
                           ["flash_bwd_dkdv", "flash_bwd_dq"])
    plain_f = time_ms(torch, fwd_plain, sets, iters=10, warmup=2)
    plain_b = time_ms(torch, bwd_plain, bwd_sets, iters=10, warmup=2)
    lib_f = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), sets, iters=50, warmup=5)
    lib_b = time_ms(torch, lib_bwd, lib_sets, iters=50, warmup=5)
    print(f"flash_bwd wrapper per call: kernels dkdv "
          f"{bwd_t['flash_bwd_dkdv']} + dq {bwd_t['flash_bwd_dq']} ms of "
          f"{bwd_t['*']} ms device time (the rest: delta = Σ dO·O), stream "
          f"{bwd_t['stream']:.6f} ms; forward kernel {fwd_t['flash_fwd']} "
          f"ms of {fwd_t['*']} ms", flush=True)
    pairs = b * h * t * (t + 1) // 2
    n = b * h * t * d                    # elements of one (B, H, T, D)
    lse_b = b * h * t * 4
    label = f"{FLASH_PATH} bfloat16"
    out = []
    for name, key, products, split, nbytes, plain, lib in (
            # q, k, v read, o (float32) and lse written
            ("flash_attention_fwd", "flash_fwd", 2, 1,
             3 * n * 2 + n * 4 + lse_b, plain_f, lib_f),
            # q, k, v, dO, lse, delta read; dk, dv written
            ("flash_attention_bwd_dkdv", "flash_bwd_dkdv", 4, 2,
             6 * n * 2 + 2 * lse_b, plain_b, lib_b),
            # q, k, v, dO, lse, delta read; dq written
            ("flash_attention_bwd_dq", "flash_bwd_dq", 3, 1,
             5 * n * 2 + 2 * lse_b, plain_b, lib_b)):
        times = fwd_t if key == "flash_fwd" else bwd_t
        flops = products * 2 * pairs * d
        ms = times[key] or times["stream"]
        print(f"{name}: {flops} FLOP ({(products + split) * 2 * pairs * d} "
              f"with the split's second products) in {ms:.6f} ms: "
              f"{flops / ms / 1e9:.1f} TFLOP/s; at the float32-FMA rate "
              f"(67 TFLOP/s) they take {flops / FP32_PEAK * 1e3:.6f} ms",
              flush=True)
        out.append(report(f"{name} {label}", {
            "ms": (times[key], times["stream"]), "plain_ms": plain,
            "library_ms": lib}, nbytes, rate, flops, BF16_PEAK))
    del sets, bwd_sets, lib_sets
    return out


def rms_inputs(torch, rows, cols, dtype, dev, seed, gdtype=None, offset=0):
    """``(x, gamma, g)`` on the card: x and g in ``dtype`` (x ``offset``
    elements into its buffer), gamma in ``gdtype`` (default x's)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn(rows, cols, generator=gen, device=dev) * 2 + 0.3).to(dt)
    gamma = (torch.rand(cols, generator=gen, device=dev) + 0.5).to(
        getattr(torch, gdtype or dtype))
    return offset_copy(torch, x, offset), gamma, torch.randn(
        rows, cols, generator=gen, device=dev).to(dt)


def check_rms_norm(torch, rn, dev):
    """Kernels 8 and 9 against their plain versions at every case and
    variant, the backward twice, bit for bit; returns the max |d y| and
    |d dx| at the path's shape, bfloat16 (the path's dtype)."""
    path_err = None
    cases = [(rows, cols, dtype, dtype, 0)
             for rows, cols, dtype in row_cases(RMS_PATH)]
    for rows, cols, dtype, gdtype, offset in cases + RMS_VARIANTS:
        x, gamma, g = rms_inputs(torch, rows, cols, dtype, dev, 0, gdtype,
                                 offset)
        y, rrms = rn.rms_norm_fwd(x, gamma)
        dx, dgamma = rn.rms_norm_bwd(x, g, gamma, rrms)
        again = rn.rms_norm_bwd(x, g, gamma, rrms)
        ry, rrrms = rn.rms_norm_fwd_reference(x, gamma)
        rdx, rdgamma = rn.rms_norm_bwd_reference(x, g, gamma, rrrms)
        torch.cuda.synchronize()
        assert torch.equal(dx, again[0]) and torch.equal(dgamma, again[1]), (
            (rows, cols, dtype, gdtype, offset), "two runs differ")
        # dx = rrms·gg − rrms³·x·Σ(gg·x)/n: held at the size of its terms,
        # which cancel (entirely at width 1, where dx is eps/x² of them)
        terms = (rrrms[:, None] * g.float() * gamma.float()).abs().max()
        errs = {k: row_err(torch, a, b) for k, a, b in (
            ("y", y, ry), ("rrms", rrms, rrrms), ("dgamma", dgamma, rdgamma))}
        errs["dx"] = row_err(torch, dx, rdx, terms.item())
        print(f"rms_norm ({rows}, {cols}) {dtype}, gamma {gdtype}, x offset "
              f"{offset}: max|d|/max|ref| "
              + " ".join(f"{k}={e:.2e}" for k, (e, _) in errs.items())
              + f" (tol {ROW_TOL:g} of max"
              f"{', + 1 bf16 ulp' if dtype == 'bfloat16' else ''}); the "
              "backward twice bit for bit", flush=True)
        assert all(ok for _, ok in errs.values()), (
            (rows, cols, dtype, gdtype, offset), errs)
        if (rows, cols) == RMS_PATH and dtype == "bfloat16" and not offset:
            path_err = ((y.float() - ry.float()).abs().max().item(),
                        (dx.float() - rdx.float()).abs().max().item())
    return path_err


def time_rms_norm(torch, rn, dev, rate):
    """Times of kernels 8 and 9 at the RMSNorm rows (32768, 512) bfloat16,
    cycling 8 input sets (256 MiB of x and g).  The library calls are
    ``F.rms_norm`` and its autograd backward (``torch.autograd.grad`` of
    a kept graph)."""
    import torch.nn.functional as F
    rows, cols = RMS_PATH
    fwd_sets, bwd_sets, lib_sets = [], [], []
    for s in range(8):
        x, gamma, g = rms_inputs(torch, rows, cols, "bfloat16", dev, s)
        fwd_sets.append((x, gamma))
        bwd_sets.append((x, g, gamma, rn.rms_norm_fwd_reference(x, gamma)[1]))
        xr, gr = x.clone().requires_grad_(True), gamma.clone().requires_grad_(
            True)
        lib_sets.append((F.rms_norm(xr, (cols,), gr, 1e-6), xr, gr, g))
    fwd = {"ms": time_ms(torch, rn.rms_norm_fwd, fwd_sets),
           "plain_ms": time_ms(torch, rn.rms_norm_fwd_reference, fwd_sets),
           "library_ms": time_ms(torch, lambda x, gamma: F.rms_norm(
               x, (cols,), gamma, 1e-6), fwd_sets)}
    bwd = {"ms": time_ms(torch, rn.rms_norm_bwd, bwd_sets),
           "plain_ms": time_ms(torch, rn.rms_norm_bwd_reference, bwd_sets),
           "library_ms": time_ms(torch, lambda y, x, gamma, g:
                                 torch.autograd.grad(y, (x, gamma), g,
                                                     retain_graph=True),
                                 lib_sets)}
    n = rows * cols * 2
    # forward: x and gamma read, y and rrms written; backward: x, g,
    # gamma and rrms read, dx and dgamma written
    out = (report(f"rms_norm_fwd ({rows}, {cols}) bfloat16", fwd,
                  2 * n + cols * 2 + rows * 4, rate),
           report(f"rms_norm_bwd ({rows}, {cols}) bfloat16", bwd,
                  3 * n + 2 * cols * 2 + rows * 4, rate))
    # the backward wrapper's trace: the rows' kernel and the partials'
    # sum, no other launch (no torch.sum, no cast)
    names = kernel_names(torch, rn.rms_norm_bwd, bwd_sets[0])
    print(f"rms_norm_bwd ({rows}, {cols}) bfloat16 runs {names}", flush=True)
    assert len(names) == 2 and any("rms_bwd_warp" in k for k in names) and (
        any("rms_bwd_sum" in k for k in names)), names
    share = time_by_kernel(torch, rn.rms_norm_bwd, bwd_sets,
                           ("rms_bwd_warp", "rms_bwd_sum"))
    print("rms_norm_bwd device ms a call by kernel: " + ", ".join(
        f"{k} {v}" for k, v in share.items()), flush=True)
    del fwd_sets, bwd_sets, lib_sets
    return out


def resnet_fmm_shapes(batch):
    """``(M, K, N, prologue)`` of every fused matmul + BN call in one
    ResNet-50 v1 forward at ``batch`` (224x224 input), in order: per
    bottleneck c1 (no prologue), c3 (bn2's prologue) and, in a stage's
    first block, the projection (no prologue)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        resnet_spec)
    _, layers, channels = resnet_spec[50]
    shapes, cin, side = [], channels[0], IMAGE // 4
    for i, (n_blocks, ch) in enumerate(zip(layers, channels[1:])):
        side = side if i == 0 else side // 2
        m = batch * side * side
        for b in range(n_blocks):
            k_in = cin if b == 0 else ch
            shapes += [(m, k_in, ch // 4, False), (m, ch // 4, ch, True)]
            if b == 0:
                shapes.append((m, k_in, ch, False))
        cin = ch
    return shapes


def fmm_inputs(torch, m, k, n, dtype, dev, seed):
    """``(x, w, scale, bias, dy, ds1, ds2)`` made on the card from a
    seed: x, w and dy in ``dtype``, the rest float32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = (rnd(m, k) * 0.5).to(dt)
    w = (rnd(k, n) * k ** -0.5).to(dt)
    scale = torch.rand(k, generator=g, device=dev) + 0.5
    bias = rnd(k) * 0.2
    dy = (rnd(m, n) * 0.1).to(dt)
    return x, w, scale, bias, dy, rnd(n) * 0.01, rnd(n) * 0.001


def check_fused_matmul_bn(torch, fb, dev):
    """Kernels 10-12 against their plain versions at every shape the
    ResNet-50 path gives them at B=128 and at the JAX tests' shapes, in
    float32 and bfloat16, with nonzero ds1/ds2.  Returns the max |d| of
    y, dx and dw over the path's float32 shapes, and over its bfloat16
    shapes (``fwd_mma``, ``dx_mma``, ``dw_mma``: kernels 10's, 11's and
    12's tensor-core tiles)."""
    path = list(dict.fromkeys(resnet_fmm_shapes(RESNET_B)))
    cases = [(shape, dt) for shape in path for dt in FMM_TOL]
    cases += [((m, k, n, pro), dt) for m, k, n in FMM_TEST_SHAPES
              for pro in (False, True) for dt in FMM_TOL]
    path_err = {"fwd": 0.0, "dx": 0.0, "dw": 0.0, "fwd_mma": 0.0,
                "dx_mma": 0.0, "dw_mma": 0.0}
    for (m, k, n, pro), dtype in cases:
        x, w, scale, bias, dy, ds1, ds2 = fmm_inputs(torch, m, k, n, dtype,
                                                     dev, 0)
        if not pro:
            scale = bias = None
        got = dict(zip(("y", "s1", "s2"),
                       fb.fused_matmul_bn_fwd(x, w, scale, bias)))
        want = dict(zip(("y", "s1", "s2"),
                        fb.matmul_bn_reference(x, w, scale, bias)))
        args = (x, w, scale, bias, want["y"], dy, ds1, ds2)
        got.update(zip(("dx", "dscale", "dbias"), fb.fused_matmul_bn_dx(*args)))
        want.update(zip(("dx", "dscale", "dbias"),
                        fb.matmul_bn_dx_reference(*args)))
        got["dw"] = fb.fused_matmul_bn_dw(*args)
        want["dw"] = fb.matmul_bn_dw_reference(*args)
        torch.cuda.synchronize()
        tol = FMM_TOL[dtype]
        ratios, abs_err = {}, {}
        for name, ref in want.items():
            if ref is None:
                assert got[name] is None, name
                continue
            assert got[name].dtype == ref.dtype, (name, got[name].dtype)
            err = (got[name].float() - ref.float()).abs().max().item()
            scale_ = ref.float().abs().max().item()
            assert err <= tol * max(scale_, 1e-30), (
                (m, k, n, pro), dtype, name, err, scale_)
            ratios[name], abs_err[name] = err / max(scale_, 1e-30), err
        print(f"fused_matmul_bn ({m}, {k}, {n}) prologue={pro} {dtype}: "
              f"max|d|/max|ref| " + " ".join(
                  f"{k_}={v:.2e}" for k_, v in ratios.items())
              + f" (tol {tol:g}) ok", flush=True)
        if (m, k, n, pro) in path:
            tile = "" if dtype == "float32" else "_mma"
            for key, name in (("fwd", "y"), ("dx", "dx"), ("dw", "dw")):
                path_err[key + tile] = max(path_err[key + tile],
                                           abs_err[name])
        del x, w, dy, got, want, args
    return path_err


def tile_suffix(dtype):
    """The kernel-name suffix of a fused kernel's instance: ``_mma`` for
    every bfloat16 tile, ``_tf32`` for every float32 one (the 3xTF32
    tiles of kernels 10-16)."""
    return "_mma" if dtype == "bfloat16" else "_tf32"


def bound_operations(dtype, flops):
    """``(operations, peak)`` of a fused kernel's bound: a 3xTF32 tile
    runs three tf32 products of ``flops`` each at the TF32 peak, a bf16
    tile one product at the bf16 peak."""
    if dtype == "bfloat16":
        return flops, BF16_PEAK
    return TF32_PRODUCTS * flops, TF32_PEAK


def check_fmm_mma(torch, fb, dev):
    """Kernels 10, 11 and 12 by dtype: the profiler's kernel names show
    float32 runs the 3xTF32 tiles (``fused_matmul_bn_fwd_tf32``,
    ``fused_matmul_bn_dx_tf32``, ``fused_matmul_bn_dw_tf32``) and
    bfloat16 the bf16 tensor-core tiles (``fused_matmul_bn_fwd_mma``,
    ``fused_matmul_bn_dx_mma``, ``fused_matmul_bn_dw_mma``); each tile
    within FMM_TOL of its plain version where it loads rows element by
    element; two runs of it give the same bits there, at the
    representative launch and at the ragged test shape."""
    def bwd_args(m, k, n, dtype, pro=True):
        x, w, scale, bias, dy, ds1, ds2 = fmm_inputs(torch, m, k, n, dtype,
                                                     dev, 2)
        if not pro:
            scale = bias = None
        y = fb.matmul_bn_reference(x, w, scale, bias)[0]
        return x, w, scale, bias, y, dy, ds1, ds2

    tiles = (("fwd", lambda *a: fb.fused_matmul_bn_fwd(*a[:4]),
              lambda *a: fb.matmul_bn_reference(*a[:4])),
             ("dx", fb.fused_matmul_bn_dx, fb.matmul_bn_dx_reference),
             ("dw", lambda *a: (fb.fused_matmul_bn_dw(*a),),
              lambda *a: (fb.matmul_bn_dw_reference(*a),)))
    for part, fn, _ in tiles:
        for dtype in FMM_TOL:
            names = [n for n in kernel_names(torch, fn,
                                             bwd_args(200, 96, 72, dtype))
                     if "fused_matmul_bn" in n]
            print(f"fused_matmul_bn_{part} {dtype} runs {names}", flush=True)
            want = f"fused_matmul_bn_{part}{tile_suffix(dtype)}"
            assert len(names) == 1 and want in names[0], names
            assert ("_mma" in names[0]) == (dtype == "bfloat16"), names
            assert ("_tf32" in names[0]) == (dtype == "float32"), names
    m, k, n, _ = FMM_REP
    for m, k, n, pro in [(m, k, n, True), (200, 96, 72, True),
                         (200, 96, 72, False)] + [
            shape + (pro,) for shape in FMM_ELEMENT_SHAPES
            for pro in (False, True)]:
        for dtype in FMM_TOL:
            args = bwd_args(m, k, n, dtype, pro)
            tol = FMM_TOL[dtype]
            for part, fn, ref in tiles:
                suffix = tile_suffix(dtype)
                first, second, want = fn(*args), fn(*args), ref(*args)
                torch.cuda.synchronize()
                ratios = []
                for a, b, r in zip(first, second, want):
                    if r is None:
                        assert a is None and b is None
                        continue
                    err = (a.float() - r.float()).abs().max().item()
                    scale_ = r.float().abs().max().item()
                    assert err <= tol * scale_, (part, dtype, (m, k, n, pro),
                                                 err)
                    assert torch.equal(a, b), (part, dtype, (m, k, n, pro))
                    ratios.append(err / scale_)
                print(f"fused_matmul_bn_{part}{suffix} ({m}, {k}, {n}) "
                      f"prologue={pro}: max|d|/max|ref| "
                      f"{' '.join(f'{v:.2e}' for v in ratios)} "
                      f"(tol {tol:g}); vec16 x {fb._vec16(args[0])} y/dy "
                      f"{fb._vec16(args[4], args[5])}; two runs bit for bit",
                      flush=True)
                del first, second, want
            del args


def time_fused_matmul_bn(torch, fb, dev, dtype, rate):
    """Times of kernels 10, 11 and 12 at the representative launch
    (stage 1's c3 at B=128, with the prologue), cycling 2 input sets of
    about 0.9 GB each in float32.  The library call for each is cuBLAS's
    product alone (``torch.matmul``): no PyTorch call computes the fused
    function."""
    m, k, n, _ = FMM_REP
    sets = [fmm_inputs(torch, m, k, n, dtype, dev, s) for s in range(2)]
    fwd_sets = [a[:4] for a in sets]
    bwd_sets = [a[:4] + (fb.matmul_bn_reference(*a[:4])[0],) + a[4:]
                for a in sets]
    kw = dict(iters=50, warmup=5)
    fwd = {"ms": time_ms(torch, fb.fused_matmul_bn_fwd, fwd_sets, **kw),
           "plain_ms": time_ms(torch, fb.matmul_bn_reference, fwd_sets, **kw),
           "library_ms": time_ms(torch, lambda x, w, sc, bi: torch.matmul(
               x, w), fwd_sets, **kw)}
    dx = {"ms": time_ms(torch, fb.fused_matmul_bn_dx, bwd_sets, **kw),
          "plain_ms": time_ms(torch, fb.matmul_bn_dx_reference, bwd_sets,
                              **kw),
          "library_ms": time_ms(torch, lambda x, w, sc, bi, y, dy, a, b:
                                torch.matmul(dy, w.t()), bwd_sets, **kw)}
    dw = {"ms": time_ms(torch, fb.fused_matmul_bn_dw, bwd_sets, **kw),
          "plain_ms": time_ms(torch, fb.matmul_bn_dw_reference, bwd_sets,
                              **kw),
          "library_ms": time_ms(torch, lambda x, w, sc, bi, y, dy, a, b:
                                torch.matmul(x.t(), dy), bwd_sets, **kw)}
    es = sets[0][0].element_size()
    flops = 2 * m * k * n
    # each input read once, each output written once; scale, bias, ds1,
    # ds2 and the column sums are float32
    fwd_bytes = (m * k + k * n + m * n) * es + 2 * k * 4 + 2 * n * 4
    dx_bytes = (2 * m * n + k * n + 2 * m * k) * es + 4 * k * 4 + 2 * n * 4
    dw_bytes = (m * k + 2 * m * n + k * n) * es + 2 * k * 4 + 2 * n * 4
    label = f"({m}, {k}, {n}) prologue {dtype}"
    out = tuple(
        report(f"fused_matmul_bn_{part}{tile_suffix(dtype)} {label}",
               times, nbytes, rate, *bound_operations(dtype, flops))
        for part, times, nbytes in (("fwd", fwd, fwd_bytes),
                                    ("dx", dx, dx_bytes),
                                    ("dw", dw, dw_bytes)))
    del sets, fwd_sets, bwd_sets
    return out


def resnet_conv3_shapes(batch):
    """``(N, H, W, C, C_out)`` of every fused 3x3 call in one ResNet-50 v1
    forward at ``batch`` (224x224 input), in order: one per bottleneck,
    each with bn1's prologue.  The 3x3 runs at the stage's output size
    (v1 strides its first 1x1)."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        resnet_spec)
    _, layers, channels = resnet_spec[50]
    shapes, side = [], IMAGE // 4
    for i, (n_blocks, ch) in enumerate(zip(layers, channels[1:])):
        side = side if i == 0 else side // 2
        shapes += [(batch, side, side, ch // 4, ch // 4)] * n_blocks
    return shapes


def conv_inputs(torch, shape, dtype, dev, seed):
    """``(x, w, scale, bias, dy, ds1, ds2)`` for the fused 3x3, made on the
    card from a seed: x, w and dy in ``dtype``, the rest float32."""
    n, h, w, c, co = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*size):
        return torch.randn(size, generator=g, device=dev)

    x = (rnd(n, h, w, c) * 0.5).to(dt)
    k = (rnd(3, 3, c, co) * (9 * c) ** -0.5).to(dt)
    scale = torch.rand(c, generator=g, device=dev) + 0.5
    bias = rnd(c) * 0.2
    dy = (rnd(n, h, w, co) * 0.1).to(dt)
    return x, k, scale, bias, dy, rnd(co) * 0.01, rnd(co) * 0.001


def check_fused_conv3_bn(torch, fc, dev):
    """Kernels 13-16 against their plain versions at the four ResNet-50
    3x3 shapes at B=128 (with the prologue, as the path runs them) and at
    the JAX tests' shapes (with and without it), in float32 and bfloat16,
    with nonzero ds1/ds2.  Returns the max |d| of y, dx and dw over the
    path's float32 shapes, and over its bfloat16 shapes (``fwd_mma``,
    ``dx_mma``, ``dw_mma``: kernels 13's, 14's and 16's tensor-core
    tiles)."""
    path = list(dict.fromkeys(resnet_conv3_shapes(RESNET_B)))
    cases = [((shape, True), dt) for shape in path for dt in FMM_TOL]
    cases += [((shape, pro), dt) for shape in CONV_TEST_SHAPES
              for pro in (False, True) for dt in FMM_TOL]
    path_err = {"fwd": 0.0, "dx": 0.0, "dw": 0.0, "fwd_mma": 0.0,
                "dx_mma": 0.0, "dw_mma": 0.0}
    for (shape, pro), dtype in cases:
        x, w, scale, bias, dy, ds1, ds2 = conv_inputs(torch, shape, dtype,
                                                      dev, 0)
        if not pro:
            scale = bias = None
        got = dict(zip(("y", "s1", "s2"),
                       fc.fused_conv3_bn_fwd(x, w, scale, bias)))
        want = dict(zip(("y", "s1", "s2"),
                        fc.conv3_bn_reference(x, w, scale, bias)))
        args = (x, w, scale, bias, want["y"], dy, ds1, ds2)
        got.update(zip(("dx", "dscale", "dbias"), fc.fused_conv3_bn_dx(*args)))
        want.update(zip(("dx", "dscale", "dbias"),
                        fc.conv3_bn_dx_reference(*args)))
        got["dw"] = fc.fused_conv3_bn_dw(*args)
        want["dw"] = fc.conv3_bn_dw_reference(*args)
        torch.cuda.synchronize()
        tol = FMM_TOL[dtype]
        ratios, abs_err = {}, {}
        for name, ref in want.items():
            assert got[name].dtype == ref.dtype, (name, got[name].dtype)
            err = (got[name].float() - ref.float()).abs().max().item()
            scale_ = ref.float().abs().max().item()
            assert err <= tol * max(scale_, 1e-30), (
                shape, pro, dtype, name, err, scale_)
            ratios[name], abs_err[name] = err / max(scale_, 1e-30), err
        print(f"fused_conv3_bn {shape} prologue={pro} {dtype}: "
              f"max|d|/max|ref| " + " ".join(
                  f"{k_}={v:.2e}" for k_, v in ratios.items())
              + f" (tol {tol:g}) ok", flush=True)
        if shape in path:
            tile = "" if dtype == "float32" else "_mma"
            for key, name in (("fwd", "y"), ("dx", "dx"), ("dw", "dw")):
                path_err[key + tile] = max(path_err[key + tile],
                                           abs_err[name])
        del x, w, dy, got, want, args
    return path_err


def check_conv3_mma(torch, fc, dev):
    """Kernels 13, 14 and 16 by dtype: the profiler's kernel names show
    float32 runs the 3xTF32 tiles (``fused_conv3_bn_fwd_tf32``,
    ``fused_conv3_bn_dx_tf32``, ``fused_conv3_bn_dw_tf32``) and bfloat16
    the bf16 tensor-core tiles (``fused_conv3_bn_fwd_mma``,
    ``fused_conv3_bn_dx_mma``, ``fused_conv3_bn_dw_mma``); each tile
    within FMM_TOL of its plain version where it loads rows element by
    element, where an
    image row takes several segments and where C_out > 64 (C_out = 260:
    the TPU's kernel 15); two runs of it give the same bits there, at
    every path shape and at the JAX tests' ragged shapes."""
    from incubator_mxnet_tpu_torch.ops import _fused_common as common

    def bwd_args(shape, dtype, pro=True):
        x, w, scale, bias, dy, ds1, ds2 = conv_inputs(torch, shape, dtype,
                                                      dev, 2)
        if not pro:
            scale = bias = None
        y = fc.conv3_bn_reference(x, w, scale, bias)[0]
        return x, w, scale, bias, y, dy, ds1, ds2

    tiles = (("fwd", lambda *a: fc.fused_conv3_bn_fwd(*a[:4]),
              lambda *a: fc.conv3_bn_reference(*a[:4])),
             ("dx", fc.fused_conv3_bn_dx, fc.conv3_bn_dx_reference),
             ("dw", lambda *a: (fc.fused_conv3_bn_dw(*a),),
              lambda *a: (fc.conv3_bn_dw_reference(*a),)))
    for part, fn, _ in tiles:
        for dtype in FMM_TOL:
            names = [n for n in kernel_names(
                torch, fn, bwd_args((2, 5, 9, 16, 8), dtype))
                if "fused_conv3_bn" in n]
            print(f"fused_conv3_bn_{part} {dtype} runs {names}", flush=True)
            want = f"fused_conv3_bn_{part}{tile_suffix(dtype)}"
            assert len(names) == 1 and want in names[0], names
            assert ("_mma" in names[0]) == (dtype == "bfloat16"), names
            assert ("_tf32" in names[0]) == (dtype == "float32"), names
    path = list(dict.fromkeys(resnet_conv3_shapes(RESNET_B)))
    sms = common.sms(dev.index)
    for shape, pro in ([(s_, True) for s_ in path]
                       + [((2, 5, 9, 16, 8), p) for p in (False, True)]
                       + [((16, 6, 6, 16, 260), True)]
                       + [(s_, p) for s_ in CONV_ELEMENT_SHAPES
                          for p in (False, True)]):
        for dtype in FMM_TOL:
            args = bwd_args(shape, dtype, pro)
            tol = FMM_TOL[dtype]
            for part, fn, ref in tiles:
                suffix = tile_suffix(dtype)
                first, second, want = fn(*args), fn(*args), ref(*args)
                torch.cuda.synchronize()
                ratios = []
                for a, b, r in zip(first, second, want):
                    err = (a.float() - r.float()).abs().max().item()
                    scale_ = max(r.float().abs().max().item(), 1e-30)
                    assert err <= tol * scale_, (part, dtype, shape, pro, err)
                    assert torch.equal(a, b), (part, dtype, shape, pro)
                    ratios.append(err / scale_)
                bf16 = dtype == "bfloat16"
                split = {"fwd": lambda *geom: fc.fwd_mma_split(
                             *geom, getattr(torch, dtype)),
                         "dx": lambda *geom: fc.dx_mma_split(
                             *geom, getattr(torch, dtype)),
                         "dw": fc.dw_mma_split if bf16
                         else fc.dw_tf32_split}[part](*shape, sms)
                print(f"fused_conv3_bn_{part}{suffix} {shape} prologue={pro}: "
                      f"max|d|/max|ref| "
                      f"{' '.join(f'{v:.2e}' for v in ratios)} (tol {tol:g}); "
                      f"vec16 x {common.vec16(args[0])} w "
                      f"{common.vec16(args[1])} y/dy "
                      f"{common.vec16(args[4], args[5])}; split {split}; two "
                      "runs bit for bit", flush=True)
                del first, second, want
            del args


def kernel_names(torch, fn, args, tries=4):
    """The device kernels a call of ``fn`` runs, by name, from the
    profiler trace of three calls after one untraced call.  The profiler
    can return a trace of so short a window with no device event at all;
    such a trace says nothing of the kernels, so it is taken again, up to
    ``tries`` times, and an empty list is returned only if every trace
    was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn(*args)
            torch.cuda.synchronize()
        names = sorted({e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA})
        if names:
            return names
        print(f"profiler trace {attempt + 1} of {tries} held no device "
              "event", flush=True)
    return names


def time_fused_conv3_bn(torch, fc, dev, dtype, rate):
    """Times of kernels 13-16 at the representative launch (stage 1's 3x3
    at B=128, with the prologue), cycling 2 input sets of about 0.3 GB
    each in float32.  The library call for each is cuDNN's product alone
    on the same operands, channels-last: ``F.conv2d`` of the normalized
    input, and ``aten.convolution_backward`` for the input and for the
    weight gradient of the rounded dyt; the cuDNN kernels they run are
    printed (cuDNN may pick Winograd or FFT).  No PyTorch call computes
    the fused function."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import _fused_common as common
    n, h, w, c, co = CONV_REP
    sets = [conv_inputs(torch, CONV_REP, dtype, dev, s) for s in range(2)]
    fwd_sets = [a[:4] for a in sets]
    bwd_sets = [a[:4] + (fc.conv3_bn_reference(*a[:4])[0],) + a[4:]
                for a in sets]
    lib_sets = []
    for x, k, sc, bi, y, dy, ds1, ds2 in bwd_sets:
        xn = common.prologue(x, sc, bi).to(x.dtype).permute(0, 3, 1, 2)
        kn = k.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
        dyt = common.dyt(y, dy, ds1, ds2).to(dy.dtype).permute(0, 3, 1, 2)
        lib_sets.append((xn, kn, dyt))
    conv_bwd = torch.ops.aten.convolution_backward

    def lib_fwd(xn, kn, dyt):
        return F.conv2d(xn, kn, padding=1)

    def lib_dx(xn, kn, dyt):
        return conv_bwd(dyt, xn, kn, None, [1, 1], [1, 1], [1, 1], False,
                        [0, 0], 1, [True, False, False])

    def lib_dw(xn, kn, dyt):
        return conv_bwd(dyt, xn, kn, None, [1, 1], [1, 1], [1, 1], False,
                        [0, 0], 1, [False, True, False])

    for label, fn in (("fwd", lib_fwd), ("dx", lib_dx), ("dw", lib_dw)):
        print(f"  cuDNN {label} {dtype} runs: "
              f"{kernel_names(torch, fn, lib_sets[0])}", flush=True)
    kw = dict(iters=50, warmup=5)
    fwd = {"ms": time_ms(torch, fc.fused_conv3_bn_fwd, fwd_sets, **kw),
           "plain_ms": time_ms(torch, fc.conv3_bn_reference, fwd_sets, **kw),
           "library_ms": time_ms(torch, lib_fwd, lib_sets, **kw)}
    dx = {"ms": time_ms(torch, fc.fused_conv3_bn_dx, bwd_sets, **kw),
          "plain_ms": time_ms(torch, fc.conv3_bn_dx_reference, bwd_sets,
                              **kw),
          "library_ms": time_ms(torch, lib_dx, lib_sets, **kw)}
    dw = {"ms": time_ms(torch, fc.fused_conv3_bn_dw, bwd_sets, **kw),
          "plain_ms": time_ms(torch, fc.conv3_bn_dw_reference, bwd_sets,
                              **kw),
          "library_ms": time_ms(torch, lib_dw, lib_sets, **kw)}
    es = sets[0][0].element_size()
    m = n * h * w
    flops = 2 * m * 9 * c * co
    # each input read once, each output written once; scale, bias, ds1,
    # ds2 and the channel sums are float32
    fwd_bytes = (m * c + 9 * c * co + m * co) * es + 2 * c * 4 + 2 * co * 4
    dx_bytes = (2 * m * c + 9 * c * co + 2 * m * co) * es + 4 * c * 4 \
        + 2 * co * 4
    dw_bytes = (m * c + 2 * m * co + 9 * c * co) * es + 2 * c * 4 + 2 * co * 4
    label = f"{CONV_REP} prologue {dtype}"
    out = tuple(
        report(f"fused_conv3_bn_{part}{tile_suffix(dtype)} {label}",
               times, nbytes, rate, *bound_operations(dtype, flops))
        for part, times, nbytes in (("fwd", fwd, fwd_bytes),
                                    ("dx", dx, dx_bytes),
                                    ("dw", dw, dw_bytes)))
    del sets, fwd_sets, bwd_sets, lib_sets
    return out


_FAMILIES = (("layer_norm", ("layer_norm",)), ("xent", ("xent",)),
             ("gemm", ("gemm", "splitk")), ("softmax", ("softmax",)),
             ("memcpy", ("memcpy", "memset")))


# ResNet-50's kernels: the port's own first (their names say conv and
# matmul too), then cuDNN's convolutions (their names carry fprop, dgrad
# or wgrad) before cuBLAS's products, since both may say "gemm";
# BatchNorm's statistics and folds are reductions and elementwise kernels
_RESNET_FAMILIES = (
    ("fused_matmul_bn_fwd", ("fused_matmul_bn_fwd",)),
    ("fused_matmul_bn_dx", ("fused_matmul_bn_dx",)),
    ("fused_matmul_bn_dw", ("fused_matmul_bn_dw",)),
    ("fused_conv3_bn_fwd", ("fused_conv3_bn_fwd",)),
    ("fused_conv3_bn_dx", ("fused_conv3_bn_dx",)),
    ("fused_conv3_bn_dw", ("fused_conv3_bn_dw",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "winograd")),
    ("gemm", ("gemm", "splitk", "cutlass")), ("xent", ("xent",)),
    ("pooling", ("pool",)),
    ("bn_elementwise", ("elementwise", "reduce", "batch_norm")),
    ("memcpy", ("memcpy", "memset")))


# the TransformerLM's kernels: the port's own (the flash-attention
# kernels; the cross-entropy pair before the softmax pair, whose names
# both say softmax), then cuBLAS's
# products (bf16 "nvjet" kernels on Hopper, float32 SIMT ones for the
# attention logits), then PyTorch's elementwise kernels and reductions
# (the casts, the scale and mask of the logits, GELU, residual adds, the
# SGD update) and its embedding gather and scatter
_TF_FAMILIES = (
    ("flash_fwd", ("flash_fwd",)), ("flash_bwd_dkdv", ("flash_bwd_dkdv",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("xent", ("xent",)), ("softmax_fwd", ("softmax_fwd",)),
    ("softmax_bwd", ("softmax_bwd",)), ("rms_norm_fwd", ("rms_fwd",)),
    ("rms_norm_bwd", ("rms_bwd",)),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "splitk")),
    ("embedding", ("embedding", "index", "gather", "scatter", "sort",
                   "radix")),
    ("elementwise", ("elementwise", "reduce", "fill", "copy", "gelu")),
    ("memcpy", ("memcpy", "memset")))


def device_families(prof, families=_FAMILIES):
    """Device ms by kernel family from a profiler trace; kernels of no
    named family count as "other" (elementwise, reductions, gathers;
    in the optimizer's window, Adam's updates)."""
    from torch.autograd import DeviceType
    fams = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = e.name.lower()
        fam = next((f for f, keys in families
                    if any(k in name for k in keys)), "other")
        fams[fam] = fams.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    return fams


def forward_breakdown(torch, pred, args, n):
    """Device time of one ``Predictor`` call by kernel family, from the
    profiler's trace, against the call's host-clock time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        pred(*args)
        wall_ms = (time.monotonic() - t0) * 1e3
    fams = device_families(prof)
    busy = sum(fams.values())
    print(f"  bucket {n} profile: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.3f}; by family "
          f"(ms): {({k: round(v, 4) for k, v in sorted(fams.items())})}",
          flush=True)


def bert_step_parts(torch, net, trainer, ce, batch):
    """One training step in two parts, each ending in a synchronise:
    forward + loss + backward, then the optimizer.  Returns the loss."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.examples.train_bert import pretraining_loss
    x, y_mlm, y_nsp = batch

    def fwd_bwd():
        with autograd.record():
            loss = pretraining_loss(net, ce, x, y_mlm, y_nsp)
        autograd.backward(loss)
        if x.is_cuda:
            torch.cuda.synchronize()
        return loss

    def update():
        trainer.step(x.shape[0])
        if x.is_cuda:
            torch.cuda.synchronize()

    return fwd_bwd, update


def check_step(np, results, tol, lr):
    """Hold one training step on the card to the same step on the CPU:
    ``results`` is ``[(loss, grads, weights after, updates, seconds)]``
    for the CPU, then the card.  The loss within 1e-5 relative, every
    gradient max |d| <= tol · max |g| per tensor, the update of every
    weight where its gradient is large (``UPDATE_TOL``), every weight
    after the update within 2·lr.  Returns the worst gradient ratio."""
    ((l_cpu, g_cpu, w_cpu, d_cpu, _),
     (l_card, g_card, w_card, d_card, _)) = results
    assert np.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), \
        (l_card, l_cpu)
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        got = g_card[name]
        assert got.shape == want.shape and np.isfinite(got).all(), name
        scale = np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= tol * max(scale, 1e-30), (name, err, scale)
        if scale > 0 and err / scale > worst:
            worst, worst_name = err / scale, name
    w_err = max(np.abs(w_card[k] - w_cpu[k]).max() for k in w_cpu)
    assert w_err <= 2 * lr, w_err
    u_err, n_large = 0.0, 0
    for name, g in g_cpu.items():
        large = np.abs(g) > 1e-2 * np.abs(g).max()
        if not large.any():
            continue
        n_large += int(large.sum())
        err = np.abs(d_card[name] - d_cpu[name])[large].max()
        assert err <= UPDATE_TOL * lr, (name, err)
        u_err = max(u_err, err)
    assert n_large > 0.01 * sum(g.size for g in g_cpu.values()), n_large
    print(f"loss card {l_card:.7f} cpu {l_cpu:.7f}; {len(g_cpu)} gradients "
          f"agree, worst max|d|/max|g| = {worst:.3e} ({worst_name}, tol "
          f"{tol:g}); update w_after - w_before where |g| > 1e-2 max|g| "
          f"({n_large} weights) max|d| = {u_err:.3e} (atol "
          f"{UPDATE_TOL:g}*lr = {UPDATE_TOL * lr:g}); weights after Adam "
          f"max|d| = {w_err:.3e} (atol 2*lr = {2 * lr:g})", flush=True)
    return worst


def compare_step(torch, np, dev, cfg, batch_size, seq_len, tol, lr):
    """One step of the same model, batch and Adam on the CPU and on
    ``dev``: the loss, every gradient (max |d| <= tol · max |g| per
    tensor), the update of every weight where its gradient is large
    (``UPDATE_TOL``), and every weight after the update (atol 2·lr: a
    first Adam step moves a weight by about lr·sign(g), so a gradient
    near 0 whose sign rounds differently on the two devices moves it by
    up to 2·lr).  Returns the worst gradient ratio max|d| / max|g|."""
    import copy
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.examples.train_bert import synthetic_batch
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    cpu = BERTModel(**cfg, dropout=0.0).initialize(
        device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(dev)
    data = synthetic_batch(batch_size, seq_len, cfg["vocab_size"])
    results = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        batch = [torch.from_numpy(a).to(where) for a in data]
        trainer = Trainer(net.collect_params(), "adam", {"learning_rate": lr})
        fwd_bwd, update = bert_step_parts(torch, net, trainer,
                                          SoftmaxCrossEntropyLoss(), batch)
        t0 = time.monotonic()
        loss = fwd_bwd().item()
        grads = grads_to_numpy(net)
        before = params_to_numpy(net)
        update()
        after = params_to_numpy(net)
        results.append((loss, grads, after,
                        {k: after[k] - before[k] for k in after},
                        time.monotonic() - t0))
    print(f"step on the CPU {results[0][4]:.2f} s, on the card "
          f"{results[1][4]:.3f} s (B={batch_size}, T={seq_len})", flush=True)
    return check_step(np, results, tol, lr)


def train_bert_base(torch, np, dev):
    """Phase 6; returns the training path's launch counts."""
    from incubator_mxnet_tpu_torch.examples.train_bert import (
        synthetic_batch, use_dropout_generator)
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln
    from incubator_mxnet_tpu_torch.ops import softmax_xent as sx
    base = dict(vocab_size=VOCAB)      # every other argument at its default
    compare_step(torch, np, dev, base, TRAIN_B_CPU, T, GRAD_TOL, LR)

    net = BERTModel(**base).initialize(
        device=dev, generator=torch.Generator().manual_seed(1))
    use_dropout_generator(net, torch.Generator(device=dev).manual_seed(0))
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    batch = [torch.from_numpy(a).to(dev)
             for a in synthetic_batch(TRAIN_B, T, VOCAB)]
    fwd_bwd, update = bert_step_parts(torch, net, trainer,
                                      SoftmaxCrossEntropyLoss(), batch)
    torch.cuda.synchronize()
    ln.launches = ln.bwd_launches = 0   # training path starts here
    sx.fwd_launches = sx.bwd_launches = 0
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.monotonic()
        loss = fwd_bwd()
        update()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(loss.item())
    counts = {"layer_norm_fwd": ln.launches, "layer_norm_bwd": ln.bwd_launches,
              "softmax_xent_fwd": sx.fwd_launches,
              "softmax_xent_bwd": sx.bwd_launches}   # training path ends
    print(f"{TRAIN_STEPS} steps at B={TRAIN_B}, T={T}, dropout 0.1, Adam "
          f"lr {LR:g}: losses {[round(v, 4) for v in losses]}", flush=True)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    want = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
            "softmax_xent_fwd": 2, "softmax_xent_bwd": 2}
    for k, n in want.items():
        assert counts[k] == n * TRAIN_STEPS, (k, counts[k])
    print(f"training path launches: {counts} ({want} a step)", flush=True)
    print(f"step time, host clock around a synchronised step: median over "
          f"steps 3-{TRAIN_STEPS} {statistics.median(step_ms[2:]):.3f} ms, "
          f"min {min(step_ms[2:]):.3f} ms, all "
          f"{[round(v, 3) for v in step_ms]}", flush=True)
    step_breakdown(torch, fwd_bwd, update)
    for k, n in amp_bert_steps(torch, np, dev, batch).items():
        counts[k] += n
    return counts


def amp_bert_steps(torch, np, dev, batch):
    """Phase 6 (c): BERT-base converted to bfloat16 by
    ``amp.convert_block`` after ``initialize``, before the Trainer, as
    ``examples/train_bert.py --amp`` builds it; AMP_STEPS steps at B=16,
    T=128, dropout 0.1, Adam, every loss finite, 25 / 25 / 2 / 2 launches
    of the LayerNorm and cross-entropy kernels a step; then, by the
    profiler's kernel names, that those kernels ran their bfloat16
    instances.  Returns the launch counts."""
    from incubator_mxnet_tpu_torch import amp
    from incubator_mxnet_tpu_torch.examples.train_bert import (
        use_dropout_generator)
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln
    from incubator_mxnet_tpu_torch.ops import softmax_xent as sx
    net = BERTModel(vocab_size=VOCAB).initialize(
        device=dev, generator=torch.Generator().manual_seed(2))
    amp.convert_block(net, "bfloat16")
    use_dropout_generator(net, torch.Generator(device=dev).manual_seed(1))
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": LR})
    fwd_bwd, update = bert_step_parts(torch, net, trainer,
                                      SoftmaxCrossEntropyLoss(), batch)
    torch.cuda.synchronize()
    ln.launches = ln.bwd_launches = 0   # training path starts here
    sx.fwd_launches = sx.bwd_launches = 0
    losses = []
    for _ in range(AMP_STEPS):
        loss = fwd_bwd()
        update()
        losses.append(loss.float().item())
    counts = {"layer_norm_fwd": ln.launches, "layer_norm_bwd": ln.bwd_launches,
              "softmax_xent_fwd": sx.fwd_launches,
              "softmax_xent_bwd": sx.bwd_launches}   # training path ends
    print(f"bfloat16 (amp.convert_block) {AMP_STEPS} steps at B={TRAIN_B}, "
          f"T={T}, dropout 0.1, Adam lr {LR:g}: loss dtype {loss.dtype}, "
          f"losses {[round(v, 4) for v in losses]}; launches {counts}",
          flush=True)
    assert np.isfinite(losses).all(), losses
    want = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
            "softmax_xent_fwd": 2, "softmax_xent_bwd": 2}
    for k, n in want.items():
        assert counts[k] == n * AMP_STEPS, (k, counts[k])
    names = [n for n in kernel_names(torch, fwd_bwd, ())
             if "layer_norm" in n or "xent" in n]
    print(f"bfloat16 BERT's LayerNorm and cross-entropy kernels: {names}",
          flush=True)
    for kernel in ("layer_norm_fwd", "layer_norm_bwd", "xent_fwd",
                   "xent_bwd"):
        assert any(kernel in n and "bfloat16" in n for n in names), (kernel,
                                                                    names)
    del net, trainer
    return counts


def step_breakdown(torch, fwd_bwd, update, families=_FAMILIES):
    """One more step under the profiler, in two windows (forward + loss
    + backward, then the optimizer): wall and device-busy ms, idle share
    and busy ms by kernel family.  The profiler's own host cost inflates
    the wall times."""
    total_wall = total_busy = 0.0
    for name, part in (("fwd+bwd", fwd_bwd), ("optimizer", update)):
        wall, busy = profile_window(torch, name, part, families)
        total_wall += wall
        total_busy += busy
    print(f"  profiled step, whole: wall {total_wall:.3f} ms, device busy "
          f"{total_busy:.3f} ms, idle share {1 - total_busy / total_wall:.3f}",
          flush=True)


def profile_window(torch, name, part, families):
    """Run ``part()`` (which ends in a synchronise) under the profiler and
    print its wall and device-busy ms, idle share, busy ms by kernel
    family and the six device kernels (or copies) that took longest, by
    name; returns ``(wall, busy)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        part()
        wall = (time.monotonic() - t0) * 1e3
    fams = device_families(prof, families)
    busy = sum(fams.values())
    print(f"  profiled step, {name}: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; by family "
          f"(ms): {({k: round(v, 4) for k, v in sorted(fams.items())})}",
          flush=True)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    for k, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"    {ms:.4f} ms in {n} x {k[:110]}", flush=True)
    return wall, busy


def resnet_forward_backward(torch, net, x, y):
    """Forward, loss and backward of one training step → ``(loss,
    logits)``; the gradients land in ``.grad``."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    net.zero_grad(set_to_none=True)
    with autograd.record():
        logits = net(x)
        loss = SoftmaxCrossEntropyLoss()(logits, y)
    autograd.backward(loss)
    return loss, logits


def resnet_state(torch, net, x, y, where):
    """One forward + backward on ``where`` → loss, logits, every gradient
    and every moving statistic, as numpy."""
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_to_numpy)
    loss, logits = resnet_forward_backward(
        torch, net, torch.from_numpy(x).to(where), torch.from_numpy(y).to(where))
    return dict(loss=loss.detach().cpu().numpy(),
                logits=logits.detach().cpu().numpy(),
                grads={k: v for k, v in grads_to_numpy(net).items()
                       if "running" not in k},
                running={k: v for k, v in params_to_numpy(net).items()
                         if "running" in k})


def worst_ratio(np, got, want, norm=False):
    """``(worst ratio over tensors, its name)``: max|got - want| /
    max|want| per tensor, or ||got - want|| / ||want|| with ``norm``."""
    worst, name = 0.0, None
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        if norm:
            r = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        else:
            r = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        if r >= worst:
            worst, name = float(r), k
    return worst, name


def resnet_errors(np, got, want):
    """Logits, moving statistics (max-relative) and gradients (max- and
    norm-relative) of one ResNet state against another."""
    return dict(
        logits=worst_ratio(np, {"logits": got["logits"]},
                           {"logits": want["logits"]}),
        running=worst_ratio(np, got["running"], want["running"]),
        grad_max=worst_ratio(np, got["grads"], want["grads"]),
        grad_norm=worst_ratio(np, got["grads"], want["grads"], norm=True))


def _fmt(errs):
    return ", ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in errs.items())


def compare_resnet_step(torch, np, dev):
    """Phase 7 (a): ResNet-50's forward + backward at B=4 on the card
    against the CPU path on the same weights and batch, after measuring
    how far the CPU path moves under a 1e-6 move of its input."""
    from incubator_mxnet_tpu_torch.examples.train_resnet_fused import (
        synthetic_batch)
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        resnet50_v1)
    base = resnet50_v1(classes=CLASSES, layout="NHWC", fused=True).initialize(
        device="cpu", generator=torch.Generator().manual_seed(0))
    x, y = synthetic_batch(RESNET_B_CPU, IMAGE, CLASSES)
    t0 = time.monotonic()
    cpu = resnet_state(torch, copy.deepcopy(base), x, y, "cpu")
    t_cpu = time.monotonic() - t0
    moved = resnet_state(torch, copy.deepcopy(base), x + np.float32(1e-6), y,
                         "cpu")
    noise = resnet_errors(np, moved, cpu)
    print(f"CPU path against itself, input moved by 1e-6: {_fmt(noise)}; "
          f"loss moved {abs(float(moved['loss'].mean() - cpu['loss'].mean())):.3e}",
          flush=True)
    assert noise["logits"][0] * 10 <= RESNET_FWD_TOL, noise
    assert noise["running"][0] * 10 <= RESNET_FWD_TOL, noise
    assert noise["grad_norm"][0] * 4 <= RESNET_GRAD_TOL, noise
    t0 = time.monotonic()
    card = resnet_state(torch, copy.deepcopy(base).to(dev), x, y, dev)
    t_card = time.monotonic() - t0
    l_cpu, l_card = float(cpu["loss"].mean()), float(card["loss"].mean())
    errs = resnet_errors(np, card, cpu)
    print(f"ResNet-50 step, B={RESNET_B_CPU}, {IMAGE}x{IMAGE}: CPU "
          f"{t_cpu:.2f} s, card {t_card:.2f} s (first call); loss card "
          f"{l_card:.7f} cpu {l_cpu:.7f}; card against CPU: {_fmt(errs)} "
          f"over {len(cpu['running'])} moving statistics and "
          f"{len(cpu['grads'])} gradients (tol: loss 1e-5, logits and "
          f"moving statistics {RESNET_FWD_TOL:g}, gradient norms "
          f"{RESNET_GRAD_TOL:g})", flush=True)
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), (l_card, l_cpu)
    assert errs["logits"][0] <= RESNET_FWD_TOL, errs
    assert errs["running"][0] <= RESNET_FWD_TOL, errs
    assert errs["grad_norm"][0] <= RESNET_GRAD_TOL, errs
    return errs, noise


def compare_bottlenecks(torch, np, dev):
    """Phase 7 (a): one full-width bottleneck of each kind, training
    forward + backward of (out*out).mean() on the card against the CPU.
    Each gradient is held to BLOCK_GRAD_TOL of its largest value, or to
    twice the CPU path's own response to a 1e-6 move of the input where
    that is larger (measured first, per tensor)."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BottleneckV1)
    worst = 0.0
    for label, ch, stride, down in (("stage-1 identity", 256, 1, False),
                                    ("stage-2 projection", 512, 2, True)):
        base = BottleneckV1(ch, stride, down, in_channels=256, layout="NHWC",
                            fused=True).initialize(
            device="cpu", generator=torch.Generator().manual_seed(1))
        x = np.random.RandomState(1).rand(RESNET_B_CPU, 56, 56, 256).astype(
            np.float32)
        res = []
        for where, xin in (("cpu", x), ("cpu", x + np.float32(1e-6)),
                           (dev, x)):
            blk = copy.deepcopy(base).to(where)
            with autograd.record():
                out = blk(torch.from_numpy(xin).to(where))
                loss = (out * out).mean()
            autograd.backward(loss)
            res.append((out.detach().cpu().numpy(),
                        {k: v for k, v in grads_to_numpy(blk).items()
                         if "running" not in k},
                        {k: v for k, v in params_to_numpy(blk).items()
                         if "running" in k}))
        (o_cpu, g_cpu, r_cpu), (_, g_moved, _), (o_card, g_card, r_card) = res
        out_r = worst_ratio(np, {"out": o_card}, {"out": o_cpu})
        run_r = worst_ratio(np, r_card, r_cpu)
        assert out_r[0] <= BLOCK_TOL and run_r[0] <= BLOCK_TOL, (out_r, run_r)
        bounds, ratios = {}, {}
        for k, want in g_cpu.items():
            noise = worst_ratio(np, {k: g_moved[k]}, {k: want})[0]
            bounds[k] = max(BLOCK_GRAD_TOL, 2 * noise)
            ratios[k] = worst_ratio(np, {k: g_card[k]}, {k: want})[0]
            assert ratios[k] <= bounds[k], (k, ratios[k], noise)
        name = max(ratios, key=ratios.get)
        widened = {k: round(b / 2, 6) for k, b in bounds.items()
                   if b > BLOCK_GRAD_TOL}
        worst = max(worst, ratios[name])
        print(f"bottleneck {label} ({RESNET_B_CPU}, 56, 56, 256) -> "
              f"{o_card.shape}: out max|d|/max = {out_r[0]:.3e}, moving "
              f"statistics {run_r[0]:.3e} (tol {BLOCK_TOL:g}); "
              f"{len(g_cpu)} gradients worst {ratios[name]:.3e} ({name}, "
              f"bound {bounds[name]:.3e}); tol {BLOCK_GRAD_TOL:g}, or twice "
              f"the CPU's own response to a 1e-6 input move where larger: "
              f"{widened}", flush=True)
    return worst


_KERNEL_COUNTERS = {  # kernels line name -> fuse.kernel_launches() key
    "fused_matmul_bn_fwd": "fused_block.fwd_launches",
    "fused_matmul_bn_dx": "fused_block.dx_launches",
    "fused_matmul_bn_dw": "fused_block.dw_launches",
    "fused_conv3_bn_fwd": "fused_conv.fwd_launches",
    "fused_conv3_bn_dx": "fused_conv.dx_launches",
    "fused_conv3_bn_dw": "fused_conv.dw_launches",
    "softmax_xent_fwd": "softmax_xent.fwd_launches",
    "softmax_xent_bwd": "softmax_xent.bwd_launches",
    "softmax_fwd": "softmax.fwd_launches",
    "softmax_bwd": "softmax.bwd_launches",
    "rms_norm_fwd": "rms_norm.fwd_launches",
    "rms_norm_bwd": "rms_norm.bwd_launches",
    "flash_attention_fwd": "flash_attention.fwd_launches",
    "flash_attention_bwd_dkdv": "flash_attention.bwd_dkdv_launches",
    "flash_attention_bwd_dq": "flash_attention.bwd_dq_launches"}


# the kernels with a bfloat16 tensor-core instance beside a float32 one
# (the 3xTF32 tile), by their counters' names
_MMA_INSTANCES = ("fused_matmul_bn_fwd", "fused_matmul_bn_dx",
                  "fused_matmul_bn_dw", "fused_conv3_bn_fwd",
                  "fused_conv3_bn_dx", "fused_conv3_bn_dw")


def zero_launches():
    """Set every kernel wrapper's launch counter to 0, and ``rtc``'s."""
    import importlib
    from incubator_mxnet_tpu_torch import rtc
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    for key in kernel_launches():
        mod, attr = key.split(".")
        setattr(importlib.import_module(
            f"incubator_mxnet_tpu_torch.ops.{mod}"), attr, 0)
    rtc.launches = 0


def resnet_step_launches():
    """Launches of each kernel in one ResNet-50 training step: 36 of each
    fused 1x1 (c1 and c3 of 16 bottlenecks, 4 projections), 16 of each
    fused 3x3, one of each cross-entropy kernel."""
    mm, c3 = len(resnet_fmm_shapes(RESNET_B)), len(resnet_conv3_shapes(
        RESNET_B))
    return {"fused_matmul_bn_fwd": mm, "fused_matmul_bn_dx": mm,
            "fused_matmul_bn_dw": mm, "fused_conv3_bn_fwd": c3,
            "fused_conv3_bn_dx": c3, "fused_conv3_bn_dw": c3,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}


def train_resnet50(torch, np, dev):
    """Phase 7; returns the ResNet training path's launch counts."""
    from incubator_mxnet_tpu_torch.examples.train_resnet_fused import (
        build, synthetic_batch, train_step)
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    compare_resnet_step(torch, np, dev)
    compare_bottlenecks(torch, np, dev)

    gc.collect()
    torch.cuda.empty_cache()
    net, trainer, loss_fn = build(CLASSES, dev)
    x, y = (torch.from_numpy(a).to(dev)
            for a in synthetic_batch(RESNET_B, IMAGE, CLASSES))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()                                     # path starts
    losses, step_ms = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.monotonic()
        loss = train_step(net, trainer, loss_fn, x, y)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(loss.mean().item())
    launched = kernel_launches()                        # path ends
    counts = {k: launched[_KERNEL_COUNTERS[k]]
              for k in resnet_step_launches()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{RESNET_STEPS} steps at B={RESNET_B}, {IMAGE}x{IMAGE}, "
          f"{CLASSES} classes, SGD lr 0.01 momentum 0.9: losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    assert np.isfinite(losses).all() and min(losses[1:]) < losses[0], losses
    want = resnet_step_launches()
    for k, n in want.items():
        assert counts[k] == n * RESNET_STEPS, (k, counts[k])
    med = statistics.median(step_ms[2:])
    print(f"training path launches: {counts} ({want} a step)", flush=True)
    print(f"step time, host clock around a synchronised step: median over "
          f"steps 3-{RESNET_STEPS} {med:.3f} ms ({RESNET_B / med * 1e3:.2f} "
          f"img/s), min {min(step_ms[2:]):.3f} ms, all "
          f"{[round(v, 3) for v in step_ms]}; peak device memory "
          f"{peak} bytes ({peak / 2**30:.2f} GiB)", flush=True)

    def fwd_bwd():
        from incubator_mxnet_tpu_torch import autograd
        with autograd.record():
            loss = loss_fn(net(x), y)
        autograd.backward(loss)
        torch.cuda.synchronize()

    def update():
        trainer.step(RESNET_B)
        torch.cuda.synchronize()

    step_breakdown(torch, fwd_bwd, update, _RESNET_FAMILIES)
    return counts


def step_state(step):
    """A fused step's parameters, moving statistics and momenta, copied
    to the host as float32 numpy arrays."""
    tensors = {**step.params, **step.aux,
               **{f"mom:{k}": v for k, v in step.opt_state["mom"].items()}}
    return {k: v.detach().float().cpu().numpy() for k, v in tensors.items()}


def compare_graph_to_eager(torch, np, dev):
    """Phase 8 (a): the bench path's step in float32 at B=8, by graph
    replay (one eager warm-up call that captures, then replays) against
    the same step code run eagerly on the card, from the same weights
    and batch, cuDNN deterministic."""
    from incubator_mxnet_tpu_torch import bench
    torch.backends.cudnn.deterministic = True
    try:
        graph, x, y = bench.build(GRAPH_B, "float32", dev)
        eager, _, _ = bench.build(GRAPH_B, "float32", dev)
        by_graph = [graph(x, y).item() for _ in range(GRAPH_CALLS)]
        by_eager = [eager.step_fn(x, y).item() for _ in range(GRAPH_CALLS)]
    finally:
        torch.backends.cudnn.deterministic = False
    assert len(graph._graphs) == 1 and not eager._graphs
    worst = worst_ratio(np, step_state(graph), step_state(eager))
    loss_d = max(abs(a - b) / abs(b) for a, b in zip(by_graph, by_eager))
    print(f"graph replay against eager, float32, B={GRAPH_B}, "
          f"{GRAPH_CALLS} calls (1 warm-up + capture, then replays): losses "
          f"{by_graph} against {by_eager} (max relative {loss_d:.3e}); "
          f"{len(step_state(eager))} parameters, moving statistics and "
          f"momenta, worst max|d|/max|eager| {worst[0]:.3e} ({worst[1]}) "
          f"(tol {GRAPH_TOL:g})", flush=True)
    assert np.isfinite(by_graph).all() and loss_d <= GRAPH_TOL, (by_graph,
                                                                 by_eager)
    assert worst[0] <= GRAPH_TOL, worst
    return worst[0]


def bench_path(torch, np, dev, smi):
    """Phase 8; returns the bench path's launch counts (the eager warm-up
    step and the capture)."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import bench
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    compare_graph_to_eager(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()

    want = {_KERNEL_COUNTERS[k]: n for k, n in resnet_step_launches().items()}
    probe, x, y = bench.build(BENCH_B, "bfloat16", dev)
    before = kernel_launches()
    probe.step_fn(x, y)
    torch.cuda.synchronize()
    eager = {k: v - before[k] for k, v in kernel_launches().items()
             if v != before[k]}
    print(f"one eager bfloat16 step at B={BENCH_B}: launches {eager}",
          flush=True)
    assert eager == want, (eager, want)
    del probe, x, y
    gc.collect()
    torch.cuda.empty_cache()

    step, x, y = bench.build(BENCH_B, "bfloat16", dev)
    zero_launches()                                     # path starts
    res = bench.timed(step, x, y, BENCH_STEPS, BENCH_WARMUP)
    launched = kernel_launches()                        # path ends
    counts = {k: launched[_KERNEL_COUNTERS[k]]
              for k in resnet_step_launches()}
    (captured,) = step.capture_launches.values()
    print(f"capture's launches {captured}", flush=True)
    assert captured == want, (captured, want)
    for k, v in counts.items():
        assert v == 2 * want[_KERNEL_COUNTERS[k]], (k, v)
    losses = res["losses"]
    print(f"bench path, bfloat16, B={BENCH_B}: {BENCH_WARMUP} warm-up and "
          f"{BENCH_STEPS} timed steps, losses {[round(v, 4) for v in losses]}",
          flush=True)
    assert np.isfinite(losses).all(), losses
    assert min(losses[1:]) < losses[0], losses
    print(f"{res['metric']}: {res['value']:.2f} img/s; step median "
          f"{res['step_ms_median']:.3f} ms, min {res['step_ms_min']:.3f} ms, "
          f"all {[round(v, 3) for v in res['step_ms']]} (host clock around "
          f"a replay and a synchronise); mfu_pct {res['mfu_pct']:.3f} of "
          f"{res['sku']} bf16 {res['peak_flops']:.4g} FLOP/s (floor "
          f"{res['floor_ms']:.3f} ms); peak device memory "
          f"{res['peak_memory_bytes']} bytes "
          f"({res['peak_memory_bytes'] / 2**30:.2f} GiB); warm-up (eager step "
          f"+ capture, then one replay) {res['warmup_s']:.2f} s; {smi}",
          flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(x, y)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    fams = device_families(prof, _RESNET_FAMILIES)
    busy = sum(fams.values())
    print(f"  profiled replay: the profiler "
          f"{'sees' if busy else 'does NOT see'} the graph's kernel nodes; "
          f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; by family (ms): "
          f"{({k: round(v, 4) for k, v in sorted(fams.items())})}",
          flush=True)
    return counts


def compare_transformer_step(torch, np, dev, attention):
    """Phases 9 and 10 (a): one float32 SGD step of the TransformerLM at
    full width, B=2, T=129, on the card against the CPU path from the
    same weights and tokens: the loss and every gradient."""
    from incubator_mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    cpu = TransformerLM(TransformerConfig(
        dtype="float32", attention=attention)).init(
        torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(dev)
    tokens = torch.randint(0, TF_VOCAB, (TF_B_CPU, TF_T_CPU),
                           generator=torch.Generator().manual_seed(1))
    res = []
    for model in (cpu, card):
        params = list(model.parameters())
        t0 = time.monotonic()
        loss = model.loss(tokens.to(params[0].device))
        grads = torch.autograd.grad(loss, params)
        res.append((loss.item(), [g.cpu().numpy() for g in grads],
                    time.monotonic() - t0))
    (l_cpu, g_cpu, t_cpu), (l_card, g_card, t_card) = res
    names = [n for n, _ in cpu.named_parameters()]
    worst = worst_ratio(np, dict(zip(names, g_card)), dict(zip(names, g_cpu)))
    print(f"TransformerLM ({attention}) float32 step, B={TF_B_CPU}, "
          f"T={TF_T_CPU}: CPU "
          f"{t_cpu:.2f} s, card {t_card:.2f} s (first call); loss card "
          f"{l_card:.7f} cpu {l_cpu:.7f} (tol {TF_LOSS_TOL:g} relative); "
          f"{len(names)} gradients, worst max|d|/max|g| {worst[0]:.3e} "
          f"({worst[1]}, tol {TF_GRAD_TOL:g})", flush=True)
    assert np.isfinite(l_card) and abs(l_card - l_cpu) <= TF_LOSS_TOL * abs(
        l_cpu), (l_card, l_cpu)
    assert worst[0] <= TF_GRAD_TOL, worst
    return worst[0]


def transformer_step_launches(attention):
    """Launches of each kernel in one TransformerLM step at the default
    config: one attention a layer (the softmax pair for "gspmd", the
    flash forward, dk/dv and dq kernels for "flash", none of the other)
    and two RMSNorms a layer plus ln_f, forward and backward, and one
    cross-entropy pair."""
    layers = 4
    soft, flash = (layers, 0) if attention == "gspmd" else (0, layers)
    return {"softmax_fwd": soft, "softmax_bwd": soft,
            "flash_attention_fwd": flash, "flash_attention_bwd_dkdv": flash,
            "flash_attention_bwd_dq": flash,
            "rms_norm_fwd": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}


def train_transformer(torch, np, dev, smi, attention):
    """Phase 9 ("gspmd") or 10 ("flash"); returns the path's launch
    counts."""
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    compare_transformer_step(torch, np, dev, attention)
    gc.collect()
    torch.cuda.empty_cache()

    model = TransformerLM(TransformerConfig(attention=attention)).init(
        torch.Generator().manual_seed(0), dev)
    step = model.make_train_step(lr=1e-3)
    gen = torch.Generator().manual_seed(1)
    batches = [torch.randint(0, TF_VOCAB, (TF_B, TF_T), generator=gen).to(dev)
               for _ in range(TF_STEPS + 2)]
    want = transformer_step_launches(attention)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()                                     # path starts
    losses, step_ms = [], []
    for i in range(TF_STEPS + 1):
        t0 = time.monotonic()
        losses.append(step(batches[i]).item())
        step_ms.append((time.monotonic() - t0) * 1e3)
        if i == 0:
            first = kernel_launches()
            one = {k: first[v] for k, v in _KERNEL_COUNTERS.items()
                   if k in want}
            print(f"one bfloat16 step ({attention}) at B={TF_B}, T={TF_T}: "
                  f"launches {one}", flush=True)
            assert one == want, (one, want)
    launched = kernel_launches()                        # path ends
    counts = {k: launched[_KERNEL_COUNTERS[k]] for k in want}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{TF_STEPS + 1} steps, SGD lr 1e-3, fresh tokens each step: "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    assert np.isfinite(losses).all(), losses
    assert abs(losses[0] - np.log(TF_VOCAB)) < 0.5, losses[0]
    for k, n in want.items():
        assert counts[k] == n * (TF_STEPS + 1), (k, counts[k])
    tokens = TF_B * (TF_T - 1)
    # matrix products a token (forward): qkv, out, the two FFN layers and
    # the tied head, plus q·kᵀ and p·v over all T keys; backward twice
    flops_tok = 3 * 2 * (4 * (3 * TF_D * TF_D + TF_D * TF_D
                              + 2 * TF_D * 2048 + 2 * (TF_T - 1) * TF_D)
                         + TF_D * TF_VOCAB)
    med = statistics.median(step_ms[2:])
    print(f"training path launches: {counts} ({want} a step)", flush=True)
    print(f"step time, host clock around a step and the loss's .item(): "
          f"median over steps 3-{TF_STEPS + 1} {med:.3f} ms "
          f"({tokens / med * 1e3:.0f} tokens/s), min "
          f"{min(step_ms[2:]):.3f} ms, all {[round(v, 3) for v in step_ms]}; "
          f"{flops_tok * tokens / 1e12:.3f} TFLOP of matrix products a step "
          f"({flops_tok / 1e6:.1f} MFLOP a token), "
          f"{flops_tok * tokens / med / 1e9:.1f} TFLOP/s achieved, bf16 "
          f"floor {flops_tok * tokens / BF16_PEAK * 1e3:.3f} ms; peak device "
          f"memory {peak} bytes ({peak / 2**30:.2f} GiB); {smi}", flush=True)

    def whole():
        step(batches[-1])
        torch.cuda.synchronize()

    profile_window(torch, f"TransformerLM step ({attention})", whole,
                   _TF_FAMILIES)
    del model, step, batches
    return counts


def ulp(torch, v):
    """The spacing of ``v``'s floating type at each |v|."""
    a = v.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def rtc_saxpy_inputs(torch, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(RTC_N, generator=g, device=dev),
            torch.randn(RTC_N, generator=g, device=dev))


def rtc_main_path(torch, rtc, dev):
    """Phase 11's main path: a user's CUDA C compiled by ``CudaModule``
    and launched on tensors, as reference MXNet's rtc is used; returns
    the outputs for the checks, which run after the counter is read."""
    from incubator_mxnet_tpu_torch import context
    from incubator_mxnet_tpu_torch._cuda_driver import (nvrtc_path,
                                                        nvrtc_version)
    t0 = time.perf_counter()
    saxpy_mod = rtc.CudaModule(RTC_SAXPY)
    print(f"NVRTC {nvrtc_version()} loaded from {nvrtc_path()}; the first "
          f"module (library load included) in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    mods = {"saxpy": saxpy_mod,
            "axpy": rtc.CudaModule(RTC_AXPY,
                                   exports=["axpy<float>", "axpy<__half>"]),
            "block_sum": rtc.CudaModule(RTC_BLOCK_SUM),
            "iota64": rtc.CudaModule(RTC_IOTA64)}
    for name, mod in mods.items():
        print(f"NVRTC compile of {name}: {mod.compile_seconds * 1e3:.1f} ms "
              f"(cubin {len(mod._cubin)} bytes)", flush=True)
    saxpy = saxpy_mod.get_kernel(
        "saxpy", "const float *x, float *y, float alpha, int n")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid, block = (sms * 32,), (256,)
    out = {}
    # (a) on the current stream, then on a side stream; a torch op reads
    # each result on the stream that launched it, with no synchronise
    x, y = rtc_saxpy_inputs(torch, dev, 0)
    y0 = y.clone()
    saxpy.launch([x, y, RTC_ALPHA, RTC_N], context.gpu(dev.index), grid,
                 block)
    out["saxpy"] = (x, y0, y.clone())
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ys = y0.clone()
        saxpy.launch([x, ys, RTC_ALPHA, RTC_N], dev, grid, block)
        out["saxpy_side"] = ys * 1.0
    torch.cuda.current_stream(dev).wait_stream(side)
    # (b) a template through exports, float and __half
    n = 1 << 20
    for ctype, dtype in (("float", torch.float32), ("__half", torch.float16)):
        g = torch.Generator(device=dev).manual_seed(1)
        xa = torch.randn(n, generator=g, device=dev).to(dtype)
        ya = torch.randn(n, generator=g, device=dev).to(dtype)
        ya0 = ya.clone()
        k = mods["axpy"].get_kernel(
            f"axpy<{ctype}>", f"const {ctype} *x, {ctype} *y, {ctype} alpha, "
            "int n")
        k.launch([xa, ya, RTC_ALPHA, n], dev, ((n + 255) // 256,), (256,))
        out[f"axpy<{ctype}>"] = (xa, ya0, ya)
    # (c) 64 KiB of dynamic shared memory a block, on a ragged length
    g = torch.Generator(device=dev).manual_seed(2)
    xs = torch.randn(RTC_SUM_N, generator=g, device=dev)
    blocks = -(-RTC_SUM_N // RTC_CHUNK)
    sums = torch.empty(blocks, device=dev)
    mods["block_sum"].get_kernel(
        "block_sum", "const float *x, float *out, int n, int chunk").launch(
        [xs, sums, RTC_SUM_N, RTC_CHUNK], dev, (blocks,), (256,),
        shared_mem=RTC_CHUNK * 4)
    out["block_sum"] = (xs, sums)
    # (d) an int64_t scalar above 2^32
    start, m = 3 * 2 ** 33 + 5, 1000
    iota = torch.empty(m, dtype=torch.int64, device=dev)
    mods["iota64"].get_kernel(
        "iota64", "int64_t *out, int64_t start, int n").launch(
        [iota, start, m], dev, (4,), (256,))
    out["iota64"] = (start, iota)
    return mods, saxpy, grid, block, out


def check_rtc(torch, rtc, mods, saxpy, grid, block, out, dev):
    """Phase 11's checks: each user kernel against its plain version,
    the errors that must raise, and ``PallasModule`` on the card against
    the CPU.  Returns saxpy's max |kernel - plain|."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.error import KernelError
    torch.cuda.synchronize()
    x, y0, y = out["saxpy"]
    # the kernel's alpha is the float32 rounding of RTC_ALPHA (its __half
    # rounding in axpy<__half>)
    a32 = torch.tensor(RTC_ALPHA, dtype=torch.float32).double().item()
    want = (a32 * x.double() + y0.double()).float()
    err = (y - want).abs()
    ulps = (err / ulp(torch, want)).max().item()
    two_round = (RTC_ALPHA * x + y0 - y).abs().max().item()
    assert ulps <= 1.0, ulps
    assert torch.equal(out["saxpy_side"], y), "side stream differs"
    max_err = err.max().item()
    print(f"saxpy n={RTC_N} float32, grid {grid[0]}x{block[0]}: within "
          f"{ulps:.3f} ulp of alpha*x + y rounded once (max|d| "
          f"{max_err:.3e}; {(err > 0).sum().item()} of {RTC_N} values "
          f"differ), max|d| {two_round:.3e} against alpha*x + y in float32 "
          "(two roundings); the side stream's result equal bit for bit",
          flush=True)
    for ctype, dtype in (("float", torch.float32), ("__half", torch.float16)):
        xa, ya0, ya = (t.cpu() for t in out[f"axpy<{ctype}>"])
        a = torch.tensor(RTC_ALPHA, dtype=dtype).double().item()
        want = (a * xa.double() + ya0.double()).to(dtype)
        allow = ulp(torch, want).double()
        if dtype == torch.float16:
            allow = allow + ulp(torch, (a * xa.double()).to(dtype)).double()
        worst = ((ya.double() - want.double()).abs() / allow).max().item()
        assert worst <= 1.0, (ctype, worst)
        print(f"axpy<{ctype}> through exports: worst |d| / allowance "
              f"{worst:.3f}", flush=True)
    xs, sums = out["block_sum"]
    pad = sums.numel() * RTC_CHUNK - RTC_SUM_N
    blocked = F.pad(xs, (0, pad)).reshape(-1, RTC_CHUNK)
    want = blocked.sum(1)
    scale = blocked.abs().sum(1)
    worst = ((sums - want).abs() / scale).max().item()
    assert worst <= RTC_SUM_TOL, worst
    print(f"block_sum n={RTC_SUM_N} ({sums.numel()} blocks, the "
          f"last of {RTC_SUM_N % RTC_CHUNK}) with {RTC_CHUNK * 4} B of "
          f"shared memory a block: worst |d| / sum|x| {worst:.3e} (tol "
          f"{RTC_SUM_TOL:g})", flush=True)
    start, iota = out["iota64"]
    assert torch.equal(iota.cpu(), start + 3 * torch.arange(iota.numel())), \
        "iota64"
    print(f"iota64 with an int64_t scalar {start}: exact", flush=True)
    # (e)-(f) what must raise; none of it launches
    before = rtc.launches
    try:
        rtc.CudaModule(RTC_BROKEN)
        raise AssertionError("a syntax error compiled")
    except KernelError as e:
        msg = str(e)
        assert "nvrtcCompileProgram" in msg and "error" in msg, msg
        print("syntax error raises KernelError with NVRTC's log: "
              + " | ".join(msg.splitlines()[1:3]), flush=True)
    xt, yt = x[:1024], y[:1024].clone()
    bad = {"a CPU tensor": ([xt.cpu(), yt, 1.0, 1024], ValueError),
           "a wrong dtype": ([xt.double(), yt, 1.0, 1024], TypeError),
           "a wrong argument count": ([xt, yt, 1.0], ValueError),
           "a non-contiguous tensor": ([x[:2048:2], yt, 1.0, 1024],
                                       ValueError),
           "a tensor for a scalar": ([xt, yt, xt, 1024], TypeError)}
    for what, (args, exc) in bad.items():
        try:
            saxpy.launch(args, dev, (4,), (256,))
            raise AssertionError(f"{what} launched")
        except exc as e:
            print(f"{what} raises {type(e).__name__}: {e}", flush=True)
    try:
        rtc.CudaModule(RTC_MANGLED).get_kernel("scale", "float *x").launch(
            [yt], dev, (1,), (32,))
        raise AssertionError("a mangled name was found")
    except KernelError as e:
        print(f"a C++ name without exports raises: {e}", flush=True)
    assert rtc.launches == before, "a refused launch was counted"
    # (g) PallasModule on the card against the same on the CPU
    def saxpy_ref(x_ref, y_ref, o_ref, *, alpha):
        o_ref[...] = x_ref[...] * alpha + y_ref[...]

    def rows(x_ref, o_ref):
        i = rtc.program_id(0)
        o_ref[i] = x_ref[i] * (i + 1) + rtc.num_programs(0)

    g = torch.Generator().manual_seed(3)
    xp, yp = torch.randn(8, 128, generator=g), torch.randn(8, 128, generator=g)
    k1 = rtc.PallasModule(saxpy_ref, num_inputs=2,
                          static_args=("alpha",)).get_kernel(
        "saxpy_ref", alpha=RTC_ALPHA)
    k2 = rtc.CudaModule(rows).get_kernel("rows")
    for name, run in (("saxpy", lambda d: k1.launch([xp.to(d), yp.to(d)])),
                      ("grid of 8 with program_id",
                       lambda d: k2.launch([xp.to(d)], grid_dims=(8,)))):
        got, want = run(dev).cpu(), run("cpu")
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        print(f"PallasModule {name}: card equals CPU to 1e-6 (max|d| "
              f"{(got - want).abs().max().item():.3e})", flush=True)
    return max_err


def time_rtc(torch, saxpy, grid, block, dev, rate):
    """saxpy's times at n = 2^26 + 3 (two input pairs of 537 MB, ten
    times L2), against its plain version ``alpha * x + y`` and
    ``torch.add(y, x, alpha=alpha)``; then the host time of one launch
    of a one-block grid, against one small ``torch.add``."""
    sets = [rtc_saxpy_inputs(torch, dev, s) for s in (4, 5)]
    times = {
        "ms": time_ms(torch, lambda x, y: saxpy.launch(
            [x, y, RTC_ALPHA, RTC_N], dev, grid, block), sets),
        "plain_ms": time_ms(torch, lambda x, y: RTC_ALPHA * x + y, sets),
        "library_ms": time_ms(torch, lambda x, y: torch.add(
            y, x, alpha=RTC_ALPHA), sets)}
    xt, yt = sets[0][0][:32], sets[0][1][:32].clone()
    host = {}
    for name, fn in (("saxpy launch", lambda: saxpy.launch(
            [xt, yt, RTC_ALPHA, 32], dev, (1,), (32,))),
                     ("torch.add", lambda: torch.add(yt, xt,
                                                     alpha=RTC_ALPHA))):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn()
        host[name] = (time.perf_counter() - t0) / 2000 * 1e3
        torch.cuda.synchronize()
    print(f"host time of one call of a one-block grid (2000 calls, no "
          f"synchronise): saxpy through rtc {host['saxpy launch']:.4f} ms, "
          f"torch.add {host['torch.add']:.4f} ms", flush=True)
    del sets
    # x and y read, y written, float32; 2 FLOP an element
    return report(f"rtc saxpy n={RTC_N} float32", times, 3 * 4 * RTC_N, rate,
                  2 * RTC_N)


def rtc_phase(torch, dev, rate):
    """Phase 11: returns (saxpy's kernels-line numbers, max error, the
    main path's launches)."""
    from incubator_mxnet_tpu_torch import rtc
    zero_launches()                                     # main path starts
    mods, saxpy, grid, block, out = rtc_main_path(torch, rtc, dev)
    torch.cuda.synchronize()
    launched = rtc.launches                             # main path ends
    assert launched == 6, f"{launched} rtc launches, want 6"
    print(f"rtc main path: {launched} launches (saxpy on two streams, "
          "axpy<float>, axpy<__half>, block_sum, iota64)", flush=True)
    err = check_rtc(torch, rtc, mods, saxpy, grid, block, out, dev)
    del out
    times = time_rtc(torch, saxpy, grid, block, dev, rate)
    return times, err, launched


_LENET_FAMILIES = (
    ("xent", ("xent",)),
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "winograd",
              "implicit", "fft")),
    ("gemm", ("gemm", "splitk", "cutlass", "nvjet", "xmma")),
    ("pooling", ("pool",)),
    ("elementwise", ("elementwise", "reduce", "fill", "copy")),
    ("memcpy", ("memcpy", "memset")))


def compare_lenet_step(torch, np, dev):
    """Phase 12 (a): one Adam step of LeNet on the CPU and on the card,
    from the same weights (carried by ``params_from_jax`` into the
    card's still-deferred layers) and batch."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.examples.train_mnist import (
        lenet, synthetic_data)
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    x, y = (torch.from_numpy(a) for a in synthetic_data(MNIST_B, seed=7))
    cpu = lenet()
    cpu.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        cpu(x)                                  # materialise the weights
    card = lenet()
    card.initialize(device=dev)
    params_from_jax(params_to_numpy(cpu), card)
    results = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        trainer = Trainer(net.collect_params(), "adam",
                          {"learning_rate": MNIST_LR}, kvstore="device")
        xb, yb = x.to(where), y.to(where)
        t0 = time.monotonic()
        with autograd.record():
            loss = SoftmaxCrossEntropyLoss()(net(xb), yb).mean()
        autograd.backward(loss)
        grads = grads_to_numpy(net)
        before = params_to_numpy(net)
        trainer.step(MNIST_B)
        after = params_to_numpy(net)
        results.append((loss.item(), grads, after,
                        {k: after[k] - before[k] for k in after},
                        time.monotonic() - t0))
    return check_step(np, results, MNIST_GRAD_TOL, MNIST_LR)


def lenet_phase(torch, np, dev):
    """Phase 12 (b)-(c); returns the LeNet path's launch counts."""
    from incubator_mxnet_tpu_torch import random
    from incubator_mxnet_tpu_torch.examples import train_mnist as tm
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.gluon import Trainer, data, metric
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    random.seed(0)
    net = tm.lenet()
    net.initialize(device=dev)
    images, labels = tm.synthetic_data(MNIST_N)
    loader = data.DataLoader(data.ArrayDataset(images, labels),
                             batch_size=MNIST_B, shuffle=True,
                             last_batch="discard", pin_memory=True)
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": MNIST_LR}, kvstore="device")
    loss_fn = SoftmaxCrossEntropyLoss()
    acc = metric.Accuracy()
    xent = ("softmax_xent.fwd_launches", "softmax_xent.bwd_launches")
    stamps, losses, bad = [], [], []
    last = {}

    def on_step(loss, out):
        now = kernel_launches()
        step = {k: now[k] - last.get(k, 0) for k in xent}
        if step != {k: 1 for k in xent}:
            bad.append(step)
        last.update(now)
        losses.append(loss.mean().item())
        stamps.append(time.perf_counter())

    zero_launches()                                     # main path starts
    last.update(kernel_launches())
    epochs = []
    for _ in range(MNIST_EPOCHS):
        acc.reset()
        stamps.append(time.perf_counter())
        t0 = time.perf_counter()
        tm.run_epoch(net, loader, trainer, loss_fn, acc, dev, MNIST_B,
                     on_step)
        torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t0, acc.get()[1]))
    launched = kernel_launches()                        # main path ends
    steps = MNIST_EPOCHS * (MNIST_N // MNIST_B)
    assert len(losses) == steps, len(losses)
    assert not bad, f"cross-entropy launches a step: {bad[:3]}"
    assert all(np.isfinite(losses)), "a loss is not finite"
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])
               if b > a]
    med = statistics.median(step_ms)
    print(f"LeNet, examples/train_mnist.py's loop: {MNIST_EPOCHS} epochs x "
          f"{MNIST_N // MNIST_B} steps at B={MNIST_B}; 1/1 cross-entropy "
          f"launches every step; losses finite, first {losses[0]:.4f}, last "
          f"{losses[-1]:.4f}; epochs (s, accuracy): "
          f"{[(round(t, 3), round(a, 4)) for t, a in epochs]}", flush=True)
    print(f"LeNet step: median {med:.3f} ms (host clock, data loading and "
          f"the metric included), {MNIST_B / med * 1e3:.0f} samples/s; "
          f"epoch samples/s {[round(MNIST_N / t) for t, _ in epochs]}",
          flush=True)
    batches = iter(loader)

    def five_steps():
        for _ in range(5):
            xb, yb = next(batches)
            tm.run_epoch(net, [(xb, yb)], trainer, loss_fn, acc, dev,
                         MNIST_B)
        torch.cuda.synchronize()

    profile_window(torch, "5 LeNet steps", five_steps, _LENET_FAMILIES)
    # (c) the overfit drive: one fixed batch, 60 steps
    random.seed(1)
    net = tm.lenet()
    net.initialize(device=dev)
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": MNIST_LR}, kvstore="device")
    x = random.uniform(shape=(MNIST_B, 1, 28, 28), device=dev)
    y = random.randint(0, 10, shape=(MNIST_B,), device=dev).float()
    fit = [tm.train_step(net, trainer, loss_fn, x, y, MNIST_B)[0].mean()
           .item() for _ in range(OVERFIT_STEPS)]
    acc.reset()
    acc.update([y], [net(x)])
    train_acc = acc.get()[1]
    print(f"overfit one batch, {OVERFIT_STEPS} steps: loss {fit[0]:.4f} -> "
          f"{fit[-1]:.4f} (must fall below {OVERFIT_LOSS}), training "
          f"accuracy {train_acc:.3f} (above {OVERFIT_ACC})", flush=True)
    assert abs(fit[0] - math.log(10)) < 0.5 and fit[-1] < OVERFIT_LOSS, fit
    assert train_acc > OVERFIT_ACC, train_acc
    return {name: launched[key] for name, key in _KERNEL_COUNTERS.items()}


def time_lenet_xent(torch, sx, dev):
    """The cross-entropy kernels at LeNet's (64, 10) float32 logits,
    against ``F.cross_entropy``: launch-bound times."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(8)
    sets = []
    for _ in range(3):
        x = torch.randn(MNIST_B, 10, generator=g, device=dev)
        lbl = torch.randint(0, 10, (MNIST_B,), generator=g, device=dev)
        sets.append((x, lbl))
    fwd = time_ms(torch, sx.softmax_xent_fwd, sets)
    lib = time_ms(torch, lambda x, lbl: F.cross_entropy(x, lbl.long(),
                                                        reduction="none"),
                  sets)
    print(f"softmax_xent_fwd at ({MNIST_B}, 10) float32: device {fwd[0]} "
          f"stream {fwd[1]:.6f} ms; F.cross_entropy device {lib[0]} stream "
          f"{lib[1]:.6f} ms", flush=True)


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/bert:predict",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out, (time.monotonic() - t0) * 1e3


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    from incubator_mxnet_tpu_torch.deploy import export_model
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops import _build, layer_norm as ln
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    from incubator_mxnet_tpu_torch.ops import rms_norm as rn
    from incubator_mxnet_tpu_torch.ops import softmax as sm
    from incubator_mxnet_tpu_torch.ops import softmax_xent as sx
    from incubator_mxnet_tpu_torch.serving.server import InferenceServer

    phase("1 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    rate, rate_note = memory_rate(kind)
    dev = torch.device("cuda", 0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}; "
          f"memory rate assumed {rate_note}", flush=True)

    phase("2 build")
    t0 = time.monotonic()
    logs = _build.build(_build.kernel_names())
    print(f"build: {time.monotonic() - t0:.2f} s "
          f"({', '.join(logs) or 'already built'})", flush=True)
    for log in logs.values():
        for line in log.splitlines():
            if "spill" in line or "ptxas info" in line and (
                    "registers" in line or "Compiling" in line):
                print("  " + line.strip(), flush=True)

    phase("3 kernels against plain versions")
    ln_err = check_layer_norm(torch, ln, dev)
    ln_times = time_layer_norm(torch, ln, dev, "float32", rate)
    time_layer_norm(torch, ln, dev, "bfloat16", rate)
    for rows in (B * T, ROWS):   # BERT's bf16 path: float32 gamma and beta
        time_layer_norm(torch, ln, dev, "bfloat16", rate, rows, "float32")
    ln_bwd_err = check_layer_norm_bwd(torch, ln, dev)
    ln_bwd_times = time_layer_norm_bwd(torch, ln, dev, "float32", rate)
    time_layer_norm_bwd(torch, ln, dev, "bfloat16", rate)
    xent_fwd_err, xent_bwd_err = check_softmax_xent(torch, sx, dev)
    xent_fwd_times, xent_bwd_times = time_softmax_xent(torch, sx, dev,
                                                       "float32", rate)
    fmm_err = check_fused_matmul_bn(torch, fb, dev)
    check_fmm_mma(torch, fb, dev)
    fmm_times = time_fused_matmul_bn(torch, fb, dev, "float32", rate)
    fmm_mma_times = time_fused_matmul_bn(torch, fb, dev, "bfloat16", rate)
    conv_err = check_fused_conv3_bn(torch, fc, dev)
    check_conv3_mma(torch, fc, dev)
    conv_times = time_fused_conv3_bn(torch, fc, dev, "float32", rate)
    conv_mma_times = time_fused_conv3_bn(torch, fc, dev, "bfloat16", rate)
    gc.collect()
    torch.cuda.empty_cache()
    sm_err = check_softmax(torch, sm, dev)
    sm_times = time_softmax(torch, sm, dev, rate)
    rms_err = check_rms_norm(torch, rn, dev)
    rms_times = time_rms_norm(torch, rn, dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    flash_err = check_flash(torch, fa, dev)
    gc.collect()
    torch.cuda.empty_cache()
    flash_times = time_flash(torch, fa, dev, rate)
    gc.collect()
    torch.cuda.empty_cache()

    phase("4 BERT-base in process")
    model = BERTModel().initialize(
        device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 30522, (B, T)).astype(np.int32)
    types = np.zeros((B, T), np.int32)
    for i, n in enumerate(VALID):
        types[i, n // 2:n] = 1
    valid = np.array(VALID, np.int32)
    inputs = [torch.from_numpy(a) for a in (tokens, types, valid)]
    t0 = time.monotonic()
    with torch.inference_mode():
        ref = [o.numpy() for o in model(*inputs)]
    print(f"CPU reference forward: {time.monotonic() - t0:.2f} s", flush=True)
    model.to(dev)
    ln.launches = 0                     # main path starts here
    with torch.inference_mode():
        got = model(*(a.to(dev) for a in inputs))
        torch.cuda.synchronize()
        got = [o.cpu().numpy() for o in got]
    assert ln.launches == 25, f"{ln.launches} LayerNorm launches, want 25"
    for name, g, r in zip(("mlm", "nsp"), got, ref):
        assert g.shape == r.shape and np.isfinite(g).all(), name
        err, scale = np.abs(g - r).max(), np.abs(r).max()
        print(f"bert {name} {g.shape}: max|d|={err:.3e} "
              f"bound 1e-3*max|ref|={1e-3 * scale:.3e}", flush=True)
        assert err <= 1e-3 * scale, name
    print("LayerNorm launches in one forward: 25", flush=True)

    phase("5 serve")
    os.environ["MXNET_SERVING_MAX_LATENCY_MS"] = "20"  # let 5 at once meet
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "bert_base")
        export_model(model, [a[:1] for a in (tokens, types, valid)], prefix,
                     outputs=[1])
        del model
        server = InferenceServer(port=0, buckets=BUCKETS, device=dev)
        try:
            t0 = time.monotonic()
            server.repository.load("bert", prefix)
            print(f"load + warmup: {time.monotonic() - t0:.2f} s", flush=True)
            port = server.start()
            before = ln.launches
            bodies = [{"inputs": [tokens[i].tolist(), types[i].tolist(),
                                  int(valid[i])]} for i in range(B)]
            answers = [None] * B
            for i in range(3):
                answers[i] = post(port, bodies[i])
            barrier = threading.Barrier(B - 3)

            def send(i):
                barrier.wait()
                answers[i] = post(port, bodies[i])

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(3, B)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
            entry = server.repository.get("bert")
            pred = entry.predictor
            for i, (out, _) in enumerate(answers):
                (direct,) = pred(tokens[i:i + 1], types[i:i + 1],
                                 valid[i:i + 1])
                np.testing.assert_allclose(np.asarray(out["outputs"][0]),
                                           direct[0], rtol=1e-4, atol=1e-4)
                np.testing.assert_allclose(direct[0], ref[1][i],
                                           atol=1e-3 * np.abs(ref[1]).max())
            lat = [ms for _, ms in answers]
            batches = dict(entry.batcher.batches)
            print(f"8 HTTP predictions agree with direct Predictor calls "
                  f"(rtol=atol=1e-4); batches (rows, padded_to): {batches}",
                  flush=True)
            print(f"request latency ms: p50={statistics.median(lat):.3f} "
                  f"max={max(lat):.3f} all={[round(v, 3) for v in lat]}",
                  flush=True)
            assert max(n for n, _ in batches) > 1, "no batch of 2+ formed"
            assert ln.launches > before, "serving launched no LayerNorm"
            for n in BUCKETS:
                args = [np.repeat(a[:1], n, axis=0)
                        for a in (tokens, types, valid)]
                pred(*args)
                runs = []
                for _ in range(10):
                    t0 = time.monotonic()
                    pred(*args)
                    runs.append((time.monotonic() - t0) * 1e3)
                print(f"Predictor forward bucket {n}: median "
                      f"{statistics.median(runs):.3f} ms min "
                      f"{min(runs):.3f} ms (host clock, 10 runs)",
                      flush=True)
                forward_breakdown(torch, pred, args, n)
        finally:
            server.shutdown()
    serve_launches = ln.launches        # serving path ends here
    print(f"serving path launches: layer_norm_fwd {serve_launches}",
          flush=True)

    phase("6 train BERT-base")
    train = train_bert_base(torch, np, dev)

    phase("7 train ResNet-50")
    resnet = train_resnet50(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()

    phase("8 bench path: bfloat16 AMP, FusedTrainStep as a CUDA graph")
    bench = bench_path(torch, np, dev, smi)
    # kernels 10-14's and 16's counters move for either of their
    # instances: phase 7 runs only float32 (the 3xTF32 tiles), the bench
    # path only bfloat16 (the bf16 tensor-core tiles)
    mma_launches = {k: bench[k] for k in _MMA_INSTANCES}
    resnet = {k: v + (bench[k] if k not in _MMA_INSTANCES else 0)
              for k, v in resnet.items()}

    gc.collect()
    torch.cuda.empty_cache()

    phase("9 train the TransformerLM")
    tf = train_transformer(torch, np, dev, smi, "gspmd")
    gc.collect()
    torch.cuda.empty_cache()

    phase("10 train the TransformerLM, flash attention")
    tf_flash = train_transformer(torch, np, dev, smi, "flash")
    tf = {k: v + tf_flash[k] for k, v in tf.items()}

    gc.collect()
    torch.cuda.empty_cache()

    phase("11 run-time-compiled CUDA C (rtc)")
    rtc_times, rtc_err, rtc_launches = rtc_phase(torch, dev, rate)
    gc.collect()
    torch.cuda.empty_cache()

    phase("12 LeNet (examples/train_mnist.py)")
    compare_lenet_step(torch, np, dev)
    lenet = lenet_phase(torch, np, dev)
    tf = {k: v + lenet[k] for k, v in tf.items()}
    time_lenet_xent(torch, sx, dev)

    phase("13 kernels")
    pk = "incubator_mxnet_tpu/ops/pallas_kernels.py"
    fbk = "incubator_mxnet_tpu/ops/fused_block.py"
    fck = "incubator_mxnet_tpu/ops/fused_conv.py"
    src = "incubator_mxnet_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        dict(name="rtc_launch", route="cuda",
             source="incubator_mxnet_tpu_torch/rtc.py",
             replaces="incubator_mxnet_tpu/rtc.py:71", launches=rtc_launches,
             max_abs_err=rtc_err, **rtc_times),
        dict(name="layer_norm_fwd", route="cuda", source=src + "layer_norm.cu",
             replaces=pk + ":219",
             launches=serve_launches + train["layer_norm_fwd"],
             max_abs_err=ln_err, **ln_times),
        dict(name="layer_norm_bwd", route="cuda", source=src + "layer_norm.cu",
             replaces=pk + ":237", launches=train["layer_norm_bwd"],
             max_abs_err=ln_bwd_err, **ln_bwd_times),
        dict(name="softmax_xent_fwd", route="cuda",
             source=src + "softmax_xent.cu", replaces=pk + ":545",
             launches=train["softmax_xent_fwd"] + resnet["softmax_xent_fwd"]
             + tf["softmax_xent_fwd"],
             max_abs_err=xent_fwd_err, **xent_fwd_times),
        dict(name="softmax_xent_bwd", route="cuda",
             source=src + "softmax_xent.cu", replaces=pk + ":558",
             launches=train["softmax_xent_bwd"] + resnet["softmax_xent_bwd"]
             + tf["softmax_xent_bwd"],
             max_abs_err=xent_bwd_err, **xent_bwd_times),
        dict(name="softmax_fwd", route="cuda", source=src + "softmax.cu",
             replaces=pk + ":127", launches=tf["softmax_fwd"],
             max_abs_err=sm_err[0], **sm_times[0]),
        dict(name="softmax_bwd", route="cuda", source=src + "softmax.cu",
             replaces=pk + ":137", launches=tf["softmax_bwd"],
             max_abs_err=sm_err[1], **sm_times[1]),
        dict(name="rms_norm_fwd", route="cuda", source=src + "rms_norm.cu",
             replaces=pk + ":657", launches=tf["rms_norm_fwd"],
             max_abs_err=rms_err[0], **rms_times[0]),
        dict(name="rms_norm_bwd", route="cuda", source=src + "rms_norm.cu",
             replaces=pk + ":669", launches=tf["rms_norm_bwd"],
             max_abs_err=rms_err[1], **rms_times[1]),
    ] + [
        dict(name=name, route="cuda", source=src + "flash_attention.cu",
             replaces=where, launches=tf[name], max_abs_err=err, **times)
        for name, where, err, times in zip(
            ("flash_attention_fwd", "flash_attention_bwd_dkdv",
             "flash_attention_bwd_dq"),
            (pk + ":348", pk + ":419 (XLA backward)",
             pk + ":419 (XLA backward)"), flash_err, flash_times)
    ] + [
        dict(name=f"fused_matmul_bn_{part}_tf32",
             route="cuda", source=src + "fused_matmul_bn.cu",
             replaces=f"{fbk}:{line}",
             launches=resnet[f"fused_matmul_bn_{part}"],
             max_abs_err=fmm_err[part], **times)
        for part, line, times in zip(("fwd", "dx", "dw"), (83, 154, 181),
                                     fmm_times)
    ] + [
        dict(name=f"fused_matmul_bn_{part}_mma", route="cuda",
             source=src + "fused_matmul_bn.cu", replaces=f"{fbk}:{line}",
             launches=mma_launches[f"fused_matmul_bn_{part}"],
             max_abs_err=fmm_err[f"{part}_mma"], **times)
        for part, line, times in zip(("fwd", "dx", "dw"), (83, 154, 181),
                                     fmm_mma_times)
    ] + [
        dict(name=f"fused_conv3_bn_{part}_tf32",
             route="cuda", source=src + "fused_conv3_bn.cu", replaces=where,
             launches=resnet[f"fused_conv3_bn_{part}"],
             max_abs_err=conv_err[part], **times)
        for part, where, times in zip(
            ("fwd", "dx", "dw"),
            (f"{fck}:139", f"{fck}:217, {fck}:180", f"{fck}:244"),
            conv_times)
    ] + [
        dict(name=f"fused_conv3_bn_{part}_mma", route="cuda",
             source=src + "fused_conv3_bn.cu", replaces=where,
             launches=mma_launches[f"fused_conv3_bn_{part}"],
             max_abs_err=conv_err[f"{part}_mma"], **times)
        for part, where, times in zip(
            ("fwd", "dx", "dw"),
            (f"{fck}:139", f"{fck}:217, {fck}:180", f"{fck}:244"),
            conv_mma_times)
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
