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
   ragged widths, a width past 16384 and a row with -inf entries, and
   kernel 3 at SSD's class rows (32·119276, 21) in both dtypes, at the
   narrow widths 2-33 and with x off 16 bytes, its kernel by name at
   SSD's and the attention rows; the cross-entropy forward at the LSTM
   LM's (1120, 10000) in both dtypes, at (7, 10001) and with the
   logits off 16 bytes and far below 0, its wide kernel by name and two
   calls bit for bit; for
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
   by kernel family; what the grad_req bookkeeping costs: the backward
   through ``autograd.backward`` against ``torch.autograd.backward``
   with the parameters' hooks idle and without them, in turns; (c) 3
   steps of the model converted to bfloat16 by
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
13. train the LSTM language model (``models/lstm_lm.py``, BASELINE
   config 5, ``example/rnn/word_lm``'s medium run: vocab 10000, embed
   and hidden 650, 2 layers, dropout 0.5, float32 with TF32 off, which
   cuDNN's RNN reads too) — (a) ``fused_rnn`` (cuDNN's LSTM, fed views
   of the one flat parameter) against ``fused_rnn_reference`` at the
   phase's width, T=35, B=32: out, hN, cN and the gradients of the
   data, the flat parameter and the states; its forward + backward time
   beside ``torch.nn.LSTM``'s on a weight buffer in cuDNN's own layout
   (the difference is the per-call copy of the views); (b) 20 steps of
   truncated BPTT at T=35, B=32 (SGD lr 1.0, gradients clipped to a
   global norm of 0.25, the state carried across windows and detached)
   over a token stream from a seed whose windows repeat every 4, with
   exactly one launch of each cross-entropy kernel a step at (1120,
   10000), every gradient finite and nonzero, the first step's update
   of every parameter of the model (``rnn.params_flat`` among them)
   equal to ``-lr·min(0.25/(norm + 1e-12), 1)·grad`` within float32
   rounding, and the predict-mode loss of the first window lower after
   the run than before; the median step time, tokens/s, the peak device
   memory of steps 2-20 above what was allocated as they started, one
   step profiled by kernel family, cuDNN's share of it (the kernels
   under its ops), and the cross-entropy kernels timed at (1120,
   10000);
14. train SSD and decode its detections (``models/ssd.py``, BASELINE
   config 4: ``ssd_300()``, 20 classes, five scales, 4 anchors a pixel,
   base width 16, 300x300, float32 with TF32 off) — (a) one Adam step
   at B=2 on the card against the same step on the CPU, the card's
   layers deferred and given the CPU model's weights: the targets, the
   loss, every gradient, the updates and the weights; (b) the detection
   ops at B=32 over the 119276 anchors, card against CPU from seeded
   inputs: ``multibox_target`` with 3:1 hard negative mining and
   ``multibox_detection`` (NMS 0.45, threshold 0.01, top 400), integer
   outputs equal but for counted near-ties, floats within 1e-5; (c) 20
   Adam steps (lr 5e-3) at B=32 on one batch of synthetic VOC-like
   scenes (1-3 boxes an image, 3 label rows, classes 0-19), whose loss
   must be finite and fall, every gradient finite and nonzero at the
   first and last steps, with no kernel launched in a training step and
   kernel 3 exactly once in ``SSD.detections`` on the last batch; the
   median step time, img/s, the peak device memory above what was
   allocated as the steps started, one step profiled by kernel family
   with its idle share, BatchNorm's layers profiled alone, and the
   detections split into the softmax, ``multibox_detection`` and its
   NMS loop; (d) ``examples/train_ssd.py`` at its defaults (200 steps
   at 96x96, B=16), whose loss must halve, and at the JAX suite's size
   (40 steps at 32x32, B=2), where image 0's best detection must be its
   box's class above 0.5 within 0.1 of the box;
15. the optimizer stack — (a) one update of a (1024, 1024) weight by
   each of the 18 optimizers (RMSProp in both ``centered`` modes), in
   float32 and in bfloat16 with a float32 master (``multi_precision``),
   on the card against the CPU; (b) BERT-base pretraining in bfloat16
   (``amp.convert_block``, dropout 0, B=16, T=128) with LAMB,
   ``multi_precision``, a PolyScheduler with 2 warm-up steps and weight
   decay 0.01 (none on LayerNorm parameters and biases): the
   uninterrupted 10 steps twice (the card's repeat spread), whose
   losses must be finite and not rise and whose float32 predict-mode
   loss must fall, with the scheduler's learning rates; then 5 steps,
   ``save_parameters`` and ``save_states``, a fresh model and trainer
   (``begin_num_update=5``) loading both, and 5 more steps, which must
   equal the uninterrupted run's within the repeat spread, with exactly
   25 / 25 / 2 / 2 launches of the LayerNorm and cross-entropy kernels
   a step; the median LAMB step and optimizer time, the bytes of the
   master copies and moments and the peak device memory above the
   weights, and one step profiled in two windows (forward + backward,
   optimizer); (c) the ``.params`` file written from the card read back
   on the CPU, every tensor equal in its dtype;
16. the chunked training loop (``fuse_loop.ChunkedTrainLoop``: K fused
   steps in one CUDA graph replay) — (a) ResNet-50 float32 at B=8 with
   cuDNN deterministic, K=4 over 10 batches against 10 per-step calls:
   every step's loss, the chunk means and every parameter, moving
   statistic and momentum bit for bit, the 4-step capture 4x a step's
   launches; (b) Dense(16) → ReLU → Dropout(0.5) → Dense(5), K=4 over 8
   batches against 8 per-step calls bit for bit, with the default and a
   private generator, and two replayed chunks that draw different
   masks; (c) ``remat`` "dots" and "nothing" against None on one bf16
   step at B=128: the loss and every tensor, the peak memory and the
   replay time of each; (d) the path: 2176 raw 224x224 records written
   to a ``.rec`` file, ``RecordFileDataset`` and 4 process workers,
   ``DevicePrefetchRing``, ``resnet50_v1`` bf16 (bench.py's model and
   SGD) with ``chunk_steps=8`` over 3 epochs of two chunks and a tail,
   a checkpoint at every chunk boundary: every loss finite and the last
   chunk's mean below the first's, the step time over chunk replays
   beside phase 8 (b)'s, img/s, the wait on the ring, the peak memory,
   one chunk profiled, the 8-step capture 8x a step's launches; (e) a
   fresh model resumed from the checkpoint after the last epoch's first
   chunk, bit for bit the uninterrupted run, and a checkpoint with a
   flipped byte that falls back to the older step; (f)
   ``examples/train_resnet_fused.py --chunk-steps 2`` at its defaults;
17. the imperative training API — (a) each of the seven kernel
   Functions at a phase 3 shape: a backward with ``create_graph=True``
   gives the first gradients of ``create_graph=False`` bit for bit, and
   differentiating them again raises ``HigherOrderGradientError``
   naming the kernel; (b) a gradient penalty on LeNet
   (``examples/train_mnist.py``'s network without its loss, 28x28,
   B=64, float32): mean(critic(real)) - mean(critic(fake)) + 10 ·
   mean((‖∂critic(x̂)/∂x̂‖₂ - 1)²), the inner gradient from
   ``autograd.grad(create_graph=True)``, one step on the card against
   the same step on the CPU, then 20 Adam steps and their step time;
   (c) BERT-base gradient accumulation (float32, dropout 0, T=128): every
   parameter at ``grad_req "add"`` but the word embedding at ``"null"``,
   a step of four micro-batches of 4 through ``autograd.backward``,
   ``Trainer.step(16)`` and ``zero_grad()``, 3 steps: the accumulated
   gradient against one B=16 batch's ``"write"`` gradient, every weight
   after each step against ``nd.adam_update`` on the weight and
   accumulated gradient it had, the embedding untouched with no
   gradient and no optimizer state, two ``"write"`` backwards leaving
   the second's gradient, 100 / 100 / 8 / 8 LayerNorm and
   cross-entropy launches a step, the step time;
   (d) every update op at (1024, 1024), card against CPU, in float32 and
   bfloat16 (the ``mp_*`` ones with float32 masters), and
   ``multi_mp_sgd_mom_update`` and ``multi_mp_adamw_update`` over
   BERT-base's parameters in bfloat16 with float32 masters against the
   loop of single ops bit for bit, with each path's wall and busy time
   and launches;
18. the vision model zoo (``gluon/model_zoo/vision``) — (a) every
   distinct fused 1x1 instance of a ResNet-50 v2 step at B=128 (15
   shapes, each with a prologue, K up to 2048, 11 of them in no v1
   call) in float32 and bfloat16, kernels 10-12 against their plain
   versions at phase 3's tolerances and timed beside their bounds, and
   the stride-1 3x3 shapes (kernels 13-16, v1's four); (b) one float32
   training step of ``resnet50_v2(layout="NHWC", fused=True)`` at
   B=128 against the same net and weights with ``fused=False``, both on
   the card: the loss, the logits, every moving statistic and every
   gradient, then 5 timed steps of each, with exactly 36 launches of
   each fused 1x1 kernel, 13 of each fused 3x3 kernel and one of each
   cross-entropy kernel a fused step; (c) the same net in bfloat16 as
   one ``FusedTrainStep`` (SGD, momentum 0.9, wd 1e-4) replayed as a
   CUDA graph: 2 warm-up and 20 timed steps, the capture's launches
   36/13/1 and the path's twice that, the loss finite and falling, the
   step time, img/s, peak memory and one replay's idle share; (d) one
   member of each family (ResNet 18 v1 and v2, ResNet-50 v2, AlexNet,
   VGG-11 BN, SqueezeNet 1.1, MobileNet 1.0 and v2 1.0, DenseNet-121,
   Inception v3 at 299x299), float32 predict-mode logits at B=2 on the
   card against the same weights on the CPU; (e)
   ``examples/benchmark_score.score`` for the JAX script's eight default
   models in bfloat16 at batch 1 and 128, img/s eager and hybridized
   (one CUDA graph a model and batch), and ``inception_v3`` at 224x224
   raising; (f) phase 13's LSTM LM converted to bfloat16, 8
   steps: the loss finite, cuDNN's bf16 RNN kernels by the profiler's
   names, one launch of each cross-entropy kernel a step, the step time;
19. the image data path — (a) the ``image_batch`` kernel (resize, crop,
   mirror, normalize) against its plain version bit for bit at B=128
   into 3x224x224 from the fixtures' sizes resized to a short side of
   256 with crops and mirrors, and upscaling, ``resize=0``, a source at
   the output size (the bytes pass through), a 1-pixel output height and
   one channel; its time beside the plain version's and its bound;
   (b) nvJPEG with the ``ycc_rgb`` colour kernel against PIL's pixels
   of the committed 4:4:4, 4:2:0 and grey fixtures, a truncated JPEG and
   a PNG raising with the process living on, the decode time an image,
   and ``ycc_rgb`` against its plain version, timed; (c) a ``.rec`` of
   2048 JPEG records made from the photo fixtures through
   ``io.ImageRecordIter`` (3x224x224, B=128, short side 256, random
   crops and mirrors, shuffled, ImageNet mean and std, seed 0):
   ``prefetch_buffer`` 0 against 4 bit for bit, 2 epochs of the
   iterator alone with exactly one ``image_batch`` launch and 128 nvJPEG
   decodes a batch, then 16 steps of phase 8's bf16 ``FusedTrainStep``
   fed by it (NCHW to NHWC on the card), every loss finite, with the
   iterator's img/s, the fed img/s, the step time beside phase 8 (b)'s
   replay, the wait on the iterator and two fed steps' idle share; (d)
   ``ImageFolderDataset`` over the photo fixtures decoded on the card,
   ``Compose([RandomResizedCrop(224), RandomFlipLeftRight(), ToTensor(),
   Normalize])`` card against CPU on the same image and draws, then a
   ``DataLoader`` into 5 eager float32 SGD steps of ``resnet18_v1``
   with finite losses; (e) ``ImageDetIter`` with
   ``CreateDetAugmenter(rand_crop=0.5, rand_mirror=True, ...)`` over
   phase 14's scenes at 300x300, labels padded with -1 rows to
   ``label_shape``, into 5 Adam steps of ``ssd_300()``, losses finite;
21. int8 quantization of ResNet-50 (run before phase 20, whose line
   counts its launches) — (a) the int8 convolution bit for bit its
   plain version at ResNet-50's stem, stage-1 1x1 and 3x3, strided
   downsample and stage-4 3x3 (B=32) and as the head Dense (32, 2048) x
   (1000, 2048), each timed beside its bound, the plain version, cuDNN
   in bfloat16 and float32 (TF32 off) or ``torch._int_mm``, from
   channels-last codes as the path gives them (and from NCHW codes, the
   wrapper's copy included); quantize with a range and without one, in
   both layouts, and dequantize from int32 and int8, bit for bit, timed
   beside the torch expression; (b) float32
   ``resnet50_v1`` hybridized against eager at B=1 and 32: the first
   call and the replays bit for bit, one capture a batch, a held result
   unchanged, the host ms of a call eager against replay; (c)
   ``examples/quantize_resnet50.py`` at its defaults (naive and entropy,
   its two JSON lines), the launches of one eager forward (53 of each
   kernel), the card's int8 logits against the same net on the CPU over
   128 images, one replay of the float and the int8 net profiled by
   kernel family, then the ``--fuse-bn`` run's line (naive mode: the
   entropy search is host numpy, ~1 s a layer, shown once above);
20. the kernels line (JSON), then the last line
   ``{"ok": true, "device": {...}}``.

Each main path runs with the launch counters set to 0 just before it
and read just after: serving from phase 4 to the end of phase 5,
BERT training over phase 6 (b) and (c), ResNet training over phase 7
(b), the
bench path over phase 8 (b)'s warm-up and timed steps, the
TransformerLM over phase 9 (b) and (c) and, with flash attention, over
phase 10 (b) and (c), the user kernels over phase 11's compiles and
launches, LeNet over phase 12 (b), the LSTM language model over phase
13 (b), SSD over phase 14 (c)'s steps and detections, LAMB's
BERT-base over phase 15 (b)'s saved and resumed run, the chunked
loop over phase 16 (d) and (e), BERT-base's gradient accumulation
over phase 17 (c)'s steps, and the model zoo's ResNet-50 v2 over phase
18 (b)'s fused timed steps and (c)'s steps, and its bf16 LSTM LM over
(f)'s, the image path over phase 19 (c)'s two epochs of the
iterator and its fed steps, and the int8 path over phase 21 (c)'s
example run.  A graph replay
launches the captured kernels without passing through their wrappers,
so on the bench path the counters hold the eager warm-up step and the
capture, and on the chunked loop's the eager chunk, the K-step capture
and the tail's warm-up step and capture, in the first epoch and in the
resume.  The kernels line gives each kernel's launches summed over the
paths it ran on; kernels 10-14 and 16 have an entry for each instance,
the float32 3xTF32 tensor-core tile (``..._tf32``) with phase 7's
launches and the bfloat16 tensor-core tile (``..._mma``) with phases
8's, 16's and 19's; the 3x3's entries also count phase 18 (b)'s and (c)'s
(v2 runs v1's four 3x3 shapes).  Kernels 10-12 have two more entries,
``..._tf32_v2`` and ``..._mma_v2``, for ResNet-50 v2's instances (a
prologue on every call), with phase 18 (b)'s and (c)'s launches and
times at stage 4's conv1.  ``image_batch`` and ``jpeg_ycc_rgb`` replace
no Pallas kernel (they are the native image iterator's C++ batch
assembly and libjpeg's colour step on the card); the ``image_batch``
entry also gives phase 19 (c)'s nvJPEG decodes and the decode time an
image.  ``int8_conv``, ``quantize_int8`` and ``dequantize`` replace no
Pallas kernel either (the JAX package computes them with XLA ops).
"""
import copy
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

B, T = 8, 128
BUCKETS = [1, 2, 4, 8]
VALID = [128, 100, 77, 64, 33, 16, 5, 1]
HIDDEN = 768
# training: BERT-base at B=16, T=128 (2048 tokens a step)
TRAIN_B, TRAIN_B_CPU, TRAIN_STEPS = 16, 4, 10
# phase 6 (b): the backward through autograd.backward against
# torch.autograd.backward with the grad_req hooks idle and without them,
# in turns
BOOK_ROUNDS = 30
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
# the LSTM language model (phase 13): example/rnn/word_lm's medium run
# (Penn Treebank's vocabulary of 10000, embed and hidden 650, 2 layers,
# dropout 0.5, bptt 35, batch 32), float32; SGD lr 1.0 without
# momentum, the gradients clipped to a global norm of 0.25; 20 steps
# over a stream whose windows repeat every LSTM_DISTINCT
LSTM_VOCAB, LSTM_UNITS, LSTM_LAYERS, LSTM_DROPOUT = 10000, 650, 2, 0.5
LSTM_T, LSTM_B, LSTM_STEPS, LSTM_DISTINCT = 35, 32, 20, 4
LSTM_LR, LSTM_CLIP = 1.0, 0.25
LSTM_ROWS = LSTM_T * LSTM_B             # 1120 rows of logits a step
# cuDNN's LSTM against fused_rnn_reference, float32 with TF32 off: out,
# hN and cN within 1e-5 (values in (-1, 1)), every gradient within 1e-4
# of its largest value (the same products summed in another order,
# over the 35-step recurrence)
LSTM_OUT_TOL, LSTM_GRAD_TOL = 1e-5, 1e-4
# the MLM and NSP shapes of the training steps in both dtypes (phase 6's
# float32 run and its bfloat16 pass (c)), the LSTM's logits (phase 13),
# then ragged shapes
XENT_SHAPES = [((ROWS, VOCAB), "float32"), ((ROWS, VOCAB), "bfloat16"),
               ((TRAIN_B, 2), "float32"), ((TRAIN_B, 2), "bfloat16"),
               ((LSTM_ROWS, LSTM_VOCAB), "float32"),
               ((LSTM_ROWS, LSTM_VOCAB), "bfloat16"),
               ((1000, 100), "float32"), ((3, 16385), "float32"),
               ((7, 10001), "bfloat16")]
# and the MLM shape with the logits one element past 16 bytes: the wide
# kernel's rows start off its 16-byte pieces
XENT_OFFSET_SHAPES = [((ROWS, VOCAB), "float32"), ((ROWS, VOCAB), "bfloat16")]
# the forward on logits far below 0 (x - 100, or the first half of
# every odd row's columns at -1e4 and row 2 at -1e9), where a thread's
# first values all lie below exp's range; loss and lse at XENT_LOSS_TOL
XENT_FAR_CASES = [(shape, dtype, variant)
                  for shape in ((LSTM_ROWS, LSTM_VOCAB), (7, 10001))
                  for dtype in ("float32", "bfloat16")
                  for variant in ("x - 100", "masked")]
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
# SSD (phase 14): ssd_300() (BASELINE config 4: 20 classes, five scales,
# 4 anchors a pixel, base width 16) at 300x300, float32; (a) one Adam
# step at B=2 card vs CPU; (b) the detection ops at B=32 card vs CPU;
# (c) 20 Adam steps (lr 5e-3) at B=32 on one batch of synthetic scenes,
# then the detections of the last batch; (d) examples/train_ssd.py
SSD_IMAGE, SSD_B, SSD_B_CPU, SSD_STEPS, SSD_LR = 300, 32, 2, 20, 5e-3
SSD_M = 3               # label rows an image: 1-3 boxes, the rest -1
SSD_MAPS = (150, 75, 37, 18, 1)          # the five stages' feature maps
SSD_ANCHORS = 4 * sum(s * s for s in SSD_MAPS)           # 119276
# kernel 3 in SSD.detections: the class axis of (B, 21, N), moved last
SSD_SM_PATH = (SSD_B * SSD_ANCHORS, 21)
SSD_DET = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
# card against CPU: float outputs (boxes, scores, location targets up to
# about 10) within 1e-5; class targets, masks, class ids and the kept
# rows equal, except at a near-tie, where the two devices' roundings may
# decide either way: an anchor whose mining score 1 - p(background) lies
# within 1e-6 of the cut-off (the 3·#pos-th largest) when the next score
# does too, or whose best IoU lies within 1e-6 of the 0.5 threshold; an
# image where two boxes of one class among the 400 best overlap within
# 1e-6 of the NMS threshold.  Near-ties are counted and printed.  The
# step (a): loss 1e-5 relative (fed the CPU's targets on both devices),
# every gradient max|d| <= 1e-3 of its largest value (12 convolution
# layers and 8 BatchNorms over 300x300 maps in another order of sums),
# updates and weights as phase 6's; the convolution biases in front of
# a BatchNorm get a gradient that is 0 in exact arithmetic and rounding
# noise on either device: each below 1e-4 of its convolution weight's
# largest gradient
SSD_FLOAT_TOL, SSD_NEAR, SSD_GRAD_TOL, SSD_NOISE_TOL = 1e-5, 1e-6, 1e-3, 1e-4
RMS_PATH = (TF_B * (TF_T - 1), TF_D)
ROW_WIDTHS = [1, 7, 300, 1000, 1024, 16385]
# kernel 3's narrow rows (softmax_fwd_narrow, up to 32 values; 33 is the
# first one-warp row) at 1000 rows, no multiple of its 256-row tile, in
# both dtypes; then x off 16 bytes by `offset` elements, (rows, cols,
# offset)
SM_NARROW_WIDTHS = [2, 10, 16, 20, 21, 31, 32, 33]
SM_OFFSET_CASES = [(4096, 21, 1), (1000, 32, 1)]
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

# phase 15, the optimizer stack.  (a) one update of a (1024, 1024)
# weight by each optimizer, float32 and bfloat16 with a float32 master
# (weight decay 0.01 on top of each case's own settings), card against
# CPU on the same inputs: both run the same elementwise float32
# operations in the same order, so every tensor agrees within 1e-6 of
# its largest value (LAMB and LARS 1e-5: their norms are sums in another
# order), the bfloat16 weights (each device's master rounded) within one
# bf16 ulp of each value, or where the master ends near 0 by
# cancellation, within the masters' own tolerance
OPT_SHAPE = (1024, 1024)
OPT_CASES = [("sgd", "sgd", dict(learning_rate=0.1, momentum=0.9)),
             ("sgld", "sgld", dict(learning_rate=0.01)),
             ("signum", "signum", dict(learning_rate=0.01, wd_lh=0.01)),
             ("dcasgd", "dcasgd", dict(learning_rate=0.1, momentum=0.9)),
             ("nag", "nag", dict(learning_rate=0.1, momentum=0.9)),
             ("adagrad", "adagrad", dict(learning_rate=0.1)),
             ("adadelta", "adadelta", dict()),
             ("adam", "adam", dict(learning_rate=0.01)),
             ("adamw", "adamw", dict(learning_rate=0.01)),
             ("adamax", "adamax", dict(learning_rate=0.01)),
             ("nadam", "nadam", dict(learning_rate=0.01)),
             ("ftrl", "ftrl", dict(learning_rate=0.1, lamda1=0.01)),
             ("ftml", "ftml", dict(learning_rate=0.01)),
             ("lars", "lars", dict(learning_rate=0.1, momentum=0.9)),
             ("lamb", "lamb", dict(learning_rate=0.01)),
             ("rmsprop", "rmsprop", dict(learning_rate=0.01)),
             ("rmsprop_centered", "rmsprop",
              dict(learning_rate=0.01, centered=True, clip_weights=2.0)),
             ("lbsgd", "lbsgd", dict(learning_rate=0.1, momentum=0.9)),
             ("test", "test", dict())]
OPT_TOL, OPT_NORM_TOL = 1e-6, 1e-5
# (b) BERT-base pretraining as gluon-nlp runs it (BASELINE config 3,
# AMP): bfloat16 by amp.convert_block, LAMB with float32 masters, lr
# 1e-4 through a PolyScheduler (2 warm-up steps, linear decay to 0 at
# 2·LAMB_N), weight decay 0.01 but none on LayerNorm parameters and
# biases; dropout 0, so the resumed run can be held to the uninterrupted
# one.  LAMB_N steps, save, a fresh model and trainer load both files,
# LAMB_N more steps (begin_num_update=LAMB_N)
LAMB_N = 5
LAMB_LR = 1e-4
# phase 16, the chunked training loop.  (a) ResNet-50 in float32 at
# B=CHUNK_B, cuDNN deterministic: K=CHUNK_K over CHUNK_N batches (two
# chunks and a tail) against CHUNK_N per-step calls, bit for bit; (b) the
# JAX suite's Dense(16) -> ReLU -> Dropout(0.5) -> Dense(5) net, K=4 over
# 8 batches against 8 per-step calls, bit for bit, then 3 chunks of one
# batch at lr 0, whose two replays must draw different masks; (c) one
# bf16 step at B=128 with remat "dots" and "nothing" against None
# (cuDNN deterministic): losses and every tensor within GRAPH_TOL of the
# largest value, a lower peak of device memory, the replay times;
# (d) the path: LOOP_RECORDS raw 224x224 records written to a .rec file,
# read by LOOP_WORKERS process workers, B=128, K=LOOP_K, LOOP_EPOCHS
# epochs (the first captures, the others replay), bf16, cuDNN
# deterministic so that (e) can hold the resume bit for bit; a
# checkpoint at every chunk boundary
CHUNK_B, CHUNK_K, CHUNK_N = 8, 4, 10
REMAT_REPLAYS = 5
LOOP_B, LOOP_K, LOOP_RECORDS, LOOP_WORKERS, LOOP_EPOCHS = (128, 8, 2176, 4,
                                                           3)
# phase 17, the imperative training API.  (a) the seven kernel
# Functions at phase 3's shapes, float32: (name of the guarded kernel,
# what the case builds)
HO_CASES = [("layer_norm_bwd", ((ROWS, HIDDEN),)),
            ("softmax_bwd", (SM_PATH,)),
            ("rms_norm_bwd", (RMS_PATH,)),
            ("softmax_xent_bwd", ((ROWS, VOCAB),)),
            ("flash_attention_bwd", (FLASH_PATH,)),
            ("fused_matmul_bn_bwd", (FMM_REP,)),
            ("fused_conv3_bn_bwd", (CONV_REP,))]
# (b) the gradient penalty's weight and LeNet's batch; card step against
# CPU step, float32 with TF32 off: the loss within 1e-5 relative, each
# gradient max|d| <= GP_GRAD_TOL of its largest value (phase 12 (a)'s
# bound: the same float32 convolutions, here also their double backward,
# summed in another order); 20 Adam steps at lr 1e-4
GP_LAMBDA, GP_STEPS, GP_LR, GP_GRAD_TOL = 10.0, 20, 1e-4, 1e-4
# (c) four micro-batches of ACC_MICRO rows make one step of ACC_MICRO *
# ACC_PARTS; the accumulated float32 gradient against one batch's, each
# tensor within ACC_TOL of its largest value (the same rows, summed in
# four parts)
ACC_MICRO, ACC_PARTS, ACC_STEPS, ACC_TOL = 4, 4, 3, 1e-5
# each Adam step's new weights against nd.adam_update on the same weight
# and gradient: within 4 float32 ulps of each tensor's largest value plus
# 1e-6 of the learning rate (the same formula, but the optimizer scales
# the gradient before it squares it and the op after, so a step may move
# by a few ulps of itself); a missed, doubled or stale update moves a
# weight by about the learning rate
ACC_UPD_ULPS, ACC_UPD_STEP = 4.0, 1e-6
# (d) the update ops card against CPU: bit for bit where an op takes no
# square root and sums nothing (tests/torch_update_op_cases.py's EXACT),
# else within 5e-7 of each float32 tensor's largest value (the card's
# sqrt differs from the CPU's by one ulp in about 0.6 % of values, the
# sums run in another order; FTRL's cancelling sigma 5e-6, as that file
# says) and, in bfloat16, one bf16 ulp of each value more: phase 15
# (a)'s rule
UPD_SHAPE = (1024, 1024)
# phase 19, the image data path.  (a) image_batch against its plain
# version bit for bit at B=128 into 3x224x224 from the fixtures' sizes
# resized to a short side of 256, and the corner cases; (b) nvJPEG and
# the colour kernel against PIL's pixels of the fixtures: the mean
# |difference| at most IMG_DECODE_MEAN and the largest IMG_DECODE_MAX
# grey levels (only the inverse DCTs differ once the colour kernel
# upsamples chroma as libjpeg does; measured on the card: means
# 0.014-0.033, largest 3); (c) IMG_RECORDS JPEG records through
# ImageRecordIter, 2 epochs alone, then IMG_FED_STEPS steps of phase 8's
# bf16 FusedTrainStep fed by it; (d) the vision transforms card against
# CPU on the same decoded image and draws: the uint8 crop-resize-flip
# equal but for one level where the value before the truncating cast
# lies within VISION_TIE of an integer (the resize's sums run in another
# order: a flat region's exact integer lands either side), ToTensor +
# Normalize within 1e-6 on the same uint8, the whole chain within one
# level through Normalize; then VISION_STEPS eager SGD steps of
# resnet18_v1; (e)
# ImageDetIter over phase 14's scenes into DET_STEPS Adam steps of SSD
IMG_B, IMG_RECORDS, IMG_RESIZE, IMG_FED_STEPS = 128, 2048, 256, 16
IMG_MEAN, IMG_STD = (123.68, 116.28, 103.53), (58.395, 57.12, 57.375)
IMG_DECODE_MEAN, IMG_DECODE_MAX = 0.1, 4
IMG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures", "torch_jpeg")
VISION_MEAN, VISION_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
VISION_B, VISION_STEPS, VISION_TIE = 8, 5, 1e-3
DET_B, DET_STEPS = 8, 5
# phase 21: int8 post-training quantization of resnet50_v1 at B=32,
# 224x224 (examples/quantize_resnet50.py's defaults).  (a) the int8
# convolution at five of ResNet-50's shapes (N, C, H, W, C_out, k,
# stride, pad) and the head Dense (M, K, N); INT8_REP's numbers go into
# the kernels line; quantize and dequantize at a stage-1 activation
INT8_PEAK = 1979e12    # dense int8 tensor-core operations/s (H100 SXM)
INT8_CONV_SHAPES = [("stem", (32, 3, 224, 224, 64, 7, 2, 3)),
                    ("stage-1 1x1", (32, 64, 56, 56, 64, 1, 1, 0)),
                    ("stage-1 3x3", (32, 64, 56, 56, 64, 3, 1, 1)),
                    ("strided downsample", (32, 256, 56, 56, 512, 1, 2, 0)),
                    ("stage-4 3x3", (32, 512, 7, 7, 512, 3, 1, 1))]
INT8_HEAD = (32, 2048, 1000)
INT8_REP = "stage-1 3x3"
INT8_ACT = (32, 256, 56, 56)
# (b) hybridized float32 resnet50_v1 against eager at these batches
HYB_BATCHES, HYB_CALLS = (1, 32), 20
# (c) the card's int8 logits against the same int8 net moved to the CPU,
# over the example's 4 x 32 images: the same top-1 on all but
# INT8_TOP1_MISS, every logit within INT8_LOGIT_TOL of the largest.  The
# int8 products are exact on both; the float layers between them
# (BatchNorm, the residual sums, pooling, dequantize) round differently
# in cuDNN and oneDNN, and a last-bit move of a layer's input at a tie
# moves its code by one, 1/127 of the layer's range, damped after it.
INT8_TOP1_MISS, INT8_LOGIT_TOL = 1, 1e-2
INT8_FORWARD_LAUNCHES = 53    # resnet50_v1's Conv2Ds, the head excluded
# (c) the example's img/s reads a window of 4 forwards; the float and the
# int8 nets are read again, interleaved, over SPREAD_REPEATS windows of
# SPREAD_PASSES passes over the 4 batches, for the spread
SPREAD_REPEATS, SPREAD_PASSES = 5, 8


def phase(name):
    print(f"== {name}", flush=True)
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        print(f"device memory allocated as the phase starts: "
              f"{torch.cuda.memory_allocated()} bytes", flush=True)


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
    print(f"  the kernel at {bound / out['ms']:.3f} of its bound", flush=True)
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
    """Both kernels against their plain versions at every shape (and with
    the logits off 16 bytes), the forward on logits far below 0, then
    the forward's kernel by the profiler's name at the LSTM LM's and the
    MLM shape, and two calls' bits; returns the max |d loss| and max
    |d dx| at the MLM shape, float32."""
    errs_at_train = None
    cases = ([(shape, dtype, 0) for shape, dtype in XENT_SHAPES]
             + [(shape, dtype, 1) for shape, dtype in XENT_OFFSET_SHAPES])
    for shape, dtype, offset in cases:
        x, labels, g = xent_inputs(torch, shape, dtype, 0, dev)
        x = offset_copy(torch, x, offset)
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
        print(f"softmax_xent {shape} {dtype}, x offset {offset}: max|d "
              f"loss|={e_loss:.3e} "
              f"max|d lse|={(lse - rlse).abs().max().item():.3e} "
              f"(tol {XENT_LOSS_TOL:g}) max|d dx|={e_dx:.3e} (tol {tol}) "
              "ok", flush=True)
        if shape == (ROWS, VOCAB) and dtype == "float32" and not offset:
            errs_at_train = e_loss, e_dx
    for shape, dtype, variant in XENT_FAR_CASES:
        x, labels, _ = xent_inputs(torch, shape, dtype, 5, dev)
        if variant == "x - 100":
            x = x - 100
        else:
            x[1::2, :shape[1] // 2] = -1e4
            x[2] = -1e9
        loss, lse = sx.softmax_xent_fwd(x, labels)
        rloss, rlse = sx.softmax_xent_fwd_reference(x, labels)
        torch.cuda.synchronize()
        for a, b in ((loss, rloss), (lse, rlse)):
            torch.testing.assert_close(a, b, rtol=XENT_LOSS_TOL,
                                       atol=XENT_LOSS_TOL)
        print(f"softmax_xent_fwd {shape} {dtype}, {variant}: max|d loss|="
              f"{(loss - rloss).abs().max().item():.3e} max|d lse|="
              f"{(lse - rlse).abs().max().item():.3e} (tol "
              f"{XENT_LOSS_TOL:g} of each) ok", flush=True)
    for shape in ((LSTM_ROWS, LSTM_VOCAB), (ROWS, VOCAB)):
        x, labels, _ = xent_inputs(torch, shape, "float32", 1, dev)
        names = kernel_names(torch, sx.softmax_xent_fwd, (x, labels))
        first, second = (sx.softmax_xent_fwd(x, labels) for _ in range(2))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        print(f"softmax_xent_fwd {shape} float32 runs {names}; two calls "
              f"give the same bits: {same}", flush=True)
        assert (len(names) == 1 and "softmax_xent_fwd_wide" in names[0]
                and same), (names, same)
    return errs_at_train


def time_softmax_xent(torch, sx, dev, dtype, rate, shape=(ROWS, VOCAB)):
    """Times at ``shape``, by default the MLM shape (2048, 30522),
    cycling 3 input sets (250 MB each there, five times L2; 45 MB each
    at the LSTM's (1120, 10000)).  The library calls are
    ``F.cross_entropy(reduction="none")`` and, for the backward, the two
    ATen ops its autograd runs (``nll_loss_backward`` and
    ``_log_softmax_backward_data``) on its saved log-probabilities, with
    the loss's gradient in the logits' dtype, as autograd gives it."""
    import torch.nn.functional as F
    rows, cols = shape
    sets, fwd_sets, lib_sets = [], [], []
    for s in range(3):
        x, labels, g = xent_inputs(torch, (rows, cols), dtype, s, dev)
        lse = sx.softmax_xent_fwd_reference(x, labels)[1]
        sets.append((x, labels, lse, g))
        fwd_sets.append((x, labels))
        lib_sets.append((x, labels.long().clamp(0, cols - 1), g.to(x.dtype),
                         torch.log_softmax(x, 1)))
    zero = torch.zeros((), device=dev, dtype=getattr(torch, dtype))
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
    """Kernels 3 and 4 against their plain versions at every case (the
    attention rows, the ragged widths, SSD.detections' class rows in both
    dtypes, the narrow widths, then x off 16 bytes), then kernel 3 by the
    profiler's name at SSD's and the attention rows; returns the max
    |d y| and |d dx| at the attention shape, float32."""
    path_err = None
    cases = [case + (0,) for case in
             row_cases(SM_PATH) + row_cases(SSD_SM_PATH)[:2]
             + [(1000, c, dt) for c in SM_NARROW_WIDTHS
                for dt in ("float32", "bfloat16")]]
    cases += [(rows, cols, dt, offset) for rows, cols, offset in
              SM_OFFSET_CASES for dt in ("float32", "bfloat16")]
    for rows, cols, dtype, offset in cases:
        x, g = softmax_inputs(torch, rows, cols, dtype, dev, 0)
        x = offset_copy(torch, x, offset)
        y = sm.softmax_fwd(x)
        dx = sm.softmax_bwd(y, g)
        ry = sm.softmax_fwd_reference(x)
        rdx = sm.softmax_bwd_reference(y, g)
        torch.cuda.synchronize()
        (ey, oky), (edx, okdx) = row_err(torch, y, ry), row_err(torch, dx, rdx)
        print(f"softmax ({rows}, {cols}) {dtype}, x offset {offset}: "
              f"max|d|/max|ref| y={ey:.2e} "
              f"dx={edx:.2e} (tol {ROW_TOL:g} of max"
              f"{', + 1 bf16 ulp' if dtype == 'bfloat16' else ''})",
              flush=True)
        assert oky and okdx, ((rows, cols, dtype, offset), ey, edx)
        if (rows, cols) == SM_PATH and dtype == "float32":
            path_err = ((y.float() - ry.float()).abs().max().item(),
                        (dx.float() - rdx.float()).abs().max().item())
        del x, g, y, dx, ry, rdx
    for (rows, cols), want in ((SSD_SM_PATH, "softmax_fwd_narrow"),
                               (SM_PATH, "softmax_fwd_warp")):
        x, _ = softmax_inputs(torch, rows, cols, "float32", dev, 1)
        names = kernel_names(torch, sm.softmax_fwd, (x,))
        print(f"softmax_fwd ({rows}, {cols}) float32 runs {names}",
              flush=True)
        assert len(names) == 1 and want in names[0], names
        del x
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


def time_softmax_ssd(torch, sm, dev, rate):
    """Kernel 3 (softmax_fwd_narrow) at SSD.detections' rows (32·119276,
    21) float32, cycling 2 input sets of 321 MB: the kernel, its plain
    version and ``torch.softmax(x, -1)`` on the rows, and the same in
    bfloat16 (2 sets of 160 MB); then the whole op on the class
    axis of (32, 21, 119276): the port's ``nn_ops.softmax(x, axis=1)``
    (movedim, kernel, movedim) against ``torch.softmax(x, 1)``, on the
    layout the model gives it (a transposed view of (32, 119276, 21),
    whose movedim copies nothing) and on a contiguous (32, 21, 119276)
    tensor (whose movedim copies it)."""
    from incubator_mxnet_tpu_torch.ops import nn_ops
    rows, cols = SSD_SM_PATH
    gen = torch.Generator(device=dev).manual_seed(11)
    sets = [(torch.randn(rows, cols, generator=gen, device=dev) * 3,)
            for _ in range(2)]
    fwd = {"ms": time_ms(torch, sm.softmax_fwd, sets),
           "plain_ms": time_ms(torch, sm.softmax_fwd_reference, sets),
           "library_ms": time_ms(torch, lambda x: torch.softmax(x, -1),
                                 sets)}
    out = report(f"softmax_fwd ({rows}, {cols}) float32 (SSD.detections' "
                 "rows)", fwd, 2 * rows * cols * 4, rate)
    bf16 = [(x.to(torch.bfloat16),) for (x,) in sets]
    report(f"softmax_fwd ({rows}, {cols}) bfloat16", {
        "ms": time_ms(torch, sm.softmax_fwd, bf16),
        "plain_ms": time_ms(torch, sm.softmax_fwd_reference, bf16),
        "library_ms": time_ms(torch, lambda x: torch.softmax(x, -1), bf16)},
        2 * rows * cols * 2, rate)
    del bf16
    layouts = {"model's layout": [(x.view(SSD_B, SSD_ANCHORS, cols)
                                   .transpose(1, 2),) for (x,) in sets]}
    layouts["contiguous"] = [(v.contiguous(),)
                             for (v,) in layouts["model's layout"]]
    for name, args in layouts.items():
        port = time_ms(torch, lambda v: nn_ops.softmax(v, axis=1), args)
        lib = time_ms(torch, lambda v: torch.softmax(v, 1), args)
        print(f"  softmax over axis 1 of ({SSD_B}, {cols}, {SSD_ANCHORS}), "
              f"{name}: the port's nn_ops.softmax device {port[0]} stream "
              f"{port[1]:.6f} ms; torch.softmax device {lib[0]} stream "
              f"{lib[1]:.6f} ms", flush=True)
    del sets, layouts
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


def fmm_case(torch, fb, dev, m, k, n, pro, dtype):
    """Kernels 10-12 against their plain versions at one shape → ``{output:
    max|d|}``, each within FMM_TOL of its largest plain value."""
    x, w, scale, bias, dy, ds1, ds2 = fmm_inputs(torch, m, k, n, dtype, dev, 0)
    if not pro:
        scale = bias = None
    got = dict(zip(("y", "s1", "s2"), fb.fused_matmul_bn_fwd(x, w, scale,
                                                             bias)))
    want = dict(zip(("y", "s1", "s2"), fb.matmul_bn_reference(x, w, scale,
                                                              bias)))
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
    return abs_err


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
        abs_err = fmm_case(torch, fb, dev, m, k, n, pro, dtype)
        if (m, k, n, pro) in path:
            tile = "" if dtype == "float32" else "_mma"
            for key, name in (("fwd", "y"), ("dx", "dx"), ("dw", "dw")):
                path_err[key + tile] = max(path_err[key + tile],
                                           abs_err[name])
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


def fmm_bytes(m, k, n, es):
    """Bytes kernels 10, 11 and 12 must move at (m, k, n) with a
    prologue: each input read once, each output written once; scale,
    bias, ds1, ds2 and the column sums float32."""
    return ((m * k + k * n + m * n) * es + 2 * k * 4 + 2 * n * 4,
            (2 * m * n + k * n + 2 * m * k) * es + 4 * k * 4 + 2 * n * 4,
            (m * k + 2 * m * n + k * n) * es + 2 * k * 4 + 2 * n * 4)


def time_fused_matmul_bn(torch, fb, dev, dtype, rate, shape=FMM_REP[:3],
                         note=""):
    """Times of kernels 10, 11 and 12 at ``(M, K, N)`` with the prologue
    (by default the representative launch, stage 1's c3 at B=128),
    cycling 2 input sets (about 0.9 GB each in float32 at the default).
    The library call for each is cuBLAS's product alone
    (``torch.matmul``): no PyTorch call computes the fused function."""
    m, k, n = shape
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
    label = f"({m}, {k}, {n}) prologue {dtype}{note}"
    out = tuple(
        report(f"fused_matmul_bn_{part}{tile_suffix(dtype)} {label}",
               times, nbytes, rate, *bound_operations(dtype, 2 * m * k * n))
        for part, times, nbytes in zip(("fwd", "dx", "dw"), (fwd, dx, dw),
                                       fmm_bytes(m, k, n, es)))
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


# the int8 path's kernels: the port's three (dequantize before quantize,
# whose kernel name it contains), then cuDNN's convolutions (the float
# net's), the layout copies, pooling and PyTorch's elementwise kernels
_INT8_FAMILIES = (
    ("int8_conv", ("int8_conv",)), ("dequantize", ("dequantize",)),
    ("quantize", ("quantize", "minmax")),
    ("conv", ("fprop", "conv", "cudnn", "winograd", "xmma", "implicit")),
    ("gemm", ("gemm", "nvjet", "cutlass")), ("copy", ("copy",)),
    ("pooling", ("pool",)),
    ("bn_elementwise", ("elementwise", "reduce", "batch_norm")),
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
    backward_bookkeeping(torch, net, SoftmaxCrossEntropyLoss(), batch)
    for k, n in amp_bert_steps(torch, np, dev, batch).items():
        counts[k] += n
    return counts


def backward_bookkeeping(torch, net, ce, batch):
    """What the grad_req bookkeeping costs on this step's graph: the
    backward alone (after a synchronised forward), three ways in turns,
    BOOK_ROUNDS rounds in a rotating order: through
    ``autograd.backward``; through ``torch.autograd.backward`` with the
    parameters' grad_req hooks idle (what PyTorch's own backward pays
    for them); through ``torch.autograd.backward`` with the hooks taken
    off for the call (the parent's path).  Each way's median and,
    against the last way in the same round, the quartiles of the
    difference."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.examples.train_bert import pretraining_loss
    hooked = [(p, dict(p._backward_hooks)) for p in net.parameters()
              if p._backward_hooks]

    def plain(h):
        torch.autograd.backward([h], [torch.ones_like(h)])

    runs = {"autograd.backward": autograd.backward,
            "torch, hooks idle": plain, "torch, no hooks": plain}
    names = list(runs)
    times = {k: [] for k in runs}
    for r in range(BOOK_ROUNDS):
        for name in names[r % 3:] + names[:r % 3]:
            for p in net.parameters():
                p.grad = None
            with autograd.record():
                loss = pretraining_loss(net, ce, *batch)
            if name == "torch, no hooks":
                for p, _ in hooked:
                    p._backward_hooks.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name](loss)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            for p, hooks in hooked:
                p._backward_hooks.update(hooks)
            del loss
    for p in net.parameters():
        p.grad = None
    base = times[names[-1]]
    parts = []
    for k in runs:
        part = f"{k} {statistics.median(times[k]):.3f} ms"
        if k != names[-1]:
            diffs = [a - b for a, b in zip(times[k], base)]
            part += (" (less the last, quartiles "
                     f"{[round(q, 3) for q in statistics.quantiles(diffs, n=4)]})")
        parts.append(part)
    print(f"grad_req bookkeeping, {len(hooked)} parameters with the hook: "
          f"the backward alone, {BOOK_ROUNDS} rounds in turns, median: "
          + "; ".join(parts), flush=True)


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
        wall, busy, _ = profile_window(torch, name, part, families)
        total_wall += wall
        total_busy += busy
    print(f"  profiled step, whole: wall {total_wall:.3f} ms, device busy "
          f"{total_busy:.3f} ms, idle share {1 - total_busy / total_wall:.3f}",
          flush=True)


def profile_window(torch, name, part, families):
    """Run ``part()`` (which ends in a synchronise) under the profiler and
    print its wall and device-busy ms, idle share, busy ms by kernel
    family and the six device kernels (or copies) that took longest, by
    name; returns ``(wall, busy, {kernel name: (count, ms)})``."""
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
    return wall, busy, by_name


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
    step and the capture) and its median step ms."""
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
    return counts, res["step_ms_median"]


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


# the LSTM language model's kernels: the port's cross-entropy pair, then
# cuDNN's RNN kernels (their names carry RNN or LSTM), then the products
# (cuDNN's input projections and the decoder, cuBLAS), the embedding's
# gather and scatter, and PyTorch's elementwise kernels and reductions
# (dropout, the weight copy into cuDNN's layout, the gradient norm, SGD)
_LSTM_FAMILIES = (
    ("xent", ("xent",)),
    ("cudnn_rnn", ("rnn", "lstm", "persist")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "splitk", "sm90")),
    ("embedding", ("embedding", "index", "gather", "scatter", "sort",
                   "radix")),
    ("elementwise", ("elementwise", "reduce", "fill", "copy", "dropout",
                     "bernoulli", "distribution")),
    ("memcpy", ("memcpy", "memset")))


def lstm_args(torch, seed):
    """The LSTM layer's inputs at the phase's width on the CPU: data (T,
    B, 650), a flat parameter drawn U(±1/sqrt(H)) (PyTorch's LSTM
    default: gates away from their linear range), h0 and c0, and head
    gradients for out, hN and cN."""
    from incubator_mxnet_tpu_torch.ops.sequence_ops import rnn_param_size
    g = torch.Generator().manual_seed(seed)
    h, layers = LSTM_UNITS, LSTM_LAYERS
    n = rnn_param_size(LSTM_UNITS, h, layers, "lstm")
    args = [torch.randn(LSTM_T, LSTM_B, LSTM_UNITS, generator=g),
            (torch.rand(n, generator=g) * 2 - 1) / h ** 0.5,
            torch.randn(layers, LSTM_B, h, generator=g) * 0.5,
            torch.randn(layers, LSTM_B, h, generator=g) * 0.5]
    heads = [torch.randn(LSTM_T, LSTM_B, h, generator=g),
             torch.randn(layers, LSTM_B, h, generator=g),
             torch.randn(layers, LSTM_B, h, generator=g)]
    return args, heads


def check_cudnn_lstm(torch, dev):
    """Phase 13 (a): ``fused_rnn`` (cuDNN's LSTM on views of the flat
    parameter) against ``fused_rnn_reference`` (the JAX scan as a loop)
    on the card, two layers at T=35, B=32, 650 units: out, hN, cN and
    the gradients of the data, the flat parameter and the states.
    Returns the worst output error and gradient ratio."""
    import warnings
    from incubator_mxnet_tpu_torch.ops import sequence_ops as so
    args, heads = lstm_args(torch, 11)
    kw = dict(state_size=LSTM_UNITS, num_layers=LSTM_LAYERS, mode="lstm")
    res = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for fn in (so.fused_rnn, so.fused_rnn_reference):
            leaves = [a.to(dev).requires_grad_() for a in args]
            outs = fn(*leaves, **kw)
            torch.autograd.backward(outs, [hd.to(dev) for hd in heads])
            torch.cuda.synchronize()
            res.append(([o.detach() for o in outs],
                        [a.grad for a in leaves]))
    print(f"warnings of the first fused_rnn calls: "
          f"{sorted({str(w.message)[:100] for w in caught})}", flush=True)
    (outs, grads), (routs, rgrads) = res
    out_err = max((a - b).abs().max().item() for a, b in zip(outs, routs))
    ratios = [((a - b).abs().max() / b.abs().max()).item()
              for a, b in zip(grads, rgrads)]
    assert grads[1].shape == args[1].shape, grads[1].shape
    print(f"cuDNN LSTM (fused_rnn) against fused_rnn_reference, T={LSTM_T} "
          f"B={LSTM_B} {LSTM_UNITS}/{LSTM_UNITS} x {LSTM_LAYERS} layers, "
          f"float32: out/hN/cN max|d| {out_err:.3e} (tol {LSTM_OUT_TOL:g}); "
          f"gradients max|d|/max|g| data {ratios[0]:.3e}, params_flat "
          f"{ratios[1]:.3e} (one tensor of {grads[1].numel()}), h0 "
          f"{ratios[2]:.3e}, c0 {ratios[3]:.3e} (tol {LSTM_GRAD_TOL:g})",
          flush=True)
    assert out_err <= LSTM_OUT_TOL, out_err
    assert max(ratios) <= LSTM_GRAD_TOL, ratios
    return out_err, max(ratios)


def time_cudnn_lstm(torch, dev):
    """Forward + backward of the two-layer LSTM at the phase's shape:
    ``fused_rnn`` (the JAX layout's views, which cuDNN copies into its
    own layout each call) against ``torch.nn.LSTM`` on a weight buffer
    already in cuDNN's layout, CUDA-event ms over 20 calls, then each
    once under the profiler: the difference is the copy and the
    gradient's way back into the flat vector."""
    from incubator_mxnet_tpu_torch.ops import sequence_ops as so
    args, heads = lstm_args(torch, 12)
    x, p, h0, c0 = (a.to(dev) for a in args)
    x.requires_grad_()
    p.requires_grad_()
    heads = [hd.to(dev) for hd in heads]
    lib = torch.nn.LSTM(LSTM_UNITS, LSTM_UNITS, LSTM_LAYERS).to(dev)

    def ours():
        outs = so.fused_rnn(x, p, h0, c0, state_size=LSTM_UNITS,
                            num_layers=LSTM_LAYERS, mode="lstm")
        torch.autograd.backward(outs, heads)

    def library():
        out, (hn, cn) = lib(x, (h0, c0))
        torch.autograd.backward([out, hn, cn], heads)

    times = {}
    for name, fn in (("fused_rnn", ours), ("nn.LSTM", library)):
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 20
    print(f"LSTM forward + backward at T={LSTM_T}, B={LSTM_B}, "
          f"{LSTM_UNITS} units, {LSTM_LAYERS} layers, CUDA events over 20 "
          f"calls: fused_rnn {times['fused_rnn']:.4f} ms, torch.nn.LSTM "
          f"(weights in cuDNN's layout) {times['nn.LSTM']:.4f} ms",
          flush=True)

    def synced(fn):
        def run():
            fn()
            torch.cuda.synchronize()
        return run

    tables = [profile_window(torch, name, synced(fn), _LSTM_FAMILIES)[2]
              for name, fn in (("fused_rnn fwd+bwd", ours),
                               ("nn.LSTM fwd+bwd", library))]
    extra = {k: (tables[0].get(k, (0, 0.0)), tables[1].get(k, (0, 0.0)))
             for k in set(tables[0]) | set(tables[1])
             if tables[0].get(k, (0,))[0] != tables[1].get(k, (0,))[0]}
    print("kernels whose count differs, fused_rnn (n, ms) against nn.LSTM "
          "(n, ms): " + "; ".join(
              f"{k[:80]}: {a[0]}, {a[1]:.4f} / {b[0]}, {b[1]:.4f}"
              for k, (a, b) in sorted(extra.items())), flush=True)
    return times


def lstm_stream(np):
    """``(windows, eval window)``: a (T·DISTINCT·reps + 1, B) time-major
    token matrix from ``RandomState(0)`` whose B columns each repeat a
    random sequence of T·DISTINCT tokens, cut into word_lm's windows
    (inputs rows i..i+T, targets rows i+1..i+T+1)."""
    rs = np.random.RandomState(0)
    base = rs.randint(0, LSTM_VOCAB, (LSTM_T * LSTM_DISTINCT, LSTM_B))
    reps = LSTM_STEPS // LSTM_DISTINCT
    corpus = np.concatenate([base] * reps + [base[:1]]).astype(np.int64)
    return [(corpus[i:i + LSTM_T], corpus[i + 1:i + 1 + LSTM_T])
            for i in range(0, LSTM_T * LSTM_DISTINCT * reps, LSTM_T)]


def train_lstm_lm(torch, np, dev, smi):
    """Phase 13 (b); returns the path's launch counts."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.utils import clip_global_norm
    from incubator_mxnet_tpu_torch.models import LSTMLanguageModel
    print(f"float32 with TF32 off: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} (cuDNN's RNN reads the "
          "latter: FMA math, no TF32)", flush=True)
    model = LSTMLanguageModel(LSTM_VOCAB, LSTM_UNITS, LSTM_UNITS,
                              LSTM_LAYERS, dropout=LSTM_DROPOUT)
    model.initialize(device=dev, generator=torch.Generator().manual_seed(0))
    model.drop.generator = torch.Generator(device=dev).manual_seed(1)
    params = list(model.collect_params().values())
    trainer = Trainer(params, "sgd", {"learning_rate": LSTM_LR,
                                      "momentum": 0.0})
    loss_fn = SoftmaxCrossEntropyLoss()
    windows = [tuple(torch.from_numpy(a).to(dev) for a in w)
               for w in lstm_stream(np)]

    def eval_loss(x, y):
        with autograd.predict_mode(), torch.no_grad():
            out = model(x, model.begin_state(LSTM_B, device=dev))[0]
            return loss_fn(out.reshape(-1, LSTM_VOCAB), y.reshape(-1)).mean(
            ).item()

    def step(x, y, state, check=False):
        state = [s.detach() for s in state]
        with autograd.record():
            out, state = model(x, state)
            loss = loss_fn(out.reshape(-1, LSTM_VOCAB), y.reshape(-1)).mean()
        autograd.backward(loss)
        grads = [p.grad for p in params]
        sizes = torch.stack([g.abs().max() for g in grads])
        if check:
            raw = {k: p.grad.clone() for k, p in
                   model.collect_params().items()}
            old = {k: p.detach().clone() for k, p in
                   model.collect_params().items()}
        norm = clip_global_norm(grads, LSTM_CLIP)
        trainer.step(1)
        if check:
            check_update(old, raw, norm)
        return loss, state, norm, sizes

    def check_update(old, raw, norm):
        """Each of the model's own parameters (read from the model
        afresh, ``rnn.params_flat`` among them) moved by exactly
        ``-lr · min(clip / (norm + 1e-12), 1) · grad``, within float32
        rounding: the clipped SGD step reached the weights the model
        runs, not a copy."""
        scale = min(LSTM_CLIP / (norm + 1e-12), 1.0)
        for k, p in model.collect_params().items():
            want = old[k] - LSTM_LR * (raw[k] * scale)
            moved = (p.detach() - old[k]).abs().max().item()
            err = (p.detach() - want).abs().max().item()
            tol = 4 * torch.finfo(torch.float32).eps * max(
                old[k].abs().max().item(), (LSTM_LR * scale * raw[k]).abs()
                .max().item())
            print(f"  step 1 update of {k}: max|moved| {moved:.3e}, "
                  f"max|d| from -lr*{scale:.4f}*grad {err:.3e} (tol "
                  f"{tol:.3e})", flush=True)
            assert moved > 0 and err <= tol, (k, moved, err, tol)

    before = eval_loss(*windows[0])
    state = model.begin_state(LSTM_B, device=dev)
    xent = ("softmax_xent.fwd_launches", "softmax_xent.bwd_launches")
    losses, norms, sizes, bad, step_ms = [], [], [], [], []
    torch.cuda.synchronize()
    zero_launches()                                     # path starts
    last = kernel_launches()
    for i, (x, y) in enumerate(windows):
        t0 = time.monotonic()
        loss, state, norm, size = step(x, y, state, check=i == 0)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        if i == 0:          # the peak of steps 2-20, without the check's
            torch.cuda.reset_peak_memory_stats(dev)     # copies
            base = torch.cuda.memory_allocated(dev)
        now = kernel_launches()
        if any(now[k] - last[k] != 1 for k in xent):
            bad.append({k: now[k] - last[k] for k in xent})
        last = now
        losses.append(loss)
        norms.append(norm)
        sizes.append(size)
    launched = kernel_launches()                        # path ends
    peak = torch.cuda.max_memory_allocated(dev)
    held = sum(p.numel() * p.element_size() for p in params)
    after = eval_loss(*windows[0])
    losses = [v.item() for v in losses]
    sizes = torch.stack(sizes).cpu()
    print(f"{LSTM_STEPS} steps, SGD lr {LSTM_LR}, clip {LSTM_CLIP}, dropout "
          f"{LSTM_DROPOUT}, windows repeating every {LSTM_DISTINCT}: losses "
          f"{[round(v, 4) for v in losses]}; gradient norms before clipping "
          f"{[round(v, 4) for v in norms]}", flush=True)
    print(f"predict-mode loss of window 0 (ln {LSTM_VOCAB} = "
          f"{math.log(LSTM_VOCAB):.4f}): before {before:.6f}, after "
          f"{after:.6f} ({after - before:+.6f})", flush=True)
    assert not bad, f"cross-entropy launches a step: {bad[:3]}"
    assert np.isfinite(losses).all() and np.isfinite(norms).all(), losses
    assert torch.isfinite(sizes).all() and (sizes > 0).all(), \
        f"a gradient is zero or not finite: {sizes}"
    assert abs(losses[0] - math.log(LSTM_VOCAB)) < 0.5, losses[0]
    assert after < before, (before, after)
    tokens = LSTM_T * LSTM_B
    h, e, v = LSTM_UNITS, LSTM_UNITS, LSTM_VOCAB
    # the two layers' input and recurrent products at every step and the
    # decoder, forward; the backward twice that
    flops = 3 * 2 * tokens * (4 * h * (e + h) + 4 * h * (h + h) + h * v)
    med = statistics.median(step_ms[2:])
    counts = {"softmax_xent_fwd": launched[xent[0]],
              "softmax_xent_bwd": launched[xent[1]]}
    print(f"training path launches: {counts} (1/1 a step)", flush=True)
    print(f"LSTM LM step, host clock around a step ending in a "
          f"synchronise (the clip's float() waits mid-step): median over "
          f"steps 3-{LSTM_STEPS} {med:.3f} ms ({tokens / med * 1e3:.0f} "
          f"tokens/s), min {min(step_ms[2:]):.3f} ms, all "
          f"{[round(v, 3) for v in step_ms]}; {flops / 1e9:.2f} GFLOP of "
          f"products a step, {flops / med / 1e9:.2f} TFLOP/s achieved, "
          f"float32 FMA floor {flops / FP32_PEAK * 1e3:.3f} ms; peak device "
          f"memory of steps 2-{LSTM_STEPS} {peak - base} bytes "
          f"({(peak - base) / 2**30:.3f} GiB) above the {base} bytes "
          f"allocated as step 2 starts ({held} of them the model's "
          f"parameters; the rest its data and state and what earlier "
          f"phases still hold); {smi}", flush=True)

    def one_step():
        step(*windows[0], state)
        torch.cuda.synchronize()

    profile_window(torch, "LSTM LM step", one_step, _LSTM_FAMILIES)
    lstm_share(torch, one_step)
    del model, trainer, windows
    return counts


def lstm_share(torch, part):
    """Profile ``part()`` (one training step ending in a synchronise)
    with the host's ops as well, and print the device time of the
    kernels that cuDNN's LSTM launches (those under ``aten::_cudnn_rnn``
    and ``aten::_cudnn_rnn_backward``, its products included) against
    the step's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        part()
    events = prof.events()
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in (
                "aten::_cudnn_rnn", "aten::_cudnn_rnn_backward"):
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            ops[e.name] = ops.get(e.name, 0.0) + t / 1e3
    lstm = sum(ops.values())
    print(f"  LSTM LM step with host ops profiled: device busy {busy:.3f} "
          f"ms; cuDNN's LSTM (kernels under the op) "
          f"{({k: round(v, 4) for k, v in sorted(ops.items())})}, "
          f"{lstm:.3f} ms, {lstm / busy:.3f} of busy", flush=True)
    assert len(ops) == 2 and 0 < lstm < busy, ops


# SSD's kernels: cuDNN's convolutions (their names carry fprop, dgrad or
# wgrad, or implicit, winograd, fft), max pooling, the sorts, scatters
# and gathers of the targets and the loss's pick, the softmaxes (the
# loss's log_softmax and the mining softmax are PyTorch's; kernel 3 runs
# only in the detections), PyTorch's reductions (BatchNorm's statistics
# and its backward's sums, the loss's sums) and elementwise kernels
# (BatchNorm's normalize, ReLU, the loss, Adam)
_SSD_FAMILIES = (
    ("conv", ("fprop", "dgrad", "wgrad", "conv", "cudnn", "winograd",
              "implicit", "fft", "xmma", "gemm", "nvjet")),
    ("pooling", ("pool",)),
    ("sort_scatter", ("sort", "radix", "scatter", "gather", "index",
                      "cub", "argsort")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "fill", "copy", "foreach")),
    ("memcpy", ("memcpy", "memset")))


def ssd_labels(np, rng, batch):
    """(B, SSD_M, 5) float32 rows ``[cls, x0, y0, x1, y1]``: 1-3 boxes an
    image, sides 0.1-0.9 of the image, classes 0-19, the rest -1."""
    labels = np.full((batch, SSD_M, 5), -1.0, np.float32)
    for b in range(batch):
        for j in range(rng.randint(1, SSD_M + 1)):
            w, h = rng.uniform(0.1, 0.9, 2)
            x0, y0 = rng.uniform(0, 1 - w), rng.uniform(0, 1 - h)
            labels[b, j] = [rng.randint(0, 20), x0, y0, x0 + w, y0 + h]
    return labels


def ssd_scenes(np, batch, seed):
    """Synthetic VOC-like scenes → ``(images (B, 3, 300, 300) float32 in
    [0, 1], labels)``: noise, with each object's box painted half in a
    colour of its class."""
    rng = np.random.RandomState(seed)
    colours = rng.rand(20, 3).astype(np.float32)
    labels = ssd_labels(np, rng, batch)
    x = rng.rand(batch, 3, SSD_IMAGE, SSD_IMAGE).astype(np.float32)
    for b, j in zip(*np.nonzero(labels[..., 0] >= 0)):
        cls, x0, y0, x1, y1 = labels[b, j]
        r0, r1, c0, c1 = (int(v * SSD_IMAGE) for v in (y0, y1, x0, x1))
        x[b, :, r0:r1, c0:c1] = (x[b, :, r0:r1, c0:c1] + colours[int(cls)]
                                 [:, None, None]) / 2
    return x, labels


def ssd_anchors(torch, co):
    """``ssd_300()``'s anchors (1, 119276, 4) on the CPU, from its five
    feature maps."""
    from incubator_mxnet_tpu_torch.models import ssd_300
    net = ssd_300()
    return torch.cat([co.multibox_prior(torch.zeros(1, 1, m, m), sizes=sz,
                                        ratios=r)
                      for m, sz, r in zip(SSD_MAPS, net.sizes, net.ratios)],
                     dim=1)


def ssd_targets_agree(torch, np, co, got, want, anchors, labels, cls_preds):
    """Card targets ``got`` against CPU targets ``want`` (each ``(loc_t,
    loc_m, cls_t)``, all from CPU copies of the inputs): location targets
    within SSD_FLOAT_TOL, masks equal, class targets equal except at
    near-ties (module notes) → ``(max |d loc_t|, near-ties, anchors that
    differ)``."""
    got = [t.cpu().numpy() for t in got]
    want = [t.numpy() for t in want]
    cls_t = want[2]
    probs = torch.softmax(cls_preds, dim=1)[:, 0].numpy()
    best_iou = co.box_iou(anchors, labels[..., 1:5]).numpy()
    best_iou = np.where(labels[:, None, :, 0].numpy() >= 0, best_iou,
                        -1.0).max(axis=2)
    near = np.abs(best_iou - 0.5) <= SSD_NEAR
    for b in range(cls_t.shape[0]):
        cand = cls_t[b] <= 0
        score = np.where(cand, 1.0 - probs[b], -1.0)
        k = int(np.float32((cls_t[b] > 0).sum()) * np.float32(3.0))
        ranked = np.sort(score[cand])[::-1]
        if 0 < k < len(ranked) and ranked[k - 1] - ranked[k] <= SSD_NEAR:
            near[b] |= cand & (np.abs(score - ranked[k - 1]) <= SSD_NEAR)
    loc_near = np.repeat(near, 4, axis=1)
    assert ((got[1] == want[1]) | loc_near).all(), "loc_mask"
    err = float(np.where(loc_near, 0.0, np.abs(got[0] - want[0])).max())
    assert err <= SSD_FLOAT_TOL, err
    differ = got[2] != cls_t
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]
    return err, int(near.sum()), int(differ.sum())


def ssd_detections_agree(torch, np, co, got, want, cls_prob, loc, anchors):
    """Card detections ``got`` against the CPU's ``want`` (B, N, 6): in
    every image without an NMS near-tie (two boxes of one class among the
    400 best overlapping within SSD_NEAR of the threshold, counted on the
    CPU's boxes), class ids and dropped rows equal and every value within
    SSD_FLOAT_TOL → ``(max |d|, images with a near-tie)``."""
    got, want = got.cpu().numpy(), want.numpy()
    # the 400 best rows, nothing suppressed
    best = co.multibox_detection(cls_prob, loc, anchors, **{
        **SSD_DET, "nms_threshold": 2.0})[:, :SSD_DET["nms_topk"]]
    iou = co.box_iou(best[..., 2:], best[..., 2:])
    same = (best[..., None, 0] == best[..., None, :, 0]) & (
        best[..., None, 1] > 0) & (best[..., None, :, 1] > 0)
    tied = ((iou - SSD_DET["nms_threshold"]).abs() <= SSD_NEAR) & same
    tied_images = set(np.nonzero(tied.flatten(1).any(1).numpy())[0])
    err = 0.0
    for b in range(want.shape[0]):
        if b in tied_images:
            continue
        np.testing.assert_array_equal(got[b, :, 0], want[b, :, 0])
        np.testing.assert_array_equal(got[b, :, 1] == -1, want[b, :, 1] == -1)
        err = max(err, float(np.abs(got[b] - want[b]).max()))
    assert err <= SSD_FLOAT_TOL, err
    assert (want[..., 1] > 0).any()
    return err, len(tied_images)


def compare_ssd_step(torch, np, dev):
    """Phase 14 (a): one Adam step of ``ssd_300()`` at B=2, 300x300, on
    the CPU and on the card from the same weights (carried by
    ``params_from_jax`` into the card's deferred layers): the targets,
    the loss and gradients (both from the CPU's targets, so that a
    near-tie cannot move them), the updates and the weights."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.models import SSDLoss, ssd_300
    from incubator_mxnet_tpu_torch.ops import contrib_ops as co
    x, labels = (torch.from_numpy(a) for a in ssd_scenes(np, SSD_B_CPU, 1))
    cpu = ssd_300()
    cpu.initialize(device="cpu", generator=torch.Generator().manual_seed(0))
    with autograd.pause():
        cpu(x)                                  # materialise the weights
    card = ssd_300()
    card.initialize(device=dev)
    params_from_jax(params_to_numpy(cpu), card)
    results, targets = [], []
    for net, where in ((cpu, "cpu"), (card, dev)):
        trainer = Trainer(net.collect_params(), "adam",
                          {"learning_rate": SSD_LR})
        xb, lb = x.to(where), labels.to(where)
        t0 = time.monotonic()
        with autograd.record():
            anchors, cls_preds, box_preds = net(xb)
            targets.append(net.targets(anchors, lb, cls_preds))
            loc_t, loc_m, cls_t = (t.to(where) for t in targets[0])
            loss = SSDLoss()(cls_preds, box_preds, cls_t, loc_t, loc_m)
        autograd.backward(loss)
        grads = grads_to_numpy(net)
        before = params_to_numpy(net)
        trainer.step(SSD_B_CPU)
        after = params_to_numpy(net)
        results.append((loss.sum().item(), grads, after,
                        {k: after[k] - before[k] for k in after},
                        time.monotonic() - t0))
        if where == "cpu":
            cpu_anchors, cpu_cls = anchors, cls_preds.detach()
    print(f"SSD-300 step at B={SSD_B_CPU}, {SSD_IMAGE}x{SSD_IMAGE}: CPU "
          f"{results[0][4]:.2f} "
          f"s, card {results[1][4]:.3f} s (deferred init and cuDNN's first "
          "calls included)", flush=True)
    err, near, differ = ssd_targets_agree(torch, np, co, targets[1],
                                          targets[0], cpu_anchors, labels,
                                          cpu_cls)
    print(f"targets card vs CPU: loc_target max|d| {err:.3e}; class targets "
          f"differ at {differ} anchors, near-ties {near}; matched "
          f"{int((targets[0][2] > 0).sum())}, ignored "
          f"{int((targets[0][2] < 0).sum())} of {targets[0][2].numel()}",
          flush=True)
    # the convolution biases in front of a BatchNorm (module notes)
    noise = [k for k in results[0][1]
             if re.fullmatch(r"stage\d+\.[03]\.bias", k)]
    for (_, grads, *_rest), where in zip(results, ("cpu", "card")):
        for k in noise:
            bound = SSD_NOISE_TOL * np.abs(
                grads[k.replace("bias", "weight")]).max()
            assert np.abs(grads[k]).max() <= bound, (where, k)
    held = [tuple({k: v for k, v in d.items() if k not in noise}
                  if isinstance(d, dict) else d for d in r) for r in results]
    print(f"{len(noise)} convolution biases in front of a BatchNorm: "
          f"gradient noise below {SSD_NOISE_TOL:g} of their weights' on "
          "both devices", flush=True)
    return check_step(np, held, SSD_GRAD_TOL, SSD_LR)


def compare_detection_ops(torch, np, dev):
    """Phase 14 (b): ``multibox_target`` (mining 3:1) and
    ``multibox_detection`` (SSD's settings) at B=32 over ssd_300()'s
    119276 anchors, card against CPU, from seeded inputs."""
    from incubator_mxnet_tpu_torch.ops import contrib_ops as co
    rng = np.random.RandomState(3)
    anchors = ssd_anchors(torch, co)
    labels = torch.from_numpy(ssd_labels(np, rng, SSD_B))
    gen = torch.Generator().manual_seed(3)
    cls_preds = torch.randn(SSD_B, 21, SSD_ANCHORS, generator=gen)
    loc = torch.randn(SSD_B, SSD_ANCHORS * 4, generator=gen) * 0.5
    cls_prob = torch.softmax(cls_preds, dim=1)
    t0 = time.monotonic()
    want_t = co.multibox_target(anchors, labels, cls_preds,
                                negative_mining_ratio=3.0)
    t1 = time.monotonic()
    want_d = co.multibox_detection(cls_prob, loc, anchors, **SSD_DET)
    t2 = time.monotonic()
    args = [a.to(dev) for a in (anchors, labels, cls_preds, cls_prob, loc)]
    got_t = co.multibox_target(*args[:3], negative_mining_ratio=3.0)
    got_d = co.multibox_detection(args[3], args[4], args[0], **SSD_DET)
    torch.cuda.synchronize()
    err_t, near_t, differ = ssd_targets_agree(torch, np, co, got_t, want_t,
                                              anchors, labels, cls_preds)
    err_d, tied = ssd_detections_agree(torch, np, co, got_d, want_d,
                                       cls_prob, loc, anchors)
    times = {}
    for name, fn in (("multibox_target", lambda: co.multibox_target(
            *args[:3], negative_mining_ratio=3.0)),
            ("multibox_detection", lambda: co.multibox_detection(
                args[3], args[4], args[0], **SSD_DET))):
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t) * 1e3)
        times[name] = round(min(runs), 3)
    kept = int((want_d[..., 1] > 0).sum())
    print(f"detection ops at B={SSD_B}, N={SSD_ANCHORS}, card vs CPU: "
          f"multibox_target loc max|d| {err_t:.3e}, class targets differ at "
          f"{differ} anchors (near-ties {near_t}); multibox_detection "
          f"max|d| {err_d:.3e}, {kept} rows kept, images with an NMS "
          f"near-tie {tied}; CPU {t1 - t0:.2f} s and {t2 - t1:.2f} s; card "
          f"ms (host clock, best of 3) {times}", flush=True)
    assert tied <= 2, tied


def ssd_step(torch, net, trainer, lossfn, x, labels):
    """One SSD training step → ``(loss (B,), anchors, cls_preds,
    box_preds)``, the gradients left in ``.grad`` until
    ``trainer.step``."""
    from incubator_mxnet_tpu_torch import autograd
    with autograd.record():
        anchors, cls_preds, box_preds = net(x)
        loc_t, loc_m, cls_t = net.targets(anchors, labels, cls_preds)
        loss = lossfn(cls_preds, box_preds, cls_t, loc_t, loc_m)
    autograd.backward(loss)
    return loss, anchors, cls_preds, box_preds


def train_ssd_300(torch, np, dev):
    """Phase 14 (c); returns the SSD path's launch counts."""
    from incubator_mxnet_tpu_torch import random
    from incubator_mxnet_tpu_torch.convert import grads_to_numpy
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.models import SSDLoss, ssd_300
    from incubator_mxnet_tpu_torch.ops import contrib_ops as co
    from incubator_mxnet_tpu_torch.ops import nn_ops
    random.seed(0)
    net = ssd_300()
    net.initialize(device=dev)
    x, labels = (torch.from_numpy(a).to(dev)
                 for a in ssd_scenes(np, SSD_B, 2))
    trainer = Trainer(net.collect_params(), "adam",
                      {"learning_rate": SSD_LR})
    lossfn = SSDLoss()
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()                                     # main path starts
    losses, stamps = [], [time.perf_counter()]
    for i in range(SSD_STEPS):
        loss, anchors, cls_preds, box_preds = ssd_step(
            torch, net, trainer, lossfn, x, labels)
        if i in (0, SSD_STEPS - 1):
            grads = grads_to_numpy(net)
            bad = [k for k, p in net.named_parameters() if p.requires_grad
                   and not (np.isfinite(grads[k]).all()
                            and np.abs(grads[k]).max() > 0)]
            assert not bad, (i, bad)
        trainer.step(SSD_B)
        losses.append(loss.mean().item())
        stamps.append(time.perf_counter())
    train_launches = dict(kernel_launches())
    peak = torch.cuda.max_memory_allocated() - start
    det = net.detections(cls_preds, box_preds, anchors)
    torch.cuda.synchronize()
    launched = kernel_launches()                        # main path ends
    assert not any(train_launches.values()), (
        f"a kernel launched in the training steps: {train_launches}")
    assert launched["softmax.fwd_launches"] == 1, launched
    assert sum(launched.values()) == 1, launched
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    det = det.cpu().numpy()
    assert det.shape == (SSD_B, SSD_ANCHORS, 6) and np.isfinite(det).all()
    assert (det[..., 1] > 0).any()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    med = statistics.median(step_ms)
    print(f"SSD-300 training, B={SSD_B}, {SSD_IMAGE}x{SSD_IMAGE}, float32, "
          f"Adam lr "
          f"{SSD_LR}: {SSD_STEPS} steps on one batch, losses finite, "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (all: "
          f"{[round(v, 4) for v in losses]}); every parameter's gradient "
          f"finite and nonzero at steps 1 and {SSD_STEPS}; no kernel "
          "launched in a training step, kernel 3 once in the detections",
          flush=True)
    print(f"SSD-300 step: median {med:.3f} ms over steps 2-{SSD_STEPS} "
          f"(host clock, the loss read back each step), "
          f"{SSD_B / med * 1e3:.1f} img/s; peak device memory "
          f"{peak} bytes above the {start} allocated as the steps "
          f"started; detections {int((det[..., 1] > 0).sum())} rows kept",
          flush=True)

    def one_step():
        ssd_step(torch, net, trainer, lossfn, x, labels)[0].mean().item()
        trainer.step(SSD_B)
        torch.cuda.synchronize()

    profile_window(torch, "SSD-300 step", one_step, _SSD_FAMILIES)
    # the detections split: the class softmax (kernel 3 and its movedim
    # copies), the NMS loop, and the rest of multibox_detection (decode,
    # the best class, the top-400 sort, the compaction)
    nms_ms = []
    real_keep = co._nms_keep

    def timed_keep(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_keep(*args, **kwargs)
        torch.cuda.synchronize()
        nms_ms.append((time.perf_counter() - t) * 1e3)
        return out

    parts = []
    co._nms_keep = timed_keep
    try:
        for _ in range(3):
            with torch.no_grad():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                probs = nn_ops.softmax(cls_preds, axis=1)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                co.multibox_detection(probs, box_preds, anchors, **SSD_DET)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
    finally:
        co._nms_keep = real_keep
    sm_ms, det_ms = (min(p[i] for p in parts) for i in (0, 1))
    loop_ms = min(nms_ms)
    print(f"SSD.detections at B={SSD_B} (host clock, best of 3): softmax "
          f"{sm_ms:.3f} ms, multibox_detection {det_ms:.3f} ms, of which "
          f"the NMS loop ({SSD_DET['nms_topk']} iterations) {loop_ms:.3f} "
          "ms", flush=True)

    # several calls in one window: a trace may lack a call's first
    # records, so the kernel-3 records are counted against the launches
    calls = 5

    def detections():
        for _ in range(calls):
            net.detections(cls_preds, box_preds, anchors)
        torch.cuda.synchronize()

    _, _, by_name = profile_window(torch, f"SSD.detections, {calls} calls",
                                   detections, _SSD_FAMILIES)
    seen = [(n, ms) for k, (n, ms) in by_name.items() if "softmax_fwd" in k]
    print(f"  SSD.detections: {sum(n for n, _ in by_name.values()) / calls} "
          f"device kernels and copies a call; kernel 3 records "
          f"{sum(n for n, _ in seen)} of {calls} launches, "
          f"{sum(ms for _, ms in seen) / max(1, sum(n for n, _ in seen)):.6f} "
          "ms each", flush=True)
    bn_share(torch, net, x)
    return {name: launched[key] for name, key in _KERNEL_COUNTERS.items()}


def bn_share(torch, net, x):
    """BatchNorm's own busy time in one step: the 8 BatchNorm layers of
    ``net`` in training mode, forward and backward, on the inputs they
    see in a forward of ``x``, profiled alone (in the step's trace their
    kernels are PyTorch's reductions and elementwise kernels, which the
    ReLUs, the loss and Adam launch too)."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon import nn
    inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: inputs.append((m, a[0].detach())))
        for m in net.modules() if isinstance(m, nn.BatchNorm)]
    try:
        with autograd.pause():
            net(x)
    finally:
        for h in hooks:
            h.remove()

    def fwd_bwd():
        for m, a in inputs:
            a = a.requires_grad_()
            with autograd.record():
                out = m(a)
            autograd.backward(out)
        torch.cuda.synchronize()

    fwd_bwd()
    profile_window(torch, f"the {len(inputs)} BatchNorm layers alone, "
                   "forward + backward", fwd_bwd, _SSD_FAMILIES)


def ssd_example(torch, np):
    """Phase 14 (d): ``examples/train_ssd.py`` on the card at its defaults
    (200 steps at 96x96, B=16), whose loss must fall by half, and at the
    JAX suite's size (40 steps at 32x32, B=2), where image 0's best
    detection must be its box's class (0) above 0.5 within 0.1 of the
    box (``tests/test_contrib_det.py``'s check)."""
    from incubator_mxnet_tpu_torch.examples import train_ssd
    t0 = time.monotonic()
    out = train_ssd.main([])
    secs = time.monotonic() - t0
    losses, det = out["losses"], out["detections"][0]
    top = det[det[:, 1] > 0]
    print(f"train_ssd.py at its defaults: {len(losses)} steps in "
          f"{secs:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f} (must "
          f"halve); image 0's best detection {top[:1].round(4).tolist()}",
          flush=True)
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0]
    out = train_ssd.main(["--batch-size", "2", "--image-size", "32",
                          "--steps", "40"])
    losses, det = out["losses"], out["detections"][0]
    top = det[det[:, 1] > 0.5]
    print(f"train_ssd.py at the JAX suite's size: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; image 0's detections above 0.5: "
          f"{top[:3].round(4).tolist()}", flush=True)
    assert losses[-1] < 0.5 * losses[0], losses
    assert len(top) >= 1 and top[0][0] == 0, top
    np.testing.assert_allclose(top[0][2:], [.1, .1, .45, .45], atol=0.1)



def _flat_state(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat_state(s)]
    return [state]


def bf16_ulp(np, x):
    """One bfloat16 ulp at each value of ``x`` (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, np.maximum(e, -125) - 8)


def check_optimizers(torch, np, dev):
    """Phase 15 (a): one update of an OPT_SHAPE weight by each optimizer,
    float32 and bfloat16 with a float32 master, on the card against the
    CPU.  SGLD draws its noise from a CPU generator of one seed on both
    devices.  Returns the worst float32 error over the largest value."""
    from incubator_mxnet_tpu_torch import optimizer as opt_mod
    gen = torch.Generator().manual_seed(0)
    w0 = torch.randn(OPT_SHAPE, generator=gen)
    g0 = 0.1 * torch.randn(OPT_SHAPE, generator=gen)
    worst = 0.0
    for case, name, kw in OPT_CASES:
        line = []
        for dtype, master in ((torch.float32, False), (torch.bfloat16, True)):
            outs = []
            for where in (torch.device("cpu"), dev):
                kwargs = dict(kw, wd=0.01, multi_precision=master)
                if name == "sgld":
                    kwargs["generator"] = torch.Generator().manual_seed(1)
                up = opt_mod.get_updater(opt_mod.create(name, **kwargs))
                w = w0.to(where, dtype).clone()
                up(0, g0.to(where, dtype).clone(), w)
                assert w.device == where and w.dtype == dtype, case
                outs.append([t.float().cpu().numpy() for t in
                             [w] + _flat_state(up.states[0])])
            (cpu, card), tol = outs, (OPT_NORM_TOL if name in ("lamb", "lars")
                                      else OPT_TOL)
            assert len(cpu) == len(card), case
            errs, differ = [], []
            for i, (a, b) in enumerate(zip(card, cpu)):
                assert np.isfinite(a).all(), (case, i)
                differ.append(int((a != b).sum()))
                if master and i == 0:       # the bfloat16 weight
                    continue
                err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
                assert err <= tol, (case, str(dtype), i, err)
                errs.append(err)
                if dtype == torch.float32:
                    worst = max(worst, err)
            if master:
                # the bfloat16 weight is its master rounded on each device:
                # one bf16 ulp apart, or, where the master ends near 0 by
                # cancellation, as far apart as the masters may be
                a, b = card[0], cpu[0]
                near = tol * np.abs(cpu[1]).max()
                assert (np.abs(a - b) <= np.maximum(bf16_ulp(np, b),
                                                    near)).all(), case
            line.append(f"{str(dtype)[6:]}: {len(cpu)} tensors, "
                        + ("bit for bit" if not any(differ) else
                           f"elements that differ {differ}, max|d|/max "
                           f"{max(errs):.2e}"))
        print(f"  {case}: {'; '.join(line)}", flush=True)
    print(f"{len(OPT_CASES)} optimizer cases (18 optimizers, RMSProp both "
          f"ways), card against CPU at {OPT_SHAPE}: worst float32 "
          f"max|d|/max {worst:.3e} (tol {OPT_TOL:g}; LAMB, LARS "
          f"{OPT_NORM_TOL:g}); bfloat16 weights within one bf16 ulp, or "
          f"the masters' tolerance where they end near 0",
          flush=True)
    return worst


def lamb_bert(torch, np, dev, tmp):
    """Phase 15 (b) and (c): BERT-base pretraining in bfloat16 with LAMB,
    saved after LAMB_N steps and resumed in a fresh model and trainer;
    returns the resumed run's launch counts."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch import ndarray as nd
    from incubator_mxnet_tpu_torch.examples.train_bert import synthetic_batch
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln
    from incubator_mxnet_tpu_torch.ops import softmax_xent as sx
    from incubator_mxnet_tpu_torch.optimizer.lr_scheduler import (
        PolyScheduler)
    batch = [torch.from_numpy(a).to(dev)
             for a in synthetic_batch(TRAIN_B, T, VOCAB)]
    ce = SoftmaxCrossEntropyLoss()

    def build(seed):
        net = BERTModel(vocab_size=VOCAB, dropout=0.0).initialize(
            device=dev, generator=torch.Generator().manual_seed(seed))
        return amp.convert_block(net, "bfloat16")

    def no_decay(net):
        for k, p in net.collect_params().items():
            if k.endswith(("gamma", "beta", "bias")):
                p.wd_mult = 0.0

    def lamb(net, begin=0):
        return Trainer(net.collect_params(), "lamb", {
            "learning_rate": LAMB_LR, "multi_precision": True, "wd": 0.01,
            "begin_num_update": begin,
            "lr_scheduler": PolyScheduler(max_update=2 * LAMB_N,
                                          base_lr=LAMB_LR, pwr=1,
                                          warmup_steps=2)})

    def run(net, trainer, n, times=None):
        fwd_bwd, update = bert_step_parts(torch, net, trainer, ce, batch)
        losses, lrs = [], []
        for _ in range(n):
            t0 = time.monotonic()
            loss = fwd_bwd()
            t1 = time.monotonic()
            update()
            if times is not None:
                times.append(((time.monotonic() - t0) * 1e3,
                              (time.monotonic() - t1) * 1e3))
            losses.append(loss.float().item())
            lrs.append(trainer.learning_rate)
        return losses, lrs

    def eval_loss(net):
        from incubator_mxnet_tpu_torch.examples.train_bert import (
            pretraining_loss)
        with torch.no_grad(), autograd.predict_mode():
            return float(pretraining_loss(
                net, lambda z, y: ce(z.float(), y), *batch))

    def spread(a, b):
        return max((x.float() - y.float()).abs().max().item()
                   / max(y.float().abs().max().item(), 1e-30)
                   for x, y in zip(a, b))

    # the uninterrupted run, twice: the card's own repeat spread
    finals, logs = [], []
    for rep in range(2):
        net = build(1)
        no_decay(net)
        trainer = lamb(net)
        if rep == 0:
            before = eval_loss(net)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        times = []
        logs.append(run(net, trainer, 2 * LAMB_N, times))
        if rep == 0:
            peak = torch.cuda.max_memory_allocated() - base
            held = torch.cuda.memory_allocated() - base
            states = trainer._updater.states.values()
            masters = sum(s[0].numel() * 4 for s in states
                          if isinstance(s[1], tuple))
            moments = sum(t.numel() * t.element_size() for s in states
                          for t in _flat_state(s)) - masters
            after = eval_loss(net)
            step_ms = [a for a, _ in times]
            opt_ms = [b for _, b in times]
        finals.append([p.detach().clone() for p in net.parameters()])
        del net, trainer
        gc.collect()
    losses, lrs = logs[0]
    repeat = spread(finals[1], finals[0])
    print(f"LAMB, multi_precision, bfloat16 BERT-base at B={TRAIN_B}, "
          f"T={T}: {2 * LAMB_N} steps, lrs {lrs}, training losses "
          f"(bfloat16) {losses}; float32 predict-mode loss {before:.6f} -> "
          f"{after:.6f}", flush=True)
    print(f"repeat of the uninterrupted run: losses "
          f"{'equal' if logs[1] == logs[0] else logs[1]}, weights "
          f"{'bit for bit' if repeat == 0 else 'max|d|/max %.3e' % repeat}",
          flush=True)
    assert np.isfinite(losses).all() and losses[-1] <= losses[0], losses
    assert after < before, (before, after)
    want_lrs = [PolyScheduler(max_update=2 * LAMB_N, base_lr=LAMB_LR, pwr=1,
                              warmup_steps=2)(n)
                for n in range(1, 2 * LAMB_N + 1)]
    assert lrs == want_lrs, (lrs, want_lrs)
    print(f"LAMB step, host clock around a synchronised step: median over "
          f"steps 3-{2 * LAMB_N} {statistics.median(step_ms[2:]):.3f} ms "
          f"(optimizer {statistics.median(opt_ms[2:]):.3f} ms), all "
          f"{[round(v, 3) for v in step_ms]}", flush=True)
    print(f"master copies {masters} bytes, moments {moments} bytes; held "
          f"after the run above the weights {held} bytes, peak above them "
          f"{peak} bytes (torch.cuda.max_memory_allocated)", flush=True)

    # the main path: LAMB_N steps, save, a fresh model loads, LAMB_N more
    pf, sf = os.path.join(tmp, "bert.params"), os.path.join(tmp, "bert.states")
    ln.launches = ln.bwd_launches = 0   # training path starts here
    sx.fwd_launches = sx.bwd_launches = 0
    net = build(1)
    no_decay(net)
    trainer = lamb(net)
    first = run(net, trainer, LAMB_N)
    net.save_parameters(pf)
    trainer.save_states(sf)
    loaded = nd.load(pf)               # (c): the card's file on the CPU
    params = net.collect_params()
    assert list(loaded) == list(params)
    for k, p in params.items():
        assert loaded[k].dtype == p.dtype and torch.equal(
            loaded[k], p.detach().cpu()), k
    print(f"(c) {len(loaded)} parameters written from the card "
          f"({os.path.getsize(pf)} bytes) read back on the CPU: equal, "
          f"dtypes kept", flush=True)
    del net, trainer, loaded, params
    gc.collect()
    fresh = build(2)
    fresh.load_parameters(pf)
    no_decay(fresh)
    trainer = lamb(fresh, begin=LAMB_N)
    trainer.load_states(sf)
    rest = run(fresh, trainer, LAMB_N)
    counts = {"layer_norm_fwd": ln.launches, "layer_norm_bwd": ln.bwd_launches,
              "softmax_xent_fwd": sx.fwd_launches,
              "softmax_xent_bwd": sx.bwd_launches}   # training path ends
    resumed = [p.detach() for p in fresh.parameters()]
    gap = spread(resumed, finals[0])
    print(f"resumed after {LAMB_N} steps: losses {first[0] + rest[0]}, "
          f"lrs {first[1] + rest[1]}; weights against the uninterrupted "
          f"run {'bit for bit' if gap == 0 else 'max|d|/max %.3e' % gap} "
          f"(repeat spread {repeat:.3e}); launches {counts}", flush=True)
    assert (first[1] + rest[1]) == lrs
    assert gap <= repeat, (gap, repeat)
    if repeat == 0:
        assert first[0] + rest[0] == losses
    want = {"layer_norm_fwd": 25, "layer_norm_bwd": 25,
            "softmax_xent_fwd": 2, "softmax_xent_bwd": 2}
    for k, n in want.items():
        assert counts[k] == n * 2 * LAMB_N, (k, counts[k])
    fwd_bwd, update = bert_step_parts(torch, fresh, trainer, ce, batch)
    step_breakdown(torch, fwd_bwd, update)
    del fresh, trainer, finals, resumed
    gc.collect()
    return counts

def decode_record(payload):
    """A raw 224x224 record → (float32 HWC image / 255, int32 label), with
    numpy only (it runs in the DataLoader's worker processes)."""
    import numpy as np
    from incubator_mxnet_tpu_torch import recordio
    header, img = recordio.unpack_raw(payload)
    return img.astype(np.float32) / 255.0, np.int32(header.label)


def bitwise_diff(torch, got, want):
    """Names of the tensors of ``want`` that ``got`` does not equal bit
    for bit."""
    return [k for k, w in want.items() if not torch.equal(got[k], w)]


def tree_on_card(step):
    return {k: v.detach().clone() for k, v in step.state_tree().items()}


def launches_times(counts, n):
    return {_KERNEL_COUNTERS[k]: v * n for k, v in counts.items()}


def chunked_against_sequential(torch, np, dev):
    """Phase 16 (a): ResNet-50 float32 at B=CHUNK_B, cuDNN deterministic,
    K=CHUNK_K over CHUNK_N batches against CHUNK_N per-step calls."""
    from incubator_mxnet_tpu_torch import bench
    rng = np.random.RandomState(1)
    batches = [(torch.from_numpy(rng.rand(CHUNK_B, IMAGE, IMAGE, 3).astype(
        np.float32)).to(dev), torch.from_numpy(rng.randint(
            0, CLASSES, CHUNK_B).astype(np.int32)).to(dev))
        for _ in range(CHUNK_N)]
    torch.backends.cudnn.deterministic = True
    try:
        seq, _, _ = bench.build(CHUNK_B, "float32", dev)
        losses = [seq(x, y).float() for x, y in batches]
        ch, _, _ = bench.build(CHUNK_B, "float32", dev, chunk_steps=CHUNK_K)
        loop = ch.chunked_loop()
        recs = loop.run_epoch(batches)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    kinds = [(r["kind"], r["steps"]) for r in recs]
    tail = CHUNK_N % CHUNK_K
    assert kinds == [("chunk", CHUNK_K)] * (CHUNK_N // CHUNK_K) + [
        ("tail", tail)], kinds
    got = torch.cat([r["losses"] for r in recs])
    want = torch.stack(losses)
    means_ok = all(torch.equal(r["loss"], sum(
        losses[i * CHUNK_K + 1:(i + 1) * CHUNK_K], losses[i * CHUNK_K])
        / CHUNK_K) for i, r in enumerate(recs[:-1]))
    per_step = launches_times(resnet_step_launches(), 1)
    (captured,) = loop.capture_launches.values()
    (seq_captured,) = seq.capture_launches.values()
    a, b = tree_on_card(ch), tree_on_card(seq)
    diff = bitwise_diff(torch, a, b)
    worst = worst_ratio(np, {k: v.float().cpu().numpy() for k, v in a.items()},
                        {k: v.float().cpu().numpy() for k, v in b.items()})
    print(f"(a) chunked K={CHUNK_K} against sequential, float32, B={CHUNK_B}, "
          f"{CHUNK_N} batches ({kinds}): per-step losses bit for bit "
          f"{torch.equal(got, want)} ({[round(v, 5) for v in got.tolist()]}), "
          f"chunk means bit for bit {means_ok}; {len(b)} parameters, moving "
          f"statistics and momenta, {len(diff)} not bit for bit "
          f"{diff[:4]}, worst max|d|/max {worst[0]:.3e} ({worst[1]}); "
          f"capture launches {captured} (per step {seq_captured})",
          flush=True)
    assert seq_captured == per_step, (seq_captured, per_step)
    assert captured == launches_times(resnet_step_launches(), CHUNK_K), \
        captured
    assert loop.compile_count == 1 and torch.isfinite(got).all()
    assert torch.equal(got, want) and means_ok and not diff, diff


def dropout_chunked(torch, np, dev):
    """Phase 16 (b): the Dense(16) -> ReLU -> Dropout(0.5) -> Dense(5) net
    chunked against sequential on the card, with the default generator
    and with a private one; then two replays' masks."""
    from incubator_mxnet_tpu_torch.fuse import make_fused_train_step
    from incubator_mxnet_tpu_torch.gluon import nn
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss

    def net(gen):
        n = nn.HybridSequential()
        drop = nn.Dropout(0.5)
        drop.generator = gen
        n.add(nn.Dense(16, in_units=8, activation="relu"), drop,
              nn.Dense(5, in_units=16))
        return n.initialize(device=dev,
                            generator=torch.Generator().manual_seed(0))

    rng = np.random.RandomState(1)
    batches = [(torch.from_numpy(rng.rand(4, 8).astype("f")).to(dev),
                torch.from_numpy(rng.randint(0, 5, 4).astype("i4")).to(dev))
               for _ in range(8)]
    for private in (False, True):
        runs = []
        for k in (None, 4):
            torch.cuda.manual_seed(3)
            gen = (torch.Generator(device=dev).manual_seed(5) if private
                   else None)
            step = make_fused_train_step(
                net(gen), SoftmaxCrossEntropyLoss(), "sgd",
                {"learning_rate": 0.1, "momentum": 0.9}, device=dev,
                chunk_steps=k)
            if k is None:
                losses = torch.stack([step(x, y).float() for x, y in batches])
            else:
                losses = torch.cat([r["losses"] for r in
                                    step.chunked_loop().run_epoch(batches)])
            runs.append((losses, tree_on_card(step),
                         torch.rand(2, device=dev, generator=gen)))
        diff = bitwise_diff(torch, runs[1][1], runs[0][1])
        print(f"(b) Dropout(0.5), {'private' if private else 'default'} "
              f"generator: chunked K=4 against 8 per-step calls: losses bit "
              f"for bit {torch.equal(runs[0][0], runs[1][0])}, state "
              f"{len(diff)} tensors off, next draws equal "
              f"{torch.equal(runs[0][2], runs[1][2])}", flush=True)
        assert torch.equal(runs[0][0], runs[1][0]) and not diff
        assert torch.equal(runs[0][2], runs[1][2])
    step = make_fused_train_step(net(None), SoftmaxCrossEntropyLoss(), "sgd",
                                 {"learning_rate": 0.0}, device=dev,
                                 chunk_steps=4)
    x = torch.rand(64, 8, device=dev)
    y = torch.randint(0, 5, (64,), device=dev, dtype=torch.int32)
    recs = step.chunked_loop().run_epoch([(x, y)] * 12)
    first, second = recs[1]["losses"], recs[2]["losses"]
    print(f"(b) lr 0, one batch, chunks 2 and 3 (replays): losses "
          f"{[round(v, 5) for v in first.tolist()]} and "
          f"{[round(v, 5) for v in second.tolist()]}", flush=True)
    assert not torch.equal(first, second)
    assert len(set(torch.cat([first, second]).tolist())) == 8


def remat_compare(torch, np, dev):
    """Phase 16 (c): one bf16 step at B=128 with remat "dots" and
    "nothing" against None, cuDNN deterministic."""
    from incubator_mxnet_tpu_torch import bench
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (None, "dots", "nothing"):
            gc.collect()
            torch.cuda.empty_cache()
            step, x, y = bench.build(BENCH_B, "bfloat16", dev, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            loss = step.step_fn(x, y)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) - base
            state = tree_on_card(step)
            step(x, y)                       # warm-up and capture
            times = []
            for _ in range(REMAT_REPLAYS):
                t0 = time.monotonic()
                step(x, y)
                torch.cuda.synchronize()
                times.append((time.monotonic() - t0) * 1e3)
            out[remat] = (loss.float().item(), state, peak,
                          statistics.median(times))
            del step, x, y
    finally:
        torch.backends.cudnn.deterministic = False
    plain = out[None]
    for remat in ("dots", "nothing"):
        loss, state, peak, ms = out[remat]
        diff = bitwise_diff(torch, state, plain[1])
        worst = max(((state[k].float() - plain[1][k].float()).abs().max()
                     / plain[1][k].float().abs().max().clamp_min(1e-30))
                    .item() for k in plain[1])
        print(f"(c) remat={remat!r} against None, bf16, B={BENCH_B}, one "
              f"eager step: loss {loss!r} against {plain[0]!r}; "
              f"{len(diff)} of {len(state)} tensors not bit for bit, worst "
              f"max|d|/max {worst:.3e} (tol {GRAPH_TOL:g}); peak above the "
              f"state {peak} against {plain[2]} bytes "
              f"({peak / plain[2]:.3f}); replay median {ms:.3f} ms against "
              f"{plain[3]:.3f} ms", flush=True)
        assert abs(loss - plain[0]) <= GRAPH_TOL * abs(plain[0]), loss
        assert worst <= GRAPH_TOL and peak < plain[2], (worst, peak)


def loop_path(torch, np, dev, smi, tmp, bench_ms):
    """Phase 16 (d) and (e): records on disk → process workers → the
    ring → K-step replays → a checkpoint at every chunk boundary; then
    the resume from the checkpoint after a chunk.  Returns the path's
    launch counts."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import bench, recordio
    from incubator_mxnet_tpu_torch.checkpoint import AsyncCheckpointManager
    from incubator_mxnet_tpu_torch.error import CheckpointCorruptError
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.gluon import data
    rec = os.path.join(tmp, "train.rec")
    t0 = time.monotonic()
    rng = np.random.default_rng(0)
    writer = recordio.MXIndexedRecordIO(os.path.join(tmp, "train.idx"), rec,
                                        "w")
    for i in range(LOOP_RECORDS):
        img = rng.integers(0, 256, (IMAGE, IMAGE, 3), dtype=np.uint8)
        label = float(rng.integers(0, CLASSES))
        writer.write_idx(i, recordio.pack_raw(
            recordio.IRHeader(0, label, i, 0), img))
    writer.close()
    print(f"(d) wrote {LOOP_RECORDS} raw {IMAGE}x{IMAGE} records, "
          f"{os.path.getsize(rec)} bytes, in {time.monotonic() - t0:.2f} s",
          flush=True)
    dataset = data.RecordFileDataset(rec).transform(decode_record)

    def loader(start=0):
        return data.DataLoader(
            dataset, batch_sampler=data.BatchSampler(
                data.SequentialSampler(LOOP_RECORDS - start, start=start),
                LOOP_B, "keep"), num_workers=LOOP_WORKERS, thread_pool=False)

    nb = -(-LOOP_RECORDS // LOOP_B)
    # the feed alone, without training: the loader, then loader and ring
    for what, feed in (("the loader", lambda: loader()),
                       ("the loader and the ring", lambda: (
                           b for b in data.DevicePrefetchRing(
                               loader(), LOOP_K, device=dev)))):
        t0 = time.monotonic()
        for _ in feed():
            pass
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        print(f"(d) {what} alone: one epoch of {nb} batches in "
              f"{dt * 1e3:.1f} ms ({LOOP_RECORDS / dt:.1f} img/s)", flush=True)
    kinds = [("chunk", LOOP_K)] * (nb // LOOP_K) + (
        [("tail", nb % LOOP_K)] if nb % LOOP_K else [])
    ckpt = AsyncCheckpointManager(os.path.join(tmp, "ckpt"), keep=5)
    torch.backends.cudnn.deterministic = True
    try:
        gc.collect()
        torch.cuda.empty_cache()
        step, _, _ = bench.build(LOOP_B, "bfloat16", dev, chunk_steps=LOOP_K)
        loop = step.chunked_loop()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()                                 # path starts
        epochs, saved = [], {}
        for epoch in range(LOOP_EPOCHS):
            marks = [torch.cuda.Event(enable_timing=True)]
            marks[0].record()
            host = [0.0]

            def on_chunk(record):
                t1 = time.monotonic()
                ckpt.save(loop.steps_run, step.state_tree())
                saved[(epoch, len(marks) - 1)] = loop.steps_run
                host[0] += time.monotonic() - t1
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()

            t0 = time.monotonic()
            recs = loop.run_epoch(loader(), on_chunk=on_chunk)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
            epochs.append((recs, ms, wall, loop.ring.wait_s, host[0]))
            if epoch == 0:
                peak = torch.cuda.max_memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            assert [(r["kind"], r["steps"]) for r in recs] == kinds
        ckpt.wait()
        timed_peak = torch.cuda.max_memory_allocated(dev)
        final = tree_on_card(step)
        # chunk replays on one block, each timed by the host clock around
        # the replay and a synchronise (as phase 8 (b) times a step)
        block = next(b for b in data.DevicePrefetchRing(loader(), LOOP_K,
                                                        device=dev))
        torch.cuda.synchronize()
        replay_ms = []
        for _ in range(REMAT_REPLAYS):
            t0 = time.monotonic()
            loop.run_chunk(block[1], block[2])
            torch.cuda.synchronize()
            replay_ms.append((time.monotonic() - t0) * 1e3 / LOOP_K)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            loop.run_chunk(block[1], block[2])
            torch.cuda.synchronize()
            prof_wall = (time.monotonic() - t0) * 1e3
        del block
        (captured,) = loop.capture_launches.values()
        del step, loop
        gc.collect()
        torch.cuda.empty_cache()
        # (e) a fresh model, step and loop resume from the checkpoint
        # saved after the last epoch's first chunk
        resume_at = saved[(LOOP_EPOCHS - 1, 0)]
        fresh, _, _ = bench.build(LOOP_B, "bfloat16", dev,
                                  chunk_steps=LOOP_K, seed=1)
        fresh.load_state_tree(ckpt.restore(resume_at))
        floop = fresh.chunked_loop()
        rrecs = floop.run_epoch(loader(start=LOOP_K * LOOP_B))
        torch.cuda.synchronize()
        launched = kernel_launches()                    # path ends
        resumed = tree_on_card(fresh)
        del fresh, floop
    finally:
        torch.backends.cudnn.deterministic = False
    counts = {k: launched[_KERNEL_COUNTERS[k]]
              for k in resnet_step_launches()}
    per_step = launches_times(resnet_step_launches(), 1)
    losses = torch.cat([r["losses"] for e in epochs for r in e[0]])
    assert torch.isfinite(losses).all(), losses
    first_mean = epochs[0][0][0]["loss"].item()
    last_mean = epochs[-1][0][-2]["loss"].item()
    print(f"(d) {LOOP_EPOCHS} epochs of {nb} batches ({kinds}), bf16, "
          f"B={LOOP_B}, K={LOOP_K}, {LOOP_WORKERS} process workers: chunk "
          f"means {[[round(r['loss'].item(), 4) for r in e[0]] for e in epochs]}"
          f"; first chunk's mean {first_mean:.4f}, last chunk's "
          f"{last_mean:.4f}", flush=True)
    assert last_mean < first_mean, (first_mean, last_mean)
    med = statistics.median(replay_ms)
    for i, (recs, ms, wall, wait_s, host_s) in enumerate(epochs):
        print(f"(d) epoch {i}: wall {wall * 1e3:.1f} ms ("
              f"{nb * LOOP_B / wall:.1f} img/s end to end); device time "
              f"between consecutive chunk boundaries "
              f"{[round(v, 3) for v in ms]} ms (the first from the epoch's "
              f"start, with the ring's first fill); the consumer waited on "
              f"the ring "
              f"{wait_s * 1e3:.1f} ms; checkpoint saves took "
              f"{host_s * 1e3:.1f} ms of host time", flush=True)
    in_loop = [e[1][k] / LOOP_K for e in epochs[1:]
               for k in range(1, nb // LOOP_K)]
    busy = sum(device_families(prof, _RESNET_FAMILIES).values())
    print(f"(d) step time over chunk replays (host clock around a replay "
          f"and a synchronise / {LOOP_K}): median {med:.3f} ms "
          f"({LOOP_B / med * 1e3:.1f} img/s), all "
          f"{[round(v, 3) for v in replay_ms]}; in the loop, the device "
          f"time between the chunk boundaries after an epoch's first / "
          f"{LOOP_K}: {[round(v, 3) for v in in_loop]} ms; phase 8 "
          f"(b)'s per-step replay median {bench_ms:.3f} ms; one profiled "
          f"chunk: wall {prof_wall:.3f} ms, device busy {busy:.3f} ms, idle "
          f"share {1 - busy / prof_wall:.3f}; peak device memory "
          f"{peak} bytes over the capturing epoch ({peak / 2**30:.2f} GiB), "
          f"{timed_peak} over the replayed ones; {smi}", flush=True)
    print(f"(d) the {LOOP_K}-step capture's launches {captured} (a step's "
          f"{per_step}); path launches {counts}", flush=True)
    assert captured == launches_times(resnet_step_launches(), LOOP_K)
    # eager chunk + its capture + the tail's eager step + its capture, in
    # the first epoch and again in the resume
    n = 2 * (2 * LOOP_K + 2)
    assert counts == {k: v * n for k, v in resnet_step_launches().items()}
    diff = bitwise_diff(torch, resumed, final)
    want = [r["losses"] for r in epochs[-1][0][1:]]
    same = all(torch.equal(a["losses"], b) for a, b in zip(rrecs, want))
    print(f"(e) resumed from step {resume_at} in a fresh model: "
          f"{[(r['kind'], r['steps']) for r in rrecs]}, losses bit for bit "
          f"{same}; {len(diff)} of {len(final)} tensors not bit for bit "
          f"{diff[:4]}", flush=True)
    assert same and not diff
    steps = ckpt.all_steps()
    newest = os.path.join(ckpt.directory, f"step_{steps[-1]:08d}")
    victim = os.path.join(newest, sorted(
        f for f in os.listdir(newest) if f.endswith(".npy"))[0])
    with open(victim, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        ckpt.restore(steps[-1])
        raise AssertionError("a flipped byte loaded")
    except CheckpointCorruptError:
        pass
    older = ckpt.restore()
    want = ckpt.restore(steps[-2])
    assert all(torch.equal(older[k], want[k]) for k in want)
    print(f"(e) steps on disk {steps}; one byte of {os.path.basename(victim)}"
          f" flipped in step {steps[-1]}: strict restore raises, restore() "
          f"falls back to step {steps[-2]}", flush=True)
    return counts


def example_chunked(np):
    """Phase 16 (f): examples/train_resnet_fused.py --chunk-steps 2 at its
    defaults, in a process of its own."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m",
         "incubator_mxnet_tpu_torch.examples.train_resnet_fused",
         "--chunk-steps", "2"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    print(f"(f) train_resnet_fused --chunk-steps 2: rc {out.returncode} in "
          f"{time.monotonic() - t0:.1f} s; {out.stdout.strip()[-600:]}",
          flush=True)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-2])
    assert (res["chunk_steps"], res["chunks"], res["tail_steps"],
            res["loop_compiles"]) == (2, 2, 0, 1), res
    assert np.isfinite(res["step_losses"]).all()


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/bert:predict",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=120) as r:
        out = json.loads(r.read())
    return out, (time.monotonic() - t0) * 1e3


def _first_and_second(torch, autograd, fn, args, diff):
    """First gradients of a kernel op's sum(sin(out)) (plus a small part
    of its other outputs) with ``create_graph=True`` and without, from
    one graph; returns both and the loss of their squares."""
    for i in diff:
        args[i].requires_grad_(True)
    wrt = [args[i] for i in diff]
    out = fn(*args)
    outs = out if isinstance(out, tuple) else (out,)
    loss = torch.sin(outs[0].float()).sum()
    for k, o in enumerate(outs[1:]):
        loss = loss + (0.01 / (k + 1)) * torch.square(o).sum()
    first = autograd.grad(loss, wrt, create_graph=True, retain_graph=True)
    plain = torch.autograd.grad(loss, wrt, retain_graph=True)
    return first, plain, wrt


def _ho_case(torch, name, shape, dev):
    """(the op, its float32 inputs on ``dev``, the inputs it is
    differentiated in) for phase 17 (a)."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.ops import fused_block as fb
    from incubator_mxnet_tpu_torch.ops import fused_conv as fc
    from incubator_mxnet_tpu_torch.ops import nn_ops
    g = torch.Generator().manual_seed(17)

    def rand(*s, scale=1.0):
        return (scale * torch.randn(s, generator=g)).to(dev)

    if name == "layer_norm_bwd":
        cols = shape[1]
        return nn_ops.layer_norm, [rand(*shape), 1 + rand(cols, scale=0.1),
                                   rand(cols, scale=0.1)], (0, 1, 2)
    if name == "softmax_bwd":
        return nn_ops.softmax, [rand(*shape)], (0,)
    if name == "rms_norm_bwd":
        return nn_ops.rms_norm, [rand(*shape), 1 + rand(shape[1],
                                                        scale=0.1)], (0, 1)
    if name == "softmax_xent_bwd":
        labels = torch.randint(0, shape[1], (shape[0],), generator=g).to(dev)
        return (lambda x: nn_ops.softmax_xent(x, labels)), [rand(*shape)], \
            (0,)
    if name == "flash_attention_bwd":
        b, h, tq, tk, d, causal = shape
        return (lambda q, k, v: fa.flash_attention(q, k, v, causal=causal)), \
            [rand(b, h, tq, d), rand(b, h, tk, d), rand(b, h, tk, d)], \
            (0, 1, 2)
    if name == "fused_matmul_bn_bwd":
        m, k, n, prologue = shape
        args = [rand(m, k, scale=0.5), rand(k, n, scale=0.1)]
        if prologue:
            args += [1 + rand(k, scale=0.1), rand(k, scale=0.1)]
        return fb.fused_matmul_bn, args, tuple(range(len(args)))
    n, h, w, c, co = shape
    return fc.fused_conv3_bn, [rand(n, h, w, c, scale=0.5),
                               rand(3, 3, c, co, scale=0.1),
                               1 + rand(c, scale=0.1), rand(c, scale=0.1)], \
        (0, 1, 2, 3)


def check_second_derivatives(torch, dev):
    """Phase 17 (a): each kernel Function's first gradients under
    ``create_graph`` bit for bit those without it; a second derivative
    through its backward raises, naming the kernel."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.ops._higher_order import \
        HigherOrderGradientError
    for name, (shape,) in HO_CASES:
        fn, args, diff = _ho_case(torch, name, shape, dev)
        first, plain, wrt = _first_and_second(torch, autograd, fn, args,
                                              diff)
        same = all(torch.equal(a.detach(), b) for a, b in zip(first, plain))
        assert same, name
        try:
            autograd.grad(sum((t * t).sum() for t in first), wrt)
        except HigherOrderGradientError as e:
            assert name in str(e), (name, str(e))
            raised = str(e).split(":")[0]
        else:
            raise AssertionError(f"{name}: a second derivative through the "
                                 "kernel's backward did not raise")
        print(f"  {name} at {shape}: first gradients under create_graph "
              f"bit for bit; the second derivative raises "
              f"HigherOrderGradientError({raised!r})", flush=True)
        del first, plain, wrt, args
        gc.collect()
        torch.cuda.empty_cache()


def gp_step(torch, autograd, critic, real, fake, eps):
    """The gradient-penalty loss, recorded, and its backward."""
    with autograd.record():
        xhat = (eps * real + (1 - eps) * fake).requires_grad_(True)
        (dx,) = autograd.grad(critic(xhat).sum(), [xhat], create_graph=True)
        norm = dx.flatten(1).norm(dim=1)
        loss = (critic(real).mean() - critic(fake).mean()
                + GP_LAMBDA * ((norm - 1) ** 2).mean())
    autograd.backward(loss)
    return loss


def gp_inputs(torch, np):
    from incubator_mxnet_tpu_torch.examples.train_mnist import synthetic_data
    real, _ = synthetic_data(MNIST_B, seed=17)
    rng = np.random.RandomState(18)
    fake = 0.5 * rng.rand(MNIST_B, 1, 28, 28).astype(np.float32)
    eps = rng.rand(MNIST_B, 1, 1, 1).astype(np.float32)
    return [torch.from_numpy(a) for a in (real, fake, eps)]


def gradient_penalty(torch, np, dev):
    """Phase 17 (b): the gradient-penalty step on LeNet, card against
    CPU, then GP_STEPS Adam steps on the card."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.examples.train_mnist import lenet
    from incubator_mxnet_tpu_torch.gluon import Trainer
    real, fake, eps = gp_inputs(torch, np)
    cpu = lenet()
    cpu.initialize(device="cpu", generator=torch.Generator().manual_seed(3))
    with autograd.pause():
        cpu(real)                               # materialise the weights
    card = lenet()
    card.initialize(device=dev)
    params_from_jax(params_to_numpy(cpu), card)
    out = []
    for net, where in ((cpu, "cpu"), (card, dev)):
        args = [a.to(where) for a in (real, fake, eps)]
        loss = gp_step(torch, autograd, net, *args)
        out.append((loss.item(), grads_to_numpy(net)))
    (l_cpu, g_cpu), (l_card, g_card) = out
    assert np.isfinite(l_card) and abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu), \
        (l_card, l_cpu)
    worst = 0.0
    for name, want in g_cpu.items():
        got = g_card[name]
        assert np.isfinite(got).all(), name
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GP_GRAD_TOL, (name, err)
        worst = max(worst, err)
    print(f"gradient penalty step: loss card {l_card:.7f} cpu {l_cpu:.7f}; "
          f"{len(g_cpu)} gradients, worst max|d|/max|g| {worst:.3e} (tol "
          f"{GP_GRAD_TOL:g})", flush=True)
    trainer = Trainer(card.collect_params(), "adam", {"learning_rate": GP_LR})
    args = [a.to(dev) for a in (real, fake, eps)]
    losses, step_ms = [], []
    for _ in range(GP_STEPS):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = gp_step(torch, autograd, card, *args)
        trainer.step(MNIST_B)
        torch.cuda.synchronize()
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    print(f"{GP_STEPS} gradient-penalty Adam steps (lr {GP_LR:g}, B="
          f"{MNIST_B}): losses {[round(v, 4) for v in losses]}; step time "
          f"median over steps 3-{GP_STEPS} "
          f"{statistics.median(step_ms[2:]):.3f} ms, min "
          f"{min(step_ms[2:]):.3f} ms (host clock around a synchronised "
          f"step)", flush=True)


def _bert_grads(torch, net):
    return {k: p.grad.detach().clone() for k, p in
            net.collect_params().items() if p.grad is not None}


def check_adam_step(torch, nd, params, before, ref_state, step, rescale):
    """Phase 17 (c): hold each weight that ``Trainer.step`` just updated
    to ``nd.adam_update`` on the weight and accumulated gradient it had
    (``before``), with the reference's own moments (``ref_state``) and
    Adam's bias-corrected rate at ``step``.  Returns the worst difference
    over its tolerance."""
    from incubator_mxnet_tpu_torch.optimizer.optimizer import Adam
    ada = Adam()
    coef = LR * math.sqrt(1 - ada.beta2 ** step) / (1 - ada.beta1 ** step)
    worst = 0.0
    for k, (w, g) in before.items():
        m, v = ref_state.get(k) or (torch.zeros_like(w), torch.zeros_like(w))
        want, m, v = nd.adam_update(w, g, m, v, lr=coef, beta1=ada.beta1,
                                    beta2=ada.beta2, epsilon=ada.epsilon,
                                    rescale_grad=rescale)
        ref_state[k] = (m, v)
        tol = ACC_UPD_ULPS * 2.0 ** -23 * want.abs().max().item() + (
            ACC_UPD_STEP * LR)
        err = (params[k].detach() - want).abs().max().item() / tol
        assert err <= 1.0, (k, step, err)
        worst = max(worst, err)
    return worst


def accumulate_bert(torch, np, dev):
    """Phase 17 (c): BERT-base gradient accumulation; returns the path's
    launch counts."""
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch import ndarray as nd
    from incubator_mxnet_tpu_torch.examples.train_bert import (
        pretraining_loss, synthetic_batch)
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    from incubator_mxnet_tpu_torch.ops import layer_norm as ln
    from incubator_mxnet_tpu_torch.ops import softmax_xent as sx
    net = BERTModel(vocab_size=VOCAB, dropout=0.0).initialize(
        device=dev, generator=torch.Generator().manual_seed(5))
    params, ce = net.collect_params(), SoftmaxCrossEntropyLoss()
    batch_b = ACC_MICRO * ACC_PARTS
    x, y_mlm, y_nsp = (torch.from_numpy(a).to(dev) for a in
                       synthetic_batch(batch_b, T, VOCAB, seed=9))

    def micro(i):
        rows = slice(i * ACC_MICRO, (i + 1) * ACC_MICRO)
        return x[rows], y_mlm.view(batch_b, T)[rows].reshape(-1), y_nsp[rows]

    def backward(batch, scale=1.0):
        with autograd.record():
            loss = pretraining_loss(net, ce, *batch) * scale
        autograd.backward(loss)
        return loss

    embed = params["word_embed.weight"]
    embed.grad_req = "null"
    # two "write" backwards in a row leave the second's gradient
    backward(micro(0))
    first = _bert_grads(torch, net)
    backward(micro(1))
    twice = _bert_grads(torch, net)
    params.zero_grad()
    backward(micro(1))
    second = _bert_grads(torch, net)
    for k, g in second.items():
        scale = g.abs().max().item()
        assert (twice[k] - g).abs().max().item() <= 1e-6 * scale, k
    moved = max((first[k] - second[k]).abs().max().item() for k in second)
    assert moved > 0, "the two micro-batches gave one gradient"
    # one B=16 batch with "write", the reference for the accumulation
    backward((x, y_mlm, y_nsp))
    want = _bert_grads(torch, net)
    for name, p in params.items():
        if p is not embed:
            p.grad_req = "add"
    params.zero_grad()
    for i in range(ACC_PARTS):
        backward(micro(i), 1.0 / ACC_PARTS)
    got = _bert_grads(torch, net)
    assert embed.grad is None and sorted(got) == sorted(want)
    worst = 0.0
    for k, g in want.items():
        err = (got[k] - g).abs().max().item() / max(g.abs().max().item(),
                                                    1e-30)
        assert err <= ACC_TOL, (k, err)
        worst = max(worst, err)
    print(f"accumulated gradient of {ACC_PARTS} micro-batches of "
          f"{ACC_MICRO} against one batch of {batch_b} with \"write\": "
          f"{len(want)} tensors, worst max|d|/max|g| {worst:.3e} (tol "
          f"{ACC_TOL:g}); two \"write\" backwards leave the second's "
          f"gradient", flush=True)
    params.zero_grad()
    trainer = Trainer(params, "adam", {"learning_rate": LR})
    embed_before = embed.detach().clone()
    ref_state = {}
    torch.cuda.synchronize()
    ln.launches = ln.bwd_launches = 0   # the accumulation path starts here
    sx.fwd_launches = sx.bwd_launches = 0
    losses, step_ms, upd_ulps = [], [], []
    for step in range(1, ACC_STEPS + 1):
        t0 = time.monotonic()
        total = sum(backward(micro(i), 1.0 / ACC_PARTS).item()
                    for i in range(ACC_PARTS))
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3
        before = {k: (p.detach().clone(), p.grad.clone())
                  for k, p in params.items() if p.grad is not None}
        t0 = time.monotonic()
        trainer.step(batch_b)
        params.zero_grad()
        torch.cuda.synchronize()
        step_ms.append(ms + (time.monotonic() - t0) * 1e3)
        losses.append(total)
        upd_ulps.append(check_adam_step(torch, nd, params, before, ref_state,
                                        step, 1.0 / batch_b))
        del before
    counts = {"layer_norm_fwd": ln.launches, "layer_norm_bwd": ln.bwd_launches,
              "softmax_xent_fwd": sx.fwd_launches,
              "softmax_xent_bwd": sx.bwd_launches}  # the path ends here
    # finite, not falling: BERT-base's first Adam steps raise the loss
    # (phase 6 (b): 11.59 -> 12.94 at step 3, then down); each update is
    # held to the update op instead (check_adam_step)
    assert np.isfinite(losses).all(), losses
    assert torch.equal(embed, embed_before) and embed.grad is None
    idx = list(params).index("word_embed.weight")
    assert idx not in trainer._updater.states
    norms = 2 * len(list(net.encoder.children())) + 1   # 25 in BERT-base
    want_counts = {"layer_norm_fwd": norms * ACC_PARTS,
                   "layer_norm_bwd": norms * ACC_PARTS,
                   "softmax_xent_fwd": 2 * ACC_PARTS,
                   "softmax_xent_bwd": 2 * ACC_PARTS}
    for k, n in want_counts.items():
        assert counts[k] == n * ACC_STEPS, (k, counts[k])
    print(f"{ACC_STEPS} accumulation steps (Adam lr {LR:g}): losses "
          f"{[round(v, 4) for v in losses]}; every updated weight against "
          f"nd.adam_update on the same weight and accumulated gradient, "
          f"worst max|d| / tol by step {[round(v, 4) for v in upd_ulps]} "
          f"(tol {ACC_UPD_ULPS:g} ulps of the largest value + "
          f"{ACC_UPD_STEP:g} lr); word "
          f"embedding unchanged, no gradient, no optimizer state; launches "
          f"{counts} ({want_counts} a step); step time median "
          f"{statistics.median(step_ms):.3f} ms, all "
          f"{[round(v, 3) for v in step_ms]} (host clock around a "
          f"synchronised step, less the copies the check takes)", flush=True)
    del net, trainer, params
    return counts


def _update_cases():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_update_op_cases as cases
    return cases


def check_update_ops(torch, np, dev):
    """Phase 17 (d), first part: every update op at UPD_SHAPE, card
    against CPU, float32 and bfloat16."""
    from incubator_mxnet_tpu_torch import ndarray as nd
    cases = _update_cases()
    line = []
    for name in cases.CANONICAL:
        differ = {}
        for dtype in (torch.float32, torch.bfloat16):
            specs, kw = cases.case(name, seed=21, shape=UPD_SHAPE)
            outs = []
            for where in ("cpu", dev):
                res = getattr(nd, name)(*cases.to_torch(torch, specs, dtype,
                                                        where), **kw)
                res = res if isinstance(res, tuple) else (res,)
                outs.append([r.float().cpu().numpy() for r in res])
            n_differ = 0
            for i, (want, got) in enumerate(zip(*outs)):
                assert np.isfinite(got).all(), (name, i)
                n_differ += int((got != want).sum())
                if name in cases.EXACT:
                    assert np.array_equal(got, want), (name, str(dtype), i)
                    continue
                allow = cases.card_tolerance(name) * max(
                    np.abs(want).max(), 1e-30)
                if dtype == torch.bfloat16:
                    allow = allow + bf16_ulp(np, want)
                assert (np.abs(got - want) <= allow).all(), (name, str(dtype),
                                                             i)
            differ[str(dtype)[6:]] = n_differ
        line.append(f"{name} {differ}")
    print(f"{len(cases.CANONICAL)} update ops at {UPD_SHAPE}, card against "
          f"CPU, elements that differ (float32, bfloat16): " +
          "; ".join(line), flush=True)


def multi_update_paths(torch, np, dev, smi):
    """Phase 17 (d), second part: the multi-tensor updates over
    BERT-base's parameters in bfloat16 with float32 masters, against the
    loop of single ops, with each path's time and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import ndarray as nd
    from incubator_mxnet_tpu_torch.models.bert import BERTModel
    shapes = [tuple(p.shape) for p in BERTModel(
        vocab_size=VOCAB).collect_params().values()]
    g = torch.Generator(device=dev).manual_seed(23)

    def rand(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    n = len(shapes)
    lrs = tuple(1e-3 * (1 + i % 3) for i in range(n))
    wds = tuple(0.01 * (i % 2) for i in range(n))
    bf, f32 = torch.bfloat16, torch.float32
    paths = {
        "multi_mp_sgd_mom_update": (
            [(rand(s, bf), rand(s, bf, 0.01), rand(s, f32, 0.01),
              rand(s, f32)) for s in shapes],
            dict(lrs=lrs, wds=wds, momentum=0.9), "mp_sgd_mom_update",
            lambda i: dict(lr=lrs[i], wd=wds[i], momentum=0.9)),
        "multi_mp_adamw_update": (
            [(rand(s, bf), rand(s, bf, 0.01), rand(s, f32, 0.01),
              rand(s, f32, 0.01).abs(), rand(s, f32)) for s in shapes],
            dict(lrs=lrs, wds=wds, etas=1.0), "mp_adamw_update",
            lambda i: dict(lr=lrs[i], wd=wds[i], eta=1.0)),
    }
    elements = sum(math.prod(s) for s in shapes)
    for name, (groups, kw, single, kw_i) in paths.items():
        flat = [t for grp in groups for t in grp]
        multi = getattr(nd, name)(*flat, **kw)
        loop = [getattr(nd, single)(*grp, **kw_i(i))
                for i, grp in enumerate(groups)]
        want = [o[j] for j in range(len(loop[0])) for o in loop]
        assert len(multi) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(multi, want)), name
        del multi, loop, want
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            getattr(nd, name)(*flat, **kw)
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            getattr(nd, name)(*flat, **kw)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        print(f"{name} over BERT-base's {n} tensors ({elements} elements, "
              f"bf16 weights, float32 masters): bit for bit the loop of "
              f"{single}; wall median {statistics.median(walls):.3f} ms "
              f"(all {[round(v, 3) for v in walls]}), device busy "
              f"{busy:.3f} ms, {len(kernels)} kernel launches; {smi}",
              flush=True)
        del groups, flat
        gc.collect()
        torch.cuda.empty_cache()


# ---- phase 18: the vision model zoo -------------------------------------

# ResNet-50 v2 (NHWC, fused) at B=128, 224x224, 1000 classes: (b) the
# float32 eager step fused against unfused, each timed over
# V2_TIMED steps after one; (c) the bf16 CUDA-graph step, V2_WARMUP
# warm-up and V2_STEPS replays
V2_TIMED, V2_WARMUP, V2_STEPS = 5, 2, 20
# (b) fused against unfused on the card from the same weights and batch:
# the loss V2_LOSS_TOL relative; the logits and every moving statistic
# max|d| <= V2_FWD_TOL * max|unfused|; every gradient but the stem BN's
# gamma max|d| <= V2_GRAD_MAX_TOL * max|unfused| and ||d|| <=
# V2_GRAD_NORM_TOL * ||unfused|| of its tensor.  These bounds are fixed.
# The gradients of this random-initialised net at B=128 move by 1-7 % of
# their largest value under a perturbation at rounding level: a 1e-6
# move of the input, which once rounded to float32 moves each pixel by
# 1e-6 plus up to half an ulp, moves the unfused path's gradients by a
# median 1.6 % (worst 6.8 %) in float32 and by 1.0 % (worst 5.4 %) with
# the net in float64, so the net's own sensitivity, not float32
# arithmetic, sets that size; the two paths round differently everywhere
# (3xTF32 tiles against cuDNN's float32 products, one-pass BN statistics
# from the kernels' sums against the layers') and differ by as much
# (PERF.md §6, on an H100).  The stem BN's gamma has an exact gradient
# of zero but for BN's eps (with beta at 0, ReLU and max-pool commute
# with its scale, and stage 1's bn1 normalizes it away): 3e-3 of the stem
# beta's in float64, and run to run on the same input its value moves by
# 43 %.  It is held to V2_GRAD_MAX_TOL of the stem beta's largest
# gradient.
V2_LOSS_TOL, V2_FWD_TOL = 1e-5, 1e-3
V2_GRAD_MAX_TOL, V2_GRAD_NORM_TOL = 0.15, 0.05
V2_STEM = "features.2"
# (d) one member of each family, float32 predict-mode logits at B=2 on
# the card against the same weights on the CPU (TF32 off): max|d| <=
# ZOO_CARD_TOL * max|CPU logit|.  cuDNN and oneDNN sum the products in
# other orders and may pick other algorithms (Winograd, FFT) through up
# to 121 layers.
ZOO_CARD_B, ZOO_CARD_TOL = 2, 1e-4
ZOO_CARD = [("resnet18_v1", 224), ("resnet18_v2", 224), ("resnet50_v2", 224),
            ("alexnet", 224), ("vgg11_bn", 224), ("squeezenet1.1", 224),
            ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
            ("densenet121", 224), ("inceptionv3", 299)]
# (e) examples/benchmark_score.py's eight default models, bfloat16
SCORE_MODELS = ["alexnet", "vgg16", "inception_v3", "resnet50_v1",
                "resnet152_v1", "mobilenet1_0", "densenet121",
                "squeezenet1_1"]
SCORE_BATCHES, SCORE_STEPS, SCORE_WARMUP = (1, 128), 20, 3
# (f) phase 13's LSTM LM converted to bfloat16: LSTM_BF16_STEPS steps.
# Its step-1 gradients (dropout off) against the float32 model's on the
# same bf16-rounded weights: ||d|| <= LSTM_BF16_GRAD_TOL * ||float32||
# for each tensor, a few bf16 roundings (2^-8 each) through 35 steps
LSTM_BF16_STEPS, LSTM_BF16_GRAD_TOL = 8, 5e-2


def resnet_v2_fmm_shapes(batch):
    """``(M, K, N, prologue)`` of every fused matmul + BN call in one
    ResNet-50 v2 forward at ``batch`` (224x224 input), in order: per
    bottleneck conv1 (bn1's prologue, from the block input's own
    statistics) at the block's input size, conv3 (bn3's prologue) at its
    output size and, in a stage's first block, the projection (bn1's
    prologue, strided in stages 2-4) at the output size.  Every call has
    a prologue."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        resnet_spec)
    _, layers, channels = resnet_spec[50]
    shapes, cin, side = [], channels[0], IMAGE // 4
    for i, (n_blocks, ch) in enumerate(zip(layers, channels[1:])):
        for b in range(n_blocks):
            side_in = side
            if i > 0 and b == 0:
                side //= 2
            k_in = cin if b == 0 else ch
            shapes += [(batch * side_in * side_in, k_in, ch // 4, True),
                       (batch * side * side, ch // 4, ch, True)]
            if b == 0:
                shapes.append((batch * side * side, k_in, ch, True))
        cin = ch
    return shapes


def resnet_v2_conv3_shapes(batch):
    """``(N, H, W, C, C_out)`` of every fused 3x3 call in one ResNet-50 v2
    forward at ``batch``: the stride-1 blocks' (every block but a stage's
    first in stages 2-4, whose stride-2 3x3 is PyTorch's convolution),
    each with bn2's prologue."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        resnet_spec)
    _, layers, channels = resnet_spec[50]
    shapes, side = [], IMAGE // 4
    for i, (n_blocks, ch) in enumerate(zip(layers, channels[1:])):
        side = side if i == 0 else side // 2
        strided = 0 if i == 0 else 1
        shapes += [(batch, side, side, ch // 4, ch // 4)] * (
            n_blocks - strided)
    return shapes


def resnet_v2_step_launches():
    """Launches of each kernel in one ResNet-50 v2 training step: 36 of
    each fused 1x1, 13 of each fused 3x3, one of each cross-entropy
    kernel."""
    mm = len(resnet_v2_fmm_shapes(RESNET_B))
    c3 = len(resnet_v2_conv3_shapes(RESNET_B))
    return {"fused_matmul_bn_fwd": mm, "fused_matmul_bn_dx": mm,
            "fused_matmul_bn_dw": mm, "fused_conv3_bn_fwd": c3,
            "fused_conv3_bn_dx": c3, "fused_conv3_bn_dw": c3,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}


def check_v2_kernels(torch, fb, dev, rate):
    """Phase 18 (a): every distinct kernel 10-12 instance of a ResNet-50
    v2 step at B=128 in both dtypes against its plain version (all 15
    with a prologue; 11 of them in no v1 call, the other four v1's
    conv3), and its kernel time (CUDA events) beside its bound.  The
    stride-1 3x3 shapes (kernels 13-16) are the four that v1 runs, which
    phase 3 holds against their plain versions already.  Returns the max
    |d| of y, dx and dw over the 15 shapes by tile."""
    shapes = list(dict.fromkeys(resnet_v2_fmm_shapes(RESNET_B)))
    v1 = set(resnet_fmm_shapes(RESNET_B))
    new = [s for s in shapes if s not in v1]
    print(f"ResNet-50 v2 at B={RESNET_B}: {len(shapes)} distinct fused 1x1 "
          f"shapes of {len(resnet_v2_fmm_shapes(RESNET_B))} calls, "
          f"{len(new)} of them not in v1's path", flush=True)
    err = {"fwd": 0.0, "dx": 0.0, "dw": 0.0, "fwd_mma": 0.0, "dx_mma": 0.0,
           "dw_mma": 0.0}
    for m, k, n, pro in shapes:
        for dtype in FMM_TOL:
            abs_err = fmm_case(torch, fb, dev, m, k, n, pro, dtype)
            tile = "" if dtype == "float32" else "_mma"
            for key, name in (("fwd", "y"), ("dx", "dx"), ("dw", "dw")):
                err[key + tile] = max(err[key + tile], abs_err[name])
            gc.collect()
            torch.cuda.empty_cache()
    for m, k, n, pro in shapes:
        for dtype in FMM_TOL:
            sets = [fmm_inputs(torch, m, k, n, dtype, dev, s)
                    for s in range(2)]
            fwd_sets = [a[:4] for a in sets]
            bwd_sets = [a[:4] + (fb.matmul_bn_reference(*a[:4])[0],) + a[4:]
                        for a in sets]
            es = sets[0][0].element_size()
            ops, peak = bound_operations(dtype, 2 * m * k * n)
            line = []
            for part, fn, argsets, nbytes in zip(
                    ("fwd", "dx", "dw"),
                    (fb.fused_matmul_bn_fwd, fb.fused_matmul_bn_dx,
                     fb.fused_matmul_bn_dw),
                    (fwd_sets, bwd_sets, bwd_sets), fmm_bytes(m, k, n, es)):
                _, ms = time_ms(torch, fn, argsets, iters=20, warmup=3)
                bound = max(nbytes / rate, ops / peak) * 1e3
                line.append(f"{part} {ms:.4f} ms (bound {bound:.4f}, "
                            f"{bound / ms:.2f})")
            print(f"  ({m}, {k}, {n}) {dtype}{' new' if (m, k, n, pro) in new else ''}"
                  f": " + "; ".join(line), flush=True)
            del sets, fwd_sets, bwd_sets
            gc.collect()
            torch.cuda.empty_cache()
    for shape in dict.fromkeys(resnet_v2_conv3_shapes(RESNET_B)):
        assert shape in resnet_conv3_shapes(RESNET_B), shape
    return err


def v2_net(torch, dev, fused, seed=0):
    """ResNet-50 v2, NHWC, 1000 classes, weights from ``seed`` on ``dev``,
    its deferred input BatchNorm resolved."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v2
    net = resnet50_v2(classes=CLASSES, layout="NHWC", fused=fused)
    net.initialize(device=dev, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net(torch.zeros(1, IMAGE, IMAGE, 3, device=dev))
    return net


def v2_grad_spread(np, got, want):
    """``{name: (max|d| / max|want|, ||d|| / ||want||)}`` over the
    gradients of two ResNet v2 states, in float64."""
    out = {}
    for k, w in want["grads"].items():
        g = got["grads"][k]
        assert g.shape == w.shape and np.isfinite(g).all(), k
        d, w = g.astype(np.float64) - w, w.astype(np.float64)
        out[k] = (np.abs(d).max() / max(np.abs(w).max(), 1e-300),
                  np.linalg.norm(d) / max(np.linalg.norm(w), 1e-300))
    return out


def _spread_line(np, spread):
    """Median and worst of each ratio over every gradient but the stem
    BN's gamma, then the stem gamma's own."""
    rest = [v for k, v in spread.items() if k != V2_STEM + ".gamma"]
    worst = [max(rest, key=lambda v: v[i]) for i in (0, 1)]
    names = [next(k for k, v in spread.items() if v is w) for w in worst]
    return (f"max-relative median {np.median([v[0] for v in rest]):.3e}, "
            f"worst {worst[0][0]:.3e} ({names[0]}); norm-relative median "
            f"{np.median([v[1] for v in rest]):.3e}, worst {worst[1][1]:.3e} "
            f"({names[1]}); stem gamma {spread[V2_STEM + '.gamma'][0]:.3e} / "
            f"{spread[V2_STEM + '.gamma'][1]:.3e}")


def compare_v2_fused(torch, np, dev):
    """Phase 18 (b): one float32 training forward + backward of
    ``resnet50_v2(layout="NHWC", fused=True)`` at B=128 against the same
    net and weights with ``fused=False``, both on the card; beside it,
    how far the unfused path moves on its own: again on the same input,
    under a 1e-6 move of the input in float32 and in float64, and
    against float64; then each path timed.  Returns the fused
    path's launch counts over its timed steps."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.convert import (grads_to_numpy,
                                                   params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.examples.train_resnet_fused import (
        synthetic_batch)
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    xb, yb = synthetic_batch(RESNET_B, IMAGE, CLASSES)
    weights = params_to_numpy(v2_net(torch, dev, True))

    def state(fused, xs, float64=False):
        net = v2_net(torch, dev, fused)
        params_from_jax(weights, net)
        if not float64:
            out = resnet_state(torch, net, xs, yb, dev)
        else:       # kernel 6 takes no float64: PyTorch's loss
            net.cast("float64")
            y = torch.from_numpy(yb).to(dev).long()
            with autograd.record():
                loss = F.cross_entropy(net(torch.from_numpy(xs).to(
                    dev, torch.float64)), y, reduction="none")
            autograd.backward(loss)
            out = dict(grads={k: v for k, v in grads_to_numpy(net).items()
                              if "running" not in k})
        del net
        gc.collect()
        torch.cuda.empty_cache()
        return out

    moved = xb + np.float32(1e-6)
    unfused = state(False, xb)
    fused = state(True, xb)
    spread = {
        "fused against unfused": v2_grad_spread(np, fused, unfused),
        "unfused again, the same input": v2_grad_spread(
            np, state(False, xb), unfused),
        "unfused, input moved by 1e-6": v2_grad_spread(
            np, state(False, moved), unfused)}
    d64 = state(False, xb, float64=True)
    spread["float64 unfused, input moved by 1e-6"] = v2_grad_spread(
        np, state(False, moved, float64=True), d64)
    spread["unfused against float64"] = v2_grad_spread(np, unfused, d64)
    spread["fused against float64"] = v2_grad_spread(np, fused, d64)
    errs = resnet_errors(np, fused, unfused)
    loss_d = abs(float(fused["loss"].mean())
                 - float(unfused["loss"].mean())) / abs(
        float(unfused["loss"].mean()))
    print(f"ResNet-50 v2 float32 B={RESNET_B}, {len(unfused['grads'])} "
          f"gradients (float64: convolutions, products and elementwise in "
          f"float64; the BN layer takes its statistics in float32 in any "
          f"dtype):", flush=True)
    for name, sp in spread.items():
        print(f"  {name}: {_spread_line(np, sp)}", flush=True)
    gamma, beta = V2_STEM + ".gamma", V2_STEM + ".beta"
    ratio64 = np.abs(d64["grads"][gamma]).max() / np.abs(
        d64["grads"][beta]).max()
    print(f"  stem BN (float64): max|d gamma| / max|d beta| {ratio64:.3e}",
          flush=True)
    print(f"fused against unfused: loss {loss_d:.3e} (tol {V2_LOSS_TOL:g}); "
          f"logits {errs['logits'][0]:.3e}, running {errs['running'][0]:.3e} "
          f"({errs['running'][1]}) (tol {V2_FWD_TOL:g}); gradients: "
          f"{len(unfused['grads']) - 1} held to max-relative "
          f"{V2_GRAD_MAX_TOL:g} and norm-relative {V2_GRAD_NORM_TOL:g}, the "
          f"stem gamma to {V2_GRAD_MAX_TOL:g} of the stem beta's largest "
          f"gradient", flush=True)
    assert loss_d <= V2_LOSS_TOL, loss_d
    assert errs["logits"][0] <= V2_FWD_TOL, errs
    assert errs["running"][0] <= V2_FWD_TOL, errs
    for k, (r_max, r_norm) in spread["fused against unfused"].items():
        if k == gamma:
            d = np.abs(fused["grads"][k] - unfused["grads"][k]).max()
            assert d <= V2_GRAD_MAX_TOL * np.abs(
                unfused["grads"][beta]).max(), (k, d)
        else:
            assert r_max <= V2_GRAD_MAX_TOL and r_norm <= V2_GRAD_NORM_TOL, (
                k, r_max, r_norm)
    assert ratio64 <= 1e-2, ratio64     # the stem gamma's gradient cancels
    del fused, unfused, d64

    x, y = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)
    times, counts = {}, None
    for fused in (False, True):
        net = v2_net(torch, dev, fused)
        trainer = Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01, "momentum": 0.9})
        loss_fn = SoftmaxCrossEntropyLoss()

        def one():
            from incubator_mxnet_tpu_torch import autograd
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(RESNET_B)
            torch.cuda.synchronize()

        one()
        if fused:
            zero_launches()                             # path starts
        ms = []
        for _ in range(V2_TIMED):
            t0 = time.monotonic()
            one()
            ms.append((time.monotonic() - t0) * 1e3)
        if fused:
            launched = kernel_launches()                # path ends
            counts = {k: launched[_KERNEL_COUNTERS[k]]
                      for k in resnet_v2_step_launches()}
        times[fused] = ms
        del net, trainer
        gc.collect()
        torch.cuda.empty_cache()
    for k, n in resnet_v2_step_launches().items():
        assert counts[k] == n * V2_TIMED, (k, counts[k])
    for fused in (False, True):
        med = statistics.median(times[fused])
        print(f"ResNet-50 v2 float32 eager step (forward, backward, SGD), "
              f"B={RESNET_B}, {'fused' if fused else 'unfused'}: median "
              f"{med:.3f} ms ({RESNET_B / med * 1e3:.2f} img/s), all "
              f"{[round(v, 3) for v in times[fused]]} (host clock around a "
              f"synchronised step)", flush=True)
    print(f"fused float32 path launches over {V2_TIMED} steps: {counts}",
          flush=True)
    return counts


def v2_graph_step(torch, np, dev, smi):
    """Phase 18 (c): ``resnet50_v2`` in bfloat16 (``amp.convert_block``)
    as one ``FusedTrainStep`` (SGD lr 0.1, momentum 0.9, wd 1e-4) at
    B=128, replayed as a CUDA graph.  Returns the launch counts (the
    eager warm-up step and the capture) and the median step ms."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import amp, bench
    from incubator_mxnet_tpu_torch.fuse import (kernel_launches,
                                                make_fused_train_step)
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    net = v2_net(torch, dev, True)
    amp.init("bfloat16")
    amp.convert_block(net, "bfloat16")
    step = make_fused_train_step(net, SoftmaxCrossEntropyLoss(), "sgd",
                                 dict(bench.OPTIMIZER_PARAMS), device=dev)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(RESNET_B, IMAGE, IMAGE, 3).astype(
        np.float32)).to(dev, torch.bfloat16)
    y = torch.from_numpy(rng.randint(0, CLASSES, RESNET_B).astype(
        np.int32)).to(dev)
    want = {_KERNEL_COUNTERS[k]: n for k, n in
            resnet_v2_step_launches().items()}
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()                                     # path starts
    losses = [float(step(x, y)) for _ in range(V2_WARMUP)]
    ms = []
    for _ in range(V2_STEPS):
        t0 = time.perf_counter()
        loss = step(x, y)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    launched = kernel_launches()                        # path ends
    counts = {k: launched[_KERNEL_COUNTERS[k]]
              for k in resnet_v2_step_launches()}
    (captured,) = step.capture_launches.values()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"ResNet-50 v2 bfloat16 graph step, B={RESNET_B}: capture's "
          f"launches {captured}; losses {[round(v, 4) for v in losses]}",
          flush=True)
    assert captured == want, (captured, want)
    for k, v in counts.items():
        assert v == 2 * want[_KERNEL_COUNTERS[k]], (k, v)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    med = statistics.median(ms)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(x, y)
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    fams = device_families(prof, _RESNET_FAMILIES)
    busy = sum(fams.values())
    print(f"ResNet-50 v2 bfloat16 graph step: median {med:.3f} ms over "
          f"{V2_STEPS} replays ({RESNET_B / med * 1e3:.2f} img/s), min "
          f"{min(ms):.3f} ms, all {[round(v, 3) for v in ms]} (host clock "
          f"around a replay and a synchronise); peak device memory {peak} "
          f"bytes ({peak / 2**30:.2f} GiB); profiled replay: wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms, idle share "
          f"{1 - busy / wall:.3f}; by family (ms): "
          f"{({k: round(v, 4) for k, v in sorted(fams.items())})}; {smi}",
          flush=True)
    del step, net, x, y
    return counts, med


def zoo_weights(torch, net, seed=0):
    """Draw ``net``'s parameters from ``seed`` so that its activations
    keep their scale through its depth: conv and dense weights N(0,
    1/fan_in), gammas 1 + N(0, 0.1²), betas, biases and moving means
    N(0, 0.1²), moving variances U(0.5, 1.5)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in net.collect_params().items():
            if k.endswith("running_var"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            elif k.endswith("gamma"):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=g))
            elif k.endswith(("bias", "beta", "running_mean")):
                p.copy_(0.1 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(torch.randn(p.shape, generator=g)
                        / math.prod(p.shape[1:]) ** 0.5)


def zoo_on_card(torch, np, dev):
    """Phase 18 (d): one member of each family, float32 predict-mode
    logits at B=2 on the card against the same weights on the CPU."""
    from incubator_mxnet_tpu_torch.convert import (params_from_jax,
                                                   params_to_numpy)
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    for name, side in ZOO_CARD:
        x = torch.from_numpy(np.random.RandomState(0).rand(
            ZOO_CARD_B, 3, side, side).astype(np.float32))
        cpu = vision.get_model(name).initialize(device="cpu")
        with torch.no_grad():
            cpu(x[:1])
        zoo_weights(torch, cpu)
        t0 = time.monotonic()
        with torch.no_grad():
            want = cpu(x).numpy()
        cpu_s = time.monotonic() - t0
        card = vision.get_model(name).initialize(device=dev)
        params_from_jax(params_to_numpy(cpu), card)
        del cpu
        with torch.no_grad():
            got = card(x.to(dev)).cpu().numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        print(f"{name} at {side}x{side}, B={ZOO_CARD_B}, float32: card "
              f"against CPU max|d|/max|CPU| {err:.3e} (tol {ZOO_CARD_TOL:g}); "
              f"max|logit| {np.abs(want).max():.4g}; CPU forward "
              f"{cpu_s:.2f} s", flush=True)
        assert got.shape == want.shape and np.isfinite(got).all(), name
        assert err <= ZOO_CARD_TOL, (name, err)
        del card
        gc.collect()
        torch.cuda.empty_cache()


def score_zoo(torch, dev, smi):
    """Phase 18 (e): ``benchmark_score.score`` for the JAX script's eight
    default models in bfloat16 at batch 1 and 128 (Inception at
    3x299x299), eager and hybridized (one CUDA graph a model and batch,
    the script's default); ``inception_v3`` at 3x224x224 must raise."""
    from incubator_mxnet_tpu_torch.examples.benchmark_score import score
    out = {}
    for model in SCORE_MODELS:
        shape = (3, 299, 299) if model == "inception_v3" else (3, 224, 224)
        for bs in SCORE_BATCHES:
            for hyb in (False, True):
                out[(model, bs, hyb)] = score(model, bs, shape, "bfloat16",
                                              SCORE_STEPS, SCORE_WARMUP, dev,
                                              hybridize=hyb)
                gc.collect()
                torch.cuda.empty_cache()
            print(f"score {model:14s} bs={bs:4d} {shape}: eager "
                  f"{out[(model, bs, False)]:10.1f} img/s, hybridized "
                  f"{out[(model, bs, True)]:10.1f} img/s (bfloat16, "
                  f"{SCORE_STEPS} forwards, the read-back inside the "
                  "window)", flush=True)
    try:
        score("inception_v3", 1, (3, 224, 224), "bfloat16", 1, 0, dev)
    except ValueError as e:
        print(f"inception_v3 at (3, 224, 224) raises: {e}", flush=True)
    else:
        raise AssertionError("inception_v3 at 224x224 returned logits")
    print(f"scores on {smi}", flush=True)
    return out


def lstm_bf16_grads(torch, np, dev, x, y):
    """Phase 18 (f), first part: one forward + backward of the LSTM LM
    (dropout off) converted to bfloat16, against the float32 model on
    the same weights (the bf16 ones, widened) and the same window, both
    through cuDNN's RNN; each gradient held to LSTM_BF16_GRAD_TOL."""
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.models import LSTMLanguageModel
    models = []
    for _ in range(2):
        m = LSTMLanguageModel(LSTM_VOCAB, LSTM_UNITS, LSTM_UNITS,
                              LSTM_LAYERS, dropout=0.0)
        m.initialize(device=dev, generator=torch.Generator().manual_seed(0))
        models.append(m)
    amp.convert_block(models[0], "bfloat16")
    with torch.no_grad():
        for k, p in models[1].collect_params().items():
            p.copy_(models[0].collect_params()[k].float())
    grads = []
    for m in models:
        with autograd.record():
            out, _ = m(x, m.begin_state(LSTM_B, device=dev))
            loss = SoftmaxCrossEntropyLoss()(out.reshape(-1, LSTM_VOCAB),
                                             y.reshape(-1)).mean()
        autograd.backward(loss)
        grads.append({k: p.grad.float() for k, p in
                      m.collect_params().items()})
    line = []
    for k, want in grads[1].items():
        got = grads[0][k]
        assert torch.isfinite(got).all() and got.abs().max() > 0, k
        r_norm = ((got - want).norm() / want.norm()).item()
        r_max = ((got - want).abs().max() / want.abs().max()).item()
        line.append(f"{k} {r_norm:.3e} / {r_max:.3e}")
        assert r_norm <= LSTM_BF16_GRAD_TOL, (k, r_norm)
    print(f"bf16 LSTM LM, step-1 gradients (dropout off) against float32 on "
          f"the same weights, norm- / max-relative: {'; '.join(line)} (tol "
          f"norm {LSTM_BF16_GRAD_TOL:g})", flush=True)


def lstm_lm_bf16(torch, np, dev, smi):
    """Phase 18 (f): phase 13's LSTM LM converted to bfloat16 by
    ``amp.convert_block``, LSTM_BF16_STEPS steps of phase 13's loop (SGD
    lr 1.0, clip 0.25, the state carried); the RNN's route by the
    profiler's kernel names (cuDNN's bf16 cell kernels); the step-1
    gradients against float32; step 1's update bit for bit the bf16 SGD
    step; the loss finite and, read in float32, falling; one launch of
    each cross-entropy kernel a step.  Returns the path's launch
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import amp, autograd
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.utils import clip_global_norm
    from incubator_mxnet_tpu_torch.models import LSTMLanguageModel
    windows = [tuple(torch.from_numpy(a).to(dev) for a in w)
               for w in lstm_stream(np)]
    lstm_bf16_grads(torch, np, dev, *windows[0])
    gc.collect()
    torch.cuda.empty_cache()
    model = LSTMLanguageModel(LSTM_VOCAB, LSTM_UNITS, LSTM_UNITS,
                              LSTM_LAYERS, dropout=LSTM_DROPOUT)
    model.initialize(device=dev, generator=torch.Generator().manual_seed(0))
    model.drop.generator = torch.Generator(device=dev).manual_seed(1)
    amp.convert_block(model, "bfloat16")
    named = model.collect_params()
    params = list(named.values())
    assert model.rnn.params_flat.dtype == torch.bfloat16
    trainer = Trainer(params, "sgd", {"learning_rate": LSTM_LR,
                                      "momentum": 0.0})
    loss_fn = SoftmaxCrossEntropyLoss()

    def eval_loss(x, y):
        """The predict-mode loss of a window, the logits read in float32
        (the bf16 loss resolves 2^-5 at ln 10000)."""
        with autograd.predict_mode(), torch.no_grad():
            out = model(x, model.begin_state(LSTM_B, device=dev))[0]
            return loss_fn(out.float().reshape(-1, LSTM_VOCAB),
                           y.reshape(-1)).mean().item()

    def step(x, y, state, check=False):
        state = [s.detach() for s in state]
        with autograd.record():
            out, state = model(x, state)
            loss = loss_fn(out.reshape(-1, LSTM_VOCAB), y.reshape(-1)).mean()
        autograd.backward(loss)
        clip_global_norm([p.grad for p in params], LSTM_CLIP)
        if check:
            old = {k: p.detach().clone() for k, p in named.items()}
            want = {k: p.detach() - LSTM_LR * p.grad for k, p in
                    named.items()}
        trainer.step(1)
        if check:   # the weights the model runs took the bf16 SGD step
            line = []
            for k, p in model.collect_params().items():
                assert p.dtype == torch.bfloat16, k
                assert torch.equal(p.detach(), want[k]), k
                share = (p.detach() != old[k]).float().mean().item()
                line.append(f"{k} {share:.4f}")
            print(f"bf16 LSTM LM step 1: every parameter bit for bit "
                  f"w - lr*clipped grad in bf16; share of elements moved: "
                  f"{'; '.join(line)} (an update under half a bf16 ulp "
                  f"of its weight is lost to rounding)", flush=True)
        return loss, state

    before = eval_loss(*windows[0])
    state = model.begin_state(LSTM_B, device=dev)
    losses, ms = [], []
    torch.cuda.synchronize()
    zero_launches()                                     # path starts
    for i in range(LSTM_BF16_STEPS):
        t0 = time.monotonic()
        loss, state = step(*windows[i % len(windows)], state, check=i == 0)
        torch.cuda.synchronize()
        ms.append((time.monotonic() - t0) * 1e3)
        losses.append(loss.float().item())
    launched = kernel_launches()                        # path ends
    counts = {"softmax_xent_fwd": launched["softmax_xent.fwd_launches"],
              "softmax_xent_bwd": launched["softmax_xent.bwd_launches"]}
    after = eval_loss(*windows[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(*windows[0], state)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA}
    rnn = sorted(n for n in names if "elementWise" in n and (
        "LSTM" in n or "GENERIC" in n))
    print(f"bf16 LSTM LM: {LSTM_BF16_STEPS} steps, losses "
          f"{[round(v, 4) for v in losses]}; predict-mode loss of window 0 "
          f"read in float32: before {before:.6f}, after {after:.6f} "
          f"({after - before:+.6f}); route: cuDNN's RNN, its cell "
          f"kernels {[n[:60] for n in rnn]}; xent launches {counts}",
          flush=True)
    assert rnn and all("bfloat16" in n for n in rnn), rnn
    assert not any("lstm_cell" in n for n in names), names
    assert np.isfinite(losses).all(), losses
    assert abs(losses[0] - math.log(LSTM_VOCAB)) < 0.5, losses[0]
    assert after < before, (before, after)
    for k, v in counts.items():
        assert v == LSTM_BF16_STEPS, (k, v)
    med = statistics.median(ms[2:])
    print(f"bf16 LSTM LM step: median over steps 3-{LSTM_BF16_STEPS} "
          f"{med:.3f} ms ({LSTM_T * LSTM_B / med * 1e3:.0f} tokens/s), all "
          f"{[round(v, 3) for v in ms]} (host clock around a step ending in "
          f"a synchronise; step 1 holds the update check's copies); {smi}",
          flush=True)
    del model, trainer, windows
    return counts


def zoo_phase(torch, np, fb, dev, rate, smi):
    """Phase 18 → ``(path launch counts by tile, the kernels line's
    entries' times and errors)``."""
    t0 = time.monotonic()
    err = check_v2_kernels(torch, fb, dev, rate)
    times = {dt: time_fused_matmul_bn(torch, fb, dev, dt, rate,
                                      (RESNET_B * 7 * 7, 2048, 512),
                                      " (v2 stage-4 conv1, the widest "
                                      "prologue)")
             for dt in FMM_TOL}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 18 (a): {time.monotonic() - t0:.1f} s", flush=True)
    f32 = compare_v2_fused(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    bf16, _ = v2_graph_step(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    zoo_on_card(torch, np, dev)
    score_zoo(torch, dev, smi)
    lstm = lstm_lm_bf16(torch, np, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 18: {time.monotonic() - t0:.1f} s", flush=True)
    return dict(f32=f32, bf16=bf16, lstm=lstm, err=err, times=times)


def _photos():
    """The photo-sized JPEG fixtures' bytes, by file name."""
    names = sorted(f for f in os.listdir(IMG_FIXTURES)
                   if f.startswith("photo_") and f.endswith(".jpg"))
    out = {}
    for n in names:
        with open(os.path.join(IMG_FIXTURES, n), "rb") as f:
            out[n] = f.read()
    return out


def image_batch_case(torch, np, ib, rng, sizes, shape, resize, rand, dev):
    """``(src, table, source bytes the crops touch)`` of random images of
    ``sizes`` for an output of ``shape``, on ``dev``."""
    _, _, height, width = shape
    rows, chunks, off, touched = [], [], 0, 0
    for h, w in sizes:
        chunks.append(rng.randint(0, 256, h * w * 3).astype(np.uint8))
        rh, rw = ib.resized_size(h, w, height, width, resize)
        y0 = rng.randint(0, rh - height + 1) if rand else (rh - height) // 2
        x0 = rng.randint(0, rw - width + 1) if rand else (rw - width) // 2
        rows.append(ib.sample_row(off, h, w, rh, rw, y0, x0,
                                  rand and rng.randint(0, 2)))
        off += h * w * 3
        ys = np.float32(h - 1) / np.float32(rh - 1) if rh > 1 else 0
        xs = np.float32(w - 1) / np.float32(rw - 1) if rw > 1 else 0
        r0, r1 = int(np.float32(y0) * ys), int(np.float32(y0 + height - 1)
                                               * ys)
        c0, c1 = int(np.float32(x0) * xs), int(np.float32(x0 + width - 1)
                                               * xs)
        touched += (min(r1 + 1, h - 1) - r0 + 1) * \
            (min(c1 + 1, w - 1) - c0 + 1) * 3
    src = torch.from_numpy(np.concatenate(chunks)).to(dev)
    return src, torch.tensor(rows, device=dev), touched


def check_image_batch(torch, np, ib, dev, rate):
    """Phase 19 (a): image_batch against its plain version on the card,
    bit for bit, at the path's shape and the corner cases; its time
    beside the plain version's and the bound.  → (max |d|, times)."""
    rng = np.random.RandomState(19)
    photo = [(375, 500), (500, 375), (480, 640), (500, 333)]
    norm = (IMG_MEAN, IMG_STD, 1.0)
    cases = [
        ("B=128 into 3x224x224, the fixtures' sizes, short side 256, crops "
         "and mirrors", photo * (IMG_B // 4), (IMG_B, 3, 224, 224),
         IMG_RESIZE, True),
        ("upscaling sources smaller than the output", [(100, 150), (60, 60),
                                                       (223, 224), (17, 300)],
         (4, 3, 224, 224), IMG_RESIZE, True),
        ("resize=0 (straight to the output size)", photo, (4, 3, 224, 224),
         0, False),
        ("a source at the output size (bytes pass through)",
         [(224, 224)] * 3, (3, 3, 224, 224), 0, False),
        ("dh = 1", [(1, 300), (5, 400), (1, 224)], (3, 3, 1, 224), 0, False),
        ("C = 1", photo * 2, (8, 1, 224, 224), IMG_RESIZE, True),
    ]
    main = None
    for label, sizes, shape, resize, rand in cases:
        src, table, touched = image_batch_case(torch, np, ib, rng, sizes,
                                               shape, resize, rand, dev)
        want = ib.image_batch_reference(src, table, shape, *norm)
        got = ib.image_batch(src, table, shape, *norm)
        torch.cuda.synchronize()
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        print(f"(a) image_batch, {label}: bit for bit its plain version "
              f"{same}", flush=True)
        assert same, label
        if "pass through" in label:
            plain = src.view(3, 224, 224, 3).permute(0, 3, 1, 2).float()
            want_pt = (plain - torch.tensor(IMG_MEAN, device=dev)
                       .view(1, 3, 1, 1)) / torch.tensor(
                           IMG_STD, device=dev).view(1, 3, 1, 1)
            assert torch.equal(got, want_pt), "the bytes did not pass through"
        if main is None:
            main = (src, table, shape, touched)
    src, table, shape, touched = main
    out_bytes = math.prod(shape) * 4
    times = {"ms": time_ms(torch, lambda: ib.image_batch(src, table, shape,
                                                         *norm), [()],
                           iters=100, warmup=5),
             "plain_ms": time_ms(torch, lambda: ib.image_batch_reference(
                 src, table, shape, *norm), [()], iters=3, warmup=1)}
    out = report(f"(a) image_batch at {shape}, {touched} source bytes "
                 f"touched", times, out_bytes + touched, rate)
    out["library_ms"] = None
    return 0.0, out


def check_nvjpeg(torch, np, jd, dev, rate):
    """Phase 19 (b): nvJPEG + the colour kernel against PIL's pixels of
    the fixtures; a truncated JPEG and a PNG raise and the process lives
    on; decode time per image; the colour kernel against its plain
    version, timed.  → (colour kernel's max |d|, its times, ms an
    image)."""
    pixels = np.load(os.path.join(IMG_FIXTURES, "small_pixels.npz"))
    for name in ("small_444", "small_420", "small_grey"):
        with open(os.path.join(IMG_FIXTURES, name + ".jpg"), "rb") as f:
            got = jd.decode(f.read(), dev).cpu().numpy().astype(np.int32)
        d = np.abs(got - pixels[name].astype(np.int32))
        print(f"(b) nvJPEG {name} {got.shape} against PIL's pixels: mean "
              f"|d| {d.mean():.4f}, max {d.max()}, share differing "
              f"{(d > 0).mean():.4f} (tolerance mean {IMG_DECODE_MEAN}, max "
              f"{IMG_DECODE_MAX})", flush=True)
        assert d.mean() <= IMG_DECODE_MEAN and d.max() <= IMG_DECODE_MAX, name
    photos = _photos()
    first = next(iter(photos.values()))
    with open(os.path.join(IMG_FIXTURES, "small.png"), "rb") as f:
        png = f.read()
    for what, buf in (("a truncated JPEG", first[:len(first) // 2]),
                      ("a PNG", png)):
        try:
            jd.decode(buf, dev)
        except ValueError as e:
            print(f"(b) {what} raises: {e}", flush=True)
        else:
            raise AssertionError(f"{what} decoded on the card")
    again = jd.decode(first, dev)
    torch.cuda.synchronize()
    print(f"(b) the process lives on: decoded {tuple(again.shape)} after "
          "both", flush=True)
    ms = []
    for _ in range(4):
        for buf in photos.values():
            t0 = time.perf_counter()
            jd.decode(buf, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    print(f"(b) nvJPEG decode + colour kernel of the {len(photos)} photo "
          f"fixtures, host clock to the synchronised image: median "
          f"{statistics.median(ms):.3f} ms an image, min {min(ms):.3f}",
          flush=True)
    # the colour kernel at a 500x375 4:2:0 image's planes
    rng = np.random.RandomState(5)
    h, w = 375, 500
    ch, cw = jd._chroma_size(h, w, 2)
    argsets = []
    for _ in range(8):
        planes = [torch.tensor(rng.randint(0, 256, s).astype(np.uint8),
                               device=dev) for s in ((h, w), (ch, cw),
                                                     (ch, cw))]
        argsets.append(planes)
    err = 0
    for y, cb, cr in argsets[:2]:
        got = jd.ycc_rgb(y, cb, cr, 2)
        want = jd.ycc_rgb_reference(y, cb, cr, 2)
        err = max(err, int((got.int() - want.int()).abs().max()))
    print(f"(b) ycc_rgb (4:2:0, {h}x{w}) against its plain version: max |d| "
          f"{err}", flush=True)
    assert err == 0
    times = {"ms": time_ms(torch, lambda y, cb, cr: jd.ycc_rgb(y, cb, cr, 2),
                           argsets),
             "plain_ms": time_ms(torch, lambda y, cb, cr:
                                 jd.ycc_rgb_reference(y, cb, cr, 2), argsets,
                                 iters=20, warmup=2)}
    out = report(f"(b) ycc_rgb at {h}x{w} 4:2:0", times,
                 h * w + 2 * ch * cw + 3 * h * w, rate)
    out["library_ms"] = None
    return float(err), out, statistics.median(ms)


def image_record_path(torch, np, dev, smi, tmp, bench_ms):
    """Phase 19 (c): the ImageNet-style path.  Returns its launch
    counts."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import bench, io, recordio
    from incubator_mxnet_tpu_torch.fuse import kernel_launches
    from incubator_mxnet_tpu_torch.ops import image_batch as ib
    from incubator_mxnet_tpu_torch.ops import jpeg_decode as jd
    photos = list(_photos().values())
    rec = os.path.join(tmp, "train.rec")
    writer = recordio.MXRecordIO(rec, "w")
    for i in range(IMG_RECORDS):
        writer.write(recordio.pack(recordio.IRHeader(0, float(i % CLASSES),
                                                     i, 0),
                                   photos[i % len(photos)]))
    writer.close()
    print(f"(c) wrote {IMG_RECORDS} JPEG records ({len(photos)} photo "
          f"fixtures, 333-640 px), {os.path.getsize(rec)} bytes", flush=True)
    kw = dict(data_shape=(3, 224, 224), batch_size=IMG_B, resize=IMG_RESIZE,
              rand_crop=True, rand_mirror=True, shuffle=True,
              mean_r=IMG_MEAN[0], mean_g=IMG_MEAN[1], mean_b=IMG_MEAN[2],
              std_r=IMG_STD[0], std_g=IMG_STD[1], std_b=IMG_STD[2], seed=0,
              device=dev)
    nb = IMG_RECORDS // IMG_B
    sync = io.ImageRecordIter(rec, prefetch_buffer=0, **kw)
    ahead = io.ImageRecordIter(rec, prefetch_buffer=4, **kw)
    n = 0
    for a, b in zip(sync, ahead):
        assert torch.equal(a.data[0], b.data[0]), n
        assert torch.equal(a.label[0], b.label[0]) and a.pad == b.pad == 0
        assert a.data[0].shape == (IMG_B, 3, 224, 224)
        assert bool(torch.isfinite(a.data[0]).all())
        n += 1
    assert n == nb, n
    print(f"(c) prefetch_buffer 0 against 4, seed 0: {n} batches bit for "
          "bit", flush=True)
    del sync, ahead
    step, _, _ = bench.build(IMG_B, "bfloat16", dev)
    want = {_KERNEL_COUNTERS[k]: n for k, n in resnet_step_launches().items()}
    gc.collect()
    torch.cuda.synchronize()
    zero_launches()                                     # path starts
    jd.decodes = 0
    it = io.ImageRecordIter(rec, prefetch_buffer=4, **kw)
    t0 = time.monotonic()
    batches = 0
    for epoch in range(2):
        for batch in it:
            batches += 1
        it.reset()
    torch.cuda.synchronize()
    alone = time.monotonic() - t0
    print(f"(c) the iterator alone: 2 epochs, {batches} batches in "
          f"{alone:.3f} s, {batches * IMG_B / alone:.1f} img/s; image_batch "
          f"launches {ib.launches}, nvJPEG decodes {jd.decodes}, ycc_rgb "
          f"launches {jd.ycc_launches}", flush=True)
    assert batches == 2 * nb and ib.launches == batches
    assert jd.decodes == jd.ycc_launches == IMG_B * batches
    losses, step_ms, waits, walls = [], [], [], []
    t0 = time.monotonic()
    for s in range(IMG_FED_STEPS):
        t1 = time.monotonic()
        batch = next(it)
        waits.append(time.monotonic() - t1)
        x = batch.data[0].to(torch.bfloat16).permute(0, 2, 3, 1) \
            .contiguous()
        y = batch.label[0].to(torch.int32)
        t1 = time.monotonic()
        losses.append(float(step(x, y)))
        step_ms.append((time.monotonic() - t1) * 1e3)
        walls.append(waits[-1] + step_ms[-1] / 1e3)
    torch.cuda.synchronize()
    fed = time.monotonic() - t0
    try:
        next(it)
        raise AssertionError("the epoch did not end")
    except StopIteration:
        pass
    launched = kernel_launches()                        # path ends
    counts = {k: launched[_KERNEL_COUNTERS[k]]
              for k in resnet_step_launches()}
    counts["image_batch"] = ib.launches
    counts["decodes"] = jd.decodes
    counts["ycc_rgb"] = jd.ycc_launches
    assert ib.launches == batches + IMG_FED_STEPS, ib.launches
    assert jd.decodes == IMG_B * ib.launches
    for k in resnet_step_launches():
        assert counts[k] == 2 * want[_KERNEL_COUNTERS[k]], (k, counts[k])
    print(f"(c) {IMG_FED_STEPS} steps of the bf16 FusedTrainStep fed by the "
          f"iterator, losses {[round(v, 4) for v in losses]}", flush=True)
    assert np.isfinite(losses).all(), losses
    med = statistics.median(step_ms[2:])
    steady = (IMG_FED_STEPS - 2) * IMG_B / sum(walls[2:])
    print(f"(c) fed training: {steady:.1f} img/s over steps 3-"
          f"{IMG_FED_STEPS} (wait + step), {IMG_FED_STEPS * IMG_B / fed:.1f} "
          f"img/s over all {IMG_FED_STEPS} with the first step's capture "
          f"({fed:.3f} s); step (host clock around the step's call, "
          f"which reads its loss) median over steps 3-{IMG_FED_STEPS} "
          f"{med:.3f} ms against phase 8 (b)'s replay {bench_ms:.3f} ms; wait "
          f"on the iterator {sum(waits):.3f} s in all, median "
          f"{statistics.median(waits) * 1e3:.3f} ms a batch, all "
          f"{[round(v * 1e3, 1) for v in waits]}; {smi}", flush=True)
    print(f"(c) path launches: {counts}", flush=True)
    it.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(2):
            batch = next(it)
            x = batch.data[0].to(torch.bfloat16).permute(0, 2, 3, 1) \
                .contiguous()
            step(x, batch.label[0].to(torch.int32))
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    fams = device_families(prof, _RESNET_FAMILIES + (
        ("image_batch", ("image_batch",)), ("ycc_rgb", ("ycc_rgb",)),
        ("nvjpeg", ("nvjpeg", "jpeg"))))
    busy = sum(fams.values())
    print(f"(c) two fed steps profiled: wall {wall:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall:.3f}; by family (ms): "
          f"{({k: round(v, 4) for k, v in sorted(fams.items())})}",
          flush=True)
    del it, step
    return counts


def vision_path(torch, np, dev, tmp):
    """Phase 19 (d): ImageFolderDataset over the fixtures on the card, the
    transforms card against CPU, then DataLoader into eager SGD steps of
    resnet18_v1."""
    import shutil
    from incubator_mxnet_tpu_torch import autograd
    from incubator_mxnet_tpu_torch.gluon import Trainer, data
    from incubator_mxnet_tpu_torch.gluon.data.vision import (
        ImageFolderDataset, transforms as T)
    from incubator_mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    root = os.path.join(tmp, "folder")
    names = sorted(_photos())
    for k in range(4):
        os.makedirs(os.path.join(root, f"class{k}"))
        for i, n in enumerate(names):
            shutil.copy(os.path.join(IMG_FIXTURES, n),
                        os.path.join(root, f"class{k}", f"{i}_{n}"))
    ds = ImageFolderDataset(root, device=dev)

    def compose(seed):
        r = np.random.RandomState(seed)
        return T.Compose([T.RandomResizedCrop(224, rng=r),
                          T.RandomFlipLeftRight(rng=r), T.ToTensor(),
                          T.Normalize(VISION_MEAN, VISION_STD)])

    def augment(seed):
        r = np.random.RandomState(seed)
        return T.Compose([T.RandomResizedCrop(224, rng=r),
                          T.RandomFlipLeftRight(rng=r)])

    tail = T.Compose([T.ToTensor(), T.Normalize(VISION_MEAN, VISION_STD)])
    level = 1 / 255 / min(VISION_STD)
    worst, tail_worst, ties, total = 0.0, 0.0, 0, 0
    for i in range(len(names)):
        img, _ = ds[i]
        assert img.device == dev and img.dtype == torch.uint8
        card, cpu = augment(i)(img), augment(i)(img.cpu())
        before = augment(i)(img.cpu().float())    # the same draws, uncast
        d = (card.cpu().int() - cpu.int()).abs()
        differ = d > 0
        near = (before - before.round()).abs() <= VISION_TIE
        assert int(d.max()) <= 1 and bool(near[differ].all()), i
        ties, total = ties + int(differ.sum()), total + d.numel()
        tail_worst = max(tail_worst, float(
            (tail(card).cpu() - tail(card.cpu())).abs().max()))
        worst = max(worst, float((compose(i)(img).cpu()
                                  - compose(i)(img.cpu())).abs().max()))
    print(f"(d) transforms card against CPU over {len(names)} decoded "
          f"fixtures, the same draws: the uint8 crop-resize-flip differs in "
          f"{ties} of {total} values ({ties / total:.4f}), each by one "
          f"level where the uncast value lies within {VISION_TIE} of an "
          f"integer (the truncating cast of a flat region's exact "
          f"integer, summed in another order); ToTensor + Normalize on the "
          f"same uint8 max |d| {tail_worst:.3e}; the whole Compose max |d| "
          f"{worst:.3e} (one level through Normalize {level:.3e})",
          flush=True)
    assert tail_worst <= 1e-6 and worst <= level + 1e-6
    loader = data.DataLoader(ds.transform_first(compose(0)),
                             batch_size=VISION_B, shuffle=True,
                             last_batch="discard")
    net = get_model("resnet18_v1", classes=4)
    net.initialize(device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 0.01, "momentum": 0.9})
    loss_fn = SoftmaxCrossEntropyLoss()
    losses, t0 = [], time.monotonic()
    while len(losses) < VISION_STEPS:
        for x, y in loader:
            y = y.to(dev)
            with autograd.record():
                loss = loss_fn(net(x), y)
            autograd.backward(loss)
            trainer.step(x.shape[0])
            losses.append(float(loss.detach().mean()))
            if len(losses) == VISION_STEPS:
                break
    torch.cuda.synchronize()
    print(f"(d) {VISION_STEPS} eager float32 SGD steps of resnet18_v1 at "
          f"B={VISION_B} from the DataLoader, losses "
          f"{[round(v, 4) for v in losses]}, {time.monotonic() - t0:.2f} s",
          flush=True)
    assert np.isfinite(losses).all(), losses


def detection_path(torch, np, dev):
    """Phase 19 (e): ImageDetIter with the detection augmenters over phase
    14's scenes into Adam steps of phase 14's SSD."""
    from incubator_mxnet_tpu_torch import image, random
    from incubator_mxnet_tpu_torch.gluon import Trainer
    from incubator_mxnet_tpu_torch.models import SSDLoss, ssd_300
    x, labels = ssd_scenes(np, 2 * DET_B, 3)
    items = [((x[b].transpose(1, 2, 0) * 255).astype(np.uint8),
              labels[b][labels[b, :, 0] >= 0]) for b in range(len(x))]
    rng = np.random.RandomState(0)
    augs = image.CreateDetAugmenter((3, SSD_IMAGE, SSD_IMAGE), rand_crop=0.5,
                                    rand_mirror=True, mean=(0.0, 0.0, 0.0),
                                    std=(255.0, 255.0, 255.0), rng=rng)
    it = image.ImageDetIter(DET_B, (3, SSD_IMAGE, SSD_IMAGE), items, augs,
                            shuffle=True, label_shape=(SSD_M, 5), device=dev,
                            rng=rng)
    random.seed(0)
    net = ssd_300()
    net.initialize(device=dev)
    trainer = Trainer(net.collect_params(), "adam", {"learning_rate": SSD_LR})
    lossfn = SSDLoss()
    losses = []
    while len(losses) < DET_STEPS:
        for batch in it:
            data, lab = batch.data[0], batch.label[0]
            assert data.shape == (DET_B, 3, SSD_IMAGE, SSD_IMAGE)
            assert lab.shape == (DET_B, SSD_M, 5) and lab.device == dev
            real = lab[..., 0] >= 0
            assert bool(real.any(1).all())
            assert bool((lab[~real] == -1).all()), "a label row not padded"
            loss, *_ = ssd_step(torch, net, trainer, lossfn, data, lab)
            trainer.step(DET_B)
            losses.append(float(loss.detach().mean()))
            if len(losses) == DET_STEPS:
                break
        it.reset()
    torch.cuda.synchronize()
    print(f"(e) ImageDetIter (crop 0.5, mirror, pad rows to {SSD_M}) into "
          f"{DET_STEPS} Adam steps of ssd_300() at B={DET_B}, 300x300: "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    assert np.isfinite(losses).all(), losses


def image_phase(torch, np, dev, rate, smi, bench_ms):
    """Phase 19 → ``(path launch counts, image_batch's (err, times),
    ycc_rgb's (err, times), ms an nvJPEG decode)``."""
    from incubator_mxnet_tpu_torch.ops import image_batch as ib
    from incubator_mxnet_tpu_torch.ops import jpeg_decode as jd
    t0 = time.monotonic()
    batch = check_image_batch(torch, np, ib, dev, rate)
    gc.collect()
    torch.cuda.empty_cache()
    ycc_err, ycc_times, decode_ms = check_nvjpeg(torch, np, jd, dev, rate)
    with tempfile.TemporaryDirectory() as tmp:
        counts = image_record_path(torch, np, dev, smi, tmp, bench_ms)
        gc.collect()
        torch.cuda.empty_cache()
        vision_path(torch, np, dev, tmp)
    gc.collect()
    torch.cuda.empty_cache()
    detection_path(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 19: {time.monotonic() - t0:.1f} s", flush=True)
    return counts, batch, (ycc_err, ycc_times), decode_ms


def _codes(torch, g, shape, dev):
    return torch.randint(-127, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


def _max_abs(torch, got, want):
    """max |got - want|, exact for integers (in int64) and floats (in
    float64)."""
    wide = torch.float64 if got.is_floating_point() else torch.int64
    return (got.to(wide) - want.to(wide)).abs().max().item()


def int8_conv_check(torch, k8, dev, rate, g):
    """Phase 21 (a), the int8 convolution: bit for bit its plain version
    at ResNet-50's five shapes and the head Dense, each timed beside its
    bound, the plain version and cuDNN (bf16; float32 printed) or
    ``torch._int_mm`` (the head).  → (max |d| over every shape,
    INT8_REP's times)."""
    import torch.nn.functional as F
    out, err = {}, 0
    for label, (n, c, h, w, co, k, st, pad) in INT8_CONV_SHAPES:
        # the codes channels-last, as the path's quantize writes them
        x = _codes(torch, g, (n, c, h, w), dev).contiguous(
            memory_format=torch.channels_last)
        wt = _codes(torch, g, (co, c, k, k), dev).contiguous(
            memory_format=torch.channels_last)
        got = k8.int8_conv(x, wt, None, st, pad)
        want = k8.int8_conv_reference(x, wt, None, st, pad)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        err = max(err, _max_abs(torch, got, want))
        print(f"(a) int8_conv {label} {(n, c, h, w)} x {(co, c, k, k)} "
              f"stride {st} pad {pad} -> {tuple(got.shape)}: bit for bit "
              f"its plain version {same}", flush=True)
        assert same, label
        m = got.numel() // co
        ops, nbytes = 2 * m * c * k * k * co, x.numel() + wt.numel() + \
            got.numel() * 4
        xb, wb = x.to(torch.bfloat16), wt.to(torch.bfloat16).contiguous()
        xf, wf = x.float(), wt.float().contiguous()
        times = {
            "ms": time_ms(torch, lambda: k8.int8_conv(x, wt, None, st, pad),
                          [()], iters=100, warmup=10),
            "plain_ms": time_ms(torch, lambda: k8.int8_conv_reference(
                x, wt, None, st, pad), [()], iters=5, warmup=1),
            "library_ms": time_ms(torch, lambda: F.conv2d(xb, wb, None, st,
                                                          pad),
                                  [()], iters=100, warmup=10)}
        f32 = time_ms(torch, lambda: F.conv2d(xf, wf, None, st, pad), [()],
                      iters=50, warmup=5)
        xn = x.contiguous()
        nchw = time_ms(torch, lambda: k8.int8_conv(xn, wt, None, st, pad),
                       [()], iters=100, warmup=10)
        out[label] = report(f"(a) int8_conv {label} (library: cuDNN bf16)",
                            times, nbytes, rate, ops, INT8_PEAK)
        print(f"  cuDNN float32 (TF32 off) at the same shape: device "
              f"{f32[0]} stream {f32[1]:.6f} ms; int8 at "
              f"{ops / out[label]['ms'] / 1e9:.1f} TOP/s; from NCHW codes "
              f"(the wrapper's channels-last copy first): device {nchw[0]} "
              f"stream {nchw[1]:.6f} ms", flush=True)
        del x, xn, wt, got, want, xb, wb, xf, wf
        torch.cuda.empty_cache()
    mh, kh, nh = INT8_HEAD
    x, wt = _codes(torch, g, (mh, kh), dev), _codes(torch, g, (nh, kh), dev)
    xc, wc = x.reshape(mh, kh, 1, 1), wt.reshape(nh, kh, 1, 1)
    got = k8.int8_conv(xc, wc).reshape(mh, nh)
    lib = torch._int_mm(x, wt.t())
    torch.cuda.synchronize()
    want = k8.int8_conv_reference(xc, wc).reshape(mh, nh)
    same = torch.equal(got, want)
    err = max(err, _max_abs(torch, got, want))
    print(f"(a) int8_conv as the head Dense {INT8_HEAD}: bit for bit its "
          f"plain version {same}, equal to torch._int_mm "
          f"{torch.equal(got, lib)}", flush=True)
    assert same and torch.equal(got, lib)
    times = {"ms": time_ms(torch, lambda: k8.int8_conv(xc, wc), [()]),
             "plain_ms": time_ms(torch, lambda: k8.int8_conv_reference(
                 xc, wc), [()], iters=20, warmup=2),
             "library_ms": time_ms(torch, lambda: torch._int_mm(x, wt.t()),
                                   [()])}
    report("(a) int8_conv, the head Dense (library: torch._int_mm)", times,
           x.numel() + wt.numel() + got.numel() * 4, rate,
           2 * mh * kh * nh, INT8_PEAK)
    return err, out[INT8_REP]


def quantize_check(torch, k8, dev, rate, g):
    """Phase 21 (a), quantize and dequantize: bit for bit their plain
    versions at a stage-1 activation (with a range and without one, in
    both layouts; from int32 sums and from int8 codes), timed beside the
    bound, the plain version and the torch expression.  → ((quantize's
    max |d|, its times with a range, channels-last), (dequantize's max
    |d|, its times from int32))."""
    x = (torch.randn(INT8_ACT, generator=g) * 3).to(dev)
    n = x.numel()
    acc = torch.randint(-2 ** 30, 2 ** 30, INT8_ACT, generator=g,
                        dtype=torch.int32).to(dev)
    q_err = d_err = 0
    for rng in ((-3.3333, 5.123), (None, None)):
        q, lo, hi = k8.quantize_int8(x, *rng)
        want = k8.quantize_int8_reference(x, *rng)[0]
        cl = k8.quantize_int8(x, *rng, channels_last=True)[0]
        torch.cuda.synchronize()
        same = torch.equal(q, want) and torch.equal(cl, want)
        q_err = max(q_err, _max_abs(torch, q, want),
                    _max_abs(torch, cl, want))
        print(f"(a) quantize_int8 {INT8_ACT}, range {rng}, and channels-"
              f"last: bit for bit its plain version {same}; range "
              f"({float(lo)}, {float(hi)})", flush=True)
        assert same, rng
        for codes in (acc, q):
            got = k8.dequantize(codes, lo, hi)
            want = k8.dequantize_reference(codes, lo, hi)
            same = torch.equal(got, want)
            d_err = max(d_err, _max_abs(torch, got, want))
            print(f"(a) dequantize {codes.dtype}: bit for bit its plain "
                  f"version {same}", flush=True)
            assert same
    scale = torch.full((), float(k8.range_scale(-3.3333, 5.123, 127.0)),
                       device=dev)
    out = {}
    for label, fn, plain, lib, nbytes in (
            ("quantize_int8, a range, channels-last (the conv layers' "
             "call)", lambda: k8.quantize_int8(
                 x, -3.3333, 5.123, channels_last=True),
             lambda: k8.quantize_int8_reference(
                 x, -3.3333, 5.123, channels_last=True),
             lambda: torch.round(x / scale).clamp_(-127, 127).to(
                 torch.int8).contiguous(memory_format=torch.channels_last),
             5 * n),
            ("quantize_int8, a range", lambda: k8.quantize_int8(
                x, -3.3333, 5.123), lambda: k8.quantize_int8_reference(
                x, -3.3333, 5.123), lambda: torch.round(x / scale).clamp_(
                -127, 127).to(torch.int8), 5 * n),
            ("quantize_int8, no range", lambda: k8.quantize_int8(x),
             lambda: k8.quantize_int8_reference(x), None, 5 * n),
            ("dequantize from int32", lambda: k8.dequantize(acc, -3.0, 3.0),
             lambda: k8.dequantize_reference(acc, -3.0, 3.0),
             lambda: acc.float() * scale, 8 * n),
            ("dequantize from int8", lambda: k8.dequantize(q, -3.0, 3.0),
             lambda: k8.dequantize_reference(q, -3.0, 3.0),
             lambda: q.float() * scale, 5 * n)):
        times = {"ms": time_ms(torch, fn, [()], iters=100, warmup=10),
                 "plain_ms": time_ms(torch, plain, [()], iters=20,
                                     warmup=2)}
        if lib is not None:
            times["library_ms"] = time_ms(torch, lib, [()], iters=100,
                                          warmup=10)
        out[label] = report(f"(a) {label} at {INT8_ACT} (library: the torch "
                            "expression)", times, nbytes, rate)
        out[label].setdefault("library_ms", None)
    return ((q_err, out["quantize_int8, a range, channels-last (the conv "
                        "layers' call)"]),
            (d_err, out["dequantize from int32"]))


def host_ms(torch, fn, calls=HYB_CALLS):
    """``(host ms to enqueue a call, wall ms a call)`` over ``calls`` calls
    after one more, the wall time ending in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return enqueue, (time.perf_counter() - t0) / calls * 1e3


def hybridize_check(torch, np, dev):
    """Phase 21 (b): float32 resnet50_v1 hybridized against eager at B=1
    and 32: the first call (warm-up and capture) and the replays bit for
    bit the eager forward, one capture a batch, a held result unchanged
    by the next call; the host ms of a call eager against replay."""
    from incubator_mxnet_tpu_torch import random as mx_random
    from incubator_mxnet_tpu_torch.gluon.model_zoo import vision
    mx_random.seed(0)
    net = vision.resnet50_v1()
    net.initialize(device=dev)
    for b in HYB_BATCHES:
        x = torch.tensor(np.random.RandomState(b).rand(b, 3, IMAGE, IMAGE)
                         .astype(np.float32), device=dev)
        with torch.no_grad():
            net.hybridize(active=False)
            eager = net(x)
            net.hybridize()
            first, replay = net(x), net(x)
            held = replay.clone()
            net(x * 0.5)
            op = net._cached_op
            same = [torch.equal(first, eager), torch.equal(replay, eager),
                    torch.equal(replay, held)]
            print(f"(b) hybridized resnet50_v1 float32 B={b}: first call, "
                  f"replay bit for bit eager {same[:2]}; a held result "
                  f"unchanged after the next call {same[2]}; captures "
                  f"{op.captures}, replays {op.replays}, cache "
                  f"{op.stats()}", flush=True)
            assert all(same) and op.captures == 1 and op.replays == 2
            net.hybridize(active=False)
            eager_ms = host_ms(torch, lambda: net(x))
            net.hybridize()
            replay_ms = host_ms(torch, lambda: net(x))
        print(f"(b) B={b}: host ms to enqueue a call / wall ms a call "
              f"({HYB_CALLS} calls): eager {eager_ms[0]:.3f} / "
              f"{eager_ms[1]:.3f}, replay {replay_ms[0]:.3f} / "
              f"{replay_ms[1]:.3f}", flush=True)
    del net
    gc.collect()
    torch.cuda.empty_cache()


def img_s_spread(torch, qr, keep, lines):
    """The hybridized float and int8 nets' img/s over SPREAD_REPEATS
    interleaved windows of SPREAD_PASSES passes over the example's eval
    batches, by the example's own timer: each net's min, median and max,
    and the int8/float speedup's, printed beside the example's own."""
    from statistics import median
    batches = keep["eval"] * SPREAD_PASSES
    nets = {"float": keep["float"], "naive": keep["naive"],
            "entropy": keep["entropy"]}
    reads = {k: [] for k in nets}
    for _ in range(SPREAD_REPEATS):
        for k, net in nets.items():
            reads[k].append(qr.imgs_per_sec(net, batches))
    for k, v in reads.items():
        print(f"(c) {k} img/s over {SPREAD_REPEATS} windows of "
              f"{len(batches)} forwards: min {min(v)}, median {median(v)}, "
              f"max {max(v)} (all: {v})", flush=True)
    for r in lines:
        mode = r["calib_mode"]
        ratio = [i / f for i, f in zip(reads[mode], reads["float"])]
        print(f"(c) {mode} int8/float speedup, window by window: min "
              f"{min(ratio)}, median {median(ratio)}, max {max(ratio)}; "
              f"the example's own 4-forward window: {r['speedup']}",
              flush=True)


def example_int8(torch, np, dev, k8):
    """Phase 21 (c): examples/quantize_resnet50.py at its defaults (both
    modes, its two JSON lines), the launch counters set to 0 just before
    and read just after; then the launches of one eager forward of the
    naive net, the card's int8 logits against the same net on the CPU,
    one profiled replay of the float and the int8 net, and the
    ``--fuse-bn`` run in naive mode.  → the path's launches."""
    from incubator_mxnet_tpu_torch.examples import quantize_resnet50 as qr
    keep = {}
    zero_launches()
    t0 = time.monotonic()
    lines = qr.run(qr.parse_args([]), keep)
    path = {"int8_conv": k8.conv_launches,
            "quantize_int8": k8.quantize_launches,
            "dequantize": k8.dequantize_launches}
    print(f"(c) the example at its defaults: {time.monotonic() - t0:.1f} s; "
          f"launches on its path {path} (53 weight quantizations a "
          "conversion, then each net's first call: an eager warm-up and a "
          "capture; a replay passes no wrapper)", flush=True)
    assert [r["calib_mode"] for r in lines] == ["naive", "entropy"]
    for r in lines:
        assert r["platform"] == "gpu" and r["float_img_per_sec"] > 0 \
            and r["int8_img_per_sec"] > 0, r
    qnet, batches = keep["naive"], keep["eval"]
    img_s_spread(torch, qr, keep, lines)
    with torch.no_grad():
        for label, net in (("float32", keep["float"]), ("int8 naive", qnet)):
            profile_window(torch, f"{label} resnet50_v1, one replay at "
                           f"B={len(batches[0])}", lambda: (
                               net(batches[0]), torch.cuda.synchronize()),
                           _INT8_FAMILIES)
    qnet.hybridize(active=False)
    before = dict(path)
    with torch.no_grad():
        qnet(batches[0])
    torch.cuda.synchronize()
    per = {"int8_conv": k8.conv_launches - before["int8_conv"],
           "quantize_int8": k8.quantize_launches - before["quantize_int8"],
           "dequantize": k8.dequantize_launches - before["dequantize"]}
    print(f"(c) launches in one eager forward of the int8 resnet50_v1: "
          f"{per}", flush=True)
    assert set(per.values()) == {INT8_FORWARD_LAUNCHES}, per
    t0 = time.monotonic()
    cpu = copy.deepcopy(qnet).to("cpu")
    got, want = [], []
    with torch.no_grad():
        for x in batches:
            got.append(qnet(x).cpu())
            want.append(cpu(x.cpu()))
    got, want = torch.cat(got), torch.cat(want)
    err = ((got - want).abs().max() / want.abs().max()).item()
    agree = (got.argmax(1) == want.argmax(1)).sum().item()
    print(f"(c) int8 logits, card against the same net on the CPU over "
          f"{len(got)} images ({time.monotonic() - t0:.1f} s): same top-1 "
          f"on {agree}, max|d|/max|CPU| {err:.3e} (tol {INT8_LOGIT_TOL:g}; "
          f"share of logits differing "
          f"{(got != want).float().mean().item():.4f})", flush=True)
    assert agree >= len(got) - INT8_TOP1_MISS and err <= INT8_LOGIT_TOL
    del keep, qnet, cpu
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fused = qr.run(qr.parse_args(["--fuse-bn", "--modes", "naive"]))
    print(f"(c) --fuse-bn: {time.monotonic() - t0:.1f} s", flush=True)
    assert all(r["int8_img_per_sec"] > 0 for r in fused)
    gc.collect()
    torch.cuda.empty_cache()
    return path


def int8_phase(torch, np, dev, rate):
    """Phase 21 → ``(the path's launches, {kernel: (max |d|, times)})``."""
    from incubator_mxnet_tpu_torch.ops import int8_conv as k8
    t0 = time.monotonic()
    g = torch.Generator().manual_seed(21)
    conv = int8_conv_check(torch, k8, dev, rate, g)
    quant, dequant = quantize_check(torch, k8, dev, rate, g)
    gc.collect()
    torch.cuda.empty_cache()
    hybridize_check(torch, np, dev)
    path = example_int8(torch, np, dev, k8)
    print(f"phase 21: {time.monotonic() - t0:.1f} s", flush=True)
    return path, {"int8_conv": conv, "quantize_int8": quant,
                  "dequantize": dequant}


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
    time_softmax_ssd(torch, sm, dev, rate)
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
    bench, bench_ms = bench_path(torch, np, dev, smi)
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

    phase("13 train the LSTM language model")
    lstm_err = check_cudnn_lstm(torch, dev)
    time_cudnn_lstm(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    lstm = train_lstm_lm(torch, np, dev, smi)
    tf = {k: v + lstm.get(k, 0) for k, v in tf.items()}
    for dtype in ("float32", "bfloat16"):   # softmax_xent_fwd_wide
        time_softmax_xent(torch, sx, dev, dtype, rate,
                          (LSTM_ROWS, LSTM_VOCAB))
    print(f"phase 13: cuDNN LSTM max|d| {lstm_err[0]:.3e}, worst gradient "
          f"ratio {lstm_err[1]:.3e}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase("14 train SSD and decode its detections")
    ssd_t0 = time.monotonic()
    compare_ssd_step(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    compare_detection_ops(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    ssd = train_ssd_300(torch, np, dev)
    tf = {k: v + ssd.get(k, 0) for k, v in tf.items()}
    gc.collect()
    torch.cuda.empty_cache()
    ssd_example(torch, np)
    print(f"phase 14: {time.monotonic() - ssd_t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase("15 the optimizer stack: 18 optimizers, LAMB BERT-base, resume")
    check_optimizers(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        lamb = lamb_bert(torch, np, dev, tmp)
    train = {k: v + lamb[k] for k, v in train.items()}
    gc.collect()
    torch.cuda.empty_cache()

    phase("16 the chunked training loop")
    chunk_t0 = time.monotonic()
    chunked_against_sequential(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    dropout_chunked(torch, np, dev)
    remat_compare(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        loop16 = loop_path(torch, np, dev, smi, tmp, bench_ms)
    for k in _MMA_INSTANCES:
        mma_launches[k] += loop16[k]
    for k in ("softmax_xent_fwd", "softmax_xent_bwd"):
        resnet[k] += loop16[k]
    gc.collect()
    torch.cuda.empty_cache()
    example_chunked(np)
    print(f"phase 16: {time.monotonic() - chunk_t0:.1f} s", flush=True)

    phase("17 the imperative training API")
    api_t0 = time.monotonic()
    check_second_derivatives(torch, dev)
    gradient_penalty(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    acc = accumulate_bert(torch, np, dev)
    train = {k: v + acc[k] for k, v in train.items()}
    gc.collect()
    torch.cuda.empty_cache()
    check_update_ops(torch, np, dev)
    multi_update_paths(torch, np, dev, smi)
    print(f"phase 17: {time.monotonic() - api_t0:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    phase("18 the vision model zoo")
    zoo = zoo_phase(torch, np, fb, dev, rate, smi)
    for k in ("fused_conv3_bn_fwd", "fused_conv3_bn_dx", "fused_conv3_bn_dw"):
        resnet[k] += zoo["f32"][k]
        mma_launches[k] += zoo["bf16"][k]
    for k in ("softmax_xent_fwd", "softmax_xent_bwd"):
        resnet[k] += zoo["f32"][k] + zoo["bf16"][k] + zoo["lstm"][k]

    phase("19 the image data path")
    img, (batch_err, batch_times), (ycc_err, ycc_times), decode_ms = \
        image_phase(torch, np, dev, rate, smi, bench_ms)
    for k in _MMA_INSTANCES:
        mma_launches[k] += img[k]
    for k in ("softmax_xent_fwd", "softmax_xent_bwd"):
        resnet[k] += img[k]

    phase("21 int8 quantization of ResNet-50")
    int8_path, int8_kernels = int8_phase(torch, np, dev, rate)
    gc.collect()
    torch.cuda.empty_cache()

    phase("20 kernels")
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
             cuda_kernels=["softmax_xent_fwd_wide", "softmax_xent_fwd_warp"],
             max_abs_err=xent_fwd_err, **xent_fwd_times),
        dict(name="softmax_xent_bwd", route="cuda",
             source=src + "softmax_xent.cu", replaces=pk + ":558",
             launches=train["softmax_xent_bwd"] + resnet["softmax_xent_bwd"]
             + tf["softmax_xent_bwd"],
             max_abs_err=xent_bwd_err, **xent_bwd_times),
        dict(name="softmax_fwd", route="cuda", source=src + "softmax.cu",
             replaces=pk + ":127", launches=tf["softmax_fwd"],
             cuda_kernels=["softmax_fwd_narrow", "softmax_fwd_warp",
                           "softmax_fwd_wide"],
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
    ] + [
        dict(name=f"fused_matmul_bn_{part}{tile}_v2", route="cuda",
             source=src + "fused_matmul_bn.cu", replaces=f"{fbk}:{line}",
             instance="ResNet-50 v2: a prologue on every call, K up to "
                      "2048; timed at (6272, 2048, 512)",
             launches=zoo[path][f"fused_matmul_bn_{part}"],
             max_abs_err=zoo["err"][part + tile.replace("_tf32", "")],
             **zoo["times"][dtype][i])
        for tile, path, dtype in (("_tf32", "f32", "float32"),
                                  ("_mma", "bf16", "bfloat16"))
        for i, (part, line) in enumerate(zip(("fwd", "dx", "dw"),
                                             (83, 154, 181)))
    ] + [
        dict(name="image_batch", route="cuda", source=src + "image_batch.cu",
             replaces="none: the native iterator's C++ ProcessSample, "
                      "src/image_iter.cc:334-435 (no Pallas kernel)",
             launches=img["image_batch"], nvjpeg_decodes=img["decodes"],
             nvjpeg_ms_per_image=decode_ms, max_abs_err=batch_err,
             **batch_times),
        dict(name="jpeg_ycc_rgb", route="cuda",
             source=src + "jpeg_decode.cu",
             replaces="none: libjpeg's chroma upsampling and colour "
                      "conversion in the native decode, "
                      "src/image_iter.cc:55-80 (no Pallas kernel)",
             launches=img["ycc_rgb"], max_abs_err=ycc_err, **ycc_times),
    ] + [
        dict(name=name, route="cuda", source=src + source,
             replaces="none: " + where + " (XLA ops, no Pallas kernel)",
             launches=int8_path[name], max_abs_err=int8_kernels[name][0],
             **int8_kernels[name][1])
        for name, source, where in (
            ("int8_conv", "int8_conv.cu",
             "incubator_mxnet_tpu/ops/quantization_ops.py:116-122 "
             "(conv_general_dilated to int32), :91-93 (dot_general); timed "
             f"at ResNet-50's {INT8_REP}, B=32"),
            ("quantize_int8", "quantize.cu",
             "incubator_mxnet_tpu/ops/quantization_ops.py:34-48; timed "
             f"channels-last at {INT8_ACT}, as the conv layers call it"),
            ("dequantize", "quantize.cu",
             "incubator_mxnet_tpu/ops/quantization_ops.py:51-61"))
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
