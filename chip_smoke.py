"""Drive the PyTorch/CUDA port's caption-serving paths once on one GPU.

    python3 chip_smoke.py              # from the repository root, one card
    python3 chip_smoke.py --profile    # instead: profile the 16x256 and
                                       # 1x256 decodes, sampling, fc7
                                       # extraction, a training and a
                                       # joint dispatch (torch.profiler)
    python3 chip_smoke.py --export     # instead: phases 1, 2 and 15 alone
    python3 chip_smoke.py --mesh       # instead: phases 1, 2 and 16 alone
    python3 chip_smoke.py --graphs     # instead: phases 1, 2, 17 and 18
                                       # alone
    python3 chip_smoke.py --examples   # instead: phases 1, 2 and 19 alone
    python3 chip_smoke.py --moe        # instead: phases 1, 2 and 20 alone
    python3 chip_smoke.py --lstm       # instead: phases 1, 2 and 3 alone

Phases, each printing its own lines; any failure raises and the script
exits nonzero.  Every search, encoder batch, sampling search, training
dispatch and evaluation, joint step and reloaded export program (phases
5, 6, 8-16) runs eagerly at its first call of a signature and, from the
second on, as one replay of a CUDA graph captured then
(``lrcn_tpu_torch/utils/graphs.py``; the mesh's training steps stay
eager); the launch counts they hold count a replay's launches once each,
and their timings warm each signature up twice:

1. card and software: ``nvidia-smi``'s name and power limit, torch and CUDA
   versions, ``require_cuda``;
2. build: the kernels compile from ``lrcn_tpu_torch/csrc/``;
3. fused LSTM step kernel against its plain version at the decode step's
   shapes (768 rows, X = H = 1000, both layers' weights) in bf16 and f32,
   bf16 at 3072, 12288 and 25600 rows (a 4-group burst, the 16x256 decode,
   best-of-100 sampling of 256 images), plus a ragged shape, with median
   CUDA-event times of the kernel, the plain version and ``torch.mm`` on
   a pre-concatenated [x, h] (the GEMM alone), and the kernel's device
   time (``queued_ms``: at 768 rows a wrapper call's host time is longer
   than the wgmma route's kernel); untimed, the row counts
   that leave the wgmma route's last row tile part-filled or alone
   (``PARTIAL_ROWS``, ``LONE_TILE_ROWS``) and the examples' widths;
   each case must take its route (bf16 aligned: wgmma, ragged: wmma, f32:
   fma), read from the per-route launch counters; the host time of one
   launch of the wgmma route (TMA descriptors encoded) and the wmma route,
   and of a wrapper call through the op ``lrcn::lstm_step`` against the
   op's CUDA implementation called directly;
4. top-k + log-sum-exp kernel: every route (block, warp, rounds) that
   takes the case's k against the plain version, values and indices
   exact, at (768, 8800) k=3, 9, 12, (256, 8800) k=1, (12288, 8800) k=3,
   a tie-heavy input, edge rows (-inf entries, an all--inf row, +-1e30,
   ties at the head and tail) at k=3 and 12, V=8801, a misaligned view,
   R=1 and 3, and k=V; the default route must be ``topk_lse_route``'s.
   At the timed shapes: each route's device time (torch.profiler kernel
   durations) in turns with v1 (or rounds above k=8), the wall time per
   wrapper call (CUDA events), host time per wrapper call (through the op
   ``lrcn::topk_lse``), per direct call of its CUDA implementation and per
   C launch,
   plain, ``torch.topk`` and the bound; the wrapper's host time by part;
5. service: a JAX-format checkpoint at the reference width (random weights
   from a seed, an 8800-word synthetic vocab) and a 2048-row feature store
   are written, loaded on the card and served, beam 3, max_words 20,
   decode_batch 256, from several request threads; the kernels' launch
   counts must match the searches run, every LSTM launch on the wgmma
   route and every top-k launch on ``topk_lse_route``'s route, and in f32
   (TF32 off) the kernel path's captions must agree with the plain path's;
6. throughput: one 16x256 beam-3 decode in bf16, its LSTM launches all on
   the wgmma route, its top-k launches on ``topk_lse_route``'s;
7. conv3x3 kernel against its plain version at the 9 distinct VGG-16 layer
   shapes at B=8 in bf16, 3 of them in f32, and a ragged 2x13x17x5->7
   shape with and without ReLU, with median CUDA-event times of the
   kernel, the plain version and cuDNN's own conv in the same dtype, and
   the 13-conv stack sums of the three; checked and not timed, one image
   at 56x56 and 14x14 and phase 16's shard of half an encoder batch (B=4)
   at every bf16 shape and the f32 ones; the 12 aligned bf16 convs must take
   the wgmma route, conv1_1 and the ragged shape the scalar route, f32 the
   fma route; the host time of one launch of the wgmma and scalar routes,
   and of a wrapper call through ``lrcn::conv3x3_relu`` against the
   CUDA implementation called directly;
8. image service: a JAX-format joint checkpoint (``cnn/`` and
   ``decoder/`` keys, ``average_image.npy``) with full-width random VGG-16
   weights is written, loaded on the card and served by image from
   several request threads; the conv kernel must launch 13 times per
   encoder batch (12 on the wgmma route, 1 on the scalar route) and the
   decoder kernels once per search step (top-k on ``topk_lse_route``'s
   route); in f32 (TF32 off) the kernel path's fc7 must agree with the
   plain path's, and the decoder's kernel path with its plain path on the
   same fc7 rows (end-to-end agreement printed);
9. fc7 throughput: ``normalize_and_fc7`` over 16x256 uint8 images in bf16,
   kernel path (its conv launches 12:1 wgmma to scalar), and the plain
   path over the first 4x256 of them;
10. training: ``Trainer.train_epoch`` at the reference width (B=256, L=20,
   lengths 10-20, K=8 steps a dispatch, a 10,000-row feature table on the
   card, dropout 0.4, bf16), ms per step and words/s over 5 dispatches
   after a warm-up one, peak memory, the step's bound, and no hand-written
   kernel launched; one narrow step (hidden 128) on the card against the
   same code on the CPU, f32 (TF32 off) and bf16, loss and every
   gradient; ``Trainer.fit`` on a learnable synthetic set (the loss falls
   below a fifth, the checkpoint loads and captions every image right
   through the kernels); a run interrupted after a mid-epoch save and
   resumed against the uninterrupted run;
11. sampling: best-of-100 over 256 images (25,600 rows), max_words 20,
   bf16, captions/s and the LSTM kernel's launches by route (42 a search,
   all wgmma); at f32, best-of-8 with the same injected Gumbel noise on
   the kernel and plain paths, captions held as in phase 5;
12. joint fine-tuning: ``JointTrainStep.multi_step`` at the reference
   width (full VGG-16 and the 2x1000 decoder, B=128, L=20, lengths 10-20,
   K=4, dropout 0.4, bf16, remat; ms per step, images/s, peak memory with
   and without remat, the step's bound, and no hand-written kernel
   launched); a narrow f32 joint step on the card against the CPU (loss
   and all 39 gradients); a step with the CNN frozen under the clip (the
   CNN bit-equal); ``JointTrainer.fit`` on 12 images of 3 colours (the
   loss below a fifth), an interrupted and resumed run (cuDNN
   deterministic), and the fine-tuned checkpoint served by image through
   the three kernels (13 conv launches an encoder batch, every caption
   right); whether the native image loader and BLEU core built, and native
   BLEU against Python BLEU;
13. the command line (``lrcn_tpu_torch.cli.main`` in this process, the
   default device: the card) at the reference width, on a learnable
   synthetic Flickr-style set (8,100 images in 64 classes, vocabulary
   8800): ``import-karpathy`` of a synthetic ``vgg_feats.mat``; ``train``
   (B=256, K=8, one epoch, no kernel launched, ms per step); ``generate``
   beam 3 over 1,000 held-out ids (the ids of the reference protocol; all
   LSTM launches on the wgmma route, all top-k on ``topk_lse_route``'s;
   captions/s over the command and over the search); ``generate`` at f32
   on the card against ``--device cpu`` (>= 99% equal lines);
   ``generate --sample 100``; ``eval``; ``train --joint`` at full VGG-16
   width, then ``extract-features`` and ``caption`` through its encoder
   (13 conv launches an encoder batch, routes from ``conv3x3_route``) with
   the host image decode replaced by synthetic arrays by id (no PIL or
   libjpeg on the card's machine; printed); ``serve`` through the HTTP
   front end (sequential id requests: p50 and p99 wall; ids, features and
   images against the service's own captions; /healthz, /stats, 404, 400,
   413).  Each command's launches go into ``launches_by_path``;
14. the C++ front end under load: phase 8's joint checkpoint and a
   2,048-row store (ids 0..2047) served by ``cli.make_caption_service``
   and ``serve.native_frontend`` at the CLI's serve defaults (decode batch
   64, beam 3, bf16), driven by the port's load generator (built with g++
   in phase 2's time): behind a device-side spin, an issue and a fetch
   must not wait for the stream; closed loops at 64 and 512 connections
   (requests/s, captions/s, p50/p90/p99, the client's CPU share, /stats
   mean batch, ``pending_hwm`` within ``max_inflight``, the pump's issue
   and issue-to-response medians), an open loop at half the
   512-connection rate, the feature leg, a spin under the 512-connection
   loop (the pump must fill ``max_inflight``), the device's idle share in a
   traced window (``utils.profiling``), ids, raw features and images by
   HTTP equal to the service's own calls, launches by route from the
   searches and encoder batches run, ``stop()``, and every served row
   through the kernels against the plain path at f32;
15. frozen export: ``lrcn_tpu_torch.cli.main(["export", ...])`` of phase
   5's checkpoint (beam and greedy, sample in bf16; beam in f32) and of
   phase 8's joint checkpoint (image, full VGG-16), ``--generate 20``, one
   process a directory, all at once (``chip_smoke.py --export-cli``), with
   the seconds to trace and save and the MB of each file; the directories
   reloaded in two fresh processes (``chip_smoke.py --reload-export``)
   that load nothing of ``lrcn_tpu_torch.models``, ``.decode`` or JAX;
   there, beam at 1, 256 and 16x256 rows through the one file, greedy at
   256, sample at 256 images with one seed twice, image at 8, f32 beam at
   256, and the bf16 directory on the CPU, each call's kernel launches by
   route (42 LSTM all wgmma and 21 top-k all block a search, 13 conv an
   image batch at ``conv3x3_route``'s routes); the artifacts' captions
   against the live path's on the same inputs (bf16: >= 99% equal, each
   differing one held by its score; sample: equal tokens under one seed;
   f32: >= 99% equal tokens), and the beam artifact's captions/s against
   the live path's at 1x256 and 16x256;
16. multi-device on the one card: ``CaptionService(mesh=)`` over a mesh
   that lists the card twice (phase 5's store and phase 8's joint
   checkpoint, decode batch 256: 384 LSTM rows a shard) answering ids,
   features and images at once, its launches 2 x (42 LSTM + 21 top-k) a
   search and 2 x 13 conv an encoder batch at the routing functions'
   routes; the sharded search bit-equal (tokens and scores, bf16 and f32)
   to one-device searches of each shard's rows, and its agreement with
   one search of all the rows printed; at f32 (w_out x 8) the mesh
   service's fc7 rows (before their L1 normalization) within FC7_RTOL of
   the one-device service's and its
   captions by id, by feature and by image equal to it; 1- and 2-shard
   captions/s (no scaling on one card); ``lrcn-torch serve --mesh 1`` over
   HTTP and ``--mesh 2`` refused with JAX's message; two gloo ranks on the
   card (``chip_smoke.py --mesh-rank``: ``ShardedTrainStep`` at (2, 1) and
   (1, 2), ``PipelinedTrainStep`` at (1, 2), ``JointTrainStep`` at (2, 1))
   against the one-process step, loss and every gradient; a one-rank NCCL
   ``Trainer(mesh=make_mesh((1, 1)))`` at the reference width beside
   phase 10's ms per step, its checkpoint restored in the one-device
   ``Trainer``; no training step launches a kernel;
17. one-program dispatch: at the reference width, bf16 and f32 (TF32
   off), each graphed entry point against its eager body on the kernel
   path, tokens and scores bit-equal, on inputs other than those it was
   captured with: beam 3 at 1x64, 4x64, 1x256 and 16x256 images, greedy
   and ``rows_search`` at 256, and raw and L1-normalized fc7 rows of
   ``vgg16_fc7`` / ``images_to_fc7`` at an encoder batch; each replay's
   launches (42 LSTM, 21 top-k a search, 13 conv an encoder batch); bf16
   eager against graphed at 1x64, 1x256 and 16x256 in turns (host wall,
   host enqueue and device time per call), each shape's first (eager) and
   capturing calls' seconds and the memory its capture kept reserved, and
   that memory freed with its module.  Phase 14 also holds that no graph is
   captured after the service's warm-up, phase 16 that each shard's
   stream replays graphs of its own, and the run that no graph of phases
   5-9 is alive when training starts;
18. one-program dispatch of sampling, training, the joint step and
   reloaded export programs, at the reference width, each graphed path
   called eagerly, captured and replayed on other inputs and held against
   an eager twin: four K=8 training dispatches (dropout 0.4, bf16;
   losses, parameters and the 19 optax leaves bit-equal) and the K-batch
   ``average_loss``; four best-of-100 searches of 256 images on one
   generator (tokens and scores bit-equal, the generators in one state);
   three K=4 joint dispatches under cuDNN's deterministic algorithms
   (losses equal, parameters within RESUME_RTOL) and ``eval_batch``; phase
   15's beam, image and sample artifacts (the sample one with two seeds
   in turn) against their programs' eager ``forward``; each replay's
   launches; for each path eager against graphed host wall, host enqueue
   and device ms, the first and capturing calls' seconds, the memory the
   capture kept and its return once its owner is dropped.  ``--graphs``
   exports the three artifacts itself;
19. the port's examples and the runbook chain, each as a user runs it, on
   the default device (the card): ``examples.synthetic_end_to_end.main``
   (train, generate and eval through ``lrcn_tpu_torch.cli.main``; its
   BLEU-4 >= 0.90 gate; BLEU-1..4 and each leg's seconds; no kernel in
   ``train``, the LSTM and top-k kernels in ``generate`` at the routing
   functions' routes; the trained checkpoint's f32 ``generate`` on the
   card against ``--device cpu``, >= 99% equal lines and the rest
   near-ties), ``examples.serving_quickstart.main`` (16 concurrent
   requests over HTTP, all answered; LSTM launches on the fma route,
   top-k on the block route at V=50; its service's 20 captions on the
   card equal to the CPU's at f32; no graph alive after ``close``) and
   tests/test_runbook.py's chain (a MatConvNet file of 8 channels a conv
   written with scipy, 32 images by id through ``synthetic_pixels``,
   ``extract-features --cnn``, ``train``, ``generate`` and ``eval`` at
   bf16; 13 conv launches an encoder batch at ``conv3x3_route``'s
   routes).  Phases 3, 4 and 7 hold the kernels at these paths' shapes
   (``EXAMPLE_LSTM`` at bf16, ``EXAMPLE_LSTM_F32`` at f32,
   ``EXAMPLE_VOCABS``, the runbook's convs);
20. the MoE text decoder's search (``models/moe_text.py``) at the
   Kimi-VL-A3B cell's geometry: the top-k kernel at its shape (3,072
   hypotheses over 163,840 words, k = 3) on its default route, its
   values and indices equal to ``topk_logsumexp_reference``'s and its
   log-sum-exp within ``LSE_ATOL``; the device time of both routes (in
   turns), the plain version's and ``torch.topk`` with
   ``torch.logsumexp``'s; then, with the launch counters zeroed, one
   replay of ``rows_search`` over 1,024 rows (1,000 real, the last
   repeated), beam 3, 30 words, by a decoder at the published widths and
   vocabulary cut to ``MOE_LAYERS`` layers (one dense, one expert layer):
   31 top-k launches a search, all on that route, and no LSTM or conv
   launch.

The line before the last is one JSON object describing each kernel, with
the time of the kernel, its plain version and a library call at the
main path's shape, the least time the card could take for that work
(``bound_ms``: bytes over 3.35 TB/s or operations over the peak rate of
their type, whichever is larger), and its launches on the main path, in
all, by route and by path; the last line is ``{"ok": true, "device":
{...}}``.  The script imports
nothing of JAX or PIL, and exits nonzero without printing a result when
no CUDA device is present.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")

# the reference width (bench.py's flagship geometry)
HIDDEN, EMBED, CNN_DIM, VOCAB = (1000, 1000), 1000, 4096, 8800
BEAM, MAX_WORDS, DECODE_BATCH = 3, 20, 256
ENCODE_BATCH = 8            # the service's default encoder batch
FC7_GROUPS, FC7_BATCH = 16, 256     # bench.py:97's fc7 geometry
FC7_PLAIN_GROUPS = 4        # phase 9's plain path: a quarter of it
SEED = 0
# the 9 distinct VGG-16 conv shapes (H = W, C, F) and how often each runs
VGG_CONVS = [(224, 3, 64, 1), (224, 64, 64, 1), (112, 64, 128, 1),
             (112, 128, 128, 1), (56, 128, 256, 1), (56, 256, 256, 2),
             (28, 256, 512, 1), (28, 512, 512, 2), (14, 512, 512, 3)]
F32_CONVS = {(224, 3, 64), (56, 256, 256), (14, 512, 512)}
CONV_BATCH = 8
REPORT_CONV = (56, 256, 256)    # the shape whose times the JSON line reports

# kernel vs plain tolerances on the card
#  lstm: the same operands (bf16-rounded or f32), f32 sums over X+H = 2000
#        terms in another order
LSTM_ATOL = 1e-4
#  rows of the paths that phase 3 does not time: those that leave the
#  wgmma route's last 128-row block part-filled, and phase 16's shard
#  (3 x decode_batch / 2 = 384 at 2 x 128 images)
PARTIAL_ROWS = (3, 192, 576, 1600, 384)
#  rows whose last 128-row tile holds one row: beside a full tile in one
#  cluster (129), or alone in its cluster, whose second tile lies past the
#  rows (12,289: 97 row tiles), checked and not timed
LONE_TILE_ROWS = (129, 12289)
#  topk: vals and idx exact; lse sums 8800 exps in another order
LSE_ATOL = 2e-5
# the top-k cases of phase 4 that are timed: the main path's shapes (beam
# search of 256 images, the 16x256 decode, greedy)
TOPK_TIMED = ("beam", "16x256 decode", "greedy")
#  f32 service check: >= 99% equal captions; a differing one is a near-tie
CAPTION_AGREEMENT, SCORE_ATOL = 0.99, 1e-3
#  conv, max |kernel - plain| relative to max |plain|:
#   bf16: the same bf16 operands, exact products, f32 sums in another
#         order, one rounding to bf16 -> one bf16 ulp at the largest
#         output, 2**-7;
#   f32: f32 sums over K <= 4608 terms in another order, and cuDNN may pick
#        a Winograd or FFT algorithm with its own rounding -> 1e-4
CONV_RTOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-4}
#  f32 fc7, kernel path vs plain path, relative to max |fc7|: the conv
#  tolerance through 13 layers and two matmuls
FC7_RTOL = 1e-4
#  bf16 fc7 (phase 9): both paths round at the same points, so they differ
#  where a sum in another order lands on the other side of a bf16 rounding
#  boundary, and that ulp propagates through 13 layers -> 3e-2
FC7_BF16_RTOL = 3e-2

# decoder training at the reference width (bench.py:133-148): B=256
# captions of L=20 padded words, lengths 10-20, K=8 steps a dispatch from a
# 10,000-row feature table on the card, dropout 0.4, bf16
TRAIN_BATCH, TRAIN_LEN, TRAIN_K, TRAIN_ROWS = 256, 20, 8, 10_000
TRAIN_DISPATCHES = 3        # timed, after two warm-up dispatches
TRAIN_DROPOUT = 0.4
#  one f32 step on the card (TF32 off) against the same code on the CPU, at
#  a narrow width: the loss within 1e-5 relative, every gradient within
#  1e-4 of its largest entry (f32 sums in another order)
NARROW = dict(hidden=(128, 128), embed=64, cnn_feature_dim=256,
              vocab_size=512)
NARROW_BATCH, NARROW_LEN = 32, 12
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
#  bf16: the card's backward rounds the cotangent to bf16 before each
#  product (ops/lstm.py), the CPU's multiplies it in f32: the gradients
#  read 5.5e-3 of the largest entry (w_out; the CPU emulating the card's
#  rounding gives the same) -> 2e-2; the loss within 1e-2 (reads 0)
TRAIN_BF16_GRAD_RTOL, TRAIN_BF16_LOSS_RTOL = 2e-2, 1e-2
#  the learnable set: its loss must fall below this share of its start
LEARN_SHARE = 0.2
#  an interrupted and resumed run against the uninterrupted one: the same
#  computation, so expected bit-equal; held to 1e-6 of the largest entry
RESUME_RTOL = 1e-6
# best-of-N sampling (the paper's "sample 100, T=2"): 256 images x 100
SAMPLE_IMAGES, SAMPLE_N, SAMPLE_T = 256, 100, 2.0
SAMPLE_F32_N = 8            # the f32 kernel-vs-plain check: 256 x 8 rows

# joint CNN+decoder fine-tuning at the reference width
# (benchmarks/bench_joint.py:26-34): full VGG-16 (He-normal from a seed,
# mean image 117) and the 2x1000 decoder, B=128 captions of L=20, lengths
# 10-20, K=4 steps a dispatch, dropout 0.4, bf16, VGG rematerialised
JOINT_BATCH, JOINT_LEN, JOINT_K = 128, 20, 4
JOINT_DISPATCHES = 2        # timed, after two warm-up dispatches
JOINT_MEAN = 117.0
VGG16_MACS = 15.47e9        # multiply-adds of one 224x224 VGG-16 forward
#  the narrow joint model (card vs CPU, freeze, the learnable set): VGG at
#  a quarter width (16-128 channels, 8 of 13 convs on the conv kernel's
#  wgmma route when served), fc width 64, decoder hidden 64
JOINT_NARROW = dict(hidden=(64, 64), embed=64, cnn_feature_dim=64)
JOINT_NARROW_VGG = dict(width_multiplier=0.25, fc_dim=64)
JOINT_NARROW_BATCH = 4
#  one f32 joint step on the card (TF32 off) against the CPU: the loss
#  within 1e-5 relative; every gradient within 1e-2 of its largest entry
#  (the CPU reads 3.9e-6 against JAX; on the card cuDNN's own algorithms
#  sum in another order, and a conv bias's gradient sums 200,704
#  positions of cotangents that cancel: conv1_1/b read 1.77e-3)
JOINT_LOSS_RTOL, JOINT_GRAD_RTOL = 1e-5, 1e-2
#  the learnable set: 12 images of 3 colours, each kind its caption.  At
#  the default CNN rate (lr / 10 = 1e-3) Adam reshapes the random VGG
#  until every image gives the same caption, in both packages (the loss
#  stalls at the image-blind 0.277, checked on the CPU); 1e-4 fine-tunes it
JOINT_EPOCHS, JOINT_CNN_LR = 40, 1e-4

# the command line (phase 13) at the reference width: a learnable
# Flickr-style set of 8,100 images in 64 classes (6,100 for training,
# 30,500 captions: over the reference's 30,000-caption small-dataset rule,
# so --batchsize 256 holds), 8-16 words a caption over VOCAB - 3 words;
# the f32 card-vs-CPU check runs 100 ids of a random checkpoint whose
# output projection is scaled by 8 (sharper logits: fewer tied beams)
CLI_IMAGES, CLI_CAPTION_LEN, CLI_TRAIN_BATCH = 8100, (8, 16), 256
CLI_CLASSES = 64
CLI_EVAL, CLI_F32_IDS, CLI_SAMPLE_IDS = 1000, 100, 16
CLI_F32_SHARPEN = 8.0       # near-ties held at SCORE_ATOL x this
CLI_JOINT_IMAGES, CLI_JOINT_BATCH = 64, 32
CLI_EXTRACT_IMAGES, CLI_EXTRACT_BATCH = 256, 64
CLI_SERVE_REQUESTS = 100
CLI_DEVICE_FLAGS: list = []     # none: the CLI's default device, the card

# the C++ front end under load (phase 14): the CLI's serve defaults (decode
# batch 64, 4 groups a burst: 192-768 LSTM rows), phase 8's joint
# checkpoint, a store of fc7 rows under ids 0..N-1 (loadgen asks for ids
# in [0, N)); closed loops at 64 and 512 connections, an open loop at half
# the 512-connection rate, the feature leg (4096 floats a row) and a
# traced window of the 512-connection loop
NATIVE_ROWS = 2048
NATIVE_CONNS, NATIVE_THREADS = (64, 512), 512 + 64
NATIVE_WARM_S, NATIVE_LOAD_S = 1.0, 3.0
NATIVE_FEAT_CONNS, NATIVE_FEAT_S = 16, 2.0
NATIVE_TRACE_S = 2.0
NATIVE_IDS, NATIVE_FEATURES, NATIVE_IMAGES = 64, 16, 8
#  the issue and fetch paths must not wait for the device: held against a
#  device-side spin of this long on the stream every thread shares
NATIVE_STALL_MS = 300.0

# frozen export (phase 15): ``lrcn-torch export`` of phase 5's checkpoint
# (beam and greedy, sample in bf16; beam in f32) and of phase 8's joint
# checkpoint (image), reloaded in two fresh processes (``--reload-export``,
# the parts below); the beam artifact runs 1, 256 and 16x256 rows through
# one file
SCRIPT = os.path.join(REPO, "chip_smoke.py")
EXPORT_WORK = os.path.join(WORK, "export")  # phase 15's; phase 18 reuses it
RELOAD_PARTS = {"beam": ("bf16",), "rest": ("sample", "f32", "image")}
EXPORT_ROWS = (1, DECODE_BATCH, 16 * DECODE_BATCH)
EXPORT_IMAGES = ENCODE_BATCH
EXPORT_SEED = 11            # the sample artifact's seed
EXPORT_ITERS = 3            # timed calls, after a warm-up one
EXPORT_CPU_ROWS = 4         # rows of the bf16 directory run on the CPU
#  a caption of an artifact that differs from the live path's is held by
#  its score, as phase 14 holds one: the plain path teacher-forced along it
#  gives the search's own score within this
EXPORT_SCORE_ATOL = 0.008

# multi-device on the one card (phase 16): a mesh that lists the card
# twice serves through two shards, each search and encoder batch split in
# two (decode batch 256: 128 images, 384 LSTM rows a shard); training runs
# as two gloo ranks on the card (``--mesh-rank``: NCCL refuses one GPU
# twice) at the narrow f32 widths, against the one-process step within
# MESH_TOL of each gradient's largest entry, and as a one-rank NCCL group
# at the reference width (phase 10's batches)
MESH_SHARDS = 2
MESH_IDS = 3 * DECODE_BATCH         # two id requests: 1 and 2 groups
MESH_FEATURES = 100
MESH_IMAGES = 2 * ENCODE_BATCH
MESH_F32_IDS = 2 * DECODE_BATCH
MESH_AGREE_ROWS = 4 * DECODE_BATCH  # the sharded-search agreement sample
MESH_BURST = 4 * DECODE_BATCH       # the timed search: a 4-group burst
MESH_RANKS = 2
MESH_RANK_TIMEOUT = 300.0
MESH_TRAIN_BATCH = 8
MESH_PP_NARROW = dict(NARROW, embed=NARROW["hidden"][0])
MESH_TOL = 1e-5
#  the joint step's conv gradients: a conv weight's gradient sums the
#  products of B x H x W positions, which cancel, and cuDNN's wgrad sums 2
#  images a rank in another order than 4 in one process (conv2_1/w read
#  1.77e-5 of its largest entry); the loss and the decoder's gradients
#  are held at MESH_TOL
MESH_CNN_TOL = 1e-4
RESULTS: dict = {}                  # figures a later phase prints beside

# one-program dispatch (phase 17): every search and encoder batch on the
# card is one CUDA graph replay; held bit-equal to the eager kernel path
# at these beam-3 (groups, images) shapes, greedy at 256 images, a table
# search of 256 ids and an encoder batch, in bf16 and f32; the searches
# timed eager against graphed at GRAPH_TIMED, each with the calls below
GRAPH_SHAPES = ((1, 64), (4, 64), (1, 256), (16, 256))
GRAPH_TIMED = ((1, 64), (1, 256), (16, 256))
GRAPH_CALLS = {64: 20, 256: 20, 4096: 6}
GRAPH_ROWS = 256
#  what the card may keep reserved once a module and its graphs are gone:
#  cuBLAS's workspace for a stream new to it (32 MiB on Hopper), twice
GRAPH_KEPT_MB = 64

# the port's examples and the runbook chain (phase 19): the end-to-end
# example and the serving quickstart (``lrcn_tpu_torch/examples/``) as a
# user runs them, and tests/test_runbook.py's chain (hidden 24, embed 16,
# a MatConvNet file of 8 channels a conv and fc 24, 32 images).  Phases
# 3, 4 and 7 hold the kernels at their shapes: the LSTM's layer-1 (X, H)
# (layer 2 takes X = 2 ceil(H / 2)) at each path's search rows (e2e: a
# 32-image batch x beam 2; quickstart: 1-4 groups of 8 x beam 3; runbook:
# 16 x beam 2; tests/test_real_captions.py's width: 64 x beam 3), the
# top-k's (V, rows) and the runbook's convs at its encoder batch
EXAMPLE_LSTM = {(24, 32): (64, 24, 48, 72, 96), (16, 24): (32,),
                (64, 96): (192,)}
# the quickstart's service and phase 19's f32 generate of the e2e
# checkpoint run (X, H) = (24, 32) at f32, the fma route: 1-4 groups of
# 8 x beam 3, and 24 ids x beam 2
EXAMPLE_LSTM_F32 = {(24, 32): (24, 48, 72, 96)}
EXAMPLE_VOCABS = ((22, 64), (25, 64), (50, 96), (13, 32))
RUNBOOK_WIDTH, RUNBOOK_FC, RUNBOOK_BATCH = 8, 24, 8
RUNBOOK_IMAGES = 32
RUNBOOK_WORDS = ["man", "dog", "park", "red", "ball", "runs", "sits", "big",
                 "small", "tree"]

# the MoE text decoder's search (phase 20): the Kimi-VL-A3B cell's geometry
# (``cli.decode_geometry(1000)``: one search of 256 x 4 rows, 1,000 real;
# beam 3, 30 words, 16 prompt ids) at the published widths and
# vocabulary, cut to one dense and one expert layer to fit the smoke
MOE_IMAGES, MOE_ROWS, MOE_BEAM, MOE_WORDS = 1000, 1024, 3, 30
MOE_LAYERS, MOE_PROMPT = 2, 16

# the H100 SXM's published peaks (dense), for bound_ms
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"bf16": 989e12, "f32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time (ms) for moving ``nbytes`` and doing ``ops`` of
    ``kind`` on the card, and which of the two bounds it."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_us(launch, n: int = 200) -> float:
    """Host microseconds per call of ``launch``, which enqueues a kernel:
    the wrapper-free cost of a C entry point, TMA encoding included."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        launch()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def route_delta(fn, before: dict) -> dict:
    """Launches by route since ``before`` (a copy of the counters)."""
    return {r: fn.launches_by_route[r] - before[r] for r in before
            if fn.launches_by_route[r] != before[r]}


def check_topk_routes(by_route: dict, launches: int, where: str) -> None:
    """Every top-k launch of the beam-3 searches took the route that
    ``topk_lse_route`` picks for a search's (rows, 8800) logits at k=3."""
    from lrcn_tpu_torch.ops.kernels.topk_lse import topk_lse_route

    logits = torch.empty((DECODE_BATCH * BEAM, VOCAB), device="meta")
    want = topk_lse_route(logits, BEAM)
    check(launches > 0 and by_route.get(want) == launches,
          f"{where}: top-k launches by route {by_route}, want all {launches} "
          f"on {want}")


def reset_counts(*fns) -> None:
    """Zero the launch counters, in all and by route, of these wrappers."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_counts(*fns) -> dict[str, int]:
    """The launch counters of these wrappers, by wrapper name."""
    return {fn.__name__: fn.launches for fn in fns}


def median_ms(fn, reps: int = 21, inner: int = 10) -> float:
    """Median over ``reps`` samples of the CUDA-event time of ``inner``
    back-to-back calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


DEVICE_MS_RANGE = "chip_smoke.device_ms"


def device_ms(fn, calls: int = 30, one_kernel: bool = True) -> float:
    """Device time per call of ``fn`` from torch.profiler's records of the
    CUDA kernels of ``calls`` calls (after a warm-up): the median kernel
    duration where each call launches one kernel, else their total over
    the calls.  Host time between launches is not in it.  Each call runs
    inside a ``record_function`` range: the profiler keeps no kernel that
    was launched outside every recorded op (a bare C launch).  The range
    also shows on the device's timeline, under its own name, and is left
    out."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            with record_function(DEVICE_MS_RANGE):
                fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.name != DEVICE_MS_RANGE]
    if one_kernel:
        check(len(us) >= calls // 2, f"the profiler recorded {len(us)} "
                                     f"kernels in {calls} calls")
        return statistics.median(us) / 1e3
    check(len(us) >= calls, f"the profiler recorded {len(us)} kernels in "
                            f"{calls} calls")
    return sum(us) / calls / 1e3


def queued_ms(fn, cycles: int, calls: int = 30) -> float:
    """Device time per call of ``fn`` with its kernels back to back, by
    CUDA events and no profiler: a spin of ``cycles`` (``stall_cycles``)
    holds the stream while the host queues all ``calls``, so the host's
    time per call, which at 768 rows exceeds the LSTM kernel's, is not in
    it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    queued = not start.query()
    torch.cuda.synchronize()
    check(queued, f"the spin ended before {calls} calls were queued")
    return start.elapsed_time(end) / calls


def random_tree(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Decoder parameters as the JAX package initializes them (xavier
    uniform, forget-gate bias 1), with '/'-joined checkpoint keys."""
    h1, h2 = HIDDEN
    f = -(-h2 // 2)

    def xavier(shape):
        scale = np.sqrt(6.0 / (shape[0] + shape[1]))
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    def bias(h):
        b = np.zeros(4 * h, np.float32)
        b[:h] = 1.0
        return b

    return {"lstm1/w": xavier((EMBED + h1, 4 * h1)), "lstm1/b": bias(h1),
            "lstm2/w": xavier((2 * f + h2, 4 * h2)), "lstm2/b": bias(h2),
            "w_factor": xavier((h1, f)), "w_cnn": xavier((CNN_DIM, f)),
            "embedding": xavier((VOCAB, EMBED)), "w_out": xavier((h2, VOCAB)),
            "b_out": np.zeros(VOCAB, np.float32)}


def write_checkpoint(path: str, tree: dict, cfg) -> None:
    """The JAX package's checkpoint format, written with numpy."""
    from lrcn_tpu_torch.core.vocab import Vocab

    os.makedirs(path)
    np.savez(os.path.join(path, "params.npz"), **tree)
    Vocab([f"word{i}" for i in range(VOCAB - 3)]).save(
        os.path.join(path, "vocab.json"))
    meta = dict(dataclasses.asdict(cfg), step=0, epoch=0)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(meta, f)


def phase_card() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    from lrcn_tpu_torch import require_cuda
    require_cuda("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"[1 card] {name} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" | CUDA {torch.version.cuda} | python {sys.version.split()[0]}")
    return name, smi


def phase_build() -> None:
    from lrcn_tpu_torch import native
    from lrcn_tpu_torch.ops.kernels import build

    # the C++ front end and the load generator (phase 14) build with g++
    # beside the kernels; phase 14 waits for them
    host_builds = ThreadPoolExecutor(2)
    host_builds.submit(native.httpserve_library)
    host_builds.submit(native.loadgen_binary)
    host_builds.shutdown(wait=False)
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    seconds = time.perf_counter() - t0
    usage = [line.strip() for line in
             path.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    print(f"[2 build] {len(build.sources())} sources from "
          f"lrcn_tpu_torch/csrc -> {os.path.relpath(path, REPO)} in "
          f"{seconds:.1f} s; ptxas: {' | '.join(sorted(set(usage)))}")


def lstm_bound(rows: int, x_dim: int, h_dim: int, w_bytes: int
               ) -> tuple[float, str]:
    """x, h, c read, W and b read, h' and c' written once; 2 flops per
    multiply-add of [x, h] @ W (the cell update is negligible)."""
    nbytes = (4 * rows * (x_dim + 2 * h_dim)
              + w_bytes * (x_dim + h_dim) * 4 * h_dim + 4 * 4 * h_dim
              + 2 * 4 * rows * h_dim)
    flops = 2 * rows * (x_dim + h_dim) * 4 * h_dim
    return bound(nbytes, flops, "bf16" if w_bytes == 2 else "f32")


def phase_lstm(tree, rng) -> dict:
    from lrcn_tpu_torch.ops.kernels import (build, fused_lstm_step,
                                            lstm_step_reference)
    from lrcn_tpu_torch.ops.kernels.lstm_step import (ROUTES, lstm_step_cuda,
                                                      lstm_step_route,
                                                      wgmma_grid)

    rows = DECODE_BATCH * BEAM
    cases = [(f"layer{n} {dtype}".replace("torch.", ""),
              tree[f"lstm{n}/w"], tree[f"lstm{n}/b"], rows, dtype, rng)
             for dtype in (torch.bfloat16, torch.float32) for n in (1, 2)]
    # the burst and 16x256 sizes draw from their own stream, so that the
    # later phases' inputs do not depend on them
    big = np.random.default_rng(SEED + 1)
    cases += [(f"layer1 bfloat16 x{r // rows}", tree["lstm1/w"],
               tree["lstm1/b"], r, torch.bfloat16, big)
              for r in (4 * rows, 16 * rows)]
    # the sampling path's rows: best-of-100 over 256 images
    cases.append(("layer1 bfloat16 sampling", tree["lstm1/w"],
                  tree["lstm1/b"], SAMPLE_IMAGES * SAMPLE_N, torch.bfloat16,
                  big))
    ragged_w = (rng.standard_normal((37 + 70, 280)) * 0.1).astype(np.float32)
    cases += [(f"ragged 100x37x70 {dtype}".replace("torch.", ""), ragged_w,
               np.zeros(280, np.float32), 100, dtype, rng)
              for dtype in (torch.bfloat16, torch.float32)]
    # the command line's row counts that leave the wgmma route's last
    # 128-row block part-filled (caption: 3; serve: 192 x g for g = 1, 3;
    # --sample 100 of 16 images: 1,600) and the mesh service's shard
    # (384), checked and not timed
    cases += [(f"layer{n} bfloat16 {r} rows untimed", tree[f"lstm{n}/w"],
               tree[f"lstm{n}/b"], r, torch.bfloat16, big)
              for r in PARTIAL_ROWS + LONE_TILE_ROWS for n in (1, 2)]
    # the examples' and the runbook's widths (phase 19), each layer at its
    # paths' row counts: gate tiles far narrower than the wgmma route's
    # 4 x 64 columns; checked and not timed
    small = np.random.default_rng(SEED + 19)
    for dtype, widths in ((torch.bfloat16, EXAMPLE_LSTM),
                          (torch.float32, EXAMPLE_LSTM_F32)):
        for (x1, h_dim), rows_list in widths.items():
            for n, x_dim in ((1, x1), (2, 2 * (-(-h_dim // 2)))):
                w_small = (small.standard_normal((x_dim + h_dim, 4 * h_dim))
                           * (6.0 / (x_dim + 5 * h_dim)) ** 0.5).astype(
                    np.float32)
                b_small = np.zeros(4 * h_dim, np.float32)
                b_small[:h_dim] = 1.0
                cases += [(f"examples layer{n} X={x_dim} H={h_dim} "
                           f"{str(dtype)[6:]} {r} rows untimed", w_small,
                           b_small, r, dtype, small) for r in rows_list]
    worst, times = 0.0, {}
    spin = stall_cycles(20.0)
    for label, w_np, b_np, b_dim, dtype, gen in cases:
        h_dim = b_np.shape[0] // 4
        x_dim = w_np.shape[0] - h_dim
        w = torch.from_numpy(w_np).cuda().to(dtype).contiguous()
        b = torch.from_numpy(b_np).cuda()
        h, c, x = (torch.from_numpy(gen.standard_normal(s).astype(
            np.float32)).cuda() for s in ((b_dim, h_dim), (b_dim, h_dim),
                                          (b_dim, x_dim)))
        before = dict(fused_lstm_step.launches_by_route)
        h_k, c_k = fused_lstm_step(w, b, h, c, x)
        routes = route_delta(fused_lstm_step, before)
        want = ("fma" if dtype == torch.float32
                else "wmma" if label.startswith("ragged")
                else lstm_step_route(w, h, c, x)
                if label.startswith("examples") else "wgmma")
        check(routes == {want: 1}, f"lstm_step {label}: routes {routes}, "
                                   f"want {want}")
        h_p, c_p = lstm_step_reference(w, b, h, c, x)
        torch.cuda.synchronize()
        err = max((h_k - h_p).abs().max().item(),
                  (c_k - c_p).abs().max().item())
        check(err <= LSTM_ATOL, f"lstm_step {label}: max |err| {err} > "
                                f"{LSTM_ATOL}")
        worst = max(worst, err)
        if label.endswith("untimed"):
            print(f"[3 lstm_step] {label}: rows={b_dim} X={x_dim} H={h_dim} "
                  f"route {want} max|err|={err:.3g} (tol {LSTM_ATOL})")
            del w, h, c, x, h_k, c_k, h_p, c_p
            continue
        reps = dict(reps=7, inner=3) if b_dim > rows else {}
        ms = median_ms(lambda: fused_lstm_step(w, b, h, c, x), **reps)
        # the kernel alone: at 768 rows a wrapper call's host time exceeds
        # the wgmma route's kernel, so the wall time is the host's
        dev = queued_ms(lambda: fused_lstm_step(w, b, h, c, x), spin)
        plain = median_ms(lambda: lstm_step_reference(w, b, h, c, x), **reps)
        # the library yardstick: the GEMM alone on a pre-concatenated [x, h]
        xh = torch.cat([x, h], 1).to(dtype)
        if dtype == torch.bfloat16:
            lib = median_ms(lambda: torch.mm(xh, w, out_dtype=torch.float32),
                            **reps)
        else:
            lib = median_ms(lambda: torch.mm(xh, w), **reps)
        bnd, by = lstm_bound(b_dim, x_dim, h_dim, w.element_size())
        times[label] = (ms, plain, lib, bnd, by, dev)
        print(f"[3 lstm_step] {label}: rows={b_dim} X={x_dim} H={h_dim} "
              f"route {want} max|err|={err:.3g} (tol {LSTM_ATOL}) kernel "
              f"{ms:.4f} ms (device {dev:.4f} ms) plain {plain:.4f} ms "
              f"torch.mm {lib:.4f} ms bound {bnd:.4f} ms ({by}); "
              f"{2 * b_dim * (x_dim + h_dim) * 4 * h_dim / dev / 1e9:.1f} "
              f"TFLOP/s on the device")
        del w, h, c, x, xh, h_k, c_k, h_p, c_p
    # the host cost of a launch: the wgmma route encodes its TMA maps
    lib_c = build.load()
    w = torch.from_numpy(tree["lstm1/w"]).cuda().to(torch.bfloat16)
    b = torch.from_numpy(tree["lstm1/b"]).cuda()
    x, h, c, h_o, c_o = (torch.zeros((rows, HIDDEN[0]), device="cuda")
                         for _ in range(5))
    stream = torch.cuda.current_stream().cuda_stream
    grid = wgmma_grid(rows, HIDDEN[0], build.sm_count(x.device))
    host = {route: host_us(lambda: build.check(lib_c.lrcn_lstm_step(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), b.data_ptr(),
        h_o.data_ptr(), c_o.data_ptr(), rows, HIDDEN[0], HIDDEN[0], grid,
        ROUTES[route], stream), route))
        for route in ("wgmma", "wmma")}
    print(f"[3 lstm_step] host time per C launch at {rows} rows: wgmma "
          f"{host['wgmma']:.2f} us (TMA maps encoded, {grid} blocks in "
          f"clusters of 2), wmma {host['wmma']:.2f} us")
    # a wrapper call through the op (the dispatcher, then the CUDA
    # implementation) against the CUDA implementation called directly
    op_us = host_us(lambda: fused_lstm_step(w, b, h, c, x))
    impl_us = host_us(lambda: lstm_step_cuda(w, b, h, c, x))
    print(f"[3 lstm_step] host time per wrapper call at {rows} rows "
          f"(wgmma): through lrcn::lstm_step {op_us:.2f} us, the CUDA "
          f"implementation called directly {impl_us:.2f} us")
    ms, plain, lib, bnd, by, dev = times["layer1 bfloat16"]
    s_ms, s_plain, s_lib, s_bnd, _, s_dev = times["layer1 bfloat16 sampling"]
    return {"name": "fused_lstm_step", "route": "cuda",
            "source": "lrcn_tpu_torch/csrc/lstm_step.cu",
            "replaces": "lrcn_tpu/ops/pallas/lstm_step.py:63",
            "shape": f"rows={rows} X=H={HIDDEN[0]} bf16",
            "kernel_route": "wgmma", "max_abs_err": worst, "ms": ms,
            "device_ms": dev,
            "plain_ms": plain, "library_ms": lib, "library": "torch.mm",
            "bound_ms": bnd, "bound_by": by,
            "host_us": host["wgmma"], "op": "lrcn::lstm_step",
            "host_op_us": op_us, "host_impl_us": impl_us,
            "sampling_shape": f"rows={SAMPLE_IMAGES * SAMPLE_N}",
            "sampling_ms": s_ms, "sampling_device_ms": s_dev,
            "sampling_plain_ms": s_plain,
            "sampling_library_ms": s_lib, "sampling_bound_ms": s_bnd}


def lse_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the finite entries of ``want``; inf unless the
    other entries (an all--inf row's -inf) are equal."""
    fin = torch.isfinite(want)
    if not (torch.equal(fin, torch.isfinite(got))
            and torch.equal(got[~fin], want[~fin])):
        return float("inf")
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def topk_edge_rows(gen: np.random.Generator) -> np.ndarray:
    """Rows at the kernel's edges: -inf entries, an all--inf row, the beam's
    +-1e30, rows of one value, ties at the head and the tail."""
    x = (gen.standard_normal((8, VOCAB)) * 3).astype(np.float32)
    x[0] = -np.inf
    x[1, gen.random(VOCAB) < 0.5] = -np.inf
    x[2] = -1e30
    x[2, [5, VOCAB // 2, VOCAB - 1]] = 1.0
    x[3, [17, 18, VOCAB * 2 // 3]] = 1e30
    x[4] = 0.5
    x[5, :VOCAB - 2] = -np.inf
    x[6, :4] = 50.0
    x[7, VOCAB - 3:] = 50.0
    return x


def topk_bound(rows: int, v: int, k: int) -> tuple[float, str]:
    """Logits read once, values, indices and lse written once; about 4 f32
    operations an element (max, subtract, exp, add)."""
    return bound(4 * rows * v + 8 * rows * k + 4 * rows, 4 * rows * v,
                 "f32")


def phase_topk(rng) -> dict:
    from lrcn_tpu_torch import require_cuda
    from lrcn_tpu_torch.ops.kernels import (build, topk_logsumexp,
                                            topk_logsumexp_reference)
    from lrcn_tpu_torch.ops.kernels.topk_lse import (MAX_K, ROUTES,
                                                     topk_lse_cuda,
                                                     topk_lse_route)

    rows = DECODE_BATCH * BEAM
    # the first three draw from the shared stream as they always have, so
    # that the later phases' inputs stay the same; the rest from their own
    ties = rng.integers(-3, 3, (rows, VOCAB)).astype(np.float32)
    ties[:, 7] = ties[:, 3]
    ties[:, VOCAB - 1] = ties[:, 0]
    cuda = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()
    beam = cuda(rng.standard_normal((rows, VOCAB)) * 3)
    greedy = cuda(rng.standard_normal((DECODE_BATCH, VOCAB)) * 3)
    own = np.random.default_rng(SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    big = torch.randn((16 * rows, VOCAB), generator=gen, device="cuda") * 3
    flat = torch.empty(64 * VOCAB + 1, device="cuda")
    misaligned = flat[1:].view(64, VOCAB)       # 4 bytes past 16-byte
    misaligned.copy_(beam[:64])
    edge = cuda(topk_edge_rows(own))
    cases = [("beam", beam, BEAM), ("beam k=9", beam, 9),
             ("beam k=12", beam, 12), ("greedy", greedy, 1),
             ("tie-heavy", cuda(ties), BEAM), ("16x256 decode", big, BEAM),
             ("edge rows", edge, BEAM), ("edge rows k=12", edge, 12),
             ("V=8801", cuda(own.standard_normal((5, VOCAB + 1)) * 3), BEAM),
             ("misaligned view", misaligned, BEAM),
             ("R=1", beam[:1].clone(), BEAM), ("R=3", beam[:3].clone(), BEAM),
             ("k=V", cuda(own.standard_normal((3, 100))), 100)]
    # the examples' and the runbook's vocabularies at their beam widths
    # (phase 19): most of a block's threads hold no element; one tie-heavy
    # input whose rows hold a handful of values
    small = np.random.default_rng(SEED + 19)
    for v, rows_v in EXAMPLE_VOCABS:
        x = cuda(small.standard_normal((rows_v, v)) * 3)
        cases += [(f"examples V={v} k={k}", x, k) for k in (2, 3)]
    v, rows_v = EXAMPLE_VOCABS[0]
    cases.append((f"examples V={v} tie-heavy", cuda(small.integers(
        -2, 2, (rows_v, v))), 3))
    worst = 0.0
    for label, x, k in cases:
        want = topk_logsumexp_reference(x, k)
        routes = [r for r in ROUTES if k <= MAX_K.get(r, x.shape[1])]
        for route in routes + [None]:
            before = dict(topk_logsumexp.launches_by_route)
            got = topk_logsumexp(x, k, route=route)
            taken = route or topk_lse_route(x, k)
            delta = route_delta(topk_logsumexp, before)
            check(delta == {taken: 1}, f"topk_logsumexp {label}: routes "
                                       f"{delta}, want {taken}")
            torch.cuda.synchronize()
            check(torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                               want[1]),
                  f"topk_logsumexp {label} ({taken}): values/indices differ")
            err = lse_err(got[2], want[2])
            check(err <= LSE_ATOL, f"topk_logsumexp {label} ({taken}): lse "
                                   f"|err| {err}")
            worst = max(worst, err)
        print(f"[4 topk_logsumexp] {label}: {tuple(x.shape)} k={k} routes "
              f"{routes} (default {topk_lse_route(x, k)}): vals/idx exact, "
              f"lse within {LSE_ATOL}")

    # times at the main path's shapes: device time (profiler) of each route
    # in turns, wall time per wrapper call, host time per call, plain,
    # torch.topk and the bound
    lib_c = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    timed = {}
    for label, x, k in (c for c in cases if c[0] in TOPK_TIMED):
        r, v = x.shape
        default = topk_lse_route(x, k)
        other = "warp" if k <= MAX_K["warp"] else "rounds"
        big_rows = r > rows
        dev = {default: [], other: []}
        for route in (other, default, default, other):
            dev[route].append(device_ms(
                lambda: topk_logsumexp(x, k, route=route),
                calls=10 if big_rows else 30))
        dev = {route: statistics.mean(ms) for route, ms in dev.items()}
        wall = median_ms(lambda: topk_logsumexp(x, k),
                         **(dict(reps=7, inner=3) if big_rows else {}))
        host = host_us(lambda: topk_logsumexp(x, k))
        host_impl = host_us(lambda: topk_lse_cuda(x, k))
        vals, idx, lse = (torch.empty((r, k), device="cuda"),
                          torch.empty((r, k), device="cuda",
                                      dtype=torch.int32),
                          torch.empty(r, device="cuda"))
        host_c = host_us(lambda: build.check(lib_c.lrcn_topk_lse(
            x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), r,
            v, k, ROUTES[default], stream), default))
        plain = device_ms(lambda: topk_logsumexp_reference(x, k),
                          calls=3 if big_rows else 10, one_kernel=False)
        lib = device_ms(lambda: torch.topk(x, k), calls=10 if big_rows
                        else 30, one_kernel=False)
        bnd, by = topk_bound(r, v, k)
        timed[label] = dict(ms=dev[default], other_ms=dev[other], wall=wall,
                            host=host, host_impl=host_impl, host_c=host_c,
                            plain=plain, lib=lib, bnd=bnd, by=by)
        print(f"[4 topk_logsumexp] {label} {tuple(x.shape)} k={k}: device "
              f"{default} {dev[default]:.4f} ms, {other} {dev[other]:.4f} ms "
              f"(in turns); wall per call {wall:.4f} ms; host per wrapper "
              f"call through lrcn::topk_lse {host:.2f} us, per direct call "
              f"of the CUDA implementation {host_impl:.2f} us, per C launch "
              f"{host_c:.2f} us; plain "
              f"{plain:.4f} ms; torch.topk {lib:.4f} ms; bound {bnd:.4f} ms "
              f"({by}), {bnd / dev[default]:.1%} of it")
    # the wrapper's host time by part at the beam shape: what it skips once
    # a device has passed (the capability query; the device switch and the
    # Stream object, where the device is current) beside what it keeps
    device = beam.device

    def switch_and_stream():
        with torch.cuda.device(device):
            return torch.cuda.current_stream(device).cuda_stream

    def on_device():
        with build.on_device(device) as s:
            return s

    parts = {"capability query": lambda: torch.cuda.get_device_capability(
                 device),
             "device switch + Stream": switch_and_stream,
             "require_cuda": lambda: require_cuda(device),
             "on_device": on_device,
             "3 x torch.empty": lambda: (
                 torch.empty((rows, BEAM), device=device),
                 torch.empty((rows, BEAM), device=device, dtype=torch.int32),
                 torch.empty(rows, device=device))}
    print(f"[4 topk_logsumexp] host us per part, ({rows}, {VOCAB}) k={BEAM}:"
          f" skipped: " + ", ".join(f"{name} {host_us(fn):.2f}"
                                    for name, fn in list(parts.items())[:2])
          + "; kept: " + ", ".join(f"{name} {host_us(fn):.2f}"
                                   for name, fn in list(parts.items())[2:]))
    t = timed["beam"]
    return {"name": "topk_logsumexp", "route": "cuda",
            "source": "lrcn_tpu_torch/csrc/topk_lse.cu",
            "replaces": "lrcn_tpu/ops/pallas/topk_lse.py:62",
            "shape": f"({rows}, {VOCAB}) k={BEAM}",
            "kernel_route": topk_lse_route(beam, BEAM),
            "routes": list(ROUTES), "max_abs_err": worst,
            "ms": t["ms"], "v1_ms": t["other_ms"], "wall_ms": t["wall"],
            "plain_ms": t["plain"], "library_ms": t["lib"],
            "library": "torch.topk", "bound_ms": t["bnd"],
            "bound_by": t["by"], "host_us": t["host"],
            "op": "lrcn::topk_lse", "host_op_us": t["host"],
            "host_impl_us": t["host_impl"], "host_c_us": t["host_c"],
            "timing": "device time from torch.profiler (ms, v1_ms, "
                      "plain_ms, library_ms); wall_ms by CUDA events"}


def phase_moe(smi: str) -> dict:
    """Phase 20: the top-k kernel at the MoE search's shape, then that
    search's launches (module docstring)."""
    from lrcn_tpu_torch.config import MoETextConfig
    from lrcn_tpu_torch.decode.beam import rows_search
    from lrcn_tpu_torch.models.moe_text import MoETextDecoder, init_params
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp,
                                            topk_logsumexp_reference)
    from lrcn_tpu_torch.ops.kernels.topk_lse import MAX_K, topk_lse_route

    cfg = MoETextConfig(num_hidden_layers=MOE_LAYERS,
                        prompt_ids=tuple(range(3, 3 + MOE_PROMPT)))
    rows, v, k = MOE_ROWS * MOE_BEAM, cfg.vocab_size, MOE_BEAM
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randn((rows, v), generator=gen, device="cuda") * 3
    default = topk_lse_route(x, k)
    other = "warp" if k <= MAX_K["warp"] else "rounds"
    want = topk_logsumexp_reference(x, k)
    before = dict(topk_logsumexp.launches_by_route)
    got = topk_logsumexp(x, k)
    delta = route_delta(topk_logsumexp, before)
    check(delta == {default: 1}, f"[20 moe] top-k routes {delta}, want "
                                 f"{default}")
    torch.cuda.synchronize()
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"[20 moe] top-k ({rows}, {v}) k={k}: values/indices differ")
    err = lse_err(got[2], want[2])
    print(f"[20 moe] top-k ({rows}, {v}) k={k}, route {default}: vals/idx "
          f"exact, lse |err| {err:.3g} (tolerance {LSE_ATOL})")
    check(err <= LSE_ATOL, f"[20 moe] top-k lse |err| {err}")
    del want, got
    dev = {default: [], other: []}
    for route in (other, default, default, other):
        dev[route].append(device_ms(lambda: topk_logsumexp(x, k, route=route),
                                    calls=10))
    dev = {route: statistics.mean(ms) for route, ms in dev.items()}
    wall = median_ms(lambda: topk_logsumexp(x, k), reps=7, inner=3)
    plain = device_ms(lambda: topk_logsumexp_reference(x, k), calls=3,
                      one_kernel=False)
    lib = device_ms(lambda: (torch.topk(x, k), torch.logsumexp(x, -1)),
                    calls=10, one_kernel=False)
    bnd, by = topk_bound(rows, v, k)
    print(f"[20 moe] top-k ({rows}, {v}) k={k}: device {default} "
          f"{dev[default]:.4f} ms, {other} {dev[other]:.4f} ms (in turns); "
          f"wall per call {wall:.4f} ms; plain {plain:.4f} ms; torch.topk + "
          f"torch.logsumexp {lib:.4f} ms; bound {bnd:.4f} ms ({by}), "
          f"{bnd / dev[default]:.1%} of it; {smi}")
    del x

    t0 = time.perf_counter()
    decoder = MoETextDecoder(cfg, init_params(cfg, gen), torch.bfloat16)
    feats = torch.rand((MOE_IMAGES, cfg.cnn_feature_dim), generator=gen,
                       device="cuda")
    table = (feats / feats.sum(1, keepdim=True)).to(torch.bfloat16)
    idx = torch.arange(MOE_ROWS, device="cuda").clamp(max=MOE_IMAGES - 1)
    search = lambda: rows_search(decoder, table, idx, beam_width=MOE_BEAM,
                                 max_words=MOE_WORDS)
    eager = search()                # the signature's eager call
    search()                        # its capture
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    kernels = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    reset_counts(*kernels)
    t0 = time.perf_counter()
    tokens, _ = search()
    torch.cuda.synchronize()
    replay = time.perf_counter() - t0
    launches = read_counts(*kernels)
    by_route = {r: n for r, n in topk_logsumexp.launches_by_route.items()
                if n}
    want = {"fused_conv3x3_relu": 0, "fused_lstm_step": 0,
            "topk_logsumexp": MOE_WORDS + 1}
    check(launches == want and by_route == {default: MOE_WORDS + 1},
          f"[20 moe] launches of one replayed search {launches}, top-k by "
          f"route {by_route}; want {want}, all {default}")
    check(torch.equal(tokens, eager[0]), "[20 moe] the replayed search's "
                                         "tokens differ from the eager one's")
    print(f"[20 moe] rows_search, {MOE_ROWS} rows x beam {MOE_BEAM}, "
          f"{MOE_WORDS} words, {MOE_LAYERS} layers at the published widths "
          f"and V={v}: one replay {replay:.3f} s (decoder, eager call and "
          f"capture {built:.1f} s), tokens equal to the eager call's; "
          f"launches {launches}, top-k by route {by_route}")
    del decoder, eager, tokens
    torch.cuda.empty_cache()
    return {"name": "topk_logsumexp", "shape": f"({rows}, {v}) k={k}",
            "kernel_route": default, "max_abs_err": err,
            "ms": dev[default], "v1_ms": dev[other], "wall_ms": wall,
            "plain_ms": plain, "library_ms": lib,
            "library": "torch.topk + torch.logsumexp", "bound_ms": bnd,
            "bound_by": by, "launches": launches["topk_logsumexp"],
            "launches_by_route": by_route,
            "launches_by_path": {"moe search (phase 20)": launches}}


def check_captions(tok_k, sc_k, tok_p, sc_p, vocab, label: str
                   ) -> tuple[int, float, int]:
    """Hold a kernel path's f32 captions against the plain path's: at least
    CAPTION_AGREEMENT equal, and every differing one a near-tie (score gap
    <= SCORE_ATOL).  Returns (captions equal, max score gap, distinct
    captions)."""
    from lrcn_tpu_torch.decode.writer import detokenize_batch

    cap_k = detokenize_batch(tok_k.cpu().numpy(), vocab)
    cap_p = detokenize_batch(tok_p.cpu().numpy(), vocab)
    differ = [i for i, (a, b) in enumerate(zip(cap_k, cap_p)) if a != b]
    gaps = (sc_k - sc_p).abs().cpu().numpy()
    agree = 1 - len(differ) / len(cap_k)
    check(agree >= CAPTION_AGREEMENT,
          f"{label}: kernel vs plain captions agree on {agree:.4f} only")
    check(all(gaps[i] <= SCORE_ATOL for i in differ),
          f"{label}: differing captions' score gaps {gaps[differ].tolist()}")
    return len(cap_k) - len(differ), float(gaps.max()), len(set(cap_k))


def phase_service(tree, rng) -> tuple[dict, torch.Tensor]:
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.serve import CaptionService
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    shutil.rmtree(WORK, ignore_errors=True)
    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB, compute_dtype="bfloat16")
    write_checkpoint(os.path.join(WORK, "ckpt"), tree, cfg)
    raw = np.abs(rng.standard_normal((2048, CNN_DIM))).astype(np.float32)
    feats = raw / raw.sum(axis=1, keepdims=True)
    store = FeatureStore(dim=CNN_DIM, normalized=True)
    for i, row in enumerate(feats):
        store.add(1000 + i, row)
    store.save(os.path.join(WORK, "store"))
    store = FeatureStore.load(os.path.join(WORK, "store"))

    ck = load_checkpoint(os.path.join(WORK, "ckpt"), device="cuda")
    svc = CaptionService(ck["cfg"], ck["decoder"], ck["vocab"],
                         device="cuda", store=store, beam_width=BEAM,
                         max_words=MAX_WORDS, decode_batch=DECODE_BATCH)
    t0 = time.perf_counter()
    svc.warmup()
    warm_s = time.perf_counter() - t0

    ids = store.ids()
    requests = [("ids", ids[:1]), ("ids", ids[1:18]), ("ids", ids[18:274]),
                ("ids", ids[274:974]), ("features", list(raw[:5])),
                ("features", list(raw[5:305]))]

    def answer(req):
        kind, items = req
        if kind == "ids":
            return svc.caption_ids(items)
        return svc.caption_features(items)

    # the main path: every count starts at 0 here (warmup's batches were
    # recorded when their requests returned, so they are counted before)
    batches_before = sum(s["batches"] for s in svc.stats().values())
    reset_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(requests)) as pool:
        answers = list(pool.map(answer, requests))
    serve_s = time.perf_counter() - t0
    launches = read_counts(fused_conv3x3_relu, fused_lstm_step,
                           topk_logsumexp)
    by_route = {"fused_lstm_step": dict(fused_lstm_step.launches_by_route),
                "topk_logsumexp": dict(topk_logsumexp.launches_by_route)}
    svc.close()     # joins the batcher threads: their stats are final
    searches = (sum(s["batches"] for s in svc.stats().values())
                - batches_before)

    n_captions = sum(len(a) for a in answers)
    for (kind, items), lines in zip(requests, answers):
        check(len(lines) == len(items), f"{kind}: {len(lines)} answers "
                                        f"for {len(items)} requests")
        for line in lines:
            check(isinstance(line, str) and line.endswith(" ."),
                  f"malformed caption {line!r}")
    steps = MAX_WORDS + 1
    check(searches > 0 and launches["topk_logsumexp"] == steps * searches,
          f"topk_logsumexp launched {launches['topk_logsumexp']} times in "
          f"{searches} searches of {steps} steps")
    check(launches["fused_lstm_step"] == 2 * steps * searches,
          f"fused_lstm_step launched {launches['fused_lstm_step']} times in "
          f"{searches} searches of {steps} steps")
    check(by_route["fused_lstm_step"]["wgmma"] == launches["fused_lstm_step"],
          f"fused_lstm_step routes {by_route['fused_lstm_step']}")
    check_topk_routes(by_route["topk_logsumexp"], launches["topk_logsumexp"],
                      "service")
    check(launches["fused_conv3x3_relu"] == 0,
          "serving by id and features launched the conv kernel")
    print(f"[5 service] warmup {warm_s:.2f} s; {n_captions} captions for "
          f"{len(requests)} concurrent requests in {serve_s:.3f} s, "
          f"{searches} searches; launches {launches}, by route {by_route}; "
          f"e.g. {answers[0][0][:60]!r}")

    # kernel path against plain path in f32, TF32 off
    dec32 = load_checkpoint(os.path.join(WORK, "ckpt"), device="cuda",
                            compute_dtype=torch.float32)["decoder"]
    batch = torch.from_numpy(feats[:DECODE_BATCH]).cuda()
    tok_k, sc_k = beam_search(dec32, batch, beam_width=BEAM,
                              max_words=MAX_WORDS)
    tok_p, sc_p = beam_search(dec32, batch, beam_width=BEAM,
                              max_words=MAX_WORDS, use_kernels=False)
    equal, gap, distinct = check_captions(tok_k, sc_k, tok_p, sc_p,
                                          ck["vocab"], "f32 service")
    print(f"[5 service f32] kernel vs plain path: {equal}/{len(tok_k)} "
          f"captions equal (need {CAPTION_AGREEMENT}); max score gap "
          f"{gap:.3g}; {distinct} distinct captions")
    return launches, by_route, torch.from_numpy(feats)


def phase_throughput(decoder_path: str, feats: torch.Tensor, smi: str
                     ) -> float:
    from lrcn_tpu_torch.decode.beam import beam_search_grouped
    from lrcn_tpu_torch.ops.kernels import fused_lstm_step, topk_logsumexp
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    decoder = load_checkpoint(decoder_path, device="cuda")["decoder"]
    groups = 16
    rows = feats[torch.arange(groups * DECODE_BATCH) % feats.shape[0]]
    batch = rows.view(groups, DECODE_BATCH, -1).cuda().to(torch.bfloat16)
    run = lambda: beam_search_grouped(decoder, batch, beam_width=BEAM,
                                      max_words=MAX_WORDS)
    run(), run()                # eagerly, then captured
    torch.cuda.synchronize()
    iters = 3
    reset_counts(fused_lstm_step, topk_logsumexp)
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens, _ = run()
    tokens.cpu()
    dt = time.perf_counter() - t0
    rate = iters * groups * DECODE_BATCH / dt
    routes = dict(fused_lstm_step.launches_by_route)
    topk_routes = dict(topk_logsumexp.launches_by_route)
    check(fused_lstm_step.launches > 0
          and routes["wgmma"] == fused_lstm_step.launches,
          f"16x{DECODE_BATCH} decode: LSTM launches by route {routes}")
    check_topk_routes(topk_routes, topk_logsumexp.launches,
                      f"16x{DECODE_BATCH} decode")
    print(f"[6 throughput] beam-{BEAM} max_words={MAX_WORDS} "
          f"{groups}x{DECODE_BATCH} bf16: {rate:.1f} captions/s "
          f"({dt / iters * 1e3:.1f} ms per decode) on {smi}; launches by "
          f"route: LSTM {routes}, top-k {topk_routes}")
    return rate


def conv_bound(b_dim, h, w_dim, c, f, elem: int) -> tuple[float, str]:
    """x, w and b read, y written once; 2 flops per multiply-add."""
    nbytes = elem * (b_dim * h * w_dim * (c + f) + 9 * c * f) + 4 * f
    flops = 2 * b_dim * h * w_dim * 9 * c * f
    return bound(nbytes, flops, "bf16" if elem == 2 else "f32")


def phase_conv() -> dict:
    import torch.nn.functional as F

    from lrcn_tpu_torch.ops.kernels import (build, conv3x3_relu_reference,
                                            fused_conv3x3_relu)
    from lrcn_tpu_torch.ops.kernels.conv3x3 import ROUTES, conv3x3_relu_cuda

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    randn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cases = [(f"{h}x{h}x{c}->{f} {dtype}".replace("torch.", ""),
              (CONV_BATCH, h, h, c, f), dtype, True)
             for dtype in (torch.bfloat16, torch.float32)
             for h, c, f, _ in VGG_CONVS
             if dtype == torch.bfloat16 or (h, c, f) in F32_CONVS]
    cases += [(f"ragged 2x13x17x5->7 relu={relu} {dtype}".replace(
        "torch.", ""), (2, 13, 17, 5, 7), dtype, relu)
        for dtype in (torch.bfloat16, torch.float32) for relu in (True, False)]
    # one image, as `caption` encodes it: 56x56 and 14x14 leave the last
    # 128-pixel block part-filled; checked and not timed
    cases += [(f"B=1 {h}x{h}x{c}->{f} bfloat16", (1, h, h, c, f),
               torch.bfloat16, True) for h, c, f in ((56, 256, 256),
                                                     (14, 512, 512))]
    # a shard of phase 16's mesh service: half an encoder batch, every
    # VGG shape in bf16 and phase 16's f32 check's; checked and not timed
    shard = ENCODE_BATCH // MESH_SHARDS
    cases += [(f"B={shard} {h}x{h}x{c}->{f} {dtype}".replace("torch.", ""),
               (shard, h, h, c, f), dtype, True)
              for dtype in (torch.bfloat16, torch.float32)
              for h, c, f, _ in VGG_CONVS
              if dtype == torch.bfloat16 or (h, c, f) in F32_CONVS]
    # the runbook's width-scaled .mat (phase 19): 8 channels a conv, an
    # encoder batch of 8; checked and not timed
    cases += [(f"B={RUNBOOK_BATCH} runbook {h}x{h}x{c}->{f} bfloat16",
               (RUNBOOK_BATCH, h, h, c, f), torch.bfloat16, True)
              for h, c, f in ((224, 3, RUNBOOK_WIDTH),
                              (224, RUNBOOK_WIDTH, RUNBOOK_WIDTH),
                              (14, RUNBOOK_WIDTH, RUNBOOK_WIDTH))]
    worst, times = 0.0, {}
    for label, (b_dim, h, w_dim, c, f), dtype, relu in cases:
        x = randn(b_dim, h, w_dim, c)
        if c > 3:           # a post-ReLU activation, as inside VGG
            x = torch.relu(x)
        x = x.to(dtype)
        w = (randn(3, 3, c, f) * (2.0 / (9 * c)) ** 0.5).to(dtype)
        b = randn(f) * 0.1
        before = dict(fused_conv3x3_relu.launches_by_route)
        y_k = fused_conv3x3_relu(x, w, b, apply_relu=relu)
        routes = route_delta(fused_conv3x3_relu, before)
        want = ("fma" if dtype == torch.float32
                else "wgmma" if c % 64 == 0 and f % 64 == 0 else "scalar")
        check(routes == {want: 1}, f"conv3x3 {label}: routes {routes}, "
                                   f"want {want}")
        y_p = conv3x3_relu_reference(x, w, b, dtype, apply_relu=relu)
        torch.cuda.synchronize()
        err = (y_k.float() - y_p.float()).abs().max().item()
        scale = y_p.float().abs().max().item()
        check(y_k.shape == y_p.shape and y_k.dtype == dtype,
              f"conv3x3 {label}: {tuple(y_k.shape)} {y_k.dtype}")
        check(err <= CONV_RTOL[dtype] * scale,
              f"conv3x3 {label}: max |err| {err} > {CONV_RTOL[dtype]} x "
              f"{scale}")
        worst = max(worst, err)
        if label.startswith("B="):
            print(f"[7 conv3x3] {label}: route {want} max|err|={err:.3g} "
                  f"(tol {CONV_RTOL[dtype]:.3g} x max|y| {scale:.3g})")
            del x, w, y_k, y_p
            continue
        ms = median_ms(lambda: fused_conv3x3_relu(x, w, b, apply_relu=relu))
        plain = median_ms(lambda: conv3x3_relu_reference(
            x, w, b, dtype, apply_relu=relu), reps=11, inner=3)
        # cuDNN's own conv in the compute dtype on the NHWC (channels-last)
        # tensors, bias in the conv, ReLU after: what a user would call
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.to(dtype)
        cudnn = median_ms(lambda: torch.relu(F.conv2d(xc, wc, bc, padding=1)))
        bnd, by = conv_bound(b_dim, h, w_dim, c, f, x.element_size())
        times[label] = (ms, plain, cudnn, bnd, by)
        flops = 2 * b_dim * h * w_dim * 9 * c * f
        print(f"[7 conv3x3] {label}: B={b_dim} route {want} max|err|="
              f"{err:.3g} (tol {CONV_RTOL[dtype]:.3g} x max|y| {scale:.3g}) "
              f"kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s) plain "
              f"{plain:.4f} ms cudnn {cudnn:.4f} ms bound {bnd:.4f} ms "
              f"({by})")
        del x, w, y_k, y_p, xc, wc
    stack = [sum(n * times[f"{h}x{h}x{c}->{f} bfloat16"][i]
                 for h, c, f, n in VGG_CONVS) for i in range(4)]
    print(f"[7 conv3x3] 13-conv stack at B={CONV_BATCH} bf16: kernel "
          f"{stack[0]:.4f} ms, plain {stack[1]:.4f} ms, cudnn "
          f"{stack[2]:.4f} ms, bound {stack[3]:.4f} ms")
    # the host cost of a launch: the wgmma route encodes two TMA maps
    lib_c = build.load()
    h, c, f = VGG_CONVS[-1][:3]
    x = torch.zeros((CONV_BATCH, h, h, c), device="cuda",
                    dtype=torch.bfloat16)
    w = torch.zeros((3, 3, c, f), device="cuda", dtype=torch.bfloat16)
    b, y = torch.zeros(f, device="cuda"), torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    host = {route: host_us(lambda: build.check(lib_c.lrcn_conv3x3(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), CONV_BATCH,
        h, h, c, f, 1, ROUTES[route], stream), route))
        for route in ("wgmma", "scalar")}
    print(f"[7 conv3x3] host time per C launch at {h}x{h}x{c}->{f}: wgmma "
          f"{host['wgmma']:.2f} us (2 TMA maps encoded), scalar "
          f"{host['scalar']:.2f} us")
    op_us = host_us(lambda: fused_conv3x3_relu(x, w, b))
    impl_us = host_us(lambda: conv3x3_relu_cuda(x, w, b))
    print(f"[7 conv3x3] host time per wrapper call at {h}x{h}x{c}->{f} "
          f"(wgmma): through lrcn::conv3x3_relu {op_us:.2f} us, the CUDA "
          f"implementation called directly {impl_us:.2f} us")
    h, c, f = REPORT_CONV
    ms, plain, cudnn, bnd, by = times[f"{h}x{h}x{c}->{f} bfloat16"]
    return {"name": "fused_conv3x3_relu", "route": "cuda",
            "source": "lrcn_tpu_torch/csrc/conv3x3.cu",
            "replaces": "lrcn_tpu/ops/pallas/conv3x3.py:61",
            "shape": f"B={CONV_BATCH} {h}x{h}x{c}->{f} bf16",
            "kernel_route": "wgmma", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "library_ms": cudnn,
            "library": "F.conv2d (cuDNN) + relu", "bound_ms": bnd,
            "bound_by": by, "host_us": host["wgmma"],
            "op": "lrcn::conv3x3_relu", "host_op_us": op_us,
            "host_impl_us": impl_us, "stack_ms": stack[0],
            "stack_library_ms": stack[2],
            "stack_bound_ms": stack[3]}


def random_vgg(rng: np.random.Generator) -> dict[str, np.ndarray]:
    """Full-width VGG-16 parameters as the JAX package initializes them
    (He-normal convs, 0.01-normal fc6/fc7, zero biases;
    lrcn_tpu/models/vgg.py:55-89), with '/'-joined keys."""
    from lrcn_tpu_torch.models.vgg import CONV_NAMES, VGG16_LAYOUT

    widths = dict(e for e in VGG16_LAYOUT if e != "pool")
    tree, c_in = {}, 3
    normal = lambda *s: rng.standard_normal(s, dtype=np.float32)
    for name in CONV_NAMES:
        c_out = widths[name]
        tree[f"{name}/w"] = normal(3, 3, c_in, c_out) * np.float32(
            np.sqrt(2.0 / (9 * c_in)))
        tree[f"{name}/b"] = np.zeros(c_out, np.float32)
        c_in = c_out
    tree["fc6/w"] = normal(7, 7, c_in, 4096) * np.float32(0.01)
    tree["fc7/w"] = normal(4096, 4096) * np.float32(0.01)
    tree["fc6/b"] = tree["fc7/b"] = np.zeros(4096, np.float32)
    return tree


def write_joint_checkpoint(path: str, tree: dict, rng) -> None:
    """A JAX-format joint checkpoint at the reference width: the decoder
    ``tree``, a full-width random VGG-16 drawn from ``rng`` and a mean
    image of ImageNet's channel means."""
    from lrcn_tpu_torch.config import LRCNConfig

    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB, compute_dtype="bfloat16")
    joint = {f"decoder/{k}": v for k, v in tree.items()}
    joint.update({f"cnn/{k}": v for k, v in random_vgg(rng).items()})
    write_checkpoint(path, joint, cfg)
    mean = np.array([123.68, 116.78, 103.94], np.float32)
    np.save(os.path.join(path, "average_image.npy"),
            np.broadcast_to(mean, (224, 224, 3)))


def phase_images(tree, rng) -> dict:
    from lrcn_tpu_torch.data.images import normalize_batch
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.models.vgg import l1_normalize, vgg16_fc7
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.serve import CaptionService
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    path = os.path.join(WORK, "joint")
    write_joint_checkpoint(path, tree, rng)

    ck = load_checkpoint(path, device="cuda")
    check(ck["vgg"] is not None, "joint checkpoint loaded without its VGG")
    svc = CaptionService(ck["cfg"], ck["decoder"], ck["vocab"],
                         device="cuda", vgg=ck["vgg"],
                         average_image=ck["average_image"], beam_width=BEAM,
                         max_words=MAX_WORDS, decode_batch=DECODE_BATCH,
                         encode_batch=ENCODE_BATCH)
    t0 = time.perf_counter()
    svc.warmup()
    warm_s = time.perf_counter() - t0
    sizes = [1, 3, 8, 13, 24]
    requests = [list(rng.integers(0, 256, (n, 224, 224, 3), np.uint8))
                for n in sizes]

    # the image path: every count starts at 0 here (warmup's batches were
    # recorded when their requests returned, so they are counted before)
    before = {k: s["batches"] for k, s in svc.stats().items()}
    reset_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(requests)) as pool:
        answers = list(pool.map(svc.caption_images, requests))
    serve_s = time.perf_counter() - t0
    launches = {"fused_conv3x3_relu": fused_conv3x3_relu.launches,
                "fused_lstm_step": fused_lstm_step.launches,
                "topk_logsumexp": topk_logsumexp.launches}
    by_route = {"fused_conv3x3_relu":
                dict(fused_conv3x3_relu.launches_by_route),
                "fused_lstm_step": dict(fused_lstm_step.launches_by_route),
                "topk_logsumexp": dict(topk_logsumexp.launches_by_route)}
    svc.close()     # joins the batcher threads: their stats are final
    after = svc.stats()
    encodes = after["encode"]["batches"] - before["encode"]
    searches = after["decode"]["batches"] - before["decode"]
    for items, lines in zip(requests, answers):
        check(len(lines) == len(items), f"images: {len(lines)} answers for "
                                        f"{len(items)} requests")
        for line in lines:
            check(isinstance(line, str) and line.endswith(" ."),
                  f"malformed caption {line!r}")
    steps = MAX_WORDS + 1
    check(encodes >= -(-sum(sizes) // ENCODE_BATCH)
          and launches["fused_conv3x3_relu"] == 13 * encodes,
          f"fused_conv3x3_relu launched {launches['fused_conv3x3_relu']} "
          f"times in {encodes} encoder batches")
    check(searches > 0 and launches["topk_logsumexp"] == steps * searches
          and launches["fused_lstm_step"] == 2 * steps * searches,
          f"decoder kernels launched {launches} in {searches} searches")
    conv_routes = by_route["fused_conv3x3_relu"]
    check(conv_routes["wgmma"] == 12 * encodes
          and conv_routes["scalar"] == encodes,
          f"conv routes {conv_routes} in {encodes} encoder batches: want 12 "
          f"wgmma and 1 scalar (conv1_1) each")
    check(by_route["fused_lstm_step"]["wgmma"] == launches["fused_lstm_step"],
          f"LSTM routes {by_route['fused_lstm_step']}")
    check_topk_routes(by_route["topk_logsumexp"], launches["topk_logsumexp"],
                      "image service")
    print(f"[8 images] warmup {warm_s:.2f} s; {sum(sizes)} captions for "
          f"{len(requests)} concurrent image requests in {serve_s:.3f} s, "
          f"{encodes} encoder batches of {ENCODE_BATCH}, {searches} "
          f"searches; launches {launches}, by route {by_route}; e.g. "
          f"{answers[0][0][:60]!r}")

    # kernel path against plain path in f32, TF32 off
    del svc, ck
    ck32 = load_checkpoint(path, device="cuda", compute_dtype=torch.float32)
    vgg32, dec32 = ck32["vgg"], ck32["decoder"]
    avg = torch.from_numpy(ck32["average_image"]).cuda()
    images = torch.from_numpy(rng.integers(
        0, 256, (DECODE_BATCH, 224, 224, 3), np.uint8)).cuda()
    fc7 = {}
    for use_kernels in (True, False):
        fc7[use_kernels] = torch.cat([
            vgg16_fc7(vgg32, normalize_batch(chunk, avg), use_kernels)
            for chunk in images.split(32)])
    torch.cuda.synchronize()
    err = (fc7[True] - fc7[False]).abs().max().item()
    scale = fc7[False].abs().max().item()
    check(err <= FC7_RTOL * scale, f"f32 fc7 kernel vs plain: max |err| "
                                   f"{err} > {FC7_RTOL} x {scale}")
    # The decoder's kernels against its plain path on the same fc7 rows (the
    # kernel path's); the conv kernel is held by the fc7 check above.  End
    # to end (kernel fc7 and decoder kernels against plain fc7 and plain
    # decoder) is printed, not held: two fc7 within FC7_RTOL of each other
    # may tip a near-tie of a random-weight model either way.
    feats_k = l1_normalize(fc7[True])
    tok_k, sc_k = beam_search(dec32, feats_k, beam_width=BEAM,
                              max_words=MAX_WORDS)
    tok_p, sc_p = beam_search(dec32, feats_k, beam_width=BEAM,
                              max_words=MAX_WORDS, use_kernels=False)
    equal, gap, distinct = check_captions(tok_k, sc_k, tok_p, sc_p,
                                          ck32["vocab"], "f32 image decoder")
    tok_e, sc_e = beam_search(dec32, l1_normalize(fc7[False]),
                              beam_width=BEAM, max_words=MAX_WORDS,
                              use_kernels=False)
    end_equal = int((tok_k == tok_e).all(dim=1).sum().item())
    end_gap = (sc_k - sc_e).abs().max().item()
    print(f"[8 images f32] kernel vs plain path over {len(tok_k)} images: "
          f"fc7 max|err| {err:.3g} (tol {FC7_RTOL} x max|fc7| {scale:.3g});"
          f" decoder on the same fc7: {equal}/{len(tok_k)} captions equal "
          f"(need {CAPTION_AGREEMENT}), max score gap {gap:.3g}, {distinct} "
          f"distinct captions; end to end: {end_equal}/{len(tok_k)} equal, "
          f"max score gap {end_gap:.3g}")
    return launches, by_route


def phase_fc7_throughput(rng, smi: str) -> float:
    from lrcn_tpu_torch.data.images import normalize_and_fc7
    from lrcn_tpu_torch.ops.kernels import fused_conv3x3_relu
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    ck = load_checkpoint(os.path.join(WORK, "joint"), device="cuda")
    vgg = ck["vgg"]
    avg = torch.from_numpy(ck["average_image"]).cuda()
    images = torch.from_numpy(rng.integers(
        0, 256, (FC7_GROUPS, FC7_BATCH, 224, 224, 3), np.uint8)).cuda()
    rates, fc7 = {}, {}
    for use_kernels in (True, False):
        # the plain path (~9x slower) runs the first FC7_PLAIN_GROUPS groups
        groups = FC7_GROUPS if use_kernels else FC7_PLAIN_GROUPS
        run = lambda: normalize_and_fc7(vgg, images[:groups], avg,
                                        use_kernels)
        run(), run().sum().item()   # warm up: eagerly, then captured
        iters = 2
        reset_counts(fused_conv3x3_relu)
        t0 = time.perf_counter()
        for _ in range(iters):
            feats = run()
        feats.sum().item()
        dt = time.perf_counter() - t0
        check(feats.shape == (groups, FC7_BATCH, CNN_DIM)
              and bool(torch.isfinite(feats).all()), "fc7 not finite")
        rates[use_kernels] = iters * groups * FC7_BATCH / dt
        fc7[use_kernels] = feats
        routes = dict(fused_conv3x3_relu.launches_by_route)
        batches = iters * groups if use_kernels else 0
        check(routes["wgmma"] == 12 * batches and routes["scalar"] == batches
              and fused_conv3x3_relu.launches == 13 * batches,
              f"fc7 {'kernel' if use_kernels else 'plain'} path: conv "
              f"launches by route {routes} for {batches} batches")
        print(f"[9 fc7 throughput] {groups}x{FC7_BATCH} uint8 images, "
              f"bf16, {'kernel' if use_kernels else 'plain'} path: "
              f"{rates[use_kernels]:.1f} images/s ({dt / iters * 1e3:.1f} "
              f"ms per call) on {smi}; conv launches by route {routes}")
    err = (fc7[True][:FC7_PLAIN_GROUPS] - fc7[False]).abs().max().item()
    scale = fc7[False].abs().max().item()
    check(err <= FC7_BF16_RTOL * scale, f"bf16 fc7 kernel vs plain: max "
                                        f"|err| {err} > {FC7_BF16_RTOL} x "
                                        f"{scale}")
    print(f"[9 fc7 throughput] bf16 fc7 kernel vs plain path over "
          f"{FC7_PLAIN_GROUPS * FC7_BATCH} images: max|err| {err:.3g} (tol "
          f"{FC7_BF16_RTOL} x max|fc7| {scale:.3g})")
    return rates[True]


def learnable_set():
    """``tests/test_train.py``'s synthetic set: 12 images, three captions,
    each a function of its 24-dim feature."""
    from lrcn_tpu_torch.core.tokenizer import Caption
    from lrcn_tpu_torch.core.vocab import Vocab
    from lrcn_tpu_torch.data.feature_store import FeatureStore

    rng = np.random.default_rng(SEED)
    vocab = Vocab([f"w{i}" for i in range(15)])
    texts = [("w0", "w1", "w2"), ("w3", "w4", "w5", "w6"), ("w7", "w8")]
    caps, store = [], FeatureStore(dim=24)
    for i in range(12):
        caps.append(Caption(i, texts[i % 3]))
        feat = np.zeros(24, np.float32)
        feat[(i % 3) * 8:(i % 3 + 1) * 8] = 1.0
        store.add(i, feat + rng.normal(scale=0.01, size=24).astype(
            np.float32))
    return vocab, caps, store


def train_setup():
    """A trainer at the reference width (K=8, dropout 0.4, bf16) on the
    card, its parameters and optimizer, 6 dispatches of synthetic batches
    (random words, lengths 10-20) and a 10,000-row feature store."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.core.vocab import Vocab
    from lrcn_tpu_torch.data.batcher import Batch
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.train.metrics import MetricsLogger
    from lrcn_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(SEED + 4)
    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB, dropout=TRAIN_DROPOUT,
                     compute_dtype="bfloat16", seed=SEED + 1)
    store = FeatureStore(dim=CNN_DIM, normalized=True)
    raw = np.abs(rng.standard_normal((TRAIN_ROWS, CNN_DIM), np.float32))
    for i, row in enumerate(raw / raw.sum(axis=1, keepdims=True)):
        store.add(i, row)
    batches = []
    for _ in range((1 + TRAIN_DISPATCHES) * TRAIN_K):
        lengths = rng.integers(10, TRAIN_LEN + 1, TRAIN_BATCH).astype(
            np.int32)
        tokens = rng.integers(3, VOCAB, (TRAIN_BATCH, TRAIN_LEN)).astype(
            np.int32)
        tokens[np.arange(TRAIN_LEN)[None, :] >= lengths[:, None]] = 0
        batches.append(Batch(rng.integers(0, TRAIN_ROWS, TRAIN_BATCH),
                             tokens, lengths))
    vocab = Vocab([f"word{i}" for i in range(VOCAB - 3)])
    trainer = Trainer(cfg, vocab, metrics=MetricsLogger(echo=False),
                      device="cuda", steps_per_dispatch=TRAIN_K)
    params, opt = trainer.init(SEED)
    return trainer, params, opt, batches, store


def train_step_flops(b_dim: int, t_dim: int) -> float:
    """Operations of one training step at the reference width: 2 per
    multiply-add, x3 for forward and backward, over the T*B positions
    (layer-1 input and recurrent products, the factor projection, layer
    2, the output projection) and the B rows of the CNN projection."""
    h1, h2 = HIDDEN
    f = -(-h2 // 2)
    per_position = (EMBED * 4 * h1 + h1 * 4 * h1 + h1 * f
                    + (2 * f + h2) * 4 * h2 + h2 * VOCAB)
    return 3 * 2 * (t_dim * b_dim * per_position + b_dim * CNN_DIM * f)


def narrow_step(device: str, tree: dict, batch, masks, dtype):
    """One loss and gradient of the narrow model on ``device``."""
    from lrcn_tpu_torch.models import lrcn
    from lrcn_tpu_torch.models.lrcn import PARAM_KEYS, LRCNParams

    params = LRCNParams.from_numpy(tree, device)
    tokens, lengths, feats = (torch.from_numpy(a).to(device) for a in batch)
    loss = lrcn.loss_fn(params, tokens, lengths, feats, pdrop=TRAIN_DROPOUT,
                        drop_masks=tuple(m.to(device) for m in masks),
                        compute_dtype=dtype)
    loss.backward()
    return loss.item(), {k: params[k].grad.cpu() for k in PARAM_KEYS}


def phase_train_narrow() -> None:
    """One step of the narrow model on the card against the CPU: f32 (TF32
    off) and bf16, dropout masks shared."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.models import lrcn

    cfg = LRCNConfig(**NARROW)
    tree = lrcn.flat_tree(lrcn.init_params(
        cfg, torch.Generator().manual_seed(SEED)))
    rng = np.random.default_rng(SEED + 5)
    lengths = rng.integers(1, NARROW_LEN + 1, NARROW_BATCH).astype(np.int32)
    lengths[-2:] = -1                       # filler rows, as the batcher pads
    tokens = rng.integers(3, cfg.vocab_size, (NARROW_BATCH, NARROW_LEN)
                          ).astype(np.int32)
    feats = rng.standard_normal((NARROW_BATCH, cfg.cnn_feature_dim)
                                ).astype(np.float32)
    masks = lrcn.dropout_masks(
        (NARROW_LEN + 1, NARROW_BATCH, cfg.embed),
        (NARROW_LEN + 1, NARROW_BATCH, 2 * cfg.factor_dim), TRAIN_DROPOUT,
        torch.Generator().manual_seed(SEED))
    batch = (tokens, lengths, feats)
    for dtype, loss_rtol, grad_rtol in (
            (torch.float32, TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL),
            (torch.bfloat16, TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GRAD_RTOL)):
        card_loss, card = narrow_step("cuda", tree, batch, masks, dtype)
        cpu_loss, cpu = narrow_step("cpu", tree, batch, masks, dtype)
        loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
        errs = {k: ((card[k] - cpu[k]).abs().max()
                    / cpu[k].abs().max().clamp_min(1e-30)).item()
                for k in cpu}
        worst = max(errs, key=errs.get)
        label = str(dtype).replace("torch.", "")
        check(loss_err <= loss_rtol, f"narrow {label} step: loss {card_loss} "
                                     f"on the card, {cpu_loss} on the CPU")
        check(errs[worst] <= grad_rtol, f"narrow {label} step: gradient of "
                                        f"{worst} off by {errs[worst]:.3g} "
                                        f"of its largest entry")
        print(f"[10 train] narrow {label} step (hidden {NARROW['hidden']}, "
              f"B={NARROW_BATCH}, L={NARROW_LEN}, 2 filler rows, dropout "
              f"{TRAIN_DROPOUT}) card vs CPU: loss {card_loss:.6f} vs "
              f"{cpu_loss:.6f} (rel {loss_err:.3g}, tol {loss_rtol}); worst "
              f"gradient {worst} {errs[worst]:.3g} of its largest entry "
              f"(tol {grad_rtol})")


def phase_train_learn() -> None:
    """``Trainer.fit`` on the learnable set on the card: the loss falls,
    the checkpoint loads and captions its images through the kernels, and
    a run interrupted after a mid-epoch save and resumed ends where the
    uninterrupted run ends."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.data.batcher import bucket_batches
    from lrcn_tpu_torch.decode.beam import search
    from lrcn_tpu_torch.decode.writer import detokenize_batch
    from lrcn_tpu_torch.models.lrcn import PARAM_KEYS
    from lrcn_tpu_torch.ops.kernels import fused_lstm_step, topk_logsumexp
    from lrcn_tpu_torch.train import trainer as trainer_mod
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint
    from lrcn_tpu_torch.train.metrics import MetricsLogger

    vocab, caps, store = learnable_set()
    cfg = LRCNConfig(hidden=(64, 64), embed=64, cnn_feature_dim=24,
                     vocab_size=len(vocab), batch_size=4, dropout=0.0,
                     lr=1e-2, seed=11)
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    trainer = trainer_mod.Trainer(cfg, vocab, MetricsLogger(echo=False),
                                  device="cuda")
    params, opt = trainer.init(SEED)
    loss0 = trainer.average_loss(params, batches, store)
    path = os.path.join(WORK, "train_ckpt")
    t0 = time.perf_counter()
    trainer.fit(params, opt, batches, batches, store, store, 1, epochs=60,
                eval_train_loss=False, savefile=path)
    fit_s = time.perf_counter() - t0
    loss1 = trainer.average_loss(params, batches, store)
    check(loss1 < LEARN_SHARE * loss0, f"learnable set: loss {loss0:.4f} -> "
                                       f"{loss1:.4f}")
    ck = load_checkpoint(path, device="cuda")
    check(ck["epoch"] == 60 and ck["opt_leaves"] is not None
          and len(ck["opt_leaves"]) == 19, "learnable set: checkpoint")
    ids = [c.image_id for c in caps]
    feats = torch.from_numpy(store.gather(ids)).cuda()
    reset_counts(fused_lstm_step, topk_logsumexp)
    tokens, _ = search(ck["decoder"], feats, beam_width=BEAM,
                       max_words=MAX_WORDS)
    lines = detokenize_batch(tokens.cpu().numpy(), vocab)
    launched = (fused_lstm_step.launches, topk_logsumexp.launches)
    want = [" ".join(c.words) + " ." for c in caps]
    right = sum(a == b for a, b in zip(lines, want))
    check(launched == (2 * (MAX_WORDS + 1), MAX_WORDS + 1),
          f"learnable set: search launched {launched}")
    check(right == len(want), f"learnable set: {right}/{len(want)} captions "
                              f"right: {lines}")
    print(f"[10 train] learnable set (hidden (64, 64), 12 images, bf16): "
          f"Trainer.fit 60 epochs x {len(batches)} steps in {fit_s:.2f} s, "
          f"loss {loss0:.4f} -> {loss1:.4f} (need < {LEARN_SHARE} x); "
          f"checkpoint epoch {ck['epoch']}, 19 optimizer leaves; beam-"
          f"{BEAM} search through the kernels (launches LSTM, top-k "
          f"{launched}): {right}/{len(want)} captions right, e.g. "
          f"{lines[0]!r}")

    # interrupted after its second mid-epoch save, then resumed
    cfg_drop = dataclasses.replace(cfg, dropout=TRAIN_DROPOUT)
    make = lambda: trainer_mod.Trainer(cfg_drop, vocab,
                                       MetricsLogger(echo=False),
                                       device="cuda", steps_per_dispatch=2)
    t = make()
    full, _ = t.fit(*t.init(SEED), batches, None, store, None, 1, epochs=3,
                    eval_train_loss=False)

    class Interrupted(Exception):
        pass

    real_save, saves = trainer_mod.save_checkpoint, []

    def save_then_stop(*args, **kwargs):
        real_save(*args, **kwargs)
        if kwargs.get("position") is not None:
            saves.append(1)
            if len(saves) == 2:
                raise Interrupted()

    path = os.path.join(WORK, "resume_ckpt")
    trainer_mod.save_checkpoint = save_then_stop
    try:
        t = make()
        t.fit(*t.init(SEED), batches, None, store, None, 1, epochs=3,
              eval_train_loss=False, savefile=path, ckpt_every=1)
        check(False, "the interrupted run was not interrupted")
    except Interrupted:
        pass
    finally:
        trainer_mod.save_checkpoint = real_save
    ck = load_checkpoint(path, device="cuda")
    t = make()
    resumed, _ = t.fit(*t.restore(ck["params"], ck["opt_leaves"]), batches,
                       None, store, None, 1, epochs=3, eval_train_loss=False,
                       resume_position=ck["position"])
    errs = {k: ((resumed[k] - full[k]).abs().max()
                / full[k].abs().max()).item() for k in PARAM_KEYS}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= RESUME_RTOL, f"resumed run: {worst} off by "
                                      f"{errs[worst]:.3g}")
    print(f"[10 train] mid-epoch resume (dropout {TRAIN_DROPOUT}, 2 steps a "
          f"dispatch, 3 epochs, interrupted after the save at epoch "
          f"{ck['position']['epoch']} dispatch {ck['position']['dispatch']}): "
          f"largest difference from the uninterrupted run {errs[worst]:.3g} "
          f"of its entry ({worst}; tol {RESUME_RTOL}); bit-equal: "
          f"{all(torch.equal(resumed[k], full[k]) for k in PARAM_KEYS)}")


def phase_train(smi: str) -> None:
    """Training at the reference width: ms per step, words/s, peak memory
    and the bound; then the narrow and learnable-set checks."""
    from lrcn_tpu_torch.models import lrcn
    from lrcn_tpu_torch.ops import lstm
    from lrcn_tpu_torch.ops.kernels import (conv3x3_relu_reference,
                                            fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)

    # does cuBLAS's f32-out bf16 product carry a gradient here?  (the port
    # goes through its own autograd Function either way)
    a = torch.ones((2, 2), device="cuda", dtype=torch.bfloat16,
                   requires_grad=True)
    try:
        torch.mm(a, a.detach(), out_dtype=torch.float32).sum().backward()
        mm_grad = "yes"
    except RuntimeError as e:
        mm_grad = f"no ({str(e).splitlines()[0][:60]})"
    a.grad = None
    lstm.matmul(a, a.detach()).sum().backward()
    check(a.grad is not None and a.grad.dtype == torch.bfloat16,
          "the bf16 CUDA matmul carries no gradient")

    trainer, params, opt, batches, store = train_setup()
    key, shuffle = 1, np.random.default_rng(SEED)
    for _ in range(2):      # warm-up: the first dispatch runs eagerly, the
        trainer.train_epoch(params, opt, batches[:TRAIN_K], store, key,
                            shuffle, log_every=0)   # second captures
    timed = batches[TRAIN_K:]
    words = int(sum(np.maximum(b.lengths, 0).sum() for b in timed))
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fused_lstm_step, topk_logsumexp, fused_conv3x3_relu)
    t0 = time.perf_counter()
    trainer.train_epoch(params, opt, timed, store, key, shuffle, log_every=0)
    dt = time.perf_counter() - t0               # train_epoch synchronizes
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    check(sum(counts.values()) == 0, f"training launched hand-written "
                                     f"kernels: {counts}")
    loss = trainer.average_loss(params, batches[:TRAIN_K], store)
    check(np.isfinite(loss) and all(torch.isfinite(params[k]).all()
                                    for k in params),
          f"training at the reference width: loss {loss}")
    steps = len(timed)
    ms = dt / steps * 1e3
    RESULTS["train_ms"] = ms
    flops = train_step_flops(TRAIN_BATCH, TRAIN_LEN + 1)
    # bytes: the f32 parameters, their gradients and Adam's two moments,
    # each read and written once a step, beside the products' operations
    nbytes = 8 * 4 * lrcn.param_count(params)
    bnd, by = bound(nbytes, flops, "bf16")
    print(f"[10 train] reference width (hidden {HIDDEN}, embed {EMBED}, "
          f"vocab {VOCAB}, {lrcn.param_count(params):,} parameters), bf16, "
          f"B={TRAIN_BATCH}, L={TRAIN_LEN}, lengths 10-{TRAIN_LEN}, dropout "
          f"{TRAIN_DROPOUT}, K={TRAIN_K} steps a dispatch, "
          f"{TRAIN_ROWS}-row table on the card: {ms:.3f} ms per step, "
          f"{words / dt:.1f} words/s over {TRAIN_DISPATCHES} dispatches "
          f"({steps} steps, {dt:.3f} s) on {smi}; peak memory "
          f"{peak / 2**30:.3f} GiB; bound {bnd:.4f} ms ({by}: "
          f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s, {nbytes / 1e9:.2f} GB "
          f"at 3.35 TB/s), {bnd / ms:.1%} of it; no hand-written kernel "
          f"launched; loss after {steps + TRAIN_K} steps {loss:.4f}; "
          f"torch.mm(out_dtype=f32) has a derivative: {mm_grad}")
    del trainer, params, opt, store
    phase_train_narrow()
    phase_train_learn()
    return counts


def phase_sample(smi: str) -> dict:
    """Best-of-100 sampling of 256 images at the reference width, bf16,
    through the LSTM kernel; then kernel vs plain path at f32 with the same
    Gumbel noise."""
    from lrcn_tpu_torch.core.vocab import BOS_ID
    from lrcn_tpu_torch.decode.sample import best_of_n_search, gumbel_noise
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    ck = load_checkpoint(os.path.join(WORK, "ckpt"), device="cuda")
    rng = np.random.default_rng(SEED + 6)
    raw = np.abs(rng.standard_normal((SAMPLE_IMAGES, CNN_DIM), np.float32))
    feats = torch.from_numpy(raw / raw.sum(axis=1, keepdims=True)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    run = lambda: best_of_n_search(
        ck["decoder"], feats, n_samples=SAMPLE_N, temperature=SAMPLE_T,
        max_words=MAX_WORDS, generator=gen)
    run()[0].cpu()          # warm up: the first call runs eagerly, the
    run()[0].cpu()          # second captures
    iters = 3
    reset_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens, scores = run()
    tokens = tokens.cpu()
    dt = time.perf_counter() - t0
    counts = read_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    launches = counts["fused_lstm_step"]
    routes = dict(fused_lstm_step.launches_by_route)
    steps = MAX_WORDS + 1
    check(launches == 2 * steps * iters and routes["wgmma"] == launches,
          f"sampling: LSTM launches {launches} by route {routes} in {iters} "
          f"searches of {steps} steps")
    check(counts["topk_logsumexp"] == counts["fused_conv3x3_relu"] == 0,
          f"sampling launched the top-k or conv kernel: {counts}")
    check(tokens.shape == (SAMPLE_IMAGES, MAX_WORDS + 2)
          and bool((tokens[:, 0] == BOS_ID).all())
          and bool(torch.isfinite(scores).all()), "sampling: malformed result")
    rate = iters * SAMPLE_IMAGES / dt
    print(f"[11 sample] best-of-{SAMPLE_N} at T={SAMPLE_T}, "
          f"{SAMPLE_IMAGES} images ({SAMPLE_IMAGES * SAMPLE_N} rows), "
          f"max_words {MAX_WORDS}, bf16: {rate:.1f} captions/s "
          f"({dt / iters * 1e3:.1f} ms per search) on {smi}; LSTM kernel "
          f"launches {launches // iters} a search, by route {routes}")

    # kernel path against plain path in f32, TF32 off, the same noise
    dec32 = load_checkpoint(os.path.join(WORK, "ckpt"), device="cuda",
                            compute_dtype=torch.float32)["decoder"]
    rows = SAMPLE_IMAGES * SAMPLE_F32_N
    noise = gumbel_noise((steps, rows, VOCAB), gen)
    out = {use: best_of_n_search(dec32, feats, n_samples=SAMPLE_F32_N,
                                 temperature=SAMPLE_T, max_words=MAX_WORDS,
                                 gumbel=noise, use_kernels=use)
           for use in (True, False)}
    equal, gap, distinct = check_captions(*out[True], *out[False],
                                          ck["vocab"], "f32 sampling")
    print(f"[11 sample f32] best-of-{SAMPLE_F32_N}, kernel vs plain path "
          f"with the same Gumbel noise: {equal}/{SAMPLE_IMAGES} captions "
          f"equal (need {CAPTION_AGREEMENT}); max score gap {gap:.3g}; "
          f"{distinct} distinct captions")
    return {"captions_per_s": rate, "searches": iters, "counts": counts,
            "by_route": routes}


def joint_setup(mesh=None):
    """A joint step at the reference width on the card (full VGG-16, the
    2x1000 decoder, K=4, dropout 0.4, bf16, mean image 117; over ``mesh``
    where given), its parameters and optimizer, and one chunk of K
    synthetic batches."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.models.joint import (JointTrainStep,
                                             make_joint_optimizer)

    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB, dropout=TRAIN_DROPOUT,
                     compute_dtype="bfloat16", seed=SEED + 1)
    avg = np.full((224, 224, 3), JOINT_MEAN, np.float32)
    step = JointTrainStep(cfg, make_joint_optimizer(cfg), remat_cnn=True,
                          average_image=avg, device="cuda", mesh=mesh)
    params, opt_state = step.init(SEED)
    rng = np.random.default_rng(SEED + 7)
    k, b, l = JOINT_K, JOINT_BATCH, JOINT_LEN
    images = rng.integers(0, 256, (k, b, 224, 224, 3), np.uint8)
    lengths = rng.integers(10, l + 1, (k, b)).astype(np.int32)
    tokens = rng.integers(3, VOCAB, (k, b, l)).astype(np.int32)
    tokens[np.arange(l)[None, None, :] >= lengths[..., None]] = 0
    return step, params, opt_state, step.shard_chunk(images, tokens, lengths)


def joint_images() -> tuple[np.ndarray, list]:
    """The joint learnable set: 12 uint8 images of three kinds (a red, a
    green and a blue field with noise), each kind its caption of
    ``learnable_set``'s."""
    from lrcn_tpu_torch.core.tokenizer import Caption

    rng = np.random.default_rng(SEED + 8)
    texts = [("w0", "w1", "w2"), ("w3", "w4", "w5", "w6"), ("w7", "w8")]
    images = rng.integers(0, 60, (12, 224, 224, 3)).astype(np.uint8)
    for i in range(12):
        images[i, :, :, i % 3] += 180
    return images, [Caption(i, texts[i % 3]) for i in range(12)]


def joint_narrow_step(device: str, tree: dict, batch, masks) -> tuple:
    """One f32 loss and gradient of the narrow joint model on ``device``."""
    from lrcn_tpu_torch.models.joint import JointParams, joint_loss
    from lrcn_tpu_torch.train.joint import load_joint_params

    params = load_joint_params(tree, device)
    images, tokens, lengths = (torch.from_numpy(a).to(device) for a in batch)
    loss = joint_loss(params, images.float() - JOINT_MEAN, tokens, lengths,
                      pdrop=TRAIN_DROPOUT,
                      drop_masks=tuple(m.to(device) for m in masks),
                      compute_dtype=torch.float32)
    loss.backward()
    grads = {f"{part}/{k}": p.grad.cpu()
             for part, ps in zip(JointParams._fields, params)
             for k, p in ps.items()}
    return loss.item(), grads


def phase_joint_narrow(cfg, tree) -> None:
    """One f32 narrow joint step on the card against the CPU (dropout
    masks shared), and a step with the CNN frozen under the clip."""
    from lrcn_tpu_torch.models import lrcn
    from lrcn_tpu_torch.models.joint import (JointTrainStep,
                                             make_joint_optimizer)
    from lrcn_tpu_torch.train.joint import load_joint_params

    rng = np.random.default_rng(SEED + 9)
    b, l = JOINT_NARROW_BATCH, 8
    images = rng.integers(0, 256, (b, 224, 224, 3)).astype(np.uint8)
    lengths = rng.integers(1, l + 1, b).astype(np.int32)
    lengths[-1] = -1                        # a filler row, as batches pad
    tokens = rng.integers(3, cfg.vocab_size, (b, l)).astype(np.int32)
    masks = lrcn.dropout_masks((l + 1, b, cfg.embed),
                               (l + 1, b, 2 * cfg.factor_dim), TRAIN_DROPOUT,
                               torch.Generator().manual_seed(SEED))
    batch = (images, tokens, lengths)
    card_loss, card = joint_narrow_step("cuda", tree, batch, masks)
    cpu_loss, cpu = joint_narrow_step("cpu", tree, batch, masks)
    loss_err = abs(card_loss - cpu_loss) / abs(cpu_loss)
    errs = {k: ((card[k] - cpu[k]).abs().max()
                / cpu[k].abs().max().clamp_min(1e-30)).item() for k in cpu}
    worst = max(errs, key=errs.get)
    rest = max(v for k, v in errs.items()
               if not (k.startswith("cnn/") and k.endswith("/b")))
    print(f"[12 joint] narrow f32 step (VGG width "
          f"{JOINT_NARROW_VGG['width_multiplier']}, fc "
          f"{JOINT_NARROW_VGG['fc_dim']}, hidden {cfg.hidden}, B={b}, 1 "
          f"filler row, dropout {TRAIN_DROPOUT}) card vs CPU: loss "
          f"{card_loss:.6f} vs {cpu_loss:.6f} (rel {loss_err:.3g}, tol "
          f"{JOINT_LOSS_RTOL}); worst of 39 gradients {worst} "
          f"{errs[worst]:.3g} of its largest entry (tol {JOINT_GRAD_RTOL}),"
          f" worst but the conv biases' {rest:.3g}")
    check(len(errs) == 39 and loss_err <= JOINT_LOSS_RTOL,
          f"narrow joint step: loss {card_loss} on the card, {cpu_loss} on "
          f"the CPU")
    check(errs[worst] <= JOINT_GRAD_RTOL, f"narrow joint step: gradient of "
                                          f"{worst} off by {errs[worst]:.3g}")

    # the CNN frozen under the clip: its gradient enters the global norm,
    # and it stays bit-equal
    frozen = dataclasses.replace(cfg, gclip=0.05, dropout=0.0)
    step = JointTrainStep(frozen, make_joint_optimizer(frozen,
                                                       freeze_cnn=True),
                          average_image=np.full((224, 224, 3), JOINT_MEAN,
                                                np.float32), device="cuda")
    params = load_joint_params(tree, "cuda")
    state = step.opt.init(params)
    before = {k: p.detach().clone() for k, p in params.cnn.items()}
    dec_before = params.decoder["w_out"].detach().clone()
    step(params, state, *step.shard_batch(*batch), 0)
    check(len(state.grad_params()) == 39
          and all(torch.equal(params.cnn[k], v) for k, v in before.items())
          and len(state.state_leaves()) == 19
          and not torch.equal(params.decoder["w_out"], dec_before),
          "freeze: the CNN moved, or the decoder did not")
    print("[12 joint] freeze_cnn step under gclip 0.05: the CNN's 30 "
          "tensors bit-equal, the decoder moved, 19 optimizer leaves")


def phase_joint_learn(cfg, vocab) -> dict:
    """``JointTrainer.fit`` on the learnable set: the loss falls below a
    fifth of its start; an interrupted and resumed run against the
    uninterrupted one (cuDNN deterministic); the fine-tuned checkpoint
    served by image through the three kernels.  Returns the serving
    path's launch counts."""
    from lrcn_tpu_torch.data.batcher import bucket_batches
    from lrcn_tpu_torch.evaluation.bleu import multi_bleu
    from lrcn_tpu_torch.native import bleu_library, imageloader_library
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.models.vgg import CONV_NAMES
    from lrcn_tpu_torch.serve import CaptionService
    from lrcn_tpu_torch.train import joint as joint_mod
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint
    from lrcn_tpu_torch.train.metrics import MetricsLogger

    images, caps = joint_images()
    by_id = {c.image_id: images[c.image_id] for c in caps}

    class ArrayTrainer(joint_mod.JointTrainer):
        """The joint trainer fed arrays by id (no image files here)."""

        def _load_images(self, batch):
            return np.stack([by_id[int(i)] for i in batch.image_ids])

    avg = np.full((224, 224, 3), JOINT_MEAN, np.float32)
    batches = bucket_batches(caps, vocab, cfg.batch_size,
                             apply_small_dataset_rule=False)
    make = lambda c, k=1: ArrayTrainer(c, vocab, {}, avg,
                                       MetricsLogger(echo=False),
                                       cnn_lr=JOINT_CNN_LR,
                                       steps_per_dispatch=k, device="cuda")
    trainer = make(cfg)
    params, opt_state = trainer.init(SEED, vgg_params=_narrow_vgg())
    conv_before = params.cnn["conv3_1/w"].detach().clone()
    loss0 = trainer.average_loss(params, batches)
    path = os.path.join(WORK, "joint_ckpt")
    os.makedirs(path)
    np.save(os.path.join(path, "average_image.npy"), avg)
    t0 = time.perf_counter()
    trainer.fit(params, opt_state, batches, batches, 1, epochs=JOINT_EPOCHS,
                savefile=path)
    fit_s = time.perf_counter() - t0
    loss1 = trainer.average_loss(params, batches)
    moved = (params.cnn["conv3_1/w"] - conv_before).abs().max().item()
    check(loss1 < LEARN_SHARE * loss0 and moved > 0,
          f"joint learnable set: loss {loss0:.4f} -> {loss1:.4f}, the CNN "
          f"moved {moved}")
    print(f"[12 joint] learnable set (12 images of 3 colours, VGG width "
          f"{JOINT_NARROW_VGG['width_multiplier']}, hidden {cfg.hidden}, "
          f"bf16, B={cfg.batch_size}, lr {cfg.lr}, CNN lr {JOINT_CNN_LR}): "
          f"JointTrainer.fit {JOINT_EPOCHS} epochs x {len(batches)} steps in "
          f"{fit_s:.2f} s, loss {loss0:.4f} -> {loss1:.4f} (need < "
          f"{LEARN_SHARE} x); conv3_1/w moved up to {moved:.3g}")

    # interrupted after its second mid-epoch save, then resumed, with
    # cuDNN's deterministic algorithms (its weight-gradient algorithms may
    # otherwise add in another order from run to run)
    torch.backends.cudnn.deterministic = True
    try:
        cfg_drop = dataclasses.replace(cfg, dropout=TRAIN_DROPOUT)
        t = make(cfg_drop, 2)
        full, _ = t.fit(*t.init(SEED, vgg_params=_narrow_vgg()), batches,
                        None, 1, epochs=3)

        class Interrupted(Exception):
            pass

        real_save, saves = joint_mod.save_checkpoint, []

        def save_then_stop(*args, **kwargs):
            real_save(*args, **kwargs)
            if kwargs.get("position") is not None:
                saves.append(1)
                if len(saves) == 2:
                    raise Interrupted()

        rpath = os.path.join(WORK, "joint_resume")
        joint_mod.save_checkpoint = save_then_stop
        try:
            t = make(cfg_drop, 2)
            t.fit(*t.init(SEED, vgg_params=_narrow_vgg()), batches, None, 1,
                  epochs=3, savefile=rpath, ckpt_every=1)
            check(False, "the interrupted joint run was not interrupted")
        except Interrupted:
            pass
        finally:
            joint_mod.save_checkpoint = real_save
        ck = load_checkpoint(rpath, device="cuda")
        t = make(cfg_drop, 2)
        resumed, _ = t.fit(*t.restore(ck["params"], ck["opt_leaves"]),
                           batches, None, 1, epochs=3,
                           resume_position=ck["position"])
    finally:
        torch.backends.cudnn.deterministic = False
    pairs = [(f"{part}/{k}", full_set[k], resumed_set[k])
             for part, full_set, resumed_set in zip(("cnn", "decoder"), full,
                                                    resumed)
             for k in full_set.keys()]
    errs = {name: ((b - a).abs().max() / a.abs().max().clamp_min(1e-30)
                   ).item() for name, a, b in pairs}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= RESUME_RTOL, f"resumed joint run: {worst} off by "
                                      f"{errs[worst]:.3g}")
    print(f"[12 joint] mid-epoch resume (dropout {TRAIN_DROPOUT}, 2 steps a "
          f"dispatch, 3 epochs, cudnn.deterministic, interrupted after the "
          f"save at epoch {ck['position']['epoch']} dispatch "
          f"{ck['position']['dispatch']}, {len(ck['opt_leaves'])} optimizer "
          f"leaves): largest difference from the uninterrupted run "
          f"{errs[worst]:.3g} of its entry ({worst}; tol {RESUME_RTOL}); "
          f"bit-equal: {all(torch.equal(a, b) for _, a, b in pairs)}")

    # the fine-tuned checkpoint, served by image through the three kernels
    ck = load_checkpoint(path, device="cuda")
    check(ck["vgg"] is not None and ck["epoch"] == JOINT_EPOCHS
          and len(ck["opt_leaves"]) == 80
          and bool((ck["average_image"] == JOINT_MEAN).all()),
          "joint checkpoint: encoder, epoch, 80 leaves, mean image")
    svc = CaptionService(ck["cfg"], ck["decoder"], ck["vocab"],
                         device="cuda", vgg=ck["vgg"],
                         average_image=ck["average_image"], beam_width=BEAM,
                         max_words=MAX_WORDS, decode_batch=16,
                         encode_batch=ENCODE_BATCH)
    svc.warmup()
    before = {k: v["batches"] for k, v in svc.stats().items()}
    reset_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    lines = svc.caption_images(list(images))
    counts = read_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    routes = {fn.__name__: dict(fn.launches_by_route)
              for fn in (fused_conv3x3_relu, fused_lstm_step,
                         topk_logsumexp)}
    svc.close()
    after = svc.stats()
    encodes = after["encode"]["batches"] - before["encode"]
    searches = after["decode"]["batches"] - before["decode"]
    steps = MAX_WORDS + 1
    want = expected_routes(cfg, [getattr(ck["vgg"], f"{n}_w").shape
                                 for n in CONV_NAMES], 16 * BEAM, BEAM)
    conv_want = _scaled(want["fused_conv3x3_relu"], encodes)
    lstm_want = want["fused_lstm_step"]
    topk_want, = want["topk_logsumexp"]
    got_conv = {r: n for r, n in routes["fused_conv3x3_relu"].items() if n}
    check(encodes == 2 and counts["fused_conv3x3_relu"] == 13 * encodes
          and got_conv == conv_want,
          f"joint service: conv launches {counts['fused_conv3x3_relu']} by "
          f"route {got_conv} in {encodes} encoder batches (want {conv_want})")
    check(searches > 0 and counts["fused_lstm_step"] == 2 * steps * searches
          and set(k for k, n in routes["fused_lstm_step"].items() if n)
          == set(lstm_want),
          f"joint service: LSTM launches {counts['fused_lstm_step']} by "
          f"route {routes['fused_lstm_step']} in {searches} searches")
    check(counts["topk_logsumexp"] == steps * searches
          and routes["topk_logsumexp"][topk_want] == steps * searches,
          f"joint service: top-k launches by route "
          f"{routes['topk_logsumexp']}, want all on {topk_want}")
    want = [" ".join(c.words) + " ." for c in caps]
    right = sum(a == b for a, b in zip(lines, want))
    check(right == len(want), f"joint service: {right}/{len(want)} captions "
                              f"right: {lines}")
    print(f"[12 joint] fine-tuned checkpoint (epoch {ck['epoch']}, 80 "
          f"optimizer leaves, mean image {JOINT_MEAN}) served by image: "
          f"{right}/{len(want)} captions right, {encodes} encoder batches "
          f"of {ENCODE_BATCH}, {searches} search(es); launches {counts}, by "
          f"route {routes}")

    # the host libraries on this machine; native BLEU against Python BLEU
    loader, bleu_lib = imageloader_library(), bleu_library()
    refs = [[w] for w in want]
    hyps = lines[::-1]              # a wrong order, so BLEU is not 1
    note = "not built"
    if bleu_lib is not None:
        native = multi_bleu(hyps, refs)
        saved = os.environ.get("LRCN_NATIVE")
        os.environ["LRCN_NATIVE"] = "0"
        try:
            python = multi_bleu(hyps, refs)
        finally:
            if saved is None:
                del os.environ["LRCN_NATIVE"]
            else:
                os.environ["LRCN_NATIVE"] = saved
        check(native == python, f"native BLEU {native} != Python {python}")
        note = f"native == Python: {native.format()}"
    print(f"[12 joint] host libraries: imageloader "
          f"{'built' if loader is not None else 'not built'}, bleu "
          f"{'built' if bleu_lib is not None else 'not built'}; BLEU of the "
          f"served captions against the set's (reversed): {note}")
    return counts


def _narrow_vgg():
    """The narrow joint model's VGG, drawn from the seed."""
    from lrcn_tpu_torch.models.vgg import init_vgg_params

    return init_vgg_params(torch.Generator().manual_seed(SEED + 2),
                           **JOINT_NARROW_VGG)


def joint_step_flops(b_dim: int, t_dim: int) -> float:
    """Operations of one rematerialised joint step at the reference width:
    4 VGG-16 forwards' worth a image (the forward, its recompute and a
    backward of twice a forward), 2 per multiply-add, and the decoder's
    step (``train_step_flops``)."""
    return b_dim * 4 * 2 * VGG16_MACS + train_step_flops(b_dim, t_dim)


def phase_joint(smi: str) -> dict:
    """Joint fine-tuning at the reference width: ms per step, images/s,
    peak memory with and without remat, the bound, and no hand-written
    kernel launched; then the narrow, freeze and learnable-set checks."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.core.vocab import Vocab
    from lrcn_tpu_torch.models import lrcn, vgg
    from lrcn_tpu_torch.models.joint import JointTrainStep
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.train.trainer import fold_in

    t0 = time.perf_counter()
    step, params, opt_state, chunk = joint_setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    key = 2
    for d in range(2):      # warm-up: the first dispatch runs eagerly, the
        _, _, losses = step.multi_step(     # second captures
            params, opt_state, *chunk, fold_in(key, 100 + d), 0)
    losses.cpu()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fused_lstm_step, topk_logsumexp, fused_conv3x3_relu)
    t0 = time.perf_counter()
    for d in range(JOINT_DISPATCHES):
        _, _, losses = step.multi_step(params, opt_state, *chunk,
                                       fold_in(key, d + 1), 0)
    losses = losses.cpu()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts(fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    check(sum(counts.values()) == 0, f"the joint step launched hand-written "
                                     f"kernels: {counts}")
    check(bool(torch.isfinite(losses).all())
          and all(bool(torch.isfinite(p).all()) for ps in params
                  for p in ps.values()),
          f"joint step at the reference width: losses {losses.tolist()}")
    steps = JOINT_DISPATCHES * JOINT_K
    ms = dt / steps * 1e3
    RESULTS["joint_ms"] = ms
    flops = joint_step_flops(JOINT_BATCH, JOINT_LEN + 1)
    n_params = vgg.vgg_param_count(params.cnn) + lrcn.param_count(
        params.decoder)
    # bytes: the f32 parameters, their gradients and Adam's two moments,
    # each read and written once a step, beside the products' operations
    nbytes = 8 * 4 * n_params
    bnd, by = bound(nbytes, flops, "bf16")

    # the same step without remat: its peak memory and time
    plain = JointTrainStep(step.cfg, step.opt, remat_cnn=False,
                           average_image=np.full((224, 224, 3), JOINT_MEAN,
                                                 np.float32), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    _, _, nr_losses = plain.multi_step(params, opt_state, *chunk,
                                       fold_in(key, 99), 0)
    nr_losses = nr_losses.cpu()
    nr_ms = (time.perf_counter() - t1) / JOINT_K * 1e3
    nr_peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(nr_losses).all()), "joint step without remat")
    print(f"[12 joint] reference width (VGG-16 "
          f"{vgg.vgg_param_count(params.cnn):,} + decoder "
          f"{lrcn.param_count(params.decoder):,} parameters, "
          f"mean image {JOINT_MEAN}), bf16, B={JOINT_BATCH}, L={JOINT_LEN}, "
          f"lengths 10-{JOINT_LEN}, dropout {TRAIN_DROPOUT}, K={JOINT_K} "
          f"steps a dispatch, remat: {ms:.3f} ms per step, "
          f"{JOINT_BATCH / ms * 1e3:.1f} images/s over {JOINT_DISPATCHES} "
          f"dispatches ({steps} steps, {dt:.3f} s) on {smi}; peak memory "
          f"{peak / 2**30:.3f} GiB with remat, {nr_peak / 2**30:.3f} GiB "
          f"without ({nr_ms:.3f} ms per step, one dispatch); bound "
          f"{bnd:.4f} ms ({by}: {flops / 1e12:.2f} TFLOP at 989 TFLOP/s, "
          f"{nbytes / 1e9:.2f} GB at 3.35 TB/s), {bnd / ms:.1%} of it; no "
          f"hand-written kernel launched; losses {losses.tolist()}; set-up "
          f"{setup_s:.1f} s")
    del step, plain, params, opt_state, chunk

    vocab = Vocab([f"w{i}" for i in range(15)])
    cfg = LRCNConfig(**JOINT_NARROW, vocab_size=len(vocab),
                     batch_size=JOINT_NARROW_BATCH, dropout=0.0, lr=1e-2,
                     compute_dtype="float32", seed=11)
    narrow = {**{f"cnn/{k}": v
                 for k, v in lrcn.flat_tree(_narrow_vgg()).items()},
              **{f"decoder/{k}": v for k, v in lrcn.flat_tree(
                  lrcn.init_params(cfg, torch.Generator().manual_seed(
                      SEED))).items()}}
    phase_joint_narrow(cfg, narrow)
    serving = phase_joint_learn(
        dataclasses.replace(cfg, compute_dtype="bfloat16"), vocab)
    return {"step": counts, "serving": serving}


def expected_routes(cfg, convs, rows: int, k: int) -> dict[str, dict]:
    """The launches by route that one decode step over ``rows`` rows at
    beam width ``k`` (two LSTM launches, one top-k launch) and one encoder
    batch of VGG-16 convolutions with the HWIO weight shapes ``convs`` (13
    launches; none for an empty list) should show, from the wrappers'
    routing functions on ``meta`` tensors."""
    from lrcn_tpu_torch.models.vgg import VGG16_LAYOUT
    from lrcn_tpu_torch.ops.kernels.conv3x3 import conv3x3_route
    from lrcn_tpu_torch.ops.kernels.lstm_step import lstm_step_route
    from lrcn_tpu_torch.ops.kernels.topk_lse import topk_lse_route

    meta = lambda *shape: torch.empty(shape, device="meta",
                                      dtype=torch.bfloat16)
    h1, h2 = cfg.hidden
    lstm: dict[str, int] = {}
    for w, h, x in ((meta(cfg.embed + h1, 4 * h1), h1, cfg.embed),
                    (meta(2 * cfg.factor_dim + h2, 4 * h2), h2,
                     2 * cfg.factor_dim)):
        route = lstm_step_route(w, meta(rows, h), meta(rows, h),
                                meta(rows, x))
        lstm[route] = lstm.get(route, 0) + 1
    conv: dict[str, int] = {}
    sizes = []
    size = 224
    for entry in VGG16_LAYOUT:
        if entry == "pool":
            size //= 2
        else:
            sizes.append(size)
    for size, shape in zip(sizes, convs):
        route = conv3x3_route(meta(1, size, size, shape[2]), meta(*shape))
        conv[route] = conv.get(route, 0) + 1
    return {"fused_lstm_step": lstm,
            "topk_logsumexp": {topk_lse_route(meta(rows, cfg.vocab_size),
                                              k): 1},
            "fused_conv3x3_relu": conv}


def _routes_used(fn) -> dict[str, int]:
    return {r: n for r, n in fn.launches_by_route.items() if n}


def _scaled(routes: dict[str, int], n: int) -> dict[str, int]:
    return {r: c * n for r, c in routes.items()}


class CLIRun:
    """Runs ``lrcn_tpu_torch.cli.main`` in this process: zeroes the three
    kernels' counters before a command and reads them, with the launches
    by route, after it; captures the command's standard output."""

    def __init__(self):
        from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                                fused_lstm_step,
                                                topk_logsumexp)

        self.fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
        self.counts: dict[str, dict] = {}
        self.routes: dict[str, dict] = {}

    def __call__(self, path: str | None, argv: list, device_flags=None
                 ) -> tuple[str, float]:
        import contextlib
        import io

        from lrcn_tpu_torch import cli

        flags = CLI_DEVICE_FLAGS if device_flags is None else device_flags
        out = io.StringIO()
        reset_counts(*self.fns)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*flags, *argv])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        check(rc == 0, f"lrcn-torch {argv[0]} returned {rc}")
        if path is not None:
            self.counts[path] = read_counts(*self.fns)
            self.routes[path] = {fn.__name__: _routes_used(fn)
                                 for fn in self.fns}
        return out.getvalue(), seconds


def cli_data(work: str, rng: np.random.Generator) -> dict:
    """A learnable Flickr-style set: ``CLI_IMAGES`` images, each of one of
    ``CLI_CLASSES`` classes, whose fc7 rows carry the class (a band of
    columns far above the noise: half of a row's mass) and whose first
    four captions are the class's own, the fifth random words, so that
    every one of the ``VOCAB - 3``
    words occurs (``--vocab-min-count 1`` gives a vocabulary of
    ``VOCAB``).  Writes the .token file and Karpathy's ``vgg_feats.mat``
    (``CNN_DIM`` x N) and ``dataset.json``."""
    from scipy.io import savemat

    n_words = VOCAB - 3
    lo, hi = CLI_CAPTION_LEN
    classes = rng.integers(0, CLI_CLASSES, CLI_IMAGES)
    templates = [" ".join(f"w{w}" for w in rng.integers(
        0, n_words, rng.integers(lo, hi + 1))) for _ in range(CLI_CLASSES)]
    lengths = rng.integers(lo, hi + 1, CLI_IMAGES)
    words = rng.integers(0, n_words, int(lengths.sum()))
    words[:n_words] = np.arange(n_words)           # every word occurs
    ends = np.cumsum(lengths)
    token = os.path.join(work, "results.token")
    with open(token, "w") as f:
        for i, (a, b) in enumerate(zip(ends - lengths, ends)):
            noise = " ".join(f"w{w}" for w in words[a:b])
            for j, caption in enumerate([templates[classes[i]]] * 4
                                        + [noise]):
                f.write(f"{10000 + i}.jpg#{j}\t{caption} .\n")
    feats = np.abs(rng.standard_normal((CNN_DIM, CLI_IMAGES), np.float32))
    band = CNN_DIM // CLI_CLASSES
    for c in range(CLI_CLASSES):
        feats[c * band:(c + 1) * band, classes == c] += 40.0
    mat = os.path.join(work, "vgg_feats.mat")
    savemat(mat, {"feats": feats})
    dataset = os.path.join(work, "dataset.json")
    with open(dataset, "w") as f:
        json.dump({"images": [{"imgid": i, "filename": f"{10000 + i}.jpg"}
                              for i in range(CLI_IMAGES)]}, f)
    return {"token": token, "mat": mat, "dataset": dataset,
            "feats": feats}


@contextmanager
def synthetic_pixels(pixels: dict[int, np.ndarray]):
    """Replace the host image decode with arrays by image id: the card's
    machine has neither PIL nor libjpeg.  Inside this block
    ``data.images.load_images``, ``preprocess`` and ``load_blobs`` and
    ``JointTrainer._load_images`` return ``pixels[id]``, the id parsed
    from the file name (or, for a blob, its decimal text)."""
    from lrcn_tpu_torch.cli import image_id_from_filename
    from lrcn_tpu_torch.data import images
    from lrcn_tpu_torch.train import joint

    def load_images(paths):
        return np.stack([pixels[image_id_from_filename(p)] for p in paths])

    def preprocess(path, average_image, device="cuda"):
        img = torch.from_numpy(load_images([path])).to(device)
        avg = torch.from_numpy(np.asarray(average_image, np.float32))
        return images.normalize_batch(img, avg.to(device))

    def load_blobs(blobs):
        return (np.stack([pixels[int(b)] for b in blobs]),
                np.ones(len(blobs), bool))

    def load_batch(self, batch):
        return np.stack([pixels[int(i)] for i in batch.image_ids])

    saved = [(images, "load_images"), (images, "preprocess"),
             (images, "load_blobs"), (joint.JointTrainer, "_load_images")]
    saved = [(obj, name, getattr(obj, name)) for obj, name in saved]
    images.load_images, images.preprocess = load_images, preprocess
    images.load_blobs, joint.JointTrainer._load_images = load_blobs, \
        load_batch
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


@contextmanager
def timed(owner, name: str, log: list):
    """Append (seconds, first argument's length) of every call of
    ``owner.name`` to ``log``, the device synchronised at both ends."""
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out

    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, real)


def f32_card_against_cpu(run: CLIRun, gen: list, n_ids: int, loadfile: str,
                         store, beam: int, max_words: int, prefix: str,
                         score_atol: float) -> tuple[list, list, list]:
    """``generate`` (the argv ``gen``, which captions ``n_ids`` ids) of the
    checkpoint ``loadfile`` at f32 on the card (kernels) and with
    ``--device cpu`` (plain): ``n_ids`` lines from each, the same ids, at
    least CAPTION_AGREEMENT of the lines equal,
    and every line that differs a near-tie, the same search by hand on
    both devices giving scores within ``score_atol``.  Returns the card's
    lines, the indices that differ and their score gaps."""
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.decode.writer import detokenize_batch
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    out = {}
    for where, flags in (("card", None), ("cpu", ["--device", "cpu"])):
        path = f"{prefix}_{where}"
        run(None, [*gen, "--loadfile", loadfile, "--compute-dtype",
                   "float32", "--out", path, "--ids-out", path + "_ids"],
            flags)
        with open(path) as f, open(path + "_ids") as g:
            out[where] = (f.read().splitlines(), g.read())
    n = len(out["card"][0])
    differ = [i for i, (a, b) in enumerate(zip(out["card"][0],
                                               out["cpu"][0])) if a != b]
    check(n == n_ids == len(out["cpu"][0]),
          f"generate f32: {n} card and {len(out['cpu'][0])} CPU lines, "
          f"want {n_ids}")
    check(out["card"][1] == out["cpu"][1]
          and len(differ) <= (1 - CAPTION_AGREEMENT) * n,
          f"generate f32 card vs CPU: {len(differ)}/{n} lines differ")
    gaps = []
    if differ:          # the same searches by hand: near-ties only
        rows = [int(x) for x in out["card"][1].split()]
        feats = torch.from_numpy(store.gather([rows[i] for i in differ]))
        got = {}
        for device in ("cuda", "cpu"):
            dec = load_checkpoint(loadfile, device, torch.float32)
            tokens, scores = beam_search(dec["decoder"], feats.to(device),
                                         beam_width=beam,
                                         max_words=max_words)
            got[device] = (detokenize_batch(tokens.cpu().numpy(),
                                            dec["vocab"]), scores.cpu())
        check(got["cuda"][0] == [out["card"][0][i] for i in differ]
              and got["cpu"][0] == [out["cpu"][0][i] for i in differ],
              "generate f32: the CLI's lines differ from beam_search's")
        gaps = (got["cuda"][1] - got["cpu"][1]).abs().tolist()
        check(max(gaps) <= score_atol,
              f"generate f32 card vs CPU: differing lines' score gaps "
              f"{gaps}")
    return out["card"][0], differ, gaps


def http_request(conn, method: str, path: str, body=None, headers=None):
    """(status, JSON reply) over a kept-alive ``http.client`` connection."""
    data = body if isinstance(body, bytes) or body is None \
        else json.dumps(body)
    conn.request(method, path, body=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read() or b"{}")


def phase_cli(smi: str) -> dict[str, dict]:
    """The port's command line at the reference width, in this process and
    on the card: import-karpathy, train, generate (beam, an f32 card
    against CPU check, --sample), eval, train --joint, extract-features,
    caption and serve through the HTTP front end.  Returns each command's
    kernel launches (``launches_by_path``)."""
    import base64
    import http.client
    import threading

    from lrcn_tpu_torch import cli
    from lrcn_tpu_torch.core.tokenizer import tokenize
    from lrcn_tpu_torch.data.batcher import (bucket_batches,
                                             effective_batch_size)
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.decode import writer
    from lrcn_tpu_torch.models.vgg import CONV_NAMES
    from lrcn_tpu_torch.serve import make_server
    from lrcn_tpu_torch.serve.http import MAX_BODY_BYTES
    from lrcn_tpu_torch.train import joint as joint_mod
    from lrcn_tpu_torch.train import trainer as trainer_mod
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    work = os.path.join(WORK, "cli")
    os.makedirs(work)
    rng = np.random.default_rng(SEED + 13)
    run = CLIRun()
    steps = MAX_WORDS + 1
    width = ["--hidden", str(HIDDEN[0]), str(HIDDEN[1]), "--embed",
             str(EMBED), "--vocab-min-count", "1"]

    marks = [("", time.perf_counter())]

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter()))

    # 1. data: the .token file and Karpathy's files -> import-karpathy
    t0 = time.perf_counter()
    data = cli_data(work, rng)
    store_dir = os.path.join(work, "store")
    run(None, ["import-karpathy", "--vgg-feats", data["mat"],
               "--dataset-json", data["dataset"], "--out", store_dir])
    store = FeatureStore.load(store_dir)
    raw = data.pop("feats")
    want = raw[:, 5] / raw[:, 5].sum()
    check(len(store) == CLI_IMAGES and store.normalized
          and np.allclose(store.get(10005), want, rtol=1e-6),
          "import-karpathy: store rows")
    vocab, splits = tokenize([data["token"]], min_count=1)
    train_caps, test_caps = splits[0], splits[2]
    check(len(vocab) == VOCAB, f"vocabulary of {len(vocab)} words")
    batch = effective_batch_size(len(train_caps), CLI_TRAIN_BATCH)
    print(f"[13 cli] data: {CLI_IMAGES} images in {CLI_CLASSES} classes x 5 "
          f"captions of "
          f"{CLI_CAPTION_LEN[0]}-{CLI_CAPTION_LEN[1]} words, vocabulary "
          f"{len(vocab)}, {len(train_caps)} training captions (batch "
          f"{batch}); import-karpathy {CNN_DIM} x {CLI_IMAGES} features in "
          f"{time.perf_counter() - t0:.1f} s with the files' writing")

    mark("data")

    # 2. train at the reference width: no kernel
    ckpt = os.path.join(work, "ckpt")
    epochs: list = []
    with timed(trainer_mod.Trainer, "train_epoch", epochs):
        _, wall = run("cli_train", [
            "train", "--datafiles", data["token"], "--features", store_dir,
            *width, "--batchsize", str(CLI_TRAIN_BATCH),
            "--steps-per-dispatch", str(TRAIN_K), "--epochs", "1",
            "--seed", "1", "--savefile", ckpt])
    check(sum(run.counts["cli_train"].values()) == 0,
          f"train launched hand-written kernels: {run.counts['cli_train']}")
    ck = load_checkpoint(ckpt, "cpu")
    n_steps = len(bucket_batches(train_caps, vocab, CLI_TRAIN_BATCH))
    check(ck["epoch"] == 1 and len(ck["vocab"]) == VOCAB
          and int(ck["opt_leaves"][0]) == n_steps
          and all(np.isfinite(v).all() for v in ck["params"].values()),
          f"train: checkpoint epoch {ck['epoch']}, "
          f"{int(ck['opt_leaves'][0])} of {n_steps} steps")
    ms = epochs[0] / n_steps * 1e3
    print(f"[13 cli] train (hidden {HIDDEN}, embed {EMBED}, vocab {VOCAB}, "
          f"bf16, B={batch}, K={TRAIN_K} steps a dispatch, 1 epoch of "
          f"{n_steps} steps): {ms:.3f} ms per step over the epoch "
          f"({epochs[0]:.2f} s), command {wall:.2f} s on {smi}; launches "
          f"{run.counts['cli_train']}")
    del ck

    mark("train")

    # 3. generate: beam 3 over the held-out split, bf16
    cands, ids_path = (os.path.join(work, n) for n in ("cands", "ids"))
    gen = ["generate", "--loadfile", ckpt, "--features", store_dir,
           "--datafiles", data["token"], "--vocab-min-count", "1",
           "--generate", str(MAX_WORDS), "--beam_width", str(BEAM),
           "--seed", "7"]
    searches: list = []
    with timed(writer, "search", searches):
        _, wall = run("cli_generate", [*gen, "--capnumber", str(CLI_EVAL),
                                       "--out", cands, "--ids-out",
                                       ids_path])
    with open(cands) as f:
        lines = f.read().splitlines()
    with open(ids_path) as f:
        ids = [int(x) for x in f.read().split()]
    want_ids = writer.pick_eval_ids_from_captions(
        test_caps, CLI_EVAL, np.random.default_rng(7), store)
    test_ids = {c.image_id for c in test_caps}
    check(len(lines) == len(ids) == CLI_EVAL and ids == want_ids
          and set(ids) <= test_ids and len(set(ids)) == CLI_EVAL
          and all(line.endswith(".") for line in lines),
          f"generate: {len(lines)} lines, {len(ids)} ids")
    batch_size, depth = cli.decode_geometry(CLI_EVAL, None, None)
    n_search = -(-CLI_EVAL // (batch_size * depth))
    cfg = load_checkpoint(ckpt, "cpu")["cfg"]
    routes = expected_routes(cfg, [], batch_size * depth * BEAM, BEAM)
    check(len(searches) == n_search
          and run.routes["cli_generate"] == {
              "fused_conv3x3_relu": {},
              "fused_lstm_step": _scaled(routes["fused_lstm_step"],
                                         steps * n_search),
              "topk_logsumexp": _scaled(routes["topk_logsumexp"],
                                        steps * n_search)},
          f"generate: launches by route {run.routes['cli_generate']} in "
          f"{len(searches)} searches, want {routes} x {steps * n_search}")
    print(f"[13 cli] generate beam-{BEAM} --generate {MAX_WORDS}, "
          f"{CLI_EVAL} held-out images ({batch_size} x {depth}, "
          f"{n_search} search), bf16: {CLI_EVAL / wall:.1f} captions/s over "
          f"the command ({wall:.3f} s), {CLI_EVAL / sum(searches):.1f} over "
          f"the search ({sum(searches) * 1e3:.1f} ms) on {smi}; launches by "
          f"route {run.routes['cli_generate']}; {len(set(lines))} distinct "
          f"captions")

    mark("generate")

    # 4. f32: the kernel path on the card against the plain path on the
    #    CPU.  One epoch on this set leaves a model with few distinct
    #    captions, so this runs a random-weight checkpoint at the reference
    #    width instead, its output projection scaled up (CLI_F32_SHARPEN)
    #    so that fewer beams tie; every line that differs must be a
    #    near-tie, as in phases 5 and 8, at SCORE_ATOL times the scale (the
    #    log-probabilities, and their rounding, grow with it)
    sharp = os.path.join(work, "random_ckpt")
    tree = random_tree(np.random.default_rng(SEED + 14))
    tree["w_out"] *= CLI_F32_SHARPEN
    write_checkpoint(sharp, tree, cfg)
    lines, differ, gaps = f32_card_against_cpu(
        run, [*gen, "--capnumber", str(CLI_F32_IDS)], CLI_F32_IDS, sharp,
        store, BEAM, MAX_WORDS, os.path.join(work, "f32"),
        SCORE_ATOL * CLI_F32_SHARPEN)
    print(f"[13 cli] generate --compute-dtype float32 (a random checkpoint, "
          f"w_out x {CLI_F32_SHARPEN}), {CLI_F32_IDS} ids, card (kernels) "
          f"vs --device cpu (plain): {CLI_F32_IDS - len(differ)}/"
          f"{CLI_F32_IDS} lines equal (need {CAPTION_AGREEMENT}), the "
          f"others near-ties (score gaps {[round(g, 6) for g in gaps]}, tol "
          f"{SCORE_ATOL * CLI_F32_SHARPEN}); ids equal; "
          f"{len(set(lines))} distinct lines")

    mark("f32")

    # 5. generate --sample: best-of-N through the LSTM kernel
    path = os.path.join(work, "sampled")
    _, wall = run("cli_sample", [*gen, "--sample", str(SAMPLE_N),
                                 "--capnumber", str(CLI_SAMPLE_IDS),
                                 "--out", path, "--ids-out", path + "_ids"])
    with open(path) as f:
        sampled = f.read().splitlines()
    rows = CLI_SAMPLE_IDS * SAMPLE_N
    lstm = expected_routes(cfg, [], rows, 1)["fused_lstm_step"]
    check(len(sampled) == CLI_SAMPLE_IDS
          and run.routes["cli_sample"] == {
              "fused_conv3x3_relu": {}, "topk_logsumexp": {},
              "fused_lstm_step": _scaled(lstm, steps)},
          f"generate --sample: {len(sampled)} lines, launches by route "
          f"{run.routes['cli_sample']}")
    print(f"[13 cli] generate --sample {SAMPLE_N}, {CLI_SAMPLE_IDS} images "
          f"({rows} rows), bf16: command {wall:.3f} s on {smi}; launches by "
          f"route {run.routes['cli_sample']}")

    mark("sample")

    # 6. eval against the .token file's references
    printed, _ = run(None, ["eval", "--candidates", cands,
                            "--candidate-ids", ids_path, "--annotations",
                            data["token"], "--refs-dir",
                            os.path.join(work, "refs")])
    check(printed.startswith("BLEU = "), f"eval printed {printed!r}")
    print(f"[13 cli] eval: {printed.strip()}")

    mark("eval")

    # 7. train --joint at full VGG-16 width; extract-features and caption
    #    through its encoder.  Pixels by id (no image decode here)
    train_ids = sorted({c.image_id for c in train_caps})
    joint_ids = train_ids[:CLI_JOINT_IMAGES]
    extract_ids = train_ids[-CLI_EXTRACT_IMAGES:]
    pixels = {i: rng.integers(0, 256, (224, 224, 3), np.uint8)
              for i in joint_ids + extract_ids}
    dirs = {}
    for name, group in (("joint", joint_ids), ("extract", extract_ids)):
        dirs[name] = os.path.join(work, f"{name}_images")
        os.makedirs(dirs[name])
        for i in group:
            open(os.path.join(dirs[name], f"{i}.jpg"), "wb").close()
    joint_ckpt = os.path.join(work, "joint_ckpt")
    joint_caps = sum(c.image_id in set(joint_ids) for c in train_caps)
    joint_batch = effective_batch_size(joint_caps, CLI_JOINT_BATCH)
    joint_epochs: list = []
    with synthetic_pixels(pixels):
        print("[13 cli] the host image decode is replaced by synthetic "
              "uint8 arrays by id (data.images.load_images, preprocess, "
              "load_blobs, JointTrainer._load_images): no PIL or libjpeg "
              "here; tests/test_torch_native.py holds the decode")
        with timed(joint_mod.JointTrainer, "train_epoch", joint_epochs):
            _, wall = run("cli_joint", [
                "train", "--joint", "--images", dirs["joint"],
                "--datafiles", data["token"], *width, "--batchsize",
                str(CLI_JOINT_BATCH), "--epochs", "1", "--seed", "2",
                "--savefile", joint_ckpt])
        check(sum(run.counts["cli_joint"].values()) == 0,
              f"train --joint launched kernels: {run.counts['cli_joint']}")
        j_steps = len(bucket_batches([c for c in train_caps
                                      if c.image_id in set(joint_ids)],
                                     vocab, CLI_JOINT_BATCH))
        # the checkpoint's files, read in part (its 2 GB are read whole by
        # each command below)
        with np.load(os.path.join(joint_ckpt, "params.npz")) as z:
            convs = [z[f"cnn/{n}/w"].shape for n in CONV_NAMES]
        with np.load(os.path.join(joint_ckpt, "opt_state.npz")) as z:
            n_leaves, count = len(z.files), int(z["leaf_0"])
        with open(os.path.join(joint_ckpt, "config.json")) as f:
            epoch = json.load(f)["epoch"]
        check(epoch == 1 and n_leaves == 80 and count == j_steps
              and os.path.exists(os.path.join(joint_ckpt,
                                              "average_image.npy")),
              f"train --joint: checkpoint epoch {epoch}, {n_leaves} "
              f"optimizer leaves, {count} of {j_steps} steps")
        print(f"[13 cli] train --joint (full VGG-16, hidden {HIDDEN}, bf16, "
              f"remat, {CLI_JOINT_IMAGES} images, {joint_caps} captions, "
              f"B={joint_batch}, {j_steps} steps): "
              f"{joint_epochs[0] / j_steps * 1e3:.3f} ms per step over the "
              f"epoch ({joint_epochs[0]:.2f} s), command {wall:.2f} s on "
              f"{smi}; launches {run.counts['cli_joint']}")
        per_batch = expected_routes(cfg, convs, 1, BEAM)
        conv = per_batch["fused_conv3x3_relu"]

        mark("joint")
        feats_dir = os.path.join(work, "extracted")
        _, wall = run("cli_extract", [
            "extract-features", "--loadfile", joint_ckpt, "--images",
            dirs["extract"], "--out", feats_dir, "--batch-size",
            str(CLI_EXTRACT_BATCH), "--scan-depth", "2"])
        extracted = FeatureStore.load(feats_dir)
        n_batches = CLI_EXTRACT_IMAGES // CLI_EXTRACT_BATCH
        check(sorted(extracted.ids()) == extract_ids
              and extracted.dim == CNN_DIM
              and bool(np.isfinite(extracted.table()).all())
              and run.routes["cli_extract"] == {
                  "fused_conv3x3_relu": _scaled(conv, n_batches),
                  "fused_lstm_step": {}, "topk_logsumexp": {}},
              f"extract-features: {len(extracted)} rows, launches by route "
              f"{run.routes['cli_extract']}, want {conv} x {n_batches}")
        print(f"[13 cli] extract-features --loadfile <joint>, "
              f"{CLI_EXTRACT_IMAGES} images in batches of "
              f"{CLI_EXTRACT_BATCH}, bf16: command {wall:.2f} s on {smi}; "
              f"launches by route {run.routes['cli_extract']}")

        mark("extract")
        image = os.path.join(dirs["extract"], f"{extract_ids[0]}.jpg")
        printed, wall = run("cli_caption", ["caption", image, "--loadfile",
                                            joint_ckpt, "--generate",
                                            str(MAX_WORDS)])
        one = expected_routes(cfg, [], BEAM, BEAM)
        check(printed.count("\n") == 1 and printed.endswith(".\n")
              and run.routes["cli_caption"] == {
                  "fused_conv3x3_relu": conv,
                  "fused_lstm_step": _scaled(one["fused_lstm_step"], steps),
                  "topk_logsumexp": _scaled(one["topk_logsumexp"], steps)},
              f"caption printed {printed!r}, launches by route "
              f"{run.routes['cli_caption']}")
        print(f"[13 cli] caption <image> --loadfile <joint>: command "
              f"{wall:.2f} s; launches by route {run.routes['cli_caption']};"
              f" {printed.strip()[:60]!r}")

        mark("caption")

        # 8. serve: the joint checkpoint (decoder and encoder) and the store
        args = cli.build_parser().parse_args([
            *CLI_DEVICE_FLAGS, "serve", "--loadfile", joint_ckpt,
            "--features", store_dir, "--generate", str(MAX_WORDS),
            "--host", "127.0.0.1", "--port", "0"])
        service = cli.make_caption_service(args)
        service.warmup()
        server = make_server(service, args.host, args.port)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        conn = http.client.HTTPConnection("127.0.0.1",
                                          server.server_address[1],
                                          timeout=120)
        try:
            serve_ids = [int(i) for i in rng.choice(store.ids(),
                                                    CLI_SERVE_REQUESTS)]
            rows = [raw[:, i - 10000].tolist() for i in serve_ids[:4]]
            blobs = [base64.b64encode(str(i).encode()).decode()
                     for i in extract_ids[:4]]
            reset_counts(*run.fns)
            walls, answers = [], []
            for i in serve_ids:
                t0 = time.perf_counter()
                status, reply = http_request(conn, "POST", "/v1/caption",
                                             {"id": i})
                walls.append(time.perf_counter() - t0)
                check(status == 200, f"serve id {i}: {status} {reply}")
                answers.extend(reply["captions"])
            bodies = [{"ids": serve_ids[:64]}, {"features": rows},
                      {"images_b64": blobs}]
            replies = [http_request(conn, "POST", "/v1/caption", b)
                       for b in bodies]
            run.counts["cli_serve"] = read_counts(*run.fns)
            run.routes["cli_serve"] = {fn.__name__: _routes_used(fn)
                                       for fn in run.fns}
            direct = [service.caption_ids(serve_ids[:64]),
                      service.caption_features([np.asarray(r, np.float32)
                                                for r in rows]),
                      service.caption_image_bytes([str(i).encode()
                                                   for i in
                                                   extract_ids[:4]])]
            # one burst of all ids against one request each: the searches'
            # shapes differ, so a near-tie may tip (as in phases 5 and 8)
            same = sum(a == b for a, b in
                       zip(answers, service.caption_ids(serve_ids)))
            check(same >= CAPTION_AGREEMENT * len(serve_ids),
                  f"serve: {same}/{len(serve_ids)} id captions equal to "
                  f"caption_ids'")
            for (status, reply), want in zip(replies, direct):
                check(status == 200 and reply["captions"] == want,
                      f"serve: {status}, captions differ from the service")
            status, health = http_request(conn, "GET", "/healthz")
            check(status == 200 and health == {"ok": True,
                                               "platform": "cuda"},
                  f"/healthz: {status} {health}")
            status, stats = http_request(conn, "GET", "/stats")
            check(status == 200 and set(stats) == {"decode", "decode_ids",
                                                   "encode"},
                  f"/stats: {status} {sorted(stats)}")
            check(http_request(conn, "GET", "/nope")[0] == 404
                  and http_request(conn, "POST", "/v1/caption",
                                   {"wrong": 1})[0] == 400,
                  "serve: 404 and 400")
            big = http.client.HTTPConnection(
                "127.0.0.1", server.server_address[1], timeout=60)
            status, _ = http_request(big, "POST", "/v1/caption", b"", {
                "Content-Length": str(MAX_BODY_BYTES + 1)})
            big.close()
            check(status == 413, f"serve: oversize body gave {status}")
        finally:
            conn.close()
            server.shutdown()
            server.server_close()
            service.close()
            thread.join(timeout=10)
    counts, used = run.counts["cli_serve"], run.routes["cli_serve"]
    searches = counts["topk_logsumexp"] // steps
    check(searches > 0 and counts["topk_logsumexp"] == steps * searches
          and counts["fused_lstm_step"] == 2 * steps * searches
          and counts["fused_conv3x3_relu"] % 13 == 0
          and counts["fused_conv3x3_relu"] > 0
          and all(set(used[fn]) == set(per_batch[fn]) for fn in used),
          f"serve: launches {counts} by route {used}, want the routes of "
          f"{per_batch}")
    ms = sorted(w * 1e3 for w in walls)
    p50 = statistics.median(ms)
    p99 = ms[min(len(ms) - 1, int(0.99 * len(ms)))]
    print(f"[13 cli] serve (joint checkpoint + store, decode batch 64, "
          f"beam {BEAM}, --generate {MAX_WORDS}, bf16): "
          f"{CLI_SERVE_REQUESTS} sequential id requests over one kept-alive "
          f"connection: p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
          f"{CLI_SERVE_REQUESTS / sum(walls):.1f} requests/s on {smi}; "
          f"{same}/{len(serve_ids)} equal to one caption_ids burst; ids x64, "
          f"features x4, images_b64 x4 equal to the service's own captions; "
          f"/healthz, /stats, 404, 400, 413 right; {searches} searches, "
          f"launches by route {used}")
    mark("serve")
    print("[13 cli] seconds by step: " + ", ".join(
        f"{label} {t - marks[i][1]:.1f}"
        for i, (label, t) in enumerate(marks[1:])))
    return run.counts


def loadgen_cmd(exe: str, port: int, conns: int, seconds: float,
                rate: float = 0.0, feat_dim: int = 0) -> list[str]:
    """The load generator's command line: one id in [0, NATIVE_ROWS) a
    request (or, with ``feat_dim``, one raw fc7 row), closed loop, or open
    loop at ``rate`` requests/s."""
    return [exe, "127.0.0.1", str(port), str(conns), str(seconds),
            str(NATIVE_ROWS), "1", str(rate), str(feat_dim), ""]


def loadgen_result(code: int, stdout: str, stderr: str) -> dict:
    """The load generator's JSON line, with the client's CPU share of the
    machine's cores (it must stay well under 1 for the server to set the
    pace)."""
    check(code == 0, f"loadgen exited {code}: {stderr[-300:]}")
    r = json.loads(stdout.strip().splitlines()[-1])
    r["client_cpu"] = ((r["cpu_user_s"] + r["cpu_sys_s"])
                       / (r["wall_s"] * (os.cpu_count() or 1)))
    return r


def run_loadgen(exe: str, port: int, conns: int, seconds: float,
                rate: float = 0.0, feat_dim: int = 0) -> dict:
    out = subprocess.run(loadgen_cmd(exe, port, conns, seconds, rate,
                                     feat_dim),
                         capture_output=True, text=True, timeout=seconds + 150)
    return loadgen_result(out.returncode, out.stdout, out.stderr)


@contextmanager
def counted_searches(searches: list, encodes: list):
    """Append the LSTM rows of each beam search the service runs (by
    feature rows or by table rows) to ``searches`` and each encoder
    batch's size to ``encodes``, whichever thread runs them: the service's
    own entry points, each one graph replay on the card."""
    from lrcn_tpu_torch.serve import service

    real = (service.search, service.rows_search, service.images_to_fc7)

    def search(decoder, feats, **kwargs):
        searches.append(feats.shape[0] * kwargs["beam_width"])
        return real[0](decoder, feats, **kwargs)

    def rows_search(decoder, table, idx, **kwargs):
        searches.append(idx.numel() * kwargs["beam_width"])
        return real[1](decoder, table, idx, **kwargs)

    def images_to_fc7(vgg, pixels, *args, **kwargs):
        encodes.append(pixels.shape[0])
        return real[2](vgg, pixels, *args, **kwargs)

    service.search, service.rows_search, service.images_to_fc7 = (
        search, rows_search, images_to_fc7)
    try:
        yield
    finally:
        service.search, service.rows_search, service.images_to_fc7 = real


def stall_cycles(ms: float) -> int:
    """Clock cycles of ``torch.cuda._sleep`` that keep the card busy for
    about ``ms``, from one timed spin."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return int(cycles * ms / start.elapsed_time(end))


def check_no_device_wait(service, cycles: int) -> str:
    """The traps of a shared stream, held on the card: with the stream busy
    for NATIVE_STALL_MS (a device-side spin), an issue returns long before
    the spin ends, its search still pending (the upload does not wait for
    the searches in flight); and the fetch of a search issued before a spin
    and a second search returns long before the spin ends, the second
    search still pending (it waits for its own copy, not the stream)."""
    rows = list(range(service.decode_batch * service.MAX_DECODE_GROUPS))
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    raw = service._decode_rows_grouped(rows)
    issue_ms = (time.perf_counter() - t0) * 1e3
    issue_pending = not raw[2].query()
    service._wait(raw)
    first = service._decode_rows_grouped(rows)
    torch.cuda._sleep(cycles)
    second = service._decode_rows_grouped(rows)
    t0 = time.perf_counter()
    service._wait(first)
    fetch_ms = (time.perf_counter() - t0) * 1e3
    second_pending = not second[2].query()
    service._wait(second)
    check(issue_ms < NATIVE_STALL_MS / 2 and issue_pending
          and fetch_ms < NATIVE_STALL_MS / 2 and second_pending,
          f"a {NATIVE_STALL_MS} ms spin on the stream: the issue took "
          f"{issue_ms:.1f} ms (pending after: {issue_pending}), the fetch "
          f"of the search before the spin {fetch_ms:.1f} ms (the one after "
          f"still pending: {second_pending})")
    return (f"behind a {NATIVE_STALL_MS:.0f} ms device-side spin an issue of "
            f"{len(rows)} ids took {issue_ms:.1f} ms and returned with its "
            f"search pending; the fetch of a search issued before another "
            f"spin took {fetch_ms:.2f} ms, the search after it pending")


def post(port: int, body, method: str = "POST", path: str = "/v1/caption"):
    """(status, JSON reply) of one request on a connection of its own."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        return http_request(conn, method, path, body)
    finally:
        conn.close()


def phase_native(smi: str, tree: dict) -> dict[str, int]:
    """The C++ HTTP front end (``serve/native_http.py``) under concurrent
    load on the card: phase 8's joint checkpoint (the random decoder
    ``tree`` and a full-width random VGG-16) and a store of NATIVE_ROWS
    rows, served through ``cli.make_caption_service`` and
    ``native_frontend``, driven by the port's load generator.  Returns the
    kernels' launches over the loads and the HTTP checks."""
    import base64

    from lrcn_tpu_torch import cli
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.decode.writer import detokenize_batch
    from lrcn_tpu_torch.models.lrcn import params_from_numpy
    from lrcn_tpu_torch.models.vgg import CONV_NAMES
    from lrcn_tpu_torch.native import httpserve_library, loadgen_binary
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.serve import native_frontend
    from lrcn_tpu_torch.utils import graphs
    from lrcn_tpu_torch.utils.profiling import device_time_ms, trace

    work = os.path.join(WORK, "native")
    joint = os.path.join(WORK, "joint")            # phase 8's checkpoint
    rng = np.random.default_rng(SEED + 14)
    marks = [("", time.perf_counter())]

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter()))
    t0 = time.perf_counter()     # phase 2 started both builds
    check(httpserve_library() is not None, "httpserve did not build")
    exe = loadgen_binary()
    check(exe is not None, "loadgen did not build")
    build_s = time.perf_counter() - t0
    raw = np.abs(rng.standard_normal((NATIVE_ROWS, CNN_DIM), np.float32))
    store = FeatureStore.from_dict(dict(enumerate(raw)), normalized=False)
    store.save(os.path.join(work, "store"))
    args = cli.build_parser().parse_args([
        *CLI_DEVICE_FLAGS, "serve", "--loadfile", joint, "--features",
        os.path.join(work, "store"), "--generate", str(MAX_WORDS), "--host",
        "127.0.0.1", "--port", "0"])
    service = cli.make_caption_service(args)
    captures = graphs.stats["captures"]
    t0 = time.perf_counter()
    service.warmup()
    warmup_s = time.perf_counter() - t0
    frontend = native_frontend(
        service, host=args.host, port=args.port, n_threads=NATIVE_THREADS,
        max_queue=args.max_queue or 4096, feat_wait_ms=args.feat_wait_ms)
    port = frontend.port
    # every shape the service runs is a graph captured by now
    captured = [g for m in (service.decoder, service.vgg)
                for g in graphs.graphs(m)]
    check(len(captured) == graphs.stats["captures"] - captures,
          "phase 14's service captured graphs outside its modules")
    captures, replays = graphs.stats["captures"], graphs.stats["replays"]
    cycles = stall_cycles(NATIVE_STALL_MS)
    waits = check_no_device_wait(service, cycles)
    print(f"[14 native] waited {build_s:.1f} s for httpserve and loadgen; "
          f"serving {joint} and {NATIVE_ROWS} stored rows on port {port}, "
          f"decode batch {args.decode_batch} x {service.MAX_DECODE_GROUPS} "
          f"groups, beam {args.beam_width}, --generate {MAX_WORDS}, bf16, "
          f"{NATIVE_THREADS} connection threads; {waits}")
    tdir = os.path.join(work, "trace")
    with trace(os.path.join(work, "trace_warmup"), device=service.device):
        torch.ones(1, device=service.device).sum()   # profiler set-up
    mark("set-up")

    # the pump's issue calls and each batch's issue-to-response time
    issue_s, answer_s, started = [], [], {}
    real_issue, real_respond = (service._decode_rows_grouped,
                                frontend._respond_raw)

    def timed_issue(rows):
        t = time.perf_counter()
        raw_result = real_issue(rows)
        issue_s.append(time.perf_counter() - t)
        started[id(raw_result)] = t
        return raw_result

    def timed_respond(preqs, pslots, raw_result):
        real_respond(preqs, pslots, raw_result)
        t = started.pop(id(raw_result), None)
        if t is not None:
            answer_s.append(time.perf_counter() - t)

    service._decode_rows_grouped = timed_issue
    frontend._respond_raw = timed_respond
    stats = lambda: post(port, None, "GET", "/stats")[1]
    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    searches, encodes, loads = [], [], {}
    pixels = {i: rng.integers(0, 256, (224, 224, 3), np.uint8)
              for i in range(NATIVE_IMAGES)}
    reset_counts(*fns)
    try:
        with counted_searches(searches, encodes):
            # closed loops: a warm-up, then the measured run
            for conns in NATIVE_CONNS:
                run_loadgen(exe, port, conns, NATIVE_WARM_S)
                before = stats()
                issue_s.clear()
                answer_s.clear()
                frontend.pending_hwm = 0
                r = run_loadgen(exe, port, conns, NATIVE_LOAD_S)
                after = stats()
                r["mean_batch"] = ((after["items"] - before["items"])
                                   / max(1, after["batches"]
                                         - before["batches"]))
                r["pending_hwm"] = frontend.pending_hwm
                r["issue_ms"] = statistics.median(issue_s) * 1e3
                r["answer_ms"] = statistics.median(answer_s) * 1e3
                loads[conns] = r
                print(f"[14 native] closed loop, {conns} connections, "
                      f"{NATIVE_LOAD_S:.0f} s, one id a request: "
                      f"{r['throughput_rps']} requests/s, "
                      f"{r['captions_per_s']} captions/s, p50 {r['p50_ms']} "
                      f"ms, p90 {r['p90_ms']} ms, p99 {r['p99_ms']} ms, "
                      f"errors {r['errors']}, client CPU share "
                      f"{r['client_cpu']:.4f}; /stats mean_batch_size "
                      f"{r['mean_batch']:.2f}, pending_hwm "
                      f"{r['pending_hwm']}; the pump's issue median "
                      f"{r['issue_ms']:.3f} ms of {len(issue_s)}, issue to "
                      f"response median {r['answer_ms']:.3f} ms; on {smi}")
                check(r["errors"] == 0 and r["requests"] > 0,
                      f"closed loop at {conns}: {r}")
            closed = loads[NATIVE_CONNS[-1]]
            rate = closed["throughput_rps"] / 2
            r = run_loadgen(exe, port, NATIVE_CONNS[-1], NATIVE_LOAD_S,
                            rate=rate)
            print(f"[14 native] open loop, {NATIVE_CONNS[-1]} connections at "
                  f"{rate:.1f} requests/s (half the closed loop's), "
                  f"{NATIVE_LOAD_S:.0f} s: p50 {r['p50_ms']} ms, p90 "
                  f"{r['p90_ms']} ms, p99 {r['p99_ms']} ms from the "
                  f"scheduled times, completion {r['completion']}, errors "
                  f"{r['errors']}, client CPU share {r['client_cpu']:.4f}; "
                  f"on {smi}")
            check(r["errors"] == 0 and r["completion"] >= 0.99,
                  f"open loop: {r}")
            loads["open"] = r
            r = run_loadgen(exe, port, NATIVE_FEAT_CONNS, NATIVE_FEAT_S,
                            feat_dim=CNN_DIM)
            print(f"[14 native] feature leg, {NATIVE_FEAT_CONNS} connections,"
                  f" {NATIVE_FEAT_S:.0f} s, one raw {CNN_DIM}-float row a "
                  f"request: {r['captions_per_s']} captions/s, p50 "
                  f"{r['p50_ms']} ms, p99 {r['p99_ms']} ms, errors "
                  f"{r['errors']}; on {smi}")
            check(r["errors"] == 0 and r["requests"] > 0,
                  f"feature leg: {r}")

            # the pump runs ahead of a stalled device, up to its budget:
            # a spin on the shared stream under the 512-connection loop
            frontend.pending_hwm = 0
            proc = subprocess.Popen(
                loadgen_cmd(exe, port, NATIVE_CONNS[-1], 1.5),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                time.sleep(0.5)
                torch.cuda._sleep(cycles)
                out, err = proc.communicate(timeout=150)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            r = loadgen_result(proc.returncode, out, err)
            print(f"[14 native] a {NATIVE_STALL_MS:.0f} ms device-side spin "
                  f"under the {NATIVE_CONNS[-1]}-connection closed loop: "
                  f"pending_hwm {frontend.pending_hwm} of max_inflight "
                  f"{frontend._max_inflight}, p99 {r['p99_ms']} ms, errors "
                  f"{r['errors']}")
            check(r["errors"] == 0
                  and frontend.pending_hwm == frontend._max_inflight,
                  f"behind a spin the pump held {frontend.pending_hwm} "
                  f"searches in flight, want max_inflight "
                  f"{frontend._max_inflight}: {r}")

            mark("loads")
            # the device's idle share under the 512-connection closed loop
            proc = subprocess.Popen(
                loadgen_cmd(exe, port, NATIVE_CONNS[-1], NATIVE_TRACE_S + 1),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            try:
                time.sleep(0.5)
                with trace(tdir, device=service.device):
                    items = stats()["items"]
                    t0 = time.perf_counter()
                    time.sleep(NATIVE_TRACE_S)
                    wall = time.perf_counter() - t0
                    items = stats()["items"] - items
                out, err = proc.communicate(timeout=NATIVE_TRACE_S + 150)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            r = loadgen_result(proc.returncode, out, err)
            check(r["errors"] == 0, f"traced closed loop: {r}")
            busy = device_time_ms(tdir)
            print(f"[14 native] traced window of the {NATIVE_CONNS[-1]}-"
                  f"connection closed loop (utils.profiling.trace, "
                  f"device_time_ms): wall {wall * 1e3:.1f} ms, device busy "
                  f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.4f}, "
                  f"{items / wall:.1f} captions/s in the window (the "
                  f"profiler slows the host); on {smi}")
            check(0 < busy <= wall * 1e3 * 1.05,
                  f"device busy {busy} ms in a {wall * 1e3} ms window")
            check(closed["pending_hwm"] <= frontend._max_inflight,
                  f"{closed['pending_hwm']} searches in flight at "
                  f"{NATIVE_CONNS[-1]} connections, over max_inflight")

            mark("trace")
            # right answers, each against the service's own call
            ids = [int(i) for i in rng.choice(NATIVE_ROWS, NATIVE_IDS,
                                              replace=False)]
            status, reply = post(port, {"ids": ids})
            check(status == 200 and reply["captions"]
                  == service.caption_ids(ids), f"ids body: {status}")
            rows = raw[:NATIVE_FEATURES] * rng.uniform(
                0.5, 4.0, (NATIVE_FEATURES, 1)).astype(np.float32)
            status, reply = post(port, {"features": rows.tolist()})
            check(status == 200 and reply["captions"]
                  == service.caption_features(list(rows)),
                  f"raw features body: {status}")
            blobs = [base64.b64encode(str(i).encode()).decode()
                     for i in pixels]
            with synthetic_pixels(pixels), ThreadPoolExecutor(
                    NATIVE_IMAGES) as pool:
                replies = list(pool.map(
                    lambda b: post(port, {"images_b64": [b]}), blobs))
                want = service.caption_image_bytes(
                    [str(i).encode() for i in pixels])
            check([s for s, _ in replies] == [200] * NATIVE_IMAGES
                  and [r["captions"][0] for _, r in replies] == want,
                  f"images_b64 bodies: {[s for s, _ in replies]}")
            singles = [int(i) for i in rng.choice(NATIVE_ROWS,
                                                  CLI_SERVE_REQUESTS)]
            with ThreadPoolExecutor(32) as pool:
                replies = list(pool.map(lambda i: post(port, {"id": i}),
                                        singles))
            check(all(s == 200 for s, _ in replies), "single-id requests")
            same = sum(r["captions"][0] == w for (_, r), w in
                       zip(replies, service.caption_ids(singles)))
            check(same >= CAPTION_AGREEMENT * len(singles),
                  f"{same}/{len(singles)} single-id captions equal to one "
                  f"caption_ids burst")
            health = post(port, None, "GET", "/healthz")
            final = stats()
            check(health == (200, {"ok": True, "ready": True,
                                   "frontend": "native"})
                  and final["frontend"] == "native",
                  f"/healthz {health}, /stats {final}")
            check(post(port, None, "GET", "/nope")[0] == 404
                  and post(port, {"id": NATIVE_ROWS + 7})[0] == 400,
                  "unknown route and unknown id")
    finally:
        t0 = time.perf_counter()
        frontend.stop()
        stop_s = time.perf_counter() - t0
        service.close()
    mark("answers")
    new_captures = graphs.stats["captures"] - captures
    check(new_captures == 0, f"{new_captures} graphs captured after the "
                             f"service's warm-up")
    print(f"[14 native] graphs: {len(captured)} captured at warm-up "
          f"(keys {sorted({g.key for g in captured})}; the warm-up took "
          f"{warmup_s:.2f} s), none after it; {graphs.stats['replays'] - replays} replays served "
          f"the loads and checks")
    check(not (frontend._pump.is_alive() or frontend._responder.is_alive()
               or frontend._img_thread.is_alive()),
          f"frontend threads alive after stop() ({stop_s:.1f} s)")
    launches = read_counts(*fns)
    used = {fn.__name__: _routes_used(fn) for fn in fns}

    # launches by route: every search and encoder batch, from the routing
    # functions on meta tensors
    cfg = service.cfg
    with np.load(os.path.join(joint, "params.npz")) as z:
        convs = [z[f"cnn/{n}/w"].shape for n in CONV_NAMES]
    steps = MAX_WORDS + 1
    want = {"fused_conv3x3_relu": _scaled(expected_routes(
        cfg, convs, 1, BEAM)["fused_conv3x3_relu"], len(encodes)),
        "fused_lstm_step": {}, "topk_logsumexp": {}}
    for rows_k in set(searches):
        per_step = expected_routes(cfg, [], rows_k, BEAM)
        for name in ("fused_lstm_step", "topk_logsumexp"):
            for route, n in per_step[name].items():
                want[name][route] = (want[name].get(route, 0)
                                     + n * steps * searches.count(rows_k))
    check(launches["topk_logsumexp"] == steps * len(searches)
          and launches["fused_lstm_step"] == 2 * launches["topk_logsumexp"]
          and launches["fused_conv3x3_relu"] == 13 * len(encodes)
          and set(used["fused_lstm_step"]) == {"wgmma"}
          and used == want,
          f"launches {launches} by route {used} in {len(searches)} searches "
          f"and {len(encodes)} encoder batches; want {want}")
    print(f"[14 native] right answers: ids x{NATIVE_IDS}, raw features "
          f"x{NATIVE_FEATURES}, {NATIVE_IMAGES} images_b64 requests equal to "
          f"the service's own calls; {same}/{len(singles)} concurrent "
          f"single-id requests equal to one caption_ids burst; /healthz, "
          f"/stats, 404, 400 right; stop() in {stop_s:.2f} s; "
          f"{len(searches)} searches ({min(searches)}-{max(searches)} LSTM "
          f"rows), {len(encodes)} encoder batches, launches by route {used}")

    # the rows served above (every stored row, the raw feature rows)
    # through the kernels and the plain path, f32, TF32 off; the output
    # projection scaled by CLI_F32_SHARPEN as in phase 13, so that fewer
    # beams of the random decoder tie.  Over 2,064 searches a tie met
    # early sends the two searches down other beams, whose final scores
    # may differ by more than the tie (gaps up to 0.057 on the H100 at
    # these rows), so each differing caption is held by its score instead:
    # the plain path, teacher-forced along either search's caption, gives
    # the score that search reported
    served = np.concatenate([raw, rows]).astype(np.float32)
    served /= served.sum(1, keepdims=True)
    sharp = dict(tree, w_out=tree["w_out"] * CLI_F32_SHARPEN)
    dec32 = params_from_numpy(sharp, "cuda", torch.float32)
    feats = torch.from_numpy(served).cuda()
    tok_k, sc_k = beam_search(dec32, feats, beam_width=BEAM,
                              max_words=MAX_WORDS)
    tok_p, sc_p = beam_search(dec32, feats, beam_width=BEAM,
                              max_words=MAX_WORDS, use_kernels=False)
    cap_k = detokenize_batch(tok_k.cpu().numpy(), service.vocab)
    cap_p = detokenize_batch(tok_p.cpu().numpy(), service.vocab)
    differ = [i for i, (a, b) in enumerate(zip(cap_k, cap_p)) if a != b]
    check(len(differ) <= (1 - CAPTION_AGREEMENT) * len(served),
          f"f32 native: {len(differ)}/{len(served)} captions differ")
    rescored = [path_score_error(dec32, feats[differ], tok[differ],
                                 sc[differ]) for tok, sc in
                ((tok_k, sc_k), (tok_p, sc_p))] if differ else [0.0, 0.0]
    check(max(rescored) <= SCORE_ATOL * CLI_F32_SHARPEN,
          f"f32 native: the differing captions' scores rescored on the "
          f"plain path are off by {rescored}")
    print(f"[14 native f32] the {len(served)} rows served above (w_out x "
          f"{CLI_F32_SHARPEN}), kernel vs plain path: "
          f"{len(served) - len(differ)}/{len(served)} captions equal (need "
          f"{CAPTION_AGREEMENT}); the {len(differ)} others' score gaps "
          f"{[round(float(g), 6) for g in (sc_k - sc_p)[differ].abs()]}, "
          f"each search's score of its own caption within "
          f"{max(rescored):.3g} of the plain path's teacher-forced score "
          f"(tol {SCORE_ATOL * CLI_F32_SHARPEN}); {len(set(cap_k))} "
          f"distinct captions")
    mark("f32")
    print("[14 native] seconds by step: " + ", ".join(
        f"{label} {t - marks[i][1]:.1f}"
        for i, (label, t) in enumerate(marks[1:])))
    return launches


def captions_per_s(run, rows: int, iters: int = EXPORT_ITERS) -> float:
    """Captions/s of ``run``, a search returning (tokens, scores), over
    ``iters`` calls back to back after one warm-up call; the last call's
    tokens are fetched."""
    run()[0].cpu()
    t0 = time.perf_counter()
    for _ in range(iters):
        tokens = run()[0]
    tokens.cpu()
    return iters * rows / (time.perf_counter() - t0)


def finish(proc: subprocess.Popen, timeout: float) -> tuple[int, str, str]:
    """(exit code, stdout, stderr) of ``proc``, killed after ``timeout``
    seconds."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def export_cli(argv: list) -> None:
    """``chip_smoke.py --export-cli ARGS``: ``lrcn-torch export ARGS`` in
    this process (the CLI's default device, the card), printing as its
    last line the seconds of each trace and each save, in order."""
    import contextlib
    import io

    from lrcn_tpu_torch import cli
    from lrcn_tpu_torch import export as export_mod

    traces: list = []
    saves: list = []
    with timed(export_mod, "export_decoder", traces), \
            timed(export_mod, "export_image_pipeline", traces), \
            timed(torch.export, "save", saves), \
            contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main([*CLI_DEVICE_FLAGS, "export", *argv])
    check(rc == 0, f"lrcn-torch export {argv} returned {rc}")
    print(json.dumps({"traces": traces, "saves": saves}))


def reload_exported(work: str, part: str) -> None:
    """``chip_smoke.py --reload-export WORK PART``: phase 15's consumer, in
    a fresh process.  Loads PART's export directories under ``WORK`` on
    the card through ``lrcn_tpu_torch.export`` alone and runs each
    artifact on ``WORK/inputs.npz``, the kernels' counters read around one
    call of each; part "beam" then waits for ``WORK/go`` (the other part
    done) and times the beam artifact, part "rest" also loads the bf16
    directory on the CPU.  Tokens, scores, counts and times go to
    ``WORK/reload_PART.*`` for phase 15 to check."""
    from lrcn_tpu_torch.export import load_exported
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    t0 = time.perf_counter()
    models = {name: load_exported(os.path.join(work, name), "cuda")
              for name in RELOAD_PARTS[part]}
    load_s = time.perf_counter() - t0
    inputs = np.load(os.path.join(work, "inputs.npz"))
    feats = torch.from_numpy(inputs["feats"]).cuda()
    results, counts, routes, rates = {}, {}, {}, {}
    info = {"load_s": load_s}

    def call(label: str, model, variant: str, *args) -> None:
        model.call(variant, *args)                  # warm-up
        torch.cuda.synchronize()
        reset_counts(*fns)
        tokens, scores = model.call(variant, *args)
        results[f"{label} tokens"] = tokens.cpu().numpy()
        results[f"{label} scores"] = scores.cpu().numpy()
        counts[label] = read_counts(*fns)
        routes[label] = {fn.__name__: _routes_used(fn) for fn in fns}

    if part == "beam":
        bf16 = models["bf16"]
        for rows in EXPORT_ROWS:
            call(f"beam {rows}", bf16, "beam", feats[:rows])
        call(f"greedy {DECODE_BATCH}", bf16, "greedy", feats[:DECODE_BATCH])
        go = os.path.join(work, "go")
        deadline = time.monotonic() + 900
        while not os.path.exists(go):
            check(time.monotonic() < deadline, "no go file in 900 s")
            time.sleep(0.2)
        for rows in EXPORT_ROWS[1:]:
            rates[f"beam {rows}"] = captions_per_s(
                lambda: bf16.call("beam", feats[:rows]), rows)
    else:
        sample = feats[:SAMPLE_IMAGES]
        call(f"sample {SAMPLE_IMAGES}", models["sample"], "sample", sample,
             EXPORT_SEED)
        results["sample again tokens"] = models["sample"].call(
            "sample", sample, EXPORT_SEED)[0].cpu().numpy()
        call(f"image {EXPORT_IMAGES}", models["image"], "image",
             torch.from_numpy(inputs["pixels"]).cuda())
        call(f"beam f32 {DECODE_BATCH}", models["f32"], "beam",
             feats[:DECODE_BATCH])
        # the bf16 directory on the CPU (its matmuls on lrcn::mm_f32's CPU
        # route, its kernels' plain versions)
        t0 = time.perf_counter()
        cpu = load_exported(os.path.join(work, "bf16"), "cpu")
        tokens, scores = cpu.call("beam", inputs["feats"][:EXPORT_CPU_ROWS])
        info["cpu_s"] = time.perf_counter() - t0
        results["beam cpu tokens"] = tokens.numpy()
        results["beam cpu scores"] = scores.numpy()
    present = [name for name in ("lrcn_tpu_torch.models",
                                 "lrcn_tpu_torch.decode", "jax")
               if name in sys.modules]
    np.savez(os.path.join(work, f"reload_{part}.npz"), **results)
    info.update(counts=counts, routes=routes, rates=rates, present=present)
    with open(os.path.join(work, f"reload_{part}.json"), "w") as f:
        json.dump(info, f)
    print(f"[15 export reload {part}] a fresh process loaded "
          f"{list(RELOAD_PARTS[part])} on the card in {load_s:.1f} s"
          + (f", and the bf16 directory on the CPU (+ {EXPORT_CPU_ROWS} "
             f"rows through it) in {info['cpu_s']:.1f} s" if "cpu_s" in info
             else "")
          + f"; of lrcn_tpu_torch.models, lrcn_tpu_torch.decode and jax, "
          f"{present or 'none'} in sys.modules")


def check_export_captions(label: str, decoder, feats, got, want, vocab
                          ) -> str:
    """Hold an artifact's captions against the live path's on the same
    rows: at least CAPTION_AGREEMENT equal, and each differing one held by
    its score (the plain path teacher-forced along either search's caption
    gives that search's own score within EXPORT_SCORE_ATOL)."""
    from lrcn_tpu_torch.decode.writer import detokenize_batch

    (tok_a, sc_a), (tok_l, sc_l) = got, want
    cap_a = detokenize_batch(tok_a, vocab)
    cap_l = detokenize_batch(tok_l.cpu().numpy(), vocab)
    differ = [i for i, (a, b) in enumerate(zip(cap_a, cap_l)) if a != b]
    check(len(differ) <= (1 - CAPTION_AGREEMENT) * len(cap_a),
          f"{label}: {len(differ)}/{len(cap_a)} captions differ from the "
          f"live path's")
    rescored = [0.0]
    if differ:
        rows = torch.tensor(differ, device=feats.device)
        rescored = [path_score_error(
            decoder, feats[rows], torch.as_tensor(tok).to(feats.device)[rows],
            torch.as_tensor(sc).to(feats.device)[rows])
            for tok, sc in ((tok_a, sc_a), (tok_l, sc_l))]
        check(max(rescored) <= EXPORT_SCORE_ATOL,
              f"{label}: the differing captions' scores rescored on the "
              f"plain path are off by {rescored}")
    gap = float(np.abs(sc_a - sc_l.cpu().numpy()).max())
    return (f"{len(cap_a) - len(differ)}/{len(cap_a)} captions equal to the "
            f"live path's (max score gap {gap:.3g}; differing ones rescored "
            f"within {max(rescored):.3g}, tol {EXPORT_SCORE_ATOL})")


def export_runs(names=None) -> dict[str, list]:
    """``lrcn-torch export`` arguments of each of phase 15's directories
    (``names``: some of them), from phase 5's and phase 8's checkpoints."""
    ckpt, joint = os.path.join(WORK, "ckpt"), os.path.join(WORK, "joint")
    runs = {"bf16": ["--loadfile", ckpt, "--variants", "beam,greedy"],
            "sample": ["--loadfile", ckpt, "--variants", "sample",
                       "--sample-n", str(SAMPLE_N), "--temperature",
                       str(SAMPLE_T)],
            "f32": ["--loadfile", ckpt, "--compute-dtype", "float32"],
            "image": ["--loadfile", joint, "--variants", "image"]}
    return {name: argv for name, argv in runs.items()
            if names is None or name in names}


def export_dirs(runs: dict[str, list]) -> dict[str, tuple]:
    """Export each of ``runs`` into ``EXPORT_WORK/<name>``, one process a
    directory, all started together (tracing is host-bound Python, one
    core each); each process's (exit code, stdout, stderr), all exit
    codes checked."""
    shutil.rmtree(EXPORT_WORK, ignore_errors=True)
    os.makedirs(EXPORT_WORK)
    common = ["--beam_width", str(BEAM), "--generate", str(MAX_WORDS)]
    procs = {name: subprocess.Popen(
        [sys.executable, SCRIPT, "--export-cli", "--out",
         os.path.join(EXPORT_WORK, name), *common, *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for name, argv in runs.items()}
    outs = {name: finish(proc, 900) for name, proc in procs.items()}
    for name, (code, out, err) in outs.items():
        check(code == 0, f"lrcn-torch export {name} exited {code}:\n"
                         f"{err[-6000:]}")
    return outs


def phase_export(smi: str) -> dict[str, dict]:
    """Phase 15: ``lrcn-torch export`` of phase 5's checkpoint (beam and
    greedy, sample in bf16; beam in f32) and phase 8's joint checkpoint
    (image, bf16) at the reference width, one process a directory
    (``export_cli``), the directories reloaded and run in two fresh
    processes (``reload_exported``), and every artifact held against the
    live path on the same inputs.  Returns the kernels' launches of one
    beam, sample and image call of the artifacts."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.core.vocab import BOS_ID
    from lrcn_tpu_torch.data.images import normalize_batch
    from lrcn_tpu_torch.decode.beam import beam_search, greedy_search
    from lrcn_tpu_torch.decode.sample import best_of_n_search
    from lrcn_tpu_torch.models.vgg import CONV_NAMES, l1_normalize, vgg16_fc7
    from lrcn_tpu_torch.ops.kernels.topk_lse import topk_lse_route
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    work = EXPORT_WORK
    ckpt, joint = os.path.join(WORK, "ckpt"), os.path.join(WORK, "joint")
    runs = export_runs()
    t0 = time.perf_counter()
    outs = export_dirs(runs)
    export_s = time.perf_counter() - t0
    files = [("beam", "bf16"), ("greedy", "bf16"), ("sample", "sample"),
             ("beam", "f32"), ("image", "image")]
    times = {}
    for name, (_, out, _) in outs.items():
        logged = json.loads(out.strip().splitlines()[-1])
        variants = [v for v, d in files if d == name]
        check(len(logged["traces"]) == len(logged["saves"]) == len(variants),
              f"export {name}: {logged} for {variants}")
        for v, t, sv in zip(variants, logged["traces"], logged["saves"]):
            times[v, name] = (t, sv)
    sizes = {(v, d): os.path.getsize(os.path.join(work, d, f"{v}.pt2")) / 1e6
             for v, d in files}
    print(f"[15 export] lrcn-torch export at hidden {HIDDEN}, vocab {VOCAB},"
          f" --generate {MAX_WORDS}, beam {BEAM}, {len(runs)} processes at "
          f"once, {export_s:.1f} s in all; per artifact (trace s, save s, "
          f"MB): " + ", ".join(
              f"{v} {d}: {times[v, d][0]:.1f} s, {times[v, d][1]:.1f} s, "
              f"{sizes[v, d]:.1f} MB" for v, d in files) + f" on {smi}")

    rng = np.random.default_rng(SEED + 15)
    raw = np.abs(rng.standard_normal((EXPORT_ROWS[-1], CNN_DIM), np.float32))
    feats_np = (raw / raw.sum(axis=1, keepdims=True)).astype(np.float32)
    pixels_np = rng.integers(0, 256, (EXPORT_IMAGES, 224, 224, 3), np.uint8)
    np.savez(os.path.join(work, "inputs.npz"), feats=feats_np,
             pixels=pixels_np)
    # two fresh processes; the beam part times its artifact only after the
    # other part is done (the "go" file), so that nothing else runs then
    t0 = time.perf_counter()
    procs = {part: subprocess.Popen(
        [sys.executable, SCRIPT, "--reload-export", work, part],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
        for part in RELOAD_PARTS}
    code, out, err = finish(procs["rest"], 900)
    if code == 0:
        open(os.path.join(work, "go"), "w").close()
    else:
        procs["beam"].kill()
    sys.stdout.write(out)
    check(code == 0, f"the export reload (rest) exited {code}:\n"
                     f"{err[-6000:]}")
    code, out, err = finish(procs["beam"], 900)
    sys.stdout.write(out)
    check(code == 0, f"the export reload (beam) exited {code}:\n"
                     f"{err[-6000:]}")
    reload_s = time.perf_counter() - t0
    info = {"counts": {}, "routes": {}}
    got = {}
    for part in RELOAD_PARTS:
        with open(os.path.join(work, f"reload_{part}.json")) as f:
            one = json.load(f)
        check(one["present"] == [], f"the reload ({part}) imported "
                                    f"{one['present']}")
        info["counts"].update(one["counts"])
        info["routes"].update(one["routes"])
        if one["rates"]:
            info["rates"] = one["rates"]
        got.update(np.load(os.path.join(work, f"reload_{part}.npz")))

    # launches of one call of each artifact: the live path's
    steps = MAX_WORDS + 1
    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB)
    meta = lambda *shape: torch.empty(shape, device="meta")
    with np.load(os.path.join(joint, "params.npz")) as z:
        convs = [z[f"cnn/{n}/w"].shape for n in CONV_NAMES]
    conv_routes = expected_routes(cfg, convs, 1, BEAM)["fused_conv3x3_relu"]
    search = {"fused_lstm_step": {"wgmma": 2 * steps},
              "topk_logsumexp": {topk_lse_route(meta(DECODE_BATCH * BEAM,
                                                     VOCAB), BEAM): steps}}
    want = {f"beam {r}": search for r in EXPORT_ROWS}
    want[f"greedy {DECODE_BATCH}"] = {
        "fused_lstm_step": {"wgmma": 2 * steps},
        "topk_logsumexp": {topk_lse_route(meta(DECODE_BATCH, VOCAB), 1):
                           steps}}
    want[f"sample {SAMPLE_IMAGES}"] = {"fused_lstm_step": {"wgmma":
                                                           2 * steps}}
    want[f"image {EXPORT_IMAGES}"] = dict(search,
                                          fused_conv3x3_relu=conv_routes)
    want[f"beam f32 {DECODE_BATCH}"] = dict(
        search, fused_lstm_step={"fma": 2 * steps})
    for label, routes in want.items():
        used = {k: v for k, v in info["routes"][label].items() if v}
        check(used == routes, f"export {label}: launches by route {used}, "
                              f"want {routes}")

    # right answers against the live path on the same inputs
    ck = load_checkpoint(ckpt, device="cuda")
    decoder, vocab = ck["decoder"], ck["vocab"]
    feats = torch.from_numpy(feats_np).cuda()
    lines = []
    for rows in EXPORT_ROWS:
        live = beam_search(decoder, feats[:rows], beam_width=BEAM,
                           max_words=MAX_WORDS)
        lines.append(f"beam {rows}: " + check_export_captions(
            f"export beam {rows}", decoder, feats[:rows],
            (got[f"beam {rows} tokens"], got[f"beam {rows} scores"]), live,
            vocab))
    live = greedy_search(decoder, feats[:DECODE_BATCH], max_words=MAX_WORDS)
    lines.append(f"greedy {DECODE_BATCH}: " + check_export_captions(
        "export greedy", decoder, feats[:DECODE_BATCH],
        (got[f"greedy {DECODE_BATCH} tokens"],
         got[f"greedy {DECODE_BATCH} scores"]), live, vocab))
    gen = torch.Generator(device="cuda").manual_seed(EXPORT_SEED)
    live_t, _ = best_of_n_search(decoder, feats[:SAMPLE_IMAGES],
                                 n_samples=SAMPLE_N, temperature=SAMPLE_T,
                                 max_words=MAX_WORDS, generator=gen)
    sample_t = got[f"sample {SAMPLE_IMAGES} tokens"]
    check(np.array_equal(sample_t, got["sample again tokens"]),
          "export sample: the same seed gave other tokens")
    check(np.array_equal(sample_t, live_t.cpu().numpy()),
          "export sample: tokens differ from the live path's under the "
          "same seed")
    rates = {}
    for rows in EXPORT_ROWS[1:]:
        rates[rows] = captions_per_s(lambda: beam_search(
            decoder, feats[:rows], beam_width=BEAM, max_words=MAX_WORDS),
            rows)
    del ck, decoder
    ckj = load_checkpoint(joint, device="cuda")
    avg = torch.from_numpy(ckj["average_image"]).cuda()
    pixels = torch.from_numpy(pixels_np).cuda()
    fc7 = l1_normalize(vgg16_fc7(ckj["vgg"], normalize_batch(pixels, avg)))
    live = beam_search(ckj["decoder"], fc7, beam_width=BEAM,
                       max_words=MAX_WORDS)
    lines.append(f"image {EXPORT_IMAGES}: " + check_export_captions(
        "export image", ckj["decoder"], fc7,
        (got[f"image {EXPORT_IMAGES} tokens"],
         got[f"image {EXPORT_IMAGES} scores"]), live, ckj["vocab"]))
    del ckj, fc7
    dec32 = load_checkpoint(ckpt, device="cuda",
                            compute_dtype=torch.float32)["decoder"]
    tok32, _ = beam_search(dec32, feats[:DECODE_BATCH], beam_width=BEAM,
                           max_words=MAX_WORDS)
    equal32 = (got[f"beam f32 {DECODE_BATCH} tokens"]
               == tok32.cpu().numpy()).all(axis=1).mean()
    check(equal32 >= CAPTION_AGREEMENT, f"export f32 beam: {equal32:.4f} of "
                                        f"the rows' tokens equal the live "
                                        f"path's")
    cpu_t = got["beam cpu tokens"]
    check(cpu_t.shape == (EXPORT_CPU_ROWS, MAX_WORDS + 2)
          and (cpu_t[:, 0] == BOS_ID).all()
          and np.isfinite(got["beam cpu scores"]).all(),
          "export beam on the CPU: malformed result")
    cpu_equal = int((cpu_t == got[f"beam {DECODE_BATCH} tokens"][
        :EXPORT_CPU_ROWS]).all(axis=1).sum())
    print(f"[15 export] right answers, bf16: " + "; ".join(lines)
          + f"; sample {SAMPLE_IMAGES} (best-of-{SAMPLE_N}, seed "
          f"{EXPORT_SEED}): tokens equal for the seed twice and to the live "
          f"path's under torch.Generator('cuda').manual_seed({EXPORT_SEED});"
          f" f32 beam {DECODE_BATCH} (TF32 off): {equal32:.4f} of the rows' "
          f"tokens equal to the live path's (need {CAPTION_AGREEMENT}); the "
          f"bf16 directory on the CPU: {cpu_equal}/{EXPORT_CPU_ROWS} rows "
          f"equal to the card's (printed, not held: bf16 sums in another "
          f"order)")
    print(f"[15 export] launches per call, by route: " + "; ".join(
        f"{label}: {info['routes'][label]}" for label in want))
    print("[15 export] captions/s, beam-{} bf16, the loaded artifact vs the "
          "live path (f32 fc7 rows, the same call): ".format(BEAM)
          + ", ".join(f"{rows // DECODE_BATCH}x{DECODE_BATCH}: "
                      f"{info['rates'][f'beam {rows}']:.1f} vs "
                      f"{rates[rows]:.1f}" for rows in EXPORT_ROWS[1:])
          + f" on {smi}; reload processes {reload_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"export_beam": info["counts"][f"beam {DECODE_BATCH}"],
            "export_sample": info["counts"][f"sample {SAMPLE_IMAGES}"],
            "export_image": info["counts"][f"image {EXPORT_IMAGES}"]}


def mesh_rank(rank: int, world: int, work: str) -> None:
    """One of phase 16's training ranks (``--mesh-rank``): join a gloo
    group on the card (NCCL refuses a second rank on one GPU), then the
    narrow f32 steps of ``mesh_inputs`` over meshes that list the card
    twice: ``ShardedTrainStep`` at (2, 1) and (1, 2), ``PipelinedTrainStep``
    at (1, 2), ``JointTrainStep`` at (2, 1).  Then two more steps of each
    through its graphed entry point, which under gloo runs the eager
    body.  Writes each step's loss and gathered gradients, the graph
    captures and whether the groups are capturable, and the kernels'
    launch counts, to ``work/rank<rank>.pkl``."""
    import pickle

    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.models.joint import (JointParams, JointTrainStep,
                                             make_joint_optimizer)
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.parallel import distributed as pdist
    from lrcn_tpu_torch.parallel import make_mesh
    from lrcn_tpu_torch.parallel.pipeline import PipelinedTrainStep
    from lrcn_tpu_torch.parallel.train import ShardedTrainStep
    from lrcn_tpu_torch.train.joint import load_joint_params
    from lrcn_tpu_torch.utils import graphs

    pdist.initialize(f"file://{os.path.join(work, 'rendezvous')}", world,
                     rank, backend="gloo")
    with open(os.path.join(work, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    devices = [torch.device("cuda", 0)] * world
    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    reset_counts(*fns)
    out = {}
    t0 = time.perf_counter()
    for name, shape in (("sharded 2x1", (2, 1)), ("sharded 1x2", (1, 2)),
                        ("pipelined 1x2", (1, 2)), ("joint 2x1", (2, 1))):
        kind = name.split()[0]
        cfg_kw, tree, batch, masks = inputs[kind]
        cfg = LRCNConfig(**cfg_kw)
        mesh = make_mesh(shape, devices=devices)
        masks = tuple(torch.from_numpy(m) for m in masks)
        if kind == "joint":
            step = JointTrainStep(
                cfg, make_joint_optimizer(cfg), mesh=mesh,
                average_image=np.full((224, 224, 3), JOINT_MEAN, np.float32))
            params = load_joint_params(tree, step.device)
            state = step.opt.init(params)
            loss = step.value_and_grad(params, state,
                                       *step.shard_batch(*batch),
                                       drop_masks=masks)
            grads = {f"{part}/{k}": p.grad.cpu().numpy()
                     for part, ps in zip(JointParams._fields, params)
                     for k, p in ps.items()}
            for key in (1, 2):
                step(params, state, *step.shard_batch(*batch), key)
        else:
            step = (PipelinedTrainStep if kind == "pipelined"
                    else ShardedTrainStep)(cfg, mesh)
            params = step.shard_params(tree)
            opt = step.init_opt(params)
            loss = step.value_and_grad(params, opt, *step.shard_batch(*batch),
                                       drop_masks=masks)
            grads = pdist.gather_to_host(
                {k: params[k].grad for k in step.specs}, mesh, step.specs)
            for key in (1, 2):
                step(params, opt, *step.shard_batch(*batch), key)
        out[name] = (float(loss), grads)
        out.setdefault("capturable", []).append(graphs.capturable(
            torch.zeros(1, device=mesh.local_device()), mesh.groups()))
    torch.cuda.synchronize()
    out["graphs"] = dict(graphs.stats)
    out["seconds"] = time.perf_counter() - t0
    out["counts"] = read_counts(*fns)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    pdist.barrier("mesh_rank")
    pdist.shutdown()


def mesh_inputs(work: str) -> dict:
    """The narrow f32 models, batches and GLOBAL dropout masks of phase
    16's rank steps, written to ``work/inputs.pkl`` for the ranks:
    ``decoder`` (phase 10's narrow width), ``pipelined`` (hidden = embed)
    and ``joint`` (phase 12's narrow joint model)."""
    import pickle

    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.models import lrcn
    from lrcn_tpu_torch.models.lrcn import flat_tree

    rng = np.random.default_rng(SEED + 16)
    gen = torch.Generator().manual_seed(SEED + 16)
    b, l = MESH_TRAIN_BATCH, NARROW_LEN
    lengths = rng.integers(1, l + 1, b).astype(np.int32)
    lengths[-1] = -1                        # a filler row, as batches pad
    tokens = rng.integers(3, NARROW["vocab_size"], (b, l)).astype(np.int32)
    tokens[np.arange(l)[None, :] >= lengths[:, None]] = 0
    feats = rng.standard_normal((b, NARROW["cnn_feature_dim"])
                                ).astype(np.float32)
    inputs = {}
    for kind, dims in (("sharded", NARROW), ("pipelined", MESH_PP_NARROW)):
        cfg = LRCNConfig(**dims, dropout=TRAIN_DROPOUT,
                         compute_dtype="float32")
        tree = flat_tree(lrcn.init_params(cfg, gen))
        masks = lrcn.dropout_masks((l + 1, b, cfg.embed),
                                   (l + 1, b, 2 * cfg.factor_dim),
                                   TRAIN_DROPOUT, gen)
        inputs[kind] = (dataclasses.asdict(cfg), tree,
                        (tokens, lengths, feats),
                        tuple(m.numpy() for m in masks))
    cfg = LRCNConfig(**JOINT_NARROW, vocab_size=NARROW["vocab_size"],
                     dropout=TRAIN_DROPOUT, compute_dtype="float32")
    tree = {f"decoder/{k}": v for k, v in
            flat_tree(lrcn.init_params(cfg, gen)).items()}
    tree.update({f"cnn/{k}": v for k, v in flat_tree(_narrow_vgg()).items()})
    jb = JOINT_NARROW_BATCH
    images = rng.integers(0, 256, (jb, 224, 224, 3)).astype(np.uint8)
    masks = lrcn.dropout_masks((l + 1, jb, cfg.embed),
                               (l + 1, jb, 2 * cfg.factor_dim),
                               TRAIN_DROPOUT, gen)
    inputs["joint"] = (dataclasses.asdict(cfg), tree,
                       (images, tokens[:jb], lengths[:jb]),
                       tuple(m.numpy() for m in masks))
    with open(os.path.join(work, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    return inputs


def mesh_reference(inputs: dict) -> dict:
    """The one-process f32 steps on the card for ``mesh_inputs``: the loss
    and every gradient (the pipeline's in its stacked layout)."""
    from lrcn_tpu_torch.parallel.pipeline import to_pipeline_params

    out = {}
    for kind in ("sharded", "pipelined"):
        _, tree, batch, masks = inputs[kind]
        loss, grads = narrow_step("cuda", tree, batch,
                                  tuple(map(torch.from_numpy, masks)),
                                  torch.float32)
        grads = {k: g.numpy() for k, g in grads.items()}
        if kind == "pipelined":
            grads = to_pipeline_params(grads)
        out[kind] = (loss, grads)
    _, tree, batch, masks = inputs["joint"]
    loss, grads = joint_narrow_step("cuda", tree, batch,
                                    tuple(map(torch.from_numpy, masks)))
    out["joint"] = (loss, {k: g.numpy() for k, g in grads.items()})
    return out


def phase_mesh_ranks() -> float:
    """Two gloo ranks on the card (``chip_smoke.py --mesh-rank``) against
    the one-process step: loss and every gradient within ``MESH_TOL`` of
    the largest entry, and no kernel launched in any rank.  Returns the
    seconds."""
    import pickle

    t0 = time.perf_counter()
    work = os.path.join(WORK, "mesh_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    inputs = mesh_inputs(work)
    env = {k: v for k, v in os.environ.items() if k != "WORLD_SIZE"}
    procs = [subprocess.Popen([sys.executable, SCRIPT, "--mesh-rank",
                               str(r), str(MESH_RANKS), work],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for r in range(MESH_RANKS)]
    try:
        want = mesh_reference(inputs)
        outs = [finish(p, MESH_RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (code, out, err) in enumerate(outs):
        check(code == 0, f"mesh rank {rank} exited {code}: {err[-3000:]}")
    ranks = []
    for rank in range(MESH_RANKS):
        with open(os.path.join(work, f"rank{rank}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    lines = []
    for name in ("sharded 2x1", "sharded 1x2", "pipelined 1x2",
                 "joint 2x1"):
        want_loss, want_grads = want[name.split()[0]]
        worst_key, worst = None, 0.0
        for rank, got in enumerate(ranks):
            loss, grads = got[name]
            loss_err = abs(loss - want_loss) / abs(want_loss)
            check(set(grads) == set(want_grads),
                  f"{name}: gradients {sorted(grads)}")
            check(loss_err <= MESH_TOL, f"{name} rank {rank}: loss {loss} "
                                        f"vs the one-process {want_loss}")
            for k, g in want_grads.items():
                err = float(np.abs(grads[k] - g).max()
                            / max(np.abs(g).max(), 1e-30))
                tol = MESH_CNN_TOL if k.startswith("cnn/") else MESH_TOL
                check(err <= tol, f"{name} rank {rank}: gradient of {k} off "
                                  f"by {err:.3g} of its largest entry (tol "
                                  f"{tol})")
                if err >= worst:
                    worst_key, worst = k, err
        rest = max(float(np.abs(ranks[0][name][1][k] - g).max()
                         / max(np.abs(g).max(), 1e-30))
                   for k, g in want_grads.items() if not k.startswith("cnn/"))
        lines.append(f"{name}: loss {ranks[0][name][0]:.6f} (one process "
                     f"{want_loss:.6f}), {len(want_grads)} gradients, worst "
                     f"{worst_key} {worst:.3g}, worst outside the CNN "
                     f"{rest:.3g}")
    counts = [r["counts"] for r in ranks]
    check(all(sum(c.values()) == 0 for c in counts),
          f"the rank steps launched hand-written kernels: {counts}")
    check(all(r["graphs"]["captures"] == 0 and not any(r["capturable"])
              for r in ranks),
          f"the gloo ranks captured graphs: "
          f"{[(r['graphs'], r['capturable']) for r in ranks]}")
    seconds = time.perf_counter() - t0
    print(f"[16 mesh] {MESH_RANKS} gloo ranks on cuda:0 (NCCL refuses one "
          f"card twice), f32, TF32 off, dropout {TRAIN_DROPOUT} with the "
          f"global masks, against the one-process step (tol {MESH_TOL} of "
          f"the largest entry, {MESH_CNN_TOL} for the CNN's): "
          + "; ".join(lines) + f"; two more steps of each through "
          f"its graphed entry point took the eager body (graphs.capturable "
          f"False for the gloo groups, 0 captures on each rank); no kernel "
          f"launched; the ranks' steps {max(r['seconds'] for r in ranks):.1f}"
          f" s, {seconds:.1f} s in all")
    return seconds


@contextmanager
def counted_all_reduces():
    """Count the ``torch.distributed.all_reduce`` calls of the block: those
    made while the current stream captures a graph ("captured") and the
    others ("eager").  A replay runs no Python and counts none."""
    counts = {"eager": 0, "captured": 0}
    real = torch.distributed.all_reduce

    def counting(*args, **kwargs):
        counts["captured" if torch.cuda.is_current_stream_capturing()
               else "eager"] += 1
        return real(*args, **kwargs)

    torch.distributed.all_reduce = counting
    try:
        yield counts
    finally:
        torch.distributed.all_reduce = real


def nccl_trainer(smi: str, work: str):
    """Phase 16, the one-rank NCCL ``Trainer(mesh=make_mesh((1, 1)))`` at
    phase 10's geometry: four K=8 dispatches on chunks A, A, B, C (eager,
    capture, two replays) against an eager twin from the same tree, the
    losses, parameters and 19 optax leaves bit-equal, with the
    ``all_reduce``s of the eager call and of the capture counted;
    ``average_loss``'s K-batch graphs against eager; eager against
    graphed ms per step through ``train_epoch``; rank 0's checkpoint
    restored in the one-device ``Trainer``.  Returns the figures and the
    graphed optimizer, whose graphs the group's shutdown must drop."""
    from lrcn_tpu_torch.models.lrcn import PARAM_KEYS
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.parallel import make_mesh
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint
    from lrcn_tpu_torch.train.metrics import MetricsLogger
    from lrcn_tpu_torch.train.trainer import Trainer
    from lrcn_tpu_torch.utils import graphs

    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    one, params1, _, batches, store = train_setup()
    tree = {k: params1[k].detach().cpu().numpy() for k in params1}
    trainer = Trainer(one.cfg, one.vocab, metrics=MetricsLogger(echo=False),
                      steps_per_dispatch=TRAIN_K, mesh=make_mesh((1, 1)))
    del one, params1
    groups = trainer.mesh.groups()
    check(len(groups) == 2 and graphs.capturable(
        torch.zeros(1, device="cuda"), groups),
        f"the one-rank NCCL mesh's groups are not capturable: "
        f"{[torch.distributed.get_backend(g) for g in groups]}")
    params, opt = trainer.restore(tree)
    twin, twin_opt = trainer.restore(tree)
    table = trainer._device_table(store)
    chunks = [trainer._stacked(batches[i * TRAIN_K:(i + 1) * TRAIN_K],
                               store)[1] for i in range(4)]
    order = (0, 0, 1, 2)

    def dispatch(p, o, d):
        return trainer._dispatch(p, o, *chunks[order[d]], table, 1,
                                 TRAIN_K * d)

    base = reserved_mb()
    reset_counts(*fns)
    got, seconds, reduces = [], [], []
    for d in range(4):
        with counted_all_reduces() as n:
            losses, sec = timed_call(lambda: dispatch(params, opt, d))
        got.append(losses)
        seconds.append(sec)
        reduces.append(n)
        if d == 1:
            kept = reserved_mb() - base
    counts = read_counts(*fns)
    check(sum(counts.values()) == 0,
          f"the NCCL trainer launched hand-written kernels: {counts}")
    # each step reduces the token count, the gradients (one flat buffer)
    # and the reported loss over the data group; the clip is off
    per = 3 * TRAIN_K
    check(reduces == [{"eager": per, "captured": 0},
                      {"eager": 0, "captured": per},
                      {"eager": 0, "captured": 0},
                      {"eager": 0, "captured": 0}],
          f"NCCL trainer: all_reduces by dispatch {reduces}")
    with eager_bodies():
        want = [dispatch(twin, twin_opt, d) for d in range(4)]
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"NCCL trainer: graphed losses {[g.tolist() for g in got]} "
          f"against eager {[w.tolist() for w in want]}")
    differ = [k for k in PARAM_KEYS if not torch.equal(params[k], twin[k])]
    check(not differ, f"NCCL trainer: parameters {differ} differ from the "
                      f"eager twin's after 4 dispatches")
    leaves, twin_leaves = opt.state_leaves(), twin_opt.state_leaves()
    check(len(leaves) == 19 and int(leaves[0]) == 4 * TRAIN_K
          and all(np.array_equal(a, b) for a, b in zip(leaves, twin_leaves)),
          "NCCL trainer: Adam's leaves differ from the eager twin's")
    (entry,) = graphs.graphs(opt)
    check(entry.replays == 3, f"NCCL trainer: {entry.replays} replays")
    with counted_all_reduces() as n_eval:
        evals = [trainer.average_loss(params, batches, store)
                 for _ in range(2)]
    with eager_bodies():
        eager_eval = trainer.average_loss(params, batches, store)
    check(all(e == eager_eval for e in evals)
          and n_eval["captured"] == 2 * TRAIN_K,
          f"NCCL trainer: graphed K-batch evaluation {evals} against eager "
          f"{eager_eval}; all_reduces {n_eval}")

    timed = batches[TRAIN_K:]

    def epoch(p, o):
        trainer.train_epoch(p, o, timed, store, 2, np.random.default_rng(
            SEED), log_every=0)                 # train_epoch synchronizes

    ms = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        t0 = time.perf_counter()
        if name == "eager":
            with eager_bodies():
                epoch(twin, twin_opt)
        else:
            epoch(params, opt)
        ms[name].append((time.perf_counter() - t0) / len(timed) * 1e3)
    check(all(torch.equal(params[k], twin[k]) for k in PARAM_KEYS),
          "NCCL trainer: graphed and eager epochs part")
    path = os.path.join(work, "ckpt")
    trainer._save(path, params, opt, epoch=1)
    ck = load_checkpoint(path, "cuda", opt_state=True)
    check(len(ck["opt_leaves"]) == 19, f"{len(ck['opt_leaves'])} "
                                       f"optimizer leaves")
    back, back_opt = Trainer(trainer.cfg, trainer.vocab,
                             metrics=MetricsLogger(echo=False),
                             device="cuda").restore(ck["params"],
                                                    ck["opt_leaves"])
    steps = int(opt.state_leaves()[0])
    check(all(torch.equal(back[k], params[k].detach()) for k in back)
          and int(back_opt.state_leaves()[0]) == steps,
          "the NCCL rank's checkpoint does not restore in the one-device "
          "Trainer")
    return {"ms": ms, "first_call_s": seconds[0],
            "capture_call_s": seconds[1], "capture_kept_mb": kept,
            "per_dispatch": per, "eval": evals[-1], "count": steps,
            "eval_captured": n_eval["captured"]}, opt


def nccl_joint() -> dict:
    """Phase 16, the one-rank NCCL ``JointTrainStep(mesh=make_mesh((1,
    1)))`` at phase 12's geometry: K=4 dispatches on chunks A, A, B
    (eager, capture, a replay) against an eager twin under cuDNN's
    deterministic algorithms (losses equal, parameters within RESUME_RTOL
    of their largest entry), ``all_reduce``s counted, ``eval_batch``
    graphed against eager; then, a new optimizer under the default
    algorithms, eager against graphed ms per step."""
    from lrcn_tpu_torch.models import lrcn
    from lrcn_tpu_torch.parallel import make_mesh

    step, params, opt_state, chunk = joint_setup(make_mesh((1, 1)))
    twin = copy.deepcopy(params)
    twin_opt = step.opt.init(twin)
    chunks = [chunk, (chunk[0].flip(2), *chunk[1:])]
    order = (0, 0, 1)
    per = 3 * JOINT_K
    torch.backends.cudnn.deterministic = True
    try:
        got, reduces = [], []
        for d, c in enumerate(order):
            with counted_all_reduces() as n:
                got.append(step.multi_step(params, opt_state, *chunks[c], 3,
                                           4 * d)[2])
            reduces.append(n)
        with eager_bodies():
            want = [step.multi_step(twin, twin_opt, *chunks[c], 3, 4 * d)[2]
                    for d, c in enumerate(order)]
        batch = [t[0] for t in chunks[1]]
        with counted_all_reduces() as n_eval:
            evals = [torch.stack(step.eval_batch(params, *batch))
                     for _ in range(3)]
        with eager_bodies():
            eager_eval = torch.stack(step.eval_batch(params, *batch))
    finally:
        torch.backends.cudnn.deterministic = False
    check(reduces == [{"eager": per, "captured": 0},
                      {"eager": 0, "captured": per},
                      {"eager": 0, "captured": 0}]
          and n_eval == {"eager": 4, "captured": 2},
          f"NCCL joint step: all_reduces by dispatch {reduces}, of the "
          f"evaluations {n_eval}")
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"NCCL joint step: graphed losses {[g.tolist() for g in got]} "
          f"against eager {[w.tolist() for w in want]}")
    check(all(torch.equal(e, eager_eval) for e in evals),
          f"NCCL joint eval_batch {evals} against eager {eager_eval}")
    flat, twin_flat = lrcn.flat_tree(params), lrcn.flat_tree(twin)
    errs = {k: float(np.abs(flat[k] - twin_flat[k]).max()
                     / max(np.abs(twin_flat[k]).max(), 1e-30))
            for k in flat}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= RESUME_RTOL, f"NCCL joint step: {worst} off by "
                                      f"{errs[worst]:.3g} from the eager "
                                      f"twin's")
    equal = all(np.array_equal(flat[k], twin_flat[k]) for k in flat)
    del twin, twin_opt, flat, twin_flat, opt_state
    base = reserved_mb()
    opt_state = step.opt.init(params)
    seconds = []
    for d in range(2):
        _, sec = timed_call(lambda: step.multi_step(params, opt_state,
                                                    *chunks[0], 5, 4 * d))
        seconds.append(sec)
        if d == 1:
            kept = reserved_mb() - base
    ms = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        def call():
            step.multi_step(params, opt_state, *chunks[1], 5, 8)
        if name == "eager":
            with eager_bodies():
                wall, _ = graph_wall_ms(call, 2)
        else:
            wall, _ = graph_wall_ms(call, 2)
        ms[name].append(wall / JOINT_K)
    return {"ms": ms, "first_call_s": seconds[0],
            "capture_call_s": seconds[1], "capture_kept_mb": kept,
            "per_dispatch": per, "worst": (worst, errs[worst]),
            "bit_equal": equal, "losses": got[-1].tolist()}


def phase_mesh_nccl(smi: str) -> float:
    """A one-rank NCCL group at the reference width: the ``Trainer`` and
    the joint step over ``make_mesh((1, 1))``, each dispatch graphed with
    its ``all_reduce``s and held against an eager twin (``nccl_trainer``,
    ``nccl_joint``); ms per step graphed and eager beside phases 10 and
    12's one-device figures; the group's shutdown drops the graphs that
    replay its communicators.  Returns the seconds."""
    from lrcn_tpu_torch.parallel import distributed as pdist
    from lrcn_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    work = os.path.join(WORK, "mesh_nccl")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    before = live_graphs()
    pdist.initialize(f"file://{os.path.join(work, 'rendezvous')}", 1, 0,
                     backend="nccl")
    try:
        backend = torch.distributed.get_backend()
        train, opt = nccl_trainer(smi, work)
        t1 = time.perf_counter()
        joint = nccl_joint()
        t2 = time.perf_counter()
        alive = len(graphs.graphs(opt))
    finally:
        pdist.shutdown()
    after = live_graphs()
    check(alive == 1 and graphs.graphs(opt) == [] and after == before,
          f"after the NCCL group's shutdown: the trainer's optimizer holds "
          f"{len(graphs.graphs(opt))} graphs ({alive} before), "
          f"{after} graphs alive ({before} before the group)")
    del opt
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    env = {k: os.environ.get(k) for k in ("TORCH_NCCL_BLOCKING_WAIT",
                                          "TORCH_NCCL_ASYNC_ERROR_HANDLING")}
    t, j = train["ms"], joint["ms"]
    print(f"[16 mesh] one-rank {backend} group (NCCL {nccl}, {env}) on "
          f"{smi}: Trainer(mesh=make_mesh((1, 1))) at the reference width, "
          f"bf16, B={TRAIN_BATCH}, L={TRAIN_LEN}, K={TRAIN_K}, dropout "
          f"{TRAIN_DROPOUT}: four dispatches (eager, capture, two replays "
          f"on other batches) bit-equal to an eager twin: losses, "
          f"parameters and the 19 optax leaves; all_reduces of a dispatch "
          f"{train['per_dispatch']} eager, then {train['per_dispatch']} "
          f"captured, none from a replay; average_loss (K-batch graphs, "
          f"{train['eval_captured']} all_reduces captured) "
          f"{train['eval']:.6f} = eager; ms per step through train_epoch "
          f"over {TRAIN_DISPATCHES * TRAIN_K} steps: graphed "
          f"{t['graphed'][0]:.3f}, {t['graphed'][1]:.3f}; eager "
          f"{t['eager'][0]:.3f}, {t['eager'][1]:.3f} (phase 10, one "
          f"device, graphed: {RESULTS.get('train_ms', float('nan')):.3f}); "
          f"first call (eager) {train['first_call_s']:.3f} s, capturing "
          f"call {train['capture_call_s']:.3f} s, the capture kept "
          f"{train['capture_kept_mb']:.1f} MB; no kernel launched; rank "
          f"0's checkpoint (19 global optax leaves, count "
          f"{train['count']}) restores in the one-device Trainer")
    print(f"[16 mesh] one-rank {backend} group on {smi}: JointTrainStep("
          f"mesh=make_mesh((1, 1))) at the reference width, B={JOINT_BATCH}"
          f", L={JOINT_LEN}, K={JOINT_K}, dropout {TRAIN_DROPOUT}, bf16, "
          f"remat, cudnn.deterministic: three dispatches (eager, capture, a "
          f"replay on other images) against an eager twin: losses equal "
          f"({joint['losses']}), parameters within {joint['worst'][1]:.3g} "
          f"of their largest entry ({joint['worst'][0]}; tol {RESUME_RTOL})"
          f", bit-equal: {joint['bit_equal']}; all_reduces of a dispatch "
          f"{joint['per_dispatch']} eager, then captured; eval_batch "
          f"graphed = eager; a new optimizer, default algorithms: ms per "
          f"step graphed {j['graphed'][0]:.3f}, {j['graphed'][1]:.3f}; "
          f"eager {j['eager'][0]:.3f}, {j['eager'][1]:.3f} (phase 12, one "
          f"device, graphed: {RESULTS.get('joint_ms', float('nan')):.3f}); "
          f"first call {joint['first_call_s']:.3f} s, capturing call "
          f"{joint['capture_call_s']:.3f} s, the capture kept "
          f"{joint['capture_kept_mb']:.1f} MB")
    seconds = time.perf_counter() - t0
    print(f"[16 mesh] after the NCCL group's shutdown: the trainer's "
          f"optimizer, still alive, holds no graph; live_graphs() "
          f"{after} ({before} before the group); {seconds:.1f} s (trainer "
          f"{t1 - t0:.1f}, joint step {t2 - t1:.1f})")
    print(json.dumps({"mesh_nccl": {"trainer": train, "joint": joint}}))
    return seconds


def phase_mesh(smi: str, rng) -> dict[str, int]:
    """Phase 16: multi-device on the one card.  Serving over a mesh that
    lists the card twice (each search and encoder batch split into two
    shards, each on its own stream; phase 5's store and phase 8's joint
    checkpoint), f32 captions equal to the one-device service's, bf16
    agreement, the CLI's ``serve --mesh``; then training over two gloo
    ranks and a one-rank NCCL group.  Returns the main path's launches."""
    import http.client
    import threading

    import lrcn_tpu_torch.serve.service as service_mod
    from lrcn_tpu_torch import cli
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.decode.writer import detokenize_batch
    from lrcn_tpu_torch.data.images import normalize_batch
    from lrcn_tpu_torch.models.vgg import CONV_NAMES, vgg16_fc7
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.parallel import make_mesh
    from lrcn_tpu_torch.parallel.decode import sharded_beam_search
    from lrcn_tpu_torch.serve import CaptionService, make_server
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint
    from lrcn_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    card = torch.device("cuda", 0)
    mesh = make_mesh((MESH_SHARDS, 1), devices=[card] * MESH_SHARDS)
    joint = os.path.join(WORK, "joint")
    ck = load_checkpoint(joint, "cuda")
    cfg, vocab = ck["cfg"], ck["vocab"]
    store = FeatureStore.load(os.path.join(WORK, "store"))
    ids = store.ids()
    svc = CaptionService(cfg, ck["decoder"], vocab, store=store,
                         vgg=ck["vgg"], average_image=ck["average_image"],
                         beam_width=BEAM, max_words=MAX_WORDS,
                         decode_batch=DECODE_BATCH, mesh=mesh)
    svc.warmup()
    raw = np.abs(rng.standard_normal((MESH_FEATURES, CNN_DIM))
                 ).astype(np.float32)
    images = list(rng.integers(0, 256, (MESH_IMAGES, 224, 224, 3),
                               dtype=np.uint8))
    requests = [("ids", ids[:DECODE_BATCH]),
                ("ids", ids[DECODE_BATCH:MESH_IDS]),
                ("features", list(raw)), ("images", images)]

    def answer(req):
        kind, items = req
        return {"ids": svc.caption_ids, "features": svc.caption_features,
                "images": svc.caption_images}[kind](items)

    # the main path: every count starts at 0 here
    searches, encodes = [], []
    modules = {"decoder": svc._decoders[0], "encoder": svc._vggs[0]}
    replays = {id(g): g.replays for m in modules.values()
               for g in graphs.graphs(m)}
    reset_counts(*fns)
    t1 = time.perf_counter()
    with counted_searches(searches, encodes):
        with ThreadPoolExecutor(max_workers=len(requests)) as pool:
            answers = list(pool.map(answer, requests))
    serve_s = time.perf_counter() - t1
    launches = read_counts(*fns)
    used = {fn.__name__: _routes_used(fn) for fn in fns}
    svc.close()
    # the two shards share the card's one replica of each module; each
    # shard's stream replays graphs of its own
    check(all(m is svc._decoders[1] or m is svc._vggs[1]
              for m in modules.values()), "a replica per shard on one card")
    shard_streams = {s.cuda_stream for s in svc._shards.streams}
    replayed = {name: {g.stream for g in graphs.graphs(m)
                       if g.replays > replays.get(id(g), 0)}
                for name, m in modules.items()}
    check(all(r == shard_streams for r in replayed.values()),
          f"mesh service: graphs replayed on streams {replayed}, want each "
          f"module's on both shards' streams {shard_streams}")
    for (kind, items), lines in zip(requests, answers):
        check(len(lines) == len(items) and all(
            isinstance(x, str) and x.endswith(" .") for x in lines),
            f"mesh service {kind}: {len(lines)} answers for {len(items)}")
    with np.load(os.path.join(joint, "params.npz")) as z:
        convs = [z[f"cnn/{n}/w"].shape for n in CONV_NAMES]
    steps = MAX_WORDS + 1
    want = {"fused_conv3x3_relu": _scaled(expected_routes(
        cfg, convs, 1, BEAM)["fused_conv3x3_relu"], len(encodes)),
        "fused_lstm_step": {}, "topk_logsumexp": {}}
    for rows_k in searches:
        per_step = expected_routes(cfg, [], rows_k, BEAM)
        for name in ("fused_lstm_step", "topk_logsumexp"):
            for route, n in per_step[name].items():
                want[name][route] = want[name].get(route, 0) + n * steps
    shard_rows = DECODE_BATCH // MESH_SHARDS * BEAM
    check(len(searches) % MESH_SHARDS == 0
          and min(searches) == shard_rows
          and len(encodes) % MESH_SHARDS == 0
          and set(encodes) == {ENCODE_BATCH // MESH_SHARDS}
          and launches["fused_lstm_step"] == 2 * steps * len(searches)
          and launches["topk_logsumexp"] == steps * len(searches)
          and launches["fused_conv3x3_relu"] == 13 * len(encodes)
          and used == want,
          f"mesh service: launches {launches} by route {used} in "
          f"{len(searches)} shard searches of {sorted(set(searches))} rows "
          f"and {len(encodes)} shard encoder batches; want {want}")
    print(f"[16 mesh] service over make_mesh(({MESH_SHARDS}, 1), "
          f"[cuda:0] x {MESH_SHARDS}), bf16, beam {BEAM}, decode batch "
          f"{DECODE_BATCH} ({shard_rows} LSTM rows a shard), encode batch "
          f"{ENCODE_BATCH}: {sum(map(len, answers))} captions for "
          f"{len(requests)} concurrent requests (ids, features, "
          f"{MESH_IMAGES} images) in {serve_s:.3f} s; "
          f"{len(searches) // MESH_SHARDS} searches and "
          f"{len(encodes) // MESH_SHARDS} encoder batches, each as "
          f"{MESH_SHARDS} shards (shard searches of "
          f"{sorted(set(searches))} rows); launches {launches}, by route "
          f"{used}; graphs replayed on each shard's own stream: " + ", ".join(
              f"{name} {sum(g.stream == st for g in graphs.graphs(m))} "
              f"graphs a shard" for name, m in modules.items()
              for st in sorted(shard_streams)[:1]))

    # the sharded search against one-device searches, bf16 and f32: of
    # each shard's rows (the same products: token for token, score for
    # score), and, printed, of all the rows at once (products of other
    # shapes round otherwise, as they do between one-device searches of
    # one and of four groups; a flip early in a search can end in another
    # caption of another score)
    table = torch.from_numpy(store.table()[:MESH_AGREE_ROWS]).cuda()
    half = MESH_AGREE_ROWS // MESH_SHARDS
    agree = {}
    for dtype in (torch.bfloat16, torch.float32):
        dec = load_checkpoint(os.path.join(WORK, "ckpt"), "cuda",
                              compute_dtype=dtype)["decoder"]
        tok_m, sc_m = sharded_beam_search(dec, table, mesh, beam_width=BEAM,
                                          max_words=MAX_WORDS)
        per_shard = [beam_search(dec, table[i:i + half], beam_width=BEAM,
                                 max_words=MAX_WORDS)
                     for i in range(0, MESH_AGREE_ROWS, half)]
        label = str(dtype).replace("torch.", "")
        check(torch.equal(tok_m, torch.cat([t for t, _ in per_shard]))
              and torch.equal(sc_m, torch.cat([c for _, c in per_shard])),
              f"{label} mesh search: tokens or scores differ from "
              f"one-device searches of each shard's rows")
        tok_1, sc_1 = beam_search(dec, table, beam_width=BEAM,
                                  max_words=MAX_WORDS)
        cap_m = detokenize_batch(tok_m.cpu().numpy(), vocab)
        cap_1 = detokenize_batch(tok_1.cpu().numpy(), vocab)
        differ = [i for i, (a, b) in enumerate(zip(cap_m, cap_1)) if a != b]
        gaps = (sc_m - sc_1).abs().cpu().numpy()
        agree[label] = (len(cap_m) - len(differ),
                        float(gaps[differ].max()) if differ else 0.0,
                        float(np.median(gaps[differ])) if differ else 0.0)
        del dec
    print(f"[16 mesh] sharded search over {MESH_AGREE_ROWS} rows, bf16 and "
          f"f32: tokens and scores equal to one-device searches of each "
          f"shard's {half} rows; against one search of all "
          f"{MESH_AGREE_ROWS}: " + ", ".join(
              f"{k} {n}/{MESH_AGREE_ROWS} captions equal, the differing "
              f"ones' score gaps median {m:.3g}, max {g:.3g}"
              for k, (n, g, m) in agree.items()))

    # f32: the mesh service's answers by id, by feature and by image equal
    # the one-device service's, on the joint checkpoint with phase 13's
    # sharper output projection (w_out x 8: fewer tied beams; the random
    # one's near-ties are held above); the encoder's shards (B=4) give fc7
    # rows within FC7_RTOL of the one-device encoder's (B=8)
    ck32 = load_checkpoint(joint, "cuda", compute_dtype=torch.float32,
                           opt_state=False)
    ck32["decoder"].w_out.mul_(CLI_F32_SHARPEN)
    f32, fc7 = {}, {}
    for name, extra in (("one", {"device": "cuda"}), ("mesh", {"mesh": mesh})):
        s32 = CaptionService(cfg, ck32["decoder"], vocab, store=store,
                             vgg=ck32["vgg"],
                             average_image=ck32["average_image"],
                             beam_width=BEAM, max_words=MAX_WORDS,
                             decode_batch=DECODE_BATCH, **extra)
        f32[name] = {"ids": s32.caption_ids(ids[:MESH_F32_IDS]),
                     "features": s32.caption_features(list(raw)),
                     "images": s32.caption_images(images)}
        # fc7 through the service's own encoder path (its shard streams
        # and modules), before its L1 normalization (held) and after it
        # (printed): fc7 has no ReLU, so the normalization divides by a
        # signed row sum, which magnifies the products' rounding some
        # hundred times
        encode = service_mod.images_to_fc7
        fc7[name] = {}
        for label, fn in (("raw", lambda vgg, px, avg: vgg16_fc7(
                vgg, normalize_batch(px, avg))), ("l1", encode)):
            service_mod.images_to_fc7 = fn
            try:
                fc7[name][label] = np.stack(s32._encode_finalize(
                    s32._encode_fn(images[:ENCODE_BATCH])))
            finally:
                service_mod.images_to_fc7 = encode
        s32.close()
    fc7_err = {label: float(np.abs(fc7["mesh"][label] - want).max()
                            / np.abs(want).max())
               for label, want in fc7["one"].items()}
    check(fc7_err["raw"] <= FC7_RTOL,
          f"f32 mesh service: fc7 off the one-device service's by "
          f"{fc7_err['raw']:.3g} of its largest entry (tol {FC7_RTOL})")
    same = {kind: sum(a == b for a, b in zip(f32["one"][kind],
                                             f32["mesh"][kind]))
            for kind in f32["one"]}
    sizes = {"ids": MESH_F32_IDS, "features": MESH_FEATURES,
             "images": MESH_IMAGES}
    check(same == sizes, f"f32 mesh service: captions equal to the "
                         f"one-device service's {same} of {sizes}")
    del ck32
    # captions/s of one and two shards on the one card, for the record
    burst = torch.from_numpy(store.table()[np.arange(MESH_BURST)
                                           % len(store)]).cuda()
    dec16 = ck["decoder"]
    rates = {}
    for name, run in (("1 shard", lambda: beam_search(
            dec16, burst, beam_width=BEAM, max_words=MAX_WORDS)),
            (f"{MESH_SHARDS} shards", lambda: sharded_beam_search(
                dec16, burst, mesh, beam_width=BEAM, max_words=MAX_WORDS))):
        run(), run()            # eagerly, then captured
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(3):
            tokens, _ = run()
        tokens.cpu()
        rates[name] = 3 * MESH_BURST / (time.perf_counter() - t1)
    print(f"[16 mesh] f32 mesh service (w_out x {CLI_F32_SHARPEN:g}): "
          f"captions equal to the one-device service's: " + ", ".join(
              f"{k} {same[k]}/{n}" for k, n in sizes.items())
          + f" ({len(set(f32['one']['images']))} distinct image captions)"
          f"; fc7 of {ENCODE_BATCH} images off by {fc7_err['raw']:.3g} "
          f"of its largest entry (tol {FC7_RTOL}), {fc7_err['l1']:.3g} "
          f"once L1-normalized; a {MESH_BURST}-row bf16 search on {smi}: "
          + ", ".join(f"{k} {v:.1f} captions/s" for k, v in rates.items())
          + " (two shards on one card measure no scaling)")

    # the command line: serve --mesh 1 over HTTP; --mesh 2 is refused
    args = cli.build_parser().parse_args([
        *CLI_DEVICE_FLAGS, "serve", "--loadfile", os.path.join(WORK, "ckpt"),
        "--features", os.path.join(WORK, "store"), "--generate",
        str(MAX_WORDS), "--mesh", "1", "--host", "127.0.0.1", "--port", "0"])
    service = cli.make_caption_service(args)
    check(service.mesh is not None and service.mesh.shape["data"] == 1,
          "serve --mesh 1 built no mesh service")
    server = make_server(service, args.host, args.port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=120)
    try:
        replies = [http_request(conn, "POST", "/v1/caption",
                                {"ids": ids[i:i + 3]})
                   for i in range(0, 12, 3)]
        direct = [service.caption_ids(ids[i:i + 3]) for i in range(0, 12, 3)]
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        service.close()
    check(all(status == 200 and reply["captions"] == d
              for (status, reply), d in zip(replies, direct)),
          f"serve --mesh 1: {replies}")
    try:
        cli.main([*CLI_DEVICE_FLAGS, "serve", "--loadfile",
                  os.path.join(WORK, "ckpt"), "--features",
                  os.path.join(WORK, "store"), "--mesh", "2"])
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "needs 2 devices, have 1" in refused,
          f"serve --mesh 2 on one card: {refused!r}")
    print(f"[16 mesh] lrcn-torch serve --mesh 1: {len(replies)} id requests "
          f"over HTTP equal to the service's own captions; serve --mesh 2 "
          f"refused: {refused!r}")

    rank_s = phase_mesh_ranks()
    nccl_s = phase_mesh_nccl(smi)
    print(f"[16 mesh] seconds: {time.perf_counter() - t0:.1f} (ranks "
          f"{rank_s:.1f}, NCCL trainer {nccl_s:.1f})")
    return launches


def graph_wall_ms(fn, calls: int) -> tuple[float, float]:
    """Median host wall per call, the call's result on the card
    (synchronized), and median host time to enqueue the call."""
    walls, enqueues = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        enqueues.append(t1 - t0)
    return statistics.median(walls) * 1e3, statistics.median(enqueues) * 1e3


def live_graphs() -> int:
    """The graphs that the modules alive in this process hold."""
    from lrcn_tpu_torch.utils.graphs import GraphCache

    gc.collect()
    with warnings.catch_warnings():     # deprecated objects among them
        warnings.simplefilter("ignore", FutureWarning)
        return sum(len(o.graphs) for o in gc.get_objects()
                   if isinstance(o, GraphCache))


def phase_graphs(smi: str, rng) -> dict[str, int]:
    """Phase 17: one-program dispatch.  At the reference width, bf16 and
    f32 (TF32 off), every graphed entry point against its eager body on
    the kernel path: each runs eagerly at its first call and captures at
    its second, on inputs A, then replays on inputs B, held against the
    eager body on B: beam-3 searches at GRAPH_SHAPES (tokens and scores
    bit-equal), greedy and a table search at GRAPH_ROWS, the encoder at
    an encoder batch (fc7 rows bit-equal, raw and L1-normalized), each
    replay's launches (42 LSTM and 21 top-k a search, 13 conv an encoder
    batch); then, bf16, each of GRAPH_TIMED eager against graphed in
    turns (host wall, host enqueue, device time per call), its first and
    capturing calls' seconds, the memory the capture kept reserved, and
    that memory freed with its module.  Returns the launches of the
    checks' replays."""
    from lrcn_tpu_torch.data.images import images_to_fc7, normalize_batch
    from lrcn_tpu_torch.decode import beam
    from lrcn_tpu_torch.models.lrcn import params_from_numpy
    from lrcn_tpu_torch.models.vgg import (vgg16_fc7, vgg16_fc7_fn,
                                          vgg_params_from_numpy)
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    steps = MAX_WORDS + 1
    tree, vgg_tree = random_tree(rng), random_vgg(rng)
    raw = np.abs(rng.standard_normal((2048, CNN_DIM), dtype=np.float32))
    rows = raw / raw.sum(axis=1, keepdims=True)
    pixels = [torch.from_numpy(rng.integers(
        0, 256, (ENCODE_BATCH, 224, 224, 3), np.uint8)).cuda()
        for _ in range(2)]
    avg = torch.full((224, 224, 3), JOINT_MEAN, device="cuda")
    ids = [torch.from_numpy(rng.choice(len(rows), GRAPH_ROWS,
                                       replace=False)).cuda()
           for _ in range(2)]
    replay_counts = dict.fromkeys(read_counts(*fns), 0)

    def feats_of(n: int, which: int) -> torch.Tensor:
        """n rows of the table, set A (0) or B (1), on the card."""
        return torch.from_numpy(rows[(np.arange(n) + which * 1000)
                                     % len(rows)]).cuda()

    def graphed(call, a, b, want: dict, label: str):
        """``call(a)`` eagerly, ``call(a)`` captured, then ``call(b)``
        replayed, its launches held to ``want``; returns the last."""
        call(a)
        call(a)
        reset_counts(*fns)
        out = call(b)
        got = read_counts(*fns)
        check(got == want, f"{label}: one replay launched {got}, want "
                           f"{want}")
        for name, n in got.items():
            replay_counts[name] += n
        return out

    def eager(fn, *args, **kwargs):
        with torch.inference_mode():
            return fn(*args, **kwargs)

    search_launches = {"fused_conv3x3_relu": 0,
                       "fused_lstm_step": 2 * steps, "topk_logsumexp": steps}
    conv_launches = {"fused_conv3x3_relu": 13, "fused_lstm_step": 0,
                     "topk_logsumexp": 0}
    held = []
    for dtype in (torch.bfloat16, torch.float32):
        label = str(dtype).replace("torch.", "")
        dec = params_from_numpy(tree, "cuda", dtype)
        table = torch.from_numpy(rows).cuda().to(dtype)
        captures = graphs.stats["captures"]
        for groups, batch in GRAPH_SHAPES:
            n = groups * batch
            if groups == 1:
                call = lambda f: beam.beam_search(
                    dec, f, beam_width=BEAM, max_words=MAX_WORDS)
            else:
                call = lambda f: tuple(t.reshape(n, *t.shape[2:]) for t in
                                       beam.beam_search_grouped(
                                           dec, f.view(groups, batch, -1),
                                           beam_width=BEAM,
                                           max_words=MAX_WORDS))
            b = feats_of(n, 1)
            tok_g, sc_g = graphed(call, feats_of(n, 0), b, search_launches,
                                  f"{label} {groups}x{batch}")
            tok_e, sc_e = eager(beam.beam_search_fn, dec, b,
                                beam_width=BEAM, max_words=MAX_WORDS)
            check(torch.equal(tok_g, tok_e) and torch.equal(sc_g, sc_e),
                  f"{label} {groups}x{batch} beam-{BEAM}: the graphed "
                  f"search's tokens or scores differ from the eager "
                  f"kernel path's")
            held.append(f"{groups}x{batch}")
        b = feats_of(GRAPH_ROWS, 1)
        tok_g, sc_g = graphed(
            lambda f: beam.greedy_search(dec, f, max_words=MAX_WORDS),
            feats_of(GRAPH_ROWS, 0), b, search_launches, f"{label} greedy")
        tok_e, sc_e = eager(beam.greedy_search_fn, dec, b,
                            max_words=MAX_WORDS)
        check(torch.equal(tok_g, tok_e) and torch.equal(sc_g, sc_e),
              f"{label} greedy at {GRAPH_ROWS}: graphed differs from eager")
        tok_g, sc_g = graphed(
            lambda i: beam.rows_search(dec, table, i, beam_width=BEAM,
                                       max_words=MAX_WORDS),
            ids[0], ids[1], search_launches, f"{label} rows")
        tok_e, sc_e = eager(beam._rows_search_fn, dec, table, ids[1],
                            beam_width=BEAM, max_words=MAX_WORDS)
        check(torch.equal(tok_g, tok_e) and torch.equal(sc_g, sc_e),
              f"{label} rows_search of {GRAPH_ROWS} ids: graphed differs "
              f"from eager")
        enc = vgg_params_from_numpy(vgg_tree, "cuda", dtype)
        images = [normalize_batch(p, avg) for p in pixels]
        fc7_g = graphed(lambda x: vgg16_fc7(enc, x), *images, conv_launches,
                        f"{label} vgg16_fc7")
        fc7_e = vgg16_fc7_fn(enc, images[1])
        check(torch.equal(fc7_g, fc7_e), f"{label} vgg16_fc7 at "
                                         f"B={ENCODE_BATCH}: graphed fc7 "
                                         f"differs from eager")
        l1_g = graphed(lambda p: images_to_fc7(enc, p, avg), *pixels,
                       conv_launches, f"{label} images_to_fc7")
        check(torch.equal(l1_g, fc7_e / fc7_e.sum(-1, keepdim=True)),
              f"{label} images_to_fc7: graphed differs from eager")
        torch.cuda.synchronize()
        made = graphs.stats["captures"] - captures
        print(f"[17 graphs] {label}: graphed = eager kernel path, tokens "
              f"and scores bit-equal, beam-{BEAM} at "
              f"{', '.join(held[-len(GRAPH_SHAPES):])} images, greedy and "
              f"rows_search at {GRAPH_ROWS}; fc7 rows bit-equal at "
              f"B={ENCODE_BATCH} (vgg16_fc7, images_to_fc7); each replayed "
              f"on inputs other than its capture's; {made} graphs "
              f"captured; each replay launched {2 * steps} LSTM + {steps} "
              f"top-k a search, 13 conv an encoder batch")
        del dec, enc, table

    # eager against graphed, bf16, each shape on a module of its own (its
    # graph pool alone), in turns: eager, graphed, graphed, eager
    dec = params_from_numpy(tree, "cuda", torch.bfloat16)
    timings = {}
    for groups, batch in GRAPH_TIMED:
        n = groups * batch
        calls = GRAPH_CALLS[n]
        feats = feats_of(n, 0)
        gc.collect()
        torch.cuda.empty_cache()
        base, alive = torch.cuda.memory_reserved(), live_graphs()
        own = copy.deepcopy(dec)
        runs = {
            "eager": lambda: eager(beam.beam_search_fn, own, feats,
                                   beam_width=BEAM, max_words=MAX_WORDS),
            "graphed": lambda: beam.beam_search(own, feats, beam_width=BEAM,
                                                max_words=MAX_WORDS)}
        seconds = []                # the first call (eager), the capture
        for _ in range(2):
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved()
            t1 = time.perf_counter()
            runs["graphed"]()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t1)
        torch.cuda.empty_cache()
        kept = torch.cuda.memory_reserved() - before
        check(len(graphs.graphs(own)) == 1, f"{groups}x{batch}: "
              f"{len(graphs.graphs(own))} graphs after two calls")
        walls = {k: [] for k in runs}
        for name in ("eager", "graphed", "graphed", "eager"):
            walls[name].append(graph_wall_ms(runs[name], calls // 2 or 1))
        r = {name: {"wall_ms": statistics.median(w for w, _ in walls[name]),
                    "enqueue_ms": statistics.median(e for _, e in
                                                    walls[name]),
                    "device_ms": device_ms(fn, max(2, calls // 2),
                                           one_kernel=False)}
             for name, fn in runs.items()}
        r["first_call_s"], r["capture_call_s"] = seconds
        r["capture_kept_mb"] = kept / 2 ** 20
        timings[f"{groups}x{batch}"] = r
        del own, runs
        gc.collect()
        torch.cuda.empty_cache()
        freed = torch.cuda.memory_reserved() - base
        r["reserved_after_drop_mb"] = freed / 2 ** 20
        check(live_graphs() == alive and freed <= GRAPH_KEPT_MB * 2 ** 20,
              f"{live_graphs() - alive} graphs alive and {freed / 2 ** 20} "
              f"MB more reserved after their module was dropped")
        print(f"[17 graphs] bf16 beam-{BEAM} {groups}x{batch} ({n} images,"
              f" {calls // 2 * 2} calls each) on {smi}: eager wall "
              f"{r['eager']['wall_ms']:.3f} ms (enqueue "
              f"{r['eager']['enqueue_ms']:.3f} ms), device "
              f"{r['eager']['device_ms']:.3f} ms; graphed wall "
              f"{r['graphed']['wall_ms']:.3f} ms (enqueue "
              f"{r['graphed']['enqueue_ms']:.3f} ms), device "
              f"{r['graphed']['device_ms']:.3f} ms; wall ratio eager / "
              f"graphed {r['eager']['wall_ms'] / r['graphed']['wall_ms']:.2f}"
              f"; first call (eager) {seconds[0]:.3f} s, second call "
              f"(warm-up, capture, replay) {seconds[1]:.3f} s, reserved "
              f"by the capture (graph pool and the graph stream's cuBLAS "
              f"workspace) {r['capture_kept_mb']:.1f} MB; reserved after "
              f"the module was dropped {freed / 2 ** 20:+.1f} MB against "
              f"before")
    del dec
    RESULTS["graphs"] = timings
    print(f"[17 graphs] seconds: {time.perf_counter() - t0:.1f}")
    print(json.dumps({"graph_timings": timings}))
    return replay_counts


@contextmanager
def eager_bodies():
    """Every graphed entry point runs its eager body, as on CPU tensors
    (``graphs.enabled`` says no): the un-graphed twin of a graphed call.
    Optimizers made outside the block keep their fused, capturable
    Adam."""
    from lrcn_tpu_torch.utils import graphs

    real = graphs.enabled
    graphs.enabled = lambda x: False
    try:
        yield
    finally:
        graphs.enabled = real


def eager_against_graphed(eager, graphed, calls: int) -> dict:
    """Median host wall, host enqueue and device ms per call of ``eager``
    (run inside ``eager_bodies``) and ``graphed``, in turns (eager,
    graphed, graphed, eager; ``calls`` a turn)."""
    def un_graphed():
        with eager_bodies():
            return eager()

    runs = {"eager": un_graphed, "graphed": graphed}
    walls: dict = {k: [] for k in runs}
    for name in ("eager", "graphed", "graphed", "eager"):
        walls[name].append(graph_wall_ms(runs[name], calls))
    return {name: {"wall_ms": statistics.median(w for w, _ in walls[name]),
                   "enqueue_ms": statistics.median(e for _, e in
                                                   walls[name]),
                   "device_ms": device_ms(fn, calls, one_kernel=False)}
            for name, fn in runs.items()}


def timed_call(fn):
    """``fn()``'s result and its seconds, the card synchronized around."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def reserved_mb() -> float:
    """The caching allocator's reserved memory once its free blocks are
    returned, MB."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 20


def dispatch_report(label: str, r: dict, smi: str, unit: str) -> None:
    """Print a path's eager against graphed figures; hold that the memory
    its capture kept came back with its owner."""
    check(r["reserved_after_drop_mb"] <= GRAPH_KEPT_MB,
          f"{label}: {r['reserved_after_drop_mb']} MB more reserved after "
          f"the graph's owner was dropped")
    e, g = r["eager"], r["graphed"]
    print(f"[18 dispatch] {label} on {smi}: eager wall {e['wall_ms']:.3f} ms "
          f"{unit} (enqueue {e['enqueue_ms']:.3f}), device "
          f"{e['device_ms']:.3f}; graphed wall {g['wall_ms']:.3f} (enqueue "
          f"{g['enqueue_ms']:.3f}), device {g['device_ms']:.3f}; wall ratio "
          f"eager / graphed {e['wall_ms'] / g['wall_ms']:.2f}; first call "
          f"(eager) {r['first_call_s']:.3f} s, capturing call (capture and "
          f"replay) {r['capture_call_s']:.3f} s; the capture kept "
          f"{r['capture_kept_mb']:.1f} MB reserved, "
          f"{r['reserved_after_drop_mb']:+.1f} MB against before once its "
          f"owner was dropped")


def dispatch_train(smi: str) -> dict:
    """Phase 18, training: four K=8 dispatches at the reference width
    (dropout 0.4, bf16) on chunks A, A, B, C (eager, capture, two
    replays) against an eager twin from the same initial state: the
    losses of each and the parameters and optimizer leaves after them
    bit-equal; ``average_loss``'s K-batch evaluation graphed against
    eager; eager against graphed times of a dispatch."""
    from lrcn_tpu_torch.models.lrcn import PARAM_KEYS
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.utils import graphs

    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    trainer, params, opt, batches, store = train_setup()
    twin, twin_opt = trainer.init(SEED)
    table = trainer._device_table(store)
    chunks = [trainer._stacked(batches[i * TRAIN_K:(i + 1) * TRAIN_K],
                               store)[1] for i in range(4)]
    order = (0, 0, 1, 2)

    def dispatch(p, o, d, chunk=None):
        c = chunks[order[d] if chunk is None else chunk]
        return trainer._dispatch(p, o, *c, table, 1, TRAIN_K * d)

    base = reserved_mb()
    reset_counts(*fns)
    got, seconds = [], []
    for d in range(4):
        losses, sec = timed_call(lambda: dispatch(params, opt, d))
        got.append(losses)
        seconds.append(sec)
    counts = read_counts(*fns)
    check(sum(counts.values()) == 0, f"graphed training launched "
                                     f"hand-written kernels: {counts}")
    kept = reserved_mb() - base
    with eager_bodies():
        want = [dispatch(twin, twin_opt, d) for d in range(4)]
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"graphed training dispatches: losses {[g.tolist() for g in got]}"
          f" against eager {[w.tolist() for w in want]}")
    differ = [k for k in PARAM_KEYS if not torch.equal(params[k], twin[k])]
    check(not differ, f"graphed training: parameters {differ} differ from "
                      f"the eager twin's after 4 dispatches")
    leaves, twin_leaves = opt.state_leaves(), twin_opt.state_leaves()
    check(int(leaves[0]) == 4 * TRAIN_K
          and all(np.array_equal(a, b) for a, b in zip(leaves, twin_leaves)),
          "graphed training: Adam's leaves differ from the eager twin's")
    (entry,) = graphs.graphs(opt)
    # restored leaves: Adam's count on the card, the graphs dropped, the
    # next dispatch eager and the one after captured anew
    opt.load_leaves(leaves)
    steps_on = {str(st["step"].device) for st in opt.adam.state.values()}
    check(steps_on == {str(params["embedding"].device)}
          and graphs.graphs(opt) == [],
          f"load_leaves: Adam's count on {steps_on}, "
          f"{len(graphs.graphs(opt))} graphs kept")
    captures = graphs.stats["captures"]
    for d in (4, 5):
        dispatch(params, opt, d, 3)
    check(graphs.stats["captures"] == captures + 1
          and int(opt.state_leaves()[0]) == 6 * TRAIN_K,
          "load_leaves: the two dispatches after it did not run eagerly "
          "and then capture anew")
    evals = [trainer.average_loss(params, batches, store) for _ in range(3)]
    with eager_bodies():
        eager_eval = trainer.average_loss(params, batches, store)
    check(all(e == eager_eval for e in evals),
          f"graphed K-batch evaluation {evals} against eager {eager_eval}")
    print(f"[18 dispatch] training, reference width, B={TRAIN_BATCH}, "
          f"L={TRAIN_LEN}, K={TRAIN_K}, dropout {TRAIN_DROPOUT}, bf16: four "
          f"dispatches (eager, capture, two replays on other batches) "
          f"bit-equal to an eager twin: losses, parameters and the 19 "
          f"optax leaves (count {int(leaves[0])}); the graph has "
          f"{len(entry.generators)} dropout generators and replayed "
          f"{entry.replays} times; average_loss over {len(batches)} batches "
          f"(K-batch graphs) {evals[-1]:.6f} = eager; no hand-written "
          f"kernel launched; after load_leaves Adam's count is on "
          f"{steps_on.pop()}, the next dispatch ran eagerly and the one "
          f"after captured anew")
    r = eager_against_graphed(lambda: dispatch(twin, twin_opt, 3, 1),
                              lambda: dispatch(params, opt, 3, 1), 4)
    r.update(first_call_s=seconds[0], capture_call_s=seconds[1],
             capture_kept_mb=kept)
    del trainer, params, opt, twin, twin_opt, entry, table, chunks
    r["reserved_after_drop_mb"] = reserved_mb() - base
    dispatch_report(f"training dispatch (K={TRAIN_K} steps; per step "
                    f"eager {r['eager']['wall_ms'] / TRAIN_K:.3f}, graphed "
                    f"{r['graphed']['wall_ms'] / TRAIN_K:.3f} ms)", r, smi,
                    "a dispatch")
    return r


def dispatch_sample(smi: str, tree: dict, rng) -> tuple[dict, dict]:
    """Phase 18, sampling: best-of-100 of 256 images at the reference
    width, bf16, four successive calls on one generator (images A, A, B,
    C: eager, capture, two replays) against four eager calls on a
    generator seeded alike: tokens and scores bit-equal, the generators
    in one state after each; each replay's launches; eager against
    graphed times.  Returns the timings and the replays' launches."""
    from lrcn_tpu_torch.decode.sample import best_of_n_search
    from lrcn_tpu_torch.models.lrcn import params_from_numpy
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)

    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    steps = MAX_WORDS + 1
    dec = params_from_numpy(tree, "cuda", torch.bfloat16)
    raw = np.abs(rng.standard_normal((3, SAMPLE_IMAGES, CNN_DIM),
                                     dtype=np.float32))
    feats = torch.from_numpy(raw / raw.sum(-1, keepdims=True)).cuda()
    gen, ref = (torch.Generator(device="cuda").manual_seed(SEED)
                for _ in range(2))
    call = lambda f, g: best_of_n_search(
        dec, f, n_samples=SAMPLE_N, temperature=SAMPLE_T,
        max_words=MAX_WORDS, generator=g)
    base = reserved_mb()
    replays = dict.fromkeys(read_counts(*fns), 0)
    seconds = []
    for d, which in enumerate((0, 0, 1, 2)):
        reset_counts(*fns)
        (tok_g, sc_g), sec = timed_call(lambda: call(feats[which], gen))
        seconds.append(sec)
        got = read_counts(*fns)
        if d >= 2:
            check(got == {"fused_conv3x3_relu": 0,
                          "fused_lstm_step": 2 * steps,
                          "topk_logsumexp": 0}
                  and fused_lstm_step.launches_by_route["wgmma"] == 2 * steps,
                  f"sampling replay: launches {got}")
            for name, n in got.items():
                replays[name] += n
        if d == 1:
            kept = reserved_mb() - base
        with eager_bodies():
            tok_e, sc_e = call(feats[which], ref)
        check(torch.equal(tok_g, tok_e) and torch.equal(sc_g, sc_e),
              f"best-of-{SAMPLE_N} call {d + 1}: graphed tokens or scores "
              f"differ from the eager call's on one generator's stream")
        check(torch.equal(gen.get_state(), ref.get_state()),
              f"best-of-{SAMPLE_N} call {d + 1}: the generators' states "
              f"differ after the graphed and the eager call")
    print(f"[18 dispatch] best-of-{SAMPLE_N} sampling of {SAMPLE_IMAGES} "
          f"images, T={SAMPLE_T}, bf16: four successive calls on one "
          f"generator (eager, capture, two replays on other images) "
          f"bit-equal, tokens and scores, to four eager calls on a "
          f"generator seeded alike, which ends in the same state; each "
          f"replay launched {2 * steps} LSTM (all wgmma)")
    r = eager_against_graphed(lambda: call(feats[1], ref),
                              lambda: call(feats[1], gen), 3)
    r.update(first_call_s=seconds[0], capture_call_s=seconds[1],
             capture_kept_mb=kept)
    del dec, call, tok_g, sc_g, tok_e, sc_e
    r["reserved_after_drop_mb"] = reserved_mb() - base
    dispatch_report(f"best-of-{SAMPLE_N} sampling of {SAMPLE_IMAGES} images"
                    f" ({SAMPLE_IMAGES * SAMPLE_N} rows)", r, smi,
                    "a search")
    return r, replays


def dispatch_joint(smi: str) -> dict:
    """Phase 18, the joint step: K=4 dispatches at the reference width
    (full VGG-16, B=128, dropout 0.4, bf16, remat) on chunks A, A, B
    (eager, capture, a replay on other images) against an eager twin from
    the same initial state, under cuDNN's deterministic algorithms: the
    losses equal, the parameters within RESUME_RTOL of their largest
    entry (bit-equality printed); ``eval_batch`` graphed against eager;
    then, a new optimizer under the default algorithms, eager against
    graphed times of a dispatch."""
    from lrcn_tpu_torch.models import lrcn

    step, params, opt_state, chunk = joint_setup()
    twin, twin_opt = step.init(SEED)
    chunks = [chunk, (chunk[0].flip(2), *chunk[1:])]
    order = (0, 0, 1)
    torch.backends.cudnn.deterministic = True
    try:
        got = [step.multi_step(params, opt_state, *chunks[c], 3, 4 * d)[2]
               for d, c in enumerate(order)]
        with eager_bodies():
            want = [step.multi_step(twin, twin_opt, *chunks[c], 3, 4 * d)[2]
                    for d, c in enumerate(order)]
        batch = [t[0] for t in chunks[1]]
        evals = [torch.stack(step.eval_batch(params, *batch))
                 for _ in range(3)]
        with eager_bodies():
            eager_eval = torch.stack(step.eval_batch(params, *batch))
    finally:
        torch.backends.cudnn.deterministic = False
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"graphed joint dispatches: losses {[g.tolist() for g in got]} "
          f"against eager {[w.tolist() for w in want]}")
    check(all(torch.equal(e, eager_eval) for e in evals),
          f"graphed joint eval_batch {evals} against eager {eager_eval}")
    flat, twin_flat = lrcn.flat_tree(params), lrcn.flat_tree(twin)
    errs = {k: float(np.abs(flat[k] - twin_flat[k]).max()
                     / max(np.abs(twin_flat[k]).max(), 1e-30))
            for k in flat}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= RESUME_RTOL, f"graphed joint step: {worst} off by "
                                      f"{errs[worst]:.3g} from the eager "
                                      f"twin's")
    equal = all(np.array_equal(flat[k], twin_flat[k]) for k in flat)
    print(f"[18 dispatch] joint step, reference width, B={JOINT_BATCH}, "
          f"L={JOINT_LEN}, K={JOINT_K}, dropout {TRAIN_DROPOUT}, bf16, "
          f"remat, cudnn.deterministic: three dispatches (eager, capture, "
          f"a replay on other images) against an eager twin: losses equal "
          f"({got[-1].tolist()}); parameters within {errs[worst]:.3g} of "
          f"their largest entry ({worst}; tol {RESUME_RTOL}), bit-equal: "
          f"{equal}; eval_batch graphed = eager")
    del twin, twin_opt, opt_state, flat, twin_flat
    base = reserved_mb()
    opt_state = step.opt.init(params)
    seconds = []
    for d in range(2):
        out, sec = timed_call(lambda: step.multi_step(
            params, opt_state, *chunks[0], 5, 4 * d))
        seconds.append(sec)
        if d == 1:
            kept = reserved_mb() - base
    r = eager_against_graphed(
        lambda: step.multi_step(params, opt_state, *chunks[1], 5, 8),
        lambda: step.multi_step(params, opt_state, *chunks[1], 5, 8), 2)
    r.update(first_call_s=seconds[0], capture_call_s=seconds[1],
             capture_kept_mb=kept)
    del opt_state, out
    r["reserved_after_drop_mb"] = reserved_mb() - base
    dispatch_report(f"joint dispatch (K={JOINT_K} steps of B={JOINT_BATCH};"
                    f" per step eager {r['eager']['wall_ms'] / JOINT_K:.3f},"
                    f" graphed {r['graphed']['wall_ms'] / JOINT_K:.3f} ms)",
                    r, smi, "a dispatch")
    del step, params, chunk, chunks
    return r


def dispatch_artifacts(smi: str, rng) -> tuple[dict, dict]:
    """Phase 18, reloaded export programs (phase 15's beam, sample and
    image artifacts, loaded here): each program called eagerly and
    captured on inputs A, then replayed on inputs B (the sample program
    with two seeds in turn), its tokens and scores equal to its eager
    ``forward`` on B; each replay's launches; eager against graphed times
    of the beam artifact at 1x256.  Returns the timings and the replays'
    launches."""
    from lrcn_tpu_torch.export import load_exported
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)

    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    steps = MAX_WORDS + 1
    unloaded = reserved_mb()
    models = {name: load_exported(os.path.join(EXPORT_WORK, name), "cuda")
              for name in ("bf16", "sample", "image")}
    raw = np.abs(rng.standard_normal((2, DECODE_BATCH, CNN_DIM),
                                     dtype=np.float32))
    feats = torch.from_numpy(raw / raw.sum(-1, keepdims=True)).cuda()
    pixels = torch.from_numpy(rng.integers(
        0, 256, (2, EXPORT_IMAGES, 224, 224, 3), np.uint8)).cuda()
    search = {"fused_conv3x3_relu": 0, "fused_lstm_step": 2 * steps,
              "topk_logsumexp": steps}
    want_launches = {
        "beam": search,
        "sample": dict(search, topk_logsumexp=0),
        "image": dict(search, fused_conv3x3_relu=13)}
    replays = dict.fromkeys(read_counts(*fns), 0)

    def eager(model, variant, x, seed=None):
        program = model._fns[variant].module
        with torch.inference_mode(), torch.random.fork_rng(
                devices=[model.device], device_type="cuda"):
            if seed is not None:
                torch.cuda.manual_seed(seed)
            return program.forward(x)

    lines, seconds = [], []
    for name, variant, inputs in (("bf16", "beam", feats),
                                  ("image", "image", pixels),
                                  ("sample", "sample", feats)):
        model = models[name]
        seeds = (EXPORT_SEED, EXPORT_SEED + 1) if name == "sample" else (None,)
        calls = [(0, seeds[0]), (0, seeds[-1]), (1, seeds[0]),
                 (1, seeds[-1])]
        for d, (which, seed) in enumerate(calls):
            args = (inputs[which],) + ((seed,) if seed is not None else ())
            if name == "bf16" and d == 0:
                base = reserved_mb()
            reset_counts(*fns)
            (tokens, scores), sec = timed_call(lambda: model.call(variant,
                                                                  *args))
            got = read_counts(*fns)
            if name == "bf16" and d < 2:
                seconds.append(sec)
                if d == 1:
                    kept = reserved_mb() - base
            if d >= 2:
                check(got == want_launches[variant],
                      f"{variant} artifact replay: launches {got}")
                for k, n in got.items():
                    replays[k] += n
            want_t, want_s = eager(model, variant, inputs[which], seed)
            check(torch.equal(tokens, want_t) and torch.equal(scores, want_s),
                  f"{variant} artifact call {d + 1}: graphed tokens or "
                  f"scores differ from the program's eager forward")
        lines.append(f"{variant}: {want_launches[variant]}")
    print(f"[18 dispatch] reloaded artifacts (beam bf16 at {DECODE_BATCH} "
          f"rows, image at {EXPORT_IMAGES} images, sample best-of-"
          f"{SAMPLE_N} at {DECODE_BATCH} images with seeds {EXPORT_SEED} and "
          f"{EXPORT_SEED + 1} in turn): each call (eager, capture, replays "
          f"on other inputs) equal, tokens and scores, to the program's "
          f"eager forward; launches a replay: " + "; ".join(lines))
    bf16 = models["bf16"]
    r = eager_against_graphed(lambda: eager(bf16, "beam", feats[1]),
                              lambda: bf16.call("beam", feats[1]), 20)
    r.update(first_call_s=seconds[0], capture_call_s=seconds[1],
             capture_kept_mb=kept)
    del models, model, bf16
    r["reserved_after_drop_mb"] = reserved_mb() - unloaded
    dispatch_report(f"beam artifact, 1x{DECODE_BATCH}", r, smi, "a call")
    return r, replays


def phase_dispatch(smi: str, rng) -> dict[str, int]:
    """Phase 18: the one-program dispatch of sampling, training, the
    joint step and reloaded export programs, each graphed path held
    against its eager body on inputs other than its capture's, with
    eager against graphed times (``dispatch_*``).  Needs phase 15's
    export directories.  Returns the launches of the checks' replays."""
    t0 = time.perf_counter()
    tree = random_tree(rng)
    laps = [time.perf_counter()]
    timings = {"training": dispatch_train(smi)}
    laps.append(time.perf_counter())
    timings["sampling"], replays = dispatch_sample(smi, tree, rng)
    laps.append(time.perf_counter())
    timings["joint"] = dispatch_joint(smi)
    laps.append(time.perf_counter())
    timings["artifact"], more = dispatch_artifacts(smi, rng)
    laps.append(time.perf_counter())
    for name, n in more.items():
        replays[name] += n
    RESULTS["dispatch"] = timings
    print(f"[18 dispatch] seconds: {time.perf_counter() - t0:.1f} ("
          + ", ".join(f"{k} {b - a:.1f}" for k, a, b in zip(
              timings, laps, laps[1:])) + ")")
    print(json.dumps({"dispatch_timings": timings}))
    return replays


def write_small_mat(path: str, rng: np.random.Generator) -> list[tuple]:
    """A MatConvNet VGG-16 file (the beta16+ layout) written with scipy:
    ``RUNBOOK_WIDTH`` channels a conv and fc6/fc7 of ``RUNBOOK_FC``, the
    weights scaled as tests/test_vgg.py's width-scaled file scales them.
    Returns the 13 convs' HWIO weight shapes."""
    from scipy.io import savemat

    from lrcn_tpu_torch.models.vgg import VGG16_LAYOUT

    layers, convs, c_in = [], [], 3

    def add(name, shape):
        w = rng.standard_normal(shape).astype(np.float32) * np.float32(0.05)
        b = np.zeros((shape[-1], 1), np.float32)
        layers.append({"name": name, "type": "conv",
                       "weights": np.array([w, b], dtype=object)})

    for entry in VGG16_LAYOUT:
        if entry == "pool":
            continue
        convs.append((3, 3, c_in, RUNBOOK_WIDTH))
        add(entry[0], convs[-1])
        c_in = RUNBOOK_WIDTH
    add("fc6", (7, 7, c_in, RUNBOOK_FC))
    add("fc7", (1, 1, RUNBOOK_FC, RUNBOOK_FC))
    savemat(path, {"layers": np.array(layers, dtype=object),
                   "meta": {"normalization": {"averageImage": np.full(
                       (224, 224, 3), 110, np.float32)}}})
    return convs


@contextmanager
def counted_legs(module, names, legs: dict):
    """Wrap the functions ``names`` of ``module``: each call zeroes the
    three kernels' counters and, after it, puts its seconds (the card
    synchronized at both ends), launches and launches by route into
    ``legs[name]``."""
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)

    fns = (fused_conv3x3_relu, fused_lstm_step, topk_logsumexp)
    real = {name: getattr(module, name) for name in names}

    def wrap(name):
        def leg(*args, **kwargs):
            reset_counts(*fns)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            legs[name] = {"seconds": time.perf_counter() - t0,
                          "counts": read_counts(*fns),
                          "routes": {fn.__name__: _routes_used(fn)
                                     for fn in fns}}
            return out
        return leg

    for name in names:
        setattr(module, name, wrap(name))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)


def _summed(counts: list[dict]) -> dict[str, int]:
    return {name: sum(c[name] for c in counts) for name in counts[0]}


def phase_examples(smi: str) -> dict[str, dict]:
    """The port's examples and the runbook chain on the card, each through
    the entry points a user calls, on the default device: the end-to-end
    example (its BLEU-4 gate; no kernel in ``train``; the LSTM and top-k
    kernels in ``generate`` at their routes; f32 ``generate`` on the card
    against the CPU), the serving quickstart (16 concurrent requests; its
    service's captions on the card equal to the CPU's at f32; no graph
    alive after ``close``) and tests/test_runbook.py's chain with the
    image decode replaced by arrays by id (the conv kernel in
    ``extract-features``).  Returns each path's launches."""
    from lrcn_tpu_torch import cli
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.examples import serving_quickstart as quick
    from lrcn_tpu_torch.examples import synthetic_end_to_end as e2e
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    work = os.path.join(WORK, "examples")
    os.makedirs(work, exist_ok=True)
    by_path: dict[str, dict] = {}
    marks = [("", time.perf_counter())]

    def mark(label: str) -> None:
        marks.append((label, time.perf_counter()))

    def no_kernels(leg: dict, what: str) -> None:
        check(sum(leg["counts"].values()) == 0,
              f"{what} launched hand-written kernels: {leg['counts']}")

    def search_routes(got: dict, cfg, n_images: int, batch: int | None,
                      beam: int, words: int, what: str) -> None:
        """``got`` (launches by route) is what the searches of ``n_images``
        at ``beam`` and ``--generate words`` give: two LSTM launches and
        one top-k launch a step, at the routing functions' routes."""
        b_dim, depth = cli.decode_geometry(n_images, batch, None)
        n_search = -(-n_images // (b_dim * depth))
        want = expected_routes(cfg, [], b_dim * depth * beam, beam)
        steps = (words + 1) * n_search
        want = {"fused_conv3x3_relu": {},
                "fused_lstm_step": _scaled(want["fused_lstm_step"], steps),
                "topk_logsumexp": _scaled(want["topk_logsumexp"], steps)}
        check(got == want, f"{what}: launches by route {got}, want {want}")

    # 1. the end-to-end example, as `python -m ...synthetic_end_to_end`
    #    runs it: no device argument, so the card
    e2e_dir = os.path.join(work, "e2e")
    legs: dict = {}
    with counted_legs(e2e, ("train", "generate", "score"), legs):
        result = e2e.main(e2e_dir)
    check(result.bleu[3] >= e2e.BLEU4_GATE, f"e2e BLEU-4 {result.bleu}")
    no_kernels(legs["train"], "e2e train")
    no_kernels(legs["score"], "e2e score")
    ckpt = os.path.join(e2e_dir, "ckpt")
    cfg = load_checkpoint(ckpt, "cpu")["cfg"]
    search_routes(legs["generate"]["routes"], cfg, 24, None, 2, 12,
                  "e2e generate")
    by_path["examples e2e (phase 19)"] = _summed(
        [leg["counts"] for leg in legs.values()])
    print(f"[19 examples] e2e (hidden {cfg.hidden}, embed {cfg.embed}, "
          f"vocab {cfg.vocab_size}, bf16): BLEU-1..4 "
          f"{[round(100 * b, 2) for b in result.bleu]} (gate BLEU-4 >= "
          f"{e2e.BLEU4_GATE}); seconds train "
          f"{legs['train']['seconds']:.2f}, generate "
          f"{legs['generate']['seconds']:.2f}, eval "
          f"{legs['score']['seconds']:.3f} on {smi}; generate's launches by "
          f"route {legs['generate']['routes']}; train and eval none")
    mark("e2e")

    # the trained checkpoint at f32: the kernels on the card against the
    # plain path on the CPU
    run = CLIRun()
    store = FeatureStore.load(os.path.join(e2e_dir, "val_feats"))
    lines, differ, gaps = f32_card_against_cpu(
        run, ["generate", "--features", os.path.join(e2e_dir, "val_feats"),
              "--capnumber", "24", "--generate", "12", "--beam_width", "2",
              "--seed", "7"], 24, ckpt, store, 2, 12,
        os.path.join(e2e_dir, "f32"), SCORE_ATOL)
    print(f"[19 examples] e2e generate --compute-dtype float32, card "
          f"(kernels) vs --device cpu (plain): {len(lines) - len(differ)}/"
          f"{len(lines)} lines equal (need {CAPTION_AGREEMENT}), score gaps "
          f"of the others {gaps}")
    mark("e2e f32")

    # 2. the serving quickstart on the card; its service at f32 on the card
    #    and on the CPU
    fns = run.fns
    reset_counts(*fns)
    t0 = time.perf_counter()
    served = quick.main()
    seconds = time.perf_counter() - t0
    counts = read_counts(*fns)
    routes = {fn.__name__: _routes_used(fn) for fn in fns}
    check(len(served["captions"]) == quick.N_REQUESTS
          and served["healthz"] == {"ok": True, "platform": "cuda"}
          and served["stats"]["decode_ids"]["errors"] == 0,
          f"quickstart: {len(served['captions'])} captions, "
          f"{served['healthz']}")
    by_path["examples quickstart (phase 19)"] = counts
    services = {d: quick.build_service(quick.CONFIG, device=d)
                for d in ("cuda", "cpu")}
    try:
        caps = {d: s.caption_ids(list(range(quick.N_IDS)))
                for d, s in services.items()}
        per_search = services["cuda"].max_words + 1
    finally:
        for service in services.values():
            service.close()
    del services
    # f32: the LSTM on the fma route, the top-k at V=50 on the block route;
    # a search runs max_words + 1 steps
    searches = counts["topk_logsumexp"] // per_search
    check(searches > 0 and counts["topk_logsumexp"] == per_search * searches
          and routes == {"fused_conv3x3_relu": {},
                         "fused_lstm_step": {"fma": 2 * per_search
                                             * searches},
                         "topk_logsumexp": {"block": per_search * searches}},
          f"quickstart: launches by route {routes}")
    check(caps["cuda"] == caps["cpu"],
          f"quickstart f32: {sum(a != b for a, b in zip(*caps.values()))}/"
          f"{quick.N_IDS} captions differ between the card and the CPU")
    torch.cuda.empty_cache()
    alive = live_graphs()
    check(alive == 0, f"{alive} graphs alive after the quickstart closed")
    print(f"[19 examples] quickstart (f32, beam 3, decode batch 8): "
          f"{quick.N_REQUESTS} concurrent requests answered 200 in "
          f"{seconds:.2f} s with its warm-up on {smi}; launches by route "
          f"{routes} ({searches} searches); /stats "
          f"{json.dumps(served['stats']['decode_ids'])}; "
          f"{quick.N_IDS}/{quick.N_IDS} captions equal card vs CPU; no "
          f"graph alive after close()")
    mark("quickstart")

    # 3. tests/test_runbook.py's chain at bf16: a MatConvNet file, 32
    #    images (arrays by id: no PIL or libjpeg here), COCO jsons
    rb = os.path.join(work, "runbook")
    img_dir = os.path.join(rb, "train2014")
    os.makedirs(img_dir)
    rng = np.random.default_rng(SEED + 19)
    ids = [61000 + i for i in range(RUNBOOK_IMAGES)]
    pixels = {i: rng.integers(0, 256, (224, 224, 3), np.uint8) for i in ids}
    for i in ids:
        open(os.path.join(img_dir, f"COCO_train2014_{i:012d}.jpg"),
             "wb").close()
    jsons = []
    for name in ("train", "val"):
        jsons.append(os.path.join(rb, f"captions_{name}2014.json"))
        with open(jsons[-1], "w") as f:
            json.dump({"annotations": [
                {"image_id": i,
                 "caption": " ".join(rng.choice(RUNBOOK_WORDS, 5)) + " ."}
                for i in ids for _ in range(5)]}, f)
    mat = os.path.join(rb, "imagenet-vgg-verydeep-16.mat")
    convs = write_small_mat(mat, rng)
    feats, ckpt = os.path.join(rb, "feats"), os.path.join(rb, "ckpt")
    cand, cand_ids = os.path.join(rb, "cands"), os.path.join(rb, "ids")
    chain = [
        ("extract", ["extract-features", "--cnn", mat, "--images", img_dir,
                     "--out", feats, "--batch-size", str(RUNBOOK_BATCH),
                     "--scan-depth", "2"]),
        ("train", ["train", "--datafiles", *jsons, "--features", feats,
                   "--val-features", feats, "--savefile", ckpt, "--epochs",
                   "2", "--batchsize", "8", "--hidden", "24", "24",
                   "--embed", "16", "--seed", "9", "--dropout", "0.0"]),
        ("generate", ["generate", "--loadfile", ckpt, "--features", feats,
                      "--datafiles", *jsons, "--capnumber", "16",
                      "--generate", "8", "--beam_width", "2",
                      "--batch-size", "16", "--out", cand, "--ids-out",
                      cand_ids, "--seed", "7"]),
        ("eval", ["eval", "--candidates", cand, "--candidate-ids", cand_ids,
                  "--annotations", jsons[1], "--refs-dir",
                  os.path.join(rb, "refs")])]
    walls, printed = {}, ""
    with synthetic_pixels(pixels):
        for name, argv in chain:
            printed, walls[name] = run(f"runbook {name}", argv)
    store = FeatureStore.load(feats)
    check(sorted(store.ids()) == ids and store.dim == RUNBOOK_FC
          and bool(np.isfinite(store.table()).all()),
          f"runbook extract-features: {len(store)} rows of {store.dim}")
    conv = expected_routes(cfg, convs, 1, 2)["fused_conv3x3_relu"]
    check(run.routes["runbook extract"] == {
              "fused_conv3x3_relu": _scaled(conv,
                                            RUNBOOK_IMAGES // RUNBOOK_BATCH),
              "fused_lstm_step": {}, "topk_logsumexp": {}},
          f"runbook extract-features: launches by route "
          f"{run.routes['runbook extract']}, want {conv} x "
          f"{RUNBOOK_IMAGES // RUNBOOK_BATCH}")
    check(sum(run.counts["runbook train"].values()) == 0
          and sum(run.counts["runbook eval"].values()) == 0,
          f"runbook train/eval launched kernels: "
          f"{run.counts['runbook train']}, {run.counts['runbook eval']}")
    rb_cfg = load_checkpoint(ckpt, "cpu")["cfg"]
    search_routes(run.routes["runbook generate"], rb_cfg, 16, 16, 2, 8,
                  "runbook generate")
    with open(cand) as f:
        n_lines = len(f.read().splitlines())
    check(n_lines == 16 and printed.startswith("BLEU = "),
          f"runbook: {n_lines} candidates, eval printed {printed!r}")
    by_path["runbook (phase 19)"] = _summed(
        [run.counts[f"runbook {name}"] for name, _ in chain])
    print(f"[19 examples] runbook (MatConvNet .mat of {RUNBOOK_WIDTH} "
          f"channels a conv, fc {RUNBOOK_FC}; hidden {rb_cfg.hidden}, embed "
          f"{rb_cfg.embed}, vocab {rb_cfg.vocab_size}; bf16; {RUNBOOK_IMAGES} "
          f"images by id): seconds " + ", ".join(
              f"{name} {walls[name]:.2f}" for name, _ in chain)
          + f" on {smi}; launches by route: extract-features "
          f"{run.routes['runbook extract']}, generate "
          f"{run.routes['runbook generate']}, train and eval none; eval "
          f"{printed.strip()}")
    mark("runbook")
    del run
    torch.cuda.empty_cache()
    alive = live_graphs()
    check(alive == 0, f"{alive} graphs alive after phase 19")
    print("[19 examples] seconds by step: " + ", ".join(
        f"{label} {t - marks[i][1]:.1f}"
        for i, (label, t) in enumerate(marks[1:])))
    return by_path


@torch.inference_mode()
def path_score_error(decoder, feats, tokens, scores) -> float:
    """How far each row's search score lies from the plain decode step's
    log-probability of the row's caption, teacher-forced: the largest, over
    rows, of the least difference over the steps where the search may
    have stopped (those of the trailing EOS run, or the last step)."""
    from lrcn_tpu_torch.core.vocab import EOS_ID
    from lrcn_tpu_torch.models import lrcn

    rows, width = tokens.shape
    cnn = lrcn.cnn_projection(decoder, feats)
    state = lrcn.init_state(decoder, rows, feats.device)
    total = torch.zeros(rows, device=feats.device)
    cum = []
    for j in range(width - 1):
        state, logits = lrcn.decode_step(decoder, state, tokens[:, j], cnn,
                                         use_kernels=False)
        total = total + torch.log_softmax(logits.float(), -1).gather(
            1, tokens[:, j + 1:j + 2])[:, 0]
        cum.append(total)
    cum = torch.stack(cum, 1)                        # (rows, width - 1)
    eos = tokens[:, 1:] == EOS_ID
    stops = eos.flip(1).int().cumprod(1).flip(1).bool()   # trailing EOS run
    stops[:, -1] = True
    err = (cum - scores[:, None]).abs().masked_fill(~stops, float("inf"))
    return err.min(1).values.max().item()


# kernel name fragment -> the row of the profile table it adds to
PROFILE_GROUPS = [
    ("fprop", "cuDNN convolutions, forward"),
    ("dgrad", "cuDNN convolutions, data gradient"),
    ("wgrad", "cuDNN convolutions, weight gradient"),
    ("max_pool", "max pools and their backward"),
    ("lstm_step_wgmma", "fused LSTM step, wgmma route"),
    ("lstm_step_kernel", "fused LSTM step, wmma/fma route"),
    ("topk_lse", "top-k + log-sum-exp kernel"),
    ("conv3x3_wgmma", "conv kernel, wgmma route (12 of 13 convs)"),
    ("conv3x3_kernel", "conv kernel, scalar route (conv1_1)"),
    ("gemm", "cuBLAS GEMMs"), ("nvjet", "cuBLAS GEMMs"),
    ("distribution", "random draws (dropout, Gumbel noise)"),
    ("adam", "Adam (fused)"), ("softmax", "log_softmax (cross-entropy)"),
    ("nll_loss", "NLL gather (cross-entropy)"),
    ("embedding", "embedding backward"),
    ("reduce", "reductions (max pools, norms, sums, ...)"),
    ("elementwise", "elementwise"), ("index", "gathers / index"),
    ("gather", "gathers / index"), ("copy", "copies / casts")]


def profile_window(label: str, run) -> None:
    """Profile one call of ``run`` (after two warm-up calls, the second
    of which captures a graphed path): wall time, device kernel time,
    idle share of the wall, and kernel time by group."""
    from torch.profiler import ProfilerActivity, profile

    run(), run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:           # the union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(e.time_range.elapsed_us() for e in kernels)
    groups: dict[str, list] = {}
    for e in kernels:
        key = next((g for frag, g in PROFILE_GROUPS
                    if frag in e.name.lower()), "other")
        acc = groups.setdefault(key, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    print(f"[profile] {label}: wall {wall_us / 1e3:.3f} ms, device kernel "
          f"time {total / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share "
          f"of the wall {1 - busy / wall_us:.4f}, {len(kernels)} kernels")
    for key, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile] {label}:   {key}: {us / 1e3:.3f} ms in {n} "
              f"launches, {us / total:.2%}")


def profile_paths(smi: str) -> None:
    """``--profile``: where the device time goes in one 16x256 and one
    1x256 (a serving search) beam-3 decode, one best-of-100 sampling of
    256 images, fc7 extraction of 1x8 and 16x256 images, one training
    dispatch (K=8 steps at the reference width) and one joint fine-tuning
    dispatch (K=4 steps of B=128), bf16, random weights."""
    from lrcn_tpu_torch.data.images import normalize_and_fc7
    from lrcn_tpu_torch.decode.beam import beam_search_grouped
    from lrcn_tpu_torch.decode.sample import best_of_n_search
    from lrcn_tpu_torch.models.lrcn import params_from_numpy
    from lrcn_tpu_torch.models.vgg import vgg_params_from_numpy

    rng = np.random.default_rng(SEED)
    decoder = params_from_numpy(random_tree(rng), "cuda", torch.bfloat16)
    raw = np.abs(rng.standard_normal((FC7_GROUPS * DECODE_BATCH, CNN_DIM)))
    feats = torch.from_numpy((raw / raw.sum(1, keepdims=True)).astype(
        np.float32)).view(FC7_GROUPS, DECODE_BATCH, -1).cuda().to(
            torch.bfloat16)
    for groups in (FC7_GROUPS, 1):
        profile_window(f"beam-{BEAM} decode {groups}x{DECODE_BATCH} bf16 "
                       f"on {smi}", lambda: beam_search_grouped(
                           decoder, feats[:groups], beam_width=BEAM,
                           max_words=MAX_WORDS))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    profile_window(f"best-of-{SAMPLE_N} sampling of {SAMPLE_IMAGES} images "
                   f"bf16 on {smi}", lambda: best_of_n_search(
                       decoder, feats[0, :SAMPLE_IMAGES], n_samples=SAMPLE_N,
                       temperature=SAMPLE_T, max_words=MAX_WORDS,
                       generator=gen))
    del decoder, feats
    vgg = vgg_params_from_numpy(random_vgg(rng), "cuda", torch.bfloat16)
    avg = torch.full((224, 224, 3), 117.0, device="cuda")
    for groups, batch in ((1, ENCODE_BATCH), (FC7_GROUPS, FC7_BATCH)):
        images = torch.from_numpy(rng.integers(
            0, 256, (groups, batch, 224, 224, 3), np.uint8)).cuda()
        profile_window(f"fc7 {groups}x{batch} bf16 on {smi}",
                       lambda: normalize_and_fc7(vgg, images, avg))
        del images
    del vgg
    trainer, params, opt, batches, store = train_setup()
    shuffle = np.random.default_rng(SEED)
    profile_window(f"train dispatch, K={TRAIN_K} steps of B={TRAIN_BATCH} "
                   f"L={TRAIN_LEN} bf16 on {smi}",
                   lambda: trainer.train_epoch(params, opt,
                                               batches[:TRAIN_K], store, 1,
                                               shuffle, log_every=0))
    del trainer, params, opt, batches, store
    step, jparams, jopt, chunk = joint_setup()
    profile_window(f"joint dispatch, K={JOINT_K} steps of B={JOINT_BATCH} "
                   f"L={JOINT_LEN} bf16, remat, on {smi}",
                   lambda: step.multi_step(jparams, jopt, *chunk, 2, 0))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; it needs "
                 "one CUDA card")
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    laps: list = [("start", time.perf_counter())]

    def lap(label: str) -> None:
        laps.append((label, time.perf_counter()))

    if sys.argv[1:2] == ["--reload-export"]:
        reload_exported(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--export-cli"]:
        export_cli(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    name, smi = phase_card()
    phase_build()
    if sys.argv[1:] == ["--profile"]:
        profile_paths(smi)
        return
    if sys.argv[1:] == ["--export"]:
        tree = random_tree(rng)
        shutil.rmtree(WORK, ignore_errors=True)
        from lrcn_tpu_torch.config import LRCNConfig
        write_checkpoint(os.path.join(WORK, "ckpt"), tree, LRCNConfig(
            hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
            vocab_size=VOCAB, compute_dtype="bfloat16"))
        write_joint_checkpoint(os.path.join(WORK, "joint"), tree, rng)
        print(json.dumps(phase_export(smi)))
        shutil.rmtree(WORK, ignore_errors=True)
        return
    if sys.argv[1:] == ["--graphs"]:
        replays = {"phase 17": phase_graphs(smi, rng)}
        tree = random_tree(rng)
        shutil.rmtree(WORK, ignore_errors=True)
        from lrcn_tpu_torch.config import LRCNConfig
        write_checkpoint(os.path.join(WORK, "ckpt"), tree, LRCNConfig(
            hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
            vocab_size=VOCAB, compute_dtype="bfloat16"))
        write_joint_checkpoint(os.path.join(WORK, "joint"), tree, rng)
        t0 = time.perf_counter()
        export_dirs(export_runs(("bf16", "sample", "image")))
        print(f"[18 dispatch] exported bf16, sample and image in "
              f"{time.perf_counter() - t0:.1f} s")
        replays["phase 18"] = phase_dispatch(smi, rng)
        print(json.dumps(replays))
        shutil.rmtree(WORK, ignore_errors=True)
        return
    if sys.argv[1:] == ["--examples"]:
        shutil.rmtree(WORK, ignore_errors=True)
        t0 = time.perf_counter()
        print(json.dumps(phase_examples(smi)))
        print(f"[time] seconds by phase: 19 {time.perf_counter() - t0:.1f}")
        shutil.rmtree(WORK, ignore_errors=True)
        return
    if sys.argv[1:] == ["--moe"]:
        t0 = time.perf_counter()
        print(json.dumps({"kernels": [phase_moe(smi)]}))
        print(f"[time] seconds by phase: 20 {time.perf_counter() - t0:.1f}")
        return
    if sys.argv[1:] == ["--lstm"]:
        t0 = time.perf_counter()
        print(json.dumps({"kernels": [phase_lstm(random_tree(rng), rng)]}))
        print(f"[time] seconds by phase: 3 {time.perf_counter() - t0:.1f}")
        return
    if sys.argv[1:] == ["--mesh"]:
        tree = random_tree(rng)
        shutil.rmtree(WORK, ignore_errors=True)
        from lrcn_tpu_torch.config import LRCNConfig
        from lrcn_tpu_torch.data.feature_store import FeatureStore
        write_checkpoint(os.path.join(WORK, "ckpt"), tree, LRCNConfig(
            hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
            vocab_size=VOCAB, compute_dtype="bfloat16"))
        raw = np.abs(rng.standard_normal((2048, CNN_DIM))).astype(np.float32)
        store = FeatureStore(dim=CNN_DIM, normalized=True)
        for i, row in enumerate(raw / raw.sum(axis=1, keepdims=True)):
            store.add(1000 + i, row)
        store.save(os.path.join(WORK, "store"))
        write_joint_checkpoint(os.path.join(WORK, "joint"), tree, rng)
        print(json.dumps(phase_mesh(smi, rng)))
        shutil.rmtree(WORK, ignore_errors=True)
        return
    lap("1-2")
    tree = random_tree(rng)
    kernels = [phase_lstm(tree, rng)]
    lap("3")
    kernels.append(phase_topk(rng))
    lap("4")
    launches, by_route, feats = phase_service(tree, rng)
    phase_throughput(os.path.join(WORK, "ckpt"), feats, smi)
    lap("5-6")
    kernels.append(phase_conv())
    lap("7")
    image_launches, image_routes = phase_images(tree, rng)
    by_path = {"service (phase 5)": dict(launches),
               "images (phase 8)": image_launches}
    launches["fused_conv3x3_relu"] = image_launches["fused_conv3x3_relu"]
    by_route["fused_conv3x3_relu"] = image_routes["fused_conv3x3_relu"]
    lap("8")
    phase_fc7_throughput(rng, smi)
    lap("9")
    # the serving phases' modules, and their graphs' pools, are gone
    # before training takes the card's memory
    from lrcn_tpu_torch.utils import graphs
    torch.cuda.empty_cache()
    alive = live_graphs()
    check(alive == 0, f"{alive} graphs of phases 5-9 alive before "
                      f"training")
    print(f"[9 fc7 throughput] {graphs.stats['captures']} graphs captured "
          f"and {graphs.stats['replays']} replayed in phases 5-9, none "
          f"alive now; {torch.cuda.memory_reserved() / 2 ** 20:.0f} MB "
          f"reserved")
    by_path["training (phase 10)"] = phase_train(smi)
    lap("10")
    sampling = phase_sample(smi)
    lap("11")
    by_path[f"sampling (phase 11), {sampling['searches']} searches"] = (
        sampling["counts"])
    joint = phase_joint(smi)
    by_path["joint step (phase 12)"] = joint["step"]
    by_path["joint (phase 12)"] = joint["serving"]
    lap("12")
    by_path.update(phase_cli(smi))
    lap("13")
    by_path["native_serve (phase 14)"] = phase_native(smi, tree)
    lap("14")
    by_path.update(phase_export(smi))
    lap("15")
    by_path["mesh_serve (phase 16)"] = phase_mesh(smi, rng)
    lap("16")
    by_path["graph replays (phase 17)"] = phase_graphs(smi, rng)
    lap("17")
    by_path["graph replays (phase 18)"] = phase_dispatch(smi, rng)
    lap("18")
    by_path.update(phase_examples(smi))
    lap("19")
    moe = phase_moe(smi)
    by_path["moe search (phase 20)"] = moe["launches_by_path"][
        "moe search (phase 20)"]
    kernels[1]["moe"] = {key: moe[key] for key in (
        "shape", "kernel_route", "max_abs_err", "ms", "v1_ms", "wall_ms",
        "plain_ms", "library_ms", "library", "bound_ms", "bound_by")}
    lap("20")
    print("[time] seconds by phase: " + ", ".join(
        f"{label} {t - laps[i][1]:.1f}"
        for i, (label, t) in enumerate(laps[1:])))
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
        entry["launches_by_route"] = by_route.get(
            entry["name"], {"cuda": entry["launches"]})
        entry["launches_by_path"] = {path: counts[entry["name"]]
                                     for path, counts in by_path.items()}
        check(entry["launches"] > 0, f"{entry['name']} never launched on "
                                     f"the main path")
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
