"""Drive the PyTorch/CUDA port's caption-serving paths once on one GPU.

    python3 chip_smoke.py              # from the repository root, one card
    python3 chip_smoke.py --profile    # instead: profile the 16x256 and
                                       # 1x256 decodes, sampling, fc7
                                       # extraction, a training and a
                                       # joint dispatch (torch.profiler)

Phases, each printing its own lines; any failure raises and the script
exits nonzero:

1. card and software: ``nvidia-smi``'s name and power limit, torch and CUDA
   versions, ``require_cuda``;
2. build: the kernels compile from ``lrcn_tpu_torch/csrc/``;
3. fused LSTM step kernel against its plain version at the decode step's
   shapes (768 rows, X = H = 1000, both layers' weights) in bf16 and f32,
   bf16 at 3072, 12288 and 25600 rows (a 4-group burst, the 16x256 decode,
   best-of-100 sampling of 256 images), plus a ragged shape, with median
   CUDA-event times of the kernel, the plain version and ``torch.mm`` on
   a pre-concatenated [x, h] (the GEMM alone);
   each case must take its route (bf16 aligned: wgmma, ragged: wmma, f32:
   fma), read from the per-route launch counters; the host time of one
   launch of the wgmma route (TMA descriptors encoded) and the wmma route;
4. top-k + log-sum-exp kernel: every route (block, warp, rounds) that
   takes the case's k against the plain version, values and indices
   exact, at (768, 8800) k=3, 9, 12, (256, 8800) k=1, (12288, 8800) k=3,
   a tie-heavy input, edge rows (-inf entries, an all--inf row, +-1e30,
   ties at the head and tail) at k=3 and 12, V=8801, a misaligned view,
   R=1 and 3, and k=V; the default route must be ``topk_lse_route``'s.
   At the timed shapes: each route's device time (torch.profiler kernel
   durations) in turns with v1 (or rounds above k=8), the wall time per
   wrapper call (CUDA events), host time per wrapper call and per C launch,
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
   the 13-conv stack sums of the three; the 12 aligned bf16 convs must take
   the wgmma route, conv1_1 and the ragged shape the scalar route, f32 the
   fma route; the host time of one launch of the wgmma and scalar routes;
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
   through the kernels against the plain path at f32.

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

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
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
#  rows that are not a multiple of the wgmma route's 128-row block
PARTIAL_ROWS = (3, 192, 576, 1600)
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
TRAIN_DISPATCHES = 3        # timed, after one warm-up dispatch
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
JOINT_DISPATCHES = 2        # timed, after one warm-up dispatch
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
    from lrcn_tpu_torch.ops.kernels.lstm_step import ROUTES

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
    # --sample 100 of 16 images: 1,600), checked and not timed
    cases += [(f"layer{n} bfloat16 {r} rows partial", tree[f"lstm{n}/w"],
               tree[f"lstm{n}/b"], r, torch.bfloat16, big)
              for r in PARTIAL_ROWS for n in (1, 2)]
    worst, times = 0.0, {}
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
                else "wmma" if label.startswith("ragged") else "wgmma")
        check(routes == {want: 1}, f"lstm_step {label}: routes {routes}, "
                                   f"want {want}")
        h_p, c_p = lstm_step_reference(w, b, h, c, x)
        torch.cuda.synchronize()
        err = max((h_k - h_p).abs().max().item(),
                  (c_k - c_p).abs().max().item())
        check(err <= LSTM_ATOL, f"lstm_step {label}: max |err| {err} > "
                                f"{LSTM_ATOL}")
        worst = max(worst, err)
        if label.endswith("partial"):
            print(f"[3 lstm_step] {label}: rows={b_dim} X={x_dim} H={h_dim} "
                  f"route {want} max|err|={err:.3g} (tol {LSTM_ATOL})")
            del w, h, c, x, h_k, c_k, h_p, c_p
            continue
        reps = dict(reps=7, inner=3) if b_dim > rows else {}
        ms = median_ms(lambda: fused_lstm_step(w, b, h, c, x), **reps)
        plain = median_ms(lambda: lstm_step_reference(w, b, h, c, x), **reps)
        # the library yardstick: the GEMM alone on a pre-concatenated [x, h]
        xh = torch.cat([x, h], 1).to(dtype)
        if dtype == torch.bfloat16:
            lib = median_ms(lambda: torch.mm(xh, w, out_dtype=torch.float32),
                            **reps)
        else:
            lib = median_ms(lambda: torch.mm(xh, w), **reps)
        bnd, by = lstm_bound(b_dim, x_dim, h_dim, w.element_size())
        times[label] = (ms, plain, lib, bnd, by)
        print(f"[3 lstm_step] {label}: rows={b_dim} X={x_dim} H={h_dim} "
              f"route {want} max|err|={err:.3g} (tol {LSTM_ATOL}) kernel "
              f"{ms:.4f} ms plain {plain:.4f} ms torch.mm {lib:.4f} ms "
              f"bound {bnd:.4f} ms ({by}); "
              f"{2 * b_dim * (x_dim + h_dim) * 4 * h_dim / ms / 1e9:.1f} "
              f"TFLOP/s")
        del w, h, c, x, xh, h_k, c_k, h_p, c_p
    # the host cost of a launch: the wgmma route encodes four TMA maps
    lib_c = build.load()
    w = torch.from_numpy(tree["lstm1/w"]).cuda().to(torch.bfloat16)
    b = torch.from_numpy(tree["lstm1/b"]).cuda()
    x, h, c, h_o, c_o = (torch.zeros((rows, HIDDEN[0]), device="cuda")
                         for _ in range(5))
    stream = torch.cuda.current_stream().cuda_stream
    host = {route: host_us(lambda: build.check(lib_c.lrcn_lstm_step(
        x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(), b.data_ptr(),
        h_o.data_ptr(), c_o.data_ptr(), rows, HIDDEN[0], HIDDEN[0],
        ROUTES[route], stream), route)) for route in ("wgmma", "wmma")}
    print(f"[3 lstm_step] host time per C launch at {rows} rows: wgmma "
          f"{host['wgmma']:.2f} us (4 TMA maps encoded), wmma "
          f"{host['wmma']:.2f} us")
    ms, plain, lib, bnd, by = times["layer1 bfloat16"]
    s_ms, s_plain, s_lib, s_bnd, _ = times["layer1 bfloat16 sampling"]
    return {"name": "fused_lstm_step", "route": "cuda",
            "source": "lrcn_tpu_torch/csrc/lstm_step.cu",
            "replaces": "lrcn_tpu/ops/pallas/lstm_step.py:63",
            "shape": f"rows={rows} X=H={HIDDEN[0]} bf16",
            "kernel_route": "wgmma", "max_abs_err": worst, "ms": ms,
            "plain_ms": plain, "library_ms": lib, "library": "torch.mm",
            "bound_ms": bnd, "bound_by": by,
            "host_us": host["wgmma"],
            "sampling_shape": f"rows={SAMPLE_IMAGES * SAMPLE_N}",
            "sampling_ms": s_ms, "sampling_plain_ms": s_plain,
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
                            host=host, host_c=host_c, plain=plain, lib=lib,
                            bnd=bnd, by=by)
        print(f"[4 topk_logsumexp] {label} {tuple(x.shape)} k={k}: device "
              f"{default} {dev[default]:.4f} ms, {other} {dev[other]:.4f} ms "
              f"(in turns); wall per call {wall:.4f} ms; host per wrapper "
              f"call {host:.2f} us, per C launch {host_c:.2f} us; plain "
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
            "host_c_us": t["host_c"],
            "timing": "device time from torch.profiler (ms, v1_ms, "
                      "plain_ms, library_ms); wall_ms by CUDA events"}


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
    run()
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
    from lrcn_tpu_torch.ops.kernels.conv3x3 import ROUTES

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
        if label.startswith("B=1"):
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
            "stack_ms": stack[0], "stack_library_ms": stack[2],
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


def phase_images(tree, rng) -> dict:
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.data.images import normalize_batch
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.models.vgg import l1_normalize, vgg16_fc7
    from lrcn_tpu_torch.ops.kernels import (fused_conv3x3_relu,
                                            fused_lstm_step, topk_logsumexp)
    from lrcn_tpu_torch.serve import CaptionService
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB, compute_dtype="bfloat16")
    path = os.path.join(WORK, "joint")
    joint = {f"decoder/{k}": v for k, v in tree.items()}
    joint.update({f"cnn/{k}": v for k, v in random_vgg(rng).items()})
    write_checkpoint(path, joint, cfg)
    mean = np.array([123.68, 116.78, 103.94], np.float32)
    np.save(os.path.join(path, "average_image.npy"),
            np.broadcast_to(mean, (224, 224, 3)))
    del joint

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
        run().sum().item()          # warm up
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
    trainer.train_epoch(params, opt, batches[:TRAIN_K], store, key, shuffle,
                        log_every=0)            # warm-up dispatch
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
    run()[0].cpu()                                      # warm up
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


def joint_setup():
    """A joint step at the reference width on the card (full VGG-16, the
    2x1000 decoder, K=4, dropout 0.4, bf16, mean image 117), its
    parameters and optimizer, and one chunk of K synthetic batches."""
    from lrcn_tpu_torch.config import LRCNConfig
    from lrcn_tpu_torch.models.joint import (JointTrainStep,
                                             make_joint_optimizer)

    cfg = LRCNConfig(hidden=HIDDEN, embed=EMBED, cnn_feature_dim=CNN_DIM,
                     vocab_size=VOCAB, dropout=TRAIN_DROPOUT,
                     compute_dtype="bfloat16", seed=SEED + 1)
    avg = np.full((224, 224, 3), JOINT_MEAN, np.float32)
    step = JointTrainStep(cfg, make_joint_optimizer(cfg), remat_cnn=True,
                          average_image=avg, device="cuda")
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
    _, _, losses = step.multi_step(params, opt_state, *chunk, key, 0)
    losses.cpu()                                # warm-up dispatch
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
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.decode.writer import detokenize_batch
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
    out = {}
    for where, flags in (("card", None), ("cpu", ["--device", "cpu"])):
        path = os.path.join(work, f"f32_{where}")
        run(None, [*gen, "--loadfile", sharp, "--compute-dtype", "float32",
                   "--capnumber", str(CLI_F32_IDS), "--out", path,
                   "--ids-out", path + "_ids"], flags)
        with open(path) as f, open(path + "_ids") as g:
            out[where] = (f.read().splitlines(), g.read())
    differ = [i for i, (a, b) in enumerate(zip(out["card"][0],
                                               out["cpu"][0])) if a != b]
    check(out["card"][1] == out["cpu"][1]
          and len(out["card"][0]) == CLI_F32_IDS
          and len(differ) <= (1 - CAPTION_AGREEMENT) * CLI_F32_IDS,
          f"generate f32 card vs CPU: {len(differ)}/{CLI_F32_IDS} lines "
          f"differ")
    gaps = []
    if differ:          # the same searches by hand: near-ties only
        rows = [int(x) for x in out["card"][1].split()]
        feats = torch.from_numpy(store.gather([rows[i] for i in differ]))
        got = {}
        for device in ("cuda", "cpu"):
            dec = load_checkpoint(sharp, device, torch.float32)
            tokens, scores = beam_search(dec["decoder"], feats.to(device),
                                         beam_width=BEAM,
                                         max_words=MAX_WORDS)
            got[device] = (detokenize_batch(tokens.cpu().numpy(),
                                            dec["vocab"]), scores.cpu())
        check(got["cuda"][0] == [out["card"][0][i] for i in differ]
              and got["cpu"][0] == [out["cpu"][0][i] for i in differ],
              "generate f32: the CLI's lines differ from beam_search's")
        gaps = (got["cuda"][1] - got["cpu"][1]).abs().tolist()
        check(max(gaps) <= SCORE_ATOL * CLI_F32_SHARPEN,
              f"generate f32 card vs CPU: differing lines' score gaps "
              f"{gaps}")
    print(f"[13 cli] generate --compute-dtype float32 (a random checkpoint, "
          f"w_out x {CLI_F32_SHARPEN}), {CLI_F32_IDS} ids, card (kernels) "
          f"vs --device cpu (plain): {CLI_F32_IDS - len(differ)}/"
          f"{CLI_F32_IDS} lines equal (need {CAPTION_AGREEMENT}), the "
          f"others near-ties (score gaps {[round(g, 6) for g in gaps]}, tol "
          f"{SCORE_ATOL * CLI_F32_SHARPEN}); ids equal; "
          f"{len(set(out['card'][0]))} distinct lines")

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
    """Append each beam search's LSTM rows to ``searches`` and each
    encoder batch's size to ``encodes``, whichever thread runs them."""
    from lrcn_tpu_torch.decode import beam
    from lrcn_tpu_torch.serve import service

    real_search, real_fc7 = beam.beam_search, service.vgg16_fc7

    def search(decoder, feats, **kwargs):
        searches.append(feats.shape[0] * kwargs["beam_width"])
        return real_search(decoder, feats, **kwargs)

    def fc7(vgg, pixels, *args):
        encodes.append(pixels.shape[0])
        return real_fc7(vgg, pixels, *args)

    beam.beam_search, service.vgg16_fc7 = search, fc7
    try:
        yield
    finally:
        beam.beam_search, service.vgg16_fc7 = real_search, real_fc7


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
    service.warmup()
    frontend = native_frontend(
        service, host=args.host, port=args.port, n_threads=NATIVE_THREADS,
        max_queue=args.max_queue or 4096, feat_wait_ms=args.feat_wait_ms)
    port = frontend.port
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
    """Profile one call of ``run`` (after a warm-up): wall time, device
    kernel time, idle share of the wall, and kernel time by group."""
    from torch.profiler import ProfilerActivity, profile

    run()
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

    name, smi = phase_card()
    phase_build()
    if sys.argv[1:] == ["--profile"]:
        profile_paths(smi)
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
