"""Command-line interface of the PyTorch port: ``lrcn-torch`` (or
``python -m lrcn_tpu_torch``), the counterpart of ``lrcn_tpu/cli.py``.

The subcommands, flags, defaults and help are the JAX CLI's; the
differences are the top-level ``--device`` (default ``cuda``) in place of
``--platform``, and ``export --platforms``, default ``cpu,cuda`` in place
of ``cpu,tpu``.  ``--device cuda`` on a machine without a CUDA card
raises: no command drops to the CPU on its own.

    lrcn-torch train            --train (lrcn.jl:175-186)
    lrcn-torch generate         caption-set generation for eval
                                (lrcn.jl:127-160)
    lrcn-torch caption IMAGE    single-image captioning (lrcn.jl:102-130)
    lrcn-torch extract-features --extfeatures (lrcn.jl:162-173, 190-221)
    lrcn-torch eval             eval/eval.jl reference building + BLEU
    lrcn-torch bleu             the multi-bleu scorer (eval/multi-bleu.perl)
    lrcn-torch import-karpathy  feature_extractor.jl (Karpathy fc7 import)
    lrcn-torch import-jld       a reference Knet JLD checkpoint
                                (lrcn.jl:185) -> a native checkpoint
    lrcn-torch export-jld       the reverse
    lrcn-torch download         download_data.sh / karpathy_features.sh
    lrcn-torch serve            the HTTP caption service (serve/http.py, or
                                serve/native_http.py with --native-frontend)
    lrcn-torch export           frozen torch.export programs (export.py)

Checkpoints, feature stores, candidate files and ``.jld`` files are those
of the JAX package: each CLI reads what the other writes.  Seeds follow
the JAX CLI: ``--seed`` picks the same held-out ids in both packages
(``np.random.default_rng``); parameter draws, dropout and sampling noise
come from this package's own ``torch.Generator`` streams.

Multi-device runs: ``train --mesh DP TP`` runs one process per mesh
entry (``--num-processes`` counts ranks, and DP x TP must equal it), each
started with ``--coordinator HOST:PORT --num-processes N --process-id I``
or by ``torchrun --nproc-per-node N`` (the launcher's environment);
NCCL on the card, gloo with ``--device cpu``.  ``serve --mesh N`` splits
every search over N data shards in one process (``--device cpu`` lists
the CPU N times).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Sequence

import numpy as np


def _add_model_args(p: argparse.ArgumentParser) -> None:
    # reference defaults: hidden=[1000,1000], embed=1000 (lrcn.jl:39-40)
    p.add_argument("--hidden", type=int, nargs=2, default=[1000, 1000],
                   help="LSTM layer sizes (reference --hidden)")
    p.add_argument("--embed", type=int, default=1000,
                   help="word embedding size (reference --embed)")


def _add_dataset_flags(p: argparse.ArgumentParser) -> None:
    """--flickr/--coco dataset selectors (lrcn.jl:51-52,68-69)."""
    p.add_argument("--flickr", action="store_true",
                   help="work on Flickr30k; fills --datafiles with the "
                        "reference's default .token path when omitted")
    p.add_argument("--coco", action="store_true",
                   help="work on MS-COCO 2014; fills --datafiles with the "
                        "train+val captions json paths when omitted")
    p.add_argument("--data-root", default="data",
                   help="dataset root for the --flickr/--coco defaults "
                        "(layout as written by `lrcn-torch download`)")
    p.add_argument("--vocab-min-count", type=int, default=5,
                   help="vocab filter: keep words appearing >= N times "
                        "(the reference hard-codes 5, tokenizer.jl:30; "
                        "lower it for small custom datasets)")


# the reference's default caption-file locations (lrcn.jl:24-26), relative
# to --data-root; COCO annotations may sit under annotations/ (the layout
# the current cocodataset.org zip extracts to).
_FLICKR_TOKEN = os.path.join("Flickr30k", "results_20130124.token")
_COCO_JSONS = ("captions_train2014.json", "captions_val2014.json")


def _autofill_datafiles(args) -> None:
    """Fill an empty --datafiles from --flickr/--coco (lrcn.jl:68-69)."""
    if args.flickr and args.coco:
        raise SystemExit("pass only one of --flickr/--coco")
    if args.datafiles:
        return
    if args.flickr:
        args.datafiles = [os.path.join(args.data_root, _FLICKR_TOKEN)]
    elif args.coco:
        files = []
        for name in _COCO_JSONS:
            direct = os.path.join(args.data_root, "MsCoCo", name)
            nested = os.path.join(args.data_root, "MsCoCo", "annotations",
                                  name)
            files.append(nested if not os.path.exists(direct)
                         and os.path.exists(nested) else direct)
        args.datafiles = files


def _dataset_kind(args) -> str:
    """'flickr' | 'coco' | '' from the flags or the datafile extensions."""
    if args.flickr:
        return "flickr"
    if args.coco:
        return "coco"
    if any(f.endswith(".token") for f in args.datafiles):
        return "flickr"
    if any(f.endswith(".json") for f in args.datafiles):
        return "coco"
    return ""


def _add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--loadfile", help="checkpoint directory to load")
    p.add_argument("--seed", type=int, default=-1,
                   help="random seed; <=0 = unseeded (reference --seed)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lrcn-torch",
        description="LRCN image captioning on PyTorch and CUDA "
                    "(reference surface: lrcn.jl:30-55)")
    parser.add_argument("--device", default="cuda",
                        help="torch device for every command's work "
                             "(cuda, cuda:N or cpu); cuda raises where no "
                             "CUDA card is present (the reference's "
                             "--atype flag, lrcn.jl:61, picked the device "
                             "the same way)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train the caption decoder")
    p.add_argument("--datafiles", nargs="+", default=[],
                   help="Flickr .token file or COCO captions .json files "
                        "(reference --datafiles); --flickr/--coco fill "
                        "the reference's default paths when omitted")
    _add_dataset_flags(p)
    p.add_argument("--features",
                   help="FeatureStore dir with training fc7 features "
                        "(required unless --joint)")
    p.add_argument("--val-features",
                   help="FeatureStore dir for validation features")
    p.add_argument("--savefile", help="checkpoint dir, saved per epoch")
    p.add_argument("--bestfile",
                   help="checkpoint dir updated only when the epoch's "
                        "validation loss improves (the reference's "
                        "--bestfile was declared in a stale variant and "
                        "referenced at lrcn.jl:63 without being declared "
                        "— a latent KeyError; here it works)")
    p.add_argument("--epochs", type=int, default=10,
                   help="TOTAL epoch budget, counting epochs a resumed "
                        "checkpoint already completed — re-running the "
                        "identical command after a crash stops at N "
                        "(raise it to continue training a finished "
                        "model; the reference instead always trains N "
                        "more, lrcn.jl:225)")
    # None = "not passed": fresh runs fall back to the LRCNConfig defaults
    # (batchsize 25, lr 1e-3, gclip 0, dropout 0.4 — lrcn.jl:41-45,227);
    # resumed runs keep the checkpoint's values unless a flag is given.
    p.add_argument("--batchsize", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--gclip", type=float, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--equal-length-batches", action="store_true",
                   help="reference-parity batching (deletes unbatchable "
                        "captions, lrcn.jl:299-327) instead of bucketing")
    p.add_argument("--mesh", type=int, nargs=2, metavar=("DP", "TP"),
                   help="train over a (data, model) device mesh: one "
                        "process per entry, DP x TP of them")
    p.add_argument("--pipeline", action="store_true",
                   help="pipeline the 2 LSTM layers over the mesh's "
                        "'model' axis (needs --mesh DP 2)")
    p.add_argument("--metrics", help="JSONL metrics file")
    # --- multi-process: one process per mesh entry; absent (and outside
    #     a launcher such as torchrun), they change nothing
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="rendezvous address of rank 0 (multi-process; "
                        "tcp://HOST:PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count: ranks, one per mesh entry "
                        "(multi-process)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank, 0-based (multi-process)")
    p.add_argument("--ckpt-every", type=int, default=None,
                   help="also checkpoint every N dispatches within an "
                        "epoch (crash-safe mid-epoch resume; the "
                        "reference only saves per epoch, lrcn.jl:228)")
    p.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="run N optimizer steps per dispatch (same-shape "
                        "batches, enqueued with no host synchronisation; "
                        "feature table resident on the device, or stacked "
                        "uint8 image batches with --joint); amortizes "
                        "host overhead")
    # --- joint CNN+LSTM fine-tune (paper LRCN-2f, 1411.4389.pdf Table 6;
    #     the reference only ever trains on frozen offline features) ---
    p.add_argument("--joint", action="store_true",
                   help="fine-tune the VGG encoder end-to-end with the "
                        "decoder; requires --images, ignores --features")
    p.add_argument("--images",
                   help="image directory for --joint (ids parsed from "
                        "filenames)")
    p.add_argument("--cnn", dest="vgg_model",
                   help="MatConvNet .mat to initialize the encoder for "
                        "--joint (random init when omitted)")
    p.add_argument("--cnn-lr", type=float, default=None,
                   help="encoder learning rate for --joint "
                        "(default: lr / 10)")
    p.add_argument("--freeze-cnn", action="store_true",
                   help="keep the encoder frozen during --joint training")
    p.add_argument("--no-remat-cnn", action="store_true",
                   help="keep VGG activations instead of rematerializing "
                        "them in the backward pass: faster when the batch "
                        "fits device memory, out of memory otherwise")
    _add_model_args(p)
    _add_common_args(p)

    p = sub.add_parser("generate",
                       help="generate a caption set for evaluation")
    p.add_argument("--loadfile", required=True)
    p.add_argument("--features", required=True,
                   help="FeatureStore dir covering the eval split")
    p.add_argument("--datafiles", nargs="+", default=[],
                   help="caption files; eval ids are sampled from the "
                        "HELD-OUT split they define (Flickr test / COCO "
                        "val, lrcn.jl:132-150). Omitting this falls back "
                        "to sampling the feature store, which is only "
                        "valid when the store holds exactly the eval "
                        "split")
    _add_dataset_flags(p)
    p.add_argument("--capnumber", type=int, default=1000,
                   help="number of images to caption (reference default)")
    p.add_argument("--generate", type=int, default=30, dest="max_words",
                   help="max words per caption (reference --generate)")
    p.add_argument("--beam_width", type=int, default=3)
    p.add_argument("--sample", type=int, default=0, metavar="N",
                   help="instead of beam search, draw N samples per image "
                        "and keep the model-preferred one (the paper's "
                        "'sample N' strategy; reference helpers "
                        "lrcn.jl:680-693)")
    p.add_argument("--temperature", type=float, default=2.0,
                   help="softmax temperature for --sample")
    p.add_argument("--batch-size", type=int, default=None,
                   help="decode batch (default: auto — up to 256 rows, "
                        "smaller for small runs)")
    p.add_argument("--scan-depth", type=int, default=None,
                   dest="decode_scan_depth",
                   help="batches decoded per search (1 decodes batch by "
                        "batch; default: auto — covers the run in as few "
                        "searches as possible, up to 16)")
    p.add_argument("--max-inflight", type=int, default=4,
                   dest="decode_max_inflight",
                   help="searches queued ahead of the host fetch (bounds "
                        "device+host memory)")
    p.add_argument("--resident-store", default="auto",
                   choices=["auto", "on", "off"],
                   help="upload the full feature table to device memory "
                        "once and decode by row index (the serving fast "
                        "path). auto: only when the run decodes at "
                        "least as many rows as the table holds. off "
                        "keeps device memory O(batch) — use it when the "
                        "table would not fit next to the model")
    p.add_argument("--out", default=None,
                   help="candidates file (default: candidates.txt, or "
                        "candidates_flickr for the Flickr split — "
                        "lrcn.jl:133-139)")
    p.add_argument("--ids-out", default=None,
                   help="candidate-ids file (default: candidate_ids.txt "
                        "or candidate_ids_flickr)")
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])

    p = sub.add_parser("caption", help="caption a single image file or URL")
    p.add_argument("image")
    p.add_argument("--loadfile", required=True)
    p.add_argument("--cnn", dest="vgg_model",
                   help="MatConvNet imagenet-vgg-verydeep-16.mat path "
                        "(optional when --loadfile is a joint checkpoint, "
                        "whose fine-tuned encoder is used)")
    p.add_argument("--generate", type=int, default=30, dest="max_words")
    p.add_argument("--beam_width", type=int, default=3)
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=-1)

    p = sub.add_parser("extract-features",
                       help="batched VGG fc7 feature extraction")
    p.add_argument("--cnn", dest="vgg_model",
                   help="MatConvNet imagenet-vgg-verydeep-16.mat")
    p.add_argument("--loadfile",
                   help="joint (cnn+decoder) checkpoint whose fine-tuned "
                        "encoder extracts the features — the LRCN-2f eval "
                        "protocol (explicit --cnn wins if both are given)")
    p.add_argument("--images", required=True,
                   help="directory of images; ids parsed from filenames")
    p.add_argument("--out", required=True, help="FeatureStore dir")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--scan-depth", type=int, default=8,
                   help="batches per device group (one upload and one "
                        "readback; amortizes per-batch host overhead)")
    p.add_argument("--flush-every", type=int, default=8,
                   help="atomic store snapshot every N groups; a crash "
                        "loses at most N*scan_depth batches (0 = only "
                        "save at the end, the reference's fragile "
                        "behavior, lrcn.jl:220)")
    p.add_argument("--no-normalize", action="store_true",
                   help="skip L1 normalization (reference stores "
                        "pre-normalized featsn files)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])

    p = sub.add_parser("eval", help="build per-image reference files and "
                                    "score candidates (eval/eval.jl)")
    p.add_argument("--candidates", required=True)
    p.add_argument("--candidate-ids", required=True)
    p.add_argument("--annotations", required=True,
                   help="COCO captions .json or Flickr .token file")
    p.add_argument("--refs-dir", required=True,
                   help="directory for ref0..ref4 files")

    p = sub.add_parser("bleu", help="multi-bleu scorer "
                                    "(eval/multi-bleu.perl parity)")
    p.add_argument("ref_stem")
    p.add_argument("--lc", action="store_true",
                   help="lowercase (Perl scorer -lc)")

    p = sub.add_parser("import-karpathy",
                       help="build a FeatureStore from Karpathy's "
                            "vgg_feats.mat + dataset.json "
                            "(feature_extractor.jl)")
    p.add_argument("--vgg-feats", required=True, help="vgg_feats.mat path")
    p.add_argument("--dataset-json", required=True)
    p.add_argument("--out", required=True, help="FeatureStore dir")
    p.add_argument("--no-normalize", action="store_true")

    p = sub.add_parser("import-jld",
                       help="convert a reference Knet JLD checkpoint "
                            "(model + vocab, lrcn.jl:185) into a native "
                            "checkpoint directory")
    p.add_argument("jld", help="path to the reference .jld checkpoint")
    p.add_argument("--savefile", required=True,
                   help="output checkpoint directory")

    p = sub.add_parser("export-jld",
                       help="convert a native checkpoint into a "
                            "reference-style Knet JLD file (the reverse "
                            "of import-jld; joint checkpoints export "
                            "the decoder, matching lrcn.jl:185)")
    p.add_argument("checkpoint", help="native checkpoint directory")
    p.add_argument("--out", required=True, help="output .jld path")

    p = sub.add_parser("download",
                       help="fetch COCO 2014 / Flickr30k / Karpathy "
                            "features (reference download_data.sh sources)")
    p.add_argument("dataset", choices=["coco", "flickr", "karpathy"])
    p.add_argument("--root", default="data")

    p = sub.add_parser("serve",
                       help="HTTP caption service with dynamic batching "
                            "(new surface — the reference only generates "
                            "offline)")
    p.add_argument("--loadfile", required=True)
    p.add_argument("--features",
                   help="FeatureStore dir for caption-by-id requests")
    p.add_argument("--cnn", dest="vgg_model",
                   help="MatConvNet .mat for caption-by-image requests "
                        "(optional when --loadfile is a joint checkpoint)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--generate", type=int, default=30, dest="max_words")
    p.add_argument("--beam_width", type=int, default=3)
    p.add_argument("--decode-batch", type=int, default=64,
                   help="decode batch; requests coalesce up to this many "
                        "rows per search")
    p.add_argument("--encode-batch", type=int, default=16,
                   help="VGG batch for image requests (drop it for "
                        "single-image latency-sensitive deployments)")
    p.add_argument("--max-wait-ms", type=float, default=5.0,
                   help="max time the dispatcher waits for stragglers "
                        "after the first queued request")
    p.add_argument("--feat-wait-ms", type=float, default=200.0,
                   help="native front-end: how long raw-feature rows "
                        "may age before dispatching when id traffic is "
                        "also flowing (a feature search costs about the "
                        "same device time for a few rows as for a full "
                        "burst); features go at once when nothing else "
                        "is in flight")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="shard each batch over N devices (one process; "
                        "with --device cpu, N CPU shards)")
    p.add_argument("--max-queue", type=int, default=None,
                   help="shed load (HTTP 503) when a stage's queue "
                        "exceeds this depth; default unbounded")
    p.add_argument("--max-burst-groups", type=int, default=None,
                   help="backlog batches drained in ONE search (default "
                        "4); deeper drains faster at the cost of "
                        "per-search tail latency")
    p.add_argument("--native-frontend", action="store_true",
                   help="serve through the C++ HTTP front-end "
                        "(native/httpserve.cpp): per-request work out "
                        "of the GIL; full request surface (ids, raw "
                        "features, base64 images when an encoder is "
                        "loaded)")
    p.add_argument("--request-timeout", type=float, default=60.0,
                   help="seconds a request may wait on the device "
                        "before HTTP 504")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])

    p = sub.add_parser("export",
                       help="freeze a checkpoint into self-contained "
                            "decode programs (torch.export; deployable "
                            "without this package's model code)")
    p.add_argument("--loadfile", required=True)
    p.add_argument("--out", required=True, help="export directory")
    p.add_argument("--variants", default="beam",
                   help="comma list of beam,greedy,sample,image "
                        "(image = uint8 pixels -> captions; needs a "
                        "joint checkpoint or --cnn)")
    p.add_argument("--cnn", dest="vgg_model",
                   help="MatConvNet .mat encoder for the image variant "
                        "(optional when --loadfile is a joint checkpoint)")
    p.add_argument("--beam_width", type=int, default=3)
    p.add_argument("--generate", type=int, default=30, dest="max_words")
    p.add_argument("--sample-n", type=int, default=100,
                   help="draws per image for the sample variant "
                        "(paper: sample 100)")
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--batch", type=int, default=None,
                   help="pin the batch dimension (default: symbolic — "
                        "one artifact serves any batch size)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma list of platforms the artifacts run on "
                        "(cpu, cuda: one file per variant, moved to the "
                        "device at load)")
    p.add_argument("--compute-dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    return parser


# --- helpers ---


def _start_ranks(args) -> None:
    """``train``: join the process group when the multi-process flags (or
    a launcher's environment) ask for one, NCCL for ``--device cuda`` and
    gloo for ``--device cpu``; then refuse what JAX's CLI refuses."""
    from lrcn_tpu_torch.parallel.distributed import (default_backend,
                                                     initialize,
                                                     process_count)

    initialize(args.coordinator, args.num_processes, args.process_id,
               backend=default_backend(args.device))
    if args.mesh:
        return
    if args.joint:
        if process_count() > 1:
            raise SystemExit(
                "lrcn-torch train --joint: multi-process runs need --mesh "
                "DP TP spanning every process's devices")
        return
    if args.pipeline:
        raise SystemExit("lrcn-torch train: --pipeline requires --mesh DP 2")
    if process_count() > 1:
        raise SystemExit(
            "lrcn-torch train: multi-process runs need --mesh DP TP "
            "spanning every process's devices — without it each process "
            "would train an independent replica")


def _mesh(args, shape, serving: bool = False):
    """A mesh of ``shape``: for ``train`` one entry per rank (each rank's
    card, or the CPU with ``--device cpu``), for ``serve`` this process's
    cards (the CPU listed N times with ``--device cpu``)."""
    import torch

    from lrcn_tpu_torch.parallel import make_mesh
    from lrcn_tpu_torch.parallel.distributed import process_count

    devices = None
    if torch.device(args.device).type == "cpu":
        n = int(np.prod(shape)) if serving else process_count()
        devices = [torch.device("cpu")] * n
    return make_mesh(tuple(shape), devices=devices)


def _device(args):
    """The ``--device`` as a ``torch.device``; raises for a CUDA device
    where torch sees no CUDA card (no command falls back to the CPU)."""
    import torch

    from lrcn_tpu_torch import as_device

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device}: torch.cuda.is_available() is False "
            f"(no CUDA card, or torch built without CUDA); pass --device "
            f"cpu to run on the CPU")
    return as_device(device)


def _compute_dtype(args):
    import torch

    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[args.compute_dtype]


def image_id_from_filename(name: str) -> int:
    """Image id from a COCO/Flickr filename.

    ``COCO_val2014_000000391895.jpg`` -> 391895;
    ``1000092795.jpg`` -> 1000092795 (reference keys feature dicts by these
    integer ids, lrcn.jl:192-207, feature_extractor.jl:23-27).
    """
    stem = os.path.splitext(os.path.basename(name))[0]
    digits = "".join(ch for ch in stem.split("_")[-1] if ch.isdigit())
    if not digits:
        raise ValueError(f"cannot parse an image id from {name!r}")
    return int(digits)


def _image_paths_from_dir(directory: str) -> dict[int, str]:
    """id -> path for every image file in ``directory``."""
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    return {
        image_id_from_filename(f): os.path.join(directory, f)
        for f in sorted(os.listdir(directory))
        if f.lower().endswith(exts)
    }


def decode_geometry(n_images: int, batch_size: int | None,
                    scan_depth: int | None) -> tuple[int, int]:
    """Pick the decode geometry for ``n_images`` (the JAX CLI's rule).

    Explicit flags win; ``None`` auto-sizes: the batch grows to 256 rows
    (power of two, >=16) and the scan depth covers the whole run in as few
    searches as possible (<=16).
    """
    if batch_size is None:
        batch_size = max(16, min(256, 1 << max(0, n_images - 1)
                                 .bit_length()))
    if scan_depth is None:
        scan_depth = max(1, min(16, -(-n_images // batch_size)))
    return batch_size, scan_depth


def _encoder(args, ckpt, device, dtype):
    """(VGG encoder, mean image) for the image commands: an explicit
    ``--cnn`` wins over a joint checkpoint's fine-tuned encoder; (None,
    None) when there is neither."""
    if args.vgg_model:
        from lrcn_tpu_torch.models.vgg import (load_matconvnet,
                                               vgg_params_from_numpy)

        tree, avg = load_matconvnet(args.vgg_model)
        return vgg_params_from_numpy(tree, device, dtype), avg
    if ckpt is not None and ckpt["vgg"] is not None:
        return ckpt["vgg"], ckpt["average_image"]
    return None, None


# train-parser hyperparameters that default to None so resumed runs can
# tell "explicitly passed" from "not passed" (cfg field -> flag name).
_RESUME_OVERRIDES = {"batch_size": "batchsize", "lr": "lr",
                     "gclip": "gclip", "dropout": "dropout"}


def _resumed_config(cfg, args):
    """Apply explicitly-passed hyperparameter flags onto a checkpoint's
    config, printing each override (silently ignoring them was a trap)."""
    for field, flag in _RESUME_OVERRIDES.items():
        value = getattr(args, flag)
        if value is not None and value != getattr(cfg, field):
            print(f"resume: --{flag} {value} overrides checkpoint "
                  f"{field}={getattr(cfg, field)}")
            setattr(cfg, field, value)
    cfg.epochs = args.epochs
    return cfg


def _fresh_config(args, **extra):
    from lrcn_tpu_torch.config import LRCNConfig

    kwargs = {field: getattr(args, flag)
              for field, flag in _RESUME_OVERRIDES.items()
              if getattr(args, flag) is not None}
    kwargs.update(extra)
    return LRCNConfig(
        hidden=tuple(args.hidden), embed=args.embed,
        epochs=args.epochs, seed=args.seed,
        compute_dtype=args.compute_dtype,
        datafiles=tuple(args.datafiles),
        savefile=args.savefile, loadfile=args.loadfile, **kwargs)


# --- commands ---


def cmd_train(args) -> int:
    import torch.distributed as dist

    from lrcn_tpu_torch.parallel.distributed import is_primary, shutdown

    joined = not dist.is_initialized()
    _start_ranks(args)
    try:
        return _train(args, is_primary())
    finally:
        if joined:       # leave a group this command joined
            shutdown()


def _train(args, primary: bool) -> int:
    from lrcn_tpu_torch.core.tokenizer import tokenize
    from lrcn_tpu_torch.data.batcher import (bucket_batches,
                                             effective_batch_size,
                                             equal_length_batches)
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint
    from lrcn_tpu_torch.train.metrics import MetricsLogger
    from lrcn_tpu_torch.train.trainer import Trainer

    _autofill_datafiles(args)
    if not args.datafiles:
        raise SystemExit("lrcn-torch train: pass --datafiles (or "
                         "--flickr/--coco to use the reference's default "
                         "paths)")
    if args.joint:
        return _train_joint(args, primary)
    if not args.features:
        raise SystemExit("lrcn-torch train: --features is required "
                         "(or pass --joint with --images)")
    device = _device(args)

    ckpt = None
    if args.loadfile:
        # the flat numpy params and the optimizer leaves are what a
        # resume needs: read them on the CPU
        ckpt = load_checkpoint(args.loadfile, "cpu")
        if ckpt["vgg"] is not None:
            raise SystemExit(
                f"{args.loadfile} is a joint (cnn+decoder) checkpoint; "
                "resume it with --joint")

    vocab, caption_lists = tokenize(args.datafiles,
                                    min_count=args.vocab_min_count)
    # caption_lists: [train, val, test] for Flickr; [train, val] for COCO
    # json pairs (the reference passes train+val json, lrcn.jl:69)
    train_caps = caption_lists[0]
    val_caps = caption_lists[1] if len(caption_lists) > 1 else None
    store = FeatureStore.load(args.features)

    if ckpt is not None:
        vocab = ckpt["vocab"]
        cfg = _resumed_config(ckpt["cfg"], args)
    else:
        cfg = _fresh_config(args, cnn_feature_dim=store.dim,
                            vocab_size=len(vocab))

    mesh = _mesh(args, args.mesh) if args.mesh else None
    # multi-process: rank 0 alone writes metrics and echoes
    metrics = MetricsLogger(args.metrics if primary else None, echo=primary)
    trainer = Trainer(cfg, vocab, metrics, device=device,
                      steps_per_dispatch=args.steps_per_dispatch, mesh=mesh,
                      pipeline=args.pipeline)
    if ckpt is None:
        params, opt = trainer.init(max(cfg.seed, 0))
    else:
        try:   # resume Adam's moments and step count
            params, opt = trainer.restore(ckpt["params"], ckpt["opt_leaves"])
        except ValueError as e:   # e.g. leaves of another parameter set
            print(f"resume: optimizer state reset ({e})")
            params, opt = trainer.restore(ckpt["params"])

    make_batches = (equal_length_batches if args.equal_length_batches
                    else bucket_batches)
    batch_size = cfg.batch_size
    if mesh is not None:
        # the data axis splits the batch: round the effective batch size
        # (after the reference's small-dataset rule, lrcn.jl:264-268) up
        # to a multiple of the DP degree
        dp = mesh.shape["data"]
        batch_size = -(-effective_batch_size(
            len(train_caps), batch_size) // dp) * dp
        train_batches = make_batches(train_caps, vocab, batch_size,
                                     apply_small_dataset_rule=False)
    else:
        train_batches = make_batches(train_caps, vocab, batch_size)
    val_batches = val_store = None
    if val_caps is not None and args.val_features:
        val_batches = make_batches(val_caps, vocab, batch_size,
                                   apply_small_dataset_rule=mesh is None)
        val_store = FeatureStore.load(args.val_features)

    trainer.fit(params, opt, train_batches, val_batches, store, val_store,
                max(cfg.seed, 0) + 1, savefile=args.savefile,
                bestfile=args.bestfile, ckpt_every=args.ckpt_every,
                resume_position=(ckpt or {}).get("position"),
                completed_epochs=(ckpt or {}).get("epoch", 0))
    metrics.close()
    return 0


def _train_joint(args, primary: bool = True) -> int:
    """``lrcn-torch train --joint``: end-to-end CNN+LSTM fine-tuning (the
    paper's LRCN-2f, 1411.4389.pdf Table 6)."""
    import torch

    from lrcn_tpu_torch.core.tokenizer import tokenize
    from lrcn_tpu_torch.data.batcher import bucket_batches
    from lrcn_tpu_torch.models import vgg as vgg_mod
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint
    from lrcn_tpu_torch.train.joint import (JointTrainer,
                                            identity_average_image)
    from lrcn_tpu_torch.train.metrics import MetricsLogger

    if not args.images:
        raise SystemExit("lrcn-torch train --joint: --images is required")
    for flag, value in (("--equal-length-batches",
                         args.equal_length_batches),
                        ("--features", args.features),
                        ("--val-features", args.val_features)):
        if value:
            raise SystemExit(
                f"lrcn-torch train --joint does not support {flag} (joint "
                "training decodes images per batch; features come from "
                "the live encoder)")
    device = _device(args)

    image_paths = _image_paths_from_dir(args.images)
    if not image_paths:
        raise SystemExit(f"no images found in {args.images}")

    vocab, caption_lists = tokenize(args.datafiles,
                                    min_count=args.vocab_min_count)
    vgg_params = decoder_params = ckpt = None
    average_image = identity_average_image()
    if args.loadfile:
        ckpt = load_checkpoint(args.loadfile, "cpu")
        if ckpt["vgg"] is not None:
            vocab = ckpt["vocab"]
            cfg = _resumed_config(ckpt["cfg"], args)
            average_image = ckpt["average_image"]
        elif args.vgg_model:
            # the paper's 2f warm start (1411.4389.pdf Table 6): decoder
            # from a feature-trained (1f) checkpoint, encoder from the
            # stock weights, fresh optimizer state
            decoder_params = ckpt["params"]
            vocab = ckpt["vocab"]
            cfg = _resumed_config(ckpt["cfg"], args)
            vgg_params, average_image = vgg_mod.load_matconvnet(
                args.vgg_model)
            fc7_dim = int(np.shape(vgg_params["fc7"]["b"])[0])
            if cfg.cnn_feature_dim != fc7_dim:
                raise SystemExit(
                    f"lrcn-torch train --joint: decoder checkpoint expects "
                    f"{cfg.cnn_feature_dim}-dim features but the encoder's "
                    f"fc7 is {fc7_dim}-dim")
            ckpt = None          # warm start, not a resume
        else:
            raise SystemExit(
                f"{args.loadfile} is a decoder-only checkpoint; resume it "
                "without --joint, or warm-start the 2f protocol by also "
                "passing --cnn <vgg .mat>")
    else:
        if args.vgg_model:
            vgg_params, average_image = vgg_mod.load_matconvnet(
                args.vgg_model)
            fc7_dim = int(np.shape(vgg_params["fc7"]["b"])[0])
        else:
            vgg_params = vgg_mod.init_vgg_params(
                torch.Generator().manual_seed(max(args.seed, 0)))
            fc7_dim = int(vgg_params["fc7/b"].shape[0])
        cfg = _fresh_config(args, vocab_size=len(vocab),
                            vgg_model=args.vgg_model,
                            cnn_feature_dim=fc7_dim)

    # only captions whose image is on disk can train end-to-end
    train_caps = [c for c in caption_lists[0] if c.image_id in image_paths]
    dropped = len(caption_lists[0]) - len(train_caps)
    if dropped:
        print(f"joint: dropped {dropped} captions without an image file")
    val_caps = None
    if len(caption_lists) > 1:
        val_caps = [c for c in caption_lists[1]
                    if c.image_id in image_paths] or None

    mesh = _mesh(args, args.mesh) if args.mesh else None
    metrics = MetricsLogger(args.metrics if primary else None, echo=primary)
    trainer = JointTrainer(cfg, vocab, image_paths, average_image,
                           metrics=metrics, cnn_lr=args.cnn_lr,
                           freeze_cnn=args.freeze_cnn,
                           steps_per_dispatch=args.steps_per_dispatch,
                           remat_cnn=not args.no_remat_cnn, device=device,
                           mesh=mesh)
    if ckpt is None:
        params, opt_state = trainer.init(max(cfg.seed, 0),
                                         vgg_params=vgg_params,
                                         decoder_params=decoder_params)
    else:
        try:
            params, opt_state = trainer.restore(ckpt["params"],
                                                ckpt["opt_leaves"])
        except ValueError as e:   # e.g. --freeze-cnn toggled
            print(f"resume: optimizer state reset ({e})")
            params, opt_state = trainer.restore(ckpt["params"])

    train_batches = bucket_batches(train_caps, vocab, cfg.batch_size)
    val_batches = (bucket_batches(val_caps, vocab, cfg.batch_size)
                   if val_caps else None)
    for ckpt_dir in (args.savefile, args.bestfile):
        if ckpt_dir and primary:   # `caption` reads this next to a joint
            os.makedirs(ckpt_dir, exist_ok=True)     # checkpoint
            np.save(os.path.join(ckpt_dir, "average_image.npy"),
                    average_image)
    trainer.fit(params, opt_state, train_batches, val_batches,
                max(cfg.seed, 0) + 1, savefile=args.savefile,
                bestfile=args.bestfile, ckpt_every=args.ckpt_every,
                resume_position=(ckpt or {}).get("position"),
                completed_epochs=(ckpt or {}).get("epoch", 0))
    metrics.close()
    return 0


def cmd_generate(args) -> int:
    import torch

    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.decode.writer import (generate_captions,
                                              pick_eval_ids,
                                              pick_eval_ids_from_captions,
                                              write_candidate_files)
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    _autofill_datafiles(args)
    kind = _dataset_kind(args)
    # default output names follow the reference: candidates.txt /
    # candidate_ids.txt for COCO, candidates_flickr / candidate_ids_flickr
    # for the Flickr split (lrcn.jl:133-141)
    if args.out is None:
        args.out = ("candidates_flickr" if kind == "flickr"
                    else "candidates.txt")
    if args.ids_out is None:
        args.ids_out = ("candidate_ids_flickr" if kind == "flickr"
                        else "candidate_ids.txt")
    device = _device(args)

    ckpt = load_checkpoint(args.loadfile, device, _compute_dtype(args),
                           opt_state=False)
    decoder, vocab = ckpt["decoder"], ckpt["vocab"]
    store = FeatureStore.load(args.features)
    # the JAX CLI's id draw: the same seed picks the same ids
    rng = np.random.default_rng(args.seed if args.seed > 0 else None)
    if args.datafiles:
        # the reference protocol: sample eval ids from the HELD-OUT
        # caption split — caption_dicts[3] (Flickr test) / caption_dicts[2]
        # (COCO val), lrcn.jl:132-150 — never from the feature store
        from lrcn_tpu_torch.core.tokenizer import tokenize
        _, caption_lists = tokenize(args.datafiles,
                                    min_count=args.vocab_min_count)
        if kind == "flickr":
            held_out = caption_lists[2]
        elif len(caption_lists) > 1:
            held_out = caption_lists[1]
        else:
            raise SystemExit(
                "lrcn-torch generate: COCO needs train+val caption jsons so "
                "the held-out val split can be sampled (lrcn.jl:140-142)")
        ids = pick_eval_ids_from_captions(held_out, args.capnumber, rng,
                                          store)
        if not ids:
            raise SystemExit("lrcn-torch generate: no held-out image has "
                             "features in the store")
    else:
        print("generate: no --datafiles given — sampling ids from the "
              "feature store; this matches the reference protocol ONLY if "
              "the store holds exactly the held-out split")
        ids = pick_eval_ids(store.ids(), args.capnumber, rng)
    batch_size, scan_depth = decode_geometry(
        len(ids), args.batch_size, args.decode_scan_depth)
    if args.batch_size is None or args.decode_scan_depth is None:
        print(f"generate: auto geometry batch {batch_size} x "
              f"scan-depth {scan_depth} for {len(ids)} images")
    generator = None
    if args.sample > 0:
        generator = torch.Generator(device=device).manual_seed(
            max(args.seed, 0))
    lines = generate_captions(
        decoder, vocab, store, ids, device=device,
        beam_width=args.beam_width, max_words=args.max_words,
        batch_size=batch_size, scan_depth=scan_depth,
        max_inflight=args.decode_max_inflight,
        resident_store={"auto": None, "on": True,
                        "off": False}[args.resident_store],
        sample_n=args.sample, temperature=args.temperature,
        generator=generator)
    write_candidate_files(lines, ids, args.out, args.ids_out)
    print(f"wrote {len(lines)} captions to {args.out}")
    return 0


def cmd_caption(args) -> int:
    from lrcn_tpu_torch.data.images import preprocess
    from lrcn_tpu_torch.decode.beam import beam_search
    from lrcn_tpu_torch.decode.writer import caption_to_line
    from lrcn_tpu_torch.models.vgg import l1_normalize, vgg16_fc7
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    device, dtype = _device(args), _compute_dtype(args)
    ckpt = load_checkpoint(args.loadfile, device, dtype, opt_state=False)
    vgg, avg = _encoder(args, ckpt, device, dtype)
    if vgg is None:
        raise SystemExit("lrcn-torch caption: --cnn is required unless "
                         "--loadfile is a joint checkpoint")
    image = preprocess(args.image, avg, device)
    feats = l1_normalize(vgg16_fc7(vgg, image))  # live path, lrcn.jl:597
    tokens, _scores = beam_search(ckpt["decoder"], feats,
                                  beam_width=args.beam_width,
                                  max_words=args.max_words)
    print(caption_to_line(tokens.cpu().numpy()[0], ckpt["vocab"]))
    return 0


def cmd_extract_features(args) -> int:
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.data.images import extract_features
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    if not (args.vgg_model or args.loadfile):
        raise SystemExit("lrcn-torch extract-features: pass --cnn <vgg "
                         ".mat> or --loadfile <joint checkpoint>")
    device, dtype = _device(args), _compute_dtype(args)
    # an explicit --cnn wins: the checkpoint is then not even read
    ckpt = (None if args.vgg_model
            else load_checkpoint(args.loadfile, device, dtype,
                                 opt_state=False))
    vgg, avg = _encoder(args, ckpt, device, dtype)
    if vgg is None:
        raise SystemExit(
            "lrcn-torch extract-features: --loadfile must be a joint "
            "(cnn+decoder) checkpoint; decoder-only checkpoints have no "
            "encoder — pass --cnn instead")
    paths = _image_paths_from_dir(args.images)
    store = None
    # roll forward any snapshot a crashed run left behind, then resume
    if FeatureStore.recover(args.out) is not None:
        store = FeatureStore.load(args.out)       # resume, lrcn.jl:203
        print(f"resuming: {len(store)} features already extracted")
    store = extract_features(
        paths, vgg, avg, store=store, batch_size=args.batch_size,
        normalize=not args.no_normalize, scan_depth=args.scan_depth,
        checkpoint_dir=args.out, flush_every=args.flush_every)
    print(f"saved {len(store)} features to {args.out}")
    return 0


def cmd_eval(args) -> int:
    from lrcn_tpu_torch.evaluation.bleu import multi_bleu_files
    from lrcn_tpu_torch.evaluation.references import (
        build_coco_references, build_flickr_references)

    build = (build_flickr_references if args.annotations.endswith(".token")
             else build_coco_references)
    stem = build(args.candidate_ids, args.annotations, args.refs_dir)
    result = multi_bleu_files(stem, args.candidates)
    print(result.format())
    return 0


def cmd_bleu(args) -> int:
    from lrcn_tpu_torch.evaluation.bleu import main as bleu_main

    return bleu_main((["-lc"] if args.lc else []) + [args.ref_stem])


def cmd_import_karpathy(args) -> int:
    from lrcn_tpu_torch.data.karpathy import import_karpathy

    store = import_karpathy(args.vgg_feats, args.dataset_json,
                            normalize=not args.no_normalize)
    store.save(args.out)
    print(f"imported {len(store)} features to {args.out}")
    return 0


def cmd_import_jld(args) -> int:
    from lrcn_tpu_torch.data.jld import import_knet_checkpoint

    out = import_knet_checkpoint(args.jld, args.savefile)
    cfg, vocab = out["cfg"], out["vocab"]
    print(f"imported {args.jld}: hidden={tuple(cfg.hidden)} "
          f"embed={cfg.embed} vocab={len(vocab)} "
          f"cnn_feature_dim={cfg.cnn_feature_dim} -> {args.savefile}")
    return 0


def cmd_export_jld(args) -> int:
    from lrcn_tpu_torch.data.jld import export_knet_checkpoint

    out = export_knet_checkpoint(args.checkpoint, args.out)
    cfg, vocab = out["cfg"], out["vocab"]
    print(f"exported {args.checkpoint}: hidden={tuple(cfg.hidden)} "
          f"embed={cfg.embed} vocab={len(vocab)} "
          f"cnn_feature_dim={cfg.cnn_feature_dim} -> {args.out}")
    return 0


def cmd_download(args) -> int:
    from lrcn_tpu_torch.data.download import download_dataset

    download_dataset(args.dataset, args.root)
    return 0


def make_caption_service(args):
    """Build the ``CaptionService`` from serve-command args (factored out
    of ``cmd_serve`` so tests can drive it without binding a port)."""
    from lrcn_tpu_torch.data.feature_store import FeatureStore
    from lrcn_tpu_torch.serve import CaptionService
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    mesh = (_mesh(args, (args.mesh, 1), serving=True)
            if getattr(args, "mesh", None) else None)
    device, dtype = _device(args), _compute_dtype(args)
    if mesh is not None:
        device = mesh.data_devices()[0]
    ckpt = load_checkpoint(args.loadfile, device, dtype, opt_state=False)
    vgg, avg = _encoder(args, ckpt, device, dtype)
    store = FeatureStore.load(args.features) if args.features else None
    if store is None and vgg is None:
        raise SystemExit("lrcn-torch serve: pass --features (caption by "
                         "id) and/or --cnn / a joint checkpoint (caption by "
                         "image)")
    return CaptionService(
        ckpt["cfg"], ckpt["decoder"], ckpt["vocab"], device=device,
        store=store, vgg=vgg, average_image=avg,
        beam_width=args.beam_width, max_words=args.max_words,
        decode_batch=args.decode_batch, encode_batch=args.encode_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=getattr(args, "max_queue", None),
        request_timeout_s=getattr(args, "request_timeout", 60.0),
        max_burst_groups=getattr(args, "max_burst_groups", None), mesh=mesh)


def cmd_serve(args) -> int:
    import signal

    from lrcn_tpu_torch.serve import make_server

    service = make_caption_service(args)
    print("serve: warming up (building the kernels, every burst "
          "shape)...", flush=True)
    service.warmup()

    if args.native_frontend:
        import threading

        from lrcn_tpu_torch.serve import native_frontend

        try:
            frontend = native_frontend(
                service, host=args.host, port=args.port,
                max_queue=args.max_queue or 4096,
                feat_wait_ms=args.feat_wait_ms)
        except RuntimeError as e:       # never the Python server instead
            service.close()
            raise SystemExit(f"lrcn-torch serve --native-frontend: {e}")
        print(f"serve: native frontend on http://{args.host}:"
              f"{frontend.port}  (POST /v1/caption, GET /healthz, "
              f"GET /stats)", flush=True)
        stop = threading.Event()

        def _stop(_signum, _frame):
            stop.set()

        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
        try:
            stop.wait()
        finally:
            print("serve: draining and shutting down", flush=True)
            frontend.stop()
            service.close()
        return 0

    server = make_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"serve: listening on http://{host}:{port}  "
          f"(POST /v1/caption, GET /healthz, GET /stats)", flush=True)

    def _graceful(_signum, _frame):     # SIGTERM drains like Ctrl-C
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("serve: draining and shutting down", flush=True)
    finally:
        server.server_close()
        service.close()
    return 0


def cmd_export(args) -> int:
    from lrcn_tpu_torch.export import (DEFAULT_PLATFORMS, VARIANTS,
                                       save_exported)
    from lrcn_tpu_torch.train.checkpoint import load_checkpoint

    variants = tuple(v.strip() for v in args.variants.split(",") if v.strip())
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"lrcn-torch export: unknown variants "
                         f"{sorted(unknown)}")
    platforms = tuple(p.strip() for p in args.platforms.split(",")
                      if p.strip())
    if set(platforms) - set(DEFAULT_PLATFORMS):
        raise SystemExit(f"lrcn-torch export: --platforms {args.platforms}:"
                         f" the artifacts run on {','.join(DEFAULT_PLATFORMS)}"
                         f" (tpu is the JAX package's `lrcn export`)")
    device, dtype = _device(args), _compute_dtype(args)
    ckpt = load_checkpoint(args.loadfile, device, dtype, opt_state=False)
    vgg = avg = None
    if "image" in variants:
        vgg, avg = _encoder(args, ckpt, device, dtype)
        if vgg is None:
            raise SystemExit("lrcn-torch export: the image variant needs an "
                             "encoder — pass --cnn or a joint --loadfile")
    manifest = save_exported(
        args.out, ckpt["decoder"], ckpt["vocab"], variants=variants,
        beam_width=args.beam_width, max_words=args.max_words,
        sample_n=args.sample_n, temperature=args.temperature,
        batch=args.batch, platforms=platforms, vgg=vgg, average_image=avg)
    print(f"exported {sorted(manifest['variants'])} for "
          f"{manifest['platforms']} to {args.out}")
    return 0


def main(argv: Sequence[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    handlers = {
        "train": cmd_train,
        "generate": cmd_generate,
        "caption": cmd_caption,
        "extract-features": cmd_extract_features,
        "eval": cmd_eval,
        "bleu": cmd_bleu,
        "import-karpathy": cmd_import_karpathy,
        "import-jld": cmd_import_jld,
        "export-jld": cmd_export_jld,
        "download": cmd_download,
        "serve": cmd_serve,
        "export": cmd_export,
    }
    return handlers[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
