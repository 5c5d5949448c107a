"""Frozen-model export: ``torch.export`` programs (counterpart of
``lrcn_tpu/export.py``).

A trained checkpoint freezes into self-contained programs that reload
without this package's model code: each decode variant is traced by
``torch.export`` into an ``ExportedProgram`` with the weights embedded and
a symbolic batch dimension (one artifact serves any batch size; ``batch``
pins it), and saved with ``torch.export.save``.  The programs call the
three kernels as the ``torch.library`` ops ``lrcn::lstm_step``,
``lrcn::topk_lse`` and ``lrcn::conv3x3_relu`` (``ops/kernels``), so a
program runs the hand-written CUDA kernels on the card and their plain
versions on the CPU, as the live path does; its bf16 matmuls are the op
``lrcn::mm_f32`` (``ops/lstm.py``), cuBLAS on the card and bf16-rounded
operands multiplied in f32 on the CPU, as the live path computes them.

Artifacts (one directory):

    export_dir/
      beam.pt2      feats (b, F) f32 -> (tokens (b, T+2) i64, scores (b,))
      greedy.pt2    optional greedy variant (``variants``)
      sample.pt2    optional best-of-N sampling variant (seeded per call)
      image.pt2     optional full pipeline: uint8 pixels -> tokens (needs an
                    encoder: a joint checkpoint or an explicit .mat)
      vocab.json    the checkpoint's vocab (detokenization contract)
      export.json   manifest: variants, shapes, decode settings

Each file holds its program with the weights on the CPU
(``file_device``); ``load_exported(out_dir, device)`` moves it to the
device asked for (``torch.export.passes.move_to_device_pass``), so one
directory runs on the CPU and on the card (``platforms``: ``cpu``,
``cuda``).  The programs are traced on the device of the decoder given
(the CLI's ``--device``), from an example batch of 2: ``torch.export``
specializes an example dimension of 1 to a constant.

The sample program draws its Gumbel noise in the graph from the default
generator of its device; ``ExportedModel.call("sample", feats, seed)``
seeds that generator with ``seed`` inside ``torch.random.fork_rng``, which
gives the stream of ``torch.Generator(device).manual_seed(seed)``: the
tokens of the live ``best_of_n_search(generator=...)``, and the same
tokens for the same ``(feats, seed)`` on every call.  (JAX's program takes
a ``uint32[2]`` key; its stream cannot be reproduced in torch.)

On a card a loaded program runs as the live searches do
(``utils/graphs.py``): eagerly at the first call of an input shape, then
captured into a CUDA graph, which every later call of that shape replays,
the kernels inside it.  The graph registers the device's default
generator, so a replayed sample program draws from the seed the call
set, as an eager one does.

The consumer path (``load_exported``, ``ExportedModel``) imports
``torch``, ``core.vocab``, ``utils.graphs`` and the op registrations, and
nothing of ``models``, ``decode``, ``serve`` or ``train``.  ``ops.kernels`` is
imported before ``torch.export.load``, which resolves ``torch.ops.lrcn.*``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
import torch

import lrcn_tpu_torch.ops.kernels  # noqa: F401  (registers lrcn::*)
from lrcn_tpu_torch import as_device, require_cuda
from lrcn_tpu_torch.core.vocab import Vocab, detokenize_batch
from lrcn_tpu_torch.utils import graphs

# the file of each variant runs on either; TPU is the JAX package's
DEFAULT_PLATFORMS = ("cpu", "cuda")
VARIANTS = ("beam", "greedy", "sample", "image")
FILE_DEVICE = "cpu"     # where each saved program's weights lie
EXAMPLE_BATCH = 2       # an example dimension of 1 is specialized

_MANIFEST = "export.json"


def _platforms(platforms) -> list[str]:
    out = list(platforms)
    bad = [p for p in out if p not in DEFAULT_PLATFORMS]
    if bad:
        raise ValueError(f"platforms {bad} are not this package's: it runs "
                         f"on {list(DEFAULT_PLATFORMS)} (tpu is the JAX "
                         f"package's `lrcn export`)")
    return out


class _Search(torch.nn.Module):
    """``search(decoder, feats, **kwargs)`` as a module whose buffers are
    the decoder's weights."""

    def __init__(self, search, decoder, **kwargs):
        super().__init__()
        self.decoder = decoder
        self.search = search
        self.kwargs = kwargs

    def forward(self, feats):
        return self.search(self.decoder, feats, **self.kwargs)


class _ImagePipeline(torch.nn.Module):
    """uint8 pixels -> mean image and 255-scale preprocessing -> VGG-16
    fc7 -> L1 normalization -> beam search."""

    def __init__(self, vgg, average_image, decoder, beam_width, max_words):
        super().__init__()
        self.vgg = vgg
        self.decoder = decoder
        self.register_buffer("average_image", average_image)
        self.beam_width, self.max_words = beam_width, max_words

    def forward(self, pixels_u8):
        from lrcn_tpu_torch.data.images import normalize_batch
        from lrcn_tpu_torch.decode.beam import beam_search_fn
        from lrcn_tpu_torch.models.vgg import l1_normalize, vgg16_fc7_fn

        feats = vgg16_fc7_fn(self.vgg, normalize_batch(pixels_u8,
                                                       self.average_image))
        return beam_search_fn(self.decoder, l1_normalize(feats),
                              beam_width=self.beam_width,
                              max_words=self.max_words)


def _freeze(module: torch.nn.Module, example: torch.Tensor,
            batch: int | None) -> torch.export.ExportedProgram:
    """Trace ``module`` on ``example`` (batch dimension symbolic unless
    ``batch`` pins it) with the weights embedded, on their device."""
    dynamic = None if batch is not None else (
        {0: torch.export.Dim("b")},)
    with torch.no_grad():
        return torch.export.export(module.eval(), (example,),
                                   dynamic_shapes=dynamic)


def export_decoder(decoder, *, variant: str = "beam", beam_width: int = 3,
                   max_words: int = 30, sample_n: int = 100,
                   temperature: float = 2.0, batch: int | None = None
                   ) -> torch.export.ExportedProgram:
    """Freeze one decode variant over ``decoder`` (an ``LRCNDecoder``, on
    the device the tracing runs on, in its compute dtype).

    ``batch=None`` exports a symbolic batch dimension (any size at call
    time); an int pins it.  The program takes L1-normalized fc7 rows in
    float32 and returns what ``decode.beam.beam_search`` (``greedy_search``,
    ``sample.best_of_n_search``) returns on them.
    """
    from lrcn_tpu_torch.decode import beam, sample

    if variant == "beam":
        module = _Search(beam.beam_search_fn, decoder,
                         beam_width=beam_width, max_words=max_words)
    elif variant == "greedy":
        module = _Search(beam.greedy_search_fn, decoder,
                         max_words=max_words)
    elif variant == "sample":
        module = _Search(sample.best_of_n_search_fn, decoder,
                         n_samples=sample_n, temperature=temperature,
                         max_words=max_words)
    else:
        raise ValueError(f"unknown export variant {variant!r}")
    feature_dim = decoder["w_cnn"].shape[0]
    example = torch.zeros((batch or EXAMPLE_BATCH, feature_dim),
                          device=decoder.device)
    return _freeze(module, example, batch)


def export_image_pipeline(vgg, average_image, decoder, *,
                          beam_width: int = 3, max_words: int = 30,
                          batch: int | None = None
                          ) -> torch.export.ExportedProgram:
    """Freeze the full pipeline: (b, 224, 224, 3) uint8 RGB -> captions.

    Embeds the encoder (``vgg``, a ``VGGEncoder`` on the decoder's device),
    the mean image, the 255-scale preprocessing (lrcn.jl:771), the
    live-path L1 normalize (lrcn.jl:597) and the beam search in one
    program, minus only the host-side JPEG decode and resize.
    """
    avg = torch.as_tensor(np.asarray(average_image, np.float32),
                          device=decoder.device)
    module = _ImagePipeline(vgg, avg, decoder, beam_width, max_words)
    example = torch.zeros((batch or EXAMPLE_BATCH, 224, 224, 3),
                          dtype=torch.uint8, device=decoder.device)
    return _freeze(module, example, batch)


def save_exported(out_dir: str, decoder, vocab: Vocab, *,
                  variants=("beam",), beam_width: int = 3,
                  max_words: int = 30, sample_n: int = 100,
                  temperature: float = 2.0, batch: int | None = None,
                  platforms=DEFAULT_PLATFORMS, vgg=None,
                  average_image=None) -> dict:
    """Export ``variants`` plus vocab + manifest into ``out_dir``.

    Returns the manifest dict.  ``"image"`` in ``variants`` requires
    ``vgg``/``average_image``.  The compute dtype is the decoder's.
    """
    from torch.export.passes import move_to_device_pass

    platforms = _platforms(platforms)
    unknown = [v for v in variants if v not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown export variants {unknown}")
    if "image" in variants and (vgg is None or average_image is None):
        raise ValueError("image export needs an encoder: pass vgg + "
                         "average_image (a joint checkpoint or --cnn)")
    os.makedirs(out_dir, exist_ok=True)
    manifest: dict = {
        "format": "torch.export", "version": 1, "platforms": platforms,
        "beam_width": beam_width, "max_words": max_words,
        "compute_dtype": str(decoder.compute_dtype).removeprefix("torch."),
        "batch": batch, "file_device": FILE_DEVICE, "variants": {},
    }
    for variant in variants:
        if variant == "image":
            exp = export_image_pipeline(
                vgg, average_image, decoder, beam_width=beam_width,
                max_words=max_words, batch=batch)
            entry = {"input": "uint8 pixels (b, 224, 224, 3), RGB, "
                              "resized+cropped"}
        else:
            exp = export_decoder(
                decoder, variant=variant, beam_width=beam_width,
                max_words=max_words, sample_n=sample_n,
                temperature=temperature, batch=batch)
            entry = {"input": "L1-normalized fc7 rows (b, F) float32"}
            if variant == "sample":
                entry["input"] += (" + an int seed of the device's default "
                                   "generator, set per call")
                entry.update(sample_n=sample_n, temperature=temperature)
        name = f"{variant}.pt2"
        torch.export.save(move_to_device_pass(exp, FILE_DEVICE),
                          os.path.join(out_dir, name))
        entry["file"] = name
        manifest["variants"][variant] = entry
    vocab.save(os.path.join(out_dir, "vocab.json"))
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class _Program:
    """A loaded program, called through its graph module's ``forward``.

    The module's ``nn.Module.__call__`` (its input-check pre-hook) is left
    out: through it, a beam search of the reference-width decoder took
    several times the host time it takes through ``forward`` on an H100
    machine (torch 2.11).  The inputs are checked here instead, against
    the dtypes and static dimensions the program was traced with.  On a
    card ``forward`` runs through ``graphs.run`` with the module as owner:
    one graph replay a call from an input shape's second call on."""

    def __init__(self, program: torch.export.ExportedProgram):
        users = set(program.graph_signature.user_inputs)
        self.inputs = [
            (node.name, node.meta["val"].dtype,
             tuple(d if isinstance(d, int) else None
                   for d in node.meta["val"].shape))
            for node in program.graph.nodes
            if node.op == "placeholder" and node.name in users]
        self.module = program.module(check_guards=False)

    def __call__(self, *args: torch.Tensor):
        if len(args) != len(self.inputs):
            raise TypeError(f"the program takes {len(self.inputs)} inputs, "
                            f"got {len(args)}")
        for arg, (name, dtype, shape) in zip(args, self.inputs):
            if (arg.dtype != dtype or arg.dim() != len(shape) or any(
                    want is not None and got != want
                    for got, want in zip(arg.shape, shape))):
                raise ValueError(
                    f"{name}: {arg.dtype} {tuple(arg.shape)}, want {dtype} "
                    f"{tuple('b' if d is None else d for d in shape)}")
        return graphs.run(
            self.module, ("program",), self.module.forward, args,
            generators=(graphs.default_generator(args[0].device),))


@dataclass
class ExportedModel:
    """A loaded export directory: callable variants + the vocab, on one
    device."""

    manifest: dict
    vocab: Vocab
    device: torch.device
    _fns: dict

    def call(self, variant: str, *args):
        """Run a variant; returns (tokens, scores) as tensors on the
        device.  Inputs may be numpy arrays or tensors; ``sample`` takes
        ``(feats, seed)``."""
        if variant not in self._fns:
            raise KeyError(f"variant {variant!r} not in this export "
                           f"(has: {sorted(self._fns)})")
        if variant == "sample":
            feats, seed = args
            args = (feats,)
        inputs = [torch.as_tensor(a).to(self.device) for a in args]
        with torch.inference_mode():
            if variant != "sample":
                return self._fns[variant](*inputs)
            cuda = self.device.type == "cuda"
            with torch.random.fork_rng(
                    devices=[self.device] if cuda else [],
                    device_type=self.device.type):
                if cuda:
                    with torch.cuda.device(self.device):
                        torch.cuda.manual_seed(int(seed))
                else:
                    torch.manual_seed(int(seed))
                return self._fns[variant](*inputs)

    def captions(self, variant: str, *args) -> list[str]:
        """Run a variant and detokenize to caption lines."""
        tokens, _ = self.call(variant, *args)
        return detokenize_batch(tokens.cpu().numpy(), self.vocab)


def load_exported(out_dir: str, device="cuda") -> ExportedModel:
    """Load an export directory written by ``save_exported`` onto
    ``device`` (the card unless the caller asks for the CPU).

    Deserialization needs only torch and the op registrations: the model
    classes never load.  This is the consumer path a deployment runs.
    """
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda":
        require_cuda(device)
    device = as_device(device)
    with open(os.path.join(out_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    if device.type not in manifest["platforms"]:
        raise ValueError(f"this export is for {manifest['platforms']}, not "
                         f"{device.type}")
    fns = {}
    for variant, entry in manifest["variants"].items():
        program = torch.export.load(os.path.join(out_dir, entry["file"]))
        if device != torch.device(manifest["file_device"]):
            program = move_to_device_pass(program, device)
        fns[variant] = _Program(program)
    vocab = Vocab.load(os.path.join(out_dir, "vocab.json"))
    return ExportedModel(manifest=manifest, vocab=vocab, device=device,
                         _fns=fns)
