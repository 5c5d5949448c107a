"""Online caption service on one CUDA device (counterpart of
``lrcn_tpu/serve/service.py``).

Two pipelined stages, each behind its own ``DynamicBatcher``:

- **encode** (only when the service was given a VGG encoder): uint8
  images are padded to ``encode_batch`` rows, uploaded, normalized by the
  mean image, run through VGG-16 to fc7 and L1-normalized on the device,
  exactly like the reference's live path (lrcn.jl:597);
- **decode**: fc7 rows -> captions through batched beam search.

Requests for captions by image id and by fc7 rows queue behind a decode
``DynamicBatcher`` each.  Its dispatcher thread pads what it drained to a
whole number of ``decode_batch``-row batches, up to ``MAX_DECODE_GROUPS``
of them in one search (burst absorption), and enqueues the search on the
device without waiting; the collector thread fetches the tokens and
detokenizes them.  Nothing on the issue side waits for the device: every
upload is staged in pinned host memory and queued behind the searches in
flight, and every result's copy to the host is queued right after its
search, with a CUDA event that the fetch waits on (not the whole stream,
which would also wait for the searches issued after it).  The C++ front
end (``serve/native_http.py``) issues through the same entry points.

On a card every search and every encoder batch is one replay of a CUDA
graph (``decode/beam.py``, ``data/images.py:images_to_fc7``), captured at
the second call of a shape (the first runs eagerly), as the JAX service
runs one compiled program a burst.  Capturing synchronizes the card, so
``warmup()`` (and the C++ front end before it reports ready) runs every
shape the service runs twice, capturing each: each burst size of each
decode path and the encoder batch.

Requests by id ship int64 row indices into a feature table that lives on
the device, uploaded once at construction (a store empty at construction
gets no table: requests by id then go through the store's own lookup and
the fc7-row batcher).  Requests by image go through the encode stage,
then the fc7-row batcher.

As in the JAX service, ``max_queue`` bounds each batcher's queue (a
request beyond it raises ``BatcherOverloaded``, HTTP 503 in
``serve/http.py``) and ``max_burst_groups`` sets ``MAX_DECODE_GROUPS``.

With a ``mesh`` (``parallel/mesh.py``) the decoder, the feature table and
the encoder are replicated once per distinct device of the mesh's data
shards, and every search and encoder batch splits into equal contiguous
slices, one per shard, each run on its shard's device and CUDA stream
(``parallel/decode.py``); each shard's result is copied to the host
behind its own work.  ``decode_batch`` (and ``encode_batch`` with an
encoder) must split over the data axis, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from lrcn_tpu_torch import as_device
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data.feature_store import (
    FeatureStore,
    device_table,
    l1_normalize,
)
from lrcn_tpu_torch.data.images import CROP, images_to_fc7
from lrcn_tpu_torch.decode.beam import rows_search, search
from lrcn_tpu_torch.decode.writer import detokenize_batch
from lrcn_tpu_torch.models.lrcn import LRCNDecoder
from lrcn_tpu_torch.models.vgg import VGGEncoder
from lrcn_tpu_torch.parallel.decode import DataShards
from lrcn_tpu_torch.serve.batcher import DynamicBatcher
from lrcn_tpu_torch.train.joint import identity_average_image


class CaptionService:
    """Caption requests against a loaded decoder, batched dynamically.

    ``caption_ids`` looks features up in the store; ``caption_features``
    takes fc7 rows; ``caption_images`` and ``caption_image_bytes`` run the
    encoder (requires ``vgg``).  All are thread-safe: any number of
    request threads may call them, and all device work funnels through the
    batchers' dispatcher threads.
    """

    MAX_DECODE_GROUPS = 4   # batches per burst search

    def __init__(self, cfg: LRCNConfig, decoder: LRCNDecoder, vocab: Vocab,
                 *, device=None, store: FeatureStore | None = None,
                 vgg: VGGEncoder | None = None,
                 average_image: np.ndarray | None = None,
                 beam_width: int = 3, max_words: int = 30,
                 decode_batch: int = 64, encode_batch: int = 8,
                 max_wait_ms: float = 5.0,
                 request_timeout_s: float = 60.0,
                 max_queue: int | None = None,
                 max_burst_groups: int | None = None, mesh=None):
        self.mesh = mesh
        self._shards = None
        if mesh is not None:
            n_data = mesh.shape["data"]
            if decode_batch % n_data or (
                    vgg is not None and encode_batch % n_data):
                raise ValueError(
                    f"decode_batch={decode_batch} / encode_batch="
                    f"{encode_batch} must be divisible by the mesh's "
                    f"data axis ({n_data}) so every chip gets equal "
                    f"batch rows")
            self._shards = DataShards(mesh)
            device = self._shards.devices[0]
        self.device = as_device("cuda" if device is None else device)
        for name, model in (("decoder", decoder), ("vgg", vgg)):
            if (model is not None and mesh is None
                    and model.device != self.device):
                raise ValueError(f"{name} is on {model.device}, service "
                                 f"device is {self.device}")
        self.cfg = cfg
        self.decoder = decoder
        self.vocab = vocab
        self.store = store
        self.beam_width = beam_width
        self.max_words = max_words
        self.decode_batch = decode_batch
        self.request_timeout_s = request_timeout_s
        if max_burst_groups is not None:
            # deeper bursts drain a backlog faster, at the cost of each
            # search's latency
            if max_burst_groups < 1:
                raise ValueError("max_burst_groups must be >= 1")
            self.MAX_DECODE_GROUPS = int(max_burst_groups)
        max_batch = decode_batch * self.MAX_DECODE_GROUPS
        self._feat_burst_warm = self._burst_warm = False
        # every caller of this batcher (caption_features, the encode
        # stage) has normalized its rows once already
        self._decode = DynamicBatcher(
            functools.partial(self._decode_feats_grouped, normalized=True),
            finalize=self._decode_finalize, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="decode", max_queue=max_queue)
        # Device-resident feature table: requests by id ship row indices
        # instead of fc7 rows.  In the compute dtype: the search casts its
        # features to it before first use, so this is bit-identical and
        # halves the table in bf16.
        self._table = self._rows_batcher = None
        if store is not None and len(store):
            self._table = device_table(store, self.device,
                                       decoder.compute_dtype,
                                       normalize=not store.normalized)
            if self._shards is not None:
                self._tables = self._shards.replicate(self._table)
            self._rows_batcher = DynamicBatcher(
                self._decode_rows_grouped, finalize=self._decode_finalize,
                max_batch=max_batch, max_wait_ms=max_wait_ms,
                name="decode_ids", max_queue=max_queue)
        self.vgg = vgg
        self._encode = self._average_image = None
        if self._shards is not None:
            self._decoders = self._shards.replicate(decoder)
        if vgg is not None:
            if vgg.feature_dim != cfg.cnn_feature_dim:
                raise ValueError(f"encoder gives {vgg.feature_dim} features,"
                                 f" decoder expects {cfg.cnn_feature_dim}")
            avg = (identity_average_image() if average_image is None
                   else np.asarray(average_image, np.float32))
            self._average_image = torch.from_numpy(avg).to(self.device)
            if self._shards is not None:
                self._vggs = self._shards.replicate(vgg)
                self._averages = self._shards.replicate(self._average_image)
            self._encode = DynamicBatcher(
                self._encode_fn, finalize=self._encode_finalize,
                max_batch=encode_batch, max_wait_ms=max_wait_ms,
                name="encode", max_queue=max_queue)

    # --- stage fns (dispatcher threads) ---

    def _padded_rows(self, n: int) -> int:
        groups = max(1, -(-n // self.decode_batch))
        if groups > self.MAX_DECODE_GROUPS:
            raise ValueError(f"{n} rows exceed {self.MAX_DECODE_GROUPS} "
                             f"batches of {self.decode_batch}")
        return groups * self.decode_batch

    def _upload(self, array: np.ndarray, device=None) -> torch.Tensor:
        """``array`` on ``device`` (the service's by default), without
        waiting for it.

        A copy from pageable memory synchronizes the stream, which every
        thread shares, so an upload would wait out the searches already
        in flight.  Staged in pinned memory, the copy queues behind them
        instead; the caching host allocator hands the pinned block out
        again only after its copy has run."""
        device = self.device if device is None else device
        host = torch.from_numpy(np.ascontiguousarray(array))
        if device.type != "cuda":
            return host
        staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        staged.copy_(host)
        return staged.to(device, non_blocking=True)

    @torch.inference_mode()
    def _fetch(self, n: int, result: torch.Tensor):
        """Queue the copy of ``result`` to the host right behind the work
        that computes it; returns ``(n, host tensor, event)`` at once.
        The event marks the copy's end: a finalize waits for it alone, not
        for the searches issued after this one (``.cpu()`` would)."""
        if self.device.type != "cuda":
            return n, result, None
        host = torch.empty(result.shape, dtype=result.dtype,
                           pin_memory=True)
        host.copy_(result, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return n, host, done

    def _run_shards(self, n: int, fn, batch: np.ndarray):
        """Under a mesh: ``fn(i, rows)`` on each data shard's device and
        stream for its equal contiguous slice of ``batch``, each result's
        host copy queued behind it; returns ``(n, host tensor, events)``
        at once, like ``_fetch``."""
        parts = [batch[rows] for rows in self._shards.split(len(batch))]
        host, events = self._shards.to_host(self._shards.run(fn, parts))
        return n, host, events

    @staticmethod
    def _wait(raw) -> np.ndarray:
        """The first ``n`` rows of a fetched result, once its copy ran."""
        n, host, done = raw
        for event in (done if isinstance(done, list) else [done]):
            if event is not None:
                event.synchronize()
        return host[:n].numpy()

    def _decode_feats_grouped(self, rows: Sequence[np.ndarray],
                              normalized: bool = False):
        """ENQUEUE one search over fc7 rows, padded to whole batches;
        returns the raw result for ``_decode_finalize`` without waiting.

        With ``normalized=False`` the rows are L1-normalized here, like
        ``caption_features`` (the native front end passes a request's raw
        rows).  The decode batcher passes ``normalized=True``: its callers
        normalize once already."""
        rows = np.asarray(rows, np.float32)
        if not normalized:
            rows = l1_normalize(rows)
        n = len(rows)
        batch = np.zeros((self._padded_rows(n), self.cfg.cnn_feature_dim),
                         np.float32)
        batch[:n] = rows
        if self._shards is not None:
            return self._run_shards(n, lambda i, part: search(
                self._decoders[i], self._upload(part, self._shards.devices[i]),
                beam_width=self.beam_width, max_words=self.max_words
            )[0].to(torch.int32), batch)
        tokens, _ = search(self.decoder, self._upload(batch),
                           beam_width=self.beam_width,
                           max_words=self.max_words)
        # int32 on the device: half the bytes, and the C front end's type
        return self._fetch(n, tokens.to(torch.int32))

    def _decode_rows_grouped(self, rows: Sequence[int]):
        """ENQUEUE one search over rows of the device-resident table."""
        n = len(rows)
        idx = np.zeros((self._padded_rows(n),), np.int64)
        idx[:n] = rows
        if self._shards is not None:
            return self._run_shards(n, lambda i, part: rows_search(
                self._decoders[i], self._tables[i],
                self._upload(part, self._shards.devices[i]),
                beam_width=self.beam_width, max_words=self.max_words
            )[0].to(torch.int32), idx)
        tokens, _ = rows_search(self.decoder, self._table, self._upload(idx),
                                beam_width=self.beam_width,
                                max_words=self.max_words)
        return self._fetch(n, tokens.to(torch.int32))

    def _decode_finalize(self, raw) -> list[str]:
        return detokenize_batch(self._wait(raw), self.vocab)

    def _encode_fn(self, images: Sequence[np.ndarray]):
        """ENQUEUE one padded encoder batch: upload uint8, then normalize,
        VGG to fc7 and L1-normalize on the device (``images_to_fc7``);
        returns the raw result for ``_encode_finalize`` without waiting."""
        n = len(images)
        batch = np.zeros((self._encode.max_batch, CROP, CROP, 3), np.uint8)
        batch[:n] = np.asarray(images, np.uint8)
        if self._shards is not None:
            return self._run_shards(n, lambda i, part: images_to_fc7(
                self._vggs[i], self._upload(part, self._shards.devices[i]),
                self._averages[i]), batch)
        return self._fetch(n, images_to_fc7(
            self.vgg, self._upload(batch), self._average_image))

    def _encode_finalize(self, raw) -> list[np.ndarray]:
        return list(self._wait(raw))

    # --- request side ---

    def caption_features(self, feats: Sequence[np.ndarray]) -> list[str]:
        """Caption raw fc7 rows.

        Rows are L1-normalized here, exactly like the reference's live
        path (``input/sum(input)``, lrcn.jl:597).  A row normalized
        already sums to 1, so it re-normalizes to itself.  fc7 is taken
        before relu7 (lrcn.jl:717), so a row may hold negative entries:
        the divisor is the row's signed sum, not its L1 norm.
        """
        rows = [np.asarray(f, np.float32).reshape(-1) for f in feats]
        for row in rows:
            if row.shape[0] != self.cfg.cnn_feature_dim:
                raise ValueError(
                    f"feature row has {row.shape[0]} dims, model expects "
                    f"{self.cfg.cnn_feature_dim}")
        if not rows:
            return []
        return self._submit_decode(list(l1_normalize(np.stack(rows))))

    def _submit_decode(self, rows: Sequence[np.ndarray]) -> list[str]:
        """Decode already-normalized fc7 rows through the batcher."""
        return self._await_all([self._decode.submit(r) for r in rows])

    def caption_ids(self, image_ids: Sequence[int]) -> list[str]:
        """Caption stored images by id: rows of the device-resident table,
        or, for an empty store (no table), the store's own lookup, which
        raises ``KeyError`` for an unknown id as the JAX service does."""
        if self.store is None:
            raise RuntimeError("service has no feature store")
        if self._rows_batcher is not None:
            rows = self.store.rows(image_ids)   # KeyError on unknown ids
            return self._await_all(
                [self._rows_batcher.submit(int(r)) for r in rows])
        feats = [self.store.get(int(i)) for i in image_ids]
        if not self.store.normalized:
            feats = [l1_normalize(r[None])[0] for r in feats]
        return self._submit_decode(feats)

    def caption_images(self, images: Sequence[np.ndarray]) -> list[str]:
        """(224,224,3) uint8 arrays -> captions (encode stage + decode)."""
        if self._encode is None:
            raise RuntimeError("service has no encoder (pass vgg)")
        feat_futs = [self._encode.submit(np.asarray(img, np.uint8))
                     for img in images]
        # encoder output is already L1-normalized (see _encode_fn)
        return self._submit_decode(self._await_all(feat_futs))

    def caption_image_bytes(self, blobs: Sequence[bytes]) -> list[str]:
        """Raw encoded image bytes (JPEG/PNG) -> captions, decoded
        through :func:`lrcn_tpu_torch.data.images.load_blobs` (the native
        JPEG loader, PIL for the rest)."""
        from lrcn_tpu_torch.data.images import load_blobs

        images, ok = load_blobs(blobs)
        bad = np.flatnonzero(~ok)
        if bad.size:
            raise ValueError(
                f"could not decode image bytes "
                f"(blob{'s' if bad.size > 1 else ''} "
                f"{', '.join(str(int(i)) for i in bad)})")
        return self.caption_images(list(images))

    def _await_all(self, futs: list, timeout_s: float | None = None
                   ) -> list:
        """Wait for every future; on timeout CANCEL the not-yet-batched
        remainder so the device never runs work whose client is gone."""
        try:
            return [f.result(timeout=timeout_s or self.request_timeout_s)
                    for f in futs]
        except Exception:
            for f in futs:
                f.cancel()
            raise

    # --- ops ---

    def warmup(self, timeout_s: float = 600.0) -> None:
        """Run every serving path once before taking traffic: this builds
        the kernels and, on a card, runs twice, and so captures the
        graph of, every burst size, 1..``MAX_DECODE_GROUPS`` batches,
        through the feature path and, with a device table, the id path,
        and the encoder's batch, so that no request meets a capture
        (which synchronizes the card).  ``timeout_s`` covers the first
        build."""
        dim = self.cfg.cnn_feature_dim
        self._await_all([self._decode.submit(np.zeros(dim, np.float32))],
                        timeout_s=timeout_s)
        self.warmup_feature_burst_shapes()
        if self._rows_batcher is not None:
            self._await_all([self._rows_batcher.submit(0)],
                            timeout_s=timeout_s)
            self.warmup_burst_shapes()
        if self._encode is not None:
            for _ in range(2):              # eagerly, then captured
                feat = self._await_all([self._encode.submit(
                    np.zeros((CROP, CROP, 3), np.uint8))],
                    timeout_s=timeout_s)[0]
            self._await_all([self._decode.submit(feat)],
                            timeout_s=timeout_s)

    def _burst_sizes(self) -> list[int]:
        """One row count for each search size, 1..MAX_DECODE_GROUPS
        batches."""
        return [self.decode_batch * g + 1
                for g in range(self.MAX_DECODE_GROUPS)]

    def warmup_feature_burst_shapes(self) -> None:
        """Run two feature searches of every burst size (the first runs
        eagerly, the second captures), so that the first requests of each
        size find its graph captured.  Idempotent; ``warmup()`` and the
        C++ front end call it."""
        if self._feat_burst_warm:
            return
        dim = self.cfg.cnn_feature_dim
        for n in 2 * self._burst_sizes():
            self._decode_finalize(self._decode_feats_grouped(
                np.ones((n, dim), np.float32)))
        self._feat_burst_warm = True

    def warmup_burst_shapes(self) -> None:
        """The id path's counterpart of
        :meth:`warmup_feature_burst_shapes` (nothing without a device
        table)."""
        if self._table is None or self._burst_warm:
            return
        for n in 2 * self._burst_sizes():
            self._decode_finalize(self._decode_rows_grouped([0] * n))
        self._burst_warm = True

    def stats(self) -> dict:
        out = {"decode": self._decode.stats.snapshot()}
        if self._rows_batcher is not None:
            out["decode_ids"] = self._rows_batcher.stats.snapshot()
        if self._encode is not None:
            out["encode"] = self._encode.stats.snapshot()
        return out

    def close(self) -> None:
        self._decode.close()
        if self._rows_batcher is not None:
            self._rows_batcher.close()
        if self._encode is not None:
            self._encode.close()
