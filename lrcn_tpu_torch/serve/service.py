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

Requests by id ship int64 row indices into a feature table that lives on
the device, uploaded once at construction (a store empty at construction
gets no table: requests by id then go through the store's own lookup and
the fc7-row batcher).  Requests by image go through the encode stage,
then the fc7-row batcher.

As in the JAX service, ``max_queue`` bounds each batcher's queue (a
request beyond it raises ``BatcherOverloaded``, HTTP 503 in
``serve/http.py``) and ``max_burst_groups`` sets ``MAX_DECODE_GROUPS``.

Not ported yet: the device mesh.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from lrcn_tpu_torch import as_device
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data.feature_store import FeatureStore, l1_normalize
from lrcn_tpu_torch.data.images import CROP, normalize_batch
from lrcn_tpu_torch.decode.beam import rows_search, search
from lrcn_tpu_torch.decode.writer import detokenize_batch
from lrcn_tpu_torch.models.lrcn import LRCNDecoder
from lrcn_tpu_torch.models.vgg import VGGEncoder, vgg16_fc7
from lrcn_tpu_torch.models.vgg import l1_normalize as l1_normalize_device
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
                 *, device, store: FeatureStore | None = None,
                 vgg: VGGEncoder | None = None,
                 average_image: np.ndarray | None = None,
                 beam_width: int = 3, max_words: int = 30,
                 decode_batch: int = 64, encode_batch: int = 8,
                 max_wait_ms: float = 5.0,
                 request_timeout_s: float = 60.0,
                 max_queue: int | None = None,
                 max_burst_groups: int | None = None):
        self.device = as_device(device)
        for name, model in (("decoder", decoder), ("vgg", vgg)):
            if model is not None and model.device != self.device:
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
            table = np.asarray(store.table(), np.float32)
            if not store.normalized:
                table = l1_normalize(table)
            self._table = torch.from_numpy(table).to(
                decoder.compute_dtype).to(self.device)
            self._rows_batcher = DynamicBatcher(
                self._decode_rows_grouped, finalize=self._decode_finalize,
                max_batch=max_batch, max_wait_ms=max_wait_ms,
                name="decode_ids", max_queue=max_queue)
        self.vgg = vgg
        self._encode = self._average_image = None
        if vgg is not None:
            if vgg.feature_dim != cfg.cnn_feature_dim:
                raise ValueError(f"encoder gives {vgg.feature_dim} features,"
                                 f" decoder expects {cfg.cnn_feature_dim}")
            avg = (identity_average_image() if average_image is None
                   else np.asarray(average_image, np.float32))
            self._average_image = torch.from_numpy(avg).to(self.device)
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

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """``array`` on the service's device, without waiting for it.

        A copy from pageable memory synchronizes the stream, which every
        thread shares, so an upload would wait out the searches already
        in flight.  Staged in pinned memory, the copy queues behind them
        instead; the caching host allocator hands the pinned block out
        again only after its copy has run."""
        host = torch.from_numpy(array)
        if self.device.type != "cuda":
            return host
        staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

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

    @staticmethod
    def _wait(raw) -> np.ndarray:
        """The first ``n`` rows of a fetched result, once its copy ran."""
        n, host, done = raw
        if done is not None:
            done.synchronize()
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
        tokens, _ = rows_search(self.decoder, self._table, self._upload(idx),
                                beam_width=self.beam_width,
                                max_words=self.max_words)
        return self._fetch(n, tokens.to(torch.int32))

    def _decode_finalize(self, raw) -> list[str]:
        return detokenize_batch(self._wait(raw), self.vocab)

    def _encode_fn(self, images: Sequence[np.ndarray]):
        """ENQUEUE one padded encoder batch: upload uint8, normalize, VGG
        to fc7, L1-normalize, all on the device; returns the raw result
        for ``_encode_finalize`` without waiting."""
        n = len(images)
        batch = np.zeros((self._encode.max_batch, CROP, CROP, 3), np.uint8)
        batch[:n] = np.asarray(images, np.uint8)
        pixels = normalize_batch(self._upload(batch), self._average_image)
        return self._fetch(n, l1_normalize_device(vgg16_fc7(self.vgg,
                                                            pixels)))

    def _encode_finalize(self, raw) -> list[np.ndarray]:
        return list(self._wait(raw))

    # --- request side ---

    def caption_features(self, feats: Sequence[np.ndarray]) -> list[str]:
        """Caption raw fc7 rows.

        Rows are L1-normalized here, exactly like the reference's live
        path (``input/sum(input)``, lrcn.jl:597).  Pre-normalized input is
        a no-op (fc7 is post-ReLU, so a normalized row re-normalizes to
        itself).
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
        the kernels and warms cuBLAS and the caching allocator at every
        burst size, 1..``MAX_DECODE_GROUPS`` batches, through the feature
        path and, with a device table, the id path, and at the encoder's
        batch.  ``timeout_s`` covers the first build."""
        dim = self.cfg.cnn_feature_dim
        self._await_all([self._decode.submit(np.zeros(dim, np.float32))],
                        timeout_s=timeout_s)
        self.warmup_feature_burst_shapes()
        if self._rows_batcher is not None:
            self._await_all([self._rows_batcher.submit(0)],
                            timeout_s=timeout_s)
            self.warmup_burst_shapes()
        if self._encode is not None:
            feat = self._await_all(
                [self._encode.submit(np.zeros((CROP, CROP, 3), np.uint8))],
                timeout_s=timeout_s)[0]
            self._await_all([self._decode.submit(feat)],
                            timeout_s=timeout_s)

    def _burst_sizes(self) -> list[int]:
        """One row count for each search size, 1..MAX_DECODE_GROUPS
        batches."""
        return [self.decode_batch * g + 1
                for g in range(self.MAX_DECODE_GROUPS)]

    def warmup_feature_burst_shapes(self) -> None:
        """Run one feature search of every burst size, so that the first
        requests of each size find the allocator and cuBLAS warm.
        Idempotent; ``warmup()`` and the C++ front end call it."""
        if self._feat_burst_warm:
            return
        dim = self.cfg.cnn_feature_dim
        for n in self._burst_sizes():
            self._decode_finalize(self._decode_feats_grouped(
                np.ones((n, dim), np.float32)))
        self._feat_burst_warm = True

    def warmup_burst_shapes(self) -> None:
        """The id path's counterpart of
        :meth:`warmup_feature_burst_shapes` (nothing without a device
        table)."""
        if self._table is None or self._burst_warm:
            return
        for n in self._burst_sizes():
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
