"""Native (C++) HTTP front end over the port's ``CaptionService``
(counterpart of ``lrcn_tpu/serve/native_http.py``).

``native/httpserve.cpp`` (a byte copy of the JAX package's) does all the
per-request work in C++ threads: accept, HTTP/1.1 keep-alive, the JSON
body, id -> store-row resolution, queueing, and the response built from
raw tokens against the registered vocabulary.  Python enters once per
coalesced batch, in three threads:

- the **pump** pulls up to ``decode_batch * MAX_DECODE_GROUPS`` queued
  items, issues the ids as one grouped search over the device table
  (``service._decode_rows_grouped``) and banks raw fc7 rows, which it
  issues as one grouped feature search (``_decode_feats_grouped``, rows
  normalized there) once they have aged ``feat_wait_ms``, fill a burst,
  or nothing else is in flight;
- the **responder** waits for each issued search's tokens (the event of
  its copy to the host, not the whole stream) and hands them to C++; the
  pump may run ``max_inflight`` id searches ahead of it, and the feature
  leg holds one slot of its own;
- the **image thread** (only when the service has an encoder) pulls
  base64-decoded blobs, decodes them through
  ``lrcn_tpu_torch.data.images.load_blobs`` (looked up at each batch), and
  runs them through ``caption_images`` in a persistent pool of depth 2.

``/v1/caption`` opens last (``lrcn_serve_ready``): before it, a caption
request gets 503, never a raw image id read as a store row.  It opens
after ``warmup_burst_shapes`` and ``warmup_feature_burst_shapes``, which
capture the service's search graphs of every burst size (on a card a
capture synchronizes it; the encoder batch's graph is captured by
``CaptionService.warmup()``, which ``lrcn-torch serve`` calls first).  The
statuses are the C++ front end's: 400 for a malformed body, an unknown id
or a wrong feature width, 404 for another route, 503 past ``max_queue``
or while shutting down, 504 past the service's ``request_timeout_s``,
500 when a batch fails (fast, not at the timeout).

Three repairs against the JAX pump:

- after ``stop()`` nothing is pulled or issued: the gate and every issue
  check the stop flag, which ``stop()`` sets under the lock an issue holds,
  and requests still in hand get 503 at once;
- an image batch that was waiting for a dispatch slot when ``stop()``
  came gets 503 at once, instead of waiting out the request timeout;
- a failed issue fails only its own requests: the id leg's failure
  leaves the banked feature rows banked, and a failed feature flush fails
  only the bank.

Sizing ``n_threads`` (one C++ thread per open connection; a connection
beyond it gets 503 "connection limit"): count every connection that may
be open at once, image clients included.  A connection that posts an
image while the blob queue (64 decoded images) is full holds its thread
for up to 1 s before it sheds (``httpserve.cpp``, the image backpressure),
so with mixed traffic the image clients' connections must not eat the
threads of the id and feature clients: give ``n_threads`` at least the
id and feature connections plus the image connections, with headroom (the
load tests use connections + 64).
"""

from __future__ import annotations

import ctypes
import queue
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lrcn_tpu_torch.core.vocab import EOS_ID
from lrcn_tpu_torch.native import httpserve_library

_LL = ctypes.c_longlong
SHUTTING_DOWN = b"shutting down"
DECODE_FAILED = b"decode failed"


class _FeatureBank:
    """Raw fc7 rows the pump holds back for one grouped feature search."""

    def __init__(self):
        self.rows: list = []
        self.reqs: list = []
        self.slots: list = []
        self.n = 0
        self.first = 0.0       # monotonic arrival of the oldest row held

    def add(self, rows: np.ndarray, reqs: np.ndarray, slots: np.ndarray
            ) -> None:
        if not self.n:
            self.first = time.monotonic()
        self.rows.append(rows)
        self.reqs.append(reqs)
        self.slots.append(slots)
        self.n += len(rows)

    def take(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Everything banked, concatenated; the bank is empty after."""
        out = tuple(np.concatenate(parts) for parts in
                    (self.rows, self.reqs, self.slots))
        self.rows, self.reqs, self.slots, self.n = [], [], [], 0
        return out


class NativeFrontend:
    """Bind the C++ HTTP server to a ``CaptionService``'s decode path.

    Caption-by-id needs the service's device-resident feature table;
    without one (a features-only deployment) id requests get 400 and
    feature requests still serve.  Raises if the native library cannot
    be built or loaded: there is no Python stand-in for it.
    """

    def __init__(self, service, host: str = "0.0.0.0", port: int = 8000,
                 n_threads: int = 128, max_queue: int = 4096,
                 wait_ms: int = 3, max_inflight: int = 2, fill_ms: int = 20,
                 feat_wait_ms: float = 200.0):
        lib = httpserve_library()
        if lib is None:
            raise RuntimeError("native httpserve library unavailable "
                               "(g++ missing or LRCN_NATIVE=0)")
        self.service = service
        self._lib = lib
        # the C++ side binds numeric addresses only
        host_ip = socket.gethostbyname(host)
        self._h = lib.lrcn_serve_start(
            host_ip.encode(), port, n_threads, max_queue,
            int(service.request_timeout_s * 1000))
        if not self._h:
            raise RuntimeError(f"could not bind {host_ip}:{port}")
        self.port = lib.lrcn_serve_port(self._h)
        self._wait_ms = wait_ms
        self._fill_ms = fill_ms
        self._max_inflight = max_inflight
        self._feat_wait_s = feat_wait_ms / 1e3
        # responses are built in C++ from raw tokens
        words = [service.vocab.word(i).encode()
                 for i in range(len(service.vocab))]
        lib.lrcn_serve_set_vocab(
            self._h, (ctypes.c_char_p * len(words))(*words), len(words))
        self._feat_dim = int(service.cfg.cnn_feature_dim)
        lib.lrcn_serve_set_feature_dim(self._h, self._feat_dim)
        # id -> store row, resolved (and unknown ids 400'd) in C++; the
        # store is frozen for the life of the service (its table is on
        # the device already)
        self._rows_resolved = False
        if service.store is not None and service._table is not None:
            sids = np.asarray(service.store.ids(), np.int64)
            srows = np.asarray(service.store.rows(sids), np.int64)
            lib.lrcn_serve_set_id_rows(
                self._h, sids.ctypes.data_as(ctypes.POINTER(_LL)),
                srows.ctypes.data_as(ctypes.POINTER(_LL)), len(sids))
            self._rows_resolved = True
        service.warmup_burst_shapes()
        service.warmup_feature_burst_shapes()
        self._stop = threading.Event()
        self._issue_mu = threading.Lock()    # stop() vs. a starting issue
        # issued searches flow pump -> responder; the budgets bound how
        # many are in flight (the pump blocks on the responder's progress)
        self._respq: queue.Queue = queue.Queue()
        self._resp_budget = threading.Semaphore(max_inflight)
        self._feat_budget = threading.Semaphore(1)
        self._inflight = 0
        self._inflight_mu = threading.Lock()
        self._last_responded = 0
        self.pending_hwm = 0      # the most searches in flight at once
        self._img_thread = None
        if service._encode is not None:
            lib.lrcn_serve_set_image_support(self._h, 1, 64)
            self._img_thread = threading.Thread(
                target=self._run_images, name="lrcn-img", daemon=True)
        self._responder = threading.Thread(
            target=self._run_responder, name="lrcn-respond", daemon=True)
        self._pump = threading.Thread(target=self._run, name="lrcn-pump",
                                      daemon=True)
        self._responder.start()
        self._pump.start()
        if self._img_thread is not None:
            self._img_thread.start()
        lib.lrcn_serve_ready(self._h)        # open /v1/caption last

    # --- pump thread ---

    def _fail(self, reqs, status: int, msg: bytes) -> None:
        for r in np.asarray(reqs).tolist():
            self._lib.lrcn_serve_error(self._h, int(r), status, msg)

    def _pull(self, max_n: int, expect: int = 0):
        ids = (_LL * max_n)()
        reqs = (_LL * max_n)()
        slots = (_LL * max_n)()
        feats = np.empty((max_n, self._feat_dim), np.float32)
        isfeat = (ctypes.c_ubyte * max_n)()
        n = self._lib.lrcn_serve_next(
            self._h, ids, reqs, slots,
            feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            isfeat, max_n, self._wait_ms, self._fill_ms, expect)
        return n, ids, reqs, slots, feats, isfeat

    def _slot_free(self) -> bool:
        """The pull gate: wait for a free in-flight slot before pulling,
        so that arrivals coalesce in the C++ queue while the device works
        and the next pull drains them as one search.  False once
        ``stop()`` was called, also when it came during the wait."""
        while not self._resp_budget.acquire(timeout=0.5):
            if self._stop.is_set():
                return False
        self._resp_budget.release()      # the pump is the only acquirer
        return not self._stop.is_set()

    def _issue(self, fn, reqs: np.ndarray, slots: np.ndarray,
               budget: threading.Semaphore) -> None:
        """Take a slot of ``budget``, run ``fn`` (which enqueues a search
        and returns its raw result) and hand the result to the responder.
        The requests get 500 if ``fn`` raises, and 503 if ``stop()`` came
        first: no issue starts after ``stop()``."""
        while not budget.acquire(timeout=0.5):
            if self._stop.is_set():
                self._fail(reqs, 503, SHUTTING_DOWN)
                return
        try:
            with self._issue_mu:         # stop() sets the flag under it
                raw = None if self._stop.is_set() else fn()
        except Exception as e:   # noqa: BLE001 — fail these, keep serving
            budget.release()
            print(f"native pump: batch failed: {e!r}", flush=True)
            self._fail(reqs, 500, DECODE_FAILED)
            return
        if raw is None:
            budget.release()
            self._fail(reqs, 503, SHUTTING_DOWN)
            return
        with self._inflight_mu:
            self._inflight += 1
            self.pending_hwm = max(self.pending_hwm, self._inflight)
        self._respq.put((raw, reqs, slots, budget))

    def _flush(self, bank: _FeatureBank) -> None:
        rows, reqs, slots = bank.take()
        self._issue(lambda: self.service._decode_feats_grouped(rows),
                    reqs, slots, self._feat_budget)

    def _run(self) -> None:
        svc = self.service
        batch_cap = svc.decode_batch * svc.MAX_DECODE_GROUPS
        # raw fc7 rows wait in the bank: a feature search costs about the
        # same device time for 8 rows as for a full burst, so issuing a
        # sliver every cycle would double every cycle's cost under mixed
        # traffic; when nothing else is in flight they go at once
        bank = _FeatureBank()
        while self._slot_free():
            id_reqs = feat_reqs = None      # pulled, not yet handed on
            try:
                n, ids, reqs, slots, feats, isfeat = self._pull(
                    batch_cap, expect=self._take_forecast())
                if n:
                    flags = np.frombuffer(isfeat, np.uint8, n)
                    ids_np = np.frombuffer(ids, np.int64, n)
                    reqs_np = np.frombuffer(reqs, np.int64, n)
                    slots_np = np.frombuffer(slots, np.int64, n)
                    id_idx = np.flatnonzero(flags == 0)
                    feat_idx = np.flatnonzero(flags)
                    feat_reqs = reqs_np[feat_idx]
                    if id_idx.size and not self._rows_resolved:
                        self._fail(reqs_np[id_idx], 400,
                                   b"caption-by-id needs a feature store "
                                   b"(features-only deployment)")
                        id_idx = id_idx[:0]
                    if id_idx.size:
                        # ids are store rows already (resolved in C++)
                        rows = ids_np[id_idx]
                        id_reqs = reqs_np[id_idx]
                        self._issue(lambda: svc._decode_rows_grouped(rows),
                                    id_reqs, slots_np[id_idx],
                                    self._resp_budget)
                        id_reqs = None
                    if feat_idx.size:
                        if bank.n + feat_idx.size > batch_cap:
                            self._flush(bank)
                        bank.add(feats[feat_idx], feat_reqs,
                                 slots_np[feat_idx])
                    feat_reqs = None
                if bank.n and (
                        bank.n >= batch_cap
                        or time.monotonic() - bank.first >= self._feat_wait_s
                        or self._inflight == 0):
                    self._flush(bank)
            except Exception as e:   # noqa: BLE001 — the pump must outlive
                # anything: fail what this cycle still holds, keep serving
                print(f"native pump: cycle failed: {e!r}", flush=True)
                for held in (id_reqs, feat_reqs):
                    if held is not None and len(held):
                        self._fail(held, 500, DECODE_FAILED)
        # stopped: nothing more is issued; the sentinel queues behind every
        # search in flight, so the responder answers them all first
        for reqs in bank.reqs:
            self._fail(reqs, 503, SHUTTING_DOWN)
        self._respq.put(None)

    def _take_forecast(self) -> int:
        # the last responded batch's size: the pull's arrival forecast
        # (closed-loop clients re-request as soon as they hear back);
        # read-and-zero so a stale value cannot hold pulls once load drops
        r = self._last_responded
        self._last_responded = 0
        return r

    # --- responder thread ---

    def _run_responder(self) -> None:
        """Wait for each issued search's tokens and respond, off the pump
        thread, so that the pump issues the next search meanwhile."""
        while True:
            item = self._respq.get()
            if item is None:
                return
            raw, preqs, pslots, budget = item
            try:
                self._respond_raw(preqs, pslots, raw)
                self._last_responded = len(preqs)
            except Exception as e:   # noqa: BLE001 — fail this batch fast
                print(f"native responder: batch failed: {e!r}", flush=True)
                self._fail(preqs, 500, DECODE_FAILED)
            finally:
                with self._inflight_mu:
                    self._inflight -= 1
                budget.release()

    def _respond_raw(self, preqs, pslots, raw) -> None:
        """Respond from raw tokens: wait for their copy to the host, and
        let C++ detokenize them against the registered vocabulary."""
        toks = np.ascontiguousarray(self.service._wait(raw), np.int32)
        preqs = np.ascontiguousarray(preqs, np.int64)
        pslots = np.ascontiguousarray(pslots, np.int64)
        if toks.shape[0] != len(preqs):
            raise RuntimeError(f"{toks.shape[0]} token rows for "
                               f"{len(preqs)} requests")
        self._lib.lrcn_serve_respond_tokens(
            self._h, preqs.ctypes.data_as(ctypes.POINTER(_LL)),
            pslots.ctypes.data_as(ctypes.POINTER(_LL)),
            toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            toks.shape[1], EOS_ID, len(preqs))

    def _respond(self, preqs, pslots, captions) -> None:
        k = len(captions)
        self._lib.lrcn_serve_respond(
            self._h, (_LL * k)(*[int(r) for r in preqs]),
            (_LL * k)(*[int(s) for s in pslots]),
            (ctypes.c_char_p * k)(*[c.encode() for c in captions]), k)

    # --- image thread ---

    def _run_images(self) -> None:
        """Pull decoded base64 blobs, batch them (after the first, whatever
        else is queued, up to the encoder's batch), decode them to pixels
        and caption them through the service's encode stage.  The encode
        and search run in a pool of depth 2, so that this thread decodes
        batch N+1 while batch N is on the device."""
        from lrcn_tpu_torch.data import images as image_io

        svc = self.service
        buf_cap = 16 << 20
        buf = ctypes.create_string_buffer(buf_cap)
        req = _LL()
        slot = _LL()

        def pull_one(wait_ms: int):
            nonlocal buf, buf_cap
            n = self._lib.lrcn_serve_next_image(
                self._h, ctypes.byref(req), ctypes.byref(slot), buf,
                buf_cap, wait_ms)
            if n < 0:                      # blob bigger than the buffer
                buf_cap = int(-n)
                buf = ctypes.create_string_buffer(buf_cap)
                n = self._lib.lrcn_serve_next_image(
                    self._h, ctypes.byref(req), ctypes.byref(slot), buf,
                    buf_cap, wait_ms)
            if n <= 0:
                return None
            return int(req.value), int(slot.value), buf.raw[:n]

        depth = 2
        sem = threading.Semaphore(depth)
        pool = ThreadPoolExecutor(max_workers=depth,
                                  thread_name_prefix="lrcn-img-dispatch")

        def dispatch(images, metas):
            try:
                caps = svc.caption_images(images)
                self._respond([r for r, _ in metas],
                              [s for _, s in metas], caps)
            except Exception as e:   # noqa: BLE001 — outlive failures
                print(f"native image thread: batch failed: {e!r}",
                      flush=True)
                self._fail([r for r, _ in metas], 500, b"encode failed")
            finally:
                sem.release()

        max_batch = svc._encode.max_batch
        while not self._stop.is_set():
            first = pull_one(50)
            if first is None:
                continue
            batch = [first]
            while len(batch) < max_batch:
                nxt = pull_one(0)
                if nxt is None:
                    break
                batch.append(nxt)
            # looked up at each batch, so a caller may swap the decoder
            decoded, ok = image_io.load_blobs([blob for _, _, blob in batch])
            images, metas = [], []
            for (r, s, _), img, good in zip(batch, decoded, ok):
                if good:
                    images.append(img)
                    metas.append((r, s))
                else:                 # bad bytes = client error
                    self._lib.lrcn_serve_error(
                        self._h, r, 400, b"could not decode image")
            if not images:
                continue
            while not sem.acquire(timeout=0.5):
                if self._stop.is_set():
                    # stopped while waiting for a slot: answer now
                    self._fail([r for r, _ in metas], 503, SHUTTING_DOWN)
                    break
            else:
                pool.submit(dispatch, images, metas)
        pool.shutdown(wait=True)     # dispatches in flight answer first

    # --- ops ---

    def stop(self) -> None:
        """Stop pulling and issuing, answer what is in flight, and close
        the listener.  The service stays open: close it after."""
        with self._issue_mu:
            self._stop.set()
        self._pump.join(timeout=10)          # enqueues the sentinel...
        self._responder.join(timeout=10)     # ...which drains in order
        if self._img_thread is not None:
            self._img_thread.join(timeout=10)
        self._lib.lrcn_serve_stop(self._h)
