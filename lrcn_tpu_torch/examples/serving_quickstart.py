"""Online serving quickstart: library-level API, synthetic model; the
counterpart of ``examples/serving_quickstart.py``.

Builds a tiny decoder + feature store, starts the caption service with
dynamic batching, serves a few requests over HTTP (Python front end), and
prints the per-stage batching stats:

    python -m lrcn_tpu_torch.examples.serving_quickstart [--device cuda|cpu]

The decoder is float32: the port's service computes in its decoder's
dtype (the JAX example passes ``compute_dtype=jnp.float32``).  Production
equivalents: ``lrcn-torch serve --loadfile ckpt/ --features feats/`` (same
endpoints), ``--native-frontend`` for the C++ front end, ``--mesh N`` for
batch-sharded serving.
"""

from __future__ import annotations

import argparse
import http.client
import json
import threading
from typing import Mapping

import numpy as np
import torch

from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.models import lrcn
from lrcn_tpu_torch.serve import CaptionService, make_server

N_IDS, N_REQUESTS = 20, 16
# a tiny untrained model: the captions are gibberish, the point is the
# serving machinery
CONFIG = LRCNConfig(hidden=(32, 32), embed=24, vocab_size=50,
                    cnn_feature_dim=16)


def build_service(cfg: LRCNConfig, params: Mapping | None = None,
                  device="cuda") -> CaptionService:
    """The quickstart's service on ``device``: a float32 decoder from
    ``params`` (an ``LRCNParams`` or the JAX package's parameter tree as
    numpy; by default ``init_params`` from seed 0) and a store of
    ``N_IDS`` random fc7 rows under ids 0..N_IDS-1 (swap in
    ``train.checkpoint.load_checkpoint`` for a real model)."""
    device = torch.device(device)
    if device.type != "cpu":
        require_cuda(device)        # the card, or an error: no CPU fallback
    vocab = Vocab([f"word{i}" for i in range(cfg.vocab_size - 3)])
    if params is None:
        params = lrcn.init_params(cfg, torch.Generator().manual_seed(0))
    decoder = lrcn.params_from_numpy(params, device, torch.float32)

    rng = np.random.default_rng(0)
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim))
             .astype(np.float32) for i in range(N_IDS)}
    store = FeatureStore.from_dict(
        {k: v / v.sum() for k, v in feats.items()}, normalized=True)
    return CaptionService(cfg, decoder, vocab, device=device, store=store,
                          beam_width=3, max_words=10, decode_batch=8,
                          max_wait_ms=20.0)


def main(device: str = "cuda") -> dict:
    """Serve ``N_REQUESTS`` concurrent single-id requests over HTTP; raises
    unless every one is answered with 200.  Returns what was printed:
    ``healthz``, ``captions`` (request index -> caption) and ``stats``."""
    service = build_service(CONFIG, device=device)
    service.warmup()                 # build and capture before traffic
    server = make_server(service, host="127.0.0.1", port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"serving on 127.0.0.1:{port} (device {service.device})")

    def request(path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST" if body else "GET", path,
                     body=json.dumps(body) if body else None)
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
        if resp.status != 200:
            raise RuntimeError(f"{path}: HTTP {resp.status} {out}")
        return out

    try:
        healthz = request("/healthz")
        print("healthz:", healthz)
        # concurrent single-id requests coalesce into one padded dispatch
        results, errors = {}, []

        def one(i):
            try:
                results[i] = request("/v1/caption",
                                     {"id": i % N_IDS})["captions"][0]
            except Exception as e:      # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(N_REQUESTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise RuntimeError(f"{len(errors)} of {N_REQUESTS} requests "
                               f"failed: {errors[0]}")
        print(f"{N_REQUESTS} concurrent captions, e.g.:", results[0])
        stats = request("/stats")
        print("stats:", json.dumps(stats, indent=2))
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    return {"healthz": healthz, "captions": results, "stats": stats}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the card) or cpu")
    main(parser.parse_args().device)
