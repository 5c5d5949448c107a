"""The port's HTTP front end (``lrcn_tpu_torch/serve/http.py``) against the
JAX package's, on the CPU in f32: two servers on ``127.0.0.1:0``, each
built by its CLI's ``make_caption_service`` over the same JAX-written
joint checkpoint and feature store, give equal captions by id, ids,
features and images, and the same statuses for 400, 404, 413, 503 (under
``--max-queue``) and 504 (``--request-timeout``).  The service option
``max_burst_groups``, and a store that is empty when the service starts
(no device table: ids go through the store's lookup), give the same
captions."""

import base64
import functools
import http.client
import io
import json
import threading

import jax
import numpy as np
import pytest
from PIL import Image

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab
from lrcn_tpu.data.feature_store import FeatureStore
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.models import vgg as jax_vgg
from lrcn_tpu.models.joint import JointParams
from lrcn_tpu.serve import make_server as jax_make_server
from lrcn_tpu.serve.http import MAX_BODY_BYTES as JAX_MAX_BODY_BYTES
from lrcn_tpu.train.checkpoint import save_checkpoint
from lrcn_tpu_torch import cli
from lrcn_tpu_torch.serve import CaptionService, make_server
from lrcn_tpu_torch.serve.http import MAX_BODY_BYTES
from lrcn_tpu_torch.train.checkpoint import load_checkpoint
from test_torch_cli import jax_cli

IDS = list(range(100, 140))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX-written f32 joint checkpoint (VGG at width 0.05, fc 16) and a
    raw (unnormalized) 16-dim feature store."""
    cfg = LRCNConfig(hidden=(16, 12), embed=8, vocab_size=20,
                     cnn_feature_dim=16, compute_dtype="float32")
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    decoder = jax_lrcn.init_params(jax.random.PRNGKey(0), cfg)
    cnn = jax.jit(functools.partial(
        jax_vgg.init_vgg_params, width_multiplier=0.05,
        fc_dim=cfg.cnn_feature_dim))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(8)
    cnn = {name: {"w": np.asarray(layer["w"]),
                  "b": (rng.standard_normal(layer["b"].shape) * 0.1
                        ).astype(np.float32)}
           for name, layer in cnn.items()}
    root = tmp_path_factory.mktemp("http")
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, JointParams(cnn=cnn, decoder=decoder), vocab, cfg)
    np.save(str(root / "ckpt" / "average_image.npy"),
            rng.uniform(90, 130, (224, 224, 3)).astype(np.float32))
    feats = {i: np.abs(rng.standard_normal(cfg.cnn_feature_dim)
                       ).astype(np.float32) for i in IDS}
    store = str(root / "store")
    FeatureStore.from_dict(feats, normalized=False).save(store)
    blobs = []
    for fmt in ("PNG", "JPEG"):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (240, 260, 3)).astype(
            np.uint8)).save(buf, format=fmt)
        blobs.append(base64.b64encode(buf.getvalue()).decode())
    return {"ckpt": ckpt, "store": store, "feats": feats, "blobs": blobs}


def _serve_args(parser, top, files, *extra):
    return parser.parse_args([*top, "serve", "--loadfile", files["ckpt"],
                              "--features", files["store"],
                              "--decode-batch", "4", "--encode-batch", "2",
                              "--beam_width", "2", "--generate", "8",
                              "--max-burst-groups", "2",
                              "--compute-dtype", "float32", *extra])


class Servers:
    """The port's and the JAX package's servers over the same files."""

    def __init__(self, files, *extra, warmup=True):
        self.services = {
            "port": cli.make_caption_service(_serve_args(
                cli.build_parser(), ["--device", "cpu"], files, *extra)),
            "jax": jax_cli.make_caption_service(_serve_args(
                jax_cli.build_parser(), ["--platform", "cpu"], files,
                *extra))}
        if warmup:
            self.services["port"].warmup()
        self.servers = {
            "port": make_server(self.services["port"], "127.0.0.1", 0),
            "jax": jax_make_server(self.services["jax"], "127.0.0.1", 0)}
        for server in self.servers.values():
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()

    def request(self, name, method, path, body=None, headers=None):
        port = self.servers[name].server_address[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            data = (body if isinstance(body, (bytes, type(None)))
                    else json.dumps(body))
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json",
                                  **(headers or {})})
            resp = conn.getresponse()
            return (resp.status, json.loads(resp.read() or b"{}"),
                    resp.getheader("Connection"))
        finally:
            conn.close()

    def both(self, method, path, body=None, headers=None):
        return {name: self.request(name, method, path, body, headers)
                for name in ("port", "jax")}

    def close(self):
        for server in self.servers.values():
            server.shutdown()
            server.server_close()
        for service in self.services.values():
            service.close()


@pytest.fixture(scope="module")
def servers(files):
    s = Servers(files)
    yield s
    s.close()


@pytest.mark.parametrize("body", [
    {"id": 100}, {"ids": [101, 102, 103, 104, 105, 106, 107, 108, 109]},
    "features", "images_b64", "image_b64"])
def test_captions_match_jax_and_the_service(servers, files, body):
    svc = servers.services["port"]
    if body == "features":
        rows = [files["feats"][i].tolist() for i in IDS[:6]]
        body, direct = {"features": rows}, svc.caption_features(rows)
    elif body == "images_b64":
        body = {"images_b64": files["blobs"]}
        direct = svc.caption_image_bytes(
            [base64.b64decode(b) for b in files["blobs"]])
    elif body == "image_b64":
        body = {"image_b64": files["blobs"][1]}
        direct = svc.caption_image_bytes([base64.b64decode(
            files["blobs"][1])])
    else:
        direct = svc.caption_ids(body.get("ids") or [body["id"]])
    out = servers.both("POST", "/v1/caption", body)
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][0] == 200 and out["port"][1]["captions"] == direct


def test_health_and_stats(servers):
    out = servers.both("GET", "/healthz")
    assert out["port"] == out["jax"]
    assert out["port"][1] == {"ok": True, "platform": "cpu"}
    stats = servers.both("GET", "/stats")
    assert set(stats["port"][1]) == set(stats["jax"][1]) == {
        "decode", "decode_ids", "encode"}


@pytest.mark.parametrize("case", [
    "unknown field", "unknown id", "wrong feature width", "bad json",
    "bad base64", "GET route", "POST route", "oversize"])
def test_error_statuses_match_jax(servers, case):
    headers = None
    method, path, body = "POST", "/v1/caption", None
    if case == "unknown field":
        body = {"wrong": 1}
    elif case == "unknown id":
        body = {"id": 999999}
    elif case == "wrong feature width":
        body = {"features": [[0.5, 0.5]]}
    elif case == "bad json":
        body = b"{not json"
    elif case == "bad base64":
        body = {"image_b64": base64.b64encode(b"not an image").decode()}
    elif case == "GET route":
        method, path = "GET", "/nope"
    elif case == "POST route":
        path, body = "/nope", {"pad": "y" * 2048}
    else:
        body, headers = b"", {"Content-Length": str(MAX_BODY_BYTES + 1)}
    out = servers.both(method, path, body, headers)
    want = {"unknown field": 400, "unknown id": 400,
            "wrong feature width": 400, "bad json": 400, "bad base64": 400,
            "GET route": 404, "POST route": 404, "oversize": 413}[case]
    assert out["port"][0] == out["jax"][0] == want
    assert "error" in out["port"][1] and "error" in out["jax"][1]
    assert out["port"][2] == out["jax"][2]      # Connection: close or not
    assert MAX_BODY_BYTES == JAX_MAX_BODY_BYTES


def test_503_under_max_queue_and_504_on_timeout(files):
    """``--max-queue 0`` sheds every request (503); ``--request-timeout
    0`` gives up on the device at once (504); both servers keep serving."""
    for extra, status in ((["--max-queue", "0"], 503),
                          (["--request-timeout", "0"], 504)):
        s = Servers(files, *extra, warmup=False)
        try:
            out = s.both("POST", "/v1/caption", {"id": 100})
            assert out["port"][0] == out["jax"][0] == status, out
            assert out["port"][2] == out["jax"][2]
            again = s.both("GET", "/healthz")
            assert again["port"][0] == again["jax"][0] == 200
        finally:
            s.close()


def test_burst_groups_and_no_resident_store_give_the_same_captions(files):
    ck = load_checkpoint(files["ckpt"], "cpu")
    from lrcn_tpu_torch.data.feature_store import FeatureStore as Store
    store = Store.load(files["store"])

    def service(store=store, **kw):
        return CaptionService(ck["cfg"], ck["decoder"], ck["vocab"],
                              device="cpu", store=store, beam_width=2,
                              max_words=8, decode_batch=4, **kw)

    default = service()
    try:
        want = default.caption_ids(IDS)      # a burst: 40 rows, 10 batches
    finally:
        default.close()
    for kw in (dict(max_burst_groups=1), dict(max_burst_groups=3),
               dict(store=Store(dim=16)), dict(max_queue=100)):
        svc = service(**kw)
        try:
            seen = []
            grouped = svc._decode_feats_grouped
            svc._decode_feats_grouped = lambda rows: (
                seen.append(len(rows)) or grouped(rows))
            svc.warmup()
            groups = kw.get("max_burst_groups", 4)
            assert svc.MAX_DECODE_GROUPS == groups
            # every burst size ran twice before traffic (on a card the
            # first runs eagerly and the second captures its graph)
            assert seen == 2 * [4 * g + 1 for g in range(groups)]
            # a store empty at construction gets no device table; rows
            # added later are found through the store's own lookup
            assert (svc._table is None) == ("store" in kw)
            for i, feat in files["feats"].items():
                if i not in svc.store:
                    svc.store.add(i, feat)
            assert svc.caption_ids(IDS) == want, kw
        finally:
            svc.close()
    with pytest.raises(ValueError, match="max_burst_groups"):
        service(max_burst_groups=0)
