"""The port's C++ front end under load, on the CPU: concurrent clients
coalesce into fewer searches, mixed id and feature traffic keeps the
searches in flight within the budget, slow-header and trickling-header
connections are released, the port's load generator (``loadgen.cpp``)
drives it closed-loop, open-loop and with feature bodies without an error,
and ``lrcn-torch serve --native-frontend`` serves, drains on SIGTERM, and
refuses to start without the native library.  One JAX-written f32
checkpoint (``tests/test_serve_native.py``'s small configuration) and a
raw feature store under ids 0..63, the ids the load generator asks for."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest

from lrcn_tpu.config import LRCNConfig
from lrcn_tpu.core.vocab import Vocab
from lrcn_tpu.data.feature_store import FeatureStore
from lrcn_tpu.models import lrcn as jax_lrcn
from lrcn_tpu.train.checkpoint import save_checkpoint
from lrcn_tpu_torch import cli
from lrcn_tpu_torch.native import loadgen_binary
from lrcn_tpu_torch.serve.native_http import NativeFrontend
from test_torch_native_http import request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_IDS, DIM = 64, 8
SERVE = ["--decode-batch", "8", "--beam_width", "2", "--generate", "8",
         "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    cfg = LRCNConfig(hidden=(16, 16), embed=12, vocab_size=20,
                     cnn_feature_dim=DIM, compute_dtype="float32")
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    root = tmp_path_factory.mktemp("native_load")
    save_checkpoint(str(root / "ckpt"),
                    jax_lrcn.init_params(jax.random.PRNGKey(0), cfg), vocab,
                    cfg)
    rng = np.random.default_rng(5)
    FeatureStore.from_dict(
        {i: np.abs(rng.standard_normal(DIM)).astype(np.float32)
         for i in range(N_IDS)}, normalized=False).save(str(root / "store"))
    return {"ckpt": str(root / "ckpt"), "store": str(root / "store")}


def serve_args(files, *extra):
    return ["serve", "--loadfile", files["ckpt"], "--features",
            files["store"], *SERVE, *extra]


@pytest.fixture(scope="module")
def service(files):
    svc = cli.make_caption_service(cli.build_parser().parse_args(
        ["--device", "cpu", *serve_args(files)]))
    yield svc
    svc.close()


def frontend(service, **kwargs):
    return NativeFrontend(service, **{"host": "127.0.0.1", "port": 0,
                                      "n_threads": 64, "wait_ms": 2,
                                      **kwargs})


def test_concurrent_clients_coalesce(service):
    fe = frontend(service)
    try:
        want = service.caption_ids(list(range(12)))
        results = {}
        barrier = threading.Barrier(32)

        def client(i):
            barrier.wait(timeout=30)
            results[i] = request(fe.port, "POST", "/v1/caption",
                                 {"id": i % 12})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert len(results) == 32
        for i, (status, out) in results.items():
            assert status == 200 and out["captions"] == [want[i % 12]]
        _, stats = request(fe.port, "GET", "/stats")
        assert stats["frontend"] == "native" and stats["items"] >= 32
        assert stats["batches"] < stats["items"], stats
    finally:
        fe.stop()


def test_mixed_traffic_keeps_inflight_within_the_budget(service):
    """Sustained id and feature traffic: the id leg holds at most
    ``max_inflight`` searches in flight and the feature leg one, so the
    high water of searches in flight stays within both budgets."""
    fe = frontend(service)
    stop = threading.Event()
    errors, served = [], []

    def hammer(kind, seed):
        rng = np.random.default_rng(seed)
        k = 0
        while not stop.is_set():
            body = ({"id": k % N_IDS} if kind == "id" else
                    {"features": [np.abs(rng.standard_normal(DIM)).tolist()]})
            status, _ = request(fe.port, "POST", "/v1/caption", body)
            if status != 200:
                errors.append((kind, status))
                return
            served.append(kind)
            k += 1

    threads = [threading.Thread(target=hammer, args=(kind, 100 + i))
               for i, kind in enumerate(("id", "feat") * 4)]
    try:
        for t in threads:
            t.start()
        time.sleep(3.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        fe.stop()
    assert not errors, errors
    assert served.count("id") > 0 and served.count("feat") > 0
    assert 1 <= fe.pending_hwm <= fe._max_inflight + 1, fe.pending_hwm


@pytest.mark.parametrize("mode", ["stall", "trickle"])
def test_slow_header_connections_are_released(files, mode):
    """A client that stops sending header bytes, or keeps trickling them,
    is disconnected once the request timeout (2 s) passes, and the server
    serves on."""
    svc = cli.make_caption_service(cli.build_parser().parse_args(
        ["--device", "cpu", *serve_args(files, "--request-timeout", "2")]))
    fe = frontend(svc, n_threads=8)
    try:
        s = socket.create_connection(("127.0.0.1", fe.port), timeout=30)
        s.sendall(b"POST /v1/caption HTTP/1.1\r\nX-Slow: ")
        s.setblocking(False)
        t0 = time.monotonic()
        closed = False
        while time.monotonic() - t0 < 15 and not closed:
            try:
                if mode == "trickle":
                    s.sendall(b"y")
                closed = s.recv(4096) == b""
            except BlockingIOError:
                pass
            except OSError:         # closed on us mid-send
                closed = True
            time.sleep(0.25)
        s.close()
        assert closed, f"{mode}ing header connection held after 15 s"
        assert request(fe.port, "POST", "/v1/caption", {"id": 3})[0] == 200
    finally:
        fe.stop()
        svc.close()


def run_loadgen(port, conns, seconds, rate=0.0, feat_dim=0):
    exe = loadgen_binary()
    assert exe is not None, "loadgen did not build"
    out = subprocess.run(
        [exe, "127.0.0.1", str(port), str(conns), str(seconds), str(N_IDS),
         "1", str(rate), str(feat_dim), ""],
        capture_output=True, text=True, timeout=seconds + 150)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["closed", "open", "features"])
def test_loadgen_drives_the_frontend(service, mode):
    """Closed loop at 8 connections, open loop at 50 requests/s and raw
    feature bodies, 1 s each: every request answered 200."""
    fe = frontend(service)
    try:
        if mode == "closed":
            r = run_loadgen(fe.port, 8, 1.0)
            assert r["requests"] > 0 and r["captions_per_s"] > 0
        elif mode == "open":
            r = run_loadgen(fe.port, 16, 1.0, rate=50)
            # every scheduled request fired and completed
            assert r["scheduled"] > 0 and r["completion"] >= 0.99
            assert r["p99_ms"] >= r["p50_ms"] > 0
        else:
            r = run_loadgen(fe.port, 4, 1.0, feat_dim=DIM)
            _, stats = request(fe.port, "GET", "/stats")
            assert r["requests"] > 0 and stats["feat_items"] >= r["requests"]
        assert r["errors"] == 0, r
    finally:
        fe.stop()


def port_cli(files, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "lrcn_tpu_torch", "--device", "cpu",
         *serve_args(files, "--native-frontend", "--host", "127.0.0.1",
                     "--port", "0")],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_cli_serves_through_the_native_frontend(files, service):
    """``lrcn-torch serve --native-frontend``: it prints its port, answers
    by id as the service does, and drains and exits 0 on SIGTERM."""
    proc = port_cli(files)
    try:
        port = None
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "native frontend on http://" in line:
                port = int(line.split("http://127.0.0.1:")[1].split()[0])
                break
        assert port, "".join(lines) + proc.stderr.read()
        assert request(port, "POST", "/v1/caption", {"id": 7}) == (
            200, {"captions": service.caption_ids([7])})
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "serve: draining and shutting down" in out


def test_cli_refuses_without_the_native_library(files):
    """Without the library (``LRCN_NATIVE=0``) the command exits nonzero
    with the reason, and never serves through the Python front end."""
    proc = port_cli(files, {"LRCN_NATIVE": "0"})
    out, err = proc.communicate(timeout=120)
    assert proc.returncode != 0
    assert "httpserve library unavailable" in err
    assert "listening" not in out and "native frontend on" not in out
