"""The port's C++ front end (``lrcn_tpu_torch/serve/native_http.py``)
against the JAX package's (``lrcn_tpu/serve/native_http.py``), on the CPU
in f32: two ``NativeFrontend``s on ``127.0.0.1:0``, over services that each
CLI's ``make_caption_service`` builds from the same JAX-written joint
checkpoint and raw feature store (``tests/test_torch_http.py``'s files),
give equal captions for ids (1..``MAX_DECODE_GROUPS`` groups), raw
unnormalized features, mixed bursts, images and a features-only service,
and the same statuses and bodies for the error surface.  The pump
outlives failed batches as JAX's does, and three of JAX's pump faults are
repaired: no issue after ``stop()``, an image batch waiting at ``stop()``
answered at once, an id failure that leaves banked feature rows served.
``tests/test_torch_native_http_load.py`` holds the load-side tests."""

import base64
import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from lrcn_tpu import cli as jax_cli
from lrcn_tpu.native import httpserve_library as jax_httpserve_library
from lrcn_tpu.serve.native_http import NativeFrontend as JaxNativeFrontend
from lrcn_tpu_torch import cli
from lrcn_tpu_torch.native import httpserve_library
from lrcn_tpu_torch.serve import native_frontend
from lrcn_tpu_torch.serve.native_http import NativeFrontend
from test_torch_http import IDS, _serve_args, files  # noqa: F401

GROUPS = 3          # --max-burst-groups: bursts of 1..3 batches of 4 rows


def request(port, method, path, body=None, timeout=60):
    """(status, JSON reply) of one request on a connection of its own."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = (body if isinstance(body, (bytes, type(None)))
                else json.dumps(body))
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def raw_status_line(port, raw: bytes) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(raw)
        s.settimeout(10)
        out = b""
        while b"\r\n" not in out:
            chunk = s.recv(4096)
            if not chunk:
                break
            out += chunk
        return out.split(b"\r\n")[0]
    finally:
        s.close()


def make_services(files, *extra, store=True):
    """The port's and the JAX package's services over the same files."""
    def args(module, top):
        parsed = _serve_args(module.build_parser(), top, files,
                             "--max-burst-groups", str(GROUPS), *extra)
        if not store:
            parsed.features = None
        return parsed

    return {"port": cli.make_caption_service(args(cli, ["--device",
                                                        "cpu"])),
            "jax": jax_cli.make_caption_service(args(jax_cli, ["--platform",
                                                               "cpu"]))}


FRONTENDS = {"port": NativeFrontend, "jax": JaxNativeFrontend}


class Pair:
    """A port and a JAX ``NativeFrontend``, over a service each."""

    def __init__(self, services, **kwargs):
        self.services = services
        kwargs = {"host": "127.0.0.1", "port": 0, "n_threads": 48,
                  "wait_ms": 2, **kwargs}
        self.fronts = {name: FRONTENDS[name](svc, **kwargs)
                       for name, svc in services.items()}

    def request(self, name, method, path, body=None):
        return request(self.fronts[name].port, method, path, body)

    def both(self, method, path, body=None):
        return {name: self.request(name, method, path, body)
                for name in self.fronts}

    def stop(self):
        for front in self.fronts.values():
            front.stop()


@pytest.fixture(scope="module")
def services(files):  # noqa: F811
    svcs = make_services(files)
    yield svcs
    for svc in svcs.values():
        svc.close()


@pytest.fixture(scope="module")
def pair(services):
    p = Pair(services)
    yield p
    p.stop()


def test_health_and_stats_match_jax(pair):
    out = pair.both("GET", "/healthz")
    assert out["port"] == out["jax"] == (200, {"ok": True, "ready": True,
                                               "frontend": "native"})
    stats = pair.both("GET", "/stats")
    assert stats["port"][0] == stats["jax"][0] == 200
    assert set(stats["port"][1]) == set(stats["jax"][1])
    assert stats["port"][1]["frontend"] == "native"


@pytest.mark.parametrize("n", [1, 3, 4, 7, 12])
def test_id_captions_match_jax(pair, n):
    """One id, and bursts of 1 to GROUPS batches of 4 rows."""
    body = {"id": IDS[0]} if n == 1 else {"ids": IDS[:n]}
    out = pair.both("POST", "/v1/caption", body)
    assert out["port"] == out["jax"]
    assert out["port"] == (200, {"captions": pair.services[
        "port"].caption_ids(IDS[:n])})


def test_raw_feature_captions_match_jax(pair, files):  # noqa: F811
    """Raw, unnormalized rows at several scales: the pump normalizes them
    as JAX's does (``_decode_feats_grouped``'s default), so the captions
    are ``caption_features``'; decoding them unnormalized gives other
    captions, so this test sees a missing normalization."""
    svc = pair.services["port"]
    scales = np.array([1.0, 3.7, 0.2, 11.0, 1.5, 6.0], np.float32)
    rows = np.stack([files["feats"][i] for i in IDS[:6]]) * scales[:, None]
    out = pair.both("POST", "/v1/caption", {"features": rows.tolist()})
    assert out["port"] == out["jax"]
    want = svc.caption_features(list(rows))
    assert out["port"] == (200, {"captions": want})
    unnormalized = svc._decode_finalize(svc._decode_feats_grouped(
        rows, normalized=True))
    assert unnormalized != want


def test_mixed_burst_matches_jax(pair, files):  # noqa: F811
    """Id and feature requests that arrive together split into a grouped
    id search and a grouped feature search; every answer is JAX's."""
    bodies = ([{"id": i} for i in IDS[10:13]]
              + [{"features": [(files["feats"][i] * 2.5).tolist()]}
                 for i in IDS[20:23]])
    results = {}

    def client(name, k, body, barrier):
        barrier.wait(timeout=30)
        results[name, k] = pair.request(name, "POST", "/v1/caption", body)

    for name in ("port", "jax"):
        barrier = threading.Barrier(len(bodies))
        threads = [threading.Thread(target=client,
                                    args=(name, k, body, barrier))
                   for k, body in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    for k in range(len(bodies)):
        assert results["port", k][0] == 200
        assert results["port", k] == results["jax", k], k


@pytest.mark.parametrize("body", ["images_b64", "image_b64"])
def test_image_captions_match_jax(pair, files, body):  # noqa: F811
    """A PNG and a JPEG through the C++ base64 decode, the image thread's
    ``load_blobs`` and the encode stage: JAX's captions and
    ``caption_image_bytes``'."""
    blobs = files["blobs"] if body == "images_b64" else files["blobs"][1:]
    payload = ({"images_b64": blobs} if body == "images_b64"
               else {"image_b64": blobs[0]})
    out = pair.both("POST", "/v1/caption", payload)
    assert out["port"] == out["jax"]
    want = pair.services["port"].caption_image_bytes(
        [base64.b64decode(b) for b in blobs])
    assert out["port"] == (200, {"captions": want})


def test_features_only_service_matches_jax(files):  # noqa: F811
    """No store: feature requests serve, id requests get 400, in both."""
    svcs = make_services(files, store=False)
    p = Pair(svcs)
    try:
        row = (files["feats"][IDS[3]] * 4.0).tolist()
        out = p.both("POST", "/v1/caption", {"features": [row]})
        assert out["port"] == out["jax"]
        assert out["port"] == (200, {"captions": svcs["port"].caption_features(
            [np.asarray(row, np.float32)])})
        out = p.both("POST", "/v1/caption", {"id": IDS[3]})
        assert out["port"] == out["jax"]
        assert out["port"][0] == 400 and "feature store" in out["port"][1][
            "error"]
    finally:
        p.stop()
        for svc in svcs.values():
            svc.close()


ERROR_CASES = {
    "bad json": (b"{not json", 400),
    "unknown field": ({"wrong": 1}, 400),
    "unknown id": ({"id": 999999}, 400),
    "huge id": (b'{"id": 99999999999999999999999}', 400),
    "wrong feature width": ({"features": [[0.5] * 5]}, 400),
    "flat features": ({"features": [0.1] * 16}, 400),
    "no features": ({"features": []}, 400),
    "bad image": ({"image_b64": base64.b64encode(b"not an image").decode()},
                  400),
    "bad base64": ({"image_b64": "!!!not-base64!!!"}, 400),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_bodies_match_jax(pair, case):
    body, status = ERROR_CASES[case]
    out = pair.both("POST", "/v1/caption", body)
    assert out["port"] == out["jax"]
    assert out["port"][0] == status and "error" in out["port"][1]


@pytest.mark.parametrize("method, path", [("GET", "/nope"),
                                          ("POST", "/v1/nope")])
def test_unknown_route_matches_jax(pair, method, path):
    out = pair.both(method, path, {"id": IDS[0]} if method == "POST"
                    else None)
    assert out["port"] == out["jax"] == (404, {"error": "no route"})


@pytest.mark.parametrize("raw, status", [
    (b'{"id": -}', b"400"), (None, b"400"), (b"chunked", b"501")])
def test_malformed_http_matches_jax(pair, raw, status):
    """A bare-sign id, a garbage Content-Length and a chunked body."""
    head = b"POST /v1/caption HTTP/1.1\r\nHost: x\r\n"
    if raw is None:
        msg = head + b"Content-Length: abc\r\n\r\n"
    elif raw == b"chunked":
        msg = (head + b"Transfer-Encoding: chunked\r\n\r\n"
               b"9\r\n{\"id\": 5}\r\n0\r\n\r\n")
    else:
        msg = head + b"Content-Length: %d\r\n\r\n" % len(raw) + raw
    lines = {name: raw_status_line(front.port, msg)
             for name, front in pair.fronts.items()}
    assert lines["port"] == lines["jax"]
    assert status in lines["port"]
    assert pair.both("GET", "/healthz")["port"][0] == 200


def test_503_before_ready(services, monkeypatch):
    """Until ``lrcn_serve_ready`` (the constructor's last call) a caption
    request gets 503 "warming up", in both packages."""
    seen = {}
    for name, lib in (("port", httpserve_library()),
                      ("jax", jax_httpserve_library())):
        real = lib.lrcn_serve_ready

        def ready(h, lib=lib, real=real, name=name):
            seen[name] = request(lib.lrcn_serve_port(h), "POST",
                                 "/v1/caption", {"id": IDS[0]})
            real(h)

        monkeypatch.setattr(lib, "lrcn_serve_ready", ready)
    p = Pair(services)
    try:
        assert seen["port"] == seen["jax"] == (503, {"error": "warming up"})
        out = p.both("POST", "/v1/caption", {"id": IDS[0]})
        assert out["port"] == out["jax"] and out["port"][0] == 200
    finally:
        p.stop()


def test_503_past_max_queue(services):
    p = Pair(services, max_queue=1)
    try:
        out = p.both("POST", "/v1/caption", {"ids": IDS[:2]})
        assert out["port"] == out["jax"] == (503, {"error": "queue full"})
        out = p.both("POST", "/v1/caption", {"id": IDS[0]})
        assert out["port"] == out["jax"] and out["port"][0] == 200
    finally:
        p.stop()


def test_504_on_the_request_timeout(services, monkeypatch):
    """A search slower than ``request_timeout_s`` gives 504 in both."""
    for svc in services.values():
        real = svc._decode_rows_grouped

        def slow(rows, real=real):
            time.sleep(1.2)
            return real(rows)

        monkeypatch.setattr(svc, "_decode_rows_grouped", slow)
        monkeypatch.setattr(svc, "request_timeout_s", 0.4)
    p = Pair(services)
    try:
        out = p.both("POST", "/v1/caption", {"id": IDS[0]})
        assert out["port"] == out["jax"]
        assert out["port"][0] == 504
    finally:
        p.stop()


def test_pump_survives_a_decode_failure(pair, monkeypatch):
    """A failing search 500s its requests at once; the next one serves."""
    for svc in pair.services.values():
        real = svc._decode_rows_grouped
        calls = []

        def failing(rows, real=real, calls=calls):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected device failure")
            return real(rows)

        monkeypatch.setattr(svc, "_decode_rows_grouped", failing)
    out = pair.both("POST", "/v1/caption", {"id": IDS[1]})
    assert out["port"] == out["jax"] == (500, {"error": "decode failed"})
    out = pair.both("POST", "/v1/caption", {"id": IDS[1]})
    assert out["port"] == out["jax"] and out["port"][0] == 200


def test_finalize_failure_fails_fast(pair, monkeypatch):
    """A batch whose respond raises gets its 500 at once, not a 504 at the
    request timeout; the responder keeps serving."""
    for front in pair.fronts.values():
        real = front._respond_raw
        calls = []

        def failing(preqs, pslots, raw, real=real, calls=calls):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("injected finalize failure")
            return real(preqs, pslots, raw)

        monkeypatch.setattr(front, "_respond_raw", failing)
    for name in ("port", "jax"):
        t0 = time.monotonic()
        assert pair.request(name, "POST", "/v1/caption", {"id": IDS[2]}) \
            == (500, {"error": "decode failed"})
        assert time.monotonic() - t0 < 5.0
        assert pair.request(name, "POST", "/v1/caption",
                            {"id": IDS[2]})[0] == 200


# --- the three repairs of JAX's pump (the port's front end alone) ---


def post_in_thread(port, body, results, key):
    def run():
        t0 = time.monotonic()
        results[key] = (*request(port, "POST", "/v1/caption", body),
                        time.monotonic() - t0)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def wait_until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.01)


def test_nothing_is_issued_after_stop(services, monkeypatch):
    """With the in-flight budget full (the responder held), a request
    waits in the C++ queue while the pump waits at its gate; ``stop()``
    then ends the pump without pulling or issuing it (the JAX pump pulls
    and issues one more batch), and the queued request gets 503."""
    svc = services["port"]
    front = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=16,
                           wait_ms=2)
    hold = threading.Event()
    real_respond = front._respond_raw
    monkeypatch.setattr(front, "_respond_raw", lambda *a: (
        hold.wait(30), real_respond(*a)))
    issued = []
    real_issue = svc._decode_rows_grouped
    monkeypatch.setattr(svc, "_decode_rows_grouped", lambda rows: (
        issued.append(time.monotonic()), real_issue(rows))[1])
    results = {}
    try:
        threads = []
        for k, i in enumerate(IDS[:2]):             # both budget slots
            threads.append(post_in_thread(front.port, {"id": i}, results,
                                          i))
            wait_until(lambda k=k: len(issued) == k + 1)
        threads.append(post_in_thread(front.port, {"id": IDS[2]}, results,
                                      IDS[2]))
        wait_until(lambda: request(front.port, "GET", "/stats")[1][
            "queue"] == 1)
        stopper = threading.Thread(target=front.stop)
        stopped_at = time.monotonic()
        stopper.start()
        wait_until(lambda: not front._pump.is_alive())
        hold.set()
        stopper.join(timeout=30)
        for t in threads:
            t.join(timeout=30)
    finally:
        hold.set()
        if front._pump.is_alive() or front._responder.is_alive():
            front.stop()
    assert len(issued) == 2 and max(issued) < stopped_at
    assert [results[i][0] for i in IDS[:2]] == [200, 200]
    assert results[IDS[2]][:2] == (503, {"error": "shutting down"})


def test_image_batch_waiting_at_stop_gets_503(services, files,  # noqa: F811
                                              monkeypatch):
    """Both image dispatch slots held, a third image batch waits for one;
    ``stop()`` answers it 503 at once (the JAX image thread drops it, and
    its client waits out the request timeout, 60 s here)."""
    svc = services["port"]
    front = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=16,
                           wait_ms=2)
    hold = threading.Event()
    entered = []
    real = svc.caption_images

    def held(images):
        entered.append(1)
        hold.wait(30)
        return real(images)

    monkeypatch.setattr(svc, "caption_images", held)
    from lrcn_tpu_torch.data import images as image_io

    decoded = []
    real_load = image_io.load_blobs
    monkeypatch.setattr(image_io, "load_blobs", lambda blobs: (
        decoded.append(len(blobs)), real_load(blobs))[1])
    results, threads = {}, []
    body = {"image_b64": files["blobs"][1]}
    try:
        for k in range(2):
            threads.append(post_in_thread(front.port, body, results, k))
            wait_until(lambda k=k: len(entered) == k + 1)
        threads.append(post_in_thread(front.port, body, results, 2))
        wait_until(lambda: len(decoded) == 3)   # now waiting for a slot
        stopper = threading.Thread(target=front.stop)
        stopper.start()
        threads[2].join(timeout=10)
        assert 2 in results, "the waiting image batch was not answered"
        hold.set()
        stopper.join(timeout=30)
        for t in threads:
            t.join(timeout=30)
    finally:
        hold.set()
        if front._img_thread.is_alive():
            front.stop()
    assert results[2][:2] == (503, {"error": "shutting down"})
    assert results[2][2] < 5.0 < svc.request_timeout_s
    assert [results[k][0] for k in range(2)] == [200, 200]


def test_id_failure_keeps_banked_features(services, files,  # noqa: F811
                                          monkeypatch):
    """Feature rows banked while an id search is in flight stay banked
    when the next id issue fails: the id request gets 500, the feature
    request 200 with JAX's captions (the JAX pump fails both)."""
    svc = services["port"]
    front = NativeFrontend(svc, host="127.0.0.1", port=0, n_threads=16,
                           wait_ms=2, feat_wait_ms=60_000)
    hold = threading.Event()
    responding = []
    real_respond = front._respond_raw

    def held_respond(*a):
        responding.append(1)
        if len(responding) == 1:
            hold.wait(30)
        return real_respond(*a)

    monkeypatch.setattr(front, "_respond_raw", held_respond)
    calls = []
    real_issue = svc._decode_rows_grouped

    def issue(rows):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected id-leg failure")
        return real_issue(rows)

    monkeypatch.setattr(svc, "_decode_rows_grouped", issue)
    rows = [(files["feats"][i] * 3.0).tolist() for i in IDS[30:33]]
    results = {}
    try:
        first = post_in_thread(front.port, {"id": IDS[0]}, results, "held")
        wait_until(lambda: responding)          # one id search in flight
        feat = post_in_thread(front.port, {"features": rows}, results,
                              "features")
        wait_until(lambda: request(front.port, "GET", "/stats")[1][
            "feat_items"] == 3 and request(front.port, "GET", "/stats")[1][
                "queue"] == 0)
        # the pump banks what it pulled before it pulls again
        failed = post_in_thread(front.port, {"id": IDS[1]}, results, "id")
        failed.join(timeout=30)
        assert "features" not in results        # still banked
        hold.set()
        for t in (first, feat):
            t.join(timeout=30)
    finally:
        hold.set()
        front.stop()
    assert results["id"][:2] == (500, {"error": "decode failed"})
    assert results["held"][0] == 200
    want = services["jax"].caption_features(
        [np.asarray(r, np.float32) for r in rows])
    assert results["features"][:2] == (200, {"captions": want})


def test_native_frontend_refuses_without_the_library(services, monkeypatch):
    """``LRCN_NATIVE=0`` (or no g++): the constructor raises; there is no
    Python stand-in for the C++ front end."""
    import lrcn_tpu_torch.serve.native_http as native_http

    monkeypatch.setattr(native_http, "httpserve_library", lambda: None)
    with pytest.raises(RuntimeError, match="httpserve library unavailable"):
        native_frontend(services["port"], host="127.0.0.1", port=0)
