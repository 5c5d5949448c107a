"""The port's examples (``lrcn_tpu_torch/examples/``) against the JAX
package's (``examples/``), on the CPU: the end-to-end example writes the
JAX example's files and passes the same BLEU-4 gate through
``lrcn-torch``; the quickstart's service, given the JAX example's
parameters, answers every id with the JAX example's caption (f32, exact
tokens); both front ends report the same /healthz and /stats keys; and
neither example runs without a card unless asked for the CPU."""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lrcn_tpu_torch.data.feature_store import FeatureStore
from lrcn_tpu_torch.evaluation.bleu import BleuResult
from lrcn_tpu_torch.examples import serving_quickstart as quick
from lrcn_tpu_torch.examples import synthetic_end_to_end as e2e

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name: str):
    """A module of the repository's ``examples/`` (not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_module(module: str, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


# --- the end-to-end example ---


def test_e2e_dataset_is_the_jax_examples(tmp_path):
    """The same jsons, byte for byte, and the same one-hot stores."""
    for name in ("jax", "port"):
        os.makedirs(tmp_path / name)
    jax_paths = _jax_example("synthetic_end_to_end").build_dataset(
        str(tmp_path / "jax"))
    port_paths = e2e.build_dataset(str(tmp_path / "port"))
    for jax_path, port_path in zip(jax_paths, port_paths):
        if jax_path.endswith(".json"):
            with open(jax_path, "rb") as f, open(port_path, "rb") as g:
                assert f.read() == g.read()
        else:
            jax_store, port_store = (FeatureStore.load(p)
                                     for p in (jax_path, port_path))
            assert port_store.ids() == jax_store.ids()
            assert port_store.normalized and jax_store.normalized
            np.testing.assert_array_equal(port_store.table(),
                                          jax_store.table())


def test_e2e_example_passes_its_gate_on_the_cpu(tmp_path):
    """``python -m ...synthetic_end_to_end --device cpu``: train, generate
    and eval through ``lrcn-torch``, BLEU-4 >= 0.90, exit 0."""
    proc = _run_module("lrcn_tpu_torch.examples.synthetic_end_to_end",
                       "--device", "cpu", str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "== quality gate PASSED (BLEU-4 >= 0.9)" in proc.stdout
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.strip().startswith("BLEU = "))
    b4 = float(line.split("/")[3].split()[0])
    assert b4 >= 90.0, line
    with open(tmp_path / "candidates.txt") as f:
        assert len(f.read().splitlines()) == 24


def test_e2e_gate_failure_raises(tmp_path, monkeypatch):
    """A score under the gate is an error, not a printed line."""
    monkeypatch.setattr(e2e, "train", lambda *a: "ckpt")
    monkeypatch.setattr(e2e, "generate", lambda *a: (
        str(tmp_path / "c.txt"), str(tmp_path / "i.txt")))
    open(tmp_path / "c.txt", "w").close()
    monkeypatch.setattr(e2e, "score", lambda *a: BleuResult(
        (0.9, 0.9, 0.9, 0.89), 1.0, 1.0, 10, 10))
    with pytest.raises(RuntimeError, match="BLEU-4 0.890 < 0.9"):
        e2e.main(str(tmp_path), device="cpu")


# --- the serving quickstart ---


@pytest.fixture(scope="module")
def jax_quickstart():
    """Run the JAX example's ``main`` once, recording its service's
    parameters, its captions of every id and its /stats before it
    closes, and what it printed."""
    import contextlib
    import io

    jax_quick = _jax_example("serving_quickstart")
    seen = {}

    class Recording(jax_quick.CaptionService):
        def __init__(self, cfg, params, vocab, **kwargs):
            seen.update(cfg=cfg, params=params, kwargs=kwargs)
            super().__init__(cfg, params, vocab, **kwargs)

        def close(self):
            seen["captions"] = self.caption_ids(list(range(quick.N_IDS)))
            seen["stats"] = self.stats()
            super().close()

    jax_quick.CaptionService = Recording
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_quick.main()
    seen["printed"] = out.getvalue()
    return seen


def test_quickstart_captions_equal_the_jax_examples(jax_quickstart):
    """The port's service on the JAX example's parameters (carried by
    ``params_from_numpy``) answers ids 0..19 with the JAX example's
    captions: f32, exact tokens."""
    import jax

    cfg = quick.CONFIG
    assert (dataclasses.asdict(jax_quickstart["cfg"])
            == dataclasses.asdict(cfg))
    assert jax_quickstart["kwargs"]["compute_dtype"] == np.float32
    tree = jax.tree.map(np.asarray, jax_quickstart["params"])
    service = quick.build_service(cfg, params=tree, device="cpu")
    try:
        assert service.decoder.compute_dtype == torch.float32
        for key in ("beam_width", "max_words", "decode_batch"):
            assert getattr(service, key) == jax_quickstart["kwargs"][key]
        got = service.caption_ids(list(range(quick.N_IDS)))
    finally:
        service.close()
    assert got == jax_quickstart["captions"]
    assert len(set(got)) > 1


def test_quickstart_main_serves_like_the_jax_example(jax_quickstart,
                                                     capsys):
    """``main(device="cpu")`` answers 16 concurrent requests; /healthz is
    the JAX front end's reply and /stats has its keys."""
    import ast

    out = quick.main(device="cpu")
    printed = capsys.readouterr().out
    assert sorted(out["captions"]) == list(range(quick.N_REQUESTS))
    assert all(c.endswith(" .") for c in out["captions"].values())
    jax_health = ast.literal_eval(next(
        ln for ln in jax_quickstart["printed"].splitlines()
        if ln.startswith("healthz: ")).split(": ", 1)[1])
    assert out["healthz"] == jax_health == {"ok": True, "platform": "cpu"}
    jax_stats = jax_quickstart["stats"]
    assert set(out["stats"]) == set(jax_stats) == {"decode", "decode_ids"}
    for stage, snapshot in out["stats"].items():
        assert set(snapshot) == set(jax_stats[stage]), stage
    assert out["stats"]["decode_ids"]["errors"] == 0
    for label in ("serving on 127.0.0.1:", "healthz: ",
                  f"{quick.N_REQUESTS} concurrent captions, e.g.:",
                  "stats: {"):
        assert label in printed and label in jax_quickstart["printed"]
    stats = json.loads(printed.split("stats: ", 1)[1])
    assert set(stats) == set(jax_stats)


def test_quickstart_command_line_on_the_cpu():
    proc = _run_module("lrcn_tpu_torch.examples.serving_quickstart",
                       "--device", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert f"{quick.N_REQUESTS} concurrent captions, e.g.:" in proc.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a CUDA device is present: the default runs")
@pytest.mark.parametrize("run", [
    lambda tmp: e2e.main(str(tmp)),
    lambda tmp: quick.main(),
    lambda tmp: quick.build_service(quick.CONFIG),
], ids=["e2e", "quickstart", "build_service"])
def test_examples_default_to_the_card(run, tmp_path):
    """Without ``device="cpu"`` each example asks for the card and,
    without one, raises ``require_cuda``'s error: no CPU fallback."""
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        run(tmp_path)
    assert not os.listdir(tmp_path)
