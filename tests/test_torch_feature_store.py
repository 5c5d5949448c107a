"""The port's ``FeatureStore`` and ``device_table``, on the CPU.

- The store keeps its appended rows in one array that grows
  geometrically: ``add``, ``get``, ``rows``, ``gather``, ``table`` and a
  save and load agree across several growths.
- ``table()`` is a read-only view (``table_copies`` stays 0) of an
  appended-only store and of a loaded one; a store holding both copies
  once a call and counts it; a view taken before more ``add`` calls keeps
  its rows.
- The two packages read each other's stores.
- ``device_table`` gives the table that the host path gave before it
  (``store.table()`` in float32, L1 normalization, the host's cast, the
  upload) bit for bit; ``generate_captions`` and ``CaptionService``
  built on it return the lines and hold the table they did.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lrcn_tpu.data.feature_store import FeatureStore as JaxStore
from lrcn_tpu_torch.config import LRCNConfig
from lrcn_tpu_torch.core.vocab import Vocab
from lrcn_tpu_torch.data import feature_store
from lrcn_tpu_torch.data.feature_store import (
    FeatureStore,
    device_table,
    l1_normalize,
)
from lrcn_tpu_torch.decode import writer
from lrcn_tpu_torch.decode.writer import generate_captions
from lrcn_tpu_torch.models.lrcn import init_params
from lrcn_tpu_torch.serve.service import CaptionService

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DIM = 6
KINDS = ["added", "mmap", "in_memory", "mixed"]


def _rows(n: int, seed: int = 0, dim: int = DIM) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (n, dim)).astype(np.float32)


def _ids(n: int, first: int = 1000) -> list[int]:
    return [first + 7 * i for i in range(n)]


def _added(n: int, seed: int = 0, first: int = 1000,
           dim: int = DIM) -> FeatureStore:
    store = FeatureStore(dim=dim)
    for image_id, row in zip(_ids(n, first), _rows(n, seed, dim)):
        store.add(image_id, row)
    return store


def _store(kind: str, path, n: int = 40, dim: int = DIM) -> FeatureStore:
    """``n`` rows: appended, loaded (mapped or read whole), or the first
    ``n // 2`` loaded and the rest appended."""
    if kind == "added":
        return _added(n, dim=dim)
    loaded = n // 2 if kind == "mixed" else n
    _added(loaded, dim=dim).save(str(path))
    store = FeatureStore.load(str(path), mmap=kind != "in_memory")
    for image_id, row in zip(_ids(n)[loaded:], _rows(n, dim=dim)[loaded:]):
        store.add(image_id, row)
    return store


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}[t.dtype])


def _host_path_table(store: FeatureStore, device, dtype,
                     normalize: bool = False) -> torch.Tensor:
    """The table as the callers built it before ``device_table``: the
    host's float32 table, L1-normalized when asked, cast on the host,
    then uploaded."""
    host = np.asarray(store.table(), np.float32)
    if normalize:
        host = l1_normalize(host)
    return torch.tensor(host).to(dtype).to(device)


# --- the store ---


# 64 rows before the first growth, then 128, 256, 512
@pytest.mark.parametrize("n", [0, 1, 64, 65, 129, 300])
def test_store_agrees_with_its_rows_across_growths(tmp_path, n):
    rows, ids = _rows(n), _ids(n)
    store = _added(n)
    store.save(str(tmp_path))
    pick = ids[::-3] + ids[:2]
    for found in (store, FeatureStore.load(str(tmp_path)),
                  FeatureStore.load(str(tmp_path), mmap=False)):
        assert len(found) == n and found.ids() == ids
        np.testing.assert_array_equal(found.table(), rows)
        np.testing.assert_array_equal(found.rows(ids), np.arange(n))
        for image_id, row in zip(ids, rows):
            np.testing.assert_array_equal(found.get(image_id), row)
        np.testing.assert_array_equal(
            found.gather(pick), rows[[ids.index(i) for i in pick]]
            .reshape(-1, DIM))
        assert found.table_copies == 0


@pytest.mark.parametrize("kind", ["added", "mmap", "in_memory"])
def test_table_is_a_read_only_view(tmp_path, kind):
    store = _store(kind, tmp_path)
    table = store.table()
    assert np.shares_memory(table, store.table())
    assert np.shares_memory(table, store._parts()[0])
    assert store.table_copies == 0
    for view in (table, store.get(_ids(1)[0])):
        assert not view.flags.writeable
        with pytest.raises(ValueError):
            view[0] = 1.0
    mutated = table.copy()
    mutated += 1.0
    np.testing.assert_array_equal(store.table(), _rows(40))


def test_mixed_store_copies_once_a_call(tmp_path):
    store = _store("mixed", tmp_path)
    rows, ids = _rows(40), _ids(40)
    tables = [store.table() for _ in range(3)]
    assert store.table_copies == 3
    assert not np.shares_memory(tables[0], tables[1])
    for table in tables:
        np.testing.assert_array_equal(table, rows)
    pick = [ids[30], ids[2], ids[19], ids[20], ids[39]]
    np.testing.assert_array_equal(store.gather(pick),
                                  rows[[30, 2, 19, 20, 39]])
    np.testing.assert_array_equal(store.get(ids[25]), rows[25])
    assert store.table_copies == 3


# room reserved for every later row: the adds write past the view;
# none: they move the rows to larger arrays
@pytest.mark.parametrize("reserve", [0, 1000])
def test_view_keeps_its_rows_through_later_adds(reserve):
    store = FeatureStore(dim=DIM)
    store.reserve(reserve)
    rows = _rows(600)
    ids = _ids(600)
    for image_id, row in zip(ids[:60], rows[:60]):
        store.add(image_id, row)
    table, first = store.table(), store.get(ids[0])
    for image_id, row in zip(ids[60:], rows[60:] + 5.0):
        store.add(image_id, row)
    np.testing.assert_array_equal(table, rows[:60])
    np.testing.assert_array_equal(first, rows[0])
    np.testing.assert_array_equal(store.table()[:60], rows[:60])
    np.testing.assert_array_equal(store.table()[60:], rows[60:] + 5.0)


def test_add_refuses_a_wrong_width_or_a_known_id():
    store = _added(3)
    with pytest.raises(ValueError):
        store.add(1, np.zeros(DIM + 1, np.float32))
    with pytest.raises(KeyError):
        store.add(_ids(1)[0], np.zeros(DIM, np.float32))
    assert len(store) == 3
    np.testing.assert_array_equal(store.table(), _rows(3))


@pytest.mark.parametrize("kind", KINDS)
def test_port_store_loads_in_jax_package(tmp_path, kind):
    store = _store(kind, tmp_path / "src")
    store.save(str(tmp_path / "port"))
    jax_store = JaxStore.load(str(tmp_path / "port"))
    assert jax_store.ids() == store.ids() == _ids(40)
    np.testing.assert_array_equal(jax_store.table(), _rows(40))
    assert jax_store.normalized == store.normalized


def test_jax_store_loads_in_port(tmp_path):
    jax_store = JaxStore(dim=DIM, normalized=True)
    for image_id, row in zip(_ids(70), _rows(70)):
        jax_store.add(image_id, row)
    jax_store.save(str(tmp_path / "jax"))
    store = FeatureStore.load(str(tmp_path / "jax"))
    assert store.normalized and store.ids() == _ids(70)
    np.testing.assert_array_equal(store.table(), _rows(70))
    store.add(5, np.ones(DIM, np.float32))
    store.save(str(tmp_path / "back"))
    back = JaxStore.load(str(tmp_path / "back"))
    np.testing.assert_array_equal(back.get(5), np.ones(DIM, np.float32))
    np.testing.assert_array_equal(back.table()[:70], _rows(70))


# --- the device table ---


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_device_table_is_the_host_paths_table(tmp_path, monkeypatch, kind,
                                              normalize, dtype):
    # blocks of 7 rows: several a part, a short last one
    monkeypatch.setattr(feature_store, "STAGE_BYTES", 7 * 4 * DIM)
    store = _store(kind, tmp_path)
    got = device_table(store, CPU, dtype, normalize=normalize)
    want = _host_path_table(store, CPU, dtype, normalize)
    assert got.dtype == dtype and got.shape == (40, DIM)
    assert torch.equal(_bits(got), _bits(want))
    if dtype == torch.float32:
        assert not np.shares_memory(got.numpy(), store.table())


def test_device_table_of_an_empty_store():
    got = device_table(FeatureStore(dim=DIM), CPU, torch.bfloat16)
    assert got.shape == (0, DIM) and got.dtype == torch.bfloat16


def test_device_table_warns_of_no_read_only_array(tmp_path):
    """``torch.from_numpy`` warns once a process on a read-only array, so
    a fresh interpreter, with warnings as errors, builds the table of an
    appended, a mapped and a mixed store."""
    code = f"""
import warnings
warnings.simplefilter("error")
import numpy as np, torch
from lrcn_tpu_torch.data.feature_store import FeatureStore, device_table
store = FeatureStore(dim=4)
for i in range(100):
    store.add(i, np.full(4, i + 1.0))
store.save({str(tmp_path)!r})
loaded = FeatureStore.load({str(tmp_path)!r})
mixed = FeatureStore.load({str(tmp_path)!r})
mixed.add(-1, np.ones(4))
for s in (store, loaded, mixed):
    device_table(s, "cpu", torch.bfloat16)
    device_table(s, "cpu", torch.float32, normalize=True)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr


def _decoder_and_vocab(dim: int):
    cfg = LRCNConfig(hidden=(16, 12), embed=8, cnn_feature_dim=dim,
                     vocab_size=25)
    params = init_params(cfg, torch.Generator().manual_seed(3))
    vocab = Vocab([f"w{i}" for i in range(cfg.vocab_size - 3)])
    return cfg, params.decoder(torch.bfloat16), vocab


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("kind", ["added", "mixed"])
def test_generate_captions_lines_unchanged(tmp_path, monkeypatch, kind,
                                           normalized):
    """The lines of the resident table built by ``device_table`` and by
    the host path, and of the gathered rows, are the same."""
    _, decoder, vocab = _decoder_and_vocab(10)
    store = _store(kind, tmp_path, n=12, dim=10)
    store.normalized = normalized

    def run(resident):
        return generate_captions(decoder, vocab, store, store.ids(),
                                 device=CPU, beam_width=2, max_words=5,
                                 batch_size=2, scan_depth=2,
                                 resident_store=resident)

    resident, gathered = run(True), run(False)
    monkeypatch.setattr(
        writer, "device_table",
        lambda store, device, dtype, normalize: _host_path_table(
            store, device, dtype, normalize))
    assert resident == gathered == run(True)
    assert len(resident) == 12


@pytest.mark.parametrize("normalized", [True, False])
def test_service_holds_the_host_paths_table(tmp_path, normalized):
    cfg, decoder, vocab = _decoder_and_vocab(DIM)
    store = _store("mixed", tmp_path)
    store.normalized = normalized
    service = CaptionService(cfg, decoder, vocab, device=CPU, store=store,
                             beam_width=2, max_words=5, decode_batch=4)
    try:
        want = _host_path_table(store, CPU, torch.bfloat16,
                                normalize=not normalized)
        assert service._table.dtype == torch.bfloat16
        assert torch.equal(_bits(service._table), _bits(want))
    finally:
        service.close()
