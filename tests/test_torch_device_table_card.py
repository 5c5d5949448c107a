"""``device_table`` on the CUDA card: the card's cast of a 5,000 x 4,096
feature table (the benchmark's generate split) against the host's cast,
bit for bit, with the upload's pinned blocks crossing the border of a
store's loaded and appended rows.

Needs the card and skips without one.  This file imports nothing of
JAX, so the card's machine runs it without ``tests/conftest.py``:

    python -m pytest --noconftest -m card tests/test_torch_device_table_card.py
"""

import numpy as np
import pytest
import torch

from lrcn_tpu_torch.data.feature_store import (
    FeatureStore,
    device_table,
    l1_normalize,
)

N, DIM = 5000, 4096


def _rows() -> np.ndarray:
    rng = np.random.default_rng(21)
    rows = rng.standard_normal((N, DIM)).astype(np.float32)
    # 16 rows of raw bit patterns under 2 in magnitude (so that no row's
    # sum overflows): subnormals, and in 4 rows ties at bf16's rounding bit
    bits = rng.integers(0, 2**32, (16, DIM), dtype=np.uint64).astype(
        np.uint32) & 0xBFFFFFFF
    bits[:4] = (bits[:4] & 0xFFFF0000) | 0x8000
    rows[:16] = bits.view(np.float32)
    return rows


@pytest.mark.card
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("loaded", [0, 2500])
def test_card_cast_is_the_host_cast(tmp_path, loaded, normalize):
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card")
    rows = _rows()
    if loaded:
        first = FeatureStore(dim=DIM)
        for i in range(loaded):
            first.add(i, rows[i])
        first.save(str(tmp_path))
        store = FeatureStore.load(str(tmp_path))
    else:
        store = FeatureStore(dim=DIM)
    store.reserve(N - loaded)
    for i in range(loaded, N):
        store.add(i, rows[i])
    host = l1_normalize(rows) if normalize else rows
    want = torch.from_numpy(host).to(torch.bfloat16)
    got = device_table(store, "cuda", torch.bfloat16, normalize=normalize)
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))
