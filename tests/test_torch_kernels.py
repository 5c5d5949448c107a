"""The kernel wrappers' routes, launch counters and build inputs, on the CPU.

A CUDA tensor takes one of each kernel's hand-written routes, chosen by a
pure function of the shapes, dtypes, alignment and k (``conv3x3_route``,
``lstm_step_route``, ``topk_lse_route``).  These tests hold those
functions at the shapes the port runs, check that the route numbers agree
with the C sources, and drive each op's CUDA implementation
(``conv3x3_relu_cuda``, ``lstm_step_cuda``, ``topk_lse_cuda``, what the
``lrcn::*`` op runs for a CUDA tensor) on tensors of the ``meta`` device
with the library, the device check and the stream stubbed out: every
route goes to the C entry point, never to the plain version, and is
counted once.  (A ``meta`` tensor given to the wrapper itself reaches
the op's fake implementation.)
"""

import contextlib
import re
import shutil

import pytest
import torch

from lrcn_tpu_torch.ops.kernels import build
from lrcn_tpu_torch.ops.kernels import conv3x3 as conv_module
from lrcn_tpu_torch.ops.kernels import lstm_step as lstm_module
from lrcn_tpu_torch.ops.kernels import topk_lse as topk_module

# the 13 VGG-16 convs at their 9 distinct shapes (H = W, C, F)
VGG_CONVS = [(224, 3, 64), (224, 64, 64), (112, 64, 128), (112, 128, 128),
             (56, 128, 256), (56, 256, 256), (28, 256, 512), (28, 512, 512),
             (14, 512, 512)]
DTYPES = [torch.bfloat16, torch.float32]
H100_SMS = 132
# the rows the wgmma route's grid is checked at: a lone part-filled tile
# (3), one full tile and a row more (129), the decode batch (768), the
# 16x256 decode (12,288) and a row more (an odd count of row tiles),
# best-of-100 sampling (25,600)
GRID_ROWS = [3, 129, 768, 12288, 12289, 25600]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _misaligned(*shape, dtype):
    """A contiguous CPU tensor whose data starts 2 elements past a 16-byte
    boundary."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.zeros(n + 16, dtype=dtype)
    skip = (-flat.data_ptr() // flat.element_size()) % 16 + 2
    return flat[skip:skip + n].view(shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,c,f", VGG_CONVS)
def test_conv_route_at_vgg_shapes(hw, c, f, dtype):
    x, w = _meta(8, hw, hw, c, dtype=dtype), _meta(3, 3, c, f, dtype=dtype)
    want = ("fma" if dtype == torch.float32
            else "scalar" if c == 3 else "wgmma")
    assert conv_module.conv3x3_route(x, w) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_route_of_ragged_shape(dtype):
    x, w = _meta(2, 13, 17, 5, dtype=dtype), _meta(3, 3, 5, 7, dtype=dtype)
    want = "fma" if dtype == torch.float32 else "scalar"
    assert conv_module.conv3x3_route(x, w) == want


def test_conv_route_needs_tma_alignment():
    w = torch.zeros((3, 3, 64, 64), dtype=torch.bfloat16)
    x = _misaligned(1, 4, 4, 64, dtype=torch.bfloat16)
    assert conv_module.conv3x3_route(x, w) == "scalar"
    assert conv_module.conv3x3_route(x.clone(), w) == "wgmma"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [768, 12288])
def test_lstm_route_at_decode_shapes(rows, dtype):
    w = _meta(2000, 4000, dtype=dtype)
    h, c, x = _meta(rows, 1000), _meta(rows, 1000), _meta(rows, 1000)
    want = "fma" if dtype == torch.float32 else "wgmma"
    assert lstm_module.lstm_step_route(w, h, c, x) == want


@pytest.mark.parametrize("dtype", DTYPES)
def test_lstm_route_of_ragged_shape(dtype):
    w = _meta(37 + 70, 280, dtype=dtype)
    h, c, x = _meta(100, 70), _meta(100, 70), _meta(100, 37)
    want = "fma" if dtype == torch.float32 else "wmma"
    assert lstm_module.lstm_step_route(w, h, c, x) == want


def test_lstm_route_needs_tma_alignment():
    w = torch.zeros((16, 32), dtype=torch.bfloat16)
    h, c = torch.zeros((4, 8)), torch.zeros((4, 8))
    x = _misaligned(4, 8, dtype=torch.float32)
    assert lstm_module.lstm_step_route(w, h, c, x) == "wmma"
    assert lstm_module.lstm_step_route(w, h, c, x.clone()) == "wgmma"


@pytest.mark.parametrize("rows,v,k,want", [
    (768, 8800, 3, "block"),        # beam-3 search of 256 images
    (12288, 8800, 3, "block"),      # the 16x256 decode
    (256, 8800, 1, "block"),        # greedy
    (768, 8800, 9, "block"), (768, 8800, 16, "block"),
    (768, 8800, 17, "rounds"), (3, 100, 100, "rounds"),
    (5, 8801, 3, "block")])
def test_topk_route_at_main_path_shapes(rows, v, k, want):
    assert topk_module.topk_lse_route(_meta(rows, v), k) == want


def test_topk_route_takes_misaligned_rows():
    """The block route reads each row's unaligned head and tail itself."""
    x = _misaligned(64, 8800, dtype=torch.float32)
    assert x.data_ptr() % 16 != 0
    assert topk_module.topk_lse_route(x, 3) == "block"
    assert topk_module.topk_lse_route(x.clone(), 3) == "block"


@pytest.mark.parametrize("module,source", [
    (conv_module, "conv3x3.cu"), (lstm_module, "lstm_step.cu"),
    (topk_module, "topk_lse.cu")])
def test_route_numbers_match_the_c_sources(module, source):
    """The ints the wrappers pass are the C side's ``enum Route``."""
    text = (build.CSRC_DIR / source).read_text()
    body = re.search(r"enum Route \{([^}]*)\}", text).group(1)
    in_c = {name.lower(): int(num)
            for name, num in re.findall(r"k(\w+) = (\d+)", body)}
    assert in_c == module.ROUTES


class _FakeLib:
    """Stands in for the CUDA library: records each entry point's args."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def stubbed(monkeypatch):
    """CUDA implementations driven on meta tensors as if they lay on a
    card: the library, the device check and the stream are stubbed; the
    plain versions must not be called."""
    lib = _FakeLib()

    def forbidden(*args, **kwargs):
        raise AssertionError("plain version called for a device tensor")

    @contextlib.contextmanager
    def on_device(device):
        yield 0

    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "on_device", on_device)
    monkeypatch.setattr(build, "sm_count", lambda device: H100_SMS)
    for module, ref in ((conv_module, "conv3x3_relu_reference"),
                        (lstm_module, "lstm_step_reference"),
                        (topk_module, "topk_logsumexp_reference")):
        monkeypatch.setattr(module, "require_cuda", lambda d: d)
        monkeypatch.setattr(module, ref, forbidden)
    return lib


@pytest.mark.parametrize("c,dtype,route", [
    (64, torch.bfloat16, "wgmma"), (3, torch.bfloat16, "scalar"),
    (64, torch.float32, "fma")])
def test_conv_wrapper_launches_its_route(stubbed, monkeypatch, c, dtype,
                                         route):
    fn = conv_module.fused_conv3x3_relu
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_by_route",
                        dict.fromkeys(conv_module.ROUTES, 0))
    y = conv_module.conv3x3_relu_cuda(
        _meta(2, 8, 8, c), _meta(3, 3, c, 64, dtype=dtype), _meta(64))
    assert y.shape == (2, 8, 8, 64) and y.dtype == dtype
    (name, args), = stubbed.calls
    assert name == "lrcn_conv3x3" and args[-2] == conv_module.ROUTES[route]
    assert fn.launches == 1
    assert fn.launches_by_route == {r: int(r == route)
                                    for r in conv_module.ROUTES}


@pytest.mark.parametrize("x_dim,dtype,route", [
    (1000, torch.bfloat16, "wgmma"), (37, torch.bfloat16, "wmma"),
    (1000, torch.float32, "fma")])
def test_lstm_wrapper_launches_its_route(stubbed, monkeypatch, x_dim, dtype,
                                         route):
    fn = lstm_module.fused_lstm_step
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_by_route",
                        dict.fromkeys(lstm_module.ROUTES, 0))
    h_dim = 1000
    h_out, c_out = lstm_module.lstm_step_cuda(
        _meta(x_dim + h_dim, 4 * h_dim, dtype=dtype), _meta(4 * h_dim),
        _meta(768, h_dim), _meta(768, h_dim), _meta(768, x_dim))
    assert h_out.shape == c_out.shape == (768, h_dim)
    (name, args), = stubbed.calls
    assert name == "lrcn_lstm_step" and args[-2] == lstm_module.ROUTES[route]
    assert fn.launches == 1
    assert fn.launches_by_route == {r: int(r == route)
                                    for r in lstm_module.ROUTES}


@pytest.mark.parametrize("rows", GRID_ROWS)
def test_lstm_wrapper_passes_the_wgmma_grid(stubbed, monkeypatch, rows):
    fn = lstm_module.fused_lstm_step
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_by_route",
                        dict.fromkeys(lstm_module.ROUTES, 0))
    h_dim = 1000
    lstm_module.lstm_step_cuda(
        _meta(2 * h_dim, 4 * h_dim, dtype=torch.bfloat16), _meta(4 * h_dim),
        _meta(rows, h_dim), _meta(rows, h_dim), _meta(rows, h_dim))
    (name, args), = stubbed.calls
    assert name == "lrcn_lstm_step"
    assert args[7:10] == (rows, h_dim, h_dim)
    assert args[10] == lstm_module.wgmma_grid(rows, h_dim, H100_SMS)
    assert args[-2] == lstm_module.ROUTES["wgmma"]
    assert fn.launches_by_route["wgmma"] == fn.launches == 1


def _walk(grid, rows, h_dim):
    """The (row tile, column tile) each block computes, as
    csrc/lstm_step.cu:wg::Tiles walks them: cluster k of K takes groups k,
    k + K, ...; block `rank` of a cluster the rank-th row tile of a group."""
    tile_rows, tile_cols = lstm_module.WGMMA_TILE
    cluster = lstm_module.WGMMA_CLUSTER
    col_tiles = -(-h_dim // tile_cols)
    groups = -(-(-(-rows // tile_rows)) // cluster) * col_tiles
    clusters = grid // cluster
    return {blk: [(u // col_tiles * cluster + blk % cluster, u % col_tiles)
                  for u in range(blk // cluster, groups, clusters)]
            for blk in range(grid)}


@pytest.mark.parametrize("rows", GRID_ROWS)
@pytest.mark.parametrize("h_dim", [1000, 64, 8])
def test_wgmma_grid_covers_every_tile_once(rows, h_dim):
    """Every (row tile, column tile) once; a tile past the rows only as a
    cluster's second row tile of the last row group; no block idle, whole
    clusters, at most one block an SM."""
    tile_rows, tile_cols = lstm_module.WGMMA_TILE
    cluster = lstm_module.WGMMA_CLUSTER
    grid = lstm_module.wgmma_grid(rows, h_dim, H100_SMS)
    assert grid % cluster == 0
    assert 1 <= grid <= H100_SMS
    row_tiles, col_tiles = -(-rows // tile_rows), -(-h_dim // tile_cols)
    walked = _walk(grid, rows, h_dim)
    assert all(walked.values())
    tiles = [t for blk in walked.values() for t in blk]
    inside = sorted(t for t in tiles if t[0] < row_tiles)
    assert inside == [(r, j) for r in range(row_tiles)
                      for j in range(col_tiles)]
    assert all(r == row_tiles and row_tiles % cluster
               for r, _ in tiles if r >= row_tiles)
    if len(tiles) >= H100_SMS:
        assert grid == H100_SMS     # a persistent block on every SM


def test_wgmma_tile_matches_the_c_source():
    text = (build.CSRC_DIR / "lstm_step.cu").read_text()
    body = text[text.index("namespace wg {"):]
    const = {name: int(num) for name, num in
             re.findall(r"constexpr int (BM|BNH|CL) = (\d+);", body)}
    assert (const["BM"], const["BNH"]) == lstm_module.WGMMA_TILE
    assert const["CL"] == lstm_module.WGMMA_CLUSTER


def test_topk_wrapper_launches_the_kernel(stubbed, monkeypatch):
    fn = topk_module.topk_logsumexp
    monkeypatch.setattr(fn, "launches", 0)
    vals, idx, lse = topk_module.topk_lse_cuda(_meta(768, 8800), 3)
    assert vals.shape == idx.shape == (768, 3) and lse.shape == (768,)
    (name, _), = stubbed.calls
    assert name == "lrcn_topk_lse" and fn.launches == 1


@pytest.mark.parametrize("k,asked,route", [
    (3, None, "block"), (3, "warp", "warp"), (3, "rounds", "rounds"),
    (8, "warp", "warp"), (12, None, "block"), (12, "rounds", "rounds"),
    (17, None, "rounds")])
def test_topk_wrapper_launches_its_route(stubbed, monkeypatch, k, asked,
                                         route):
    fn = topk_module.topk_logsumexp
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_by_route",
                        dict.fromkeys(topk_module.ROUTES, 0))
    vals, idx, lse = topk_module.topk_lse_cuda(_meta(768, 8800), k, asked)
    assert vals.shape == idx.shape == (768, k) and lse.shape == (768,)
    assert vals.dtype == lse.dtype == torch.float32
    assert idx.dtype == torch.int32
    (name, args), = stubbed.calls
    assert name == "lrcn_topk_lse"
    assert args[4:8] == (768, 8800, k, topk_module.ROUTES[route])
    assert fn.launches == 1
    assert fn.launches_by_route == {r: int(r == route)
                                    for r in topk_module.ROUTES}


@pytest.mark.parametrize("k,asked", [(9, "warp"), (17, "block"),
                                     (3, "tiles")])
def test_topk_wrapper_refuses_a_route_that_cannot_take_k(stubbed, k, asked):
    """Refused by the wrapper (its op's fake implementation on meta) and
    by the CUDA implementation, before any launch."""
    with pytest.raises(ValueError):
        topk_module.topk_logsumexp(_meta(768, 8800), k, route=asked)
    with pytest.raises(ValueError):
        topk_module.topk_lse_cuda(_meta(768, 8800), k, asked)
    assert stubbed.calls == []


def test_build_hashes_the_shared_header(tmp_path, monkeypatch):
    """``csrc/hopper.cuh`` is a build input: editing it rebuilds."""
    assert build.CSRC_DIR / "hopper.cuh" in build.sources()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path()
    with open(csrc / "hopper.cuh", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path() != before
