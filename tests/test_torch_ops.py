"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors each kernel wrapper computes its plain PyTorch version;
these tests hold that version against the JAX reference and against the
Pallas kernel in interpret mode, on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lrcn_tpu.ops.lstm import lstm_step as jax_lstm_step
from lrcn_tpu.ops.pallas import fused_lstm_step as jax_fused_lstm_step
from lrcn_tpu.ops.pallas.topk_lse import topk_logsumexp as jax_topk_lse
from lrcn_tpu_torch import require_cuda
from lrcn_tpu_torch.ops import lstm as torch_lstm
from lrcn_tpu_torch.ops.kernels import (fused_lstm_step, lstm_step_reference,
                                        topk_logsumexp,
                                        topk_logsumexp_reference)
from lrcn_tpu_torch.ops.kernels import lstm_step as lstm_step_module
from lrcn_tpu_torch.ops.kernels import topk_lse as topk_module

JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _lstm_inputs(seed, b_dim, x_dim, h_dim):
    rng = np.random.default_rng(seed)
    return dict(
        w=(rng.standard_normal((x_dim + h_dim, 4 * h_dim)) * 0.05
           ).astype(np.float32),
        b=(rng.standard_normal(4 * h_dim) * 0.1).astype(np.float32),
        h=rng.standard_normal((b_dim, h_dim)).astype(np.float32),
        c=rng.standard_normal((b_dim, h_dim)).astype(np.float32),
        x=rng.standard_normal((b_dim, x_dim)).astype(np.float32))


def _torch_lstm(fn, a, dtype):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    h, c = fn(t["w"].to(dtype), t["b"], t["h"], t["c"], t["x"])
    return h.numpy(), c.numpy()


# f32: the same operands summed in another order -> rtol = atol = 1e-5.
# bf16: the same bf16-rounded operands, products summed in f32 in another
# order -> atol 1e-4.
TOLERANCE = {torch.float32: dict(rtol=1e-5, atol=1e-5),
             torch.bfloat16: dict(rtol=0, atol=1e-4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 24, 32), (7, 16, 12), (96, 200, 160)])
def test_lstm_step_reference_matches_jax(dtype, shape):
    a = _lstm_inputs(0, *shape)
    h_ref, c_ref = jax_lstm_step(
        jnp.asarray(a["w"]), jnp.asarray(a["b"]), jnp.asarray(a["h"]),
        jnp.asarray(a["c"]), jnp.asarray(a["x"]),
        compute_dtype=JAX_DTYPES[dtype])
    # the wrapper on CPU tensors and the plain version directly
    for fn in (fused_lstm_step, lstm_step_reference):
        h, c = _torch_lstm(fn, a, dtype)
        np.testing.assert_allclose(h, np.asarray(h_ref), **TOLERANCE[dtype])
        np.testing.assert_allclose(c, np.asarray(c_ref), **TOLERANCE[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_step_reference_matches_pallas_interpret(dtype):
    a = _lstm_inputs(1, 6, 24, 32)
    h_ref, c_ref = jax_fused_lstm_step(
        jnp.asarray(a["w"]), jnp.asarray(a["b"]), jnp.asarray(a["h"]),
        jnp.asarray(a["c"]), jnp.asarray(a["x"]),
        compute_dtype=JAX_DTYPES[dtype], interpret=True)
    h, c = _torch_lstm(fused_lstm_step, a, dtype)
    np.testing.assert_allclose(h, np.asarray(h_ref), **TOLERANCE[dtype])
    np.testing.assert_allclose(c, np.asarray(c_ref), **TOLERANCE[dtype])


def test_matmul_keeps_f32_output_of_bf16_operands():
    """bf16 operands, f32 sums and output: not a bf16-rounded product."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 33)).astype(np.float32)
    w = rng.standard_normal((33, 7)).astype(np.float32)
    from lrcn_tpu.ops.lstm import matmul as jax_matmul
    ref = np.asarray(jax_matmul(jnp.asarray(a), jnp.asarray(w),
                                jnp.bfloat16))
    got = torch_lstm.matmul(torch.from_numpy(a), torch.from_numpy(w),
                            torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_lstm_step_validates_shapes():
    z = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError):
        fused_lstm_step(z(10, 12), z(12), z(2, 3), z(2, 3), z(2, 4))
    with pytest.raises(TypeError):
        fused_lstm_step(z(7, 12), z(12), z(2, 3), z(2, 3),
                        z(2, 4).double())


def _tie_heavy(rng, r, v):
    """Small integer logits with copied columns: many exact ties."""
    x = rng.integers(-3, 3, size=(r, v)).astype(np.float32)
    x[:, 7] = x[:, 3]
    x[:, v - 1] = x[:, 0]
    return x


# 9 and 12: beam widths above v1's register list; K_EQ_V: k = V, on a
# narrower row (the interpreted Pallas kernel unrolls k rounds)
K_EQ_V = 64


@pytest.mark.parametrize("k", [1, 3, 4, 9, 12, K_EQ_V])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_logsumexp_reference_matches_pallas_interpret(k, ties):
    rng = np.random.default_rng(k)
    r, v = 16, K_EQ_V if k == K_EQ_V else 300
    x = (_tie_heavy(rng, r, v) if ties
         else rng.standard_normal((r, v)).astype(np.float32) * 3)
    ref_v, ref_i, ref_l = jax_topk_lse(jnp.asarray(x), k, interpret=True)
    for fn in (topk_logsumexp, topk_logsumexp_reference):
        vals, idx, lse = fn(torch.from_numpy(x), k)
        # values and indices exact, ties included
        np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
        assert idx.dtype == torch.int32
        # lse: another summation order -> 1e-6
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l),
                                   rtol=1e-6, atol=1e-6)


def test_topk_logsumexp_rejects_unsupported_k():
    x = torch.zeros((2, 5))
    for k in (0, 6, 9):
        with pytest.raises(ValueError):
            topk_logsumexp(x, k)


def test_device_tensors_never_take_the_plain_version(monkeypatch):
    """Only CPU tensors take the plain versions: a CUDA tensor goes to the
    op's CUDA implementation, which raises unless it is on an sm_90 card,
    and a ``meta`` tensor to its fake implementation (shapes only)."""
    def forbidden(*args, **kwargs):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(lstm_step_module, "lstm_step_reference", forbidden)
    monkeypatch.setattr(topk_module, "topk_logsumexp_reference", forbidden)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            require_cuda("cuda")
    with pytest.raises(RuntimeError):
        require_cuda("cpu")
    meta = lambda *s: torch.empty(s, device="meta")
    lstm_args = (meta(8, 16).bfloat16(), meta(16), meta(2, 4), meta(2, 4),
                 meta(2, 4))
    # the CUDA implementations must raise for a tensor off the card
    with pytest.raises(RuntimeError):
        lstm_step_module.lstm_step_cuda(*lstm_args)
    with pytest.raises(RuntimeError):
        topk_module.topk_lse_cuda(meta(2, 5), 2)
    h, c = lstm_step_module.fused_lstm_step(*lstm_args)
    vals, idx, lse = topk_module.topk_logsumexp(meta(2, 5), 2)
    assert h.device.type == c.device.type == vals.device.type == "meta"
    assert idx.shape == (2, 2) and idx.dtype == torch.int32
    assert lstm_step_module.fused_lstm_step.launches == 0
    assert topk_module.topk_logsumexp.launches == 0
