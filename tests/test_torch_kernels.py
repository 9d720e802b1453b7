"""The port's kernel modules against the JAX package's kernels, on the CPU.

Inputs come from numpy seeds and go through both frameworks. The port's
wrappers run their plain PyTorch versions here (CPU tensors); the JAX side
runs both its XLA reference and its Pallas kernel in interpret mode. The
CUDA kernels themselves run only on the card (`chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu.kernels import attention as jatt
from kidney_diffusion_tpu.kernels import conv3x3 as jc3
from kidney_diffusion_tpu_torch.kernels import attention as tatt
from kidney_diffusion_tpu_torch.kernels import conv3x3 as tc3

CONV_ATOL = 1e-3  # as tests/test_kernels.py holds Pallas to XLA
ATTN_ATOL = 2e-5

# name: (batch, rows, width, cin, cout, prologue, stats, chunks, bias scale)
CONV_CASES = {
    "prologue_stats": (2, 8, 16, 8, 16, True, True, 0, 1.0),
    "border_rows": (1, 2, 5, 3, 3, True, True, 0, 1.0),
    "chunked": (2, 4, 12, 8, 6, True, True, 4, 1.0),
    "chunked_one_row": (1, 1, 8, 4, 4, False, True, 8, 1.0),
    "no_bias_no_stats": (1, 6, 7, 6, 5, False, False, 0, 0.0),
}


def _conv_inputs(b, rows, w, cin, cout, pro, chunks, bias_scale, seed=0):
    rng = np.random.default_rng(seed)
    nb = b * max(chunks, 1)
    x = rng.normal(size=(nb, rows, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * bias_scale).astype(np.float32)
    p = None
    if pro:
        # per-image affine, repeated over an image's chunks as
        # gn_film_affine(chunks=...) makes it
        p = rng.normal(size=(b, 2, cin)).astype(np.float32)
        p = np.repeat(p, max(chunks, 1), axis=0)
    return x, wk, bias, p


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _as_np(out):
    return [np.asarray(o) for o in out] if isinstance(out, tuple) else [np.asarray(out)]


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv3x3_plain_matches_xla(case):
    b, rows, w, cin, cout, pro, stats, chunks, bs = CONV_CASES[case]
    x, wk, bias, p = _conv_inputs(b, rows, w, cin, cout, pro, chunks, bs)
    bias_arg = bias if bs else None
    want = jc3.xla_conv3x3(_j(x), _j(wk), _j(bias_arg), _j(p), want_stats=stats, chunks=chunks)
    got = tc3.conv3x3(_t(x), _t(wk), _t(bias_arg), pro=_t(p), want_stats=stats, chunks=chunks)
    for g, r in zip(_as_np(got), _as_np(want)):
        np.testing.assert_allclose(g, r, atol=CONV_ATOL, rtol=1e-5)


@pytest.mark.parametrize("case", ["prologue_stats", "border_rows", "chunked"])
def test_conv3x3_plain_matches_pallas_interpret(case):
    b, rows, w, cin, cout, pro, stats, chunks, bs = CONV_CASES[case]
    x, wk, bias, p = _conv_inputs(b, rows, w, cin, cout, pro, chunks, bs, seed=1)
    want = jc3.conv3x3(_j(x), _j(wk), _j(bias), pro=_j(p), want_stats=stats,
                       chunks=chunks, interpret=True)
    got = tc3.conv3x3(_t(x), _t(wk), _t(bias), pro=_t(p), want_stats=stats, chunks=chunks)
    for g, r in zip(_as_np(got), _as_np(want)):
        np.testing.assert_allclose(g, r, atol=CONV_ATOL, rtol=1e-5)


def test_conv3x3_chunked_equals_same():
    """Row-chunked conv == SAME conv on the whole image; per-chunk stats
    combine to the whole image's by the parallel-variance rule."""
    rng = np.random.RandomState(0)
    B, H, W, C, D, CH = 2, 16, 12, 8, 6, 4
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, C, D).astype(np.float32))
    b = torch.from_numpy(rng.randn(D).astype(np.float32))
    y_ref, s_ref = tc3.conv3x3(x, w, b, want_stats=True)
    y_ch, s_ch = tc3.conv3x3(x.reshape(B * CH, H // CH, W, C), w, b, want_stats=True, chunks=CH)
    np.testing.assert_allclose(y_ch.reshape(B, H, W, D).numpy(), y_ref.numpy(), atol=1e-5)
    sc = s_ch.numpy().reshape(B, CH, 2, D)
    npix = (H // CH) * W
    s1 = sc[:, :, 0].sum(1)
    mu_i = sc[:, :, 0] / npix
    q = sc[:, :, 1].sum(1) + npix * ((mu_i - (s1 / (npix * CH))[:, None]) ** 2).sum(1)
    np.testing.assert_allclose(s1, s_ref.numpy()[:, 0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(q, s_ref.numpy()[:, 1], rtol=1e-4, atol=1e-3)


def test_conv3x3_stats_large_bias_no_cancellation():
    """A huge bias (|mean|/std ~ 1e4) must not cancel the variance: the
    stats come from the pre-bias output (JAX test_kernels.py:226)."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 32, 32, 8).astype(np.float32) * 0.01
    w = rng.randn(3, 3, 8, 8).astype(np.float32) * 0.1
    bias = np.full((8,), 500.0, np.float32)
    y, s = tc3.conv3x3(_t(x), _t(w), _t(bias), want_stats=True)
    var_true = y.double().numpy().reshape(-1, 8).var(0)
    np.testing.assert_allclose(s.numpy()[0, 1] / (32 * 32), var_true, rtol=1e-3)
    _, s_jax = jc3.xla_conv3x3(_j(x), _j(w), _j(bias), want_stats=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_jax), rtol=1e-4, atol=CONV_ATOL)


@pytest.mark.parametrize("width", [5, 16, 40, 130])
def test_conv3x3_tile_slots_finish_to_plain_stats(width):
    """The CUDA kernel writes one [sum z, sum z^2] slot per 64-pixel tile
    (`tile_w` columns x 64/tile_w rows) and the wrapper sums the slots and
    finishes them. Emulate that tiling on the plain pre-bias output: it must
    give the plain stats."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 7, width, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    _, want = tc3.conv3x3(x, w, b, want_stats=True)
    z = tc3.conv3x3(x, w, None).double()
    tw = tc3.tile_w(width)
    assert tw in (16, 32, 64) and (tw >= width or tw == 64)
    th = 64 // tw
    slots = []
    for y0 in range(0, 7, th):
        for x0 in range(0, width, tw):
            t = z[:, y0:y0 + th, x0:x0 + tw]
            slots.append(torch.stack([t.sum((1, 2)), (t * t).sum((1, 2))], 1))
    s = torch.stack(slots, 1).sum(1).float()
    got = tc3.finish_stats(s[:, 0], s[:, 1], 7 * width, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-3)


# name: (batch, nq, nk, heads, dim_head)
ATTN_CASES = {
    "self": (2, 48, 48, 2, 16),
    "context_tokens": (1, 40, 43, 2, 8),
    "unaligned_queries": (1, 37, 37, 1, 16),
    "cross_two_keys": (2, 64, 2, 2, 8),
}


def _qkv(b, nq, nk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, nq, h, d), (b, nk, h, d), (b, nk, h, d))]


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_matches_xla(case):
    q, k, v = _qkv(*ATTN_CASES[case])
    want = jatt.xla_attention(*map(jnp.asarray, (q, k, v)))
    got = tatt.attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_ATOL)


@pytest.mark.parametrize("case", ["context_tokens", "unaligned_queries", "cross_two_keys"])
def test_attention_plain_matches_pallas_interpret(case):
    b, nq, nk, h, d = ATTN_CASES[case]
    q, k, v = _qkv(b, nq, nk, h, d, seed=1)

    def heads_first(a):  # (B, N, H, D) -> (B*H, N, D), the kernel's layout
        return jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, a.shape[1], d)

    out = jatt._fused_attention(heads_first(q), heads_first(k), heads_first(v), interpret=True)
    want = np.asarray(out).reshape(b, h, nq, d).transpose(0, 2, 1, 3)
    got = tatt.attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_ATOL)


def test_attention_bf16_rounds_like_the_reference():
    """bf16 inputs: q scaled in bf16, softmax weights cast to bf16 before
    P.V — the plain version matches the JAX reference's rounding."""
    q, k, v = _qkv(1, 32, 34, 2, 8, seed=4)
    want = jatt.xla_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = tatt.attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    x, w, b, p = _conv_inputs(1, 4, 4, 3, 2, True, 0, 1.0)
    before = (tc3.LAUNCHES, tatt.LAUNCHES)
    tc3.conv3x3(_t(x), _t(w), _t(b), pro=_t(p), want_stats=True)
    tatt.attention(*map(torch.from_numpy, _qkv(1, 4, 4, 1, 8)))
    assert (tc3.LAUNCHES, tatt.LAUNCHES) == before


def test_wrappers_refuse_other_devices():
    meta = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        tc3.conv3x3(meta, torch.empty((3, 3, 3, 2), device="meta"))
    q = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError):
        tatt.attention(q, q, q)
