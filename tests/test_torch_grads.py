"""Gradients of the port's kernel wrappers against `jax.grad` of the JAX
package's, on the CPU.

JAX routes every conv3x3 through its custom VJP (`_conv3x3_vjp`: the backward
differentiates an all-fp32 reference, straight through the int8 mode) and
differentiates `xla_attention` directly; the port's `Conv3x3Function` and
`AttentionFunction` are their counterparts. Each test feeds the same seeded
numpy inputs and the same cotangents (a loss that weights every output read)
to both. Tolerances: fp32 within 1e-4 (the JAX suite's own, `test_unet.py`);
bf16 normwise within 2^-8, one bf16 rounding unit: both sides differentiate
the same fp32 function and round the gradient once to the input's dtype.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu.kernels import attention as jattn
from kidney_diffusion_tpu.kernels import conv3x3 as jconv
from kidney_diffusion_tpu_torch.kernels import attention as tattn
from kidney_diffusion_tpu_torch.kernels import conv3x3 as tconv
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-4
BF16_NORMWISE = 2.0**-8
# the unchunked init conv: JAX differentiates `nn.Conv(dtype=bf16)` in bf16
# directly, the port the fp32 conv (then rounds): a few bf16 roundings apart
BIAS_IN_DTYPE_NORMWISE = 2.0**-6

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# name: (batch, rows, width, cin, cout, chunks, bias, prologue, stats, quant, range)
CONV_CASES = {
    "plain": (2, 6, 5, 8, 16, 0, False, False, False, False, False),
    "pro": (2, 6, 5, 8, 16, 0, True, True, False, False, False),
    "stats": (2, 6, 5, 8, 16, 0, True, True, True, False, False),
    "chunks2": (4, 3, 5, 8, 16, 2, True, True, True, False, False),
    "bias": (2, 6, 5, 8, 16, 0, True, False, False, False, False),
    "quant": (2, 6, 5, 8, 16, 0, True, True, True, True, False),
    "range": (2, 6, 5, 8, 16, 0, True, True, False, False, True),
    "range_stats_quant": (4, 3, 5, 8, 16, 2, True, True, True, True, True),
}


def _conv_inputs(seed, nb, h, w, cin, cout, chunks, bias, pro):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, h, w, cin)).astype(np.float32)
    wk = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.normal(size=(cout,))).astype(np.float32) if bias else None
    p = None
    if pro:  # per image, repeated over its chunks, as GroupNorm makes it
        n_img = nb // max(chunks, 1)
        p = rng.normal(size=(n_img, 2, cin)).astype(np.float32)
        p[:, 0] = np.abs(p[:, 0]) + 0.5
        p = np.repeat(p, max(chunks, 1), axis=0)
    r_out = rng.normal(size=(nb, h, w, cout)).astype(np.float32)
    r_stats = rng.normal(size=(nb, 2, cout)).astype(np.float32) / (h * w)
    return x, wk, b, p, r_out, r_stats


def _compare(got, want, dtype, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=what)
    else:
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= BF16_NORMWISE, (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv3x3_grad_matches_jax(case, dtype):
    nb, h, w, cin, cout, chunks, bias, pro, stats, quant, rng_ = CONV_CASES[case]
    x, wk, b, p, r_out, r_stats = _conv_inputs(len(case), nb, h, w, cin, cout, chunks, bias, pro)
    names = ["x", "w"] + (["b"] if bias else []) + (["pro"] if pro else [])
    args = [x, wk] + ([b] if bias else []) + ([p] if pro else [])

    def split(vals):
        it = iter(vals)
        xx, ww = next(it), next(it)
        return xx, ww, next(it) if bias else None, next(it) if pro else None

    def jloss(*vals):
        xx, ww, bb, pp = split(vals)
        outs = jconv.conv3x3(xx.astype(JDT[dtype]), ww.astype(JDT[dtype]), bb, pro=pp,
                             want_stats=stats, chunks=chunks, quant=quant, want_range=rng_)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = jnp.sum(outs[0].astype(jnp.float32) * r_out)
        if stats:
            loss = loss + jnp.sum(outs[1] * r_stats)
        return loss

    want = jax.grad(jloss, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))

    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    xx, ww, bb, pp = split(leaves)
    outs = tconv.conv3x3(xx.to(TDT[dtype]), ww.to(TDT[dtype]), bb, pro=pp, want_stats=stats,
                         chunks=chunks, quant=quant, want_range=rng_)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert type(outs[0].grad_fn).__name__ == "Conv3x3FunctionBackward"
    if rng_:
        assert not outs[-1].requires_grad  # ranges carry no gradient
    loss = (outs[0].float() * torch.from_numpy(r_out)).sum()
    if stats:
        loss = loss + (outs[1] * torch.from_numpy(r_stats)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, wnt in zip(names, got, want):
        _compare(g.numpy(), wnt, dtype, f"d{name}")


@pytest.mark.parametrize("case", ["stats", "chunks2", "quant"])
def test_conv3x3_function_with_injected_forward(case):
    """The card path's autograd code run here: `Conv3x3Function` with a
    stand-in for the CUDA launch (the plain version, counted). The forward
    runs it once and the backward never; the gradients equal the CPU
    path's bit for bit, and autograd straight through the plain version's
    fp32 graph within 1e-6."""
    nb, h, w, cin, cout, chunks, bias, pro, stats, quant, rng_ = CONV_CASES[case]
    x, wk, b, p, r_out, r_stats = _conv_inputs(3, nb, h, w, cin, cout, chunks, bias, pro)
    calls = []

    def launch(*args, **kwargs):
        calls.append(kwargs["quant"])
        return tconv.conv3x3_plain(*args, **kwargs)

    opts = dict(want_stats=stats, chunks=chunks, quant=quant, want_range=rng_,
                bias_in_dtype=False)

    def grads(run):
        leaves = [torch.tensor(a, requires_grad=True) for a in (x, wk, b, p)]
        outs = run(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = (outs[0] * torch.from_numpy(r_out)).sum() + (outs[1] * torch.from_numpy(r_stats)).sum()
        return torch.autograd.grad(loss, leaves)

    injected = grads(lambda *t: tconv.Conv3x3Function.apply(launch, opts, *t, None, None))
    assert calls == [quant]
    cpu_path = grads(lambda xx, ww, bb, pp: tconv.conv3x3(xx, ww, bb, pro=pp, **opts))
    direct = grads(lambda xx, ww, bb, pp: tconv.conv3x3_plain(
        xx, ww, bb, pro=pp, want_stats=stats, chunks=chunks))  # exact: no quantization
    for a, c, d in zip(injected, cpu_path, direct):
        assert torch.equal(a, c)
        torch.testing.assert_close(a, d, atol=1e-6, rtol=1e-6)


def test_conv3x3_without_grad_runs_no_autograd_function():
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    w = torch.randn(3, 3, 8, 8)
    with torch.no_grad():
        assert tconv.conv3x3(x, w).grad_fn is None
    assert tconv.conv3x3(x.detach(), w).grad_fn is None


def test_bias_in_dtype_grad_matches_flax_conv():
    """The unchunked init conv in bf16 (`bias_in_dtype`) against
    `jax.grad` of `nn.Conv(dtype=bf16)`, which XLA differentiates in bf16:
    within 2^-6 normwise (fp32 params; the input gradient in bf16)."""
    x, wk, b, _, r_out, _ = _conv_inputs(5, 2, 8, 7, 6, 32, 0, True, False)
    conv = nn.Conv(32, (3, 3), dtype=jnp.bfloat16)
    variables = {"params": {"kernel": jnp.asarray(wk), "bias": jnp.asarray(b)}}

    def jloss(xx, params):
        y = conv.apply({"params": params}, xx.astype(jnp.bfloat16))
        return jnp.sum(y.astype(jnp.float32) * r_out)

    gx, gp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), variables["params"])
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, wk, b)]
    y = tconv.conv3x3(leaves[0].bfloat16(), leaves[1].bfloat16(), leaves[2], bias_in_dtype=True)
    got = torch.autograd.grad((y.float() * torch.from_numpy(r_out)).sum(), leaves)
    for name, g, want in zip(("x", "kernel", "bias"), got, (gx, gp["kernel"], gp["bias"])):
        want = np.asarray(want, np.float64)
        err = np.linalg.norm(g.double().numpy() - want) / np.linalg.norm(want)
        assert err <= BIAS_IN_DTYPE_NORMWISE, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,nk", [(12, 14), (9, 2)])  # self + 2 context keys; cross
def test_attention_grad_matches_jax(nq, nk, dtype):
    rng = np.random.default_rng(nq + nk)
    q, k, v = (rng.normal(size=(2, n, 2, 8)).astype(np.float32) for n in (nq, nk, nk))
    r = rng.normal(size=(2, nq, 2, 8)).astype(np.float32)

    def jloss(qq, kk, vv):
        o = jattn.xla_attention(*(t.astype(JDT[dtype]) for t in (qq, kk, vv)))
        return jnp.sum(o.astype(jnp.float32) * r)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = tattn.attention(*(t.to(TDT[dtype]) for t in leaves))
    assert type(o.grad_fn).__name__ == "AttentionFunctionBackward"
    got = torch.autograd.grad((o.float() * torch.from_numpy(r)).sum(), leaves)
    for name, g, wnt in zip("qkv", got, want):
        _compare(g.numpy(), wnt, dtype, f"d{name}")
