"""The port's w8a8 int8 + fp8-storage serving path, and its bf16 U-Net, against
the JAX package's, on the CPU.

Inputs are numpy draws from a seed, parameters random draws with the names
and shapes of a Flax init carried into the port by `convert.from_flax`. The
port's wrappers run their plain versions here (CPU tensors); the JAX side
runs `xla_conv3x3`, which is what the JAX package runs for every int8 and
range-epilogue conv on any backend (`kernels/conv3x3.py:_dispatch`).

Tolerances:
- the int8 conv and its range epilogue, and a quantized Upsample, are
  bit-equal to JAX (exact int32 sums, the same scale and rounding order);
  stats are fp32 sums in another order: 1e-5 of the largest;
- a quantized ResnetBlock: its GroupNorm affine and silu round in fp32 in
  another order, and where that moves a bf16 activation across an int8
  rounding boundary the next conv sees one different int8 step; so 2 bf16
  ulps of the largest value and 2^-8 normwise, the carried bound 2^-8;
- the bf16 range epilogue (no quant): the fp32 conv sums in another order,
  so 1e-3 absolute, as `tests/test_kernels.py` holds Pallas to XLA;
- whole bf16 U-Nets: 2^-6 normwise (measured 0.9-1.0e-2; bf16 rounds at
  other places in the two frameworks, one ulp is 2^-8 relative);
- whole int8 U-Nets: quantization turns a one-ulp bf16 difference near a
  rounding boundary into a whole int8 step, so the JAX package's own jitted
  and eager runs of this model differ by 4.5e-2 normwise with bf16 storage,
  1.05e-1 with fp8 e4m3fn storage and 1.89e-1 with fp8 e5m2 (two mantissa
  bits; chunks 4). The bounds are about 1.4x and 1.5x those: 2^-4, 0.16 and
  0.28.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu.kernels import conv3x3 as jc3
from kidney_diffusion_tpu.models import blocks as jb
from kidney_diffusion_tpu.models import configs as jcfg
from kidney_diffusion_tpu.models.unet import EfficientUNet as JaxUNet
from kidney_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from kidney_diffusion_tpu_torch.cascade import Cascade
from kidney_diffusion_tpu_torch.convert import build_model, from_flax
from kidney_diffusion_tpu_torch.kernels import conv3x3 as tc3
from kidney_diffusion_tpu_torch.models import blocks as tb
from kidney_diffusion_tpu_torch.models import configs as tcfg
from kidney_diffusion_tpu_torch.models.unet import cast_storage
from test_torch_helpers import one_torch_thread, random_flax_params  # noqa: F401 (autouse)

BF16_UNET_NORMWISE = 2.0**-6
QUANT_UNET_NORMWISE = {None: 2.0**-4, "float8_e4m3fn": 0.16, "float8_e5m2": 0.28}
STATS_RTOL = 1e-5
CONV_ATOL = 1e-3


def _bf16(a):
    """numpy fp32 values rounded to bf16 (exactly representable both ways)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype is not None else t


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _normwise(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture
def every_site_quant(monkeypatch):
    """Quantize every conv whatever its size, as the JAX range tests do."""
    monkeypatch.setenv("KDT_QUANT_MIN_PIX", "1")
    monkeypatch.setenv("KDT_QUANT_MIN_CH", "1")


# name: (batch, rows, width, cin, cout, chunks, prologue, a_max, stats)
QUANT_CASES = {
    "plain": (2, 8, 12, 40, 24, 0, False, None, False),
    "a_max_stats": (2, 8, 12, 40, 24, 0, False, 4.5, True),
    "chunked_a_max_stats": (2, 2, 12, 40, 24, 4, False, 4.5, True),
    "chunked_prologue_dynamic": (2, 2, 12, 40, 24, 4, True, None, True),
    "prologue_a_max": (1, 9, 7, 16, 20, 0, True, 3.0, True),
    "chunked_prologue_no_stats": (1, 3, 17, 32, 32, 3, True, 2.5, False),
}


def _conv_case(case, seed=0):
    b, rows, w, cin, cout, chunks, pro, a_max, stats = QUANT_CASES[case]
    rng = np.random.default_rng(seed)
    nb = b * max(chunks, 1)
    x = _bf16(rng.normal(size=(nb, rows, w, cin)))
    wk = _bf16(rng.normal(size=(3, 3, cin, cout)) * 0.2)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    p = None
    if pro:  # per-image affine repeated over its chunks, as GroupNorm makes it
        p = np.repeat(rng.normal(size=(b, 2, cin)).astype(np.float32), max(chunks, 1), axis=0)
    am = None if a_max is None else np.float32(a_max)
    return x, wk, bias, p, am, chunks, stats


@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_conv_plain_matches_xla(case):
    """The plain int8 conv equals `xla_conv3x3(quant=True)` bit for bit in its
    output and range, with and without prologue, chunks and a given a_max."""
    x, wk, bias, p, am, chunks, stats = _conv_case(case)
    want = jc3.xla_conv3x3(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16),
                           jnp.asarray(bias), None if p is None else jnp.asarray(p),
                           want_stats=stats, chunks=chunks, quant=True,
                           a_max=None if am is None else jnp.asarray(am), want_range=True)
    got = tc3.conv3x3(_t(x, torch.bfloat16), _t(wk, torch.bfloat16), _t(bias), pro=_t(p),
                      want_stats=stats, chunks=chunks, quant=True, a_max=_t(am),
                      want_range=True)
    assert len(got) == len(want) == (3 if stats else 2)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    np.testing.assert_array_equal(_np(got[-1]), _np(want[-1]))
    if stats:
        scale = np.abs(_np(want[1])).max()
        np.testing.assert_allclose(_np(got[1]), _np(want[1]), rtol=0, atol=STATS_RTOL * scale)


def test_quant_conv_reuses_quantized_weights():
    """`w_q=quantize_weights(w)` gives the same output as quantizing inside."""
    x, wk, bias, p, am, chunks, stats = _conv_case("chunked_a_max_stats", seed=3)
    xt, wt = _t(x, torch.bfloat16), _t(wk, torch.bfloat16)
    kw = dict(want_stats=stats, chunks=chunks, quant=True, a_max=_t(am))
    a = tc3.conv3x3(xt, wt, _t(bias), **kw)
    b = tc3.conv3x3(xt, wt, _t(bias), w_q=tc3.quantize_weights(wt), **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("chunks", [0, 2])
def test_range_epilogue_bf16_matches_xla(stats, chunks):
    """The range epilogue without quant, in both of JAX's definitions: from
    fp32 z + bias with stats, from the bf16 output without. Either way the
    range rounded to bf16 is exactly the output's own [max, min]."""
    rng = np.random.default_rng(5)
    x = _bf16(rng.normal(size=(2 * max(chunks, 1), 8 // max(chunks, 1), 16, 32)))
    wk = _bf16(rng.normal(size=(3, 3, 32, 32)) * 0.1)
    bias = np.linspace(-1.0, 1.0, 32, dtype=np.float32)
    want = jc3.xla_conv3x3(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16),
                           jnp.asarray(bias), want_stats=stats, chunks=chunks, want_range=True)
    got = tc3.conv3x3(_t(x, torch.bfloat16), _t(wk, torch.bfloat16), _t(bias),
                      want_stats=stats, chunks=chunks, want_range=True)
    assert got[-1].shape == (x.shape[0], 2, 32)
    np.testing.assert_allclose(_np(got[-1]), _np(want[-1]), rtol=1e-5, atol=CONV_ATOL)
    out, ranges = got[0], got[-1]
    assert torch.equal(ranges[:, 0].bfloat16(), out.amax(dim=(1, 2)))
    assert torch.equal(ranges[:, 1].bfloat16(), out.amin(dim=(1, 2)))


def test_bias_in_dtype_matches_flax_conv():
    """The unchunked init conv's call site: `bias_in_dtype` rounds like
    `flax.linen.Conv(dtype=bf16)` (conv output to bf16, then the bf16 bias
    added in bf16), bit for bit."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16, 6)).astype(np.float32)
    conv = fnn.Conv(32, (3, 3), dtype=jnp.bfloat16)
    params = random_flax_params(lambda: conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["bias"] = params["params"]["bias"] * 40.0  # so the bias rounding shows
    want = conv.apply(params, jnp.asarray(x, jnp.bfloat16))
    mod = tb.Conv3x3(6, 32, torch.bfloat16)
    mod.load_state_dict(from_flax(params, device="cpu"))
    with torch.no_grad():
        got = mod(_t(x), bias_in_dtype=True)
        once = mod(_t(x))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert not torch.equal(got, once)  # the flag changes the rounding here


@pytest.mark.parametrize("fp8", ["float8_e4m3fn", "float8_e5m2"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_fp8_storage_follows_jax_overflow_rule(dtype, fp8):
    """float8_e4m3fn has no infinity: JAX makes NaN of what rounds past 448,
    torch saturates. The port's storage cast follows JAX. float8_e5m2 has
    infinities: 57344 is its largest value, from 61440 (the midpoint, a tie
    to the even 2^16) a value rounds to inf, and inf and NaN stay."""
    if fp8 == "float8_e4m3fn":
        vals = [460.0, 500.0, -600.0, 448.0, 464.0, 466.0, -1000.0, 0.3, -2.7e-3, np.inf, np.nan]
    else:
        vals = [57344.0, 61440.0, -61440.0, 6e4, 1e5, 3.0e-5, 1e-6, 0.3, -2.7e-3, np.inf,
                -np.inf, np.nan]
    vals = np.array(vals, np.float32)
    want = np.asarray(jnp.asarray(vals, dtype).astype(getattr(jnp, fp8)).astype(jnp.float32))
    tdt = torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32
    got = cast_storage(torch.from_numpy(vals).to(tdt), getattr(torch, fp8))
    assert got.dtype == getattr(torch, fp8)
    np.testing.assert_array_equal(got.float().numpy(), want)  # NaN where JAX has NaN
    if fp8 == "float8_e4m3fn":
        assert np.isnan(want[[1, 2, 5, 6, 9, 10]]).all() and want[0] == 448.0
    else:
        assert want[0] == want[3] == 57344.0 and np.isnan(want[11])
        assert list(want[[1, 2, 4, 9, 10]]) == [np.inf, -np.inf, np.inf, np.inf, -np.inf]


@pytest.mark.parametrize("special", [None, np.inf, -np.inf, np.nan])
def test_dynamic_amax_of_e5m2_matches_jax(special):
    """The re-anchor amax of an e5m2-stored map, reduced in e5m2 (the low 7
    bits order |x|, inf below NaN): equal to JAX's `jnp.max(jnp.abs(x))`,
    an inf staying inf and a NaN propagating."""
    y = (300.0 * np.random.default_rng(11).normal(size=(2, 8, 8, 16))).astype(np.float32)
    if special is not None:
        y[1, 3, 4, 5] = special
    want = float(jb.dynamic_amax(jnp.asarray(y).astype(jnp.float8_e5m2)))
    got = tb.dynamic_amax(cast_storage(_t(y), torch.float8_e5m2))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(float(got), want)
    if special is not None:
        assert not np.isfinite(want)


def test_quant_site_gate_matches_jax(monkeypatch):
    shapes = [((16, 32, 512, 128), 128, 16), ((16, 4, 64, 2048), 1024, 16),
              ((1, 64, 64, 128), 128, 0), ((1, 63, 64, 128), 128, 0),
              ((16, 64, 1024, 6), 128, 16), ((2, 8, 8, 32), 31, 0), ((4, 2, 32, 32), 32, 4)]
    for env in ({}, {"KDT_QUANT_MIN_PIX": "1", "KDT_QUANT_MIN_CH": "1"},
                {"KDT_QUANT_MIN_PIX": "16384"}):
        for key in ("KDT_QUANT_MIN_PIX", "KDT_QUANT_MIN_CH"):
            monkeypatch.delenv(key, raising=False)
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        for shape, cout, chunks in shapes:
            assert tb._quant_site(shape, cout, chunks) == jb._quant_site(shape, cout, chunks)
    monkeypatch.delenv("KDT_QUANT_MIN_PIX")
    assert tb._quant_site((16, 4, 64, 2048), 1024, 16)  # the flagship's 64² level
    assert not tb._quant_site((16, 64, 1024, 6), 128, 16)  # the init conv
    for val in ("1", "0"):
        monkeypatch.setenv("KDT_QUANT_RANGES", val)
        assert tb.ranges_enabled() == jb.ranges_enabled()


def test_range_helpers_match_jax():
    rng = np.random.default_rng(7)
    y = 3.0 * rng.normal(size=(4, 64, 16)).astype(np.float32)
    ranges = np.stack([y.max(axis=1), y.min(axis=1)], axis=1)
    affine = rng.normal(size=(4, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(float(tb.amax_from_ranges(_t(ranges))),
                               float(jb.amax_from_ranges(jnp.asarray(ranges))), rtol=1e-7)
    np.testing.assert_allclose(float(tb.silu_affine_amax(_t(affine), _t(ranges))),
                               float(jb.silu_affine_amax(jnp.asarray(affine), jnp.asarray(ranges))),
                               rtol=1e-6)
    for big in (100.0, 1000.0):  # 1000 overflows fp8 storage to NaN
        y[1, 2, 3] = big
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float8_e4m3fn, jnp.float8_e4m3fn)):
            want = float(jb.dynamic_amax(jnp.asarray(y, jdt)))
            got = tb.dynamic_amax(cast_storage(_t(y), dt))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(float(got), want)


@pytest.mark.parametrize("chunks", [0, 2])
def test_quant_resnet_block_matches_jax(every_site_quant, chunks):
    """One int8 ResnetBlock with a 1x1 residual projection, its scales from
    the propagated bound: output and carried bound bit-equal to JAX."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2 * max(chunks, 1), 16 // max(chunks, 1), 12, 32)).astype(np.float32)
    temb = rng.normal(size=(2, 24)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jmod = jb.ResnetBlock(48, groups=8, dtype=jnp.bfloat16, chunks=chunks, quant=True)
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(0), jx, jnp.asarray(temb),
                                                  jnp.float32(1.0)))
    want, want_amax = jmod.apply(params, jx, jnp.asarray(temb), jnp.float32(5.0))
    tmod = tb.ResnetBlock(32, 48, 24, groups=8, dtype=torch.bfloat16, quant=True)
    tmod.load_state_dict(from_flax(params, device="cpu"))
    with torch.no_grad():
        got, got_amax = tmod(_t(x, torch.bfloat16), _t(temb), chunks=chunks,
                             a_max=torch.tensor(5.0))
    got, want = _np(got), _np(want)
    assert np.abs(got - want).max() <= 2 * 2.0**-7 * np.abs(want).max()
    assert _normwise(got, want) <= 2.0**-8
    np.testing.assert_allclose(float(got_amax), float(want_amax), rtol=2.0**-8)


@pytest.mark.parametrize("storage", [None, "float8_e4m3fn", "float8_e5m2"])
def test_quant_upsample_matches_jax(every_site_quant, storage):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 2, 8, 32)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = _t(x, torch.bfloat16)
    if storage:
        jx, tx = jx.astype(getattr(jnp, storage)), cast_storage(tx, getattr(torch, storage))
    jmod = jb.Upsample(16, jnp.bfloat16, chunks=2, quant=True)
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(0), jx, jnp.float32(1.0)))
    want, want_amax = jmod.apply(params, jx, jnp.float32(3.5))
    tmod = tb.Upsample(32, 16, torch.bfloat16, quant=True)
    tmod.load_state_dict(from_flax(params, device="cpu"))
    with torch.no_grad():
        got, got_amax = tmod(tx, chunks=2, a_max=torch.tensor(3.5))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert float(got_amax) == float(want_amax)


def _quant_cfg(cls, **kw):
    """The tiny quant U-Net of `tests/test_quant_ranges.py:38` (bf16)."""
    base = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=(2, 3), layer_attns=(False, True),
                layer_cross_attns=(False, True), memory_efficient=True,
                init_conv_to_final_conv_residual=True, lowres_cond=True, quant_conv="int8",
                attn_heads=2, attn_dim_head=8)
    base.update(kw)
    return cls(**base)


def _unet_inputs(cfg, size, batch, seed):
    rng = np.random.default_rng(seed)
    kw = {"x": rng.normal(size=(batch, size, size, 3)).astype(np.float32),
          "time": rng.uniform(0.05, 0.95, size=(batch,)).astype(np.float32)}
    if cfg.lowres_cond:
        kw["lowres_cond_img"] = np.tanh(rng.normal(size=(batch, size, size, 3))).astype(np.float32)
        kw["lowres_noise_times"] = rng.uniform(0, 1, size=(batch,)).astype(np.float32)
    return kw


def _unet_pair(jax_cfg, port_cfg, size, batch, seed, init_conv_out=None):
    """JAX (jitted) and port outputs of the same U-Net, params and inputs.
    With a list `init_conv_out`, also both init convs' outputs, appended."""
    kw = _unet_inputs(port_cfg, size, batch, seed)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jmod = JaxUNet(jax_cfg)
    x, t = jkw.pop("x"), jkw.pop("time")
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(seed), x, t, **jkw), seed)
    apply = functools.partial(jmod.apply, mutable=["intermediates"],
                              capture_intermediates=lambda m, _: m.name == "init_conv")
    want, state = jax.jit(apply)(params, x, t, **jkw)
    want = np.asarray(want, np.float32)
    model = build_model(port_cfg, from_flax(params, device="cpu"))
    captured = []
    hook = model.init_conv.register_forward_hook(lambda m, a, out: captured.append(out))
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        got = model(tkw.pop("x"), tkw.pop("time"), **tkw)
    hook.remove()
    assert got.shape == want.shape and got.dtype == port_cfg.compute_dtype
    if init_conv_out is not None:
        init_conv_out += [_np(captured[0]),
                          _np(state["intermediates"]["init_conv"]["__call__"][0])]
    return _np(got), want


@pytest.mark.parametrize("chunks,storage", [(0, None), (0, "float8_e4m3fn"), (4, None),
                                            (4, "float8_e4m3fn"), (4, "float8_e5m2")])
def test_tiny_quant_unet_matches_jax(every_site_quant, chunks, storage):
    """The whole int8 (+ fp8 storage) U-Net, every conv site quantized, scales
    from propagated ranges: within the stated normwise bound of JAX."""
    kw = dict(spatial_chunks=chunks, storage_dtype=storage)
    got, want = _unet_pair(_quant_cfg(JaxUNetConfig, **kw), _quant_cfg(tcfg.UNetConfig, **kw),
                           32, 2, seed=0)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert _normwise(got, want) <= QUANT_UNET_NORMWISE[storage]


@pytest.mark.parametrize("stage", [1, 2])
def test_bf16_unet_tiny_cascade_matches_jax(stage):
    """The served dtype: the tiny cascade's stages in bf16. Their unchunked
    init conv rounds twice, as `nn.Conv(dtype=bf16)` does: its output is
    bit-equal to JAX's inside the U-Net."""
    jst, tst = jcfg.tiny_test_cascade().stage(stage), tcfg.tiny_test_cascade().stage(stage)
    init = []
    got, want = _unet_pair(dataclasses.replace(jst.unet, dtype="bfloat16"),
                           dataclasses.replace(tst.unet, dtype="bfloat16"),
                           tst.image_size, 2, seed=stage, init_conv_out=init)
    np.testing.assert_array_equal(*init)
    assert _normwise(got, want) <= BF16_UNET_NORMWISE


def test_bf16_unet_flagship_topology_chunked_matches_jax():
    """The flagship stage-3 topology at dim 16 in bf16, row-chunked (2 chunks
    of a 64² crop), against JAX."""
    small = dict(dim=16, spatial_chunks=2)
    jst = jcfg.ultra_res(0, "v_param").stage(3)
    tst = tcfg.ultra_res(0, "v_param").stage(3)
    got, want = _unet_pair(dataclasses.replace(jst.unet, **small),
                           dataclasses.replace(tst.unet, **small), 64, 1, seed=7)
    assert _normwise(got, want) <= BF16_UNET_NORMWISE


@pytest.mark.parametrize("chunks,storage", [(0, None), (4, "float8_e4m3fn")])
def test_propagated_bounds_hold_at_every_site(every_site_quant, monkeypatch, chunks, storage):
    """Port counterpart of `tests/test_quant_ranges.py:112`: every int8 conv
    gets a TRUE bound on its post-prologue input amax, and the bounds stay
    tight (median under 4x, worst under 32x)."""
    records = []
    orig = tb.conv3x3

    def spy(x, w, b=None, **kw):
        if kw.get("quant"):
            if kw.get("a_max") is not None:
                xin = tc3.apply_prologue(x, kw["pro"]) if kw.get("pro") is not None else x
                records.append((float(kw["a_max"]), float(xin.float().abs().max())))
            else:
                records.append(None)
        return orig(x, w, b, **kw)

    monkeypatch.setattr(tb, "conv3x3", spy)
    cfg = _quant_cfg(tcfg.UNetConfig, spatial_chunks=chunks, storage_dtype=storage)
    kw = _unet_inputs(cfg, 32, 2, seed=3)
    params = from_flax(random_flax_params(lambda: JaxUNet(_quant_cfg(
        JaxUNetConfig, spatial_chunks=chunks, storage_dtype=storage)).init(
        jax.random.PRNGKey(0), *(jnp.asarray(kw[k]) for k in ("x", "time")),
        lowres_cond_img=jnp.asarray(kw["lowres_cond_img"]))), device="cpu")
    with torch.no_grad():
        build_model(cfg, params)(torch.from_numpy(kw["x"]), torch.from_numpy(kw["time"]),
                                 lowres_cond_img=torch.from_numpy(kw["lowres_cond_img"]))
    bounded = [r for r in records if r is not None]
    assert len(bounded) >= 15, (len(bounded), len(records) - len(bounded))
    for bound, true in bounded:
        assert np.isfinite(bound)
        assert bound >= true * (1 - 1e-3), (bound, true)
    ratios = sorted(b / max(t, 1e-9) for b, t in bounded)
    assert ratios[len(ratios) // 2] < 4.0, ratios
    assert ratios[-1] < 32.0, ratios


def test_serving_overrides_match_jax():
    for kw in (dict(quant="int8", storage="float8_e4m3fn"), dict(quant="int8"),
               dict(storage="float8_e4m3fn", min_image_size=256), {}):
        want = jcfg.serving_overrides(jcfg.ultra_res(0, "v_param"), **kw)
        got = tcfg.serving_overrides(tcfg.ultra_res(0, "v_param"), **kw)
        assert [(s.unet.quant_conv, s.unet.storage_dtype) for s in got.stages] == \
            [(s.unet.quant_conv, s.unet.storage_dtype) for s in want.stages]
    flagship = tcfg.serving_overrides(tcfg.ultra_res(0, "v_param"), quant="int8",
                                      storage="float8_e4m3fn")
    assert [s.unet.quant_conv for s in flagship.stages] == [None, None, "int8"]


def test_cascade_serves_the_overrides_on_the_cpu(every_site_quant, monkeypatch):
    """`Cascade.sample` through the int8 + fp8 path (overrides on stage 2 of
    the tiny cascade), with CFG's doubled batch as one tensor per forward."""
    cfg = tcfg.serving_overrides(tcfg.tiny_test_cascade(condition_on_text=True),
                                 quant="int8", storage="float8_e4m3fn", min_image_size=32)
    batches = []
    orig = tb.conv3x3

    def spy(x, w, b=None, **kw):
        if kw.get("quant"):
            batches.append(x.shape[0])
        return orig(x, w, b, **kw)

    monkeypatch.setattr(tb, "conv3x3", spy)
    cascade = Cascade(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = [cascade.init_stage_params(n, gen) for n in (1, 2)]
    for p in params:
        p["final_conv.kernel"].normal_(0.0, 0.05, generator=gen)
    text = torch.randn((2, 2, 3), generator=gen)
    out = cascade.sample(params, gen, batch_size=2, text_embeds=text, cond_scale=3.0,
                         ddim_steps=2, output_dtype="uint8")
    assert out.shape == (2, 32, 32, 3) and out.dtype == torch.uint8
    assert batches and set(batches) == {4}  # cond + uncond halves in one tensor


def test_cascade_serves_e5m2_storage_on_the_cpu():
    """`Cascade.sample` with float8_e5m2 activation storage (the CLIs'
    `--activation_storage float8_e5m2`) on the tiny cascade's stage 2:
    every stored map cast as JAX casts it, the re-anchors reduced in e5m2;
    it finishes with a finite image."""
    cfg = tcfg.serving_overrides(tcfg.tiny_test_cascade(), storage="float8_e5m2",
                                 min_image_size=32)
    assert [s.unet.storage_dtype for s in cfg.stages] == [None, "float8_e5m2"]
    cascade = Cascade(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = [cascade.init_stage_params(n, gen) for n in (1, 2)]
    for p in params:
        p["final_conv.kernel"].normal_(0.0, 0.05, generator=gen)
    out = cascade.sample(params, gen, batch_size=2, ddim_steps=2)
    assert out.shape == (2, 32, 32, 3) and torch.isfinite(out).all()
