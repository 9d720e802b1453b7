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
from test_torch_helpers import one_torch_thread  # noqa: F401 (autouse)

CONV_ATOL = 1e-3  # as tests/test_kernels.py holds Pallas to XLA
ATTN_ATOL = 2e-5

# name: (batch, rows, width, cin, cout, prologue, stats, chunks, bias scale)
CONV_CASES = {
    "prologue_stats": (2, 8, 16, 8, 16, True, True, 0, 1.0),
    "border_rows": (1, 2, 5, 3, 3, True, True, 0, 1.0),
    "chunked": (2, 4, 12, 8, 6, True, True, 4, 1.0),
    "chunked_one_row": (1, 1, 8, 4, 4, False, True, 8, 1.0),
    "no_bias_no_stats": (1, 6, 7, 6, 5, False, False, 0, 0.0),
    # the conditioned init convs' widths (the narrow kernel's folded K of 81
    # and 108)
    "cin9_chunked": (2, 4, 12, 9, 16, False, True, 4, 1.0),
    "cin12_prologue_stats": (2, 8, 16, 12, 16, True, True, 0, 1.0),
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


@pytest.mark.parametrize("case", ["prologue_stats", "border_rows", "chunked", "cin9_chunked",
                                  "cin12_prologue_stats"])
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


def _flagship_conv_sites():
    """(stage, name, Cin, Cout, bias_in_dtype) of every Conv3x3 of the
    flagship's three U-Nets, built on the meta device."""
    from kidney_diffusion_tpu_torch.convert import build_model
    from kidney_diffusion_tpu_torch.models.blocks import Conv3x3
    from kidney_diffusion_tpu_torch.models.configs import ultra_res

    cfg = ultra_res(0, "v_param")
    sites = []
    for n in (1, 2, 3):
        unet = cfg.stage(n).unet
        for name, mod in build_model(unet).named_modules():
            if isinstance(mod, Conv3x3):
                # the unchunked init conv rounds its bias in bf16 (`unet.py`)
                bid = name == "init_conv" and not unet.spatial_chunks
                sites.append((n, name, mod.kernel.shape[2], mod.kernel.shape[3], bid))
    return sites


def test_conv_routing_over_the_flagship_sites():
    """The card's conv kernels split the flagship's 3x3 convs by a pure
    function of (Cin, Cout, quant, bias_in_dtype): in bf16, 237 wide sites
    go to the wgmma kernel and the 6 narrow ends (init and final convs, the
    unchunked init conv with its bf16-bias rounding) to the narrow kernel;
    the 106 int8 sites of the served config go to the wgmma int8 kernel; no
    flagship site goes to the WMMA kernel, which keeps ragged widths. The
    conditioned configs' init convs (Cin 9, 10, 12) go to the narrow kernel
    too, so no site of a conditioned config goes to the WMMA kernel."""
    import chip_smoke as cs
    from kidney_diffusion_tpu_torch.models.configs import serving_overrides, ultra_res

    sites = _flagship_conv_sites()
    routes = [tc3.route(cin, cout, bias_in_dtype=bid) for _, _, cin, cout, bid in sites]
    assert routes.count("wgmma") == 237 and routes.count("narrow") == 6
    by_stage = {n: sum(r == "wgmma" for (s, *_), r in zip(sites, routes) if s == n)
                for n in (1, 2, 3)}
    assert by_stage == {1: 73, 2: 58, 3: 106}
    for (_, name, cin, cout, bid), r in zip(sites, routes):
        assert (r == "narrow") == (name in ("init_conv", "final_conv")), name
        assert tc3.route(cin, cout, bias_in_dtype=True) == ("narrow" if r == "narrow" else "wmma")
        assert bid <= (r == "narrow")
        if r == "wgmma":
            assert tc3.route(cin, cout, quant=True) == "wgmma_int8"
    served = serving_overrides(ultra_res(0, "v_param"), quant="int8", storage="float8_e4m3fn")
    kinds = {n: [k for _, k in cs.conv_sites(served.stage(n).unet, served.stage(n).image_size)]
             for n in (1, 2, 3)}
    assert kinds[3].count("wgmma_int8") == 106 and kinds[3].count("narrow") == 2
    assert not any(k in ("wmma", "wmma_int8") for ks in kinds.values() for k in ks)
    # ragged widths stay on the WMMA kernel, in both modes
    assert tc3.route(96, 96) == tc3.route(96, 96, quant=True) == "wmma"
    assert tc3.route(16, 32) == tc3.route(3, 40) == tc3.route(48, 3) == "wmma"
    # the conditioned init convs: Cin 9 (3 + 3 low-res + 3 cond), 10
    # (patch_conditioned's labelmap) and 12 (v2's 6 cond channels)
    for bid in (False, True):
        assert [tc3.route(c, 128, bias_in_dtype=bid) for c in (9, 10, 12)] == ["narrow"] * 3
        assert tc3.route(9, 256, bias_in_dtype=bid) == "narrow"
        assert tc3.route(17, 128, bias_in_dtype=bid) == "wmma"
    from kidney_diffusion_tpu_torch.models.configs import kumar, patch_conditioned

    conditioned = [ultra_res(m, v) for m in (1, 2) for v in ("v1", "v2", "v_param", "airs")]
    conditioned += [patch_conditioned(), kumar(),
                    serving_overrides(ultra_res(1, "v_param"), quant="int8",
                                      storage="float8_e4m3fn")]
    init_cin = set()
    for cfg in conditioned:
        for st in cfg.stages:
            sites = dict(cs.conv_sites(st.unet, st.image_size))
            assert "wmma" not in sites.values() and "wmma_int8" not in sites.values(), cfg.name
            assert sites["init_conv"] == "narrow"
            init_cin.add(build_init_cin(st.unet))
    assert {9, 10, 12} <= init_cin


def build_init_cin(unet):
    """Cin of a U-Net config's init conv (built on the meta device)."""
    from kidney_diffusion_tpu_torch.convert import build_model

    return build_model(unet).init_conv.kernel.shape[2]


def test_smoke_launch_counts_of_the_served_requests():
    """What `chip_smoke.py` requires of requests A (bf16) and C (int8 + fp8
    stage 3) per conv kernel, derived from the layers: A makes 3807 bf16
    launches, 3699 on the wgmma kernel and 108 on the narrow one; C 3383
    bf16 (3275 wgmma + 108 narrow) and 424 int8, all on the wgmma int8
    kernel; neither request leaves a launch to the WMMA kernel."""
    import chip_smoke as cs
    from kidney_diffusion_tpu_torch.models.configs import serving_overrides, ultra_res

    flagship = ultra_res(0, "v_param")
    want_a = cs.expected_launches(flagship, cs.FORWARDS_A)
    served = serving_overrides(flagship, quant="int8", storage="float8_e4m3fn")
    want_c = cs.expected_launches(served, cs.FORWARDS_A)
    assert want_a == {"conv3x3": 3807, "conv3x3_wide": 3699, "conv3x3_narrow": 108,
                      "conv3x3_int8": 0, "conv3x3_int8_wide": 0, "attention": 562}
    assert want_c == {"conv3x3": 3383, "conv3x3_wide": 3275, "conv3x3_narrow": 108,
                      "conv3x3_int8": 424, "conv3x3_int8_wide": 424, "attention": 562}
    for want in (want_a, want_c):
        by_kernel = cs.per_kernel(want)
        assert by_kernel["conv3x3"] == by_kernel["conv3x3_int8"] == 0
    assert {k: want_a[k] for k in ("conv3x3_wide", "conv3x3_narrow", "conv3x3_int8_wide")} == {
        "conv3x3_wide": cs.WIDE_LAUNCHES["A"], "conv3x3_narrow": cs.NARROW_LAUNCHES["A"],
        "conv3x3_int8_wide": cs.INT8_WIDE_LAUNCHES["A"]}
    assert {k: want_c[k] for k in ("conv3x3_wide", "conv3x3_narrow", "conv3x3_int8_wide")} == {
        "conv3x3_wide": cs.WIDE_LAUNCHES["C"], "conv3x3_narrow": cs.NARROW_LAUNCHES["C"],
        "conv3x3_int8_wide": cs.INT8_WIDE_LAUNCHES["C"]}


def test_wide_tiles_fit_the_kernel():
    """Every wgmma tile is 128 or 256 pixels of one batch item, a whole
    number of 8-pixel rows, with a halo'd patch inside the kernel's patch
    buffer (264 or 396 pixels); each flagship map gets the tile that covers
    it fewest times."""
    for rows, width in [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 64), (8, 128),
                        (16, 256), (32, 512), (64, 1024), (128, 128), (256, 256), (5, 130)]:
        for pixels, tiles, patch in ((128, tc3.WIDE_TILES, 264), (256, tc3.WIDE_TILES_256, 396)):
            th, tw = tc3.wide_tile(rows, width, pixels)
            assert th * tw == pixels and tw % 8 == 0 and (th + 2) * (tw + 2) <= patch
            n = -(-rows // th) * -(-width // tw)
            assert n == min(-(-rows // a) * -(-width // b) for a, b in tiles)
    assert tc3.wide_tile(4, 64) == (4, 32)  # stage 3's skip concat: 2 tiles, not 4
    # 256-pixel tiles of 128 channels where a 128-pixel tile's patch keeps
    # its blocks one to an SM, and the larger tiles still give ~a wave
    assert tc3.wide_config(16, 4, 64, 2048, 1024) == (4, 64, 128, 1)  # case (e)
    assert tc3.wide_config(16, 32, 512, 128, 128) == (8, 16, 128, 1)  # case (a)
    assert 6 * 34 > tc3.TWO_PER_SM_PATCH >= 10 * 18  # 4 x 32 tiles: one an SM; 8 x 16: two
    assert tc3.wide_config(1, 16, 16, 768, 768) == (8, 16, 64, 6)  # case (c)
    assert tc3.wide_config(1, 128, 128, 128, 128) == (8, 16, 64, 1)
    assert tc3.wide_bn(128, 16, 128) == 128 and tc3.wide_bn(2, 1, 768) == 64
    assert tc3.wide_bn(4096, 1, 320) == 64  # an odd multiple of 64
    # a split over K only where the tiles fill under half the card; every
    # split a nonempty run of whole 64-channel slices
    assert tc3.wide_split(128, 16, 128, 128, 128) == 1
    assert tc3.wide_split(2, 1, 768, 64, 768) == 6  # case (c): 24 -> 144 blocks
    for blocks in range(1, 70):
        for slices in (2, 12, 16, 24, 32):
            k = tc3.wide_split(blocks, 1, 64, 64, 64 * slices)
            per = -(-slices // k)
            assert 1 <= k <= slices and (k - 1) * per < slices
            assert k == 1 or k == slices or blocks * k >= 66


@pytest.mark.parametrize("pixels", [128, 256])
@pytest.mark.parametrize("rows,width", [(7, 40), (4, 64), (8, 8), (3, 130)])
def test_conv3x3_wide_tile_slots_finish_to_plain_stats(rows, width, pixels):
    """The wgmma kernel writes one [sum z, sum z^2] slot per `wide_tile` of
    128 or 256 pixels, over its valid pixels; summed and finished by the
    wrapper they give the plain stats."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, rows, width, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 4, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    _, want = tc3.conv3x3(x, w, b, want_stats=True)
    z = tc3.conv3x3(x, w, None).double()
    th, tw = tc3.wide_tile(rows, width, pixels)
    slots = [torch.stack([t.sum((1, 2)), (t * t).sum((1, 2))], 1)
             for y0 in range(0, rows, th) for x0 in range(0, width, tw)
             for t in [z[:, y0:y0 + th, x0:x0 + tw]]]
    s = torch.stack(slots, 1).sum(1).float()
    got = tc3.finish_stats(s[:, 0], s[:, 1], rows * width, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-3)


def flash_attention_emulation(q, k, v, tile=64, first=0):
    """The CUDA kernel's algorithm in plain PyTorch: q scaled in its dtype,
    64-key tiles taken from tile `first` on (a block of the kernel starts at
    its query tile's index, modulo the tile count), fp32 scores, a running
    max and sum, P = exp(s - running max) rounded to v's dtype before P.V,
    O normalised once at the end."""
    scale = q.shape[-1] ** -0.5
    qs = (q * scale).float().permute(0, 2, 1, 3)  # (B, H, Nq, D)
    kf, vf = (t.float().permute(0, 2, 1, 3) for t in (k, v))
    b, h, nq, d = qs.shape
    m = torch.full((b, h, nq, 1), -float("inf"))
    l = torch.zeros((b, h, nq, 1))
    acc = torch.zeros((b, h, nq, d))
    n_tiles = -(-kf.shape[2] // tile)
    for t in range(n_tiles):
        k0 = (t + first) % n_tiles * tile
        s = qs @ kf[:, :, k0:k0 + tile].transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(v.dtype).float() @ vf[:, :, k0:k0 + tile]
        m = m_new
    return (acc / l).to(v.dtype).permute(0, 2, 1, 3)


# name: (batch, nq, nk, heads, dim_head) — the card's cases, narrowed
FLASH_CASES = {
    "self_plus_context": (1, 200, 202, 2, 64),
    "two_tiles_of_keys": (1, 70, 100, 2, 64),
    "ragged_queries_two_keys": (1, 130, 2, 2, 64),
    "cross_four_keys": (1, 96, 4, 2, 64),
    "head_width_32": (2, 96, 98, 2, 32),
}


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_emulation_matches_plain_within_attn_tol(case, first):
    """The blockwise online softmax with bf16-rounded P that the CUDA
    kernel runs agrees with `attention_plain` within `chip_smoke.ATTN_TOL`
    on bf16 inputs (the one accepted rounding deviation), whichever tile a
    block starts at (a partial last tile first included)."""
    import chip_smoke as cs

    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(*FLASH_CASES[case], seed=7))
    got = flash_attention_emulation(q, k, v, first=first)
    ref = tatt.attention_plain(q, k, v)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    cs.check(case, got.float(), ref.float(), cs.ATTN_TOL)


# (Cin, Cout) of the flagship stage 3's int8 sites, and a Cin that ends in
# a half slice of 64 channels
INT8_WIDTHS = [(128, 128), (256, 128), (256, 256), (512, 256), (512, 512), (1024, 512),
               (1024, 1024), (2048, 1024), (192, 128)]


@pytest.mark.parametrize("cin,cout", INT8_WIDTHS)
def test_kmajor_int8_weights_read_back_in_kernel_order(cin, cout):
    """The wgmma int8 kernel reads its K-major weights as 16-byte chunks
    w_k[((tap * Cout + n) * Cin + 128 s + 16 c) ...] for slice s, output
    channel n and chunk c, zero-filling chunks past Cin. Read back in that
    order the layout gives `quantize_weights(w)` exactly."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32)).bfloat16()
    wq, _ = tc3.quantize_weights(w)
    flat = tc3.kmajor_weights(wq).reshape(-1)
    nsl = -(-cin // tc3.WIDE_KC[True])
    tap = torch.arange(9)[:, None, None, None, None]
    n = torch.arange(cout)[None, :, None, None, None]
    s = torch.arange(nsl)[None, None, :, None, None]
    c = torch.arange(8)[None, None, None, :, None]
    e = torch.arange(16)[None, None, None, None, :]
    ci = 128 * s + 16 * c + e
    inside = (128 * s + 16 * c < cin).expand(9, cout, nsl, 8, 16)
    got = flat[((tap * cout + n) * cin + ci.clamp(max=cin - 1)).reshape(-1)].reshape(inside.shape)
    got = torch.where(inside, got, torch.zeros((), dtype=torch.int8))
    want = wq.reshape(9, cin, cout).permute(0, 2, 1)  # [tap, n, ci]
    want = torch.nn.functional.pad(want, (0, nsl * 128 - cin)).reshape(9, cout, nsl, 8, 16)
    assert torch.equal(got, want)


def _flagship_deep_int8_splits():
    """The splits over K `wide_config(quant=True)` picks at the flagship's
    maps: none at stage 3's int8 sites (16 row chunks fill the card, at the
    256² crop too); 2-8 at the small deep maps of stages 1 and 2."""
    import chip_smoke as cs
    from kidney_diffusion_tpu_torch.models.configs import serving_overrides, ultra_res

    served = serving_overrides(ultra_res(0, "v_param"), quant="int8", storage="float8_e4m3fn")
    unet = served.stage(3).unet
    for size in (256, 1024):
        for nb, rows, width, cin, cout in _conv_shapes(unet, size):
            if tc3.route(cin, cout, quant=True) == "wgmma_int8":
                assert tc3.wide_config(nb, rows, width, cin, cout, True)[3] == 1
    splits = set()
    for n, size in ((1, 64), (2, 256)):
        for nb, rows, width, cin, cout in _conv_shapes(served.stage(n).unet, size):
            if tc3.route(cin, cout, quant=True) == "wgmma_int8":
                k = tc3.wide_config(nb, rows, width, cin, cout, True)[3]
                if k > 1:
                    splits.add((k, cin))
    return sorted(splits)


def _conv_shapes(unet, size):
    """(nb, rows, width, Cin, Cout) of each Conv3x3 of a forward at size x
    size, by `chip_smoke.conv_shapes`' level rule."""
    import chip_smoke as cs

    for _, mod, (nb, rows, width, cin), _ in cs.conv_shapes(unet, size):
        yield nb, rows, width, cin, mod.kernel.shape[3]


def test_flagship_int8_splits_are_known():
    got = _flagship_deep_int8_splits()
    assert {k for k, _ in got} == {2, 3, 4, 6, 8}


@pytest.mark.parametrize("ksplit,cin", [(2, 512), (3, 768), (4, 1024), (6, 768), (6, 1536), (8, 1024),
                                        (8, 2048), (2, 192)])
def test_int8_split_k_int32_partials_finish_bit_equal(ksplit, cin):
    """The wgmma int8 kernel's split over K: each split sums its run of
    128-channel slices exactly in int32, the finishing kernel adds the
    int32 partials and dequantizes as float32(acc) * (s_a * s_w), then adds
    the bias. Emulated here, that is the unsplit exact sum, and the output
    is bit-equal to `conv3x3_plain(quant=True)` (no tolerance: integer sums
    are exact and the fp32 steps are the same). The cases are the splits
    `wide_config(quant=True)` picks at the flagship's deep maps (with the
    Cin they come with) and a half slice."""
    assert (ksplit, cin) in _flagship_deep_int8_splits() or cin == 192
    rng = np.random.default_rng(ksplit * 7 + cin)
    cout = 8
    x = torch.from_numpy(rng.normal(size=(2, 4, 5, cin)).astype(np.float32)).bfloat16()
    w = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / (9 * cin) ** 0.5)
                         .astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    a_max = 1.25 * x.float().abs().amax()
    want = tc3.conv3x3_plain(x, w, b, quant=True, a_max=a_max)
    s_a = tc3.activation_scale(x, a_max)
    wq, s_w = tc3.quantize_weights(w)
    q = torch.clamp(torch.round(x.float() / s_a), -127, 127).double().permute(0, 3, 1, 2)
    wk = wq.double().permute(3, 2, 0, 1)
    nsl = -(-cin // 128)
    kps = -(-nsl // ksplit)
    assert (ksplit - 1) * kps < nsl  # no split is empty
    acc = torch.zeros((2, cout, 4, 5), dtype=torch.int32)
    for k in range(ksplit):
        lo, hi = k * kps * 128, min((k + 1) * kps * 128, cin)
        part = torch.nn.functional.conv2d(q[:, lo:hi], wk[:, lo:hi], padding=1)
        assert part.abs().max() < 2**31
        acc += part.to(torch.int32)  # an int32 partial, summed in int32
    z = acc.permute(0, 2, 3, 1).float() * (s_a * s_w)
    got = (z + b).to(torch.bfloat16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["final", "init", "init_cin9"])
@pytest.mark.parametrize("rows,width", [(7, 40), (5, 130), (9, 70), (3, 200)])
def test_conv3x3_narrow_tile_slots_finish_to_plain_stats(rows, width, kind):
    """The narrow kernel writes one [sum z, sum z^2] and one [max, min] slot
    per tile over its valid pixels: 4 x 64 tiles for the final conv,
    `narrow_in_tile`'s tiles for the init conv (128 pixels at Cout 64, 64
    at the Cin-9 case's Cout 256). Summed (and max/min'ed) by the wrapper
    they give the plain stats and ranges, at widths that leave partial
    tiles. Stats to 1e-4 relative (fp32 sums in another order, as the
    wide-tile test); ranges exactly."""
    cin, cout = {"final": (64, 3), "init": (6, 64), "init_cin9": (9, 256)}[kind]
    assert tc3.route(cin, cout) == "narrow"
    rng = np.random.default_rng(rows * width)
    x = torch.from_numpy(rng.normal(size=(2, rows, width, cin)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(cout,)).astype(np.float32))
    _, want, want_rng = tc3.conv3x3(x, w, b, want_stats=True, want_range=True)
    z = tc3.conv3x3(x, w, None).double()
    th, tw = (tc3.NARROW_OUT_TILE if kind == "final"
              else tc3.narrow_in_tile(rows, width, cout))
    tiles = [z[:, y0:y0 + th, x0:x0 + tw] for y0 in range(0, rows, th)
             for x0 in range(0, width, tw)]
    assert len(tiles) == -(-rows // th) * -(-width // tw)
    s = torch.stack([torch.stack([t.sum((1, 2)), (t * t).sum((1, 2))], 1) for t in tiles],
                    1).sum(1).float()
    got = tc3.finish_stats(s[:, 0], s[:, 1], rows * width, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-3)
    # range mode 1 (with stats): [max, min] of fp32 z per tile, + bias after
    hi = torch.stack([t.amax((1, 2)) for t in tiles], 1).amax(1).float() + b
    lo = torch.stack([t.amin((1, 2)) for t in tiles], 1).amin(1).float() + b
    assert torch.equal(torch.stack([hi, lo], 1), want_rng)


def test_narrow_in_tiles_fit_the_kernel():
    """The narrow init conv's tile holds 128 / `narrow_in_groups(Cout)`
    pixels (so its staged output, all Cout channels, is at most 32 KB), a
    power-of-two number of columns and a halo'd patch of at most 264
    pixels; each map gets the tile that covers it fewest times."""
    for cout, groups in ((64, 1), (128, 1), (192, 2), (256, 2), (320, 4), (512, 4)):
        assert tc3.narrow_in_groups(cout) == groups
        pixels = 128 // groups
        assert pixels * cout * 2 <= 32 * 1024
        for rows, width in [(64, 1024), (256, 256), (64, 64), (5, 37), (9, 20), (1, 8), (7, 130)]:
            th, tw = tc3.narrow_in_tile(rows, width, cout)
            assert th * tw == pixels and tw & (tw - 1) == 0 and (th + 2) * (tw + 2) <= 264
            n = -(-rows // th) * -(-width // tw)
            assert n == min(-(-rows // a) * -(-width // b) for a, b in tc3.NARROW_IN_TILES[pixels])
    assert tc3.narrow_in_tile(64, 1024, 128) == (8, 16)  # stage 3's init conv: 128-pixel tiles


def _bfrag(w, ks_n):
    """The kernel's fill of its B fragments: element i = (ks * n16 + q) *
    32 + l of the fragment array holds, for n8 blocks 2q + hb, column n =
    (2q + hb) * 8 + l // 4, rows k0 + {0, 1, 8, 9} with k0 = ks * 16 + 2 (l
    % 4), zeros past K."""
    cin, cout = w.shape[2], w.shape[3]
    wf = w.reshape(9 * cin, cout)
    n16 = cout // 16
    frag = torch.zeros((ks_n * n16 * 32, 8), dtype=w.dtype)
    for i in range(ks_n * n16 * 32):
        l, kq = i & 31, i >> 5
        ks, q = divmod(kq, n16)
        k0 = ks * 16 + 2 * (l & 3)
        for hb in range(2):
            n = (2 * q + hb) * 8 + (l >> 2)
            for e in range(4):
                k = k0 + (e & 1) + (e >> 1) * 8
                if k < 9 * cin:
                    frag[i, 4 * hb + e] = wf[k, n]
    return frag


def _koff(cin, ks_n, pw):
    """The kernel's table of A offsets: entry (t4, ks) packs the byte
    offsets of k = ks * 16 + 2 t4 + {0, 1} (.x) and + {8, 9} (.y)."""
    run = pw * cin
    table = []
    for t in range(4):
        row = []
        for ks in range(ks_n):
            o = []
            for e in range(4):
                k = ks * 16 + 2 * t + (e & 1) + (e >> 1) * 8
                tap, ci = divmod(k, cin)
                o.append(2 * ((tap // 3) * run + (tap % 3) * cin + ci) if k < 9 * cin else 0)
            assert max(o) < 2**16
            row.append((o[0] | o[1] << 16, o[2] | o[3] << 16))
        table.append(row)
    return table


@pytest.mark.parametrize("cin", [3, 6, 8, 9, 10, 12, 16])
def test_narrow_in_folded_k_layout_gathers_to_the_plain_conv(cin):
    """Rebuild the narrow init conv's operands in torch exactly as the
    kernel indexes them: its B fragments read back as `mma.sync.m16n8k16`
    takes them (lane (g, t4): column g, rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4
    + 9) give B[k, n] = w[k // Cin, k % Cin, n], zero past K; each pixel's
    A row gathered from the halo'd patch through the packed `koff` table
    (the 16-bit halves added to the pixel's byte offset, twice, in one
    32-bit add) is its 3 x 3 x Cin receptive field in k order. Then A @ B
    over the tile is the plain conv (float64: exact up to summation
    order)."""
    cout, (th, tw) = 32, (8, 16)
    rng = np.random.default_rng(cin)
    w = torch.from_numpy(rng.normal(size=(3, 3, cin, cout)))
    x = torch.from_numpy(rng.normal(size=(1, th, tw, cin)))
    ks_n, pw, k_n = -(-9 * cin // 16), tw + 2, 9 * cin
    # B, read back from the fragments the way each lane feeds the MMA
    frag, n16 = _bfrag(w, ks_n), cout // 16
    b = torch.full((ks_n * 16, cout), float("nan"), dtype=torch.float64)
    for ks in range(ks_n):
        for q in range(n16):
            for lane in range(32):
                g, t4 = lane >> 2, lane & 3
                f = frag[(ks * n16 + q) * 32 + lane]
                for hb in range(2):
                    n = (2 * q + hb) * 8 + g
                    for e, dk in enumerate((0, 1, 8, 9)):
                        b[ks * 16 + 2 * t4 + dk, n] = f[4 * hb + e]
    want_b = torch.zeros_like(b)
    want_b[:k_n] = w.reshape(9 * cin, cout)
    assert torch.equal(b, want_b)
    # A, gathered through koff from the patch (SAME padding zeros around x)
    patch = torch.nn.functional.pad(x[0], (0, 0, 1, 1, 1, 1)).reshape(-1)
    assert patch.numel() == (th + 2) * pw * cin <= 264 * 16
    koff = _koff(cin, ks_n, pw)
    a = torch.zeros((th * tw, ks_n * 16), dtype=torch.float64)
    for m in range(th * tw):
        pb = 0x10001 * 2 * cin * ((m // tw) * pw + m % tw)
        for t4 in range(4):
            for ks in range(ks_n):
                for half, dk in enumerate((0, 8)):
                    o = pb + koff[t4][ks][half]
                    assert (pb & 0xFFFF) + (koff[t4][ks][half] & 0xFFFF) < 2**16  # no carry
                    for e, off in enumerate((o & 0xFFFF, o >> 16)):
                        assert off % 2 == 0
                        a[m, ks * 16 + 2 * t4 + dk + e] = patch[off // 2]
    # each valid k reads the pixel's receptive field in (tap, ci) order
    field = torch.stack([torch.nn.functional.pad(x[0], (0, 0, 1, 1, 1, 1))[
        m // tw:m // tw + 3, m % tw:m % tw + 3].reshape(-1) for m in range(th * tw)])
    assert torch.equal(a[:, :k_n], field)
    got = (a @ b).reshape(1, th, tw, cout)
    want = tc3.conv3x3_plain(x.float(), w.float())  # fp32 sums in another order
    np.testing.assert_allclose(got.numpy(), want.double().numpy(), rtol=1e-5, atol=1e-4)
