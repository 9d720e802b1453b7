"""The port's U-Net modules against the JAX package's, on the CPU, in fp32.

Parameters are numpy draws with the names and shapes of a Flax init and are
carried into the port by `convert.from_flax`; inputs are made with numpy
from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu.cascade import Cascade as JaxCascade
from kidney_diffusion_tpu.models import blocks as jb
from kidney_diffusion_tpu.models import configs as jcfg
from kidney_diffusion_tpu.models.unet import EfficientUNet as JaxUNet
from kidney_diffusion_tpu_torch.convert import build_model, from_flax, init_stage_params
from kidney_diffusion_tpu_torch.models import blocks as tb
from kidney_diffusion_tpu_torch.models import configs as tcfg
from test_torch_helpers import one_torch_thread, random_flax_params  # noqa: F401 (autouse)

ATOL = 1e-4


def _port(module, tree):
    module.load_state_dict(from_flax(tree, device="cpu"), strict=True)
    return module.eval()


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("chunks", [0, 2])
@pytest.mark.parametrize("film", [False, True])
def test_gn_film_affine(chunks, film):
    rng = np.random.default_rng(0)
    b, c, npix = 2, 16, 40
    nb = b * max(chunks, 1)
    s1 = _rand(rng, nb, c) * npix
    q = np.abs(_rand(rng, nb, c)) * npix + 1.0
    stats = np.stack([s1, q], axis=1)
    gamma, beta = _rand(rng, c), _rand(rng, c)
    ss = (_rand(rng, b, c), _rand(rng, b, c)) if film else None  # per image
    want = jb.gn_film_affine(jnp.asarray(stats), npix, jnp.asarray(gamma), jnp.asarray(beta),
                             None if ss is None else tuple(map(jnp.asarray, ss)),
                             groups=4, chunks=chunks)
    got = tb.gn_film_affine(torch.from_numpy(stats), npix, torch.from_numpy(gamma),
                            torch.from_numpy(beta),
                            None if ss is None else tuple(map(torch.from_numpy, ss)),
                            groups=4, chunks=chunks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("cin,chunks", [(8, 0), (16, 0), (8, 2)])
def test_resnet_block(cin, chunks):
    rng = np.random.default_rng(1)
    b, h, w, cout, tdim = 2, 8, 6, 16, 12
    x = _rand(rng, b * max(chunks, 1), h // max(chunks, 1), w, cin)
    temb = _rand(rng, b, tdim)  # per image, also in the chunked layout
    jmod = jb.ResnetBlock(cout, groups=4, dtype=jnp.float32, chunks=chunks)
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(temb)))
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(temb))
    tmod = _port(tb.ResnetBlock(cin, cout, tdim, groups=4, dtype=torch.float32), params)
    got = tmod(torch.from_numpy(x), torch.from_numpy(temb), chunks=chunks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_transformer_block_with_context():
    rng = np.random.default_rng(2)
    x, ctx = _rand(rng, 2, 4, 5, 16), _rand(rng, 2, 3, 12)
    jmod = jb.TransformerBlock(heads=2, dim_head=8, ff_mult=2, dtype=jnp.float32)
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(ctx)))
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    tmod = _port(tb.TransformerBlock(16, 12, heads=2, dim_head=8, ff_mult=2,
                                     dtype=torch.float32), params)
    got = tmod(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def test_cross_attention_block():
    rng = np.random.default_rng(3)
    x, ctx = _rand(rng, 2, 4, 4, 16), _rand(rng, 2, 2, 12)
    jmod = jb.CrossAttentionBlock(heads=2, dim_head=8, dtype=jnp.float32)
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(ctx)))
    want = jmod.apply(params, jnp.asarray(x), jnp.asarray(ctx))
    tmod = _port(tb.CrossAttentionBlock(16, 12, heads=2, dim_head=8, dtype=torch.float32),
                 params)
    got = tmod(torch.from_numpy(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def _unet_inputs(unet, size, batch, rng, text_dim):
    kw = {"x": _rand(rng, batch, size, size, 3),
          "time": rng.uniform(0.05, 0.95, size=(batch,)).astype(np.float32)}
    if unet.lowres_cond:
        kw["lowres_cond_img"] = _rand(rng, batch, size, size, 3)
        kw["lowres_noise_times"] = rng.uniform(0, 1, size=(batch,)).astype(np.float32)
    if unet.cond_images_channels:  # half size: exercises the nearest resize
        kw["cond_images"] = rng.uniform(
            size=(batch, size // 2, size // 2, unet.cond_images_channels)).astype(np.float32)
    if text_dim is not None:
        kw["text_embeds"] = _rand(rng, batch, 2, text_dim)
        kw["cond_drop_mask"] = np.array([0.0, 1.0], np.float32)[:batch]
    return kw


def _compare_unet(jax_cfg, port_cfg, size, batch=2, text_dim=None, seed=0):
    rng = np.random.default_rng(seed)
    kw = _unet_inputs(port_cfg, size, batch, rng, text_dim)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jmod = JaxUNet(jax_cfg)
    x, t = jkw.pop("x"), jkw.pop("time")
    params = random_flax_params(lambda: jmod.init(jax.random.PRNGKey(seed), x, t, **jkw), seed)
    want = jax.jit(jmod.apply)(params, x, t, **jkw)
    model = build_model(port_cfg, from_flax(params, device="cpu"))
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with torch.no_grad():
        got = model(tkw.pop("x"), tkw.pop("time"), **tkw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stage", [1, 2])
@pytest.mark.parametrize("variant", ["plain", "text", "cond_images"])
def test_efficient_unet_tiny_cascade(stage, variant):
    kw = {"text": dict(condition_on_text=True),
          "cond_images": dict(cond_images_channels=2)}.get(variant, {})
    jcas, tcas = jcfg.tiny_test_cascade(**kw), tcfg.tiny_test_cascade(**kw)
    st = tcas.stage(stage)
    _compare_unet(jcas.stage(stage).unet, st.unet, st.image_size,
                  text_dim=st.unet.text_embed_dim, seed=stage)


def test_efficient_unet_flagship_topology_chunked():
    """The flagship stage-3 topology (res blocks (2,4,6,8), memory
    efficient, init->final residual, cross-attention at the deepest level)
    at dim 16 on a 64² crop with spatial_chunks=2, so the row-chunked path
    and its halo exchanges are active."""
    jst = jcfg.ultra_res(0, "v_param").stage(3)
    tst = tcfg.ultra_res(0, "v_param").stage(3)
    small = dict(dim=16, spatial_chunks=2, dtype="float32")
    jcfg_small = dataclasses.replace(jst.unet, **small)
    tcfg_small = dataclasses.replace(tst.unet, **small)
    assert 64 % (2 * 2 ** tcfg_small.num_levels) == 0  # the chunked path engages
    _compare_unet(jcfg_small, tcfg_small, 64, batch=1, seed=7)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_flagship_param_names_and_shapes(stage):
    """Every full-width flagship stage: the port's parameter names and shapes
    (made on the meta device, no compute) equal the JAX package's."""
    jcas = JaxCascade(jcfg.ultra_res(0, "v_param"))
    shapes = jax.eval_shape(lambda: jcas.init_stage_params(jax.random.PRNGKey(0), stage))
    want = {".".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = init_stage_params(tcfg.ultra_res(0, "v_param"), stage, device="meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.device.type == "meta" for v in got.values())


def test_param_init_matches_flax_statistics():
    """Fresh port parameters follow the Flax initializers: zero biases and
    final conv, unit norm scales, lecun-normal kernels."""
    cfg = tcfg.tiny_test_cascade(condition_on_text=True)
    p = init_stage_params(cfg, 2, torch.Generator().manual_seed(0), device="cpu")
    assert torch.count_nonzero(p["final_conv.kernel"]) == 0
    assert torch.all(p["down0_block0.block1.norm.scale"] == 1)
    assert torch.all(p["down0_block0.block1.conv.bias"] == 0)
    k = p["up1_block0.block1.conv.kernel"]
    fan_in = 9 * k.shape[2]
    assert abs(k.std().item() * fan_in**0.5 - 1.0) < 0.1
    assert k.abs().max().item() <= 2.0 / 0.8796 / fan_in**0.5 + 1e-6
