"""The port's training half against the JAX package's, on the CPU, in fp32:
`diffusion_loss`, the linear resize and random crop, `Cascade.stage_loss`
(loss and gradients), the `Trainer`'s update (clipping, Adam, EMA, gradient
accumulation) and its checkpoints.

JAX's threefry draws cannot be reproduced in torch: the port's `stage_loss`
takes the values JAX drew through `draws=`, made here by repeating JAX's key
splits. Parameters are numpy draws with the names and shapes of a Flax init
(`random_flax_params`: no zero-initialised layer, so every gradient is
non-trivial). Tolerance: 1e-4 in fp32, the JAX suite's own (`test_unet.py`).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from kidney_diffusion_tpu import cascade as jcas
from kidney_diffusion_tpu.core import diffusion as jdiff
from kidney_diffusion_tpu.core.schedules import GaussianDiffusion as JaxGD
from kidney_diffusion_tpu.models import configs as jcfg
from kidney_diffusion_tpu.train import trainer as jtrain
from kidney_diffusion_tpu_torch import cascade as tcas
from kidney_diffusion_tpu_torch.convert import from_flax, from_flax_state
from kidney_diffusion_tpu_torch.core import diffusion as tdiff
from kidney_diffusion_tpu_torch.core.schedules import GaussianDiffusion as TorchGD
from kidney_diffusion_tpu_torch.models import configs as tcfg
from kidney_diffusion_tpu_torch.train import Trainer, optim
from kidney_diffusion_tpu_torch.utils import checkpoint as tckpt
from test_torch_helpers import one_torch_thread, random_flax_params  # noqa: F401 (autouse)

ATOL = 1e-4


def jax_draws(cascade, n, key, batch, channels=3):
    """What JAX's `stage_loss` draws from `key`, by the port's names."""
    cfg = cascade.config
    st = cfg.stage(n)
    k_time, k_noise, k_crop, k_aug, k_augn, k_drop = jax.random.split(key, 6)
    side = st.random_crop_size or st.image_size
    shape = (batch, side, side, channels)
    d = {"times": cascade.diffusions[n - 1].sample_random_times(k_time, batch),
         "noise": jax.random.normal(k_noise, shape, jnp.float32)}
    if st.random_crop_size is not None:
        ky, kx = jax.random.split(k_crop)
        hi = st.image_size - st.random_crop_size + 1
        d["crop_ys"] = jax.random.randint(ky, (batch,), 0, hi)
        d["crop_xs"] = jax.random.randint(kx, (batch,), 0, hi)
    if st.unet.lowres_cond:
        d["aug_times"] = jax.random.uniform(k_aug, (batch,), jnp.float32, 0.0,
                                            cfg.lowres_max_aug_level)
        d["aug_noise"] = jax.random.normal(k_augn, shape, jnp.float32)
    if cfg.condition_on_text and st.unet.text_embed_dim is not None:
        d["drop"] = jax.random.bernoulli(k_drop, cfg.cond_drop_prob, (batch,)).astype(jnp.float32)
    return {k: np.array(v) for k, v in d.items()}  # writable copies


def _as_params(tree):
    return {k: nn.Parameter(v) for k, v in from_flax(tree, device="cpu").items()}


# ---- diffusion_loss, resize, crop ------------------------------------------


@pytest.mark.parametrize("objective", ["noise", "v", "x_start"])
def test_diffusion_loss(objective):
    rng = np.random.default_rng(0)
    x0, noise = (rng.normal(size=(3, 6, 5, 2)).astype(np.float32) for _ in range(2))
    t = np.array([0.05, 0.5, 0.93], np.float32)
    w = rng.normal(size=(2,)).astype(np.float32)
    jfn = lambda x, tt: x * w + tt[:, None, None, None]  # noqa: E731
    want = jdiff.diffusion_loss(JaxGD(8, "cosine"), jfn, *map(jnp.asarray, (x0, t, noise)),
                                objective=objective)
    tw = torch.from_numpy(w)
    got = tdiff.diffusion_loss(TorchGD(8, "cosine"), lambda x, tt: x * tw + tt[:, None, None, None],
                               *map(torch.from_numpy, (x0, t, noise)), objective=objective)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("src,dst", [(32, 16), (37, 11), (64, 16), (16, 32), (8, 8)])
def test_linear_resize_matches_jax(src, dst):
    x = np.random.default_rng(src).uniform(size=(2, src, src, 3)).astype(np.float32)
    want = jcas.resize_image_to(jnp.asarray(x), dst, "linear")
    got = tcas.resize_image_to(torch.from_numpy(x), dst, "linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_random_crop_pair_matches_jax():
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(3, 12, 12, c)).astype(np.float32) for c in (3, 2))
    key = jax.random.PRNGKey(4)
    want = jcas._random_crop_pair(key, 5, jnp.asarray(a), jnp.asarray(b))
    ky, kx = jax.random.split(key)
    ys, xs = (torch.from_numpy(np.array(jax.random.randint(k, (3,), 0, 8))) for k in (ky, kx))
    got = tcas.random_crop_pair(ys, xs, 5, torch.from_numpy(a), torch.from_numpy(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- stage_loss: loss and gradients ------------------------------------------


def _stage3_topology(module):
    """The flagship stage-3 U-Net (res blocks (2,4,6,8), memory efficient,
    init->final residual, cross-attention at the deepest level) at dim 16
    with spatial_chunks=2, fp32, trained on a 32² crop of 64² images: 1 row
    per chunk at the deepest level, as the flagship's 256² crop has with 16
    chunks. Stage 2's size sets the low-res conditioning's (16²)."""
    cfg = module.ultra_res(0, "v_param")
    s1, s2, s3 = cfg.stages
    unet = dataclasses.replace(s3.unet, dim=16, spatial_chunks=2, dtype="float32")
    stages = (s1, dataclasses.replace(s2, image_size=16),
              dataclasses.replace(s3, unet=unet, image_size=64, random_crop_size=32))
    return dataclasses.replace(cfg, stages=stages)


def _tiny(module, stage):
    if stage == 1:  # text conditioning with its drop mask, and cond_images
        cfg = module.tiny_test_cascade(condition_on_text=True, cond_images_channels=2)
        return dataclasses.replace(cfg, cond_drop_prob=0.5)
    cfg = module.tiny_test_cascade()  # v objective, low-res conditioning, a crop
    return dataclasses.replace(cfg, stages=(cfg.stages[0], dataclasses.replace(
        cfg.stages[1], random_crop_size=16)))


STAGE_LOSS_CASES = {
    "tiny_stage1_eps_text": (lambda m: _tiny(m, 1), 1, 32, 4),
    "tiny_stage2_v_lowres_crop": (lambda m: _tiny(m, 2), 2, 32, 3),
    "flagship_stage3_topology_chunked": (_stage3_topology, 3, 64, 2),
}


@pytest.mark.parametrize("case", list(STAGE_LOSS_CASES))
def test_stage_loss_and_grads_match_jax(case):
    make, n, size, batch = STAGE_LOSS_CASES[case]
    jc, tc = jcas.Cascade(make(jcfg)), tcas.Cascade(make(tcfg), device="cpu")
    st = tc.config.stage(n)
    if n == 3:  # the chunked path engages at the crop, with 1 row per chunk at the bottom
        crop, levels = st.random_crop_size, st.unet.num_levels
        assert crop % (2 * 2**levels) == 0 and crop // 2**levels // 2 == 1
    rng = np.random.default_rng(len(case))
    images = rng.uniform(size=(batch, size, size, 3)).astype(np.float32)
    kw = {}
    if st.unet.cond_images_channels:
        kw["cond_images"] = rng.uniform(size=(batch, 8, 8, 2)).astype(np.float32)
    if tc.config.condition_on_text:
        kw["text_embeds"] = rng.normal(size=(batch, 2, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    params = random_flax_params(lambda: jc.init_stage_params(jax.random.PRNGKey(0), n), n)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jc.stage_loss(p, n, key, jnp.asarray(images), **jkw)))(params)

    draws = jax_draws(jc, n, key, batch)
    if "drop" in draws:
        assert 0 < draws["drop"].sum() < batch  # both branches of the mask
    tparams = _as_params(params)
    loss = tc.stage_loss(tparams, n, None, torch.from_numpy(images),
                         **{k: torch.from_numpy(v) for k, v in kw.items()}, draws=draws)
    grads = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5, atol=ATOL)
    want = from_flax(want_grads, device="cpu")
    assert set(want) == set(tparams)
    for name, g in zip(tparams, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=ATOL, err_msg=name)
    assert all(g.abs().max() > 0 for g in grads)  # every parameter reached


def test_stage_loss_draws_in_jax_order():
    """Without `draws`, the generator's values go, in JAX's split order, to
    time, noise, crop, aug and aug-noise; with any of them given, the others
    are still drawn."""
    tc = tcas.Cascade(_tiny(tcfg, 2), device="cpu")
    params = tc.init_stage_params(2, torch.Generator().manual_seed(0))
    images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(3)
    expect = {"times": torch.rand((2,), generator=g),
              "noise": torch.randn((2, 16, 16, 3), generator=g),
              "crop_ys": torch.randint(0, 17, (2,), generator=g),
              "crop_xs": torch.randint(0, 17, (2,), generator=g),
              "aug_times": torch.rand((2,), generator=g) * tc.config.lowres_max_aug_level,
              "aug_noise": torch.randn((2, 16, 16, 3), generator=g)}
    with torch.no_grad():
        drawn = tc.stage_loss(params, 2, torch.Generator().manual_seed(3), images)
        given = tc.stage_loss(params, 2, None, images, draws=expect)
    assert torch.equal(drawn, given)
    with pytest.raises(ValueError, match="drop"):
        tc.stage_loss(params, 2, None, images, draws=dict(expect, drop=torch.zeros(2)))


def test_stage_loss_refuses_edm():
    cfg = tcfg.tiny_test_cascade()
    cfg = dataclasses.replace(cfg, stages=(dataclasses.replace(cfg.stages[0], sampler="edm"),
                                           cfg.stages[1]))
    tc = tcas.Cascade(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        tc.stage_loss({}, 1, torch.Generator(), torch.zeros(1, 16, 16, 3))


def test_remat_leaves_loss_and_grads_unchanged():
    """`remat=True` recomputes every ResnetBlock in the backward
    (`torch.utils.checkpoint`): the loss and gradients are bit-equal."""
    results = []
    for remat in (False, True):
        cfg = _tiny(tcfg, 2)
        s2 = cfg.stages[1]
        cfg = dataclasses.replace(cfg, stages=(cfg.stages[0], dataclasses.replace(
            s2, unet=dataclasses.replace(s2.unet, remat=remat))))
        tc = tcas.Cascade(cfg, device="cpu")
        params = {k: nn.Parameter(v) for k, v in tc.init_stage_params(
            2, torch.Generator().manual_seed(0)).items()}
        params["final_conv.kernel"].data.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(2))
        images = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        loss = tc.stage_loss(params, 2, torch.Generator().manual_seed(3), images)
        results.append((loss, torch.autograd.grad(loss, list(params.values()))))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert sum(int(g.abs().max() > 0) for g in g0) == len(g0)


# ---- the optimizer arithmetic -------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 1e-4])  # a small norm shows any epsilon
@pytest.mark.parametrize("ratio", [0.5, 2.0])  # max_norm below / above the norm
def test_clip_by_global_norm_matches_optax(ratio, scale):
    rng = np.random.default_rng(3)
    grads = [(scale * rng.normal(size=s)).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 3))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    max_norm = ratio * norm
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads],
                                                         optax.EmptyState())
    got, got_norm = optim.clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
    np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if ratio > 1:  # below the bound: unchanged, no epsilon
        assert all(torch.equal(g, torch.from_numpy(a)) for g, a in zip(got, grads))


def test_adam_and_ema_match_optax():
    """Three `optax.adam` updates (bias correction at counts 1-3) and the
    JAX trainer's EMA with its warmup decay, from one start."""
    rng = np.random.default_rng(4)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    opt = optax.adam(1e-2, b1=0.9, b2=0.99, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = opt.init(jp)
    jema = dict(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = optim.AdamState.zeros_like(tp)
    tema = {k: v.clone() for k, v in tp.items()}
    for step in range(3):
        g = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        decay = jnp.minimum(0.9999, (1.0 + jnp.float32(step)) / (10.0 + jnp.int32(step)))
        jema = jtrain._ema_update(jema, jp, decay)
        optim.adam_update(tp, [torch.from_numpy(g[k]) for k in tp], ts, 1e-2, 0.9, 0.99, 1e-8)
        d = optim.ema_decay(0.9999, step)
        assert d == float(decay)
        optim.ema_update(tema, tp, d)
    adam = js[0]
    assert int(ts.count) == int(adam.count) == 3
    for k in shapes:
        for got, want in ((tp, jp), (ts.mu, adam.mu), (ts.nu, adam.nu), (tema, jema)):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7)


# ---- the Trainer --------------------------------------------------------------


def test_trainer_steps_match_jax():
    """Three steps of both trainers from one state (carried over by
    `from_flax_state`) on tiny stage 2 (v objective, low-res conditioning
    with noise augmentation), with gradient accumulation over 2 chunks and
    a `max_grad_norm` that clips: losses, parameters, EMA, Adam moments and
    counts agree."""
    n, batch, chunks, max_norm = 2, 4, 2, 0.05
    jc = jcas.Cascade(jcfg.tiny_test_cascade())
    jt = jtrain.Trainer(jc, max_grad_norm=max_norm, grad_accum_chunks=chunks, seed=5)
    params = random_flax_params(lambda: jc.init_stage_params(jax.random.PRNGKey(0), n), 11)
    start = jtrain.StageState(
        params=params, ema_params=jax.tree.map(lambda p: np.array(p, copy=True), params),
        opt_state=jt._optimizer().init(params), step=jnp.zeros((), jnp.int32))
    tt = Trainer(tcas.Cascade(tcfg.tiny_test_cascade(), device="cpu"), max_grad_norm=max_norm,
                 grad_accum_chunks=chunks)
    tt.set_state(n, from_flax_state(jax.device_get(start), device="cpu"))
    jt._states[n] = jt._place_state(start)

    rng = np.random.default_rng(9)
    key = jax.random.PRNGKey(5)  # the JAX trainer's key chain, repeated
    for step in range(3):
        images = rng.uniform(size=(batch, 32, 32, 3)).astype(np.float32)
        key, k = jax.random.split(key)
        draws = [jax_draws(jc, n, ck, batch // chunks) for ck in jax.random.split(k, chunks)]
        want = jt.train_step(n, {"images": images})
        got = tt.train_step(n, {"images": images}, draws=draws)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)
        assert tt.last_grad_norm > max_norm  # the clip engaged
    js, ts = jax.device_get(jt.state(n)), tt.state(n)
    assert ts.step == int(js.step) == 3 == tt.num_steps_taken(n)
    adam = js.opt_state[1][0]
    assert int(ts.opt_state.count) == int(adam.count) == 3
    for got, want in ((ts.params, js.params), (ts.ema_params, js.ema_params),
                      (ts.opt_state.mu, adam.mu), (ts.opt_state.nu, adam.nu)):
        want = from_flax(want, device="cpu")
        assert set(want) == set(got)
        for name, w in want.items():
            np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(), atol=ATOL,
                                       rtol=1e-4, err_msg=name)


def _tiny_trainer(**kw):
    return Trainer(tcas.Cascade(tcfg.tiny_test_cascade(), device="cpu"), **kw)


def _images(seed, batch=2):
    return {"images": np.random.RandomState(seed).rand(batch, 32, 32, 3).astype(np.float32)}


def _trees_equal(a, b):
    fa, fb = tckpt.flatten(a), tckpt.flatten(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


def test_only_train_unet_number_guard():
    tr = _tiny_trainer(only_train_unet_number=2)
    with pytest.raises(ValueError, match="stage 2 only"):
        tr.train_step(1, _images(0))
    with pytest.raises(ValueError, match="stage 2 only"):
        tr.state(1)
    tr.train_step(2, _images(0))
    assert tr.num_steps_taken(2) == 1 and tr.num_steps_taken(1) == 0


def test_checkpoint_round_trip(tmp_path):
    tr = _tiny_trainer(max_grad_norm=1.0)
    for n in (1, 2):
        tr.train_step(n, _images(n))
    tr.save(tmp_path / "ckpt")
    meta = tckpt.load_metadata(tmp_path / "ckpt")
    assert meta["stages"] == [1, 2] and meta["cascade"] == "tiny_test"
    back = _tiny_trainer()
    assert back.load(tmp_path / "ckpt")
    for n in (1, 2):
        assert _trees_equal(back.state(n).tree(), tr.state(n).tree())
        assert all(isinstance(p, nn.Parameter) for p in back.state(n).params.values())
    # the restored trainer trains on from the same point
    tr.generator.manual_seed(1)
    back.generator.manual_seed(1)
    assert tr.train_step(2, _images(7)) == back.train_step(2, _images(7))
    assert _trees_equal(back.state(2).tree(), tr.state(2).tree())


def test_ema_only_checkpoint_merges_partially(tmp_path):
    tr = _tiny_trainer()
    tr.train_step(1, _images(0))
    tr.train_step(1, _images(1))
    tr.save(tmp_path / "full")
    full = {k: v.clone() for k, v in tckpt.flatten(tr.state(1).tree()).items()}
    tr.train_step(1, _images(2))
    tr.save(tmp_path / "ema", ema_only=True)
    raw = tckpt.load_checkpoint(tmp_path / "ema")
    assert set(raw["1"]) == {"ema_params", "step"}
    back = _tiny_trainer()
    back.load(tmp_path / "full")
    with pytest.warns(UserWarning, match="kept the current value"):
        back.load(tmp_path / "ema", partial=True)
    st = back.state(1)
    assert st.step == 3
    assert all(torch.equal(st.ema_params[k], v) for k, v in tr.state(1).ema_params.items())
    now = tckpt.flatten(st.tree())
    for k, v in full.items():  # params and optimizer state: the full checkpoint's
        if not k.startswith(("ema_params", "step")):
            assert torch.equal(now[k], v), k


def test_failed_save_leaves_the_old_checkpoint_loadable(tmp_path, monkeypatch):
    path = tmp_path / "ckpt"
    tr = _tiny_trainer()
    tr.train_step(1, _images(0))
    tr.save(path)
    want = {k: v.clone() for k, v in tr.state(1).params.items()}

    def dying_save(tree, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise RuntimeError("simulated kill mid-save")

    tr.train_step(1, _images(1))
    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        tr.save(path)
    monkeypatch.undo()
    back = _tiny_trainer()
    assert back.load(path)
    assert all(torch.equal(back.state(1).params[k], v) for k, v in want.items())
    tr.save(path)  # the next good save replaces it and clears the leftover
    assert not (tmp_path / "ckpt.tmp_save").exists()
    assert _tiny_trainer().load(path)


def test_load_noop_missing_and_failed_restore(tmp_path):
    tr = _tiny_trainer()
    assert tr.load(tmp_path / "missing", noop_if_not_exist=True) is False
    with pytest.raises(FileNotFoundError):
        tr.load(tmp_path / "missing")
    tr.train_step(1, _images(0))
    tr.save(tmp_path / "ckpt")
    (tmp_path / "ckpt" / tckpt.STATE_NAME).write_bytes(b"corrupt")
    with pytest.raises(RuntimeError, match="after dropping the live state"):
        tr.load(tmp_path / "ckpt")
    assert tr.num_steps_taken(1) == 0  # the live state is gone, as the error says


def test_checkpoint_version_mismatch_warns(tmp_path):
    tr = _tiny_trainer()
    tr.train_step(1, _images(0))
    tr.save(tmp_path / "ckpt")
    meta_path = tmp_path / "ckpt" / tckpt.META_NAME
    meta = json.loads(meta_path.read_text())
    assert meta["version"] == __import__("kidney_diffusion_tpu_torch").__version__
    meta_path.write_text(json.dumps(dict(meta, version="0.0.0-other")))
    with pytest.warns(UserWarning, match="0.0.0-other"):
        assert _tiny_trainer().load(tmp_path / "ckpt")


def test_trainer_sample_uses_ema_weights():
    tr = _tiny_trainer()
    tr.train_step(1, _images(0))
    out = tr.sample(batch_size=1, stop_at_unet_number=1, ddim_steps=2)
    assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()
    assert tr.valid_step(1, _images(1)) > 0


def test_smoke_train_launch_counts():
    """What `chip_smoke.py` requires of each train step per kernel: one
    launch per 3x3 conv and attention layer of the forward at the training
    size (the backward recomputes in plain PyTorch and launches none):
    stage 3 at the 256² crop 106 wgmma + 2 narrow convs and 3
    cross-attentions, stage 1 at 64² 73 + 2 convs and 14 attentions (self and
    cross)."""
    import chip_smoke as cs

    flagship = tcfg.ultra_res(0, "v_param")
    assert cs.train_sites(flagship, 3) == {
        "conv3x3": 108, "conv3x3_wide": 106, "conv3x3_narrow": 2, "conv3x3_int8": 0,
        "conv3x3_int8_wide": 0, "attention": 3}
    assert cs.train_sites(flagship, 1) == {
        "conv3x3": 75, "conv3x3_wide": 73, "conv3x3_narrow": 2, "conv3x3_int8": 0,
        "conv3x3_int8_wide": 0, "attention": 14}


@pytest.mark.parametrize("remat", [False, True])
def test_remat_forward_calls_match_the_smoke_count(remat, monkeypatch):
    """Under `remat` every ResnetBlock's convs run their forward again in the
    backward: the conv forwards of one loss and gradient on the CPU (the
    plain version standing in for the kernel) equal `train_sites`' count."""
    import chip_smoke as cs
    from kidney_diffusion_tpu_torch.kernels import conv3x3 as conv_mod

    cfg = _tiny(tcfg, 2)
    s2 = cfg.stages[1]
    cfg = dataclasses.replace(cfg, stages=(cfg.stages[0], dataclasses.replace(
        s2, unet=dataclasses.replace(s2.unet, remat=remat))))
    calls = []
    plain = conv_mod.conv3x3_plain

    def counted(*args, **kwargs):
        if not torch.is_grad_enabled():  # a forward, not the backward's recompute
            calls.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(conv_mod, "conv3x3_plain", counted)
    tc = tcas.Cascade(cfg, device="cpu")
    params = {k: nn.Parameter(v) for k, v in tc.init_stage_params(
        2, torch.Generator().manual_seed(0)).items()}
    loss = tc.stage_loss(params, 2, torch.Generator().manual_seed(1), torch.rand(1, 32, 32, 3))
    torch.autograd.grad(loss, list(params.values()))
    want = cs.train_sites(dataclasses.replace(cfg, stages=cfg.stages[:2] + (
        dataclasses.replace(cfg.stages[1], image_size=16),)), 2)["conv3x3"]
    assert len(calls) == want
