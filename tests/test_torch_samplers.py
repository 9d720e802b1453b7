"""The port's schedules, sampling loops and cascade against the JAX package's.

JAX's threefry streams cannot be reproduced in torch, so the port's loops
take their noise from a callable here that hands out, in the port's draw
order, exactly the normals the JAX loop draws — made by repeating the JAX
loop's own `jax.random.split` chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu import cascade as jcas
from kidney_diffusion_tpu.core import diffusion as jdiff
from kidney_diffusion_tpu.core.schedules import GaussianDiffusion as JaxGD
from kidney_diffusion_tpu.models import configs as jcfg
from kidney_diffusion_tpu_torch import cascade as tcas
from kidney_diffusion_tpu_torch.convert import from_flax
from kidney_diffusion_tpu_torch.core import diffusion as tdiff
from kidney_diffusion_tpu_torch.core.schedules import GaussianDiffusion as TorchGD
from kidney_diffusion_tpu_torch.models import configs as tcfg
from test_torch_helpers import one_torch_thread, random_flax_params  # noqa: F401 (autouse)

ATOL = 1e-4


class Feeder:
    """A port noise source that returns prepared arrays in order."""

    def __init__(self, arrays):
        self.arrays = list(arrays)

    def __call__(self, shape):
        a = self.arrays.pop(0)
        assert tuple(a.shape) == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a))

    def done(self):
        assert not self.arrays, f"{len(self.arrays)} draws left over"


def loop_noise(key, shape, t_nexts, *, step_draws, inpaint=False, rounds=1):
    """The normals a JAX sampler loop draws, in the port's draw order."""
    normal = lambda k: jax.random.normal(k, shape, jnp.float32)  # noqa: E731
    key, init_key = jax.random.split(key)
    out = [normal(init_key)]
    rounds = max(rounds, 1) if inpaint else 1
    for t_next in t_nexts:
        if not inpaint:
            key, uk = jax.random.split(key)
            if step_draws:
                out.append(normal(uk))
            continue
        for r in range(rounds):
            key, k1, k2, k3 = jax.random.split(key, 4)
            out.append(normal(k1))
            if step_draws:
                out.append(normal(k2))
            if rounds > 1 and r < rounds - 1 and t_next > 0:
                out.append(normal(k3))
    return out


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_schedules(schedule):
    t = np.linspace(0.0, 1.0, 33, dtype=np.float32)
    tn = np.clip(t - 0.05, 0.0, 1.0)
    rng = np.random.default_rng(0)
    x, n = rng.normal(size=(33, 4, 4, 2)).astype(np.float32), rng.normal(
        size=(33, 4, 4, 2)).astype(np.float32)
    jg, tg = JaxGD(64, schedule), TorchGD(64, schedule)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    T = lambda a: torch.from_numpy(a)  # noqa: E731
    pairs = [
        (jg.log_snr(J(t[1:-1])), tg.log_snr(T(t[1:-1]))),
        (jg.alpha_sigma(J(t))[0], tg.alpha_sigma(T(t))[0]),
        (jg.alpha_sigma(J(t))[1], tg.alpha_sigma(T(t))[1]),
        (jg.q_sample(J(x), J(t), J(n))[0], tg.q_sample(T(x), T(t), T(n))[0]),
        (jg.q_sample_from_to(J(x), J(tn), J(t), J(n)), tg.q_sample_from_to(T(x), T(tn), T(t), T(n))),
        (jg.predict_start_from_noise(J(x), J(t), J(n)), tg.predict_start_from_noise(T(x), T(t), T(n))),
        (jg.predict_start_from_v(J(x), J(t), J(n)), tg.predict_start_from_v(T(x), T(t), T(n))),
        (jg.predict_noise_from_start(J(x), J(t), J(n)), tg.predict_noise_from_start(T(x), T(t), T(n))),
        (jg.calculate_v(J(x), J(t), J(n)), tg.calculate_v(T(x), T(t), T(n))),
        (jg.sampling_time_pairs(), tg.sampling_time_pairs()),
    ]
    half = t[1:] * 0.5  # t_next < t
    post_j = jg.q_posterior(J(x[1:]), J(n[1:]), J(t[1:]), J(half))
    post_t = tg.q_posterior(T(x[1:]), T(n[1:]), T(t[1:]), T(half))
    pairs += list(zip(post_j[:2], post_t[:2]))
    for want, got in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 160, 128, 3)])  # the second subsamples
def test_dynamic_threshold(shape):
    x0 = np.random.default_rng(1).normal(size=shape).astype(np.float32) * 2.0
    want = jdiff.dynamic_threshold(jnp.asarray(x0))
    got = tdiff.dynamic_threshold(torch.from_numpy(x0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _denoisers():
    """The same analytic denoiser in both frameworks: depends on x and t."""
    return (lambda x, t: jnp.tanh(x) * (0.5 + t[:, None, None, None]),
            lambda x, t: torch.tanh(x) * (0.5 + t[:, None, None, None]))


# name: (loop function in both packages, kwargs, whether each update draws noise)
SAMPLERS = {
    "ancestral": ("sample_loop", {}, True),
    "ddim": ("ddim_sample_loop", {"num_steps": 5}, False),
    "ddim_eta": ("ddim_sample_loop", {"num_steps": 5, "eta": 0.5}, True),
    "dpmpp": ("dpmpp_sample_loop", {"num_steps": 6}, False),
}


@pytest.mark.parametrize("inpaint", [False, True])
@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_sampler_loops(sampler, inpaint):
    fn_name, kw, step_draws = SAMPLERS[sampler]
    objective = "v" if sampler == "dpmpp" else "noise"
    shape = (2, 8, 8, 3)
    steps = kw.get("num_steps", 6)
    gd_j, gd_t = JaxGD(steps, "cosine"), TorchGD(steps, "cosine")
    rng = np.random.default_rng(2)
    ikw_j, ikw_t, rounds = {}, {}, 1
    if inpaint:
        rounds = 2
        img = rng.uniform(-1, 1, size=shape).astype(np.float32)
        mask = np.zeros(shape[:3], np.float32)
        mask[:, :, :3] = 1.0
        ikw_j = dict(inpaint_images=jnp.asarray(img), inpaint_masks=jnp.asarray(mask),
                     inpaint_resample_times=rounds)
        ikw_t = dict(inpaint_images=torch.from_numpy(img), inpaint_masks=torch.from_numpy(mask),
                     inpaint_resample_times=rounds)
    key = jax.random.PRNGKey(3)
    jfn, tfn = _denoisers()
    want = getattr(jdiff, fn_name)(gd_j, jfn, shape, key, objective=objective, **kw, **ikw_j)
    t_nexts = np.linspace(1.0, 0.0, steps + 1)[1:]
    feeder = Feeder(loop_noise(key, shape, t_nexts, step_draws=step_draws,
                               inpaint=inpaint, rounds=rounds))
    got = getattr(tdiff, fn_name)(gd_t, tfn, shape, feeder, objective=objective, **kw, **ikw_t)
    feeder.done()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cascade_sample_tiny():
    """Two stages of `tiny_test_cascade` with text conditioning and CFG:
    stage 1 on DPM++, stage 2 on DDIM, uint8 out."""
    jc = jcas.Cascade(jcfg.tiny_test_cascade(condition_on_text=True))
    tc = tcas.Cascade(tcfg.tiny_test_cascade(condition_on_text=True), device="cpu")
    params = [random_flax_params(lambda: jc.init_stage_params(jax.random.PRNGKey(0), n), n)
              for n in (1, 2)]
    text = np.random.default_rng(5).normal(size=(2, 1, 3)).astype(np.float32)
    kw = dict(batch_size=2, cond_scale=3.0, dpmpp_steps=(3, 0), ddim_steps=(0, 2))
    key = jax.random.PRNGKey(11)
    want = jc.sample([jax.tree.map(jnp.asarray, p) for p in params], key,
                     text_embeds=jnp.asarray(text), **kw)

    draws, k = [], key
    for n, steps in ((1, 3), (2, 2)):
        k, sk = jax.random.split(k)
        k_loop, k_lr = jax.random.split(sk)
        size = jc.config.stage(n).image_size
        shape = (2, size, size, 3)
        if n == 2:
            draws.append(jax.random.normal(k_lr, shape, jnp.float32))
        draws += loop_noise(k_loop, shape, np.linspace(1, 0, steps + 1)[1:], step_draws=False)
    feeder = Feeder(draws)
    got = tc.sample([from_flax(p, device="cpu") for p in params], feeder,
                    text_embeds=torch.from_numpy(text), **kw)
    feeder.done()
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    # the uint8 wire out rounds what the float path returns
    feeder = Feeder(draws)
    got_u8 = tc.sample([from_flax(p, device="cpu") for p in params], feeder,
                       text_embeds=torch.from_numpy(text), output_dtype="uint8", **kw)
    assert got_u8.dtype == torch.uint8
    np.testing.assert_array_equal(got_u8.numpy(), np.round(got.numpy() * 255).astype(np.uint8))


def test_stage_sampler_steps_and_wire_helpers():
    assert tcas.stage_sampler_steps((25, 25, 0), 3, 3) == 0
    assert tcas.stage_sampler_steps(4, 2, 3) == jcas.stage_sampler_steps(4, 2, 3)
    with pytest.raises(ValueError):
        tcas.stage_sampler_steps((25, 25), 3, 3)
    x = np.random.default_rng(6).uniform(size=(1, 7, 7, 2)).astype(np.float32)
    for size in (3, 7, 16):
        np.testing.assert_array_equal(
            tcas.resize_image_to(torch.from_numpy(x), size).numpy(),
            np.asarray(jcas.resize_image_to(jnp.asarray(x), size)))
    np.testing.assert_allclose(
        tcas.unnormalize_img(tcas.normalize_img(torch.from_numpy(x))).numpy(), x, atol=1e-6)
