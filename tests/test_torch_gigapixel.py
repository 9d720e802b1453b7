"""The port's gigapixel sampler (`kidney_diffusion_tpu_torch/sample/`,
`data/wsi.py`, `cli/sample_ultra_res*.py`) against the JAX package's.

Wavefront plans, crops, strips, the stitch and `get_cond_images` are held
equal to JAX's on the same numpy inputs; one tiny conditioned level runs
through both orchestrators with JAX's noise fed to the port in JAX's chunk
order; the rest holds the port's transports to each other (resident and
uint8 wire bit-equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kidney_diffusion_tpu import cascade as jcas
from kidney_diffusion_tpu.models import configs as jcfg
from kidney_diffusion_tpu.sample import gigapixel as jgp
from kidney_diffusion_tpu.sample import resident as jres
from kidney_diffusion_tpu.sample import wavefront as jwf
from kidney_diffusion_tpu_torch import cascade as tcas
from kidney_diffusion_tpu_torch.convert import from_flax
from kidney_diffusion_tpu_torch.data import wsi as twsi
from kidney_diffusion_tpu_torch.models import configs as tcfg
from kidney_diffusion_tpu_torch.sample import gigapixel as tgp
from kidney_diffusion_tpu_torch.sample import resident as tres
from kidney_diffusion_tpu_torch.sample import wavefront as twf
from test_torch_helpers import one_torch_thread, random_flax_params  # noqa: F401 (autouse)
from test_torch_samplers import Feeder, loop_noise

MAG_SIZES = (256, 128, 32)  # tiny levels: patch width 16 inside a 32² final stage


# ---------------------------------------------------------------------------
# wavefront
# ---------------------------------------------------------------------------


def _sparse(seed=0, n=40, side=10):
    pos = [tuple(int(v) for v in p) for p in np.random.default_rng(seed).integers(0, side, (n, 2))]
    return list(dict.fromkeys(pos))


PATCH_SETS = {
    "full_5": twf.full_grid(5),
    "sparse": _sparse(),
    "single_row": [(0, j) for j in range(6)],
    "single_column": [(i, 2) for i in range(6)],
    "row_with_hole": [(0, 0), (0, 1), (0, 3), (1, 1), (1, 2), (2, 0)],
}


@pytest.mark.parametrize("name", sorted(PATCH_SETS))
def test_wavefront_plans_equal_jax(name):
    pos = PATCH_SETS[name]
    assert twf.choose_orientation(pos) == jwf.choose_orientation(pos)
    for ori in (-1, 1):
        assert twf.ready_patches(pos, ori) == jwf.ready_patches(pos, ori)
        waves = twf.plan_waves(pos, ori)
        assert waves == jwf.plan_waves(pos, ori)
        assert tres.last_use_waves(waves, ori) == jres.last_use_waves(waves, ori)
        assert [twf.deps(p, ori) for p in pos] == [jwf.deps(p, ori) for p in pos]


def test_bucket_size_and_stage_batch_equal_jax():
    for n in list(range(1, 140)) + [255, 256, 257, 1000]:
        assert twf.bucket_size(n) == jwf.bucket_size(n)
    for args in [(64, 32, None, 1), (256, 32, 4, 1), (1024, 32, None, 1), (1024, 32, 2, 1),
                 (1024, 32, 2, 1, False)]:
        assert tgp._stage_batch(*args) == jgp._stage_batch(*args)


# ---------------------------------------------------------------------------
# geometry and crops
# ---------------------------------------------------------------------------


def test_geometry_helpers_equal_jax():
    from kidney_diffusion_tpu.data import wsi as jwsi

    assert (twsi.MAG_LEVEL_SIZES, twsi.AIRS_MAG_LEVEL_SIZES, twsi.PATCH_SIZE, twsi.FILL_COLOR,
            twsi.AIRS_FILL_COLOR) == (jwsi.MAG_LEVEL_SIZES, jwsi.AIRS_MAG_LEVEL_SIZES,
                                      jwsi.PATCH_SIZE, jwsi.FILL_COLOR, jwsi.AIRS_FILL_COLOR)
    for mag in (1, 2):
        for sizes in (jwsi.MAG_LEVEL_SIZES, jwsi.AIRS_MAG_LEVEL_SIZES, MAG_SIZES):
            assert (twsi.inner_patch_width(mag, mag_sizes=sizes)
                    == jwsi.inner_patch_width(mag, mag_sizes=sizes))
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(23, 17, 3)).astype(np.float32)
    for out in [(40, 31), (7, 9), (23, 17)]:
        np.testing.assert_array_equal(twsi.resize_nearest(img, *out), jwsi.resize_nearest(img, *out))
        np.testing.assert_array_equal(tgp.resize_bilinear(img, *out), jgp.resize_bilinear(img, *out))
    batch = rng.integers(0, 256, (3, 48, 48, 6), dtype=np.uint8)
    for size in (16, 32, 48, 96):
        np.testing.assert_array_equal(tgp.resize_nearest_batch(batch, size),
                                      jgp.resize_nearest_batch(batch, size))
    np.testing.assert_array_equal(tgp.to_wire_uint8(img), jgp.to_wire_uint8(img))


@pytest.mark.parametrize("fill", [0.95, 0.0])
def test_crop_with_fill_equals_jax(fill):
    img = np.random.default_rng(1).uniform(size=(40, 44, 3)).astype(np.float32)
    for y0, x0 in [(-8, -8), (13, 11), (30, -2), (-3, 36), (50, 50), (0, 0)]:
        np.testing.assert_array_equal(tgp.crop_with_fill(img, y0, x0, 16, fill),
                                      jgp.crop_with_fill(img, y0, x0, 16, fill))


def test_grid_spec_equals_jax():
    for width, mag, ov, sizes, ps, airs in [
            (1024, 1, 0.25, twsi.MAG_LEVEL_SIZES, 1024, False),
            (6400, 2, 0.25, twsi.MAG_LEVEL_SIZES, 1024, False),
            (1024, 1, 0.25, twsi.AIRS_MAG_LEVEL_SIZES, 1024, True),
            (4000, 2, 0.5, twsi.AIRS_MAG_LEVEL_SIZES, 1024, True),
            (64, 1, 0.25, MAG_SIZES, 32, False)]:
        kw = dict(mag_sizes=sizes, patch_size=ps, airs=airs)
        got = tgp.GridSpec.build(width, mag, ov, **kw)
        assert dataclasses_tuple(got) == dataclasses_tuple(jgp.GridSpec.build(width, mag, ov, **kw))
    # the flagship mag-1 level: 166-pixel patches every 124 pixels, 8 x 8
    assert dataclasses_tuple(tgp.GridSpec.build(1024, 1, 0.25)) == (166, 124, 8, 0.25)


def dataclasses_tuple(g):
    return (g.patch_width, g.patch_dist, g.num_patches_width, g.overlap)


def _tissue_image(size=80, seed=2):
    """A pale image with a tissue-coloured block in one corner region."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 0.95, np.float32)
    img[10:30, 45:70] = (0.6, 0.3, 0.7)
    return np.clip(img + rng.uniform(-0.02, 0.02, img.shape).astype(np.float32), 0, 1)


@pytest.mark.parametrize("case", ["mag1", "center_cond", "no_materialize", "mag2_filter",
                                  "mag2_all_patches", "airs"])
def test_get_cond_images_equals_jax(case):
    zoomed = (np.random.default_rng(3).uniform(size=(64, 64, 3)).astype(np.float32)
              if not case.startswith("mag2") else _tissue_image())
    kw = dict(overlap=0.25, mag_sizes=MAG_SIZES, patch_size=32)
    mag = 2 if case.startswith("mag2") else 1
    kw.update({"center_cond": dict(center_cond=True), "no_materialize": dict(materialize=False),
               "mag2_all_patches": dict(all_patches=True), "airs": dict(airs=True)}.get(case, {}))
    want = jgp.get_cond_images(zoomed, mag, **kw)
    got = tgp.get_cond_images(zoomed, mag, device="cpu", **kw)
    assert got[1] == want[1] and dataclasses_tuple(got[2]) == dataclasses_tuple(want[2])
    if case == "no_materialize":
        assert got[0] is None and want[0] is None
    else:
        np.testing.assert_array_equal(got[0], want[0])
    if case == "center_cond":
        assert got[0].shape[-1] == 6
    if case == "mag2_filter":  # the filter kept some patches and dropped others
        assert 0 < len(got[1]) < got[2].num_patches_width ** 2
        assert tgp.tissue_patch_filter(zoomed, got[2], device="cpu") == jgp.tissue_patch_filter(
            zoomed, want[2])


# ---------------------------------------------------------------------------
# strips and stitch
# ---------------------------------------------------------------------------


def _strip_case(seed=4):
    """A 4 x 4 grid of 8-pixel patches every 6 pixels (so the coarse
    fallback stays inside a 32² cond image), cond images of three patches,
    generated 16² stage outputs of others, as float and uint8 stores."""
    rng = np.random.default_rng(seed)
    grid = tgp.GridSpec(patch_width=8, patch_dist=6, num_patches_width=4, overlap=0.25)
    zoomed = rng.uniform(size=(40, 40, 3)).astype(np.float32)
    conds = {}
    for pos in [(1, 1), (2, 2), (1, 2), (0, 0), (3, 0)]:
        cy, cx = (p * grid.patch_dist + grid.patch_width // 2 for p in pos)
        conds[pos] = tgp.crop_with_fill(zoomed, cy - 16, cx - 16, 32, 0.95)
    gen8 = {p: rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            for p in [(0, 1), (1, 0), (0, 0), (0, 2), (2, 1)]}
    return grid, zoomed, conds, gen8


@pytest.mark.parametrize("orientation", [-1, 1])
@pytest.mark.parametrize("store", ["uint8", "float"])
def test_assemble_inpaint_strips_equals_jax(orientation, store):
    """Generated neighbours, the coarse fallback, the diagonal corner and a
    first patch with no strip, in both sweep directions."""
    grid, _, conds, gen8 = _strip_case()
    gen = gen8 if store == "uint8" else {p: (v / 255.0).astype(np.float16) for p, v in gen8.items()}
    for wave in ([(1, 1)], [(2, 2)], [(1, 2), (3, 0)], [(0, 0)], [(1, 1), (2, 2), (0, 0)]):
        for cond_by_pos in (conds, None):
            want = jgp.assemble_inpaint_strips(wave, gen, cond_by_pos, grid, 16, orientation)
            got = tgp.assemble_inpaint_strips(wave, gen, cond_by_pos, grid, 16, orientation)
            for a, b in zip(got, want):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
    # the first patch of a grid has no strip
    assert tgp.assemble_inpaint_strips([(0, 0)], {}, None, grid, 16, -1) == (None, None)


def test_stitch_patches_equals_jax():
    rng = np.random.default_rng(5)
    zoomed = rng.uniform(size=(50, 50, 3)).astype(np.float32)
    patches = {(0, 0): rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
               (1, 2): rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
               (2, 1): rng.uniform(size=(32, 32, 3)).astype(np.float16)}
    kw = dict(overlap=0.25, num_patches_width=3, patch_size=32)
    got = tgp.stitch_patches(zoomed, patches, **kw)
    assert got.dtype == np.uint8 and got.shape == (80, 80, 3)
    np.testing.assert_array_equal(got, jgp.stitch_patches(zoomed, patches, **kw))


# ---------------------------------------------------------------------------
# the resident engine against the port's host assembly
# ---------------------------------------------------------------------------


def _host_cond(zoomed, grid, pos, ps, center_cond=False):
    """What `get_cond_images` makes for one patch."""
    cy, cx = (p * grid.patch_dist + grid.patch_width // 2 for p in pos)
    cond = tgp.crop_with_fill(zoomed, cy - ps // 2, cx - ps // 2, ps, 0.95)
    if center_cond:
        y0 = (ps - grid.patch_width) // 2
        c = cond[y0:y0 + grid.patch_width, y0:y0 + grid.patch_width]
        up = twsi.resize_nearest(tgp.to_wire_uint8(c), ps, ps).astype(np.float32) / 255.0
        cond = np.concatenate([cond, up], -1)
    return cond


@pytest.mark.parametrize("orientation", [-1, 1])
@pytest.mark.parametrize("center_cond", [False, True])
def test_resident_prep_equals_host_assembly(orientation, center_cond):
    """`prep_chunk` against what the uint8 wire stages on the host: cond
    crops (fill regions included, at the stage size) exact; strips exact
    from generated neighbours and within one count at coarse-fallback
    pixels; masks exact (the diagonal corner leaves the mask); padding
    repeats the last patch. Canvas and stack modes agree."""
    grid, zoomed, _, gen8 = _strip_case()
    ps, hs = 32, 16
    full = twf.full_grid(grid.num_patches_width)
    dev_store = {p: torch.from_numpy(v) for p, v in gen8.items()}
    lowres = {p: torch.full((8, 8, 3), k, dtype=torch.uint8) for k, p in enumerate(full)}
    chunk = [(1, 1), (2, 2), (3, 0)]
    host_cond = {p: _host_cond(zoomed, grid, p, ps, center_cond) for p in full}
    want_img, want_msk = tgp.assemble_inpaint_strips(chunk, gen8, host_cond, grid, hs, orientation)
    want_img, want_msk = tgp.to_wire_uint8(want_img), want_msk.astype(np.uint8)
    want_cond = tgp.to_wire_uint8(tgp.resize_nearest_batch(
        np.stack([host_cond[p] for p in chunk]), hs))
    # fallback pixels: those the same assembly fills from cond images of -1
    marked = tgp.assemble_inpaint_strips(chunk, gen8, {p: np.full_like(c, -1.0) for p, c in
                                                       host_cond.items()}, grid, hs, orientation)
    fallback = marked[0] < 0
    assert fallback.any() and (want_msk > 0).sum() * 3 > fallback.sum()

    common = dict(patch_size=ps, grid=grid, orientation=orientation, device="cpu")
    engines = [
        tres.ResidentEngine(canvas=zoomed, center_cond=center_cond, **common),
        # the stack holds the host's cond images (centre channels included)
        tres.ResidentEngine(cond_stack=np.stack([host_cond[p] for p in full]), patch_pos=full,
                            **common),
    ]
    for engine in engines:
        kw = engine.prep_chunk(chunk, hs, dev_store, lowres, 4, need_cond=True)
        img, msk = kw["inpaint_images"].numpy(), kw["inpaint_masks"].numpy()
        assert img.shape == (4, hs, hs, 3) and msk.dtype == np.uint8
        np.testing.assert_array_equal(kw["cond_images"].numpy()[:3], want_cond)
        np.testing.assert_array_equal(msk[:3], want_msk)
        diff = np.abs(img[:3].astype(int) - want_img.astype(int))
        assert diff[~fallback].max() == 0 and diff[fallback].max() <= 1
        for key in ("cond_images", "inpaint_images", "inpaint_masks", "lowres_image"):
            np.testing.assert_array_equal(kw[key][3].numpy(), kw[key][2].numpy())  # padding
        np.testing.assert_array_equal(kw["lowres_image"][:3].numpy(),
                                      np.stack([lowres[p].numpy() for p in chunk]))
    # no conditioning: only generated neighbours give strips; a diagonal one
    # alone writes its corner and leaves the mask there 0
    i, j = 1, 1
    only_diag = {(i - 1, j + orientation): gen8[(0, 0)]}
    want_img, want_msk = tgp.assemble_inpaint_strips([(i, j)], only_diag, None, grid, hs,
                                                     orientation)
    engine = tres.ResidentEngine(patch_size=ps, grid=grid, orientation=orientation, device="cpu")
    kw = engine.prep_chunk([(i, j)], hs, {p: torch.from_numpy(v) for p, v in only_diag.items()},
                           None, 1, need_cond=False)
    assert "cond_images" not in kw and want_msk.max() == 0 and want_img.max() > 0
    np.testing.assert_array_equal(kw["inpaint_images"].numpy(), tgp.to_wire_uint8(want_img))
    np.testing.assert_array_equal(kw["inpaint_masks"].numpy(), want_msk.astype(np.uint8))


def test_resident_seed_center_crops_equal_host():
    grid, zoomed, _, _ = _strip_case()
    pos = [(0, 0), (2, 3), (3, 3)]
    full = twf.full_grid(grid.num_patches_width)
    stack = np.stack([_host_cond(zoomed, grid, p, 32) for p in full])
    y0 = 16 - grid.patch_width // 2
    for kw in (dict(canvas=zoomed), dict(cond_stack=stack, patch_pos=full)):
        engine = tres.ResidentEngine(patch_size=32, grid=grid, orientation=1, device="cpu", **kw)
        seeds = engine.seed_center_crops(pos)
        for p in pos:
            want = tgp.to_wire_uint8(_host_cond(zoomed, grid, p, 32)[y0:y0 + 8, y0:y0 + 8])
            np.testing.assert_array_equal(seeds[p].numpy(), want)


# ---------------------------------------------------------------------------
# end to end: the port against JAX, and the port's transports
# ---------------------------------------------------------------------------


def _tiny_jax_setup():
    jc = jcas.Cascade(jcfg.tiny_test_cascade(cond_images_channels=3, image_sizes=(16, 32),
                                             timesteps=4))
    params = [random_flax_params(lambda n=n: jc.init_stage_params(jax.random.PRNGKey(0), n), n)
              for n in (1, 2)]
    return jc, params


def _tiny_port(cond_channels=3, num_stages=2):
    """The port's tiny conditioned cascade with random fp32 weights (a
    non-zero final conv) on the CPU."""
    cfg = tcfg.tiny_test_cascade(cond_images_channels=cond_channels, num_stages=num_stages,
                                 image_sizes=(16, 32, 32)[:num_stages], timesteps=4,
                                 objectives=("noise", "v", "v")[:num_stages])
    cas = tcas.Cascade(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = []
    for n in range(1, num_stages + 1):
        ps = cas.init_stage_params(n, gen)
        k = ps["final_conv.kernel"]
        k.copy_(torch.randn(k.shape, generator=gen) / (9 * k.shape[2]) ** 0.5)
        params.append(ps)
    return cas, params


def test_generate_high_res_image_equals_jax(monkeypatch):
    """One tiny conditioned level (64² canvas, 5 x 5 grid, 9 waves, inpaint
    resampling 2) through both orchestrators on the uint8 wire, the port fed
    the normals JAX draws in JAX's chunk order (each chunk's key: low-res
    noise, then the masked loop's). Tolerance: one-ulp fp32 differences of
    the U-Nets can flip a rounding to uint8, and a flipped pixel carries into
    the next stage and the neighbours' strips: at most 2 counts per pixel,
    mean under 0.05 count. Measured: max 1, mean 0.0320 (1572 of the
    49152 values of the 128² canvas differ by one count)."""
    jc, params = _tiny_jax_setup()
    tc = tcas.Cascade(tcfg.tiny_test_cascade(cond_images_channels=3, image_sizes=(16, 32),
                                             timesteps=4), device="cpu")
    zoomed = np.random.default_rng(0).uniform(size=(64, 64, 3)).astype(np.float32)
    kw = dict(overlap=0.25, mag_sizes=MAG_SIZES, progress=False, inpaint_resample_times=2,
              wire="uint8")
    calls = []
    orig = jc.sample_stage

    def spy(p, stage, key, **k):
        calls.append((stage, key, k["batch_size"], "inpaint_images" in k))
        return orig(p, stage, key, **k)

    monkeypatch.setattr(jc, "sample_stage", spy)
    want = jgp.generate_high_res_image(jc, [jax.tree.map(jnp.asarray, p) for p in params],
                                       jax.random.PRNGKey(7), zoomed, 1, **kw)
    draws = []
    for stage, key, b, inpaint in calls:
        size = jc.config.stage(stage).image_size
        shape = (b, size, size, 3)
        k_loop, k_lr = jax.random.split(key)
        if jc.config.stage(stage).lowres_cond:
            draws.append(jax.random.normal(k_lr, shape, jnp.float32))
        draws += loop_noise(k_loop, shape, np.linspace(1, 0, 5)[1:], step_draws=True,
                            inpaint=inpaint, rounds=2)
    assert len({c[2] for c in calls}) >= 3 and any(c[3] for c in calls)
    feeder = Feeder(draws)
    got = tgp.generate_high_res_image(tc, [from_flax(p, device="cpu") for p in params],
                                      feeder, zoomed, 1, **kw)
    feeder.done()
    assert got.shape == want.shape == (128, 128, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean(), (diff > 0).sum())


@pytest.mark.parametrize("center_cond", [False, True])
def test_resident_bit_equal_to_uint8_wire(center_cond):
    """A full tiny grid: the resident transport gives the uint8 wire's bits
    from the same generator seed (same quantization points, same draws);
    the stack mode (materialized cond images uploaded) the canvas mode's."""
    cas, params = _tiny_port(cond_channels=6 if center_cond else 3)
    zoomed = np.random.default_rng(1).uniform(size=(64, 64, 3)).astype(np.float32)
    kw = dict(overlap=0.25, mag_sizes=MAG_SIZES, progress=False, center_cond=center_cond)
    hooks = {w: [] for w in ("uint8", "resident")}
    out = {w: tgp.generate_high_res_image(cas, params, torch.Generator().manual_seed(3), zoomed,
                                          1, wire=w, metrics_hook=lambda **m: hooks[w].append(m),
                                          **kw) for w in ("uint8", "resident")}
    np.testing.assert_array_equal(out["resident"], out["uint8"])
    # the resident final store is evicted as soon as no later wave reads a
    # patch: after the last wave only stage 1's store (cleared next) is held
    assert hooks["resident"][-1]["device_store_entries"] == 25
    assert hooks["uint8"][-1]["device_store_entries"] == 50
    if not center_cond:
        conds, pos, grid = tgp.get_cond_images(zoomed, 1, overlap=0.25, mag_sizes=MAG_SIZES,
                                               patch_size=32)
        common = dict(patch_pos=pos, grid=grid, progress=False, store_dtype=np.uint8)
        a = tgp.generate_patch_set(cas, params, torch.Generator().manual_seed(5),
                                   cond_images=conds, wire="resident", **common)
        b = tgp.generate_patch_set(cas, params, torch.Generator().manual_seed(5),
                                   cond_images=None, wire="resident", zoomed_image=zoomed, **common)
        assert set(a) == set(b) == set(pos)
        for p in pos:
            np.testing.assert_array_equal(a[p], b[p])


def test_ignore_stage_1_on_a_sparse_set():
    """`ignore_stage_1` seeding and a patch set with an interior hole (its
    dependents take coarse-fallback strips): resident within 2.5 counts of
    the uint8 wire (the fallback's fill pixels round within one count, and
    that carries through stage 2's sampling)."""
    cas, params = _tiny_port()
    zoomed = np.random.default_rng(4).uniform(size=(64, 64, 3)).astype(np.float32)
    conds, pos, grid = tgp.get_cond_images(zoomed, 1, overlap=0.25, mag_sizes=MAG_SIZES,
                                           patch_size=32)
    drop = pos[len(pos) // 2]
    keep = [k for k, p in enumerate(pos) if p != drop]
    conds, pos = conds[keep], [pos[k] for k in keep]
    common = dict(patch_pos=pos, grid=grid, inpaint_resample_times=2, ignore_stage_1=True,
                  progress=False)
    seen = []
    orig = cas.sample_stage
    cas.sample_stage = lambda p, n, noise, **k: (seen.append(n), orig(p, n, noise, **k))[1]
    a = tgp.generate_patch_set(cas, params, torch.Generator().manual_seed(5), cond_images=conds,
                               wire="uint8", **common)
    b = tgp.generate_patch_set(cas, params, torch.Generator().manual_seed(5), cond_images=None,
                               wire="resident", zoomed_image=zoomed, **common)
    assert set(seen) == {2} and set(a) == set(b) == set(pos)
    for p in pos:
        assert a[p].dtype == np.float16 and b[p].dtype == np.float16
        np.testing.assert_allclose(a[p].astype(np.float32), b[p].astype(np.float32),
                                   atol=2.5 / 255.0)


def test_cleared_uint8_stores():
    """The uint8 wire stores uint8 between stages (the low-res inputs come
    from uint8 stores) and frees each store once the next stage has read
    it (a three-stage cascade: during stage 3, stage 1's store is gone);
    `max_wave_batch` caps the <= 256² stages' chunks; the public output is
    float16 in [0, 1]."""
    cas, params = _tiny_port(num_stages=3)
    zoomed = np.random.default_rng(6).uniform(size=(64, 64, 3)).astype(np.float32)
    conds, pos, grid = tgp.get_cond_images(zoomed, 1, overlap=0.25, mag_sizes=MAG_SIZES,
                                           patch_size=32)
    calls, hooks = [], []
    orig = cas.sample_stage

    def spy(p, n, noise, **k):
        lr = k.get("lowres_image")
        calls.append((n, k["batch_size"], None if lr is None else lr.dtype))
        return orig(p, n, noise, **k)

    cas.sample_stage = spy
    out = tgp.generate_patch_set(cas, params, torch.Generator().manual_seed(1), patch_pos=pos,
                                 grid=grid, cond_images=conds, wire="uint8", progress=False,
                                 max_wave_batch=2, metrics_hook=lambda **m: hooks.append(m))
    assert {c[2] for c in calls if c[0] > 1} == {np.dtype(np.uint8)}
    assert {c[1] for c in calls} == {1, 2}
    done = 0
    for m in hooks:
        done = done % len(pos) + m["patches"]
        held = {1: done, 2: len(pos) + done, 3: len(pos) + done}[m["stage"]]
        assert m["device_store_entries"] == held, (m, held)
    for p in pos:
        assert out[p].dtype == np.float16
        assert 0.0 <= float(out[p].min()) and float(out[p].max()) <= 1.0


def test_final_stage_batch():
    """`final_stage_batch` raises the chunk of a > 256² final stage (1 by
    default), the batch padded to its bucket, on both transports alike; no
    conditioning (strips from generated neighbours only)."""
    cfg = tcfg.tiny_test_cascade(image_sizes=(16, 264), timesteps=2)
    cas = tcas.Cascade(cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    params = [cas.init_stage_params(n, gen) for n in (1, 2)]
    grid = tgp.GridSpec(patch_width=16, patch_dist=12, num_patches_width=3, overlap=0.25)
    pos = [(0, 0), (0, 1), (1, 0), (1, 1), (2, 0)]
    batches = []
    orig = cas.sample_stage
    cas.sample_stage = lambda p, n, noise, **k: (batches.append((n, k["batch_size"])),
                                                 orig(p, n, noise, **k))[1]
    outs = {}
    for fsb, wire in ((None, "uint8"), (3, "uint8"), (3, "resident")):
        batches.clear()
        outs[fsb, wire] = tgp.generate_patch_set(
            cas, params, torch.Generator().manual_seed(0), patch_pos=pos, grid=grid,
            cond_images=None, wire=wire, progress=False, final_stage_batch=fsb,
            store_dtype=np.uint8)
        waves = twf.plan_waves(pos, twf.choose_orientation(pos))
        want = [twf.bucket_size(len(w)) if fsb else 1 for w in waves for _ in
                range(1 if fsb else len(w))]
        assert [b for n, b in batches if n == 2] == want
        assert [b for n, b in batches if n == 1] == [twf.bucket_size(len(w)) for w in waves]
    assert max(len(w) for w in waves) == 2
    for p in pos:
        assert outs[3, "uint8"][p].shape == (264, 264, 3)
        np.testing.assert_array_equal(outs[3, "resident"][p], outs[3, "uint8"][p])


def test_resident_engine_copies_finals_in_groups():
    """Final patches reach the host in groups of FETCH_BATCH as they are
    handed over and the rest at `finish()`, with their values (as float
    stores too); `mesh` is refused."""
    grid = tgp.GridSpec(patch_width=16, patch_dist=12, num_patches_width=4, overlap=0.25)
    gen = torch.Generator().manual_seed(0)
    patches = {(i, j): torch.randint(0, 256, (8, 8, 3), generator=gen, dtype=torch.uint8)
               for i in range(4) for j in range(3)}
    for store_dtype in (np.uint8, np.float16):
        engine = tres.ResidentEngine(patch_size=32, grid=grid, orientation=-1,
                                     store_dtype=store_dtype, device="cpu")
        for k, (pos, arr) in enumerate(patches.items()):
            engine.enqueue_final(pos, arr)
            assert len(engine.final_host) == (k + 1) // tres.FETCH_BATCH * tres.FETCH_BATCH
        out = engine.finish()
        assert set(out) == set(patches)
        for pos, arr in patches.items():
            assert out[pos].dtype == store_dtype
            want = arr.numpy()
            if store_dtype != np.uint8:
                want = (want.astype(np.float32) / 255.0).astype(store_dtype)
            np.testing.assert_array_equal(out[pos], want)
    cas, _ = _tiny_port()
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        tgp.generate_patch_set(cas, [None, None], torch.Generator(), patch_pos=[(0, 0)],
                               grid=grid, cond_images=None, mesh=object(), progress=False)


def test_stage_model_built_once_and_output_split():
    """`generate_patch_set` builds each stage's model once per level and
    hands it to every chunk; `sample_stage` on a given model equals
    `sample_stage` building its own; `output_split` returns the batch's
    images as a tuple."""
    cas, params = _tiny_port()
    kw = dict(batch_size=2, use_ddim=True, ddim_steps=2, cond_images=torch.rand(2, 16, 16, 3),
              output_dtype="uint8")
    whole = cas.sample_stage(params[0], 1, torch.Generator().manual_seed(0), **kw)
    split = cas.sample_stage(params[0], 1, torch.Generator().manual_seed(0), output_split=True,
                             model=cas.stage_model(params[0], 1), **kw)
    assert isinstance(split, tuple) and len(split) == 2
    np.testing.assert_array_equal(torch.stack(split).numpy(), whole.numpy())

    built, models = [], []
    orig_model, orig_sample = cas.stage_model, cas.sample_stage

    def stage_model(p, n):
        built.append(n)
        return orig_model(p, n)

    def sample_stage(p, n, noise, **k):
        models.append((n, k["model"]))
        return orig_sample(p, n, noise, **k)

    cas.stage_model, cas.sample_stage = stage_model, sample_stage
    zoomed = np.random.default_rng(2).uniform(size=(64, 64, 3)).astype(np.float32)
    for wire in ("uint8", "resident"):
        built.clear(), models.clear()
        tgp.generate_high_res_image(cas, params, torch.Generator().manual_seed(1), zoomed, 1,
                                    overlap=0.25, mag_sizes=MAG_SIZES, progress=False, wire=wire)
        assert built == [1, 2] and len(models) > 4
        for n in (1, 2):
            assert len({id(m) for s, m in models if s == n}) == 1


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module", ["sample_ultra_res", "sample_ultra_res_demo"])
def test_cli_help(module, capsys):
    import importlib

    mod = importlib.import_module(f"kidney_diffusion_tpu_torch.cli.{module}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--ckpt_mag0" in out and "--device" in out


def test_cli_sample_ultra_res_end_to_end(tmp_path, monkeypatch):
    """`cli.sample_ultra_res` on the CPU from tiny checkpoints written by the
    port's `Trainer.save`: `load_level_params` reads the EMA weights of an
    `ema_only` or a full checkpoint and refuses a level missing a stage;
    mag 0, then a mag-1 level on the resident wire, each saved as an image;
    the cascades are tiny configs in place of `ultra_res`, and the level
    sizes shrunk so the tiny mag-0 image holds a 3 x 3 grid."""
    from kidney_diffusion_tpu_torch.cli import sample_ultra_res as cli
    from kidney_diffusion_tpu_torch.train import Trainer

    def tiny(mag, version="v1"):
        return tcfg.tiny_test_cascade(cond_images_channels=3 if mag > 0 else 0,
                                      image_sizes=(16, 32), timesteps=4)

    monkeypatch.setattr(cli, "ultra_res", tiny)
    monkeypatch.setattr(cli, "MAG_LEVEL_SIZES", MAG_SIZES)
    ckpts = []
    for mag in (0, 1):
        trainer = Trainer(tcas.Cascade(tiny(mag), device="cpu"), seed=mag)
        for n in (1, 2):
            with torch.no_grad():
                for v in trainer.state(n).ema_params.values():
                    v.add_(0.25)
        # mag 0 a serving checkpoint, mag 1 a full train state of which only
        # the EMA weights are read
        trainer.save(tmp_path / f"mag{mag}", ema_only=mag == 0)
        ckpts.append(str(tmp_path / f"mag{mag}"))
    _, loaded = cli.load_level_params(ckpts[1], 1, "v_param", device="cpu")
    for n in (1, 2):
        ema = trainer.state(n).ema_params
        assert list(loaded[n - 1]) == list(ema)
        for k, v in ema.items():
            torch.testing.assert_close(loaded[n - 1][k], v, rtol=0, atol=0)
    per_stage = tmp_path / "stage2_only"
    trainer.drop_state(1)
    trainer.save(per_stage)
    with pytest.raises(ValueError, match=r"stages \[1\]"):
        cli.load_level_params(str(per_stage), 1, "v_param", device="cpu")
    out_dir = tmp_path / "samples"
    cli.main(["--ckpt_mag0", ckpts[0], "--ckpt_mag1", ckpts[1], "--ckpt_mag2", "unused",
              "--stop_at_mag", "1", "--device", "cpu", "--seed", "0", "--version", "v_param",
              "--sample_dir", str(out_dir), "--dpmpp_steps", "2", "--ddim_steps", "0"])
    names = sorted(p.name for p in out_dir.iterdir())
    assert len(names) == 2 and names[0].startswith("MAG0-") and names[1].startswith("MAG1-")
    from PIL import Image

    assert Image.open(out_dir / names[1]).size == (80, 80)  # 32 + 2 * 24
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        cli.main(["--ckpt_mag0", ckpts[0], "--ckpt_mag1", ckpts[1], "--ckpt_mag2", "x",
                  "--num_devices", "2", "--device", "cpu", "--sample_dir", str(out_dir)])


def test_smoke_launch_counts_of_the_gigapixel_level():
    """What `chip_smoke.py` requires of request G, one mag-1 level of
    `ultra_res(1, "v_param")` with the int8 + fp8 overrides: 375, 375 and
    256 forwards (15 wave chunks at DPM++-25 for stages 1-2, 64 batch-1
    patches at DDIM-4 for stage 3) and, per kernel, one launch per layer of
    each: none on the WMMA kernel; the narrow kernel takes every init and
    final conv, 2012 launches, 631 of them the Cin-9 init convs of stages 2
    and 3 (3 + 3 low-res + 3 cond channels); the first four patches (G',
    M2) make 100, 100 and 16."""
    import chip_smoke as cs

    cfg = tcfg.serving_overrides(tcfg.ultra_res(1, "v_param"), quant="int8",
                                 storage="float8_e4m3fn")
    forwards = cs.level_forwards(cfg, twf.full_grid(8))
    assert forwards == ((1, 375), (2, 375), (3, 256))
    assert cs.level_forwards(cfg, twf.full_grid(8)[:4]) == ((1, 100), (2, 100), (3, 16))
    want = cs.expected_launches(cfg, forwards)
    assert want == {"conv3x3": 51137, "conv3x3_wide": 49125, "conv3x3_narrow": 1381 + 631,
                    "conv3x3_int8": 27136, "conv3x3_int8_wide": 27136, "attention": 9018}
    assert want["conv3x3_narrow"] == cs.GIGA_NARROW_LAUNCHES
    by_kernel = cs.per_kernel(want)
    assert by_kernel["conv3x3"] == cs.wmma_sites(cfg, forwards) == cs.GIGA_WMMA_LAUNCHES == 0
    assert by_kernel["conv3x3_int8"] == 0
    for n, cin in ((1, 6), (2, 9), (3, 9)):
        unet = cfg.stage(n).unet
        sites = dict(cs.conv_sites(unet, cfg.stage(n).image_size))
        assert sites["init_conv"] == "narrow"
        assert next(m for name, m, *_ in cs.conv_shapes(unet, 64) if name == "init_conv"
                    ).kernel.shape[2] == cin
