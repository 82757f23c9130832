"""`gsattack_torch.ops.raster` against `gsattack.ops.raster`: the pair
binning, the plain blend (value and gradients) against the XLA blend and
against the Pallas kernels run in interpret mode, and `render` against the
golden image. Both sides of a blend comparison get the same bins, so
depth ties cannot reorder pairs between them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsattack.ops import raster as jr
from gsattack.ops.project import project as j_project
from gsattack.render import render as j_render
from gsattack_torch.ops import raster as tr
from gsattack_torch.ops.project import ProjectedGaussians, project as t_project
from gsattack_torch.render import render as t_render
from tests.conftest import make_toy_camera, make_toy_scene
from tests.test_golden import GOLDEN
from tests.torch_port import max_rel_err, np_, port_camera, port_scene

torch.set_num_threads(2)


def _proj(n, seed, wh):
    sc = make_toy_scene(n=n, seed=seed)
    cam = make_toy_camera(width=wh[0], height=wh[1])
    return j_project(sc, cam), t_project(port_scene(sc), port_camera(cam))


@pytest.mark.parametrize("pairs,rect", [(16, 0), (6, 16)])
def test_bin_gaussians_matches(pairs, rect):
    wh = (48, 40)
    jp, tp = _proj(96, 6, wh)
    ref = jax.jit(
        lambda p: jr.bin_gaussians(
            p.mean2d, p.depth, p.radius_tight, *wh, pairs, conic=p.conic,
            opacity=p.opacity, rect_candidates=rect,
        )
    )(jp)
    got = tr.bin_gaussians(
        tp.mean2d, tp.depth, tp.radius_tight, *wh, pairs, conic=tp.conic,
        opacity=tp.opacity, rect_candidates=rect,
    )
    starts, ends = np.asarray(ref.tile_start), np.asarray(ref.tile_end)
    np.testing.assert_array_equal(np_(got.tile_start), starts)
    np.testing.assert_array_equal(np_(got.tile_end), ends)
    assert got.gauss_idx.shape[0] == ends[-1]
    np.testing.assert_array_equal(
        np_(got.gauss_idx), np.asarray(ref.gauss_idx)[: ends[-1]]
    )
    assert int(got.num_culled_pairs) == int(ref.num_culled_pairs)
    assert ends[-1] > 100 and (rect == 0 or int(ref.num_culled_pairs) > 0)


def _ref_blend_inputs(seed=8, n=80, wh=(40, 32)):
    """JAX projection + bins of a toy scene, as numpy, and random loss
    weights over the image and transmittance."""
    jp, _ = _proj(n, seed, wh)
    bins = jr.bin_gaussians(
        jp.mean2d, jp.depth, jp.radius_tight, *wh, 16, conic=jp.conic, opacity=jp.opacity
    )
    chans = jnp.concatenate([jp.color, jp.obj], axis=-1)
    leaves = [np.asarray(x) for x in (jp.mean2d, jp.conic, jp.opacity, chans)]
    rng = np.random.default_rng(seed)
    w_img = rng.normal(size=(wh[1], wh[0], chans.shape[1])).astype(np.float32)
    w_t = rng.normal(size=(wh[1], wh[0])).astype(np.float32)
    return bins, leaves, w_img, w_t, wh


def test_blend_plain_matches_xla_blend_value_and_grads():
    bins, leaves, w_img, w_t, (w, h) = _ref_blend_inputs()
    chunk, max_chunks = 16, 8

    def j_loss(m, c, o, col):
        img, T = jr._blend_tiles(bins, m, c, o, col, w, h, chunk, max_chunks)
        return jnp.sum(img * w_img) + jnp.sum(T * w_t), (img, T)

    vg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))
    (_, (img_r, T_r)), g_ref = vg(*map(jnp.asarray, leaves))
    tl = [torch.tensor(x)[None].requires_grad_(True) for x in leaves]
    tx, ty = tr._tiles(w, h)
    img, T = tr.blend_tiles_plain(
        torch.tensor(np.asarray(bins.gauss_idx)), torch.tensor(np.asarray(bins.tile_start))[None],
        torch.tensor(np.asarray(bins.tile_end))[None], *tl, tx, ty, chunk, max_chunks,
    )
    img, T = img[0, :h, :w], T[0, :h, :w]
    np.testing.assert_allclose(np_(img), np.asarray(img_r), atol=2e-5)
    np.testing.assert_allclose(np_(T), np.asarray(T_r), atol=2e-5)
    ((img * torch.tensor(w_img)).sum() + (T * torch.tensor(w_t)).sum()).backward()
    for name, leaf, r in zip(("mean2d", "conic", "opacity", "channels"), tl, g_ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        assert max_rel_err(leaf.grad[0], r) <= 1e-4, name


def test_blend_plain_matches_xla_blend_on_batch_edge_and_cap_tiles():
    """`chip_smoke.edge_tile_inputs` at CH = 3 (tiles of 0, 1, B - 1, B,
    B + 1 pairs for the kernels' staging batches, and of 2047, 2048 and 2049
    around the cap) through the plain blend and the XLA blend, both capped
    at 128 x 16 = 2048 pairs, with the tolerances of the plain-vs-XLA test."""
    import chip_smoke

    e = chip_smoke.edge_tile_inputs(3)
    (tx, ty), chunk, max_chunks = e["tiles"], 128, 16
    w, h = tx * 16, ty * 16
    bins = jr.TileBins(jnp.asarray(e["gauss_idx"]), jnp.asarray(e["tile_start"][0]),
                       jnp.asarray(e["tile_end"][0]), jnp.zeros((), jnp.int32))
    leaves = [e[k][0] for k in ("mean2d", "conic", "opacity", "colors")]
    rng = np.random.default_rng(12)
    w_img = rng.normal(size=(h, w, 3)).astype(np.float32)
    w_t = rng.normal(size=(h, w)).astype(np.float32)

    def j_loss(m, c, o, col):
        img, T = jr._blend_tiles(bins, m, c, o, col, w, h, chunk, max_chunks)
        return jnp.sum(img * w_img) + jnp.sum(T * w_t), (img, T)

    vg = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True))
    (_, (img_r, T_r)), g_ref = vg(*map(jnp.asarray, leaves))
    tl = [torch.tensor(x)[None].requires_grad_(True) for x in leaves]
    img, T = tr.blend_tiles_plain(
        *(torch.from_numpy(e[k]) for k in ("gauss_idx", "tile_start", "tile_end")),
        *tl, tx, ty, chunk, max_chunks,
    )
    np.testing.assert_allclose(np_(img[0]), np.asarray(img_r), atol=2e-5)
    np.testing.assert_allclose(np_(T[0]), np.asarray(T_r), atol=2e-5)
    ((img[0] * torch.tensor(w_img)).sum() + (T[0] * torch.tensor(w_t)).sum()).backward()
    for name, leaf, r in zip(("mean2d", "conic", "opacity", "channels"), tl, g_ref):
        assert np.abs(np.asarray(r)).max() > 0, name
        assert max_rel_err(leaf.grad[0], r) <= 1e-4, name
    # The 2049th pair of the last tile is past the cap: no gradient reaches it.
    past = e["gauss_idx"][e["tile_end"][0, -1] - 1]
    assert all(float(leaf.grad[0, past].abs().max()) == 0.0 for leaf in tl)


def _pallas_pairs(rng, n, ch, tile_x):
    """n random pairs on the 16x16 tile at column `tile_x`: means in and
    around the tile, PD conics, opacities up to 0.999 (so the 0.99 cap
    binds), colours in [0, 1]."""
    mean = rng.uniform(-4, 20, size=(n, 2)).astype(np.float32)
    mean[:, 0] += 16 * tile_x
    a = rng.uniform(0.01, 0.3, size=n)
    c = rng.uniform(0.01, 0.3, size=n)
    b = rng.uniform(-0.5, 0.5, size=n) * np.sqrt(a * c)
    conic = np.stack([a, b, c], axis=1).astype(np.float32)
    op = rng.uniform(0.05, 0.999, size=n).astype(np.float32)
    col = rng.uniform(size=(n, ch)).astype(np.float32)
    return mean, conic, op, col


def test_blend_plain_matches_pallas_interpret_kernels():
    """Two tiles (one and two 128-pair chunks) through the Pallas forward
    and backward kernels in interpret mode, pair for pair."""
    from gsattack.ops.pallas_blend import CHUNK, GEOM_W, pallas_blend_views

    rng = np.random.default_rng(11)
    ch, ch_pad = 19, 24
    counts = (90, 200)
    slots = (0, CHUNK)  # 128-aligned start of each tile in the packed layout
    p_pad = 3 * CHUNK
    mean = np.zeros((p_pad, 2), np.float32)
    conic = np.tile(np.array([[1.0, 0.0, 1.0]], np.float32), (p_pad, 1))
    op = np.zeros(p_pad, np.float32)
    col = np.zeros((p_pad, ch), np.float32)
    for t, (cnt, s0) in enumerate(zip(counts, slots)):
        m, c, o, k = _pallas_pairs(rng, cnt, ch, t)
        mean[s0 : s0 + cnt], conic[s0 : s0 + cnt], op[s0 : s0 + cnt], col[s0 : s0 + cnt] = m, c, o, k
    packed = np.zeros((1, GEOM_W + ch_pad, p_pad), np.float32)
    packed[0, 0:2] = mean.T
    packed[0, 2:5] = conic.T
    packed[0, 5] = op
    packed[0, GEOM_W : GEOM_W + ch] = col.T
    starts = np.array([slots], np.int32)
    ends = np.array([[s + c for s, c in zip(slots, counts)]], np.int32)
    # The kernel's output rows: CH channels, zero padding to CH_pad, then T.
    w_out = np.zeros((1, 2, ch_pad + 1, 256), np.float32)
    w_out[:, :, :ch] = rng.normal(size=(1, 2, ch, 256))
    w_out[:, :, ch_pad] = rng.normal(size=(1, 2, 256))

    def j_loss(pk):
        out = pallas_blend_views(
            pk, jnp.asarray(starts), jnp.asarray(ends), 2, 1, max_chunks=4, interpret=True
        )
        return jnp.sum(out * w_out), out

    (_, out_r), g_ref = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(packed))
    out_r, g_ref = np.asarray(out_r)[0], np.asarray(g_ref)[0]

    idx = np.concatenate([np.arange(s, s + c) for s, c in zip(slots, counts)]).astype(np.int32)
    t_start = np.array([[0, counts[0]]], np.int32)
    t_end = np.array([[counts[0], sum(counts)]], np.int32)
    leaves = [torch.tensor(x)[None].requires_grad_(True) for x in (mean, conic, op, col)]
    img, T = tr.blend_tiles_plain(
        torch.tensor(idx), torch.tensor(t_start), torch.tensor(t_end), *leaves, 2, 1, 128, 4
    )
    # (1, 16, 32, CH) -> per tile (CH + 1, 256), the kernel's layout.
    got = torch.cat([img, T[..., None]], dim=-1)[0].reshape(16, 2, 16, ch + 1)
    got = got.permute(1, 3, 0, 2).reshape(2, ch + 1, 256)
    out_r = np.concatenate([out_r[:, :ch], out_r[:, ch_pad:]], axis=1)
    np.testing.assert_allclose(np_(got), out_r, atol=1e-5)
    w_got = np.concatenate([w_out[0, :, :ch], w_out[0, :, ch_pad:]], axis=1)
    (got * torch.tensor(w_got)).sum().backward()
    rows = {"mean2d": (0, 2), "conic": (2, 5), "opacity": (5, 6), "colors": (GEOM_W, GEOM_W + ch)}
    for (name, (r0, r1)), leaf in zip(rows.items(), leaves):
        g = leaf.grad[0].reshape(p_pad, -1)[idx]
        r = g_ref[r0:r1, idx].T
        assert np.abs(r).max() > 0, name
        assert max_rel_err(g, r) <= 1e-3, name


def test_render_matches_golden():
    sc = make_toy_scene(n=48, seed=42)
    cam = make_toy_camera(width=32, height=32)
    out = t_render(
        port_scene(sc), port_camera(cam), torch.tensor([0.15, 0.25, 0.35]),
        pairs_per_gaussian=16, max_chunks=4,
    )
    with np.load(GOLDEN) as g:
        np.testing.assert_allclose(np_(out["render"]), g["render"], atol=2e-5)
        np.testing.assert_allclose(np_(out["final_transmittance"]), g["transmittance"], atol=2e-5)
        np.testing.assert_array_equal(np_(out["radii"]), g["radii"])
    assert out["render_object"].shape == (32, 32, 16)
    assert out["visibility_filter"].dtype == torch.bool


def test_rasterize_views_matches_reference_and_counts_truncation():
    """Two views in one blend; a tile cap small enough to truncate, so
    num_truncated_pairs must match the reference's count, not vanish."""
    sc = make_toy_scene(n=64, seed=9)
    cams = [make_toy_camera(width=40, height=32, z=z) for z in (0.0, 0.4)]
    bg = np.array([0.2, 0.4, 0.6], np.float32)
    kw = dict(pairs_per_gaussian=16, chunk=8, max_chunks=2)
    refs = [j_render(sc, c, jnp.asarray(bg), **kw) for c in cams]
    ts = port_scene(sc)
    proj = ProjectedGaussians(
        *(torch.stack(f) for f in zip(*(t_project(ts, port_camera(c)) for c in cams)))
    )
    got = tr.rasterize_views(proj, 40, 32, torch.tensor(bg), **kw)
    for key in ("render", "render_object", "final_transmittance"):
        for v, ref in enumerate(refs):
            np.testing.assert_allclose(np_(got[key][v]), np.asarray(ref[key]), atol=2e-5, err_msg=key)
    for key in ("num_culled_pairs", "num_truncated_pairs"):
        assert int(got[key]) == sum(int(r[key]) for r in refs), key
    assert int(got["num_truncated_pairs"]) > 0
    rgb_only = tr.rasterize_views(proj, 40, 32, torch.tensor(bg), with_objects=False, **kw)
    np.testing.assert_allclose(np_(rgb_only["render"]), np_(got["render"]), atol=1e-6)
    assert not rgb_only["render_object"].any()


def test_auto_pairs_per_gaussian_matches():
    jp, tp = _proj(64, 10, (48, 48))
    assert tr.auto_pairs_per_gaussian(tp, 48, 48) == jr.auto_pairs_per_gaussian(jp, 48, 48)
