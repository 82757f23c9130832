"""`chip_smoke.pair_work`, the count of (pixel, pair) work behind the
blend kernels' bounds, against a serial walk of the forward's rules over
every pixel; `chip_smoke.gather_bound`, the row gather's byte bound; and
`chip_smoke.choices`, which pins a detector loss's discrete choices for
phase 6's card-against-CPU gate."""

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(2)


def _serial_walk(gauss_idx, tile_start, tile_end, mean2d, conic, opacity, tiles, cap):
    """Per pixel, pair by pair: the forward's `last` (V, H_pad, W_pad) and
    the counts `pair_work` should give."""
    tiles_x, tiles_y = tiles
    v, n = opacity.shape
    geom = torch.cat([mean2d, conic, opacity[..., None]], -1).reshape(v * n, 6)
    start = tile_start.reshape(-1).long()
    count = (tile_end.reshape(-1).long() - start).clamp(0, cap)
    tid = torch.arange(tiles_x * tiles_y).repeat(v)
    pix = torch.arange(256)
    px = ((tid % tiles_x)[:, None] * 16 + pix % 16).float()
    py = ((tid // tiles_x)[:, None] * 16 + pix // 16).float()
    m = start.shape[0]
    T = torch.ones(m, 256)
    last = torch.zeros(m, 256, dtype=torch.long)
    done = torch.zeros(m, 256, dtype=torch.bool)
    counts = dict(fwd_eval=0, live=0, clamped=0, warp_live=0)
    for k in range(int(count.max())):
        valid = (k < count)[:, None]
        g = geom[gauss_idx[(start + k).clamp(max=gauss_idx.shape[0] - 1)].long()]
        dx, dy = px - g[:, 0:1], py - g[:, 1:2]
        power = -0.5 * (g[:, 2:3] * dx * dx + g[:, 4:5] * dy * dy) - g[:, 3:4] * dx * dy
        alpha_pre = g[:, 5:6] * torch.exp(power.clamp(max=0.0))
        alpha = alpha_pre.clamp(max=0.99)
        counts["fwd_eval"] += int((valid & ~done).sum())
        use = (power <= 0) & (alpha >= 1.0 / 255.0) & valid & ~done
        test = T * (1 - alpha)
        stop = use & (test < 1e-4)
        done |= stop
        comp = use & ~stop
        counts["live"] += int(comp.sum())
        counts["clamped"] += int((comp & (alpha_pre > 0.99)).sum())
        # A warp is a tile's two-row group of 32 pixels (threads 32w..32w+31).
        counts["warp_live"] += int(comp.reshape(m, 8, 32).any(-1).sum())
        T = torch.where(comp, test, T)
        last = torch.where(comp, k + 1, last)
    counts["stops"] = int(done.sum())
    counts["bwd_eval"] = int(last.sum())
    last_img = last.reshape(v, tiles_y, tiles_x, 16, 16).permute(0, 1, 3, 2, 4)
    return last_img.reshape(v, tiles_y * 16, tiles_x * 16).int(), counts


def test_pair_work_matches_serial_walk():
    rng = np.random.default_rng(0)
    v, n, ch, tiles, cap = 2, 60, 3, (2, 2), 50
    mean2d = rng.uniform(-4, 36, size=(v, n, 2))
    a, c = rng.uniform(0.005, 0.03, size=(2, v, n))
    b = rng.uniform(-0.5, 0.5, size=(v, n)) * np.sqrt(a * c)
    conic = np.stack([a, b, c], -1)
    opacity = rng.uniform(0.6, 0.999, size=(v, n))
    colors = rng.uniform(size=(v, n, ch))
    # A quarter centred on pixels at opacity 0.999: clamped where live.
    mean2d[:, :15] = np.round(mean2d[:, :15])
    opacity[:, :15] = 0.999
    # Every gaussian in every tile, in a random order, capped at 50 of 60.
    idx = np.concatenate([rng.permutation(n) + vi * n for vi in range(v) for _ in range(4)])
    tile_start = np.arange(v * 4).reshape(v, 4) * n
    args = [torch.as_tensor(x, dtype=dt) for x, dt in (
        (idx, torch.int32), (tile_start, torch.int32), (tile_start + n, torch.int32),
        (mean2d, torch.float32), (conic, torch.float32), (opacity, torch.float32),
        (colors, torch.float32),
    )]
    last, want = _serial_walk(*args[:6], tiles, cap)
    got = chip_smoke.pair_work(args[:3], args[3:], tiles, cap, last)
    assert got == want
    assert min(want["stops"], want["clamped"]) > 0
    assert want["live"] < want["bwd_eval"] < want["fwd_eval"]
    # Some warp steps have a live lane, and most have several.
    assert 0 < want["warp_live"] < want["live"]


def test_bwd_shuffles_per_live_warp_step():
    assert chip_smoke.bwd_shuffles(19) == (125, 31)
    assert chip_smoke.bwd_shuffles(3) == (45, 16)


def test_edge_tiles_reach_every_batch_edge_and_the_cap():
    """Phase 2b's inputs: each tile's deepest last contributor is its capped
    pair count (the serial walk's `last`), some live pairs pass the 0.99
    cap, and `pair_work` counts them as the serial walk does."""
    e = chip_smoke.edge_tile_inputs(3)
    counts = chip_smoke.edge_tile_counts()
    cap = chip_smoke.CHUNK * chip_smoke.MAX_CHUNKS
    assert counts == [0, 1, 31, 32, 33, 63, 64, 65, cap - 1, cap, cap + 1]
    args = [torch.from_numpy(e[k]) for k in ("gauss_idx", "tile_start", "tile_end",
                                              "mean2d", "conic", "opacity", "colors")]
    assert args[0].shape[0] == sum(counts) and sorted(args[0].tolist()) == list(range(sum(counts)))
    last, want = _serial_walk(*args[:6], e["tiles"], cap)
    deepest = last.reshape(16, len(counts), 16).amax(dim=(0, 2)).tolist()
    assert deepest == [min(c, cap) for c in counts]
    assert want["clamped"] > 0
    assert chip_smoke.pair_work(args[:3], args[3:], e["tiles"], cap, last) == want


def test_gather_bound_counts_index_distinct_row_and_output_bytes():
    # A small example: each index once, each distinct row once, each output row once.
    idx = np.random.default_rng(3).integers(0, 50, size=200).astype(np.int32)
    distinct = np.unique(idx).size
    assert distinct < 50
    nbytes, ms = chip_smoke.gather_bound(torch.from_numpy(idx), 16)
    assert nbytes == 4 * 200 + 4 * 16 * distinct + 4 * 200 * 16
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    # M distinct rows of the micro-bench's sizes: the most the gather can need.
    m, s = chip_smoke.GATHER_M, chip_smoke.GATHER_S
    nbytes, ms = chip_smoke.gather_bound(torch.randperm(m, dtype=torch.int32), 16)
    assert nbytes == 292_773_888 == 4 * m + 2 * 4 * m * 16
    assert ms == pytest.approx(0.0874, abs=5e-5)
    # M uniform indices into S rows, as phase 5 draws them, name about
    # S (1 - exp(-M / S)) distinct rows: ~1.27M of 2.2M.
    idx = torch.randint(0, s, (m,), generator=torch.Generator().manual_seed(5),
                        dtype=torch.int32)
    distinct = (chip_smoke.gather_bound(idx, 16)[0] - 4 * m - 4 * m * 16) // (4 * 16)
    assert distinct == pytest.approx(s * (1 - np.exp(-m / s)), rel=5e-3)
    bounds = {w: round(chip_smoke.gather_bound(idx, w)[1], 4) for w in (16, 32, 40)}
    assert bounds == pytest.approx({16: 0.0693, 32: 0.1360, 40: 0.1693}, abs=2e-4)


@pytest.mark.parametrize("name,kwargs", [
    ("yolov8", dict(num_classes=4, imgsz=64)),
    ("detectron2", dict(num_classes=4, num_proposals=8)),
    ("detr", dict(num_classes=4, num_queries=6)),
])
def test_choices_replay_pins_a_detector_loss(name, kwargs):
    """Replaying a run's recording reproduces its loss call for call; the
    choices of another run (other GT boxes) replayed change the loss, so
    the replay, not a recomputation, decides."""
    from gsattack_torch.models import load_detector

    det = load_detector(name, seed=1, device="cpu", **kwargs)
    rng = np.random.default_rng(0)
    x, y = (torch.tensor(rng.uniform(size=(2, 64, 64, 3)), dtype=torch.float32) for _ in "xy")
    boxes_a = np.array([[4, 4, 60, 50], [10, 8, 40, 62]], np.float32)
    boxes_b = np.array([[30, 34, 44, 52], [0, 0, 24, 20]], np.float32)
    with torch.no_grad():
        with chip_smoke.choices(name) as rec_a:
            loss_a = det.loss(x, 2, boxes_a)
        with chip_smoke.choices(name, replay=rec_a) as used:
            again = det.loss(x, 2, boxes_a)
        with chip_smoke.choices(name) as rec_b:
            loss_b = det.loss(y, 2, boxes_b)
        with chip_smoke.choices(name, replay=rec_a):
            crossed = det.loss(y, 2, boxes_b)
    assert len(rec_a) == len(used) == len(rec_b) > 0
    assert torch.equal(again, loss_a)
    assert chip_smoke.choices_differing(rec_a, used) == 0
    assert chip_smoke.choices_differing(rec_a, rec_b) > 0
    assert not torch.equal(crossed, loss_b)


def test_colmap_model_writer_reads_back(tmp_path):
    """Phase 7b's COLMAP text model: the views come back from
    `load_scene_info` within 1e-6, the points as written (float32) and the
    colours as bytes; the orbiting views give a nonzero nerf++ radius."""
    from gsattack_torch.attack import expand_viewpoints
    from gsattack_torch.core.camera import CameraExtrinsics
    from gsattack_torch.io import load_scene_info

    base = CameraExtrinsics(np.eye(3), np.array([0.0, 0.0, 6.0]), 1.0, 0.8, 48, 40)
    exts = expand_viewpoints([base], 5)
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    chip_smoke.write_colmap_model(str(tmp_path), exts, pts, cols)
    info = load_scene_info(str(tmp_path), shuffle=False)
    assert [c.image_name for c in info.train_cameras] == [f"view_{i:03d}" for i in range(5)]
    assert chip_smoke.cameras_err(info.train_cameras, exts) <= 1e-6
    assert chip_smoke.cameras_err(info.train_cameras[:4], exts) == np.inf
    np.testing.assert_array_equal(info.points, pts)
    np.testing.assert_array_equal(info.colors, np.round(cols * 255) / np.float32(255))
    assert info.nerf_normalization["radius"] > 1.0
    assert all(c.image is None for c in info.train_cameras)


def test_train_config_scales_the_schedule_only():
    """Phase 7b's `TrainConfig`: configs/config.yaml's values (the
    defaults), with only the schedule cut, the position rate scaled by the
    extent and the densify threshold moved from NDC to pixel units; every
    schedule event falls inside the run and SH reaches degree 3."""
    import dataclasses
    import os

    import yaml

    from gsattack_torch.train import TrainConfig

    with open(os.path.join(chip_smoke.ROOT, "configs", "config.yaml")) as f:
        yml = yaml.safe_load(f)
    default = TrainConfig()
    shared = [f.name for f in dataclasses.fields(TrainConfig) if f.name in yml]
    assert len(shared) >= 20
    for name in shared:
        assert getattr(default, name) == yml[name], name
    cfg = chip_smoke.train_config(2.5, 800)
    changed = {f.name for f in dataclasses.fields(TrainConfig)
               if getattr(cfg, f.name) != getattr(default, f.name)}
    assert changed == set(chip_smoke.TRAIN_REDUCED) | {"spatial_lr_scale",
                                                      "densify_grad_threshold"}
    for name, (was, here) in chip_smoke.TRAIN_REDUCED.items():
        assert getattr(default, name) == was and getattr(cfg, name) == here, name
    assert cfg.spatial_lr_scale == 2.5 and cfg.densify_grad_threshold == pytest.approx(5e-7)
    assert cfg.densify_from_iter < cfg.densify_until_iter <= cfg.iterations
    assert cfg.opacity_reset_interval < cfg.densify_until_iter
    assert 3 * cfg.sh_increase_interval <= cfg.iterations


def test_loss_fell_compares_the_first_and_last_windows():
    falling = np.linspace(1.0, 0.1, 200)
    assert chip_smoke.loss_fell(falling)[0]
    assert not chip_smoke.loss_fell(falling[::-1])[0]
    fell, first, last = chip_smoke.loss_fell(np.r_[np.ones(50), np.full(100, 5.0), np.ones(50)])
    assert not fell and first == last == 1.0
