"""The plain reference held to the program at a small size on the CPU,
before it judges the program on the card: the render and its gradients,
the detector's loss and image gradient, and the training steps with the
densify statistics, a densify pass and an opacity reset."""

import numpy as np
import pytest
import torch

from portbench import inputs
from portbench.reference import render as R
from portbench.reference.frcnn import ReferenceFasterRCNN

SPEC = {"splats": 2000, "sh_degree": 3, "center": [0.0, 0.0, 6.0], "spread": [2.0, 2.0, 1.0],
        "knn_dist2": 4e-3, "f_rest_std": 0.02, "width": 80, "height": 64, "fov": 1.0,
        "camera_T": [0.0, 0.0, 0.0], "views": 3, "yaw_step_deg": 7}
CPU = torch.device("cpu")


def test_render_and_gradients_match_the_program():
    from gsattack_torch.attack import render_views
    from gsattack_torch.core.camera import stack_cameras

    scene = inputs.synthetic_scene(SPEC, 5, CPU)
    views = inputs.orbit_views(SPEC)
    ref_cams = inputs.reference_cameras(views, SPEC, CPU)
    cams = stack_cameras([inputs.program_extrinsics(Rm, T, SPEC).build(device="cpu")
                          for Rm, T in views])
    pairs = max(R.pairs_per_gaussian(R.project(scene, c, 3), 80, 64) for c in ref_cams)
    bg = torch.tensor([0.1, 0.2, 0.3])

    def grads(render):
        leaves = {k: scene[k].clone().requires_grad_(True) for k in R.PARAM_NAMES}
        img = render({**scene, **leaves})
        g = torch.autograd.grad((img * img).sum(), list(leaves.values()), allow_unused=True)
        return img.detach(), dict(zip(leaves, g))

    ref_img, ref_g = grads(lambda sc: R.render_views(sc, ref_cams, bg, pairs, 128 * 16, 3)["render"])
    prog_img, prog_g = grads(lambda sc: render_views(inputs.program_scene(sc, 3, 3), cams, bg,
                                                     pairs, 16, 128))
    assert float(ref_img.abs().max()) > 0.1
    assert float((ref_img - prog_img).abs().max()) < 1e-5
    for k in ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit"):
        rel = float((ref_g[k] - prog_g[k]).abs().max() / ref_g[k].abs().max().clamp(min=1e-12))
        assert rel < 1e-3, (k, rel)


def test_detector_loss_and_image_gradient_match_the_program():
    from gsattack_torch.models import load_detector

    ref = ReferenceFasterRCNN(80, 256).eval().requires_grad_(False)
    inputs.detector_weights(ref.model, 9, CPU)
    prog = load_detector("detectron2", num_classes=80, num_proposals=256, device="cpu")
    inputs.detector_weights(prog.model, 9, CPU)
    imgs = torch.rand((2, 96, 128, 3), generator=torch.Generator().manual_seed(3))
    boxes = np.array([[10, 12, 90, 80], [20, 8, 120, 70]], np.float32)
    out = []
    for det in (ref, prog):
        x = imgs.clone().requires_grad_(True)
        loss = det.loss(x, 2, boxes)
        out.append((float(loss), torch.autograd.grad(loss, [x])[0]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    assert float((out[0][1] - out[1][1]).abs().max() / out[1][1].abs().max()) < 1e-5


def test_training_steps_match_the_program():
    from conftest import small_cell

    from portbench.drivers.train import Cell

    wl, cfg = small_cell("train")
    cell = Cell(cfg, wl, 2 ** 35 + 1, CPU)
    cell.window(4.0)  # past the first densify pass and opacity reset
    cell.release()
    numbers = cell.numbers(cell.reference())
    assert all(v < 1e-4 for _, v, _ in numbers), numbers
