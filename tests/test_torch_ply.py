"""`gsattack_torch.io.ply` against `gsattack.io.ply`: the same scene
written by both packages gives the same bytes, and each package reads the
other's file back exactly."""

import numpy as np
import torch

from gsattack.io.ply import load_scene_ply as j_load
from gsattack.io.ply import save_scene_ply as j_save
from gsattack_torch.io.ply import load_scene_ply as t_load
from gsattack_torch.io.ply import read_ply_vertex_table, save_scene_ply as t_save
from tests.conftest import make_toy_scene
from tests.torch_port import np_, port_scene

torch.set_num_threads(2)


def test_ply_bytes_identical_and_cross_readable(tmp_path):
    js = make_toy_scene(n=20, seed=7)
    js = js.replace(alive=js.alive.at[5].set(False))  # dead rows are dropped
    j_path, t_path = tmp_path / "j.ply", tmp_path / "t.ply"
    j_save(js, str(j_path))
    t_save(port_scene(js), str(t_path))
    assert t_path.read_bytes() == j_path.read_bytes()

    back_t = t_load(str(j_path), device="cpu")
    back_j = j_load(str(t_path))
    assert back_t.num_points == 19 and back_t.active_sh_degree == 3
    for k, v in back_j.params().items():
        np.testing.assert_array_equal(np_(back_t.params()[k]), np.asarray(v), err_msg=k)
    assert read_ply_vertex_table(str(t_path))["obj_dc_15"].shape == (19,)
