"""`gsattack_torch.utils.profiling` and `gsattack_torch.utils.viewer`
against their `gsattack` counterparts: the stage timer's counts and
summary, spans named in a written trace, and the viewer's frames over
`localhost`, equal to the port's render in RGB8 and within one RGB8 step
of the JAX viewer's frames for the same scene and requests."""

import json
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from gsattack.utils import profiling as jprof
from gsattack.utils import viewer as jviewer
from gsattack_torch.render import render
from gsattack_torch.utils import profiling as tprof
from gsattack_torch.utils import viewer as tviewer
from tests.conftest import make_toy_camera, make_toy_scene
from tests.torch_port import port_camera, port_scene

torch.set_num_threads(2)


def test_stage_timer_matches_jax():
    timers = (tprof.StageTimer(), jprof.StageTimer())
    x = (torch.ones(8, 8), jax.numpy.ones((8, 8)))
    for t, a in zip(timers, x):
        with t.stage("mul", block_on=None):
            y = a * 2
        with t.stage("mul", block_on=y):
            y = a * 3
        with t.stage("add", block_on={"y": [y]}):
            y = a + 1
    got, want = timers
    assert dict(got.counts) == dict(want.counts) == {"mul": 2, "add": 1}
    assert all(v > 0 for v in got.totals.values())
    lines = got.summary().splitlines()
    assert len(lines) == 2 and {ln.split()[0] for ln in lines} == {"mul", "add"}
    assert all(ln.endswith(("x2", "x1")) for ln in lines)


def test_trace_names_the_spans(tmp_path):
    @tprof.annotate_fn("wrapped-stage")
    def f(a):
        return a + 1

    assert f.__name__ == "f"
    with tprof.trace_to(str(tmp_path)) as prof:
        with tprof.annotate("outer-stage"):
            z = torch.ones(64).sum()
        w = f(z)
    assert float(w) == 65.0
    names = {e["name"] for e in json.loads((tmp_path / tprof.TRACE_FILE).read_text())["traceEvents"]}
    assert {"outer-stage", "wrapped-stage"} <= names
    assert {"outer-stage", "wrapped-stage"} <= {a.key for a in prof.key_averages()}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(serve, scene, requests):
    """Start `serve` in a daemon thread on a free port for len(requests)
    requests, and fetch a frame for each."""
    ready, port = threading.Event(), _free_port()
    t = threading.Thread(target=serve, args=(scene,), daemon=True,
                         kwargs={"port": port, "max_requests": len(requests),
                                 "ready_event": ready})
    t.start()
    assert ready.wait(30)
    frames = [tviewer.request_frame(req, port=port) for req in requests]
    t.join(timeout=30)
    assert not t.is_alive()
    return frames


@pytest.mark.parametrize("scaling", [1.0, 0.7])
def test_viewer_frames_match_render_and_jax(scaling):
    js = make_toy_scene(n=32)
    cams = [make_toy_camera(width=48, height=32, z=0.1 * i) for i in range(2)]
    requests = [{"width": 48, "height": 32, "fovx": 1.0, "fovy": 1.0,
                 "view": np.asarray(c.view).tolist(), "scaling_modifier": scaling} for c in cams]
    scene = port_scene(js)
    got = _serve(tviewer.serve_scene, scene, requests)
    want = _serve(jviewer.serve_scene, js, requests)
    for g, w, c in zip(got, want, cams):
        assert g.shape == (32, 48, 3) and g.dtype == np.uint8 and g.max() > 0
        with torch.no_grad():
            img = render(scene, port_camera(c), torch.zeros(3), scaling_modifier=scaling)["render"]
        np.testing.assert_array_equal(g, (torch.clamp(img, 0, 1) * 255).to(torch.uint8).numpy())
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
