"""Network viewer: a socket server that answers a viewer's frame requests
with renders of a scene. Port of `gsattack/utils/viewer.py`, with the same
JSON protocol:

request (one JSON line):
  {"width": W, "height": H, "fovx": f, "fovy": f,
   "view": [[...4x4...]], "scaling_modifier": 1.0}
response: 4-byte little-endian length + raw RGB8 (H*W*3) frame.

`serve_scene` runs a blocking single-client loop (run it in a daemon
thread); `request_frame` is the matching client. Frames are rendered by
`render` on the scene's device, so by the blend's CUDA kernels on a card.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Optional

import numpy as np
import torch

from ..core.camera import ZFAR, ZNEAR, Camera
from ..core.scene import GaussianScene
from ..core.transforms import perspective_projection_matrix
from ..render import render


def camera_from_request(req: dict, device: torch.device) -> Camera:
    """The camera a request describes, on `device`."""
    view = np.asarray(req["view"], np.float32).reshape(4, 4)
    proj = perspective_projection_matrix(
        req.get("znear", ZNEAR), req.get("zfar", ZFAR), req["fovx"], req["fovy"]
    )
    full = (proj @ view).astype(np.float32)
    cam_center = np.linalg.inv(view)[:3, 3].astype(np.float32)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        view=t(view), full_proj=t(full), cam_center=t(cam_center),
        tanfovx=t(np.tan(req["fovx"] * 0.5)), tanfovy=t(np.tan(req["fovy"] * 0.5)),
        width=int(req["width"]), height=int(req["height"]),
    )


@torch.no_grad()
def frame(scene: GaussianScene, req: dict, bg: torch.Tensor) -> np.ndarray:
    """The (H, W, 3) uint8 frame a request asks for: the render clipped to
    [0, 1] and truncated to 8 bits, as the reference viewer sends it."""
    cam = camera_from_request(req, scene.device)
    out = render(scene, cam, bg, scaling_modifier=float(req.get("scaling_modifier", 1.0)))
    return (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8).cpu().numpy()


def serve_scene(
    scene: GaussianScene,
    host: str = "127.0.0.1",
    port: int = 6009,
    bg: Optional[torch.Tensor] = None,
    max_requests: Optional[int] = None,
    ready_event: Optional[threading.Event] = None,
) -> None:
    """Blocking render server (the reference's init / try_connect / send
    loop, `network_gui.py:26-86`): one request a connection, until
    `max_requests` have been answered (never, when None). `ready_event` is
    set once the socket listens."""
    bg = torch.zeros(3, device=scene.device) if bg is None else bg
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        if ready_event is not None:
            ready_event.set()
        served = 0
        while max_requests is None or served < max_requests:
            conn, _ = srv.accept()
            with conn, conn.makefile("rb") as f:
                line = f.readline()
                if not line:
                    continue
                payload = frame(scene, json.loads(line), bg).tobytes()
                conn.sendall(struct.pack("<I", len(payload)) + payload)
            served += 1


def request_frame(req: dict, host: str = "127.0.0.1", port: int = 6009) -> np.ndarray:
    """Client: send one camera request, return the (H, W, 3) uint8 frame."""
    with socket.create_connection((host, port), timeout=30) as s:
        s.sendall((json.dumps(req) + "\n").encode())
        with s.makefile("rb") as f:
            (n,) = struct.unpack("<I", f.read(4))
            data = f.read(n)
    return np.frombuffer(data, np.uint8).reshape(req["height"], req["width"], 3)
