"""The YOLO graphs (ultralytics v3u / v5u / v8 / v11), the port of
`gsattack/models/yolo_blocks.py`: NCHW modules built from the same
layer-spec tables and scaling rules as ultralytics' `parse_model`.

The submodule names are the ultralytics state-dict keys
(`model.{i}.cv1.conv.weight`, `model.22.cv2.0.2.bias`,
`model.10.m.0.attn.qkv.bn.running_var`), so an upstream checkpoint loads
with `load_state_dict` and no renaming (`convert_yolo.py`). Convolutions
pad k // 2 on every side, batch norms run on stored statistics with eps
1e-3, and every activation is SiLU except where ultralytics sets
act=False.

The v3 / v5 rows are the vendored anchor cards' backbone and neck with the
anchor-free DFL Detect of the u-variants, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FrozenBN

REG_MAX = 16
STRIDES = (8, 16, 32)


def make_divisible(x: float, divisor: int = 8) -> int:
    return math.ceil(x / divisor) * divisor


class UConv(nn.Module):
    """ultralytics Conv: Conv2d (no bias) + batch norm (eps 1e-3) + SiLU."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: int | None = None,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p, groups=g, bias=False)
        self.bn = FrozenBN(c2, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class UBottleneck(nn.Module):
    """ultralytics Bottleneck: cv1 (k[0]) -> cv2 (k[1], groups g), plus the
    input when `shortcut` and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: tuple = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = UConv(c1, c_, k[0], 1)
        self.cv2 = UConv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convs (v3u / v5u); C3k sets the bottlenecks'
    kernels to (k, k) (v11)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5,
                 k: tuple = (1, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = UConv(c1, c_, 1, 1)
        self.cv2 = UConv(c1, c_, 1, 1)
        self.cv3 = UConv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(UBottleneck(c_, c_, shortcut, k=k, e=1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5,
                 k: int = 3):
        super().__init__(c1, c2, n, shortcut, e, k=(k, k))


class C2f(nn.Module):
    """v8 cross-stage-partial block: split, n bottlenecks, concat all; C3k2
    (v11) makes the inner modules C3k(n=2) or e=0.5 bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = UConv(c1, 2 * self.c, 1, 1)
        self.cv2 = UConv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            UBottleneck(self.c, self.c, shortcut, k=(3, 3), e=1.0) for _ in range(n)
        )

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class C3k2(C2f):
    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5,
                 shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, e)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut) if c3k
            else UBottleneck(self.c, self.c, shortcut, k=(3, 3), e=0.5)
            for _ in range(n)
        )


class SPPF(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = UConv(c1, c_, 1, 1)
        self.cv2 = UConv(c_ * 4, c2, 1, 1)
        self.k = k

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], self.k, 1, self.k // 2))
        return self.cv2(torch.cat(y, 1))


class UAttention(nn.Module):
    """ultralytics Attention (C2PSA): qkv conv, softmax attention over the
    H*W positions, a depthwise positional conv on v, proj. The qkv channels
    split per head as (key, key, head) in channel-first order, which NCHW
    gives by a plain view."""

    def __init__(self, dim: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim**-0.5
        self.qkv = UConv(dim, dim + self.key_dim * num_heads * 2, 1, act=False)
        self.proj = UConv(dim, dim, 1, act=False)
        self.pe = UConv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = self.qkv(x).view(b, self.num_heads, self.key_dim * 2 + self.head_dim,
                                   h * w).split([self.key_dim, self.key_dim, self.head_dim], 2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).view(b, c, h, w) + self.pe(v.reshape(b, c, h, w))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, c: int, num_heads: int, attn_ratio: float = 0.5):
        super().__init__()
        self.attn = UAttention(c, num_heads, attn_ratio)
        self.ffn = nn.Sequential(UConv(c, c * 2, 1), UConv(c * 2, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = UConv(c1, 2 * self.c, 1, 1)
        self.cv2 = UConv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, num_heads=max(self.c // 64, 1))
                                 for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat([a, self.m(b)], 1))


class Detect(nn.Module):
    """Anchor-free decoupled head with DFL box regression. legacy (v3u /
    v5u / v8): cv2 / cv3 = [Conv, Conv, Conv2d] per scale; v11: the class
    branch uses depthwise-separable pairs. Returns the per-scale
    (B, 4 * REG_MAX + nc, H, W) maps."""

    def __init__(self, nc: int, ch: tuple, legacy: bool = True):
        super().__init__()
        self.nc = nc
        c2 = max(16, ch[0] // 4, REG_MAX * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(UConv(x, c2, 3), UConv(c2, c2, 3), nn.Conv2d(c2, 4 * REG_MAX, 1))
            for x in ch
        )
        if legacy:
            self.cv3 = nn.ModuleList(
                nn.Sequential(UConv(x, c3, 3), UConv(c3, c3, 3), nn.Conv2d(c3, nc, 1))
                for x in ch
            )
        else:
            self.cv3 = nn.ModuleList(
                nn.Sequential(
                    nn.Sequential(UConv(x, x, 3, g=x), UConv(x, c3, 1)),
                    nn.Sequential(UConv(c3, c3, 3, g=c3), UConv(c3, c3, 1)),
                    nn.Conv2d(c3, nc, 1),
                )
                for x in ch
            )

    def forward(self, feats):
        return [torch.cat([self.cv2[i](f), self.cv3[i](f)], 1) for i, f in enumerate(feats)]


class Upsample(nn.Module):
    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        return F.interpolate(x, scale_factor=self.factor, mode="nearest")


class Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


# ---------------------------------------------------------------------------
# Layer-spec tables, transcribed from the ultralytics model yamls: rows are
# (from, repeats, module, args) as in the yaml, before scaling.
# ---------------------------------------------------------------------------

YOLOV8_SPEC = [
    (-1, 1, "Conv", [64, 3, 2]),        # 0  P1/2
    (-1, 1, "Conv", [128, 3, 2]),       # 1  P2/4
    (-1, 3, "C2f", [128, True]),        # 2
    (-1, 1, "Conv", [256, 3, 2]),       # 3  P3/8
    (-1, 6, "C2f", [256, True]),        # 4
    (-1, 1, "Conv", [512, 3, 2]),       # 5  P4/16
    (-1, 6, "C2f", [512, True]),        # 6
    (-1, 1, "Conv", [1024, 3, 2]),      # 7  P5/32
    (-1, 3, "C2f", [1024, True]),       # 8
    (-1, 1, "SPPF", [1024, 5]),         # 9
    (-1, 1, "Upsample", [2]),           # 10
    ([-1, 6], 1, "Concat", []),         # 11
    (-1, 3, "C2f", [512]),              # 12
    (-1, 1, "Upsample", [2]),           # 13
    ([-1, 4], 1, "Concat", []),         # 14
    (-1, 3, "C2f", [256]),              # 15 P3 out
    (-1, 1, "Conv", [256, 3, 2]),       # 16
    ([-1, 12], 1, "Concat", []),        # 17
    (-1, 3, "C2f", [512]),              # 18 P4 out
    (-1, 1, "Conv", [512, 3, 2]),       # 19
    ([-1, 9], 1, "Concat", []),         # 20
    (-1, 3, "C2f", [1024]),             # 21 P5 out
    ([15, 18, 21], 1, "Detect", []),    # 22
]

YOLOV5_SPEC = [
    (-1, 1, "Conv", [64, 6, 2, 2]),     # 0  P1/2 (the 6x6 stem)
    (-1, 1, "Conv", [128, 3, 2]),       # 1  P2/4
    (-1, 3, "C3", [128]),               # 2
    (-1, 1, "Conv", [256, 3, 2]),       # 3  P3/8
    (-1, 6, "C3", [256]),               # 4
    (-1, 1, "Conv", [512, 3, 2]),       # 5  P4/16
    (-1, 9, "C3", [512]),               # 6
    (-1, 1, "Conv", [1024, 3, 2]),      # 7  P5/32
    (-1, 3, "C3", [1024]),              # 8
    (-1, 1, "SPPF", [1024, 5]),         # 9
    (-1, 1, "Conv", [512, 1, 1]),       # 10
    (-1, 1, "Upsample", [2]),           # 11
    ([-1, 6], 1, "Concat", []),         # 12
    (-1, 3, "C3", [512, False]),        # 13
    (-1, 1, "Conv", [256, 1, 1]),       # 14
    (-1, 1, "Upsample", [2]),           # 15
    ([-1, 4], 1, "Concat", []),         # 16
    (-1, 3, "C3", [256, False]),        # 17 P3 out
    (-1, 1, "Conv", [256, 3, 2]),       # 18
    ([-1, 14], 1, "Concat", []),        # 19
    (-1, 3, "C3", [512, False]),        # 20 P4 out
    (-1, 1, "Conv", [512, 3, 2]),       # 21
    ([-1, 10], 1, "Concat", []),        # 22
    (-1, 3, "C3", [1024, False]),       # 23 P5 out
    ([17, 20, 23], 1, "Detect", []),    # 24
]

YOLOV3_SPEC = [
    (-1, 1, "Conv", [32, 3, 1]),            # 0
    (-1, 1, "Conv", [64, 3, 2]),            # 1  P1/2
    (-1, 1, "Bottleneck", [64]),            # 2
    (-1, 1, "Conv", [128, 3, 2]),           # 3  P2/4
    (-1, 2, "Bottleneck", [128]),           # 4
    (-1, 1, "Conv", [256, 3, 2]),           # 5  P3/8
    (-1, 8, "Bottleneck", [256]),           # 6
    (-1, 1, "Conv", [512, 3, 2]),           # 7  P4/16
    (-1, 8, "Bottleneck", [512]),           # 8
    (-1, 1, "Conv", [1024, 3, 2]),          # 9  P5/32
    (-1, 4, "Bottleneck", [1024]),          # 10
    (-1, 1, "Bottleneck", [1024, False]),   # 11
    (-1, 1, "Conv", [512, 1, 1]),           # 12
    (-1, 1, "Conv", [1024, 3, 1]),          # 13
    (-1, 1, "Conv", [512, 1, 1]),           # 14
    (-1, 1, "Conv", [1024, 3, 1]),          # 15 P5 out
    (-2, 1, "Conv", [256, 1, 1]),           # 16
    (-1, 1, "Upsample", [2]),               # 17
    ([-1, 8], 1, "Concat", []),             # 18
    (-1, 1, "Bottleneck", [512, False]),    # 19
    (-1, 1, "Bottleneck", [512, False]),    # 20
    (-1, 1, "Conv", [256, 1, 1]),           # 21
    (-1, 1, "Conv", [512, 3, 1]),           # 22 P4 out
    (-2, 1, "Conv", [128, 1, 1]),           # 23
    (-1, 1, "Upsample", [2]),               # 24
    ([-1, 6], 1, "Concat", []),             # 25
    (-1, 1, "Bottleneck", [256, False]),    # 26
    (-1, 2, "Bottleneck", [256, False]),    # 27
    ([27, 22, 15], 1, "Detect", []),        # 28
]

YOLOV11_SPEC = [
    (-1, 1, "Conv", [64, 3, 2]),            # 0  P1/2
    (-1, 1, "Conv", [128, 3, 2]),           # 1  P2/4
    (-1, 2, "C3k2", [256, False, 0.25]),    # 2
    (-1, 1, "Conv", [256, 3, 2]),           # 3  P3/8
    (-1, 2, "C3k2", [512, False, 0.25]),    # 4
    (-1, 1, "Conv", [512, 3, 2]),           # 5  P4/16
    (-1, 2, "C3k2", [512, True]),           # 6
    (-1, 1, "Conv", [1024, 3, 2]),          # 7  P5/32
    (-1, 2, "C3k2", [1024, True]),          # 8
    (-1, 1, "SPPF", [1024, 5]),             # 9
    (-1, 2, "C2PSA", [1024]),               # 10
    (-1, 1, "Upsample", [2]),               # 11
    ([-1, 6], 1, "Concat", []),             # 12
    (-1, 2, "C3k2", [512, False]),          # 13
    (-1, 1, "Upsample", [2]),               # 14
    ([-1, 4], 1, "Concat", []),             # 15
    (-1, 2, "C3k2", [256, False]),          # 16 P3 out
    (-1, 1, "Conv", [256, 3, 2]),           # 17
    ([-1, 13], 1, "Concat", []),            # 18
    (-1, 2, "C3k2", [512, False]),          # 19 P4 out
    (-1, 1, "Conv", [512, 3, 2]),           # 20
    ([-1, 10], 1, "Concat", []),            # 21
    (-1, 2, "C3k2", [1024, True]),          # 22 P5 out
    ([16, 19, 22], 1, "Detect", []),        # 23
]

# name -> (depth, width, max_channels), from the yamls' `scales:` sections.
SCALES = {
    "yolov8n": (0.33, 0.25, 1024),
    "yolov8s": (0.33, 0.50, 1024),
    "yolov8m": (0.67, 0.75, 768),
    "yolov8l": (1.00, 1.00, 512),
    "yolov8x": (1.00, 1.25, 512),
    "yolov5n": (0.33, 0.25, 1024),
    "yolov5s": (0.33, 0.50, 1024),
    "yolov5m": (0.67, 0.75, 1024),
    "yolov5l": (1.00, 1.00, 1024),
    "yolov5x": (1.33, 1.25, 1024),
    "yolov3": (1.00, 1.00, 1024),
    "yolov11n": (0.50, 0.25, 1024),
    "yolov11s": (0.50, 0.50, 1024),
    "yolov11m": (0.50, 1.00, 512),
    "yolov11l": (1.00, 1.00, 512),
    "yolov11x": (1.00, 1.50, 512),
}

SPECS = {
    "yolov8": YOLOV8_SPEC,
    "yolov5": YOLOV5_SPEC,
    "yolov3": YOLOV3_SPEC,
    "yolov11": YOLOV11_SPEC,
}

# v11 m / l / x force c3k=True on every C3k2 (ultralytics parse_model);
# n / s keep the yaml's values.
FORCE_C3K = {"yolov11m", "yolov11l", "yolov11x"}


def resolve_variant(name: str) -> tuple[str, str]:
    """'yolov8s' -> (family 'yolov8', scale key 'yolov8s'); a bare family
    name takes the reference's checkpoint (v8n, v5s, v3, v11n)."""
    defaults = {"yolov8": "yolov8n", "yolov5": "yolov5s", "yolov3": "yolov3",
                "yolov11": "yolov11n"}
    for fam in ("yolov11", "yolov8", "yolov5", "yolov3"):
        if name.startswith(fam):
            return fam, name if name in SCALES else defaults[fam]
    raise ValueError(f"unknown yolo variant {name!r}")


class YoloGraph(nn.Module):
    """Interpreter over a layer-spec table, ultralytics' parse_model and
    its forward with the save list. `model[i]` is row i's module."""

    def __init__(self, family: str = "yolov8", scale: str = "yolov8n", nc: int = 80):
        super().__init__()
        spec = SPECS[family]
        depth, width, max_ch = SCALES[scale]
        force_c3k = scale in FORCE_C3K

        def w(c):
            return make_divisible(min(c, max_ch) * width, 8)

        def d(n):
            return max(round(n * depth), 1) if n > 1 else n

        layers, channels, self.froms = [], [], []
        for i, (frm, n, mod, args) in enumerate(spec):
            self.froms.append(frm)
            if i == 0:
                src_ch = [3]
            else:
                src_ch = [channels[j] for j in (frm if isinstance(frm, list) else [frm])]
            c1 = src_ch[0]
            if mod == "Conv":
                c2 = w(args[0])
                layer = UConv(c1, c2, args[1], args[2], p=args[3] if len(args) > 3 else None)
            elif mod == "Bottleneck":
                c2 = w(args[0])
                shortcut = args[1] if len(args) > 1 else True
                reps = d(n)
                if reps == 1:
                    layer = UBottleneck(c1, c2, shortcut)
                else:
                    layer = nn.Sequential(*(UBottleneck(c1 if j == 0 else c2, c2, shortcut)
                                            for j in range(reps)))
            elif mod == "C2f":
                c2 = w(args[0])
                layer = C2f(c1, c2, d(n), args[1] if len(args) > 1 else False)
            elif mod == "C3":
                c2 = w(args[0])
                layer = C3(c1, c2, d(n), args[1] if len(args) > 1 else True)
            elif mod == "C3k2":
                c2 = w(args[0])
                c3k = (args[1] if len(args) > 1 else False) or force_c3k
                layer = C3k2(c1, c2, d(n), c3k, args[2] if len(args) > 2 else 0.5)
            elif mod == "SPPF":
                c2 = w(args[0])
                layer = SPPF(c1, c2, args[1])
            elif mod == "C2PSA":
                c2 = c1
                layer = C2PSA(c1, d(n))
            elif mod == "Upsample":
                c2 = c1
                layer = Upsample(args[0])
            elif mod == "Concat":
                c2 = sum(src_ch)
                layer = Concat()
            elif mod == "Detect":
                c2 = 0
                layer = Detect(nc, tuple(src_ch), legacy=family != "yolov11")
            else:  # pragma: no cover
                raise ValueError(f"unknown module {mod}")
            layers.append(layer)
            channels.append(c2)
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """(B, 3, H, W) -> the Detect maps at strides 8, 16, 32."""
        outputs = []
        for i, layer in enumerate(self.model):
            frm = self.froms[i]
            if i == 0:
                src = x
            elif isinstance(frm, list):
                src = [outputs[j] for j in frm]
            else:
                src = outputs[frm]
            y = layer(src)
            if isinstance(layer, Detect):
                return y
            outputs.append(y)
        raise ValueError("spec has no Detect layer")  # pragma: no cover
