"""`gsattack_torch/utils/config.py` against `gsattack/utils/config.py`
(PyYAML): every file in configs/, a list of override values, and the
interpolation; equal values and equal types. Also: the CLI and the config
import with PyYAML, Pillow, scikit-learn and OpenCV blocked, and without
JAX."""

import datetime
import glob
import math
import os
import subprocess
import sys

import pytest
import yaml

from gsattack.utils import config as jcfg
from gsattack_torch.utils import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
NOW = datetime.datetime(2031, 4, 5, 6, 7, 8)
SCENES = sorted(os.path.splitext(os.path.basename(p))[0]
                for p in glob.glob(os.path.join(CONFIGS, "scene", "*.yaml")))
OVERRIDE_VALUES = [
    "1e-3", "1.6e-6", "1.0e-3", "5.000000e-07", "1E+3", "1_0.5", ".5", "1.", "+0.0",
    ".inf", "-.INF", ".nan", "yes", "no", "on", "Off", "TRUE", "tRue", "~", "null", "Null",
    "", "0x10", "0x1F", "0b101", "010", "08", "1_000", "-0", "+1", "1:30", "190:20:30.15",
    "[a, 1]", "[0.0, 1.0]", "[color]", "[a, ]", "[1, [2, [3]]]", '["output/hydrant.ply"]',
    "{a: 1, b: [2, 3]}", "{}", "[]", "[unclosed", "[a,,b]", "'quoted'", '"dq\\tx\\u00e9"',
    "'it''s'", "'a' # c", "a b", "a #b", "a#b", "#b", " a", "a: b", "a, b", "-", "- a",
    "@foo", "%foo", "=", "<<", "car", "/tmp/x/scene", "./results/${scene.name}",
    "${now:%Y}", "http://x:80", "2024-01-02", "2024-1-2", "2001-12-14 21:59:43.10 -5",
    "2001-12-14T21:59:43Z", "30000", "0.00016",
]


def same(a, b) -> bool:
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_reader_matches_pyyaml_on_every_config_file():
    paths = sorted(glob.glob(os.path.join(CONFIGS, "**", "*.yaml"), recursive=True))
    assert len(paths) == 1 + len(SCENES) == 15
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert same(tcfg.parse_yaml(text), yaml.safe_load(text)), path


@pytest.mark.parametrize("scene", [None] + SCENES)
def test_load_config_matches(scene):
    overrides = [] if scene is None else [f"scene={scene}"]
    got = tcfg.load_config(CONFIGS, overrides=overrides, now=NOW)
    want = jcfg.load_config(CONFIGS, overrides=overrides, now=NOW)
    assert isinstance(got, tcfg.ConfigNode)
    assert same(got.to_dict(), want.to_dict())


def test_override_values_resolve_as_pyyaml():
    for v in OVERRIDE_VALUES:
        got, want = tcfg._parse_override_value(v), jcfg._parse_override_value(v)
        assert same(got, want), (v, got, want)
    overrides = ["epsilon=1e-3", "alpha=1.6e-6", "batch_mode=yes", "scene.untarget=~",
                 "attack_attributes=[color, opacity]", "max_iters=0x10", "eval_every=1_000",
                 "scene.target='car'", "mesh.views=2", "a.b.c=[0.0, 1.0]"]
    got = tcfg.load_config(CONFIGS, overrides=overrides, now=NOW)
    want = jcfg.load_config(CONFIGS, overrides=overrides, now=NOW)
    assert same(got.to_dict(), want.to_dict())
    assert got.epsilon == "1e-3" and got.alpha == 1.6e-6 and got.max_iters == 16


def test_yaml_subset_matches_pyyaml():
    text = """
# a comment
top:
  nested: {k: [1, 2.5, "s"]}   # trailing
  list:
  - a: 1
    b: two
  - - x
    - 'y'
  -
  empty:
quoted key: "v: #not a comment"
"k2": 'single ''q'''
seq_same_indent:
- 1
- null
url: http://host:80/p#frag
last: -3
"""
    assert same(tcfg.parse_yaml(text), yaml.safe_load(text))
    for bad in ("a: &x 1", "a: |\n  b", "a: 1\n   b: 2"):
        with pytest.raises(tcfg.YamlError):
            tcfg.parse_yaml(bad)


def test_interpolation_and_now(tmp_path):
    (tmp_path / "c.yaml").write_text(
        'a: hello\nb: "${a}_world"\nn: 3\nn2: "${n}"\nd: run/${now:%Y-%m}\n')
    for mod in (tcfg, jcfg):
        cfg = mod.load_config(str(tmp_path), "c", now=NOW)
        assert (cfg.b, cfg.n2, cfg.d) == ("hello_world", 3, "run/2031-04")
    cfg = tcfg.load_config(CONFIGS, now=NOW)
    assert cfg.sysconfig.log_dir == "./results/toy/2031-04-05/nyc_block_toy_06-07"
    node = tcfg.ConfigNode.wrap({"a": {"b": [1, {"c": 2}]}})
    assert node.a.b[1].c == 2 and node.to_dict() == {"a": {"b": [1, {"c": 2}]}}
    assert tcfg.apply_overrides({"x": 1}, ["a.b.c=5", "x=2"]) == {"x": 2, "a": {"b": {"c": 5}}}
    with pytest.raises(ValueError):
        tcfg.apply_overrides({}, ["novalue"])


def test_cli_imports_without_optional_packages():
    """The CLI, the config and the evals import with PyYAML, Pillow,
    scikit-learn and OpenCV blocked, and load no JAX."""
    code = (
        "import sys\n"
        "for m in ('yaml', 'PIL', 'sklearn', 'cv2'): sys.modules[m] = None\n"
        "import gsattack_torch.cli, gsattack_torch.utils.config, gsattack_torch.evals\n"
        "cfg = gsattack_torch.utils.config.load_config('configs')\n"
        "assert cfg.scene.name == 'toy'\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'gsattack.')) for m in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
