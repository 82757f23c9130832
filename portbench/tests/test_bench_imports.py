"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program, by whole top-level names."""

import ast
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "gsattack"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").rglob("*.py"):
        assert "gsattack_torch" not in top_level_imports(path), path


def test_whole_names_are_compared():
    assert "gsattack_torch".split(".")[0] not in FORBIDDEN


def test_a_reader_that_loads_jax_stops_the_run_before_its_result(capsys, monkeypatch):
    """The look at `sys.modules` comes after every per-layer reader has
    run: a reader that loads a forbidden module ends the run with no
    result line."""
    import sys
    import types

    import torch
    from conftest import args, small_cell

    from portbench import run

    def reader(ctx):
        monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
        return None

    monkeypatch.setattr(run, "metric_reader", lambda name: reader)
    wl, cfg = small_cell("train")
    rc = run.run_cell(args("train", seconds=1.0, trace=1), wl, cfg, torch.device("cpu"))
    out = capsys.readouterr()
    assert rc == 3 and out.out == ""
    assert "jax" in out.err.splitlines()[-1]
