"""The root conftest.py marks tests of tests/test_parallel.py `slow` by name:
a renamed test must fail here, not drop its mark in silence."""

import ast
import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_slow_marks_name_top_level_tests():
    spec = importlib.util.spec_from_file_location("root_conftest", ROOT / "conftest.py")
    root_conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_conftest)
    tree = ast.parse(root_conftest._MESH_TESTS.read_text())
    tests = {n.name for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}
    assert len(root_conftest.SLOW_MESH_TESTS) == 3
    assert set(root_conftest.SLOW_MESH_TESTS) <= tests, (
        set(root_conftest.SLOW_MESH_TESTS) - tests)
