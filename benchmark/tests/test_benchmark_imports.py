"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the port either (top-level names
compared whole: the port's name begins with the JAX package's)."""

import ast
import os

import pytest

from benchmark import core

JAX = {"jax", "jaxlib", "flax", "voiceprintrecognition_paddlepaddle_tpu"}


def _modules():
    for root, _, files in os.walk(core.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, core.HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted(p for p in _modules()
                                        if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, core.HERE))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert not names & (JAX | {core.PORT})


def test_sys_modules_check_compares_whole_names():
    assert core.forbidden_modules(["voiceprintrecognition_paddlepaddle_torch.predict",
                                   "numpy"]) == []
    assert core.forbidden_modules(["jax.numpy", "voiceprintrecognition_paddlepaddle_tpu"]) == [
        "jax", "voiceprintrecognition_paddlepaddle_tpu"]
    assert core.forbidden_modules(["jaxtyping"]) == []
