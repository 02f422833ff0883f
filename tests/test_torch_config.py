"""PyTorch port, the YAML reader (``utils/config.py``) that lets every
entry point start from a config path without PyYAML: equal to
``yaml.safe_load`` on each file in ``configs/`` and on what
``yaml.safe_dump`` writes of them in block style (the port's tests
write their configs so), the scalar forms of YAML 1.1 that it takes
resolved as PyYAML resolves them, a ``ValueError`` naming the line for
each construct it leaves out, and ``predict._load_configs`` (which
``Predictor``, ``Trainer`` and every command line call) with PyYAML
unimportable."""

import glob
import math
import os
import subprocess
import sys

import pytest
import yaml

from voiceprintrecognition_paddlepaddle_torch.utils.config import (
    load_yaml, parse_yaml)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yml")))


def test_every_config_file_is_covered():
    assert len(CONFIGS) == 8


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load(path):
    with open(path, encoding="utf-8") as f:
        text = f.read()
    want = yaml.safe_load(text)
    assert load_yaml(path) == want
    assert parse_yaml(yaml.safe_dump(want)) == want
    # PyYAML's flow style: flow mappings, wrapped over lines
    with pytest.raises(ValueError, match="^line 1: "):
        parse_yaml(yaml.safe_dump(want, default_flow_style=True))


SCALARS = """\
int: 42
neg: -3
under: 1_000
zero: 0
float: 1.0e-06
dot: .5
trail: 2.
plain_exp: 1e-6
inf: .inf
ninf: -.Inf
yes: yes
off: Off
true_: TRUE
null_: null
tilde: ~
empty:
single: 'it''s # not a comment'
double: "tab\\there"
path: dataset/cn-celeb-test/enroll_list.txt  # a comment
url: http://host:8080/x
list: [1, 'a, b', [2.5, true], []]
map: {}
quoted_key: {}
'b c': [x, 'y, z']
block:
- 1
-
  - nested
  - [3]
deep:
  - x
"""


def test_scalars_resolve_as_pyyaml():
    got, want = parse_yaml(SCALARS), yaml.safe_load(SCALARS)
    assert repr(got) == repr(want)
    assert isinstance(got["plain_exp"], str) and got["float"] == 1e-6
    assert math.isinf(got["ninf"]) and got["ninf"] < 0
    nan = parse_yaml("x: .nan\n")["x"]
    assert math.isnan(nan) and math.isnan(yaml.safe_load("x: .nan\n")["x"])
    assert parse_yaml("") is None and parse_yaml("# only\n\n") is None
    assert parse_yaml("- 1\n- x\n") == [1, "x"]


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2), ("a: *alias\n", 1), ("a: !!str 1\n", 1),
    ("a: |\n  text\n", 1), ("a: >\n  text\n", 1), ("---\na: 1\n", 1),
    ("a: {b: 1}\n", 1), ("a: [1,\n  2]\n", 1), ("a: [1, {}]\n", 1),
    ("a:\n  - b: 1\n", 2), ("a: 1\na: 2\n", 2),
    ("a: b\n  c\n", 2), ("a:\n\tb: 1\n", 2), ("a: x: y\n", 1),
    ("a: 0755\n", 1), ("a: 0x1F\n", 1), ("a: 1:30\n", 1),
    ("a: 2020-01-01\n", 1), ("a: 'open\n", 1), ("a: [1, 2\n", 1),
    ("a:\n    b: 1\n  c: 2\n", 3), ("? complex\n", 1)])
def test_constructs_outside_the_subset_raise(text, line):
    with pytest.raises(ValueError, match=f"^line {line}: "):
        parse_yaml(text)


def test_load_configs_needs_no_pyyaml():
    """``_load_configs`` on every config file with ``yaml`` blocked in
    ``sys.modules`` (an import of it raises), in a fresh interpreter; the
    command lines parse ``--configs`` through it."""
    code = (
        "import sys, glob\n"
        "sys.modules['yaml'] = None\n"
        "from voiceprintrecognition_paddlepaddle_torch.predict import "
        "_load_configs\n"
        "for p in sorted(glob.glob('configs/*.yml')):\n"
        "    c = _load_configs(p)\n"
        "    assert c.model_conf.model if 'model_conf' in c else c.speed\n"
        "try:\n"
        "    import yaml\n"
        "except ImportError:\n"
        "    print('no yaml')\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "no yaml"
