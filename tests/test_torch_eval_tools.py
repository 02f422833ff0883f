"""PyTorch port, the evaluation tools against the JAX package's, on the CPU,
with one tiny TDNN trained by the port's ``Trainer(device="cpu")`` on the
recipe of ``tests/test_torch_diarization_quality.py`` and carried to JAX
(flax variables, inverse of ``jax_to_torch_state``) and to a paddle
``.pdparams`` (inverse of the converter's spec), each round trip checked:

- ``eval_from_paddle`` against JAX's ``tools/eval_from_paddle.main`` on the
  same ``.pdparams``, over 8 tone speakers (the 4 trained ones and 4
  between them) x (2 enroll + 2 trial) clips: EER and MinDCF equal, the
  threshold within 1e-4 (the two front ends' log-mels differ by about
  1e-3, ROADMAP.md queue 3); ``--predict`` scores within 1e-5 of JAX's;
- ``eval_speaker_diarization``: ``create_aishell4_test_rttm``,
  ``infer_data`` and ``compute_metrics`` on a tiny AIShell-4-shaped tree
  (two 3-speaker tone conversations) against JAX's
  ``tools/eval_speaker_diarization/`` scripts, each run in its own copy of
  the tree: the reference RTTM, the data list, every per-speaker wav and
  the hypothesis RTTM byte-equal, every speaker named, the same printed
  metrics, DER < 0.20;
- ``infer_speaker_diarization --show_plot=True`` writes
  ``output/speaker_diarization.png``;
- ``utils.utils``: ``cal_accuracy_threshold``, ``cal_accuracy`` and
  ``cosin_metric`` equal JAX's on seeded inputs (exactly);
- ``torch_card.pdparams_of``, which writes the card's trained CAM++ for
  ``eval_from_paddle``: the stock CAM++ converted back bit-equal by the
  port's and JAX's converters."""

import contextlib
import io
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch
import yaml
from flax import serialization

import torch_jax_native  # noqa: F401 (JAX's native library, locked)
from test_predictor import _configs
from torch_card import tone, write_wav
from tools import convert_paddle_checkpoint as jconv
from voiceprintrecognition_paddlepaddle_torch import (eval_from_paddle,
                                                      infer_speaker_diarization)
from voiceprintrecognition_paddlepaddle_torch.eval_speaker_diarization import (
    compute_metrics, create_aishell4_test_rttm, infer_data)
from voiceprintrecognition_paddlepaddle_torch.models.convert import \
    jax_to_torch_state
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_torch.utils import utils as tutils
from voiceprintrecognition_paddlepaddle_tpu.utils import utils as jutils

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
TOOLS = os.path.join(ROOT, "tools", "eval_speaker_diarization")
MODEL_ARGS = {"embd_dim": 32, "channels": 32, "pooling_type": "TSP"}
N_MELS = 40
TRAINED_F0S = (130, 210, 290, 370)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads, as ``tests/test_torch_trainer.py``."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flax_from_torch(state):
    """The inverse of ``jax_to_torch_state`` for a backbone of convs,
    dense layers and BatchNorms."""
    bns = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    tree = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        mod, leaf = name.rsplit(".", 1)
        v = t.numpy()
        if leaf == "num_batches_tracked":
            continue
        coll = "params"
        if leaf.startswith("running_"):
            coll, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "weight" and mod in bns:
            leaf = "scale"
        elif leaf == "weight":
            leaf = "kernel"
            v = {3: lambda: v.transpose(2, 1, 0),
                 4: lambda: v.transpose(2, 3, 1, 0),
                 2: lambda: v.T}[v.ndim]()
        node = tree[coll]
        for k in mod.split("."):
            node = node.setdefault(k, {})
        node[leaf] = np.ascontiguousarray(v)
    return tree


def _paddle_from_flax(variables, name, n_mels, args):
    """A paddle ``state_dict`` (``0.``-prefixed) holding ``variables``:
    the inverse of each transform of the converter's spec."""
    out = {}
    for pkey, coll, fpath, _, kind in jconv.SPECS[name](n_mels, **args):
        node = variables[coll]
        for k in fpath.split("/"):
            node = node[k]
        v = np.asarray(node)
        v = {"conv1d_w": lambda: v.transpose(2, 1, 0),
             "conv2d_w": lambda: v.transpose(3, 2, 0, 1),
             "conv1d_as_dense_w": lambda: v.T[:, :, None]}.get(
            kind, lambda: v)()
        out[f"0.{pkey}"] = np.ascontiguousarray(v, dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The tiny TDNN of ``_configs`` trained on 4 tone speakers x 4 clips
    (40 epochs, learning rate 0.05, ``dataset.seed`` 7), in the port's,
    JAX's and paddle's layouts; eval lists of 8 speakers; the config file."""
    root = tmp_path_factory.mktemp("trained")
    lines = []
    for spk, f0 in enumerate(TRAINED_F0S):
        for u in range(4):
            p = root / f"s{spk}_u{u}.wav"
            write_wav(p, tone(f0, 1.2, seed=spk * 10 + u))
            lines.append(f"{p}\t{spk}")
    (root / "train_list.txt").write_text("\n".join(lines) + "\n",
                                         encoding="utf-8")
    cfg = _configs(root)
    cfg["train_conf"]["max_epoch"] = 40
    cfg["optimizer_conf"]["scheduler_args"]["learning_rate"] = 0.05
    cfg["dataset_conf"]["dataset"]["seed"] = 7
    tr = Trainer(configs=cfg, device="cpu")
    tr.train(save_model_path="", log_dir="", do_eval=False)
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    torch.save(state, str(root / "model.pt"))
    variables = _flax_from_torch(state)
    back = jax_to_torch_state(variables)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k].float()) for k in state
               if not k.endswith("num_batches_tracked"))
    (root / "model.msgpack").write_bytes(
        serialization.msgpack_serialize(variables))
    pd = _paddle_from_flax(variables, "TDNN", N_MELS, MODEL_ARGS)
    tree = jconv.convert_state({k[2:]: v for k, v in pd.items()}, "TDNN",
                               N_MELS, model_args=MODEL_ARGS)
    assert jax_to_torch_state({"params": tree["params"]["backbone"],
                               "batch_stats": tree["batch_stats"]["backbone"]
                               }).keys() == back.keys()
    with open(root / "model.pdparams", "wb") as f:
        pickle.dump(pd, f)

    rng = np.random.RandomState(1)
    lists = {"enroll": [], "trials": []}
    for spk, f0 in enumerate(sorted(TRAINED_F0S + (170, 250, 330, 410))):
        for part in lists:
            for u in range(2):
                p = root / f"{part}_{spk}_{u}.wav"
                write_wav(p, tone(f0, rng.uniform(1.0, 2.0),
                                  seed=500 + 10 * spk + u + len(part)))
                lists[part].append(f"{p}\t{spk}")
    for part, ls in lists.items():
        (root / f"{part}.txt").write_text("\n".join(ls) + "\n",
                                          encoding="utf-8")
    cfg["dataset_conf"]["enroll_list"] = str(root / "enroll.txt")
    cfg["dataset_conf"]["trials_list"] = str(root / "trials.txt")
    cfg_path = root / "tdnn_tiny.yml"
    cfg_path.write_text(yaml.safe_dump(cfg), encoding="utf-8")
    paths = [ln.split("\t")[0] for ln in lists["enroll"] + lists["trials"]]
    return {"configs": str(cfg_path), "pt": str(root / "model.pt"),
            "msgpack": str(root / "model.msgpack"),
            "pdparams": str(root / "model.pdparams"), "paths": paths}


def test_eval_from_paddle_equals_jax(trained, tmp_path):
    from tools.eval_from_paddle import main as jax_main
    cfg_path, pd_path = trained["configs"], trained["pdparams"]
    got = eval_from_paddle.main(["--configs", cfg_path, "--pdparams", pd_path,
                                 "--workdir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    want = jax_main(["--configs", cfg_path, "--pdparams", pd_path,
                     "--workdir", str(tmp_path / "jax"), "--use_gpu", "false"])
    assert os.path.exists(os.path.join(got["checkpoint"], "model.pt"))
    assert 0.0 < got["eer"] < 0.5, got
    assert got["eer"] == want["eer"] and got["min_dcf"] == want["min_dcf"]
    assert abs(got["threshold"] - want["threshold"]) <= 1e-4, (got, want)


def test_eval_from_paddle_predict_equals_jax(trained, tmp_path):
    from tools.eval_from_paddle import main as jax_main
    cfg_path, pd_path, paths = (trained["configs"], trained["pdparams"],
                                trained["paths"])
    verdicts = set()
    for a, b in ((paths[0], paths[16]), (paths[0], paths[-1])):
        got = eval_from_paddle.main(
            ["--configs", cfg_path, "--pdparams", pd_path, "--workdir",
             str(tmp_path / "port"), "--predict", a, b, "--device", "cpu"])
        want = jax_main(["--configs", cfg_path, "--pdparams", pd_path,
                         "--workdir", str(tmp_path / "jax"), "--predict", a,
                         b, "--use_gpu", "false"])
        assert abs(got["score"] - want["score"]) <= 1e-5, (got, want)
        assert got["same_speaker"] == want["same_speaker"]
        verdicts.add(got["same_speaker"])
    assert verdicts == {True, False}


# ---- the AIShell-4 flow -------------------------------------------------------
CONVERSATIONS = {"conv_a": [0, 1, 2, 0, 2, 1], "conv_b": [2, 0, 1, 1, 0, 2]}
TURN_S, GAP_S = 3.0, 0.8


def _aishell_tree(root):
    """``dataset/test/wav/<conv>.wav`` and ``dataset/test/TextGrid/
    <conv>.rttm`` for each conversation of three trained speakers."""
    wav_dir, rttm_dir = root / "dataset/test/wav", root / "dataset/test/TextGrid"
    wav_dir.mkdir(parents=True)
    rttm_dir.mkdir(parents=True)
    for c, (name, order) in enumerate(CONVERSATIONS.items()):
        pieces, lines, t0 = [], [], 0.0
        for i, spk in enumerate(order):
            pieces.append(tone(TRAINED_F0S[spk], TURN_S,
                               seed=1000 * (c + 1) + 17 * i + spk))
            lines.append(f"SPEAKER {name} 1 {t0:.3f} {TURN_S:.3f} <NA> <NA> "
                         f"spk{spk} <NA> <NA>\n")
            t0 += TURN_S
            if i != len(order) - 1:
                pieces.append(np.zeros(int(GAP_S * SR), np.float32))
                t0 += GAP_S
        write_wav(wav_dir / f"{name}.wav", np.concatenate(pieces))
        (rttm_dir / f"{name}.rttm").write_text("".join(lines),
                                               encoding="utf-8")


def _run_jax_tool(monkeypatch, cwd, name, argv=()):
    """``tools/eval_speaker_diarization/<name>.py`` as ``__main__`` in
    ``cwd``; returns what it printed."""
    monkeypatch.chdir(cwd)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(os.path.join(TOOLS, f"{name}.py"), run_name="__main__")
    return out.getvalue()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_aishell4_flow_equals_jax_tools(trained, monkeypatch, tmp_path):
    trees = {}
    for side in ("port", "jax"):
        trees[side] = tmp_path / side
        _aishell_tree(trees[side])
    _run_jax_tool(monkeypatch, trees["jax"], "create_aishell4_test_rttm")
    monkeypatch.chdir(trees["port"])
    create_aishell4_test_rttm.main([])
    port_files, jax_files = (_files(trees[s] / "dataset")
                             for s in ("port", "jax"))
    assert sorted(port_files) == sorted(jax_files)
    assert sum(n.startswith("audio_db") for n in port_files) == 12
    for name in port_files:
        assert port_files[name] == jax_files[name], name

    _run_jax_tool(monkeypatch, trees["jax"], "infer_data",
                  [f"--configs={trained['configs']}",
                   f"--model_path={trained['msgpack']}", "--use_gpu=False"])
    monkeypatch.chdir(trees["port"])
    infer_data.main([f"--configs={trained['configs']}",
                     f"--model_path={trained['pt']}", "--device=cpu"])
    hyp = {s: (trees[s] / "dataset/hypotheses.rttm").read_bytes()
           for s in trees}
    assert hyp["port"] == hyp["jax"]
    assert {ln.split()[7] for ln in hyp["port"].decode().splitlines()} == \
        {"spk0", "spk1", "spk2"}

    want = _run_jax_tool(monkeypatch, trees["jax"], "compute_metrics")
    monkeypatch.chdir(trees["port"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = compute_metrics.main([])
    assert out.getvalue() == want
    assert metrics["diarization error rate"] < 0.20, metrics


def test_show_plot_writes_the_png(trained, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    results = infer_speaker_diarization.main([
        f"--configs={trained['configs']}", f"--model_path={trained['pt']}",
        "--device=cpu",
        f"--audio_path={os.path.join(ROOT, 'dataset', 'test_long.wav')}",
        "--show_plot=True"])
    png = tmp_path / "output" / "speaker_diarization.png"
    assert results and png.exists() and png.stat().st_size > 1000


@pytest.mark.parametrize("name", ["cal_accuracy_threshold", "cal_accuracy",
                                  "cosin_metric"])
def test_score_helpers_equal_jax(name):
    rng = np.random.RandomState(4)
    for _ in range(5):
        if name == "cosin_metric":
            args = (rng.randn(192).astype(np.float32),
                    rng.randn(192).astype(np.float32))
        else:
            args = (rng.uniform(-0.2, 1.0, 50).astype(np.float32),
                    rng.randint(0, 2, 50))
            if name == "cal_accuracy":
                args += (float(rng.uniform(0.0, 0.9)),)
        got, want = getattr(tutils, name)(*args), getattr(jutils, name)(*args)
        assert got == want and name in tutils.__all__


def test_torch_card_pdparams_inverts_the_converter():
    """``torch_card.pdparams_of`` (the card writes its trained CAM++ as a
    ``.pdparams`` with it): the stock CAM++ with seeded weights and BN
    statistics, written out and converted back by the port's and JAX's
    converters, bit-equal."""
    from torch_card import CONFIG, pdparams_of, random_flax_variables
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import pdparams_to_torch_state

    args = dict(CONFIG["model_conf"]["model_args"])
    model = CAMPPlus(80, **args)
    model.load_state_dict(jax_to_torch_state(random_flax_variables(model, 5)))
    pd = {k[2:]: v for k, v in pdparams_of(model, args).items()}
    back = pdparams_to_torch_state(pd, "CAMPPlus", 80, model_args=args)["model"]
    tree = jconv.convert_state(pd, "CAMPPlus", 80, model_args=args)
    jax_back = jax_to_torch_state({"params": tree["params"]["backbone"],
                                   "batch_stats": tree["batch_stats"]["backbone"]})
    state = model.state_dict()
    assert back.keys() == state.keys() == jax_back.keys()
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v) and torch.equal(jax_back[k], v), k
