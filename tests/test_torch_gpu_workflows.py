"""PyTorch port on the card, end to end at the stock CAM++'s width: the
single-card workflow's command lines, data parallelism on one card, and a
CAM++ trained on the card through diarization, the evaluation tools and
the GUI actions. Every test here is marked ``gpu`` and skips without a
CUDA device; this file imports no jax. Run the card's tests with

    python -m pytest --noconftest tests/test_torch_gpu*.py -m gpu -q

Each test holds the kernel path to a plain or fp32 side, and counts the
kernels' launches (``torch_card.launches``: fbank, FCM, trunk) where it
must take them.
"""

import glob
import json
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from test_torch_parallel_ranks import launch_ranks
from torch_card import (CONFIG, ROOT, SEED, cos_min, eager_embed, launches,
                        launches_since, pdparams_of, synth_corpus,
                        synth_pdparams, tone, train_config, write_wav)
from voiceprintrecognition_paddlepaddle_torch.models.campplus import CAMPPlus
from voiceprintrecognition_paddlepaddle_torch.ops import features, kaldi
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor
from voiceprintrecognition_paddlepaddle_torch.trainer import Trainer
from voiceprintrecognition_paddlepaddle_torch.utils.config import load_yaml

pytestmark = pytest.mark.gpu

PORT = "voiceprintrecognition_paddlepaddle_torch"


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def run_cli(module, args, timeout=600):
    """``main(args)`` of ``<PORT>.<module>`` in a child process, as ``-m``
    runs it: returns (its stdout but the last two lines, the kernels'
    launches in the child, the value ``main`` returned)."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        f"from {PORT}.{module} import main\n"
        f"value = main({list(args)!r})\n"
        "from torch_card import launches\n"
        "print(json.dumps(value, default=str))\n"
        "print(json.dumps(launches()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, f"{module}:\n{proc.stderr[-4000:]}"
    lines = proc.stdout.strip().splitlines()
    return ("\n".join(lines[:-2]), json.loads(lines[-1]),
            json.loads(lines[-2]))


def yaml_with_lists(path, lists):
    """configs/cam++.yml's text with its three list paths replaced (read
    back by the port's YAML reader); returns the path written."""
    with open(os.path.join(ROOT, "configs", "cam++.yml"),
              encoding="utf-8") as f:
        text = f.read()
    for key, value in zip(("train_list", "enroll_list", "trials_list"),
                          lists):
        old = f"  {key}: {CONFIG['dataset_conf'][key]}\n"
        assert old in text, old
        text = text.replace(old, f"  {key}: {value}\n")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return path


# ---- the single-card workflow -----------------------------------------------
def _held_features(lists, device):
    """Each ``*_features.txt`` array against the plain fbank on the card
    (``fbank_fused_reference``) of the same clip, padded to its bucket and
    trimmed as ``extract_features`` does: (max |d|, p99 |d|, arrays)."""
    from voiceprintrecognition_paddlepaddle_torch.data_utils import \
        SpeakerDataset
    from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import \
        bucket_length
    from voiceprintrecognition_paddlepaddle_torch.ops.fbank_kernel import \
        fbank_fused_reference

    diffs = []
    args = dict(CONFIG["dataset_conf"]["dataset"], max_duration=100)
    for src in lists:
        ds = SpeakerDataset(src, mode="extract_feature", **args)
        with open(src.replace(".txt", "_features.txt"),
                  encoding="utf-8") as f:
            saved = [ln.split("\t") for ln in f.read().splitlines()]
        assert len(saved) == len(ds), src
        for i, (path, label) in enumerate(saved):
            samples, want_label, _ = ds[i]
            pad = bucket_length(len(samples))
            x = torch.zeros((1, pad), device=device)
            x[0, :len(samples)] = torch.from_numpy(samples).to(device)
            ratio = torch.tensor([len(samples) / pad], device=device)
            with torch.no_grad():
                ref = features.apply_cmn_and_mask(
                    fbank_fused_reference(x, n_mels=80), ratio)[0]
            got = torch.from_numpy(np.load(path)).to(device)
            assert int(label) == int(want_label), path
            assert got.shape[0] <= ref.shape[0], path
            diffs.append((got - ref[:got.shape[0]]).abs().flatten())
    d = torch.cat(diffs)
    return (float(d.max()), float(torch.quantile(d[::7].double(), 0.99)),
            len(diffs))


def test_single_card_workflow(cuda, tmp_path):
    """Every command line reads configs/cam++.yml's text (its lists
    replaced) through the port's YAML reader. ``convert_paddle`` turns a
    seeded paddle state into model.pt equal to the in-process route, whose
    kernel-path embeddings hold within cos 0.999 of the eager model;
    ``extract_features`` writes the fbank kernel's features (one launch a
    clip) within 2e-2 (p99 1e-3) of the plain fbank; ``Trainer.train()``
    from them with remat and the bf16 Adam moment against neither (the
    first two losses within 1e-5, the next two 1e-2, the BN statistics
    after step 1 within 1e-6, no fbank launch); ``train(profiler_dir=...)``
    writes one trace naming the fbank kernel; the exported ``model.pt2``
    within cos 0.999 of the Predictor's kernel path at two batches and two
    lengths; ``infer_recognition`` registers two users and recognises a
    12 s clip through the kernels."""
    from voiceprintrecognition_paddlepaddle_torch.models.convert_paddle \
        import pdparams_to_torch_state

    work = str(tmp_path)
    # 64 train speakers x 4 clips of 3 s (b64: 4 steps, no crop), 4 eval
    # speakers x (2 enroll + 2 trials) clips of 3-8 s
    lists = synth_corpus(work, n_train=64, clips=4, train_s=(3.0, 3.0),
                         n_eval=4, enroll=2, trials=2, eval_s=(3.0, 8.0),
                         seed=SEED + 11)
    yml = yaml_with_lists(os.path.join(work, "cam++.yml"), lists)
    feat_yml = yaml_with_lists(os.path.join(work, "features.yml"), [
        p.replace(".txt", "_features.txt") for p in lists])

    # -- convert a paddle checkpoint (the command line) ------------------
    model_args = dict(CONFIG["model_conf"]["model_args"])
    model = CAMPPlus(80, **model_args)
    state = synth_pdparams(model, model_args, SEED)
    pdparams = os.path.join(work, "model.pdparams")
    with open(pdparams, "wb") as f:
        pickle.dump(state, f)
    converted = os.path.join(work, "converted")
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.convert_paddle", f"--configs={yml}",
         f"--pdparams={pdparams}", f"--output={converted}"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    cli_sd = torch.load(os.path.join(converted, "model.pt"), weights_only=True)
    ref_sd = pdparams_to_torch_state({k[2:]: v for k, v in state.items()},
                                     "CAMPPlus", 80,
                                     model_args=model_args)["model"]
    assert list(cli_sd) == list(ref_sd)
    assert all(torch.equal(cli_sd[k], ref_sd[k]) for k in ref_sd)
    model.load_state_dict(ref_sd)
    model.to(cuda).eval().requires_grad_(False)
    rng = np.random.RandomState(SEED + 11)
    # seven clips of 1-8 s and one of 12 s (the 16 s bucket)
    clips = [(rng.randn(int(s * 16000)) * 0.1).astype(np.float32)
             for s in list(rng.uniform(1.0, 8.0, 7)) + [12.0]]
    before = launches()
    pred = Predictor(yml, model_path=converted, device=cuda)
    embs = pred.predict_batch(clips)
    assert min(launches_since(before)) > 0
    assert min(cos_min(eager_embed(model, torch.from_numpy(c).to(cuda)[None]),
                       embs[i:i + 1]) for i, c in enumerate(clips)) > 0.999

    # -- extract_features (the command line, the fbank kernel) -----------
    _, fbank_launches, _ = run_cli("extract_features", [
        f"--configs={yml}", f"--device={cuda.type}",
        f"--save_dir={os.path.join(work, 'features')}"])
    d_max, d_p99, n = _held_features(lists, cuda)
    assert fbank_launches[0] == n and d_max < 2e-2 and d_p99 < 1e-3

    # -- train from the features at b64, with remat and the bf16 moment
    # and with neither ----------------------------------------------------
    runs = {}
    for name, extra in (("remat_bf16_moment",
                         {"train_conf.enable_remat": True,
                          "optimizer_conf.optimizer_args.mu_dtype":
                              "bfloat16"}), ("plain", {})):
        cfg = load_yaml(feat_yml)
        for key, value in extra.items():
            node = cfg
            *path, leaf = key.split(".")
            for k in path:
                node = node[k]
            node[leaf] = value
        tr = Trainer(cfg, device=cuda)
        run = {"losses": [], "stats": None}

        def step_and_snapshot(*args, _step=tr.train_step, _tr=tr, _run=run,
                              **kwargs):
            loss, acc = _step(*args, **kwargs)
            _run["losses"].append(loss)
            if _run["stats"] is None:
                _run["stats"] = {k: v.detach().clone() for k, v in
                                 _tr.model.state_dict().items()
                                 if "running" in k}
            return loss, acc

        tr.train_step = step_and_snapshot
        before = launches()
        tr.train(save_model_path="", log_dir="", do_eval=False, max_epochs=1)
        run["fbank"] = launches_since(before)[0]
        run["moments"] = {tr.optimizer.state[p]["exp_avg"].dtype
                          for p in tr.optimizer.param_groups[0]["params"]}
        run["losses"] = [float(x) for x in run["losses"]]
        runs[name] = run
    r, p = runs["remat_bf16_moment"], runs["plain"]
    bn_rel = max(float((r["stats"][k] - v).abs().max()
                       / v.abs().max().clamp_min(1e-30))
                 for k, v in p["stats"].items())
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], p["losses"])]
    assert len(r["losses"]) == len(p["losses"]) >= 4
    # update 0 runs at lr 0; then the bf16 moment's rounding
    assert max(loss_rel[:2]) <= 1e-5 and max(loss_rel[2:4]) <= 1e-2, loss_rel
    assert bn_rel <= 1e-6
    assert r["moments"] == {torch.bfloat16}
    assert r["fbank"] == p["fbank"] == 0

    # -- the profiler hook, from waveforms, 21 steps ---------------------
    cfg = load_yaml(yml)
    cfg["dataset_conf"]["sampler"]["batch_size"] = 12    # 21 steps
    prof_dir = os.path.join(work, "profile")
    tr = Trainer(cfg, device=cuda)
    before = launches()
    tr.train(save_model_path="", log_dir="", do_eval=False, max_epochs=1,
             profiler_dir=prof_dir)
    traces = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    assert tr.step >= 21 and len(traces) == 1
    assert launches_since(before)[0] == tr.step
    with open(traces[0], encoding="utf-8") as f:
        assert "fbank_kernel" in f.read()

    # -- export with a symbolic batch and length, reload, run ------------
    tr = Trainer(load_yaml(yml), device=cuda)
    infer = tr.export(save_model_path=os.path.join(work, "export"),
                      resume_model=converted, export_batch=None,
                      export_seconds=None)
    program = torch.export.load(os.path.join(infer, "model.pt2")).module()
    pred = Predictor(yml, model_path=infer, device=cuda)
    for frames in (298, 498):
        w = (rng.randn(3, 160 * frames + 240) * 0.1).astype(np.float32)
        want = pred.predict_batch(list(w))
        for b in (1, 3):
            with torch.no_grad():
                got = program(torch.from_numpy(w[:b]).to(cuda))
            assert cos_min(got, want[:b]) > 0.999, (frames, b)

    # -- infer_recognition: two users, then a 12 s clip (16 s bucket) ----
    third = os.path.join(work, "third.wav")
    write_wav(third, (np.sin(2 * np.pi * 140 * np.arange(192000) / 16000)
                      * 0.3 + 0.02 * rng.randn(192000)))
    wav = lambda n: os.path.join(ROOT, "dataset", f"{n}.wav")  # noqa: E731
    text, rec_launches, _ = run_cli("infer_recognition", [
        f"--configs={yml}", f"--device={cuda.type}",
        f"--model_path={converted}",
        f"--audio_db_path={os.path.join(work, 'db')}", "--threshold=-1.0",
        f"--register=alice={wav('a_1')}", f"--register=bob={wav('b_1')}",
        f"--recognize={third}"])
    lines = text.splitlines()
    assert any(ln.startswith("recognised speaker: ") for ln in lines), text
    assert "registered users: ['alice', 'bob']" in lines, text
    assert min(rec_launches) > 0


# ---- data parallelism on one card -------------------------------------------
DDP_STEPS = 4            # DDP steps held against one process
DDP_BATCH = 64           # the global batch: b32 on each of two ranks
# the bar on the cosine of the DDP run's parameter change against one
# process's. Adam's first steps move each weight by about the LR whatever
# its gradient's size, so weights of near-zero gradient move by rounding
# noise: on an NVIDIA H100 80GB HBM3 at 700 W two gloo ranks read
# 0.9984889 and the same steps with no gradient exchange 0.4309177 (and
# a loss 4.66e-2 apart); the fault must fail this bar and the loss's
DELTA_COS = 0.99


def _calibrated_bn(model, feats):
    """A copy of ``model`` whose BatchNorm running statistics are the
    cumulative averages of the batch statistics over ``feats`` (a list of
    ``(features, ratios)``), the rest of its weights unchanged."""
    import copy

    from voiceprintrecognition_paddlepaddle_torch.models.layers import \
        BatchNorm

    cal = copy.deepcopy(model).train()
    bns = [m for m in cal.modules() if isinstance(m, BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    with torch.no_grad():
        for x, lens in feats:
            cal(x, lengths=lens)
    for m in bns:
        m.momentum = 0.1
    return cal.eval()


class _fp32_convs:
    """cuDNN convs in true fp32 (TF32 off) inside the block."""

    def __enter__(self):
        self.tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.tf32
        return False


def test_data_parallel_on_one_card(cuda, tmp_path):
    """Two ranks on cuda:0 (gloo with CUDA tensors, the port's launcher)
    run ``DDP_STEPS`` DDP steps at b32 x 3 s each against one process at
    b64 on the same batches: the mean rank loss within 1e-3 relative, the
    parameters at cos >= 0.9999, their change over the steps at cos >=
    ``DELTA_COS``, the BN statistics within 1e-3, while the same steps
    with no gradient exchange fail both the loss's and the change's bar.
    ``evaluate()`` at world 2 gives world 1's EER and MinDCF within 1e-6,
    the gathered embeddings in rank order at cos >= 0.9999. One rank over
    NCCL takes a DDP step. Predictor serves the DCP checkpoint within cos
    0.9999 of model.pt, and ``Predictor(data_parallel=True, devices=
    [cuda:0, cuda:0])`` 11 clips of 1-8 s and one of 16 s within cos
    0.9999 of one device.

    cuDNN's convs run in true fp32 on both sides: in TF32 b32 and b64 take
    other algorithms, whose rounding moved the loss by 8e-4 relative
    within 4 steps, next to the 1e-3 bar; and with TF32 allowed cuDNN took
    a TF32 algorithm for some plain FCM conv in one process and a full
    fp32 one in another, in some runs only (rank 0's gathered embeddings
    at cos 0.9976661 of world 1's; NVIDIA H100 80GB HBM3, 700 W). Both
    evaluations embed the seeded initial weights with BN statistics
    calibrated on the held batches, one clip a batch: with the initial
    statistics every clip embeds nearly alike and the EER follows the
    order of near-equal scores (EERs 3.6e-2 apart from the same
    embeddings in another order, same card)."""
    nproc, work = 2, str(tmp_path)
    lists = synth_corpus(work)
    cfg64, _ = train_config(lists, **{"dataset_conf.eval_conf.batch_size": 1})
    cfg_rank, _ = train_config(lists, **{
        "dataset_conf.sampler.batch_size": DDP_BATCH // nproc,
        "dataset_conf.eval_conf.batch_size": 1,
        "train_conf.checkpoint_format": "orbax"})
    ref = Trainer(cfg64, device=cuda)
    ref._setup_dataloader(is_train=True)
    ref._setup_model(80, is_train=True)
    theta0 = {f"{part}.{k}": v.detach().clone()
              for part in ("model", "classifier")
              for k, v in getattr(ref, part).state_dict().items()}
    it = iter(ref.train_loader)
    batches = [next(it)[1:] for _ in range(DDP_STEPS)]
    cal = _calibrated_bn(ref.model, [
        (ref.featurize("waveforms", *(torch.from_numpy(a).to(cuda)
                                      for a in (data, lens))),
         torch.from_numpy(lens).to(cuda)) for data, _, lens in batches])
    eval_model = {k: v.cpu() for k, v in cal.state_dict().items()}
    del cal
    torch.cuda.empty_cache()
    ckpt = os.path.join(work, "ckpt")
    inputs = {"device": "cuda", "ddp": {
        "cfg": cfg_rank, "batches": batches, "eval_model": eval_model,
        "ckpt": ckpt}}
    (tmp_path / "ddp").mkdir()
    ranks = launch_ranks(tmp_path / "ddp", ["ddp_steps"], inputs, timeout=420,
                         nproc=nproc)
    n_cards = torch.cuda.device_count()
    for r in ranks:
        rank, world = r["rank_world"]
        s = r["ddp_steps"]
        assert world == nproc and s["ddp"] == "DistributedDataParallel"
        assert s["backend"] == ("nccl" if nproc <= n_cards else "gloo")
        assert s["device"] == f"cuda:{rank % n_cards}"
        assert s["train_launches"][0] == DDP_STEPS
        assert min(s["eval_launches"]) > 0
    r0 = ranks[0]["ddp_steps"]

    # -- one process at b64 on the same batches --------------------------
    with _fp32_convs():
        ref.model.train()
        ref.classifier.train()
        before, ref_losses = launches(), []
        for batch in batches:
            ref_losses.append(float(ref.train_step("waveforms", *(
                torch.from_numpy(a).to(cuda) for a in batch))[0]))
        assert launches_since(before)[0] == DDP_STEPS

    def mean_rel(key):
        means = [sum(x) / nproc
                 for x in zip(*(r["ddp_steps"][key] for r in ranks))]
        return max(abs(a - b) / abs(b) for a, b in zip(means, ref_losses))

    want = {f"{part}.{k}": v for part in ("model", "classifier")
            for k, v in getattr(ref, part).state_dict().items()}
    names = [n for n in ref.param_names if n in want]

    def flat(d, base=None):
        return torch.cat([(d[n].double().to(cuda) - (
            0 if base is None else base[n].double())).flatten()
            for n in names])

    def cos(a, b):
        return float((a @ b) / (a.norm() * b.norm()))

    step_want = flat(want, theta0)
    assert mean_rel("losses") < 1e-3
    assert cos(flat(r0["state"]), flat(want)) >= 0.9999
    assert cos(flat(r0["state"], theta0), step_want) >= DELTA_COS
    assert max(float((r0["state"][n].to(cuda) - want[n]).abs().max()
                     / max(float(want[n].abs().max()), 1e-6))
               for n in want if "running_" in n) <= 1e-3
    # the fault fails both bars
    assert cos(flat(r0["nosync_state"], theta0), step_want) < DELTA_COS
    assert mean_rel("nosync_losses") >= 1e-3

    # -- evaluate() at world 1 with the same weights ---------------------
    ev1 = Trainer(cfg64, device=cuda)
    ev1._setup_dataloader()
    ev1._setup_model(80)
    ev1.model.load_state_dict(eval_model)
    with _fp32_convs():
        before = launches()
        world1 = dict(zip(("eer", "min_dcf", "threshold"), ev1.evaluate()))
        assert min(launches_since(before)) > 0
    for r in ranks:
        for k in ("eer", "min_dcf"):
            assert abs(r["ddp_steps"]["eval"][k] - world1[k]) <= 1e-6, k
    # rank 0's gather against world 1's rows in rank order (rank r embeds
    # clips r, r + 2, ...)
    for part, (emb, labels) in ev1.eval_embeddings.items():
        order = np.concatenate([np.arange(len(labels))[r::nproc]
                                for r in range(nproc)])
        got, got_labels = r0["eval_embeddings"][part]
        assert np.array_equal(got_labels, labels[order])
        assert cos_min(got, emb[order]) >= 0.9999

    # -- NCCL at world 1 ---------------------------------------------------
    torch.cuda.empty_cache()
    (tmp_path / "nccl").mkdir()
    nccl = launch_ranks(tmp_path / "nccl", ["nccl_step"], inputs,
                        timeout=300, nproc=1)[0]["nccl_step"]
    assert nccl["backend"] == "nccl" and nccl["world"] == 1
    assert nccl["ddp"] == "DistributedDataParallel"
    assert np.isfinite(nccl["loss"]) and nccl["launches"][0] == 1

    # -- Predictor: the DCP checkpoint; data parallel ----------------------
    rng = np.random.RandomState(SEED + 12)
    clips = [(rng.randn(int(rng.uniform(1.0, 8.0) * 16000)) * 0.1)
             .astype(np.float32) for _ in range(11)]
    clips.append((rng.randn(16 * 16000) * 0.1).astype(np.float32))
    dcp = os.path.join(ckpt, "CAMPPlus_Fbank", "epoch_1")
    assert "model.dcp" in os.listdir(dcp)
    pt = os.path.join(work, "rank0_model.pt")
    torch.save({k[len("model."):]: v for k, v in r0["state"].items()
                if k.startswith("model.")}, pt)
    e_pt = Predictor(cfg64, model_path=pt, device=cuda).predict_batch(clips)
    e_dcp = Predictor(cfg64, model_path=dcp, device=cuda).predict_batch(clips)
    dp = Predictor(cfg64, model_path=dcp, device=cuda, data_parallel=True,
                   devices=[cuda, cuda] if n_cards == 1 else None)
    before = launches()
    e_dp = dp.predict_batch(clips)
    assert min(launches_since(before)) >= len(dp._replicas)
    assert cos_min(e_dcp, e_pt) >= 0.9999
    assert cos_min(e_dp, e_pt) >= 0.9999


# ---- a CAM++ trained on the card: diarization, tools, GUI actions ----------
F0S = (130, 210, 290, 370)   # tests/test_predictor.py: 130 + 80 * spk
TURN_S, GAP_S = 4.0, 0.8


def _tone_config(train_list):
    """``tests/test_predictor.py`` ``_configs`` with the stock CAM++ of
    ``configs/cam++.yml`` (192-d, its 80-mel Fbank) over 4 speakers, and
    the recipe of its diarization bar: 40 epochs, learning rate 0.05,
    ``dataset.seed`` 7."""
    import copy

    return {
        "dataset_conf": {
            "dataset": {"min_duration": 0.3, "max_duration": 1.0,
                        "sample_rate": 16000, "use_dB_normalization": True,
                        "target_dB": -20, "seed": 7},
            "sampler": {"batch_size": 8, "shuffle": True, "drop_last": True},
            # one loader thread: two draw the clips' crops from one
            # generator in whichever order the host schedules them
            "dataLoader": {"num_workers": 1},
            "eval_conf": {"batch_size": 4, "max_duration": 2},
            "train_list": train_list, "enroll_list": None,
            "trials_list": None},
        "preprocess_conf": copy.deepcopy(CONFIG["preprocess_conf"]),
        "model_conf": {"model": "CAMPPlus",
                       "model_args": dict(CONFIG["model_conf"]["model_args"]),
                       "classifier": {"classifier_type": "Cosine",
                                      "num_speakers": 4, "num_blocks": 0}},
        "loss_conf": {"loss": "AAMLoss",
                      "loss_args": {"margin": 0.2, "scale": 32}},
        "optimizer_conf": {"optimizer": "Adam", "optimizer_args": {},
                           "scheduler": "WarmupCosineSchedulerLR",
                           "scheduler_args": {"learning_rate": 0.05,
                                              "min_lr": 1.0e-5,
                                              "warmup_epoch": 1}},
        "train_conf": {"enable_amp": False, "max_epoch": 40,
                       "log_interval": 10},
    }


def _conversation(path, order, seed0):
    """Turns of ``TURN_S`` s by the speakers ``order`` (f0s of ``F0S``)
    with ``GAP_S`` s of silence between, fresh seeds; written to ``path``.
    Returns the reference [(start, end, "spk<k>")]."""
    pieces, reference, t0 = [], [], 0.0
    for i, spk in enumerate(order):
        pieces.append(tone(F0S[spk], TURN_S, seed=seed0 + 17 * i + spk))
        reference.append((t0, t0 + TURN_S, f"spk{spk}"))
        t0 += TURN_S
        if i != len(order) - 1:
            pieces.append(np.zeros(int(GAP_S * 16000), np.float32))
            t0 += GAP_S
    write_wav(path, np.concatenate(pieces))
    return reference


def _score(reference, segments, path):
    """DER of ``segments`` after a round trip through an RTTM file at
    ``path`` (the port's ``write_rttm`` / ``load_rttm``), detailed."""
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.der import (
        diarization_error_rate, load_rttm, write_rttm)

    with open(path, "w", encoding="utf-8") as f:
        write_rttm(f, "synth", segments)
    return diarization_error_rate(reference, load_rttm(path)["synth"],
                                  detailed=True)


def _names_ok(reference, hypothesis):
    """Each reference turn's most-overlapping hypothesis label is the
    turn's own speaker name."""
    for s, e, name in reference:
        overlap = {}
        for hs, he, label in hypothesis:
            overlap[label] = overlap.get(label, 0.0) + max(
                0.0, min(e, he) - max(s, hs))
        if not overlap or max(overlap, key=overlap.get) != name:
            return False
    return True


class _deterministic:
    """cuDNN's deterministic algorithms without autotuning and PyTorch's
    deterministic kernels inside the block, so that the tone training
    gives the same weights, and so the same diarization, on every run (an
    op with no deterministic version warns, and the warnings are kept
    quiet)."""

    def __enter__(self):
        self.saved = (torch.are_deterministic_algorithms_enabled(),
                      torch.is_deterministic_algorithms_warn_only_enabled(),
                      torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark,
                      os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("ignore")
        return self

    def __exit__(self, *exc):
        self._catch.__exit__(*exc)
        on, warn_only, det, bench, cublas = self.saved
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        return False


class _kaldi_featurizer:
    """The Predictor's Fbank and masked CMN through ``kaldi.fbank`` (plain
    PyTorch in fp32): a featurizer that launches no kernel."""
    dither = 0.0

    def __init__(self, method_args):
        self.method_args = dict(method_args)

    def __call__(self, waveforms, input_lens_ratio=None, rng=None):
        return features.apply_cmn_and_mask(
            kaldi.fbank(waveforms, **self.method_args), input_lens_ratio)


def _chunk_cos(pred, plain, chunks):
    """The least cosines of the diarization chunk embeddings: as served
    (``predict_batch``: the kernel path, each chunk padded to its bucket)
    against the plain version of the same padded batch
    (``fbank_fused_reference``, ``fcm_reference``,
    ``trunk_stats_reference``); and the kernel path at exact length
    against the fp32 model at exact length (``kaldi.fbank``, CMN, the
    eager CAM++): the kernels' bf16 design alone."""
    from voiceprintrecognition_paddlepaddle_torch.data_utils.collate import \
        bucket_length
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models import \
        trunk_kernel as tk
    from voiceprintrecognition_paddlepaddle_torch.ops.fbank_kernel import \
        fbank_fused_reference

    model, dev = pred.model, pred.device
    n = len(chunks[0])
    assert all(len(c) == n for c in chunks)
    exact = torch.from_numpy(np.stack(chunks)).to(dev)
    length = bucket_length(n)
    padded = torch.nn.functional.pad(exact, (0, length - n))
    ratios = np.full(len(chunks), n / length, np.float32)
    with torch.no_grad():
        served = pred.predict_batch(chunks)
        feats = features.apply_cmn_and_mask(
            fbank_fused_reference(padded, sr=16000, n_mels=80), ratios)
        t_valid, _ = tk.trunk_geometry(feats.shape[1])
        stats = tk.trunk_stats_reference(
            tk.pack_trunk(model),
            fkm.fcm_reference(fkm.pack_fcm(model), feats),
            tk.tvalids_from_ratios(ratios, t_valid))
        plain_version = model.DenseBN_0(stats).float()
        kernel_exact = pred._embed(exact, None)
        with _fp32_convs():
            fp32_exact = model(plain._audio_featurizer(exact)).float()
    return cos_min(served, plain_version), cos_min(kernel_exact, fp32_exact)


def test_trained_campplus_diarizes_and_evaluates(cuda, tmp_path):
    """The stock CAM++ (192-d) trained on the card by the port's Trainer
    on 4 tone speakers x 4 clips of 1.2 s (``tests/test_predictor.py``'s
    diarization recipe: 40 epochs, lr 0.05, seed 7; deterministic
    algorithms, one loader thread). A 6-turn 3-speaker conversation
    diarized with ``speaker_num=3`` through the kernel path and through
    the fp32 plain model (``kaldi.fbank``, the eager CAM++, no kernel
    launched): 3 speakers, DER < 0.20 and confusion < 0.05 after an RTTM
    round trip on each; the chunk embeddings as served within cos 0.9999
    of the plain version of the same padded batch, and the kernel path at
    exact length within cos 0.999 of the fp32 model. The RTTM flow
    (``infer_data`` and ``compute_metrics`` as child processes) over two
    conversations with their own audio db: DER < 0.20, each turn named.
    ``eval_from_paddle`` (a child process) on the trained weights written
    as a .pdparams (converted back bit-equal) over 8 tone speakers' clips
    of 3-20 s: equal to an in-process ``Trainer.evaluate`` within 1e-6,
    ``--predict`` to ``Predictor.contrast`` within 1e-5. The GUI actions:
    contrast verdicts, register and recognise, the streaming window, the
    diarization action."""
    from voiceprintrecognition_paddlepaddle_torch import (
        infer_contrast_gui, infer_recognition_gui,
        infer_speaker_diarization_gui)
    from voiceprintrecognition_paddlepaddle_torch.infer_utils.der import (
        load_rttm, write_rttm)

    work = str(tmp_path)
    # -- train the stock CAM++ on 4 tone speakers --------------------------
    lines = []
    for spk, f0 in enumerate(F0S):
        for u in range(4):
            p = os.path.join(work, f"s{spk}_u{u}.wav")
            write_wav(p, tone(f0, 1.2, seed=spk * 10 + u))
            lines.append(f"{p}\t{spk}")
    train_list = os.path.join(work, "train_list.txt")
    with open(train_list, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    cfg = _tone_config(train_list)
    with _deterministic():
        tr = Trainer(cfg, device=cuda)
        tr.train(save_model_path="", log_dir="", do_eval=False)
    model_pt = os.path.join(work, "model", "model.pt")
    os.makedirs(os.path.dirname(model_pt))
    torch.save({k: v.detach().cpu() for k, v in
                tr.model.state_dict().items()}, model_pt)
    trained = tr.model
    del tr

    # -- the quality bar: the kernel path, then the fp32 model ------------
    conv = os.path.join(work, "conversation.wav")
    reference = _conversation(conv, [0, 1, 2, 0, 1, 2], 0)
    pred = Predictor(cfg, model_path=model_pt, device=cuda)
    assert pred._embed is not None, "the stock CAM++ takes the kernel path"
    before = launches()
    segs = pred.speaker_diarization(conv, speaker_num=3)
    rise = launches_since(before)
    assert rise[0] > 0 and rise[2] > 0, rise
    plain = Predictor(cfg, model_path=model_pt, device=cuda)
    plain._embed = None
    plain._replicas = [(d, m, None) for d, m, _ in plain._replicas]
    plain._audio_featurizer = _kaldi_featurizer(
        cfg["preprocess_conf"]["method_args"])
    before = launches()
    with _fp32_convs():
        segs32 = plain.speaker_diarization(conv, speaker_num=3)
    assert launches_since(before) == [0, 0, 0]
    for name, s in (("kernel path", segs), ("fp32", segs32)):
        r = _score(reference, s, os.path.join(work, "hyp.rttm"))
        assert len({x["speaker"] for x in s}) == 3, (name, s)
        assert r["diarization error rate"] < 0.20, (name, r)
        assert r["confusion"] < 0.05, (name, r)
    chunks = [np.asarray(c[2], np.float32) for c in
              pred.speaker_diarize.segments_audio(pred._load_audio(conv))]
    served, exact = _chunk_cos(pred, plain, chunks)
    assert served >= 0.9999 and exact >= 0.999, (served, exact)

    # -- the RTTM flow: infer_data and compute_metrics -------------------
    db_root = os.path.join(work, "audio_db")
    data_list = os.path.join(work, "data_list.txt")
    refs = {}
    with open(data_list, "w", encoding="utf-8") as f:
        for c, (name, order) in enumerate((("conv_a", [0, 2, 1, 2, 0, 1]),
                                           ("conv_b", [1, 0, 2, 0, 2, 1]))):
            path = os.path.join(work, f"{name}.wav")
            refs[name] = _conversation(path, order, 1000 * (c + 1))
            f.write(f"{path}\t{name}\n")
            for spk in range(3):
                d = os.path.join(db_root, name, f"spk{spk}")
                os.makedirs(d)
                for n in range(2):
                    write_wav(os.path.join(d, f"{n}.wav"), tone(
                        F0S[spk], 2.0, seed=5000 + 100 * c + 10 * spk + n))
    references = os.path.join(work, "references.rttm")
    with open(references, "w", encoding="utf-8") as f:
        for name, ref in refs.items():
            write_rttm(f, name, [{"speaker": s, "start": a, "end": b}
                                 for a, b, s in ref])
    hypotheses = os.path.join(work, "hypotheses.rttm")
    _, rise, _ = run_cli("eval_speaker_diarization.infer_data", [
        "--configs=configs/cam++.yml", f"--device={cuda.type}",
        f"--model_path={model_pt}", f"--data_list_path={data_list}",
        f"--result_path={hypotheses}", f"--audio_db_path={db_root}"])
    assert rise[0] > 0 and rise[2] > 0, rise
    text, _, metrics = run_cli("eval_speaker_diarization.compute_metrics",
                               [f"--references={references}",
                                f"--hypotheses={hypotheses}"])
    hyp = load_rttm(hypotheses)
    assert metrics["diarization error rate"] < 0.20, text
    assert all(_names_ok(refs[name], hyp.get(name, [])) for name in refs), hyp

    # -- eval_from_paddle on the trained weights as a .pdparams ----------
    pd_dir = os.path.join(work, "paddle")
    os.makedirs(pd_dir)
    rng = np.random.RandomState(SEED + 13)
    lists = [os.path.join(pd_dir, f"{p}_list.txt")
             for p in ("train", "enroll", "trials")]
    with open(lists[0], "w", encoding="utf-8") as f:
        f.write(f"{os.path.join(work, 's0_u0.wav')}\t0\n")
    for part, n, path in (("enroll", 1, lists[1]), ("trials", 2, lists[2])):
        with open(path, "w", encoding="utf-8") as f:
            # the 4 trained speakers and 4 between them
            for k, f0 in enumerate(sorted(F0S + (170, 250, 330, 410))):
                for u in range(n):
                    p = os.path.join(pd_dir, f"{part}{k}_{u}.wav")
                    write_wav(p, tone(f0, rng.uniform(3.0, 20.0),
                                      seed=9000 + 10 * k + u + n))
                    f.write(f"{p}\t{k}\n")
    yml = yaml_with_lists(os.path.join(pd_dir, "cam.yml"), lists)
    pdparams = os.path.join(pd_dir, "model.pdparams")
    with open(pdparams, "wb") as f:
        pickle.dump(pdparams_of(trained, dict(
            CONFIG["model_conf"]["model_args"])), f)
    converted = os.path.join(pd_dir, "converted")
    common = ["--configs", yml, "--pdparams", pdparams, "--workdir",
              converted, "--device", cuda.type]
    _, rise, got = run_cli("eval_from_paddle", common)
    assert min(rise) > 0
    back = torch.load(os.path.join(converted, "model.pt"), weights_only=True)
    assert all(torch.equal(back[k].cpu(), v.cpu()) for k, v in
               trained.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    want = Trainer(load_yaml(yml), device=cuda).evaluate(
        resume_model=converted)
    for k, w in zip(("eer", "min_dcf", "threshold"), want):
        assert abs(got[k] - w) <= 1e-6, (k, got[k], w)
    with open(lists[1], encoding="utf-8") as f:
        a = [ln.split("\t")[0] for ln in f.read().splitlines()]
    _, _, pr = run_cli("eval_from_paddle", common + ["--predict", a[0], a[1]])
    score = Predictor(load_yaml(yml), model_path=converted,
                      device=cuda).contrast(a[0], a[1])
    assert abs(pr["score"] - score) <= 1e-5

    # -- the GUI actions on the trained checkpoint -----------------------
    clip = {}
    for key, (spk, seed) in {"s0_a": (0, 7000), "s0_b": (0, 7001),
                             "s0_c": (0, 7002), "s1": (1, 7003)}.items():
        clip[key] = os.path.join(work, f"{key}.wav")
        write_wav(clip[key], tone(F0S[spk], 2.0, seed=seed))
    stream = tone(F0S[0], 3.0, seed=7004)
    contrast = infer_contrast_gui.ContrastActions(pred, 0.6)
    assert contrast.compare(clip["s0_a"], clip["s0_b"]).startswith("SAME")
    assert contrast.compare(clip["s0_a"], clip["s1"]).startswith("DIFFERENT")
    rec = infer_recognition_gui.RecognitionActions(Predictor(
        cfg, model_path=model_pt, device=cuda,
        audio_db_path=os.path.join(work, "gui_db")))
    assert rec.register(clip["s0_a"], "alice")[0]
    assert rec.recognise(clip["s0_c"]).startswith("speaker: alice")
    window = infer_recognition_gui.StreamWindow(16000)
    texts = [rec.stream_block(window, stream[i:i + 1024])
             for i in range(0, len(stream), 1024)]
    heard = [x for x in texts if x is not None]
    assert len(heard) == len(texts) - 15
    assert heard[-1].startswith("speaker: alice")
    diar, diar_text = infer_speaker_diarization_gui.DiarizationActions(
        pred).diarize(conv, "3")
    assert diar == segs and diar_text.count("\n") == len(segs)
