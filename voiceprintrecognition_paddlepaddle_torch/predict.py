"""Inference surface: embeddings, 1:1 contrast, 1:N recognition over a
persistent audio database, and speaker diarization (counterpart of the
JAX ``predict.py``).

Every config in ``configs/`` is served: CAM++, ECAPA-TDNN, TDNN,
Res2Net, ResNetSE, ERes2Net and ERes2NetV2, on any feature method.

The kernel path is ``trunk_kernel.make_campplus_masked_embed_fn``: the
fbank kernel, CMN, the FCM kernel, the whole-trunk kernel and the
DenseBN head. On ``device="cuda"`` it runs the CUDA kernels and never falls back;
on ``device="cpu"`` the same wrappers run their plain PyTorch versions.
Batches pad to bucketed lengths and carry per-utterance length ratios, so
a padded clip gives its exact-length embedding.

Which path a batch takes is decided as in the JAX ``Predictor``:

- by the configuration, once, in ``__init__`` (JAX
  ``_maybe_make_fast_embed``, ``predict.py:116-133``): the kernel path
  serves exactly the stock CAM++ (growth 32, init_channels 128, bn_size 4,
  the ``batchnorm-relu`` stack the trunk kernel folds) on the 80-mel
  Fbank front end without dither; any other configuration, every other
  backbone included, runs the plain model for every batch;
- by the bucket length (``predict.py:382-407``): buckets longer than
  ``MAX_KERNEL_BUCKET_SAMPLES`` (32 s) run the plain model.

The plain path is the features, then ``model.forward(feats,
lengths=ratios)`` on the same device, the JAX ``_embed_impl``. Its
featurizing goes through the fbank kernel whenever the Fbank options are
the stock ones (``features.fbank_dispatch``); the backbones run as cuDNN
and cuBLAS calls in fp32 under PyTorch's default precision (convs may use
TF32, matmuls do not). With Fbank dither on, the plain path draws its
noise from a generator seeded 0 for every batch, as JAX ``_embed_impl``
uses a fixed key, so inference stays deterministic.

``Predictor(data_parallel=True)`` splits each chunk of at least as many
clips as devices over every visible CUDA device (or over ``devices``, a
list that may name one device twice), as the JAX ``Predictor`` shards over
its local mesh (``predict.py:340-380``): the chunk pads with zero clips of
ratio 1 to the device count times a power of two, each device embeds its
equal share (a slice of the one staged chunk) with a replica of the model
and its own packed kernel weights, under ``torch.cuda.device`` on that
device's current stream, and the padding rows are dropped. Smaller chunks
run on the first device; with one device the path is the plain one.

A checkpoint directory's ``model.dcp/`` (``torch.distributed.checkpoint``,
``train_conf.checkpoint_format: orbax``) is read before its ``model.pt``,
as JAX reads ``model.orbax/`` before ``model.msgpack``.

The audio database keeps the JAX package's pickle ``audio_indexes.bin``
format (users_name / faces_feature / users_image_path).
"""

import copy
import itertools
import os
import pickle
import shutil
import threading
from contextlib import nullcontext
from io import BufferedReader

import numpy as np
import torch

from .data_utils.collate import bucket_length
from .infer_utils.speaker_diarization import SpeakerDiarization
from .models import build_model
from .models.campplus import CAMPPlus
from .models.trunk_kernel import make_campplus_masked_embed_fn
from .ops.audio import AudioSegment
from .ops.features import AudioFeaturizer
from .utils.checkpoint import find_weights, read_weights
from .utils.config import load_yaml
from .utils import tracing
from .utils.logger import logger
from .utils.utils import dict_to_object

__all__ = ["Predictor", "PPVectorPredictor", "MAX_KERNEL_BUCKET_SAMPLES",
           "campplus_kernel_path_applies"]

# longest bucket the kernel path serves: 32 s at 16 kHz (3198 frames, the
# trunk kernel's MAX_T_RAW); the JAX Predictor's 640,000-sample fast-path
# cap admits the same buckets
MAX_KERNEL_BUCKET_SAMPLES = 512000


def campplus_kernel_path_applies(model, featurizer):
    """The stock CAM++ on the 80-mel Fbank front end without dither (JAX
    ``_maybe_make_fast_embed``, ``predict.py:123-133``): the configuration
    the kernel path serves."""
    return (isinstance(model, CAMPPlus) and model.growth_rate == 32
            and model.init_channels == 128 and model.bn_size == 4
            and model.config_str == "batchnorm-relu"
            and featurizer.feature_method == "Fbank"
            and featurizer.feature_dim == 80 and featurizer.dither == 0.0)


def _load_configs(configs):
    """A config dict, or a YAML path read by ``utils.config`` (no PyYAML,
    one reader on every host)."""
    if isinstance(configs, str):
        configs = load_yaml(configs)
    return dict_to_object(configs)


class Predictor:
    def __init__(self, configs, threshold=0.6, audio_db_path=None,
                 model_path="models/CAMPPlus_Fbank/best_model/model.pt",
                 device="cuda", data_parallel=False, devices=None):
        """``model_path``: a torch ``state_dict`` file, a DCP directory, or
        a checkpoint directory holding ``model.dcp/`` or ``model.pt``.
        ``device``: ``"cuda"`` (default) raises when no CUDA device is
        present; pass ``"cpu"`` for the plain PyTorch versions.
        ``data_parallel``: split each chunk over ``devices`` (default:
        every visible CUDA device, or ``device`` alone on the CPU); the
        first of them is the one device of the plain path."""
        if (data_parallel and not devices
                and torch.device(device).type == "cuda"):
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        if data_parallel and devices:
            device = devices[0]
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Predictor(device='cuda') needs a CUDA device; "
                               "pass device='cpu' to run on the CPU")
        self.configs = _load_configs(configs)
        self.threshold = threshold
        self._audio_featurizer = AudioFeaturizer(
            feature_method=self.configs.preprocess_conf.feature_method,
            method_args=self.configs.preprocess_conf.get("method_args", {}))
        self.model = build_model(self._audio_featurizer.feature_dim,
                                 self.configs)
        if (os.path.isdir(model_path) and not os.path.exists(
                os.path.join(model_path, ".metadata"))):
            model_path = find_weights(model_path)
        if not os.path.exists(model_path):
            raise FileNotFoundError(f"model not found: {model_path}")
        self.model.load_state_dict(read_weights(model_path))
        self.model.to(self.device).eval()
        logger.info(f"loaded model weights: {model_path}")
        kernel_path = campplus_kernel_path_applies(self.model,
                                                   self._audio_featurizer)
        # (device, model, kernel-path embed or None) per replica
        self._replicas = []
        for i, dev in enumerate([self.device] + [
                torch.device(d) for d in (devices or [])[1:]]):
            model = self.model if i == 0 else copy.deepcopy(self.model).to(dev)
            embed = (make_campplus_masked_embed_fn(model,
                                                   self._audio_featurizer)
                     if kernel_path else None)
            self._replicas.append((dev, model, embed))
        if len(self._replicas) > 1:
            logger.info(f"data-parallel serving over "
                        f"{[str(d) for d, _, _ in self._replicas]}")
        self._embed = self._replicas[0][2]
        self._calls = itertools.count()     # the ``id`` of each call's spans
        # chunks staged, and those staged in pinned memory (predict_batch)
        self.chunks = 0
        self.pinned_chunks = 0
        self._count_lock = threading.Lock()
        if kernel_path and self.device.type == "cuda":
            # build and load the kernels now, not in a first request
            from ._build import kernel_library
            kernel_library()

        # voiceprint database state (reference ``predict.py:69-86``)
        self.audio_feature = None
        self.audio_feature_mean = None
        self.users_name = []
        self.users_audio_path = []
        self.users_name_mean = []
        self.audio_db_path = audio_db_path
        if self.audio_db_path is not None:
            self.audio_indexes_path = os.path.join(audio_db_path,
                                                   "audio_indexes.bin")
            self.__load_audio_db(self.audio_db_path)
        self.speaker_diarize = SpeakerDiarization()

    # ------------------------------------------------------------------
    # audio db persistence (pickle format of reference predict.py:89-109)
    # ------------------------------------------------------------------
    def __load_audio_indexes(self):
        if not os.path.exists(self.audio_indexes_path):
            return
        with open(self.audio_indexes_path, "rb") as f:
            indexes = pickle.load(f)
        for name, feature, path in zip(indexes["users_name"],
                                       indexes["faces_feature"],
                                       indexes["users_image_path"]):
            if not os.path.exists(path):
                continue
            self.users_name.append(name)
            self.users_audio_path.append(path)
            feature = np.asarray(feature)
            self.audio_feature = (
                feature[None] if self.audio_feature is None
                else np.vstack((self.audio_feature,
                                feature[None] if feature.ndim == 1
                                else feature)))

    def __write_index(self):
        with open(self.audio_indexes_path, "wb") as f:
            pickle.dump({"users_name": self.users_name,
                         "faces_feature": self.audio_feature,
                         "users_image_path": self.users_audio_path}, f)

    def __load_audio_db(self, audio_db_path):
        self.__load_audio_indexes()
        os.makedirs(audio_db_path, exist_ok=True)
        audios_path = []
        for name in sorted(os.listdir(audio_db_path)):
            audio_dir = os.path.join(audio_db_path, name)
            if not os.path.isdir(audio_dir):
                continue
            for file in sorted(os.listdir(audio_dir)):
                audios_path.append(
                    os.path.join(audio_dir, file).replace("\\", "/"))
        if len(audios_path) == 0 and self.audio_feature is None:
            return
        logger.info("loading voiceprint database...")
        batch_size = self.configs.dataset_conf.eval_conf.batch_size
        pending = []
        for audio_path in audios_path:
            if audio_path in self.users_audio_path:
                continue
            seg = self._load_audio(audio_path)
            self.users_name.append(os.path.basename(
                os.path.dirname(audio_path)))
            self.users_audio_path.append(audio_path)
            pending.append(seg.samples)
            if len(pending) == batch_size:
                self._append_features(pending)
                pending = []
        if pending:
            self._append_features(pending)
        if not (self.audio_feature is None
                or len(self.audio_feature) == len(self.users_name)
                == len(self.users_audio_path)):
            raise RuntimeError("voiceprint database count mismatch")
        self.__write_index()
        self._recompute_means()
        logger.info(f"voiceprint database ready: "
                    f"{len(self.users_name_mean)} users "
                    f"({self.users_name_mean})")

    def _append_features(self, samples_list):
        feats = self.predict_batch(samples_list)
        self.audio_feature = (feats if self.audio_feature is None
                              else np.vstack((self.audio_feature, feats)))

    def _recompute_means(self):
        self.users_name_mean = []
        self.audio_feature_mean = None
        if self.audio_feature is None:
            return
        for name in sorted(set(self.users_name)):
            rows = [i for i, n in enumerate(self.users_name) if n == name]
            mean = self.audio_feature[rows].mean(axis=0)
            self.audio_feature_mean = (
                mean[None] if self.audio_feature_mean is None
                else np.vstack((self.audio_feature_mean, mean[None])))
            self.users_name_mean.append(name)

    # ------------------------------------------------------------------
    @staticmethod
    def normalize_features(features):
        return features / np.linalg.norm(features, axis=1, keepdims=True)

    @staticmethod
    def cosine_score(f1, f2):
        """Cosine similarity between two 1-D embeddings."""
        return float(np.dot(f1, f2)
                     / (np.linalg.norm(f1) * np.linalg.norm(f2)))

    def __retrieval(self, np_feature, threshold=None):
        """Cosine retrieval against per-user mean voiceprints."""
        if threshold is None:
            threshold = self.threshold
        feats = self.normalize_features(np.asarray(np_feature, np.float32))
        means = self.normalize_features(
            self.audio_feature_mean.astype(np.float32))
        results = []
        for sim in feats @ means.T:
            idx = int(np.argmax(sim))
            score = float(sim[idx])
            if score >= threshold:
                results.append([self.users_name_mean[idx], round(score, 5)])
            else:
                results.append([None, None])
        return results

    def retrieve(self, np_features, threshold=None):
        """Public cosine retrieval: ``(N, D)`` embeddings -> list of
        ``[name, score]`` / ``[None, None]`` rows (serving front ends that
        embed through a batcher call this with ready features).
        ``threshold`` overrides ``self.threshold`` for this call only."""
        return self.__retrieval(np_features, threshold=threshold)

    def _load_audio(self, audio_data, sample_rate=16000):
        """Accepts path / file object / bytes / ndarray / AudioSegment."""
        if isinstance(audio_data, (str, BufferedReader)):
            segment = AudioSegment.from_file(audio_data)
        elif isinstance(audio_data, np.ndarray):
            segment = AudioSegment.from_ndarray(audio_data, sample_rate)
        elif isinstance(audio_data, bytes):
            segment = AudioSegment.from_bytes(audio_data)
        elif isinstance(audio_data, AudioSegment):
            segment = audio_data
        else:
            raise TypeError(f"unsupported audio type: {type(audio_data)}")
        ds_conf = self.configs.dataset_conf.dataset
        if segment.duration < ds_conf.min_duration:
            raise ValueError(f"audio too short: minimum "
                             f"{ds_conf.min_duration}s, got "
                             f"{segment.duration}s")
        if segment.sample_rate != ds_conf.sample_rate:
            segment.resample(ds_conf.sample_rate)
        if ds_conf.use_dB_normalization:
            segment.normalize(target_db=ds_conf.target_dB)
        return segment

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def predict(self, audio_data, sample_rate=16000):
        """Single-utterance embedding."""
        seg = self._load_audio(audio_data, sample_rate)
        return self.predict_batch([seg.samples])[0]

    def predict_batch(self, audios_data, sample_rate=16000, batch_size=32):
        """Batched embeddings: each chunk pads to its bucket length and
        carries per-utterance length ratios. A configuration off the kernel
        path, and chunks whose bucket is longer than
        ``MAX_KERNEL_BUCKET_SAMPLES``, run the plain model. With
        ``data_parallel``, a chunk of at least as many clips as devices is
        split over them (the module docstring).

        A chunk is staged once (``_stage``): on a CUDA device into pinned
        host memory from PyTorch's caching host allocator, which hands the
        same block back call after call and keeps it from reuse until the
        non-blocking copies from it have finished, so concurrent calls
        need no lock; on the CPU into ordinary numpy memory. Each row gets
        its clip and a zeroed tail, rows past the chunk are zeroed with
        ratio 1. The waves, and on the plain path the ratios, go to the
        device without blocking the host (the kernel path's embed function
        sends its per-utterance values the same way); a chunk's one host
        sync is its ``.cpu()``. The pinned memory held is the next power
        of two above a chunk's bytes, per bucket size and per call in
        flight: 32 MiB for 64 clips at the 8 s bucket.

        Counters: ``chunks``, the chunks staged; ``pinned_chunks``, those
        staged in pinned memory and copied without blocking. Spans:
        ``vpr.predict`` (the call's number as ``id``) around
        ``vpr.predict.stage``, ``.copy_in``, ``.model`` and ``.copy_out``
        of each chunk."""
        with tracing.span("vpr.predict", id=next(self._calls)):
            samples = []
            for audio in audios_data:
                if isinstance(audio, np.ndarray) and audio.dtype == np.float32:
                    samples.append(audio)
                else:
                    samples.append(self._load_audio(audio, sample_rate).samples)
            n_dev = len(self._replicas)
            features = []
            for i in range(0, len(samples), batch_size):
                chunk = samples[i:i + batch_size]
                with tracing.span("vpr.predict.stage"):
                    # data parallel: n_dev x a power of two rows, as JAX pads
                    use_dp = n_dev > 1 and len(chunk) >= n_dev
                    b_pad = n_dev if use_dp else len(chunk)
                    while b_pad < len(chunk):
                        b_pad *= 2
                    waves, ratios = self._stage(chunk, b_pad)
                if use_dp:
                    share = b_pad // n_dev
                    # launch every share first, then copy back: the devices
                    # work at once
                    embs = [self._embed_on(r, waves[r * share:(r + 1) * share],
                                           ratios[r * share:(r + 1) * share])
                            for r in range(n_dev)]
                    with tracing.span("vpr.predict.copy_out"):
                        emb = torch.cat([e.cpu() for e in embs])[:len(chunk)]
                else:
                    emb = self._embed_on(0, waves, ratios)
                    with tracing.span("vpr.predict.copy_out"):
                        emb = emb.cpu()
                features.append(emb.numpy())
            return np.concatenate(features, axis=0)

    def _staging(self, b_pad, max_len):
        """Uninitialised ``(b_pad, max_len)`` waves and ``(b_pad,)`` ratios,
        float32 CPU tensors: pinned on a CUDA device, else numpy memory."""
        if self.device.type == "cuda":
            return (torch.empty((b_pad, max_len), dtype=torch.float32,
                                pin_memory=True),
                    torch.empty((b_pad,), dtype=torch.float32,
                                pin_memory=True))
        return (torch.from_numpy(np.empty((b_pad, max_len), np.float32)),
                torch.from_numpy(np.empty((b_pad,), np.float32)))

    def _stage(self, chunk, b_pad):
        """The chunk padded to its bucket in ``b_pad`` rows, and its ratios:
        every element of the staging written, each row's tail and the rows
        past the chunk zeroed (the fbank reads them), those rows' ratios
        1."""
        max_len = bucket_length(max(len(s) for s in chunk))
        waves, ratios = self._staging(b_pad, max_len)
        w, r = waves.numpy(), ratios.numpy()
        for j, s in enumerate(chunk):
            w[j, :len(s)] = s
            w[j, len(s):] = 0.0
            r[j] = len(s) / max_len
        w[len(chunk):] = 0.0
        r[len(chunk):] = 1.0
        with self._count_lock:
            self.chunks += 1
            self.pinned_chunks += waves.is_pinned()
        return waves, ratios

    def _embed_on(self, replica, waves, ratios):
        """Embeddings of the staged CPU batch ``waves`` and its ``ratios``
        on the device of ``replica`` (a tensor there): the kernel path for
        buckets up to ``MAX_KERNEL_BUCKET_SAMPLES`` where it applies, with
        the ratios on the host for its tile schedule; else the plain model,
        with the ratios copied beside the waves."""
        dev, model, embed = self._replicas[replica]
        if replica == 0:
            embed = self._embed
        kernel = (embed is not None
                  and waves.shape[1] <= MAX_KERNEL_BUCKET_SAMPLES)
        guard = torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
        with guard:
            with tracing.span("vpr.predict.copy_in"):
                waves_t = waves.to(dev, non_blocking=True)
                if not kernel:
                    ratios = ratios.to(dev, non_blocking=True)
            with tracing.span("vpr.predict.model"):
                if kernel:
                    ratios = ratios.numpy()
                    exact = bool(np.all(ratios == 1.0))
                    return embed(waves_t, None if exact else ratios)
                return self._embed_plain(waves_t, ratios, model)

    @torch.no_grad()
    def _embed_plain(self, waves, ratios, model=None):
        """The plain model (``self.model`` unless given) on a padded batch
        on its device (JAX ``_embed_impl``): masked CMN, then
        ``model.forward`` with length-aware pooling, both reading the
        ``(B,)`` float32 tensor ``ratios`` on that device. Dither, when on,
        comes from a generator seeded 0 (JAX's fixed key)."""
        rng = None
        if self._audio_featurizer.dither > 0:
            rng = torch.Generator(device=waves.device)
            rng.manual_seed(0)
        feats = self._audio_featurizer(waves, input_lens_ratio=ratios,
                                       rng=rng)
        return (model or self.model)(feats, lengths=ratios).float()

    def contrast(self, audio_data1, audio_data2):
        """1:1 cosine similarity."""
        return self.cosine_score(self.predict(audio_data1),
                                 self.predict(audio_data2))

    def register(self, audio_data, user_name: str, sample_rate=16000):
        """Add a voiceprint: writes ``audio_db/<user>/N.wav`` and updates
        the pickle index and the per-user mean."""
        if (not user_name or ".." in user_name
                or any(c in user_name for c in ("/", "\\", "\x00"))):
            # the name becomes a directory under audio_db — never let it
            # traverse outside (serving front ends pass client input here)
            return False, f"invalid user name: {user_name!r}"
        seg = self._load_audio(audio_data, sample_rate)
        feature = self.predict(seg)
        self.audio_feature = (feature[None] if self.audio_feature is None
                              else np.vstack((self.audio_feature,
                                              feature[None])))
        user_dir = os.path.join(self.audio_db_path, user_name)
        n = len(os.listdir(user_dir)) if os.path.exists(user_dir) else 0
        audio_path = os.path.join(user_dir, f"{n}.wav")
        os.makedirs(user_dir, exist_ok=True)
        seg.to_wav_file(audio_path)
        self.users_audio_path.append(audio_path.replace("\\", "/"))
        self.users_name.append(user_name)
        self.__write_index()
        if user_name in self.users_name_mean:
            idx = self.users_name_mean.index(user_name)
            rows = [i for i, v in enumerate(self.users_name)
                    if v == user_name]
            self.audio_feature_mean[idx] = \
                self.audio_feature[rows].mean(axis=0)
        else:
            self.users_name_mean.append(user_name)
            self.audio_feature_mean = (
                feature[None] if self.audio_feature_mean is None
                else np.vstack((self.audio_feature_mean, feature[None])))
        return True, "register success"

    def recognition(self, audio_data, threshold=None, sample_rate=16000):
        """1:N retrieval; returns [name, score] or [None, None]."""
        if threshold:
            self.threshold = threshold
        feature = self.predict(audio_data, sample_rate=sample_rate)
        return self.__retrieval(feature[None])[0]

    def get_users(self):
        return self.users_name

    def remove_user(self, user_name):
        """Delete a user's rows, files and mean voiceprint."""
        if user_name not in self.users_name:
            return False
        for index in sorted((i for i, n in enumerate(self.users_name)
                             if n == user_name), reverse=True):
            del self.users_name[index]
            del self.users_audio_path[index]
            self.audio_feature = np.delete(self.audio_feature, index, axis=0)
        self.__write_index()
        shutil.rmtree(os.path.join(self.audio_db_path, user_name),
                      ignore_errors=True)
        idx = self.users_name_mean.index(user_name)
        del self.users_name_mean[idx]
        self.audio_feature_mean = np.delete(self.audio_feature_mean, idx,
                                            axis=0)
        return True

    def speaker_diarization(self, audio_data, sample_rate=16000,
                            speaker_num=None, search_audio_db=False,
                            threshold=None):
        """VAD → chunk → batched embed → cluster → postprocess (JAX
        ``predict.py:481-503``). ``threshold`` overrides ``self.threshold``
        for the audio-db speaker naming only."""
        seg = self._load_audio(audio_data, sample_rate)
        segments = self.speaker_diarize.segments_audio(seg)
        features = self.predict_batch([s[2] for s in segments],
                                      sample_rate=sample_rate)
        labels, centers = self.speaker_diarize.clustering(
            features, speaker_num=speaker_num)
        outputs = self.speaker_diarize.postprocess(segments, labels)
        if search_audio_db:
            if self.audio_feature is None:
                raise ValueError("voiceprint database is empty; register "
                                 "speakers first")
            names = self.__retrieval(centers, threshold=threshold)
            outputs = [{
                "speaker": (names[o["speaker"]][0]
                            or f"stranger{o['speaker']}"),
                "start": o["start"], "end": o["end"],
            } for o in outputs]
        return outputs


# reference-compatible alias
PPVectorPredictor = Predictor
