"""Speaker diarization: VAD → chunk → (batched embed, by the caller) →
spectral clustering → postprocess (copy of the JAX package's
``infer_utils/speaker_diarization.py``, with k-means written here).

Pipeline parity with reference
``ppvector/infer_utils/speaker_diarization.py:9-310`` (itself a modelscope
adaptation): 1.5 s / 0.75 s sliding chunks over VAD segments, cosine
affinity with p-pruning, unnormalised Laplacian, eigen-gap speaker count,
k-means on spectral embeddings, centroid merging at cosine ≥ 0.78, and the
merge/overlap-split/smooth postprocess emitting ``{speaker, start, end}``.

Host-side numpy/scipy is the right tool here — the matrices are tiny
(hundreds of chunks); the expensive part (embedding the chunks) is the
caller's batched forward on the card.

k-means is ``kmeans`` below, not scikit-learn's (the GPU host has none):
greedy k-means++ seeding from a ``numpy.random.Generator`` made from the
``seed`` constructor argument, then Lloyd iterations with scikit-learn's
``max_iter=300`` and ``tol=1e-4``. The JAX package calls
``sklearn.cluster.k_means`` with no ``random_state``; here one seed gives
one labelling.
"""

import numpy as np
import scipy.linalg

from ..ops.audio import AudioSegment

__all__ = ["SpeakerDiarization", "SpectralCluster", "kmeans"]


class SpeakerDiarization:
    def __init__(self, seg_duration=1.5, seg_shift=0.75, sample_rate=16000,
                 merge_threshold=0.78, seed=0):
        self.seg_duration = seg_duration
        self.seg_shift = seg_shift
        self.sample_rate = sample_rate
        self.merge_threshold = merge_threshold
        self.spectral_cluster = SpectralCluster(seed=seed)

    # ------------------------------------------------------------------
    # segmentation
    # ------------------------------------------------------------------
    def segments_audio(self, audio_segment: AudioSegment):
        """VAD then fixed-length chunking; returns
        ``[[start_s, end_s, samples], ...]``."""
        self.sample_rate = audio_segment.sample_rate
        samples = audio_segment.samples
        vad_segments = []
        for t in audio_segment.vad(return_seconds=True):
            st, ed = round(t["start"], 3), round(t["end"], 3)
            vad_segments.append(
                [st, ed, samples[int(st * self.sample_rate):
                                 int(ed * self.sample_rate)]])
        self._check_audio_list(vad_segments)
        return self._chunk(vad_segments)

    def _check_audio_list(self, audio):
        total = 0.0
        for i, seg in enumerate(audio):
            if seg[1] < seg[0]:
                raise ValueError("bad segment timestamps")
            if not isinstance(seg[2], np.ndarray):
                raise ValueError("bad segment payload")
            if i > 0 and seg[0] < audio[i - 1][1]:
                raise ValueError("segments must be ordered")
            total += seg[1] - seg[0]
        if total <= 5:
            raise ValueError(f"audio too short for diarization: {total:.2f}s "
                             f"of speech, need > 5s")

    def _chunk(self, vad_segments):
        chunk_len = int(self.seg_duration * self.sample_rate)
        chunk_shift = int(self.seg_shift * self.sample_rate)
        out = []
        for seg_st, _, data in vad_segments:
            last_end = 0
            for start in range(0, data.shape[0], chunk_shift):
                end = min(start + chunk_len, data.shape[0])
                if end <= last_end:
                    break
                last_end = end
                start = max(0, end - chunk_len)
                chunk = data[start:end]
                if chunk.shape[0] < chunk_len:
                    chunk = np.pad(chunk, (0, chunk_len - chunk.shape[0]))
                out.append([start / self.sample_rate + seg_st,
                            end / self.sample_rate + seg_st, chunk])
        return out

    # ------------------------------------------------------------------
    # clustering
    # ------------------------------------------------------------------
    def clustering(self, embeddings, speaker_num=None):
        """Returns (labels, per-speaker centroid embeddings).

        ``centers[i]`` is recomputed from the *final* merged labels, so it
        always aligns with label ``i`` (the pre-merge centroid list would be
        misaligned once ``_merge_by_cos`` renumbers labels)."""
        labels = self.spectral_cluster(embeddings, oracle_num=speaker_num)
        labels = self._correct_labels(labels)
        spk_num = labels.max() + 1
        centers = np.stack([embeddings[labels == i].mean(0)
                            for i in range(spk_num)], axis=0)
        labels = self._merge_by_cos(labels, centers, self.merge_threshold)
        centers = np.stack([embeddings[labels == i].mean(0)
                            for i in range(labels.max() + 1)], axis=0)
        return labels, centers

    @staticmethod
    def _merge_by_cos(labels, spk_center_emb, cos_thr):
        """Iteratively merge the most-similar centroid pair while their
        cosine ≥ threshold.

        Note: the reference (``speaker_diarization.py:112-136``) re-reads
        the *original* centroid list by the re-numbered labels after each
        merge, mis-aligning centroids and over-merging; here the merged
        centroid row is deleted so indices stay consistent."""
        if not 0 < cos_thr <= 1:
            raise ValueError(f"cos_thr must lie in (0, 1], got {cos_thr}")
        labels = labels.copy()
        centers = np.asarray(spk_center_emb, dtype=np.float64).copy()
        while centers.shape[0] > 1:
            normed = centers / np.linalg.norm(centers, axis=1, keepdims=True)
            affinity = np.triu(normed @ normed.T, 1)
            a, b = np.unravel_index(np.argmax(affinity), affinity.shape)
            if affinity[a, b] < cos_thr:
                break
            labels[labels == b] = a
            labels[labels > b] -= 1
            centers = np.delete(centers, b, axis=0)
        return labels

    # ------------------------------------------------------------------
    # postprocess
    # ------------------------------------------------------------------
    def postprocess(self, segments, labels):
        if len(segments) != len(labels):
            raise ValueError(f"{len(segments)} segments but "
                             f"{len(labels)} labels")
        res = [[segments[i][0], segments[i][1], int(labels[i])]
               for i in range(len(segments))]
        res = self._merge_seque(res)

        # split overlapped neighbours at the midpoint
        for i in range(1, len(res)):
            if res[i - 1][1] > res[i][0] + 1e-4:
                mid = (res[i][0] + res[i - 1][1]) / 2
                res[i][0] = mid
                res[i - 1][1] = mid

        res = self._smooth(res)
        return [dict(speaker=r[2], start=round(r[0], 3), end=round(r[1], 3))
                for r in res]

    @staticmethod
    def _correct_labels(labels):
        """Re-number labels in first-appearance order."""
        mapping = {}
        out = []
        for v in labels:
            if v not in mapping:
                mapping[v] = len(mapping)
            out.append(mapping[v])
        return np.array(out)

    @staticmethod
    def _merge_seque(res):
        """Merge adjacent same-speaker segments that touch/overlap."""
        merged = [res[0]]
        for seg in res[1:]:
            if seg[2] != merged[-1][2] or seg[0] > merged[-1][1]:
                merged.append(seg)
            else:
                merged[-1][1] = seg[1]
        return merged

    def _smooth(self, res, min_duration=1.0):
        """Reassign segments shorter than ``min_duration`` to the closer
        neighbour, then re-merge."""
        for i in range(len(res)):
            res[i][0] = round(res[i][0], 2)
            res[i][1] = round(res[i][1], 2)
            if res[i][1] - res[i][0] >= min_duration:
                continue
            if i == 0 and len(res) > 1:
                res[i][2] = res[i + 1][2]
            elif i == len(res) - 1:
                res[i][2] = res[i - 1][2]
            elif (res[i][0] - res[i - 1][1]) <= (res[i + 1][0] - res[i][1]):
                res[i][2] = res[i - 1][2]
            else:
                res[i][2] = res[i + 1][2]
        return self._merge_seque(res)


class SpectralCluster:
    """Unnormalised-Laplacian spectral clustering with p-pruning and
    eigen-gap model selection (reference
    ``infer_utils/speaker_diarization.py:219-310``)."""

    def __init__(self, min_num_spks=1, max_num_spks=15, pval=0.022, seed=0):
        self.min_num_spks = min_num_spks
        self.max_num_spks = max_num_spks
        self.pval = pval
        self.seed = seed

    def __call__(self, X, oracle_num=None):
        sim = self.get_sim_mat(X)
        pruned = self.p_pruning(sim)
        sym = 0.5 * (pruned + pruned.T)
        laplacian = self.get_laplacian(sym)
        emb, k = self.get_spec_embs(laplacian, oracle_num)
        return self.cluster_embs(emb, k)

    @staticmethod
    def get_sim_mat(X):
        normed = X / np.maximum(
            np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
        return normed @ normed.T

    def p_pruning(self, A):
        pval = self.pval
        if A.shape[0] * pval < 6:
            pval = 6.0 / A.shape[0]
        n_zero = int((1 - pval) * A.shape[0])
        # zero the n_zero smallest entries per row (vectorised)
        order = np.argsort(A, axis=1)[:, :n_zero]
        A = A.copy()
        np.put_along_axis(A, order, 0.0, axis=1)
        return A

    @staticmethod
    def get_laplacian(M):
        M = M.copy()
        np.fill_diagonal(M, 0.0)
        D = np.diag(np.sum(np.abs(M), axis=1))
        return D - M

    def get_spec_embs(self, L, k_oracle=None):
        lambdas, eig_vecs = scipy.linalg.eigh(L)
        if k_oracle is not None:
            k = k_oracle
        else:
            window = lambdas[self.min_num_spks - 1:self.max_num_spks + 1]
            gaps = np.diff(window)
            k = int(np.argmax(gaps)) + self.min_num_spks
        return eig_vecs[:, :k], k

    def cluster_embs(self, emb, k):
        return kmeans(emb, k, np.random.default_rng(self.seed))


def _sq_dists(X, centers):
    """Squared Euclidean distances ``(n, k)``."""
    return ((X[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


def _kmeans_plusplus(X, k, rng):
    """Greedy k-means++ (scikit-learn's ``_kmeans_plusplus``): each new
    centre is the best of ``2 + log(k)`` candidates drawn in proportion to
    the squared distance from the centres so far."""
    n = X.shape[0]
    n_trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]), X.dtype)
    centers[0] = X[rng.integers(n)]
    closest = ((X - centers[0]) ** 2).sum(1)
    pot = closest.sum()
    for c in range(1, k):
        picks = np.searchsorted(np.cumsum(closest),
                                rng.uniform(size=n_trials) * pot)
        picks = np.minimum(picks, n - 1)
        cand = np.minimum(closest[None, :], _sq_dists(X, X[picks]).T)
        pots = cand.sum(1)
        best = int(np.argmin(pots))
        pot, closest = pots[best], cand[best]
        centers[c] = X[picks[best]]
    return centers


def kmeans(X, k, rng, max_iter=300, tol=1e-4):
    """Lloyd's k-means from greedy k-means++ seeds; returns labels ``(n,)``.

    Stops when no label changes, or when the squared centre shift falls
    to ``tol`` times the mean per-feature variance of ``X`` (scikit-learn's
    rule). An empty cluster takes the point farthest from its centre. The
    labels returned are those of the final centres, so points that are
    equal share one label even when that leaves fewer than ``k`` clusters,
    as in scikit-learn."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k-means needs 1 <= k <= {n} points, got k={k}")
    tol = tol * float(np.mean(np.var(X, axis=0)))
    centers = _kmeans_plusplus(X, k, rng)
    labels = None
    for _ in range(max_iter):
        d2 = _sq_dists(X, centers)
        new_labels = np.argmin(d2, axis=1)
        new_centers = np.empty_like(centers)
        for j in range(k):
            members = new_labels == j
            if not members.any():
                far = int(np.argmax(d2[np.arange(n), new_labels]))
                new_labels[far] = j
                members = new_labels == j
            new_centers[j] = X[members].mean(0)
        shift = float(((new_centers - centers) ** 2).sum())
        centers = new_centers
        if labels is not None and np.array_equal(labels, new_labels):
            return labels
        labels = new_labels
        if shift <= tol:
            break
    return np.argmin(_sq_dists(X, centers), axis=1)
