"""The whole CAM++ trunk as one CUDA kernel: the counterpart of the JAX
package's ``models/pallas_campplus.py``.

The trunk takes the FCM output ``(B, T_raw, 320)`` and returns pooled
statistics ``(B, 1024)``: a k5 stride-2 stem with BN-ReLU, 52 CAM layers
in three dense blocks with transits, the out BN-ReLU, then mean ||
unbiased std over each utterance's valid frames.

- ``pack_trunk`` folds every BatchNorm into per-channel affines and packs
  the weights into the layouts ``csrc/campplus_trunk.cu`` reads.
- ``trunk_stats_reference`` is the plain PyTorch version. It rounds to
  bf16 at the same points as the kernel (and as the TPU kernel), so the
  two agree tightly on the card.
- ``trunk_stats`` is the wrapper: the CUDA kernel on a CUDA tensor (with
  a launch counter), the plain version on a CPU tensor.
- ``campplus_embed_fast`` runs FCM -> trunk -> DenseBN head. The FCM
  is dispatched as the JAX package's ``_fcm_forward``: the FCM kernel
  (``fcm_kernel.fcm_fused``) for buckets of ``FCM_MIN_T`` (1000) frames
  and more, the model's plain convs below that.
  ``make_campplus_masked_embed_fn`` wraps featurize + embed for padded
  batches.

The trunk kernel serves up to ``MAX_T_RAW`` frames (the 32 s bucket,
3198 frames; ``t_valid <= 1600``). Each utterance runs on a thread-block
cluster of ``cs`` blocks, each owning ``R`` of its trunk rows (at most
``SMEM_MAX_T16``, so a block's bottleneck activations fit in its shared
memory); ``trunk_split`` picks ``(cs, R)`` from the batch, the length and
how many clusters of each size the card holds at once, and
``trunk_stats(..., cluster=cs)`` forces a size.

Valid frames: the stem keeps ``t_valid = (T_raw - 1) // 2 + 1`` frames; a
padded utterance with length ratio ``r`` has ``ceil(r * t_valid)`` of
them (clamped to ``[1, t_valid]``). Rows past an utterance's valid count
are zero after every masked write, so a padded clip gives its
exact-length embedding.
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .fcm_kernel import FCM_MIN_T, fcm_fused, fcm_supported, pack_fcm
from .layers import bn_affine

__all__ = ["trunk_plan", "pack_trunk", "trunk_geometry", "tvalids_from_ratios",
           "rows_per_block", "trunk_split", "default_split",
           "trunk_stats_reference", "trunk_stats", "campplus_embed_fast",
           "make_campplus_masked_embed_fn", "MAX_T_RAW", "SMEM_MAX_T16",
           "CLUSTER_SIZES"]

SEG_LEN = 100           # CAM segment pooling window
FCM_DIM = 320           # 32 channels x 80/8 frequencies
WIDE = 1024             # widest concat (992) and transit input
MAX_T_RAW = 3200        # 32 s bucket (3198 frames): t_valid <= 1600
MAX_T16 = 1600          # trunk rows of the 32 s bucket (csrc kMaxT16)
SMEM_MAX_T16 = 400      # trunk rows a block holds (csrc kMaxR)
CLUSTER_SIZES = (1, 2, 4, 8)  # up to the portable size (csrc kMaxCluster)
_BF16 = torch.bfloat16


def trunk_plan():
    """Static layer plan of the stock CAM++ trunk: per-layer input width,
    dilation and row offset into the packed ``w_lin1``, and the block
    boundary widths."""
    init_channels, growth_rate, bn_size = 128, 32, 4
    num_layers, dilations = (12, 24, 16), (1, 2, 2)
    layers, off, c = [], 0, init_channels
    blocks = []
    for b, (n, dil) in enumerate(zip(num_layers, dilations)):
        for li in range(n):
            cin = c + li * growth_rate
            layers.append(dict(block=b, li=li, cin=cin, dil=dil,
                               lin1_off=off))
            off += cin
        cout = c + n * growth_rate
        blocks.append(dict(c_in=c, c_out=cout, c_transit=cout // 2))
        c = cout // 2
    return dict(layers=layers, lin1_rows=off, n_layers=len(layers),
                bn_ch=bn_size * growth_rate, growth=growth_rate,
                init_channels=init_channels, num_layers=tuple(num_layers),
                dilations=tuple(dilations), final_channels=c, blocks=blocks)


def _check_model(model):
    if not (model.growth_rate == 32 and model.bn_size == 4
            and model.init_channels == 128 and model.input_size == 80):
        raise NotImplementedError(
            "the trunk kernel serves the stock CAM++ widths (80 mels, "
            "growth 32, bn_size 4, init_channels 128); see ROADMAP.md")


@torch.no_grad()
def pack_trunk(model):
    """CAM++ module -> packed trunk tensors on the model's device.

    bf16: ``w_stem (1600, 128)`` tap-major rows over the frequency-major
    FCM order; ``w_lin1 (lin1_rows, 128)``; ``wide_ab (55, 2, 1024)``, the
    wide BN affines (a, b) of the 52 layers and 3 transits, rounded to
    bf16 as the TPU kernel does; ``w_local (52, 384, 32)`` rows
    ``tap * 128 + c``; ``w_cam1 (52, 128, 64)``; ``w_cam2 (52, 64, 32)``;
    ``w_t0..w_t2 (cw, cw/2)``.
    fp32: ``stem_aff (3, 128)`` (conv bias, a, b); ``lin1_aff (52, 3, 128)``;
    ``cam_bias (52, 128)`` = local | cam2 | cam1 biases; ``tbias (3, 512)``;
    ``out_aff (2, 512)``."""
    _check_model(model)
    plan = trunk_plan()
    L, dev = plan["n_layers"], model.TDNNLayer_0.Conv_0.weight.device
    f32 = dict(dtype=torch.float32, device=dev)
    stem = model.TDNNLayer_0
    w = stem.Conv_0.weight.float()                      # (128, 320, 5)
    a, b = bn_affine(stem._NonLinear_0.BatchNorm_0)
    packed = dict(
        w_stem=w.permute(2, 1, 0).reshape(-1, w.shape[0]).to(_BF16),
        stem_aff=torch.stack([stem.Conv_0.bias.float(), a, b]))
    w_lin1, lin1_aff, w_local, w_cam1, w_cam2, cam_bias = [], [], [], [], [], []
    wide_ab = torch.zeros((L + 3, 2, WIDE), **f32)
    tbias = torch.zeros((3, 512), **f32)
    l = 0
    for bi, n in enumerate(plan["num_layers"]):
        blk = getattr(model, f"CAMDenseTDNNBlock_{bi}")
        for li in range(n):
            layer = getattr(blk, f"CAMDenseTDNNLayer_{li}")
            cin = plan["layers"][l]["cin"]
            a1, b1 = bn_affine(layer._NonLinear_0.BatchNorm_0)
            wide_ab[l, 0, :cin], wide_ab[l, 1, :cin] = a1, b1
            w_lin1.append(layer.Conv_0.weight[:, :, 0].float().t())
            a2, b2 = bn_affine(layer._NonLinear_1.BatchNorm_0)
            lin1_aff.append(torch.stack([layer.Conv_0.bias.float(), a2, b2]))
            cam = layer.CAMLayer_0
            w_local.append(cam.Conv_0.weight.float().permute(2, 1, 0)
                           .reshape(-1, cam.Conv_0.weight.shape[0]))
            w_cam1.append(cam.Conv_1.weight[:, :, 0].float().t())
            w_cam2.append(cam.Conv_2.weight[:, :, 0].float().t())
            cam_bias.append(torch.cat([cam.Conv_0.bias, cam.Conv_2.bias,
                                       cam.Conv_1.bias]).float())
            l += 1
        at, bt = bn_affine(getattr(model, f"_NonLinear_{bi}").BatchNorm_0)
        cw = plan["blocks"][bi]["c_out"]
        wide_ab[L + bi, 0, :cw], wide_ab[L + bi, 1, :cw] = at, bt
        conv = getattr(model, f"Conv_{bi}")
        tbias[bi, :cw // 2] = conv.bias.float()
        packed[f"w_t{bi}"] = conv.weight[:, :, 0].float().t().to(_BF16)
    packed.update(
        w_lin1=torch.cat(w_lin1).to(_BF16),
        lin1_aff=torch.stack(lin1_aff),
        wide_ab=wide_ab.to(_BF16),
        w_local=torch.stack(w_local).to(_BF16),
        w_cam1=torch.stack(w_cam1).to(_BF16),
        w_cam2=torch.stack(w_cam2).to(_BF16),
        cam_bias=torch.stack(cam_bias),
        tbias=tbias,
        out_aff=torch.stack(bn_affine(model._NonLinear_3.BatchNorm_0)))
    return {k: v.contiguous() for k, v in packed.items()}


def trunk_geometry(t_raw):
    """``(t_valid, t16)``: trunk frames after the k5 stride-2 stem, and that
    count rounded up to the kernel's 16-row tiles."""
    t_valid = (t_raw - 1) // 2 + 1
    return t_valid, -(-t_valid // 16) * 16


def rows_per_block(t16, cs):
    """``R``: ``t16`` rows over ``cs`` blocks, rounded up to 16-row tiles."""
    return -(-t16 // (16 * cs)) * 16


def trunk_split(b, t16, resident):
    """``(cs, R)``: the cluster size per utterance and the rows per block
    for ``b`` utterances of ``t16`` trunk rows, where ``resident(cs, R)``
    is how many clusters of ``cs`` blocks of ``R`` rows the card holds at
    once (``default_split`` asks the CUDA occupancy query).

    A block's time grows with its 64-row chunks (``ceil(R / 64)``), and
    clusters that the card cannot hold at once wait for a second wave.
    So, of the sizes 1, 2, 4, 8 whose ``R`` fits a block's shared memory
    (``SMEM_MAX_T16``) and, above the smallest such size, keeps at least
    32 rows, take the one with the fewest waves x chunks, then the fewest
    waves, then the largest."""
    if t16 % 16 or not 16 <= t16 <= MAX_T16:
        raise ValueError(f"t16 must be a multiple of 16 in [16, {MAX_T16}], "
                         f"got {t16}")
    best = None
    for cs in CLUSTER_SIZES:
        rows = rows_per_block(t16, cs)
        if rows > SMEM_MAX_T16:
            continue
        if best is not None and rows < 32:
            break
        n = resident(cs, rows)
        waves = -(-b // n) if n > 0 else float("inf")
        key = (waves * -(-rows // 64), waves, -cs)
        if best is None or key < best[0]:
            best = (key, cs, rows)
    return best[1], best[2]


def _forced_split(cluster, t16):
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got "
                         f"{cluster!r}")
    rows = rows_per_block(t16, cluster)
    if rows > SMEM_MAX_T16:
        raise ValueError(f"cluster={cluster} leaves {rows} trunk rows per "
                         f"block, more than the {SMEM_MAX_T16} that fit")
    return cluster, rows


def tvalids_from_ratios(ratios, t_valid):
    """Per-utterance valid trunk frames ``ceil(r * t_valid)`` in float32
    (JAX ``pallas_campplus.py:974-975``), clamped to ``[1, t_valid]``."""
    r = np.asarray(ratios, np.float32)
    tv = np.ceil(r * np.float32(t_valid)).astype(np.int64)
    return np.clip(tv, 1, t_valid)


def _tvalid_tensor(tvalids, b, t_valid, device):
    if tvalids is None:
        return torch.full((b,), t_valid, dtype=torch.int32, device=device)
    tv = torch.as_tensor(np.asarray(tvalids), dtype=torch.int32)
    if tv.shape != (b,):
        raise ValueError(f"tvalids must have shape ({b},), got {tuple(tv.shape)}")
    return tv.clamp(1, t_valid).to(device)


def _mm(a, w):
    """bf16 operands, fp32 products and sums (bf16 values are exact in
    fp32; the caller keeps TF32 off)."""
    return a.float() @ w.float()


def _wide_relu(x, ab):
    """The wide BN affine in bf16, unmasked: relu(bf16(bf16(x*a) + b))."""
    return torch.relu(x * ab[0, :x.shape[-1]] + ab[1, :x.shape[-1]])


def _unbias(stats, tv):
    tv = tv.to(stats.dtype)
    corr = torch.sqrt(tv / torch.clamp(tv - 1, min=1))
    cf = stats.shape[1] // 2
    return torch.cat([stats[:, :cf], stats[:, cf:] * corr[:, None]], 1)


@torch.no_grad()
def trunk_stats_reference(packed, fcm_out, tvalids=None):
    """Plain PyTorch trunk: ``(B, T_raw, 320) -> (B, 1024)`` mean ||
    unbiased std, with the kernel's bf16 rounding points and masking."""
    plan = trunk_plan()
    b, t_raw, _ = fcm_out.shape
    t_valid, _ = trunk_geometry(t_raw)
    dev = fcm_out.device
    tv = _tvalid_tensor(tvalids, b, t_valid, dev).long()
    t_idx = torch.arange(t_valid, device=dev)
    mask = (t_idx[None, :] < tv[:, None]).float()[..., None]    # (B, T, 1)

    # stem: k5 stride 2 pad 2, taps concatenated tap-major
    xp = F.pad(fcm_out.to(_BF16), (0, 0, 2, 2 * t_valid + 1 - t_raw))
    cols = torch.cat([xp[:, k:k + 2 * t_valid - 1:2] for k in range(5)], -1)
    sa = packed["stem_aff"]
    y = torch.relu((_mm(cols, packed["w_stem"]) + sa[0]) * sa[1] + sa[2])
    xcat = torch.zeros((b, t_valid, WIDE), dtype=_BF16, device=dev)
    xcat[..., :plan["init_channels"]] = (y * mask).to(_BF16)

    n_segs = -(-t_valid // SEG_LEN)
    seg_of = torch.clamp(t_idx // SEG_LEN, max=n_segs - 1)
    seg_mask = torch.stack([((t_idx >= s * SEG_LEN) & (t_idx < (s + 1) * SEG_LEN))
                            for s in range(n_segs)]).float()          # (S, T)
    seg_mask = seg_mask[None] * mask[None, :, :, 0].transpose(0, 1)   # (B, S, T)
    seg_cnt = torch.clamp(seg_mask.sum(-1, keepdim=True), min=1)
    for l, spec in enumerate(plan["layers"]):
        cin, off, dil = spec["cin"], spec["lin1_off"], spec["dil"]
        h = _wide_relu(xcat[..., :cin], packed["wide_ab"][l])
        la = packed["lin1_aff"][l]
        x2 = torch.relu((_mm(h, packed["w_lin1"][off:off + cin]) + la[0])
                        * la[1] + la[2])
        x2 = (x2 * mask).to(_BF16)
        cb = packed["cam_bias"][l]
        # local k3 dilated conv with zeros past the valid edge
        x2p = F.pad(x2, (0, 0, dil, dil))
        taps = torch.cat([x2p[:, k * dil:k * dil + t_valid] for k in range(3)], -1)
        y = _mm(taps, packed["w_local"][l]) + cb[:32]
        # CAM gate from the global mean + the frame's 100-frame segment mean
        x2f = x2.float()
        seg_sum = seg_mask @ x2f                                     # (B, S, 128)
        mean = seg_sum.sum(1, keepdim=True) / tv[:, None, None]
        ctx = (mean + seg_sum / seg_cnt).to(_BF16)
        c1 = torch.relu(_mm(ctx, packed["w_cam1"][l]) + cb[64:]).to(_BF16)
        g = torch.sigmoid(_mm(c1, packed["w_cam2"][l]) + cb[32:64]).to(_BF16)
        gate = g[:, seg_of].float()                                  # (B, T, 32)
        c0 = plan["blocks"][spec["block"]]["c_in"] + spec["li"] * plan["growth"]
        xcat[..., c0:c0 + 32] = (y * gate * mask).to(_BF16)
        if spec["li"] == plan["num_layers"][spec["block"]] - 1:
            bi = spec["block"]
            cw = plan["blocks"][bi]["c_out"]
            h = _wide_relu(xcat[..., :cw], packed["wide_ab"][plan["n_layers"] + bi])
            ht = _mm(h, packed[f"w_t{bi}"]) + packed["tbias"][bi, :cw // 2]
            xcat[..., :cw // 2] = (ht * mask).to(_BF16)

    cf = plan["final_channels"]
    oa = packed["out_aff"]
    x = torch.relu(xcat[..., :cf].float() * oa[0] + oa[1]) * mask
    n = tv[:, None].float()
    mean = x.sum(1) / n
    var = (((x - mean[:, None]) ** 2) * mask).sum(1) / n
    return _unbias(torch.cat([mean, torch.sqrt(var)], 1), tv)


class _TrunkParams(ctypes.Structure):
    """Mirror of ``TrunkParams`` in ``csrc/campplus_trunk.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "tvalid", "out", "ws", "w_stem", "stem_aff", "w_lin1",
        "lin1_aff", "wide_ab", "w_local", "w_cam1", "w_cam2", "cam_bias",
        "w_t0", "w_t1", "w_t2", "tbias", "out_aff")] + [
        (name, ctypes.c_int) for name in ("B", "T_raw", "t_valid", "t16",
                                          "cs", "R")]


@lru_cache(maxsize=None)
def _entries():
    from .._build import kernel_library
    lib = kernel_library().lib
    fn = lib.vpr_campplus_trunk
    fn.restype = ctypes.c_int
    fn.argtypes = [_TrunkParams, ctypes.c_void_p]
    occ = lib.vpr_campplus_trunk_max_clusters
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    return fn, occ


def _device_index(device):
    return device.index if device.index is not None else torch.cuda.current_device()


@lru_cache(maxsize=None)
def _max_clusters(cs, rows, t_valid, device_index):
    from .._build import check
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(_entries()[1](cs, rows, t_valid, ctypes.byref(n)),
              "vpr_campplus_trunk_max_clusters")
    return n.value


def default_split(b, t_raw, device):
    """``(cs, R)`` that ``trunk_stats`` takes for ``b`` utterances of
    ``t_raw`` frames on a CUDA ``device``: ``trunk_split`` with the
    card's resident clusters."""
    index = _device_index(device)
    t_valid, t16 = trunk_geometry(t_raw)
    return trunk_split(b, t16, lambda cs, rows:
                       _max_clusters(cs, rows, t_valid, index))


def trunk_stats(packed, fcm_out, tvalids=None, *, cluster=None):
    """``(B, T_raw, 320) -> (B, 1024)`` mean || unbiased std.

    A CPU tensor runs ``trunk_stats_reference``. A CUDA tensor launches
    the CUDA kernel (bf16 in, fp32 stats out) over clusters of
    ``default_split`` blocks per utterance, or of ``cluster`` blocks where
    given (one of ``CLUSTER_SIZES`` leaving at most ``SMEM_MAX_T16`` rows
    per block, else ``ValueError``), and adds one to
    ``trunk_stats.launches`` and to ``trunk_stats.cluster_launches[cs]``.
    A cluster size the card cannot hold resident raises."""
    if fcm_out.ndim != 3 or fcm_out.shape[2] != FCM_DIM:
        raise ValueError(f"expected (B, T, {FCM_DIM}), got {tuple(fcm_out.shape)}")
    b, t_raw, _ = fcm_out.shape
    t_valid, t16 = trunk_geometry(t_raw)
    if cluster is not None:
        cs, rows = _forced_split(cluster, t16)
    if fcm_out.device.type == "cpu":
        return trunk_stats_reference(packed, fcm_out, tvalids)
    if fcm_out.device.type != "cuda":
        raise ValueError(f"unsupported device {fcm_out.device}")
    if t_raw > MAX_T_RAW:
        raise ValueError(
            f"the trunk kernel serves at most {MAX_T_RAW} frames (the 32 s "
            f"bucket), got {t_raw}; longer buckets run the plain model "
            f"(predict.py)")
    dev = fcm_out.device
    index = _device_index(dev)
    if cluster is None:
        cs, rows = default_split(b, t_raw, dev)
    if _max_clusters(cs, rows, t_valid, index) == 0:
        raise RuntimeError(
            f"no cluster of {cs} trunk blocks of {rows} rows fits on "
            f"{torch.cuda.get_device_name(index)}")
    x = fcm_out.to(_BF16).contiguous()
    tv = _tvalid_tensor(tvalids, b, t_valid, dev)
    out = torch.empty((b, 2 * 512), dtype=torch.float32, device=dev)
    ws = torch.empty((2, b, t16, WIDE), dtype=_BF16, device=dev)
    for k, v in packed.items():
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"packed[{k!r}] must be contiguous on {dev}")
    p = _TrunkParams(
        x.data_ptr(), tv.data_ptr(), out.data_ptr(), ws.data_ptr(),
        *(packed[k].data_ptr() for k in (
            "w_stem", "stem_aff", "w_lin1", "lin1_aff", "wide_ab", "w_local",
            "w_cam1", "w_cam2", "cam_bias", "w_t0", "w_t1", "w_t2", "tbias",
            "out_aff")),
        b, t_raw, t_valid, t16, cs, rows)
    from .._build import check
    # the kernel launches on the current device: make it the tensor's
    with torch.cuda.device(dev):
        check(_entries()[0](p, torch.cuda.current_stream(dev).cuda_stream),
              "vpr_campplus_trunk")
    trunk_stats.launches += 1
    trunk_stats.cluster_launches[cs] = trunk_stats.cluster_launches.get(cs, 0) + 1
    return _unbias(out, tv)


trunk_stats.launches = 0
trunk_stats.cluster_launches = {}


@torch.no_grad()
def campplus_embed_fast(model, packed, packed_fcm, feats, tvalids=None):
    """Features ``(B, T, 80)`` -> embeddings ``(B, embd_dim)``: the FCM
    through ``fcm_fused`` for ``T >= FCM_MIN_T`` (``packed_fcm`` from
    ``pack_fcm``, ``packed`` from ``pack_trunk``) and the model's plain
    FCM below that (JAX
    ``pallas_campplus.py:91-112``), the trunk through ``trunk_stats``, and
    the DenseBN head with its input in the model's dtype."""
    dtype = model.DenseBN_0.Dense_0.weight.dtype
    t = feats.shape[1]
    if t >= FCM_MIN_T and fcm_supported(t, feats.shape[2]):
        fcm_out = fcm_fused(packed_fcm, feats)
    else:
        fcm_out = model.FCM_0(feats.to(dtype))
    stats = trunk_stats(packed, fcm_out, tvalids)
    return model.DenseBN_0(stats.to(dtype)).float()


def make_campplus_masked_embed_fn(model, featurizer):
    """Pack the trunk and the FCM once and return ``call(waves (B, L)
    tensor, ratios (B,) or None) -> embeddings (B, embd_dim)``.

    With ratios the features take the masked CMN and the trunk the
    per-utterance valid counts; with ``None`` every frame is valid."""
    packed = pack_trunk(model)
    packed_fcm = pack_fcm(model)

    def call(waves, ratios=None):
        feats = featurizer(waves, input_lens_ratio=ratios)
        t_valid, _ = trunk_geometry(feats.shape[1])
        tvalids = None if ratios is None else tvalids_from_ratios(ratios, t_valid)
        return campplus_embed_fast(model, packed, packed_fcm, feats, tvalids)

    return call
