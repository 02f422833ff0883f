"""The whole CAM++ trunk as one CUDA kernel: the counterpart of the JAX
package's ``models/pallas_campplus.py``.

The trunk takes the FCM output ``(B, T_raw, 320)`` and returns pooled
statistics ``(B, 1024)``: a k5 stride-2 stem with BN-ReLU, 52 CAM layers
in three dense blocks with transits, the out BN-ReLU, then mean ||
unbiased std over each utterance's valid frames.

- ``pack_trunk`` folds every BatchNorm into per-channel affines and packs
  the weights into the layouts ``csrc/campplus_trunk.cu`` reads: the
  products' weights in the order of the kernel's wgmma operand slices
  (``trunk_weights`` gives them back as plain matrices).
- ``trunk_stats_reference`` is the plain PyTorch version. It rounds to
  bf16 at the same points as the kernel (and as the TPU kernel), so the
  two agree tightly on the card.
- ``trunk_stats`` is the wrapper: the CUDA kernel on a CUDA tensor (with
  a launch counter), the plain version on a CPU tensor;
  ``trunk_phase_times`` times block 0's phases on the card.
- ``campplus_embed_fast`` runs FCM -> trunk -> DenseBN head, the FCM
  through the FCM kernel (``fcm_kernel.fcm_fused``) at every length.
  ``make_campplus_masked_embed_fn`` wraps featurize + embed for padded
  batches (``MaskedEmbedFn``: on the card the per-utterance values go
  from pinned memory without blocking, so the host never waits for the
  card). Both record the spans ``vpr.embed`` (the call) and
  ``vpr.embed.{featurize,fcm,trunk,head}`` while tracing is on
  (``utils.tracing``).

The trunk kernel serves up to ``MAX_T_RAW`` frames (the 32 s bucket,
3198 frames; ``t_valid <= 1600``). Each utterance runs on a thread-block
cluster of ``cs`` blocks, each owning ``R`` of its trunk rows (at most
``SMEM_MAX_T16``, so a block's bottleneck activations and its ring of
operand stages fit in its shared memory); ``trunk_split`` picks ``(cs,
R)`` from the batch, the length, how many clusters of each size the card
holds at once and ``block_cost``. ``trunk_stats`` always takes that
split; ``_trunk_stats_at`` forces another size, for tests and
measurement only (a size the rule does not take can be slower than the
parent kernel's: clusters of 8 on a batch of 30 are).

Valid frames: the stem keeps ``t_valid = (T_raw - 1) // 2 + 1`` frames; a
padded utterance with length ratio ``r`` has ``ceil(r * t_valid)`` of
them (clamped to ``[1, t_valid]``). Rows past an utterance's valid count
are zero after every masked write, so a padded clip gives its
exact-length embedding. The kernel computes each block's rows only up to
the valid count rounded up to 16 (``trunk_tiles`` counts the 64-row tiles
that leaves) and serves the utterances with the most such tiles first
(``launch_order``); a batch's embeddings are those of the kernel that
runs every row, bit for bit.
"""

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import tracing
from .fcm_kernel import fcm_fused, pack_fcm
from .layers import bn_affine

__all__ = ["trunk_plan", "pack_trunk", "trunk_weights", "lin1_offsets",
           "trunk_geometry", "tvalids_from_ratios", "rows_per_block",
           "block_cost", "trunk_split", "default_split", "block_launch",
           "trunk_tiles", "launch_order",
           "trunk_stats_reference", "trunk_stats", "trunk_phase_times",
           "campplus_embed_fast", "make_campplus_masked_embed_fn",
           "MaskedEmbedFn",
           "MAX_T_RAW", "SMEM_MAX_T16", "CLUSTER_SIZES", "TRUNK_PHASES",
           "RING_COUNTS"]

SEG_LEN = 100           # CAM segment pooling window
FCM_DIM = 320           # 32 channels x 80/8 frequencies
WIDE = 1024             # widest concat (992) and transit input
MAX_T_RAW = 3200        # 32 s bucket (3198 frames): t_valid <= 1600
MAX_T16 = 1600          # trunk rows of the 32 s bucket (csrc kMaxT16)
SMEM_MAX_T16 = 256      # trunk rows a block holds (csrc kMaxR)
CLUSTER_SIZES = (1, 2, 4, 8)  # up to the portable size (csrc kMaxCluster)
K_SLICE = 64            # K rows of a packed weight slice (csrc kKS)
N_PASS = 128            # columns of a packed weight slice (csrc kNP)
TILE_ROWS = 64          # rows of a wgmma tile (csrc kTile)
PASS_TILES = 3          # tiles a row pass holds at most (csrc kBigTiles)
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


def _swizzle_index():
    """Where each element of a 128 x 64 weight slice (column n, K row k)
    lies in the kernel's stage: column n's 128-byte line holds its 64 K
    values, 16-byte chunk q at chunk q ^ (n & 7) (wgmma's 128-byte
    swizzle, csrc swz128). Returns the flat source index of each position."""
    n = np.arange(N_PASS)[:, None, None]
    q = np.arange(K_SLICE // 8)[None, :, None]
    j = np.arange(8)[None, None, :]
    pos = n * K_SLICE + ((q ^ (n & 7)) * 8) + j        # where (n, 8q + j) lies
    src = n * K_SLICE + q * 8 + j                      # (n, k) in [n][k] order
    order = np.empty(N_PASS * K_SLICE, np.int64)
    order[pos.reshape(-1)] = src.reshape(-1)
    return torch.from_numpy(order)


_SWZ = _swizzle_index()
_UNSWZ = torch.argsort(_SWZ)


def _padded(k):
    """``k`` rounded up to whole K slices."""
    return -(-k // K_SLICE) * K_SLICE


def _tile_slices(w):
    """``(K, N) -> (N / 128 * ceil(K / 64), 8192)``: the kernel's weight
    slices, [column pass][K slice], each 128 columns x 64 K as wgmma's
    K-major B in the 128-byte swizzle (``_swizzle_index``), zero past K, so
    that one slice is one contiguous copy into a ring stage."""
    k, n = w.shape
    w = F.pad(w, (0, 0, 0, _padded(k) - k))
    t = w.reshape(-1, K_SLICE, n // N_PASS, N_PASS)               # s, kk, p, nn
    t = t.permute(2, 0, 3, 1).reshape(-1, N_PASS * K_SLICE)       # [p, s][nn, kk]
    return t[:, _SWZ.to(t.device)].contiguous()


def _untile_slices(t, k, n):
    """The inverse of ``_tile_slices``."""
    t = t[:, _UNSWZ.to(t.device)].reshape(n // N_PASS, -1, N_PASS, K_SLICE)
    return t.permute(1, 3, 0, 2).reshape(-1, n)[:k]


def lin1_offsets():
    """Each layer's first slice in the packed ``w_lin1`` (its cin rounded
    up to whole K slices, layer after layer)."""
    offs, off = [], 0
    for spec in trunk_plan()["layers"]:
        offs.append(off)
        off += _padded(spec["cin"]) // K_SLICE
    return offs


def _kmajor_local(w):
    """``(L, 384, 32) -> (L, 12288)``: each layer's local-conv weights as
    wgmma's no-swizzle K-major B, [8-column group][8-row chunk of K][column]
    [row]."""
    return w.reshape(w.shape[0], 48, 8, 4, 8).permute(0, 3, 1, 4, 2).reshape(
        w.shape[0], -1).contiguous()


@torch.no_grad()
def pack_trunk(model):
    """CAM++ module -> packed trunk tensors on the model's device.

    bf16: ``w_stem (25, 8192)``, the stem's (1600, 128) tap-major rows over
    the frequency-major FCM order; ``w_lin1 (492, 8192)``, each layer's
    (cin, 128) in turn, cin rounded up to whole slices (``lin1_offsets``);
    ``w_t0 (16, 8192)``, ``w_t1`` and ``w_t2 (64, 8192)``, the transits'
    (cw, cw / 2): all in the kernel's weight slices (``_tile_slices``).
    ``w_local (52, 12288)``, each layer's (384, 32) with rows ``tap * 128
    + c``, K-major (``_kmajor_local``);
    ``wide_ab (55, 2, 1024)``, the wide BN affines (a, b) of the 52 layers
    and 3 transits, rounded to bf16 as the TPU kernel does; ``w_cam1 (52,
    128, 64)``; ``w_cam2 (52, 64, 32)``.
    fp32: ``stem_aff (3, 128)`` (conv bias, a, b); ``lin1_aff (52, 3, 128)``;
    ``cam_bias (52, 128)`` = local | cam2 | cam1 biases; ``tbias (3, 512)``;
    ``out_aff (2, 512)``. ``trunk_weights`` unpacks the products' weights."""
    _check_model(model)
    plan = trunk_plan()
    L, dev = plan["n_layers"], model.TDNNLayer_0.Conv_0.weight.device
    f32 = dict(dtype=torch.float32, device=dev)
    stem = model.TDNNLayer_0
    w = stem.Conv_0.weight.float()                      # (128, 320, 5)
    a, b = bn_affine(stem._NonLinear_0.BatchNorm_0)
    packed = dict(
        w_stem=_tile_slices(w.permute(2, 1, 0).reshape(-1, w.shape[0]).to(_BF16)),
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
            w_lin1.append(_tile_slices(
                layer.Conv_0.weight[:, :, 0].float().t().to(_BF16)))
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
        packed[f"w_t{bi}"] = _tile_slices(conv.weight[:, :, 0].float().t().to(_BF16))
    packed.update(
        w_lin1=torch.cat(w_lin1),
        lin1_aff=torch.stack(lin1_aff),
        wide_ab=wide_ab.to(_BF16),
        w_local=_kmajor_local(torch.stack(w_local).to(_BF16)),
        w_cam1=torch.stack(w_cam1).to(_BF16),
        w_cam2=torch.stack(w_cam2).to(_BF16),
        cam_bias=torch.stack(cam_bias),
        tbias=tbias,
        out_aff=torch.stack(bn_affine(model._NonLinear_3.BatchNorm_0)))
    return {k: v.contiguous() for k, v in packed.items()}


def trunk_weights(packed):
    """The products' weights of ``pack_trunk`` as plain matrices (``x @
    w``): ``w_stem (1600, 128)``, ``w_lin1 (lin1_rows, 128)`` (layer l's
    rows from its ``lin1_off``), ``w_local (52, 384, 32)``, ``w_t0 (512,
    256)``, ``w_t1`` and ``w_t2 (1024, 512)``."""
    plan = trunk_plan()
    lin1 = [_untile_slices(packed["w_lin1"][o:o + _padded(s["cin"]) // K_SLICE],
                           s["cin"], plan["bn_ch"])
            for s, o in zip(plan["layers"], lin1_offsets())]
    wl = packed["w_local"]
    out = dict(
        w_stem=_untile_slices(packed["w_stem"], 5 * FCM_DIM, plan["init_channels"]),
        w_lin1=torch.cat(lin1),
        w_local=wl.reshape(wl.shape[0], 4, 48, 8, 8).permute(0, 2, 4, 1, 3)
        .reshape(wl.shape[0], 3 * plan["bn_ch"], plan["growth"]))
    for bi, blk in enumerate(plan["blocks"]):
        out[f"w_t{bi}"] = _untile_slices(packed[f"w_t{bi}"], blk["c_out"],
                                         blk["c_transit"])
    return out


def trunk_geometry(t_raw):
    """``(t_valid, t16)``: trunk frames after the k5 stride-2 stem, and that
    count rounded up to the kernel's 16-row tiles."""
    t_valid = (t_raw - 1) // 2 + 1
    return t_valid, -(-t_valid // 16) * 16


def rows_per_block(t16, cs):
    """``R``: ``t16`` rows over ``cs`` blocks, rounded up to 16-row tiles."""
    return -(-t16 // (16 * cs)) * 16


def block_cost(rows):
    """A block's time in units of one 64-row tile's products: its tiles,
    plus two for each row pass (a pass streams every weight slice again and
    has its own serial work). Fitted to a sweep of every cluster size on
    an NVIDIA H100 (``PERF.md`` section 6, the kernel table's records): a
    block of one tile takes about 1.3 ms, of two 1.75, of three 2.2, of
    four (two passes) 2.7-3.1."""
    tiles = -(-rows // TILE_ROWS)
    return tiles + 2 * -(-tiles // PASS_TILES)


def trunk_split(b, t16, resident):
    """``(cs, R)``: the cluster size per utterance and the rows per block
    for ``b`` utterances of ``t16`` trunk rows, where ``resident(cs, R)``
    is how many clusters of ``cs`` blocks of ``R`` rows the card holds at
    once (``default_split`` asks the CUDA occupancy query).

    Clusters that the card cannot hold at once wait for another wave, and
    a block's time follows ``block_cost``. So, of the sizes 1, 2, 4, 8
    whose ``R`` fits a block's shared memory (``SMEM_MAX_T16``) and, above
    the smallest such size, keeps at least 32 rows, take the one with the
    least waves x block cost, then the fewest waves, then the largest (a
    tie spreads the rows over more SMs)."""
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
        key = (waves * block_cost(rows), waves, -cs)
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


def _tvalids(tvalids, b, t_valid):
    """The valid counts as int32 in ``[1, t_valid]``; ``None``: every row."""
    if tvalids is None:
        return np.full(b, t_valid, np.int32)
    tv = np.asarray(tvalids).astype(np.int32)
    if tv.shape != (b,):
        raise ValueError(f"tvalids must have shape ({b},), got {tv.shape}")
    return np.clip(tv, 1, t_valid)


def trunk_tiles(tvalids, t16, cs, rows):
    """``(tiles, tiles_run)``, each ``(B,)``: per utterance of valid counts
    ``tvalids`` (ints in ``[1, t_valid]``), the 64-row tiles its cluster's
    ``cs`` blocks of ``rows`` rows hold over the rows they own, and the
    tiles they run: a block computes its rows below the valid count
    rounded up to 16 (csrc ``nc``), in row passes of up to ``PASS_TILES``
    tiles."""
    tv16 = -(-np.asarray(tvalids, np.int64) // 16) * 16
    r0 = np.minimum(np.arange(cs) * rows, t16)
    nr = np.minimum(r0 + rows, t16) - r0
    nc = np.clip(tv16[:, None] - r0[None, :], 0, nr[None, :])
    tiles = -(-nr // TILE_ROWS)
    return (np.full(len(tv16), tiles.sum(), np.int64),
            (-(-nc // TILE_ROWS)).sum(1))


def launch_order(tiles_run):
    """The utterance that each cluster of a launch serves, in launch order:
    the most tiles run first, ties in batch order (a stable sort), so the
    longest utterances start in the first wave. Equal counts (every
    utterance whole) give the identity."""
    return np.argsort(-np.asarray(tiles_run), kind="stable")


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
    w = trunk_weights(packed)
    b, t_raw, _ = fcm_out.shape
    t_valid, _ = trunk_geometry(t_raw)
    dev = fcm_out.device
    tv = torch.from_numpy(_tvalids(tvalids, b, t_valid)).to(dev).long()
    t_idx = torch.arange(t_valid, device=dev)
    mask = (t_idx[None, :] < tv[:, None]).float()[..., None]    # (B, T, 1)

    # stem: k5 stride 2 pad 2, taps concatenated tap-major
    xp = F.pad(fcm_out.to(_BF16), (0, 0, 2, 2 * t_valid + 1 - t_raw))
    cols = torch.cat([xp[:, k:k + 2 * t_valid - 1:2] for k in range(5)], -1)
    sa = packed["stem_aff"]
    y = torch.relu((_mm(cols, w["w_stem"]) + sa[0]) * sa[1] + sa[2])
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
        x2 = torch.relu((_mm(h, w["w_lin1"][off:off + cin]) + la[0])
                        * la[1] + la[2])
        x2 = (x2 * mask).to(_BF16)
        cb = packed["cam_bias"][l]
        # local k3 dilated conv with zeros past the valid edge
        x2p = F.pad(x2, (0, 0, dil, dil))
        taps = torch.cat([x2p[:, k * dil:k * dil + t_valid] for k in range(3)], -1)
        y = _mm(taps, w["w_local"][l]) + cb[:32]
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
            ht = _mm(h, w[f"w_t{bi}"]) + packed["tbias"][bi, :cw // 2]
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
        "x", "tvalid", "order", "out", "ws", "w_stem", "stem_aff", "w_lin1",
        "lin1_aff", "wide_ab", "w_local", "w_cam1", "w_cam2", "cam_bias",
        "w_t0", "w_t1", "w_t2", "tbias", "out_aff", "phase")] + [
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
    blk = lib.vpr_campplus_trunk_block
    blk.restype = ctypes.c_int
    blk.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    return fn, occ, blk


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


def block_launch(rows, t_valid):
    """``(threads, shared-memory bytes)`` of a kernel block of ``rows``
    trunk rows (the build of two or three warpgroups by its tiles)."""
    from .._build import check
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    check(_entries()[2](rows, t_valid, ctypes.byref(threads), ctypes.byref(smem)),
          "vpr_campplus_trunk_block")
    return threads.value, smem.value


def default_split(b, t_raw, device):
    """``(cs, R)`` that ``trunk_stats`` takes for ``b`` utterances of
    ``t_raw`` frames on a CUDA ``device``: ``trunk_split`` with the
    card's resident clusters."""
    index = _device_index(device)
    t_valid, t16 = trunk_geometry(t_raw)
    return trunk_split(b, t16, lambda cs, rows:
                       _max_clusters(cs, rows, t_valid, index))


def trunk_stats(packed, fcm_out, tvalids=None):
    """``(B, T_raw, 320) -> (B, 1024)`` mean || unbiased std.

    A CPU tensor runs ``trunk_stats_reference``. A CUDA tensor launches
    the CUDA kernel (bf16 in, fp32 stats out) over clusters of
    ``default_split`` blocks per utterance, the utterances in
    ``launch_order``, which goes to the card with the valid counts in one
    copy that does not block the host (``_to_card``); it adds one to
    ``trunk_stats.launches`` and to
    ``trunk_stats.cluster_launches[cs]``, and the launch's ``trunk_tiles``
    (summed on the host) to ``trunk_stats.tiles`` and
    ``trunk_stats.tiles_run``."""
    return _trunk_stats_at(packed, fcm_out, tvalids, None)


def _trunk_stats_at(packed, fcm_out, tvalids, cluster):
    """``trunk_stats`` over clusters of ``cluster`` blocks per utterance
    (``None``: the default split), for tests and measurement: one of
    ``CLUSTER_SIZES`` leaving at most ``SMEM_MAX_T16`` rows per block,
    else ``ValueError``; a size the card cannot hold resident raises."""
    split = _check_call(fcm_out, cluster)
    if fcm_out.device.type == "cpu":
        return trunk_stats_reference(packed, fcm_out, tvalids)
    out, tv = _launch(packed, fcm_out, tvalids, split)
    return _unbias(out, tv)


# the phases block 0 of a launch times (csrc Phase, in order)
TRUNK_PHASES = ("stem", "bottleneck", "cam_sums", "local_conv", "gate_mlp",
                "append", "transits", "pooling")
# the ring's counters that follow them (csrc RingCount, in order)
RING_COUNTS = ("ring_slices", "ring_landed", "ring_wait_ns")


def trunk_phase_times(packed, fcm_out, tvalids=None, *, iters=10):
    """Where block 0's time goes, on a CUDA tensor at the default split:
    ``iters`` launches with the kernel's phase stamps on, ``{"ms": {phase:
    ms}, "cycles": {phase: SM cycles}, "ring_slices": ..., "ring_landed":
    ..., "ring_wait_ns": ...}`` per launch (``%globaltimer`` and
    ``clock64`` deltas of block 0's thread 0, summed over the layers).
    The ring's counters come from thread 0 of each warpgroup of block 0:
    the K slices of the products over the concat that it waited for (the
    stem's are not counted), those whose copies had landed when it first
    tested the stage's mbarrier, and the ns it waited on them; their
    ratio is the ring's hit share. Each launch counts in
    ``trunk_stats.launches``."""
    _check_call(fcm_out, None)
    n = len(TRUNK_PHASES)
    acc = torch.zeros(2 * n + len(RING_COUNTS), dtype=torch.int64,
                      device=fcm_out.device)
    for _ in range(iters):
        _launch(packed, fcm_out, tvalids, None, acc)
    acc = acc.cpu().double() / iters
    return {"ms": dict(zip(TRUNK_PHASES, (acc[:n] / 1e6).tolist())),
            "cycles": dict(zip(TRUNK_PHASES, acc[n:2 * n].tolist())),
            **dict(zip(RING_COUNTS, acc[2 * n:].tolist()))}


def _check_call(fcm_out, cluster):
    """The forced ``(cs, R)`` or ``None``, after the checks that hold on
    every device."""
    if fcm_out.ndim != 3 or fcm_out.shape[2] != FCM_DIM:
        raise ValueError(f"expected (B, T, {FCM_DIM}), got {tuple(fcm_out.shape)}")
    if cluster is None:
        return None
    return _forced_split(cluster, trunk_geometry(fcm_out.shape[1])[1])


def _launch(packed, fcm_out, tvalids, split, phase=None):
    """One kernel launch on a CUDA tensor: the raw ``(B, 1024)`` mean ||
    biased std and the valid-count tensor."""
    if fcm_out.device.type != "cuda":
        raise ValueError(f"unsupported device {fcm_out.device}")
    b, t_raw, _ = fcm_out.shape
    if t_raw > MAX_T_RAW:
        raise ValueError(
            f"the trunk kernel serves at most {MAX_T_RAW} frames (the 32 s "
            f"bucket), got {t_raw}; longer buckets run the plain model "
            f"(predict.py)")
    t_valid, t16 = trunk_geometry(t_raw)
    dev = fcm_out.device
    index = _device_index(dev)
    cs, rows = split or default_split(b, t_raw, dev)
    if _max_clusters(cs, rows, t_valid, index) == 0:
        raise RuntimeError(
            f"no cluster of {cs} trunk blocks of {rows} rows fits on "
            f"{torch.cuda.get_device_name(index)}")
    x = fcm_out.to(_BF16).contiguous()
    tv_host = _tvalids(tvalids, b, t_valid)
    tiles, tiles_run = trunk_tiles(tv_host, t16, cs, rows)
    if tvalids is None:
        tv, order = torch.full((b,), t_valid, dtype=torch.int32, device=dev), None
    else:
        # the valid counts and the launch order in one copy, not blocking
        both = _to_card(np.concatenate(
            [tv_host, launch_order(tiles_run).astype(np.int32)]), dev)
        tv, order = both[:b], both[b:].data_ptr()
    out = torch.empty((b, 2 * 512), dtype=torch.float32, device=dev)
    ws = torch.empty((2, b, t16, WIDE), dtype=_BF16, device=dev)
    for k, v in packed.items():
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"packed[{k!r}] must be contiguous on {dev}")
    p = _TrunkParams(
        x.data_ptr(), tv.data_ptr(), order, out.data_ptr(), ws.data_ptr(),
        *(packed[k].data_ptr() for k in (
            "w_stem", "stem_aff", "w_lin1", "lin1_aff", "wide_ab", "w_local",
            "w_cam1", "w_cam2", "cam_bias", "w_t0", "w_t1", "w_t2", "tbias",
            "out_aff")),
        None if phase is None else phase.data_ptr(),
        b, t_raw, t_valid, t16, cs, rows)
    from .._build import check
    # the kernel launches on the current device: make it the tensor's
    with torch.cuda.device(dev):
        check(_entries()[0](p, torch.cuda.current_stream(dev).cuda_stream),
              "vpr_campplus_trunk")
    trunk_stats.launches += 1
    trunk_stats.cluster_launches[cs] = trunk_stats.cluster_launches.get(cs, 0) + 1
    trunk_stats.tiles += int(tiles.sum())
    trunk_stats.tiles_run += int(tiles_run.sum())
    return out, tv


trunk_stats.launches = 0
trunk_stats.cluster_launches = {}
trunk_stats.tiles = 0       # 64-row tiles the launches' blocks own
trunk_stats.tiles_run = 0   # of them, the tiles the launches ran


@torch.no_grad()
def campplus_embed_fast(model, packed, packed_fcm, feats, tvalids=None):
    """Features ``(B, T, 80)`` -> embeddings ``(B, embd_dim)``: the FCM
    through ``fcm_fused`` (``packed_fcm`` from ``pack_fcm``), the trunk
    through ``trunk_stats`` (``packed`` from ``pack_trunk``), and the
    DenseBN head with its input in the model's dtype (JAX
    ``pallas_campplus.py:91-112``, whose bucket threshold was measured on
    a TPU; on the H100 the kernel wins at every bucket). Both kernels
    raise on a shape they do not serve."""
    dtype = model.DenseBN_0.Dense_0.weight.dtype
    with tracing.span("vpr.embed.fcm"):
        fcm_out = fcm_fused(packed_fcm, feats)
    with tracing.span("vpr.embed.trunk"):
        stats = trunk_stats(packed, fcm_out, tvalids)
    with tracing.span("vpr.embed.head"):
        return model.DenseBN_0(stats.to(dtype)).float()


def make_campplus_masked_embed_fn(model, featurizer):
    """Pack the trunk and the FCM once and return the kernel path's embed
    function, a ``MaskedEmbedFn``."""
    return MaskedEmbedFn(model, featurizer)


class MaskedEmbedFn:
    """``call(waves (B, L) tensor, ratios (B,) or None) -> embeddings (B,
    embd_dim)``: featurize, then ``campplus_embed_fast``.

    With ratios (numpy or a CPU tensor) the features take the masked CMN
    and the trunk the per-utterance valid counts, which the host computes
    from the same ratios; with ``None`` every frame is valid and nothing
    is copied. On a CUDA tensor the ratios, and in the trunk the valid
    counts with the launch order, reach the card from pinned memory
    without blocking (``_to_card``), so the batches dispatched ahead keep
    the card busy; nothing is read back.

    Counters: ``calls``; ``pinned_calls``, the calls whose per-utterance
    values went to the card that way."""

    def __init__(self, model, featurizer):
        self.model, self.featurizer = model, featurizer
        self.packed = pack_trunk(model)
        self.packed_fcm = pack_fcm(model)
        self.calls = 0
        self.pinned_calls = 0
        self._count_lock = threading.Lock()

    def __call__(self, waves, ratios=None):
        with tracing.span("vpr.embed"):
            pinned = ratios is not None and waves.device.type == "cuda"
            if ratios is not None:
                # float32, and writable for torch.from_numpy
                ratios = np.array(ratios, np.float32)
            with tracing.span("vpr.embed.featurize"):
                feats = self.featurizer(waves, input_lens_ratio=(
                    _to_card(ratios, waves.device) if pinned else ratios))
            t_valid, _ = trunk_geometry(feats.shape[1])
            tvalids = (None if ratios is None
                       else tvalids_from_ratios(ratios, t_valid))
            with self._count_lock:
                self.calls += 1
                self.pinned_calls += pinned
            return campplus_embed_fast(self.model, self.packed,
                                       self.packed_fcm, feats, tvalids)


def _to_card(values, device):
    """The host array ``values`` on the CUDA ``device``, copied without
    blocking from pinned memory of PyTorch's caching host allocator,
    which keeps the block from reuse until the copy has run: calls in
    flight never share one."""
    return torch.from_numpy(values).pin_memory().to(device, non_blocking=True)
