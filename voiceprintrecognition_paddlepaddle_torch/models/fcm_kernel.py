"""The CAM++ FCM front end as a CUDA kernel: the counterpart of the JAX
package's ``models/pallas_fcm.py``.

The FCM takes features ``(B, T, 80)`` and returns ``(B, T, 320)`` in the
frequency-major order of ``campplus.FCM``: conv0 (1 -> 32, 3x3), four
BasicResBlocks (blocks 0 and 2 with frequency stride 2 and 1x1 stride-2
shortcuts) and a final stride-2 3x3 conv.

- ``pack_fcm`` folds each conv bias and BatchNorm into a per-channel fp32
  affine and lays the 12 conv weights out as ``csrc/fcm.cu`` reads them.
- ``fcm_reference`` is the plain PyTorch version, with the TPU kernel's
  rounding points: features rounded to the packed dtype, bf16 operands
  with fp32 sums and an fp32 affine, and ReLU then a bf16 store after
  every conv ('same' zero padding at the time and frequency edges).
- ``fcm_fused`` is the wrapper: the CUDA kernel on a CUDA tensor (with a
  launch counter), the plain version on a CPU tensor.
- ``fcm_stage_times`` times each of the kernel's launches with CUDA
  events; ``fcm_launch_costs`` gives the bytes each launch's design moves
  and the operations it does, for the rates beside those times.
- ``fcm_grids`` sizes the persistent grid of each conv launch from the
  card's resident blocks (``fcm_occupancy``), and the wrapper passes those
  grids to the kernel.

The embed path uses the kernel for buckets of ``FCM_MIN_T`` frames and
more, as the JAX package does (``pallas_campplus.py:88``); shorter
buckets keep the model's plain FCM.
"""

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from .layers import bn_affine

__all__ = ["pack_fcm", "fcm_reference", "fcm_fused", "fcm_supported",
           "fcm_stage_times", "fcm_launch_costs", "fcm_occupancy",
           "fcm_conv_items", "persistent_grid", "fcm_grids", "FCM_LAUNCHES",
           "FCM_MIN_T", "FCM_MAX_FRAMES"]

F_IN = 80                 # input mel bins (the kernel is built for them)
FCM_DIM = 320             # 32 channels x 10 frequencies
FCM_MIN_T = 1000          # frames from which the embed path takes the kernel
FCM_MAX_FRAMES = 6000     # nominal, as the JAX package's (predict's cap rules)
_TIME_TILE = 32           # csrc/fcm.cu kTT (fcm_occupancy checks both)
_FREQ_BAND = 10           # csrc/fcm.cu kFB: output frequencies per item
_C = 32
_BF16 = torch.bfloat16

# conv i -> (module path under FCM_0, BatchNorm, frequency stride; 0 for
# the 1x1 stride-2 shortcuts), the order of ``pallas_fcm.pack_fcm``
_SPECS = [
    ("Conv_0", "BatchNorm_0", 1),
    ("BasicResBlock_0.Conv_0", "BasicResBlock_0.BatchNorm_0", 2),
    ("BasicResBlock_0.Conv_1", "BasicResBlock_0.BatchNorm_1", 1),
    ("BasicResBlock_0.Conv_2", "BasicResBlock_0.BatchNorm_2", 0),
    ("BasicResBlock_1.Conv_0", "BasicResBlock_1.BatchNorm_0", 1),
    ("BasicResBlock_1.Conv_1", "BasicResBlock_1.BatchNorm_1", 1),
    ("BasicResBlock_2.Conv_0", "BasicResBlock_2.BatchNorm_0", 2),
    ("BasicResBlock_2.Conv_1", "BasicResBlock_2.BatchNorm_1", 1),
    ("BasicResBlock_2.Conv_2", "BasicResBlock_2.BatchNorm_2", 0),
    ("BasicResBlock_3.Conv_0", "BasicResBlock_3.BatchNorm_0", 1),
    ("BasicResBlock_3.Conv_1", "BasicResBlock_3.BatchNorm_1", 1),
    ("Conv_1", "BatchNorm_1", 2),
]


# The launches of csrc/fcm.cu, in order: (name, the conv kernel's instance
# (a key of fcm_occupancy; None for conv0, which has its own kernel),
# output frequencies, K of the product per output (input channels x taps,
# the 1x1 shortcut's 32 added where it runs in the same launch), units
# read, units written).
# A unit is one frequency of 32 bf16 channels over every frame, 64 bytes a
# frame; conv0 reads the fp32 features (320 bytes a frame: 5 units). The
# launches of c2 and c7 also read their shortcut's input at the even
# frequencies, those of c5 and c10 the identity residual.
FCM_LAUNCHES = (
    ("conv0", None, 80, 9, 5, 80),
    ("c1", "stride 2", 40, 288, 80, 40),
    ("c2+sc3", "shortcut", 40, 288 + 32, 80, 40),
    ("c4", "stride 1", 40, 288, 40, 40),
    ("c5", "identity", 40, 288, 80, 40),
    ("c6", "stride 2", 20, 288, 40, 20),
    ("c7+sc8", "shortcut", 20, 288 + 32, 40, 20),
    ("c9", "stride 1", 20, 288, 20, 20),
    ("c10", "identity", 20, 288, 40, 20),
    ("c11", "stride 2", 10, 288, 20, 10),
)
_UNIT_BYTES = _C * 2      # one frequency of 32 bf16 channels, per frame


def fcm_launch_costs(b, t):
    """Per launch of the kernel at ``b`` utterances of ``t`` frames:
    ``{"name", "bytes", "flop"}``. Bytes count each unit the launch reads
    or writes once (``FCM_LAUNCHES``); flop is 2 x frames x output
    frequencies x 32 channels x K."""
    frames = b * t
    return [{"name": name, "bytes": (r + w) * frames * _UNIT_BYTES,
             "flop": 2 * frames * f_out * _C * k}
            for name, _, f_out, k, r, w in FCM_LAUNCHES]


def fcm_conv_items(b, t, f_out):
    """Work items of one 32 -> 32 conv launch: (32-frame time tile, band
    of 10 output frequencies, utterance)."""
    return b * -(-t // _TIME_TILE) * (f_out // _FREQ_BAND)


def persistent_grid(n_items, n_sms, per_sm):
    """Blocks of a persistent conv launch: the card's resident blocks
    (``n_sms`` x ``per_sm``), or fewer if there are fewer items."""
    if n_sms < 1 or per_sm < 1:
        raise ValueError(f"no resident block ({n_sms} SMs x {per_sm})")
    return min(n_items, n_sms * per_sm)


def fcm_grids(b, t, occ):
    """Blocks of each conv launch after conv0, in launch order, for ``b``
    utterances of ``t`` frames on a card with ``occ`` (``fcm_occupancy``):
    the grids the wrapper passes to the kernel."""
    return [persistent_grid(fcm_conv_items(b, t, f_out), occ["sms"],
                            occ[kind])
            for _, kind, f_out, *_ in FCM_LAUNCHES[1:]]


def fcm_occupancy(device=None):
    """Resident blocks per SM of the conv kernel's instances on the current
    (or given) CUDA device, as the kernel asks the runtime, and the SM
    count: ``{"stride 2", "shortcut", "stride 1", "identity", "sms"}``."""
    device = torch.device("cuda" if device is None else device)
    return dict(_occupancy(device.index if device.index is not None
                           else torch.cuda.current_device()))


@lru_cache(maxsize=None)
def _occupancy(device_index):
    from .._build import check
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        check(_entries()[2](out), "vpr_fcm_occupancy")
    if (out[5], out[6]) != (_TIME_TILE, _FREQ_BAND):
        raise RuntimeError(f"csrc/fcm.cu has kTT={out[5]}, kFB={out[6]}; this "
                           f"module sizes grids for {_TIME_TILE}, {_FREQ_BAND}")
    return dict(zip(("stride 2", "shortcut", "stride 1", "identity", "sms"),
                    out))


def fcm_supported(t, n_feats):
    """Whether the kernel serves ``t`` frames of ``n_feats`` mel bins
    (``pallas_fcm.py:498-499``)."""
    return n_feats == F_IN and t <= FCM_MAX_FRAMES


@torch.no_grad()
def pack_fcm(model, dtype=_BF16):
    """CAM++ module -> packed FCM tensors on the model's device.

    ``w0..w11``: conv i as ``(9 * cin, 32)``, row ``(df * 3 + dt) * cin + c``
    for the frequency tap ``df`` and time tap ``dt`` of a 3x3 conv, and
    ``(32, 32)`` for the 1x1 shortcuts 3 and 8, in ``dtype`` (bf16 for the
    kernel; fp32 for tests). ``aff (12, 2, 32)`` fp32: per-channel scale
    ``a`` and shift ``a * bias + b`` of the folded BatchNorm."""
    fcm = model.FCM_0
    packed, affs = {}, []
    for i, (conv_name, bn_name, _) in enumerate(_SPECS):
        conv, bn = fcm.get_submodule(conv_name), fcm.get_submodule(bn_name)
        w = conv.weight.float()                       # (32, cin, kf, kt)
        packed[f"w{i}"] = w.permute(2, 3, 1, 0).reshape(-1, _C).to(dtype)
        a, b = bn_affine(bn)
        affs.append(torch.stack([a, a * conv.bias.float() + b]))
    packed["aff"] = torch.stack(affs)
    return {k: v.contiguous() for k, v in packed.items()}


@torch.no_grad()
def fcm_reference(packed, feats):
    """Plain PyTorch FCM: ``(B, T, 80) -> (B, T, 320)`` in the packed
    dtype, with the kernel's rounding points."""
    cd = packed["w1"].dtype
    b, t, _ = feats.shape
    aff = packed["aff"]

    def conv(x, i):
        stride = _SPECS[i][2]
        w = packed[f"w{i}"].float()
        if stride == 0:                               # 1x1, stride (2, 1)
            y = F.conv2d(x, w.t()[:, :, None, None], stride=(2, 1))
        else:
            cin = w.shape[0] // 9
            w = w.reshape(3, 3, cin, _C).permute(3, 2, 0, 1)
            y = F.conv2d(x, w, stride=(stride, 1), padding=1)
        return y * aff[i, 0][:, None, None] + aff[i, 1][:, None, None]

    def store(v):
        return torch.relu(v).to(cd).float()

    x = feats.to(cd).float().transpose(1, 2)[:, None]          # (B, 1, 80, T)
    x = store(conv(x, 0))
    for c1, c2, sc in ((1, 2, 3), (4, 5, None), (6, 7, 8), (9, 10, None)):
        y = store(conv(x, c1))
        x = store(conv(y, c2) + (conv(x, sc) if sc is not None else x))
    out = store(conv(x, 11))                                   # (B, 32, 10, T)
    return out.permute(0, 3, 2, 1).reshape(b, t, FCM_DIM).to(cd)


class _FcmParams(ctypes.Structure):
    """Mirror of ``FcmParams`` in ``csrc/fcm.cu``."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "x", "out", "ws", *(f"w{i}" for i in range(12)), "aff",
        "events")] + [(name, ctypes.c_int) for name in ("B", "T", "T_pad")] + [
        ("grid", ctypes.c_int * (len(FCM_LAUNCHES) - 1))]


@lru_cache(maxsize=None)
def _entries():
    from .._build import kernel_library
    lib = kernel_library().lib
    fn = lib.vpr_fcm
    fn.restype = ctypes.c_int
    fn.argtypes = [_FcmParams, ctypes.c_void_p]
    ws = lib.vpr_fcm_workspace_elems
    ws.restype = ctypes.c_longlong
    ws.argtypes = [ctypes.c_int, ctypes.c_int]
    occ = lib.vpr_fcm_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.POINTER(ctypes.c_int)]
    return fn, ws, occ


def fcm_fused(packed, feats):
    """``(B, T, 80) -> (B, T, 320)`` FCM output.

    A CPU tensor runs ``fcm_reference``. A CUDA tensor launches the CUDA
    kernel (fp32 features in, bf16 out; bf16 packing only) and adds one to
    ``fcm_fused.launches``."""
    _check_shape(feats)
    if feats.device.type == "cpu":
        return fcm_reference(packed, feats)
    return _launch(packed, feats)


def fcm_stage_times(packed, feats, iters=10):
    """CUDA-event ms of each launch of the kernel on the CUDA tensor
    ``feats``, a mean over ``iters`` runs: ``{name: ms}`` in the order of
    ``FCM_LAUNCHES``. Each run counts in ``fcm_fused.launches``."""
    _check_shape(feats)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(FCM_LAUNCHES) + 1)]
    for e in events:          # the handles exist from the first record on
        e.record()
    handles = (ctypes.c_void_p * len(events))(*(e.cuda_event for e in events))
    sums = [0.0] * len(FCM_LAUNCHES)
    for _ in range(iters):
        _launch(packed, feats, handles)
        events[-1].synchronize()
        for i in range(len(FCM_LAUNCHES)):
            sums[i] += events[i].elapsed_time(events[i + 1])
    return {name: s / iters for (name, *_), s in zip(FCM_LAUNCHES, sums)}


def _check_shape(feats):
    if feats.ndim != 3 or feats.shape[2] != F_IN:
        raise ValueError(f"expected (B, T, {F_IN}), got {tuple(feats.shape)}")


def _launch(packed, feats, events=None):
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    b, t, _ = feats.shape
    if not fcm_supported(t, F_IN):
        raise ValueError(f"the FCM kernel serves at most {FCM_MAX_FRAMES} "
                         f"frames, got {t}")
    dev = feats.device
    for k, v in packed.items():
        if v.device != dev or not v.is_contiguous():
            raise ValueError(f"packed[{k!r}] must be contiguous on {dev}")
        if k != "aff" and v.dtype != _BF16:
            raise ValueError(f"the FCM kernel takes bf16 weights, packed[{k!r}] "
                             f"is {v.dtype}")
    fn, ws_elems, _ = _entries()
    x = feats.float().contiguous()
    t_pad = -(-t // _TIME_TILE) * _TIME_TILE
    out = torch.empty((b, t, FCM_DIM), dtype=_BF16, device=dev)
    ws = torch.empty((ws_elems(b, t_pad),), dtype=_BF16, device=dev)
    grids = fcm_grids(b, t, fcm_occupancy(dev))
    p = _FcmParams(x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                   *(packed[f"w{i}"].data_ptr() for i in range(12)),
                   packed["aff"].data_ptr(), ctypes.cast(events, ctypes.c_void_p),
                   b, t, t_pad, (ctypes.c_int * len(grids))(*grids))
    from .._build import check
    # the kernel launches on the current device: make it the tensor's
    with torch.cuda.device(dev):
        check(fn(p, torch.cuda.current_stream(dev).cuda_stream), "vpr_fcm")
    fcm_fused.launches += 1
    return out


fcm_fused.launches = 0
