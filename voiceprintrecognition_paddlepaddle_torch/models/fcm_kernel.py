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
- ``FCM_LAUNCHES`` is the kernel's plan: four launches, one per residual
  block (conv0 in the first, c11 in the last). Each walks items of a time
  tile by a band of output frequencies and keeps the block's
  intermediates in shared memory; its tiles (``FcmTile``) say which
  frames and frequencies of each layer an item holds, halos included.
  The CUDA source holds the same table; ``fcm_occupancy`` checks the two
  agree when it first asks the card.
- ``fcm_stage_times`` times each launch with CUDA events;
  ``fcm_launch_costs`` gives the bytes each launch moves (its input read
  and its output written once), the function's operations and the
  design's (halos and ragged m-tiles included), for the rates beside
  those times.
- ``fcm_grids`` sizes the persistent grid of each launch from the card's
  resident blocks (``fcm_occupancy``), and the wrapper passes those grids
  to the kernel.

The embed path (``trunk_kernel.campplus_embed_fast``) takes the kernel
at every length it supports. On an NVIDIA H100 (700 W) it beat the
model's cuDNN convs 9.6x to 19.6x at b1, b64 and b256 of each bucket from
1 s to 8 s, and 12.4x to 13.0x at b256 x 298 and b32 x 1598 frames (0.06
to 0.12 against 0.90 to 1.53 ms at b1 x 98, 4.0 against 52.7 to 53.4 ms
at b256 x 798; three runs of the crossover, ``PERF.md`` section 6). The
JAX package's 1000-frame threshold is a TPU's.
"""

import ctypes
from collections import namedtuple
from functools import lru_cache

import torch
import torch.nn.functional as F

from .layers import bn_affine

__all__ = ["pack_fcm", "fcm_reference", "fcm_fused", "fcm_supported",
           "fcm_stage_times", "fcm_launch_costs", "fcm_occupancy",
           "fcm_items", "persistent_grid", "fcm_grids", "FCM_LAUNCHES",
           "FCM_MAX_FRAMES"]

F_IN = 80                 # input mel bins (the kernel is built for them)
FCM_DIM = 320             # 32 channels x 10 frequencies
FCM_MAX_FRAMES = 6000     # nominal, as the JAX package's (predict's cap rules)
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


# One tile of a launch: for an item at frame t0 and band start f0, the
# frames [t0 - halo, t0 + tt + halo) and the frequencies [scale * f0 + off,
# + slots) of a layer ``width`` frequencies wide, of which slots [lo, hi)
# are computed (or copied; the others hold zeros: frequencies outside the
# layer in every item). conv: the packed conv that computes the tile from
# the one before (-1: the launch's input, copied from device memory;
# launch A's holds fp32 bins). res: the tile whose residual is added
# before the ReLU (-1: none), res_conv its 1x1 stride-2 shortcut (-1: the
# identity).
FcmTile = namedtuple("FcmTile", "conv halo scale off slots lo hi width res "
                                "res_conv")
# One launch: name, its convs, the item's time tile ``tt`` and band of
# ``fb`` output frequencies of ``f_out``, its tiles (first: its input,
# last: its output), and the units it reads and writes (a unit is one
# frequency of 32 bf16 channels over every frame, 64 bytes a frame; the
# fp32 features are 5).
FcmLaunch = namedtuple("FcmLaunch", "name convs tt fb f_out tiles "
                                    "read_units write_units")
FCM_LAUNCHES = (
    FcmLaunch("A", "conv0 c1 c2+sc3", 16, 10, 40, (
        FcmTile(-1, 3, 2, -4, 28, 0, 28, 80, -1, -1),    # features, fp32
        FcmTile(0, 2, 2, -3, 25, 0, 25, 80, -1, -1),     # conv0
        FcmTile(1, 1, 1, -1, 12, 0, 12, 40, -1, -1),     # c1, stride 2
        FcmTile(2, 0, 1, 0, 10, 0, 10, 40, 1, 3)), 5, 40),
    FcmLaunch("B", "c4 c5+x", 32, 10, 40, (
        FcmTile(-1, 2, 1, -2, 14, 0, 14, 40, -1, -1),    # A's output
        FcmTile(4, 1, 1, -1, 12, 0, 12, 40, -1, -1),
        FcmTile(5, 0, 1, 0, 10, 0, 10, 40, 0, -1)), 40, 40),
    FcmLaunch("C", "c6 c7+sc8", 32, 10, 20, (
        FcmTile(-1, 2, 2, -3, 25, 0, 25, 40, -1, -1),    # B's output
        FcmTile(6, 1, 1, -1, 12, 0, 12, 20, -1, -1),     # c6, stride 2
        FcmTile(7, 0, 1, 0, 10, 0, 10, 20, 0, 8)), 40, 20),
    FcmLaunch("D", "c9 c10+x c11", 16, 10, 10, (
        FcmTile(-1, 3, 1, -1, 22, 1, 21, 20, -1, -1),    # C's output
        FcmTile(9, 2, 1, -1, 22, 1, 21, 20, -1, -1),
        FcmTile(10, 1, 1, -1, 21, 1, 21, 20, 0, -1),
        FcmTile(11, 0, 1, 0, 10, 0, 10, 10, -1, -1)), 20, 10),
)
_UNIT_BYTES = _C * 2      # one frequency of 32 bf16 channels, per frame


def _taps(conv):
    """K of conv ``conv``'s product per output: 9 for conv0, 32 for the
    1x1 shortcuts, 288 for the 3x3 convs."""
    return 9 if conv == 0 else _C if conv in (3, 8) else 9 * _C


def fcm_items(b, t, launch):
    """Work items of ``launch`` (an ``FcmLaunch``): (time tile, band,
    utterance); a ragged last tile counts."""
    return b * -(-t // launch.tt) * (launch.f_out // launch.fb)


def fcm_launch_costs(b, t):
    """Per launch of the kernel at ``b`` utterances of ``t`` frames:
    ``{"name", "bytes", "flop", "design_flop"}``. Bytes count each unit
    the launch reads or writes once; flop is the function's work, 2 x
    frames x output frequencies x 32 channels x K of each conv; design_flop
    what the kernel issues: every m-tile of 16 positions of every tile an
    item computes, halos and ragged m-tiles included, conv0 at K = 16."""
    out = []
    for ln in FCM_LAUNCHES:
        flop = design = 0
        for tile in ln.tiles[1:]:
            k = _taps(tile.conv) + (_C if tile.res_conv >= 0 else 0)
            flop += 2 * b * t * tile.width * _C * k
            positions = (ln.tt + 2 * tile.halo) * (tile.hi - tile.lo)
            design += 2 * -(-positions // 16) * 16 * _C * (
                16 if tile.conv == 0 else k)
        out.append({"name": ln.name,
                    "bytes": (ln.read_units + ln.write_units) * b * t
                    * _UNIT_BYTES,
                    "flop": flop, "design_flop": design * fcm_items(b, t, ln)})
    return out


def persistent_grid(n_items, n_sms, per_sm):
    """Blocks of a persistent launch: the card's resident blocks
    (``n_sms`` x ``per_sm``), or fewer if there are fewer items."""
    if n_sms < 1 or per_sm < 1:
        raise ValueError(f"no resident block ({n_sms} SMs x {per_sm})")
    return min(n_items, n_sms * per_sm)


def fcm_grids(b, t, occ):
    """Blocks of each launch, in launch order, for ``b`` utterances of
    ``t`` frames on a card with ``occ`` (``fcm_occupancy``): the grids the
    wrapper passes to the kernel."""
    return [persistent_grid(fcm_items(b, t, ln), occ["sms"], occ[ln.name])
            for ln in FCM_LAUNCHES]


def _plan_ints():
    """``FCM_LAUNCHES`` as ``vpr_fcm_plan`` writes the kernel's plan."""
    out = []
    for ln in FCM_LAUNCHES:
        out += [ln.tt, ln.fb, ln.f_out, len(ln.tiles)]
        for tile in ln.tiles:
            out += list(tile)
    return out


def fcm_occupancy(device=None):
    """Resident blocks per SM of each launch's kernel on the current (or
    given) CUDA device, as the kernel asks the runtime, and the SM count:
    ``{"A", "B", "C", "D", "sms"}``."""
    device = torch.device("cuda" if device is None else device)
    return dict(_occupancy(device.index if device.index is not None
                           else torch.cuda.current_device()))


@lru_cache(maxsize=None)
def _occupancy(device_index):
    from .._build import check
    _, _, occ, plan = _entries()
    want = _plan_ints()
    got = (ctypes.c_int * (len(want) + 1))()
    n = plan(got, len(got))
    if list(got[:n]) != want:
        raise RuntimeError(f"csrc/fcm.cu was built with the plan {list(got[:n])}"
                           f"; this module sizes and checks {want}")
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device_index):
        check(occ(out), "vpr_fcm_occupancy")
    return dict(zip([ln.name for ln in FCM_LAUNCHES] + ["sms"], out))


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
        "events")] + [(name, ctypes.c_int) for name in ("B", "T")] + [
        ("grid", ctypes.c_int * len(FCM_LAUNCHES))]


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
    plan = lib.vpr_fcm_plan
    plan.restype = ctypes.c_int
    plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    return fn, ws, occ, plan


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
    return {ln.name: s / iters for ln, s in zip(FCM_LAUNCHES, sums)}


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
    fn, ws_elems, *_ = _entries()
    x = feats.float().contiguous()
    out = torch.empty((b, t, FCM_DIM), dtype=_BF16, device=dev)
    ws = torch.empty((ws_elems(b, t),), dtype=_BF16, device=dev)
    grids = fcm_grids(b, t, fcm_occupancy(dev))
    p = _FcmParams(x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                   *(packed[f"w{i}"].data_ptr() for i in range(12)),
                   packed["aff"].data_ptr(), ctypes.cast(events, ctypes.c_void_p),
                   b, t, (ctypes.c_int * len(grids))(*grids))
    from .._build import check
    # the kernel launches on the current device: make it the tensor's
    with torch.cuda.device(dev):
        check(fn(p, torch.cuda.current_stream(dev).cuda_stream), "vpr_fcm")
    fcm_fused.launches += 1
    return out


fcm_fused.launches = 0
