#!/usr/bin/env python3
"""Variants of the FCM kernel on one NVIDIA GPU: other per-launch
settings, and timing-only ablations.

    python3 fcm_variants.py NAME=SPEC [NAME=SPEC ...]

SPEC is ``as-built`` (``csrc/fcm.cu`` as it is), or four per-launch
settings ``warps/tt/stages/blocks`` joined by ``_`` (launches A, B, C, D:
warps a block, the time tile, the input ring depth, the blocks an SM the
launch is built for), optionally followed by ``,`` and ablations joined
by ``+``:

    emma    every mma.sync replaced by an empty ``asm`` that keeps its
            operands and accumulators (no tensor-core work)
    eldA    every ldmatrix of A replaced the same way (no A loads)
    eldB    every ldmatrix.trans of B replaced the same way (no B loads)
    nobar   no block barrier between two tiles of an item
    noin    no copy of an item's input tile

An ablation gives garbage and only a time. Each variant is written to
``build/fcm_variants/<NAME>.cu``, built with the port's nvcc flags into a
library of its own, and loaded in place of the kernel library (the
wrapper ``models/fcm_kernel.fcm_fused`` runs it, its plan check
included). Variants without ablations are held against
``fcm_reference`` at b3 x 33, b2 x 1598 and b1 x 5 (chip_smoke.py's bars).
Each is timed at b32 x 1598 (the 16 s bucket) and b256 x 298 (3 s) by CUDA
events, two means of 20 calls in each of two rounds (the second in
reverse order), with the ms of each launch (``fcm_stage_times``). One
JSON line a variant; the card's name and power limit first.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "voiceprintrecognition_paddlepaddle_torch", "csrc",
                   "fcm.cu")
OUT = os.path.join(ROOT, "build", "fcm_variants")

_MMA = '''  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
_LDSM = '''  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");'''
_EMPTY_LD = ('  asm volatile("" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) '
             ': "r"(addr));')
ABLATIONS = {
    "emma": (_MMA, '''  asm volatile("" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''),
    "eldA": (_LDSM, _EMPTY_LD),
    "eldB": (_LDSM.replace("m8n8.x4.shared", "m8n8.x4.trans.shared"), _EMPTY_LD),
    "nobar": ("    if constexpr (I + 1 < plan(L).n_tiles) {\n      __syncthreads();\n",
              "    if constexpr (I + 1 < plan(L).n_tiles) {\n"),
    "noin": ("      cp_async16(stage + r * P::rowB + s * kC * 2 + qq * 16,",
             "      if (t == -12345) cp_async16(stage + r * P::rowB + s * kC * 2 + qq * 16,"),
}
# the tail of each launch's Plan{...} in plan(): stages, blocks, warps
_TAIL = re.compile(r"\n                  (\d), (\d), (\d+)\}")
_HEAD = re.compile(r"Plan\{(\d+), 10, ")


def parse(spec):
    """``SPEC`` -> (per-launch settings or None, ablations)."""
    launches, _, ablations = spec.partition(",")
    flags = [f for f in ablations.split("+") if f]
    for f in flags:
        if f not in ABLATIONS:
            raise ValueError(f"unknown ablation {f!r}")
    if launches == "as-built":
        return None, flags
    per = [tuple(int(x) for x in ln.split("/")) for ln in launches.split("_")]
    if len(per) != 4 or any(len(p) != 4 for p in per):
        raise ValueError(f"need warps/tt/stages/blocks for 4 launches: {spec}")
    return per, flags


def variant_source(src, per, flags):
    """``csrc/fcm.cu`` with each launch's settings ``per`` (None: as built)
    and the ablations ``flags``."""
    for f in flags:
        old, new = ABLATIONS[f]
        if src.count(old) != 1:
            raise ValueError(f"ablation {f} does not match the source")
        src = src.replace(old, new)
    if per is None:
        return src
    heads, tails = list(_HEAD.finditer(src)), list(_TAIL.finditer(src))
    if len(heads) != 4 or len(tails) != 4:
        raise ValueError("plan() does not have four launches")
    # right to left, so earlier offsets stay valid
    edits = [(m.start(1), m.end(1), str(p[1])) for m, p in zip(heads, per)]
    edits += [(m.start(1), m.end(3), f"{p[2]}, {p[3]}, {p[0]}")
              for m, p in zip(tails, per)]
    for a, b, text in sorted(edits, reverse=True):
        src = src[:a] + text + src[b:]
    return src


def _build(name, source):
    from voiceprintrecognition_paddlepaddle_torch import _build as vb
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"{name}.so")
    with open(cu, "w", encoding="utf-8") as f:
        f.write(source)
    r = subprocess.run([vb._nvcc(), *vb.NVCC_FLAGS, "-shared", "-o", so, cu],
                       capture_output=True, text=True, timeout=600)
    return so, r.returncode, r.stdout + r.stderr


def _use(fkm, so, launches, tts):
    """Route ``fcm_fused`` to the library ``so``, the plan ``launches``
    with time tiles ``tts``."""
    lib = ctypes.CDLL(so)
    fn, ws = lib.vpr_fcm, lib.vpr_fcm_workspace_elems
    occ, plan = lib.vpr_fcm_occupancy, lib.vpr_fcm_plan
    fn.restype, fn.argtypes = ctypes.c_int, [fkm._FcmParams, ctypes.c_void_p]
    ws.restype, ws.argtypes = ctypes.c_longlong, [ctypes.c_int, ctypes.c_int]
    occ.restype, occ.argtypes = ctypes.c_int, [ctypes.POINTER(ctypes.c_int)]
    plan.restype = ctypes.c_int
    plan.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    fkm._entries = lambda: (fn, ws, occ, plan)
    fkm._occupancy.cache_clear()
    fkm.FCM_LAUNCHES = tuple(ln._replace(tt=tt)
                             for ln, tt in zip(launches, tts))


def main(argv):
    import numpy as np
    import torch
    import chip_smoke as cs
    from voiceprintrecognition_paddlepaddle_torch.models import \
        fcm_kernel as fkm
    from voiceprintrecognition_paddlepaddle_torch.models.campplus import \
        CAMPPlus
    from voiceprintrecognition_paddlepaddle_torch.models.convert import \
        jax_to_torch_state

    if not torch.cuda.is_available():
        raise RuntimeError("fcm_variants.py needs an NVIDIA GPU")
    specs = dict(a.split("=", 1) for a in argv)
    if not specs:
        raise SystemExit(__doc__)
    launches = fkm.FCM_LAUNCHES
    with open(SRC, encoding="utf-8") as f:
        src = f.read()
    parsed = {n: parse(s) for n, s in specs.items()}
    with ThreadPoolExecutor(len(parsed)) as ex:
        built = dict(zip(parsed, ex.map(
            lambda n: _build(n, variant_source(src, *parsed[n])), parsed)))
    print(cs.card_line(), flush=True)
    for name, (_, rc, log) in built.items():
        if rc:
            raise RuntimeError(f"{name} did not build:\n{log[-3000:]}")
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"[build] {name}: registers {regs}, spill stores {spills}",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    model = CAMPPlus(80, embd_dim=192)
    model.load_state_dict(jax_to_torch_state(
        cs.random_flax_variables(model, cs.SEED)))
    model.cuda().eval().requires_grad_(False)
    packed = fkm.pack_fcm(model)
    rng = np.random.RandomState(cs.SEED)
    xs = {name: torch.from_numpy(rng.randn(b, t, 80).astype(np.float32)).cuda()
          for name, (b, t) in (("b32 x 1598", (32, 1598)),
                               ("b256 x 298", (256, 298)))}
    res = {n: {"spec": specs[n], "ms": {k: [] for k in xs}, "split": {}}
           for n in specs}
    names = list(specs)
    for rnd, order in enumerate((names, names[::-1])):
        for name in order:
            per, flags = parsed[name]
            _use(fkm, built[name][0], launches,
                 [p[1] for p in per] if per else [ln.tt for ln in launches])
            if rnd == 0:
                res[name]["occupancy"] = fkm.fcm_occupancy()
                if not flags:
                    for b, t in ((3, 33), (2, 1598), (1, 5)):
                        x = torch.from_numpy(np.random.RandomState(t).randn(
                            b, t, 80).astype(np.float32)).cuda()
                        g = fkm.fcm_fused(packed, x).double()
                        r = fkm.fcm_reference(packed, x).double()
                        c = float((g * r).sum() / (g.norm() * r.norm()))
                        d = float((g - r).abs().max()) / max(
                            1.0, float(r.abs().max()))
                        if not (c > 0.9999 and d < 5e-2):
                            raise AssertionError(
                                f"{name} disagrees at b{b} x {t}: cos {c}, "
                                f"max|d|/scale {d}")
                for k, x in xs.items():
                    res[name]["split"][k] = fkm.fcm_stage_times(packed, x, 10)
            for k, x in xs.items():
                res[name]["ms"][k] += [cs.cuda_ms(
                    lambda: fkm.fcm_fused(packed, x), 20, 3) for _ in range(2)]
    for name in names:
        print(json.dumps({"variant": name, **res[name]}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
