// The CAM++ FCM front end (12 convolutions in 4 launches, one per residual
// block) for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's models/pallas_fcm.py:
// `_kernel` (:251; pallas_call in `_fcm_call`, :399, one pass per
// utterance) and `_fcm_call_chunked` (:442; the same kernel over halo
// windows for long buckets). The chunked variant existed only because one
// utterance's activations had to fit in VMEM. Here every launch is a walk
// over (time tile, frequency band) items with their halos, so one code
// path serves any length.
//
// What it computes, per utterance (features x: (T, 80) fp32, rounded to
// bf16), in torch's (C, F, T) terms with 'same' zero padding in both
// frequency and time at every layer (frames outside [0, T) and
// frequencies outside the layer read as zero):
//   conv0   1 -> 32, 3x3                    relu(aff0)             F 80
//   block 0 c1 3x3 stride (2,1)             relu(aff1)             F 40
//           c2 3x3 + 1x1 stride-2 shortcut  relu(aff2(c2) + aff3(sc))
//   block 1 c4 3x3                          relu(aff4)
//           c5 3x3 + identity               relu(aff5(c5) + x)
//   block 2 as block 0 (convs 6, 7, 8)                             F 20
//   block 3 as block 1 (convs 9, 10)
//   final   3x3 stride (2,1)                relu(aff11)            F 10
// Each aff is the conv bias and the BatchNorm folded into a per-channel
// fp32 affine. Every conv takes bf16 operands with fp32 accumulation and
// stores bf16, at the TPU kernel's rounding points, so the plain PyTorch
// version (models/fcm_kernel.fcm_reference) matches it closely. The
// output (T, 10, 32) is campplus.FCM's frequency-major (T, 320).
//
// What bounds it on the H100. The function needs 4.8 MFLOP a frame, nearly
// all in the ten 32 -> 32 3x3 convs (small GEMMs: K = 288, N = 32): at
// b32 x 1598 frames 244 GFLOP, 0.247 ms on the bf16 tensor cores (b256 x
// 298: 0.368 ms). A 32 -> 32 conv does about 144 FLOP per byte of its own
// activations, below the card's ridge, so a design that stores every
// conv's output in device memory is bound by bytes: one launch per conv
// moved 775 "units" (a unit is one frequency of 32 bf16 channels over
// every frame, 64 bytes a frame), a byte floor of 0.76 ms at b32 x 1598.
// This design keeps each residual block's intermediates on chip: four
// launches, each reading its input and writing its output once, 215 units
// (fcm_kernel.FCM_LAUNCHES), a byte floor of 0.21 ms at b32 x 1598 (b256 x
// 298: 0.31 ms), below the operations bound. What it pays instead is the
// halo: each item recomputes the border its chain of 3x3 convs needs, 18 %
// more products at b32 x 1598, 23 % at b256 x 298 (fcm_kernel.
// fcm_launch_costs, "design_flop"). With the bytes gone, the pace is set
// by the products (mma.sync and its ldmatrix operands) and the epilogues,
// which alternate between the block barriers of a layer; two blocks an SM
// overlap one's epilogues with the other's products where shared memory
// allows (PERF.md has the ablations).
//
//   launch  convs                     reads              writes
//   A       conv0, c1, c2 + sc3       fp32 features      (B, T, 40, 32)
//   B       c4, c5 + identity         A's output         (B, T, 40, 32)
//   C       c6, c7 + sc8              B's output         (B, T, 20, 32)
//   D       c9, c10 + identity, c11   C's output         (B, T, 10, 32)
//
// Design. The plan (plan() below; fcm_kernel.FCM_LAUNCHES holds the same
// tiles and checks them at load through vpr_fcm_plan) gives each launch its
// item, a time tile of `tt` frames by a band of `fb` output frequencies,
// its tiles, first (the launch's input) to last (its output), its input
// ring depth, its blocks an SM and its warps a block. Tile i of an item at
// frame t0 and band start f0 holds the frames [t0 - halo, t0 + tt + halo)
// and the frequencies [scale * f0 + off, + slots) of its layer,
// channels-last bf16 in shared memory; the halo shrinks by one frame per
// 3x3 conv and the bands follow the stride-2 frequency maps (a stride-2
// output f reads 2f - 1 .. 2f + 1, a shortcut 2f). Launch D holds all 20
// frequencies (one band), with zero slots for frequencies -1 and 20.
//   - Persistent blocks (fcm_kernel.fcm_grids: the card's resident blocks
//     from vpr_fcm_occupancy, or the item count if smaller) walk items
//     (band, time tile, utterance), stride gridDim.x; each stages its
//     launch's weights and affines in shared memory once.
//   - The input tile is copied by cp.async.cg 16-byte copies, into a ring
//     of 2 stages (the next item loads while one is computed) or, where
//     two blocks share an SM, 1 stage (the other block runs meanwhile).
//     Frames outside [0, T) and frequencies outside the layer are
//     zero-filled by the copy (src-size 0), never read from memory.
//   - Each later tile is computed from the one before. Its positions
//     (slot-major over frames) are cut into m-tiles of 16; warp w takes
//     m-tiles w, w + warps, ..., a count fixed at compile time, and carries
//     up to 4 of them through one pass of the taps. The products are
//     mma.sync.m16n8k16 bf16 in PTX, A (16 positions x 16 channels of one
//     tap) by ldmatrix from the tile before (each lane gives its own row
//     address, so a tap's window is a shifted view), B (the tap's 16 x 32
//     weights) by ldmatrix.trans, once per tap for the warp's m-tiles.
//   - The epilogue works on the accumulator fragments in registers: the
//     affine (this lane's channels' scales and shifts held in registers),
//     the shortcut (its own accumulators, the 1x1 product from the block
//     input's tile) or the identity residual (from the input tile), the
//     ReLU and the bf16 rounding, then a bf16x2 store into the next tile,
//     or, for the launch's last tile, into device memory. A position
//     outside [0, T) or outside the layer's frequencies is stored as zero,
//     since the plain version zero-pads every conv's input: it is not
//     relu(affine(0)).
//   - conv0 (K = 9, one channel) runs on the tensor cores too: each lane
//     builds its A fragment from the fp32 feature tile (rounded to bf16,
//     taps 9-15 zero) and holds conv0's B fragments in registers.
//   - One block barrier between two tiles, one before each item.
// Shared-memory rows are padded to an odd number of 16-byte chunks so that
// the 8 row addresses of an ldmatrix over consecutive frames fall in
// distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

typedef __nv_bfloat16 bf16;

struct FcmParams {
  const float* x;      // (B, T, 80) features
  bf16* out;           // (B, T, 320) = (B, T, 10, 32)
  // vpr_fcm_workspace_elems(B, T) bf16: the outputs of launches A, B, C
  bf16* ws;
  // conv i: (9 * cin, 32), rows (df * 3 + dt) * cin + c; the 1x1
  // shortcuts 3 and 8: (32, 32)
  const bf16 *w0, *w1, *w2, *w3, *w4, *w5, *w6, *w7, *w8, *w9, *w10, *w11;
  const float* aff;    // (12, 2, 32): scale, shift
  // null, or 5 events: recorded before the first launch and after each of
  // the 4 launches (per-launch times, for measurement)
  cudaEvent_t* events;
  int B, T;
  // blocks of each launch, in launch order (any count >= 1 computes every
  // item; fcm_kernel.fcm_grids sizes them)
  int grid[4];
};

namespace {

constexpr int kC = 32;               // channels
constexpr int kF0 = 80;              // input mel bins
constexpr int kMG = 4;               // m-tiles a warp carries through one pass of the taps
constexpr int kWRowB = kC * 2 + 16;  // a staged weight row, bytes (5 chunks)
constexpr int kLaunches = 4;
constexpr int kMaxTiles = 4;
constexpr int kMaxDevices = 64;

// One tile of a launch (see the note at the head).
struct Tile {
  int conv;      // the packed conv that computes it; -1: the launch's input
  int halo;      // frames [t0 - halo, t0 + tt + halo)
  int scale, off;  // first frequency: scale * f0 + off
  int slots;     // frequencies held (launch A's input: fp32 bins)
  int lo, hi;    // slots computed (or copied); the others stay zero
  int width;     // frequencies of the layer
  int res;       // tile of the residual added before the ReLU; -1: none
  int res_conv;  // its 1x1 stride-2 shortcut conv; -1: the identity
};

struct Plan {
  int tt, fb, f_out, n_tiles;
  Tile t[kMaxTiles];
  int stages;    // input ring depth (2: the next item loads while one runs)
  int blocks;    // resident blocks an SM the launch is built for
  int warps;     // warps a block
};

__host__ __device__ constexpr Plan plan(int l) {
  return l == 0 ? Plan{16, 10, 40, 4, {
                      {-1, 3, 2, -4, 28, 0, 28, 80, -1, -1},   // features, fp32
                      {0, 2, 2, -3, 25, 0, 25, 80, -1, -1},    // conv0
                      {1, 1, 1, -1, 12, 0, 12, 40, -1, -1},    // c1, stride 2
                      {2, 0, 1, 0, 10, 0, 10, 40, 1, 3}},      // c2 + sc3(conv0)
                  2, 2, 6}
       : l == 1 ? Plan{32, 10, 40, 3, {
                      {-1, 2, 1, -2, 14, 0, 14, 40, -1, -1},   // A's output
                      {4, 1, 1, -1, 12, 0, 12, 40, -1, -1},    // c4
                      {5, 0, 1, 0, 10, 0, 10, 40, 0, -1},      // c5 + identity
                      {}},
                  1, 2, 6}
       : l == 2 ? Plan{32, 10, 20, 3, {
                      {-1, 2, 2, -3, 25, 0, 25, 40, -1, -1},   // B's output
                      {6, 1, 1, -1, 12, 0, 12, 20, -1, -1},    // c6, stride 2
                      {7, 0, 1, 0, 10, 0, 10, 20, 0, 8},       // c7 + sc8(input)
                      {}},
                  2, 1, 8}
                : Plan{16, 10, 10, 4, {
                      {-1, 3, 1, -1, 22, 1, 21, 20, -1, -1},   // C's output
                      {9, 2, 1, -1, 22, 1, 21, 20, -1, -1},    // c9
                      {10, 1, 1, -1, 21, 1, 21, 20, 0, -1},    // c10 + identity
                      {11, 0, 1, 0, 10, 0, 10, 10, -1, -1}},   // c11, stride 2
                  2, 1, 8};
}

__host__ __device__ constexpr int w_bytes(int conv) {
  return conv <= 0 ? 0 : (conv == 3 || conv == 8 ? kC : 9 * kC) * kWRowB;
}
__host__ __device__ constexpr int n_affs(int l, int i) {  // affines of tile i
  return i == 0 ? 0 : 1 + (plan(l).t[i].res_conv >= 0 ? 1 : 0);
}
// shared-memory layout of launch l: the weights of tiles 1.. (a 3x3 conv,
// then its shortcut), their affines (scale, shift; 256 bytes each), the
// input ring (2 stages of tile 0), tiles 1..
__host__ __device__ constexpr int w_off(int l, int i) {
  int o = 0;
  for (int k = 1; k < i; ++k)
    o += w_bytes(plan(l).t[k].conv) +
         (plan(l).t[k].res_conv >= 0 ? w_bytes(plan(l).t[k].res_conv) : 0);
  return o;
}
__host__ __device__ constexpr int aff_off(int l, int i) {
  int o = w_off(l, plan(l).n_tiles);
  for (int k = 1; k < i; ++k) o += n_affs(l, k) * 2 * kC * 4;
  return o;
}
__host__ __device__ constexpr int tile_bytes(int l, int i) {
  const Tile t = plan(l).t[i];
  const int rows = plan(l).tt + 2 * t.halo;
  return rows * (l == 0 && i == 0 ? t.slots * 4 : t.slots * kC * 2 + 16);
}
__host__ __device__ constexpr int tile_off(int l, int i) {  // tile 0: the ring
  int o = aff_off(l, plan(l).n_tiles);
  for (int k = 0; k < i; ++k) o += tile_bytes(l, k) * (k == 0 ? plan(l).stages : 1);
  return o;
}
// the last tile is not in shared memory: its epilogue stores to device memory
__host__ __device__ constexpr int smem_bytes(int l) { return tile_off(l, plan(l).n_tiles - 1); }

// geometry of tile I of launch L, as compile-time scalars
template <int L, int I>
struct TG {
  static constexpr int conv = plan(L).t[I].conv, halo = plan(L).t[I].halo;
  static constexpr int scale = plan(L).t[I].scale, off = plan(L).t[I].off;
  static constexpr int slots = plan(L).t[I].slots, lo = plan(L).t[I].lo;
  static constexpr int hi = plan(L).t[I].hi, width = plan(L).t[I].width;
  static constexpr int res = plan(L).t[I].res, res_conv = plan(L).t[I].res_conv;
  static constexpr bool feats = L == 0 && I == 0;
  static constexpr int rows = plan(L).tt + 2 * halo;
  // a frame of the tile: slots x 32 bf16 and one pad chunk (odd chunks);
  // the fp32 feature tile: 28 bins, 7 chunks
  static constexpr int rowB = feats ? slots * 4 : slots * kC * 2 + 16;
  static constexpr int bytes = rows * rowB;
  static constexpr int np = rows * (hi - lo);  // positions computed
  static constexpr int nmt = (np + 15) / 16;   // m-tiles
  // shared-memory offsets: the tile (tile 0: the ring's first stage), its
  // conv's weights and shortcut's, its affines
  static constexpr int at = tile_off(L, I), w_at = w_off(L, I);
  static constexpr int wsc_at = w_at + w_bytes(conv), aff_at = aff_off(L, I);
};

// a block may use 227 KB; an SM holds 228 KB, less 1 KB a block
__host__ __device__ constexpr bool fits(int l) {
  return smem_bytes(l) <= 232448 && plan(l).blocks * (smem_bytes(l) + 1024) <= 233472;
}
static_assert(fits(0) && fits(1) && fits(2) && fits(3),
              "a launch's blocks do not fit an SM's shared memory");

// ---- PTX: asynchronous copies, ldmatrix, mma.sync -------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros when !full (src-size 0:
// nothing is read from `src`)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row-major) x b (16x8, col-major), bf16 in, fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of a 16 x 32 weight slice (staged rows of kWRowB bytes; `w`
// is this lane's ldmatrix row address in it): b[j] for the n-tile of
// channels 8j .. 8j + 7
__device__ __forceinline__ void load_b(uint32_t (&b)[4][2], uint32_t w) {
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    uint32_t r[4];
    ldsm_x4_trans(r, w + np * 32);
    b[2 * np][0] = r[0];
    b[2 * np][1] = r[1];
    b[2 * np + 1][0] = r[2];
    b[2 * np + 1][1] = r[3];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

struct LaunchArgs {
  const void* in;        // launch A: (B, T, 80) fp32; else (B, T, F_in, 32) bf16
  bf16* out;             // (B, T, f_out, 32)
  const bf16* w[12];
  const float* aff;      // (12, 2, 32)
  int B, T;
};

// one item of a launch: its first frame and band start, the frames of the
// utterance, and the utterance's (T, f_out, 32) output
struct Item {
  int t0, f0, T;
  bf16* out;
};

// this lane's roles: ldmatrix row (lane & 7) of matrix (lane >> 3), the
// matrices being (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
// 8-15) of a 16 x 16 bf16 block; accumulator rows g, g + 8 and columns 2q,
// 2q + 1 of each n-tile
struct Lane {
  int warp, lrow, lcol, g, q;
  __device__ Lane()
      : warp(threadIdx.x >> 5),
        lrow((threadIdx.x & 7) + ((threadIdx.x >> 3) & 1) * 8),
        lcol(((threadIdx.x & 31) >> 4) * 8),
        g((threadIdx.x & 31) >> 2),
        q(threadIdx.x & 3) {}
};

// This lane's affines of tile I (its conv's, then its shortcut's): scale
// and shift of channels 8j + 2q + e at [k][0 or 1][2j + e].
template <int L, int I>
struct LaneAff {
  static constexpr int kN = TG<L, I>::res_conv >= 0 ? 2 : 1;
  float v[kN][2][8];
  __device__ __forceinline__ LaneAff(const unsigned char* smem, const Lane& ln) {
    const float* aff = reinterpret_cast<const float*>(smem + TG<L, I>::aff_at);
#pragma unroll
    for (int k = 0; k < kN; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[k][0][2 * j + e] = aff[2 * kC * k + 8 * j + 2 * ln.q + e];
          v[k][1][2 * j + e] = aff[2 * kC * k + kC + 8 * j + 2 * ln.q + e];
        }
  }
};

// The epilogue of one m-tile `mt` of tile I: the affine, the residual,
// the ReLU, the zero edges, a bf16x2 store per row and channel pair.
// `res`: the residual tile's shared address (the ring stage for tile 0).
template <int L, int I>
__device__ __forceinline__ void epilogue(unsigned char* smem, uint32_t s0, const Lane& ln,
                                         const LaneAff<L, I>& aff, const float (&acc)[4][4],
                                         int mt, uint32_t res, const Item& it) {
  using O = TG<L, I>;
  unsigned char* out = smem + O::at;
  float sc[4][4];
  if constexpr (O::res >= 0 && O::res_conv >= 0) {
    // the 1x1 stride-(2,1) shortcut over the same positions: output (r, s)
    // reads the block input at frame r + XR, frequency 2 (scale f0 + off + s)
    using R = TG<L, O::res>;
    constexpr int XR = R::halo - O::halo, XS = 2 * O::off - R::off;
    static_assert(plan(L).f_out / plan(L).fb == 1 || R::scale == 2 * O::scale, "");
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    int p = mt * 16 + ln.lrow;
    p = p < O::np ? p : O::np - 1;
    const int r = p % O::rows, s = O::lo + p / O::rows;
    const uint32_t x_lane = res + (r + XR) * R::rowB + (2 * s + XS) * kC * 2 + ln.lcol * 2;
    const uint32_t wsc_lane = s0 + O::wsc_at + ln.lrow * kWRowB + ln.lcol * 2;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      uint32_t af[4], bw[4][2];
      ldsm_x4(af, x_lane + kc * 32);
      load_b(bw, wsc_lane + kc * 16 * kWRowB);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma16816(sc[j], af, bw[j][0], bw[j][1]);
    }
  }
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int p = mt * 16 + ln.g + 8 * e2;
    if (p >= O::np) continue;
    const int r = p % O::rows, s = O::lo + p / O::rows;
    const int t = it.t0 - O::halo + r, f = O::scale * it.f0 + O::off + s;
    const bool valid = t >= 0 && t < it.T && f >= 0 && f < O::width;
    // the launch's last tile goes straight to device memory (frames past
    // T are not stored), the others to their shared tile
    constexpr bool kOut = I + 1 == plan(L).n_tiles;
    if (kOut && t >= it.T) continue;
    unsigned char* dst = kOut ? reinterpret_cast<unsigned char*>(
                                    it.out + ((size_t)t * plan(L).f_out + f) * kC)
                              : out + r * O::rowB + s * kC * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * ln.q;
      float v0 = acc[j][2 * e2] * aff.v[0][0][2 * j] + aff.v[0][1][2 * j];
      float v1 = acc[j][2 * e2 + 1] * aff.v[0][0][2 * j + 1] + aff.v[0][1][2 * j + 1];
      if constexpr (O::res >= 0 && O::res_conv >= 0) {
        v0 += sc[j][2 * e2] * aff.v[1][0][2 * j] + aff.v[1][1][2 * j];
        v1 += sc[j][2 * e2 + 1] * aff.v[1][0][2 * j + 1] + aff.v[1][1][2 * j + 1];
      }
      if constexpr (O::res >= 0 && O::res_conv < 0) {
        using R = TG<L, O::res>;
        constexpr int XR = R::halo - O::halo, XS = O::off - R::off;
        static_assert(plan(L).f_out / plan(L).fb == 1 || R::scale == O::scale, "");
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(
            smem + (res - s0) + (r + XR) * R::rowB + (s + XS) * kC * 2 + c * 2);
        v0 += __bfloat162float(x.x);
        v1 += __bfloat162float(x.y);
      }
      *reinterpret_cast<uint32_t*>(dst + c * 2) =
          valid ? pack_bf16(fmaxf(v0, 0.f), fmaxf(v1, 0.f)) : 0u;
    }
  }
}

// M m-tiles of tile I (I >= 1, a 32 -> 32 3x3 conv), mt0, mt0 + kWarps, ...,
// through one pass of the taps: a tap's weight fragments are loaded once
// for all M. Output (r, s) tap (df, dt) reads tile I - 1 (at shared address
// `in`) at (r + dt, stride * s + df + kInS0).
template <int L, int I, int M>
__device__ __forceinline__ void conv_group(unsigned char* smem, uint32_t s0, const Lane& ln,
                                           uint32_t in, uint32_t res, int mt0, const Item& it) {
  constexpr int kWarps = plan(L).warps;
  using O = TG<L, I>;
  using P = TG<L, I - 1>;
  constexpr int kStride = P::width / O::width;
  constexpr int kInS0 = kStride * O::off - 1 - P::off;
  static_assert(P::halo == O::halo + 1, "a 3x3 conv needs one more frame each side");
  static_assert(plan(L).f_out / plan(L).fb == 1 || P::scale == kStride * O::scale, "");
  static_assert(kStride * O::lo + kInS0 >= 0 && kStride * (O::hi - 1) + kInS0 + 2 < P::slots,
                "the conv reads past its input tile");
  const uint32_t w_lane = s0 + O::w_at + ln.lrow * kWRowB + ln.lcol * 2;
  uint32_t a_at[M];
  float acc[M][4][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    int p = (mt0 + m * kWarps) * 16 + ln.lrow;
    p = p < O::np ? p : O::np - 1;
    const int r = p % O::rows, s = O::lo + p / O::rows;
    a_at[m] = in + r * P::rowB + (kStride * s + kInS0) * kC * 2 + ln.lcol * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  }
#pragma unroll
  for (int df = 0; df < 3; ++df) {
#pragma unroll
    for (int dt = 0; dt < 3; ++dt) {
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        uint32_t bw[4][2];
        load_b(bw, w_lane + ((df * 3 + dt) * kC + kc * 16) * kWRowB);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          uint32_t af[4];
          ldsm_x4(af, a_at[m] + dt * P::rowB + df * kC * 2 + kc * 32);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma16816(acc[m][j], af, bw[j][0], bw[j][1]);
        }
      }
    }
  }
  const LaneAff<L, I> aff(smem, ln);
#pragma unroll
  for (int m = 0; m < M; ++m)
    epilogue<L, I>(smem, s0, ln, aff, acc[m], mt0 + m * kWarps, res, it);
}

// N m-tiles of tile I for this warp, mt0, mt0 + kWarps, ..., in groups of
// at most kMG
template <int L, int I, int N>
__device__ __forceinline__ void conv_warp(unsigned char* smem, uint32_t s0, const Lane& ln,
                                          uint32_t in, uint32_t res, int mt0, const Item& it) {
  constexpr int kWarps = plan(L).warps;
  if constexpr (N > 0) {
    constexpr int M = N < kMG ? N : kMG;
    conv_group<L, I, M>(smem, s0, ln, in, res, mt0, it);
    conv_warp<L, I, N - M>(smem, s0, ln, in, res, mt0 + M * kWarps, it);
  }
}

// Tile I from tile I - 1: warp w takes m-tiles w, w + kWarps, ...; the
// count of each warp is a compile-time constant, so the tap loop has no
// branch.
template <int L, int I>
__device__ __forceinline__ void conv_tile(unsigned char* smem, uint32_t s0, const Lane& ln,
                                          uint32_t in, uint32_t res, const Item& it) {
  constexpr int kWarps = plan(L).warps;
  using O = TG<L, I>;
  constexpr int kFull = O::nmt / kWarps, kRem = O::nmt % kWarps;
  if constexpr (kRem > 0) {
    if (ln.warp < kRem) {
      conv_warp<L, I, kFull + 1>(smem, s0, ln, in, res, ln.warp, it);
      return;
    }
  }
  conv_warp<L, I, kFull>(smem, s0, ln, in, res, ln.warp, it);
}

// conv0 (launch A, tile 1) from the fp32 feature tile at `feats`: K = 9
// taps of one channel, padded to one k16 step. Each lane builds its A
// fragment (rows g, g + 8; taps 2q, 2q + 1 and 2q + 8, 2q + 9) from the
// tile, rounded to bf16; `b0` holds conv0's B fragments.
__device__ __forceinline__ void conv0_tile(unsigned char* smem, uint32_t s0, const Lane& ln,
                                           const float* feats, const uint32_t (&b0)[4][2],
                                           const Item& it) {
  constexpr int kWarps = plan(0).warps;
  using O = TG<0, 1>;
  using P = TG<0, 0>;
  constexpr int kRowF = P::rowB / 4;
  constexpr int kInS0 = O::off - 1 - P::off;   // both at 80 bins
  static_assert(P::halo == O::halo + 1 && O::hi - 1 + kInS0 + 2 < P::slots, "");
  const LaneAff<0, 1> aff(smem, ln);
  for (int mt = ln.warp; mt < O::nmt; mt += kWarps) {
    uint32_t a[4];
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      int p = mt * 16 + ln.g + 8 * e2;
      p = p < O::np ? p : O::np - 1;
      const int r = p % O::rows, s = O::lo + p / O::rows;
      // tap k = df * 3 + dt reads (r + dt, s + df + kInS0)
      const float* src = feats + r * kRowF + s + kInS0;
      const int k0 = 2 * ln.q, k1 = 2 * ln.q + 1;
      a[e2] = pack_bf16(src[(k0 % 3) * kRowF + k0 / 3], src[(k1 % 3) * kRowF + k1 / 3]);
      a[2 + e2] = pack_bf16(ln.q == 0 ? src[2 * kRowF + 2] : 0.f, 0.f);   // tap 8
    }
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      mma16816(acc[j], a, b0[j][0], b0[j][1]);
    }
    epilogue<0, 1>(smem, s0, ln, aff, acc, mt, 0, it);
  }
}

// The copies of tile 0 (the launch's input) of item (b, t0, f0) into a
// ring stage: slots [lo, hi), zero-filled outside [0, T) and the layer.
template <int L>
__device__ __forceinline__ void stage_input(const LaunchArgs& a, uint32_t stage, int b, int t0,
                                            int f0) {
  constexpr int kThreads = 32 * plan(L).warps;
  using P = TG<L, 0>;
  if constexpr (P::feats) {
    // 28 bins from 4 (5 f0 - 1): whole 16-byte chunks of 4 bins, each
    // inside [0, 80) or outside
    const float* x = static_cast<const float*>(a.in);
    constexpr int kCh = P::slots / 4;
    for (int v = threadIdx.x; v < P::rows * kCh; v += kThreads) {
      const int ch = v % kCh, r = v / kCh;
      const int t = t0 - P::halo + r, bin = P::scale * f0 + P::off + 4 * ch;
      const bool ok = t >= 0 && t < a.T && bin >= 0 && bin < kF0;
      cp_async16(stage + r * P::rowB + ch * 16,
                 ok ? x + ((size_t)b * a.T + t) * kF0 + bin : x, ok);
    }
  } else {
    const bf16* x = static_cast<const bf16*>(a.in);
    constexpr int S = P::hi - P::lo;
    for (int v = threadIdx.x; v < P::rows * S * 4; v += kThreads) {
      const int qq = v & 3, s = P::lo + (v >> 2) % S, r = (v >> 2) / S;
      const int t = t0 - P::halo + r, f = P::scale * f0 + P::off + s;
      const bool ok = t >= 0 && t < a.T && f >= 0 && f < P::width;
      cp_async16(stage + r * P::rowB + s * kC * 2 + qq * 16,
                 ok ? x + (((size_t)b * a.T + t) * P::width + f) * kC + qq * 8 : x, ok);
    }
  }
}

// zero the slots outside [lo, hi) of tile I (never written afterwards)
template <int L, int I>
__device__ __forceinline__ void zero_pads(unsigned char* tile) {
  using O = TG<L, I>;
  if constexpr (!O::feats && (O::lo != 0 || O::hi != O::slots)) {
    constexpr int kThreads = 32 * plan(L).warps;
    constexpr int kPad = O::slots - (O::hi - O::lo);
    for (int v = threadIdx.x; v < O::rows * kPad * 4; v += kThreads) {
      const int qq = v & 3, k = (v >> 2) % kPad, r = (v >> 2) / kPad;
      const int s = k < O::lo ? k : O::hi + (k - O::lo);
      *reinterpret_cast<uint4*>(tile + r * O::rowB + s * kC * 2 + qq * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

// the weights (rows padded to kWRowB) and affines of tile I, once per block
template <int L, int I>
__device__ __forceinline__ void stage_weights(unsigned char* smem, const LaunchArgs& a) {
  constexpr int kThreads = 32 * plan(L).warps;
  using O = TG<L, I>;
  if constexpr (O::conv > 0) {
    constexpr int kRows = w_bytes(O::conv) / kWRowB;
    const uint4* w = reinterpret_cast<const uint4*>(a.w[O::conv]);
    for (int v = threadIdx.x; v < kRows * 4; v += kThreads)
      *reinterpret_cast<uint4*>(smem + O::w_at + (v >> 2) * kWRowB + (v & 3) * 16) =
          __ldg(w + v);
  }
  if constexpr (O::res_conv >= 0) {
    const uint4* w = reinterpret_cast<const uint4*>(a.w[O::res_conv]);
    for (int v = threadIdx.x; v < kC * 4; v += kThreads)
      *reinterpret_cast<uint4*>(smem + O::wsc_at + (v >> 2) * kWRowB + (v & 3) * 16) =
          __ldg(w + v);
  }
  float* aff = reinterpret_cast<float*>(smem + O::aff_at);
  for (int v = threadIdx.x; v < 2 * kC; v += kThreads) {
    aff[v] = a.aff[O::conv * 2 * kC + v];
    if constexpr (O::res_conv >= 0) aff[2 * kC + v] = a.aff[O::res_conv * 2 * kC + v];
  }
}

template <int L, int I>
__device__ __forceinline__ void setup_tiles(unsigned char* smem, const LaunchArgs& a) {
  if constexpr (I < plan(L).n_tiles) {
    using O = TG<L, I>;
    if constexpr (I == 0) {
      for (int k = 0; k < plan(L).stages; ++k) zero_pads<L, 0>(smem + O::at + k * O::bytes);
    } else {
      stage_weights<L, I>(smem, a);
      if constexpr (I + 1 < plan(L).n_tiles) zero_pads<L, I>(smem + O::at);
    }
    setup_tiles<L, I + 1>(smem, a);
  }
}

// tiles I.. of one item, a block barrier between two; `stage`: the ring
// stage that holds tile 0
template <int L, int I>
__device__ __forceinline__ void run_tiles(unsigned char* smem, uint32_t s0, const Lane& ln,
                                          uint32_t stage, const uint32_t (&b0)[4][2],
                                          const Item& it) {
  if constexpr (I < plan(L).n_tiles) {
    using O = TG<L, I>;
    if constexpr (L == 0 && I == 1) {
      conv0_tile(smem, s0, ln, reinterpret_cast<const float*>(smem + (stage - s0)), b0, it);
    } else {
      const uint32_t in = I == 1 ? stage : s0 + TG<L, I - 1>::at;
      const uint32_t res = O::res == 0 ? stage : s0 + TG<L, O::res < 0 ? 0 : O::res>::at;
      conv_tile<L, I>(smem, s0, ln, in, res, it);
    }
    if constexpr (I + 1 < plan(L).n_tiles) {
      __syncthreads();
      run_tiles<L, I + 1>(smem, s0, ln, stage, b0, it);
    }
  }
}

template <int L>
__global__ void __launch_bounds__(32 * plan(L).warps, plan(L).blocks)
    fcm_launch_kernel(const LaunchArgs a) {
  constexpr int kN = plan(L).n_tiles, kTT = plan(L).tt, kFB = plan(L).fb;
  constexpr int kFout = plan(L).f_out, kStages = plan(L).stages;
  using O = TG<L, kN - 1>;
  static_assert(O::halo == 0 && O::scale == 1 && O::off == 0 && O::slots == kFB &&
                    O::width == kFout && kFout % kFB == 0, "");
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const Lane ln;

  setup_tiles<L, 0>(smem, a);
  uint32_t b0[4][2] = {};
  if constexpr (L == 0) {
    // conv0's B fragments: k = tap (rows 9-15 zero), n = 8j + g
    const bf16* w0 = a.w[0];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * j + ln.g, k = 2 * ln.q;
      b0[j][0] = pack_bf16(__bfloat162float(w0[k * kC + n]),
                           __bfloat162float(w0[(k + 1) * kC + n]));
      b0[j][1] = pack_bf16(ln.q == 0 ? __bfloat162float(w0[8 * kC + n]) : 0.f, 0.f);
    }
  }

  const int n_tt = (a.T + kTT - 1) / kTT, n_fb = kFout / kFB;
  const int n_items = a.B * n_tt * n_fb;
  constexpr int kStageB = TG<L, 0>::bytes;
  const uint32_t ring = s0 + TG<L, 0>::at;
  auto decode = [&](int item, int& b, int& t0, int& f0) {
    const int rest = item / n_fb;
    f0 = (item % n_fb) * kFB;
    t0 = (rest % n_tt) * kTT;
    b = rest / n_tt;
  };
  auto item_of = [&](int item) {
    int b, t0, f0;
    decode(item, b, t0, f0);
    return Item{t0, f0, a.T, a.out + (size_t)b * a.T * kFout * kC};
  };
  auto stage = [&](int item, uint32_t at) {
    int b, t0, f0;
    decode(item, b, t0, f0);
    stage_input<L>(a, at, b, t0, f0);
    cp_async_commit();
  };
  if (kStages == 2 && blockIdx.x < n_items) stage(blockIdx.x, ring);

  int slot = 0;   // the ring stage of `item`
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    if constexpr (kStages == 1) {
      __syncthreads();   // every warp is done with the item before's input
      stage(item, ring);
    }
    cp_async_wait_all();   // this thread's copies of `item` have landed
    // everyone's have, every warp is done with the item before (its stage
    // takes the next item) and the setup is visible
    __syncthreads();
    if (kStages == 2 && item + (int)gridDim.x < n_items)
      stage(item + gridDim.x, ring + (slot ^ 1) * kStageB);
    run_tiles<L, 1>(smem, s0, ln, ring + slot * kStageB, b0, item_of(item));
    slot = (slot + 1) % kStages;
  }
  cp_async_wait_all();
}

// The kernel's dynamic shared-memory limit is one setting per device for
// the whole process, as is its occupancy. Each launch's kernel sets the
// limit once per device, under a lock, and asks the occupancy then;
// launches from many threads (a server) find it done.
std::mutex g_setup_mu;

template <int L>
cudaError_t launch_setup(int* blocks_per_sm, int* n_sms) {
  static bool done[kMaxDevices] = {};
  static int bps[kMaxDevices] = {}, sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_setup_mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(fcm_launch_kernel<L>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(L));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps[dev], fcm_launch_kernel<L>,
                                                          32 * plan(L).warps, smem_bytes(L));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  *blocks_per_sm = bps[dev];
  *n_sms = sms[dev];
  return cudaSuccess;
}

template <int L>
cudaError_t launch(const LaunchArgs& a, int grid, cudaStream_t stream) {
  int bps = 0, sms = 0;
  cudaError_t err = launch_setup<L>(&bps, &sms);
  if (err != cudaSuccess) return err;
  if (bps < 1) return cudaErrorInvalidConfiguration;
  // the kernel's item index is an int
  const long long items = (long long)a.B * ((a.T + plan(L).tt - 1) / plan(L).tt) *
                          (plan(L).f_out / plan(L).fb);
  if (grid < 1 || items > 0x7fffffff) return cudaErrorInvalidValue;
  fcm_launch_kernel<L><<<grid, 32 * plan(L).warps, smem_bytes(L), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Workspace, in bf16 elements: the outputs of launches A and B (F = 40)
// and C (F = 20). The wrapper allocates it from this count.
extern "C" long long vpr_fcm_workspace_elems(int B, int T) {
  return (long long)B * T * kC * (40 + 40 + 20);
}

// What the wrapper sizes the persistent grids from: the resident blocks
// per SM of each launch's kernel into out[0..3] and the SM count into
// out[4].
extern "C" int vpr_fcm_occupancy(int* out) {
  cudaError_t err = launch_setup<0>(&out[0], &out[4]);
  if (err == cudaSuccess) err = launch_setup<1>(&out[1], &out[4]);
  if (err == cudaSuccess) err = launch_setup<2>(&out[2], &out[4]);
  if (err == cudaSuccess) err = launch_setup<3>(&out[3], &out[4]);
  return (int)err;
}

// The plan as the kernel was built with it, for the wrapper to check
// against its own: per launch tt, fb, f_out, n_tiles, then per tile conv,
// halo, scale, off, slots, lo, hi, width, res, res_conv. Returns the count
// written (at most `cap`), or -1 if `cap` is too small.
extern "C" int vpr_fcm_plan(int* out, int cap) {
  int n = 0;
  for (int l = 0; l < kLaunches; ++l) {
    const Plan p = plan(l);
    const int head[4] = {p.tt, p.fb, p.f_out, p.n_tiles};
    for (int v : head) {
      if (n >= cap) return -1;
      out[n++] = v;
    }
    for (int i = 0; i < p.n_tiles; ++i) {
      const Tile& t = p.t[i];
      const int row[10] = {t.conv, t.halo, t.scale, t.off, t.slots,
                           t.lo, t.hi, t.width, t.res, t.res_conv};
      for (int v : row) {
        if (n >= cap) return -1;
        out[n++] = v;
      }
    }
  }
  return n;
}

extern "C" int vpr_fcm(FcmParams p, void* stream_) {
  if (p.B <= 0 || p.T <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t per = (size_t)p.B * p.T * kC;   // elements per frequency
  bf16* ya = p.ws;
  bf16* yb = ya + per * 40;
  bf16* yc = yb + per * 40;
  LaunchArgs a{};
  const bf16* w[12] = {p.w0, p.w1, p.w2, p.w3, p.w4, p.w5,
                       p.w6, p.w7, p.w8, p.w9, p.w10, p.w11};
  for (int i = 0; i < 12; ++i) a.w[i] = w[i];
  a.aff = p.aff;
  a.B = p.B;
  a.T = p.T;
  int n_marked = 0;
  auto mark = [&]() {
    return p.events ? cudaEventRecord(p.events[n_marked++], stream) : cudaSuccess;
  };
  cudaError_t err;
#define VPR_TRY(x) do { err = (x); if (err != cudaSuccess) return (int)err; } while (0)
  VPR_TRY(mark());
  a.in = p.x;
  a.out = ya;
  VPR_TRY(launch<0>(a, p.grid[0], stream));
  VPR_TRY(mark());
  a.in = ya;
  a.out = yb;
  VPR_TRY(launch<1>(a, p.grid[1], stream));
  VPR_TRY(mark());
  a.in = yb;
  a.out = yc;
  VPR_TRY(launch<2>(a, p.grid[2], stream));
  VPR_TRY(mark());
  a.in = yc;
  a.out = p.out;
  VPR_TRY(launch<3>(a, p.grid[3], stream));
  VPR_TRY(mark());
#undef VPR_TRY
  return (int)cudaSuccess;
}
