// Warpgroup (wgmma) flash-attention tile shared by the paged prefill
// kernels (prefill_attention.cu: B2 over a bf16 cache, B4b over an int8 one)
// and the ragged prefill kernels (ragged_prefill_attention.cu: B3 and B4c).
// See those files for the designs.  Every piece is a template over A, the
// type of q, the fresh K/V, a float cache and out: __nv_bfloat16, or __half
// for the fp16 bodies (the same tile, descriptors and swizzles: both are
// 2-byte types; the products run as wgmma .f16 in place of .bf16, int8
// prefix rows convert exactly to A, and P is rounded to A).
//
// A block holds 128 query rows, (token, query head of the KV head's group)
// pairs, in two consumer warpgroups of 64 rows, plus one producer
// warpgroup:
//   - the consumers load Q once (cp.async, 128-byte swizzled K-major
//     panels of 64 head dims);
//   - the producer (registers handed to the consumers with setmaxnreg)
//     streams K/V tiles of kKeys keys through a ring of kStages stages with
//     16-byte cp.async.  Dead keys are zero-filled instead of read, so NaN
//     in the pool or in padding K/V never reaches shared memory.  Float rows
//     arrive on the stage's `full` mbarrier by themselves as they land
//     (cp.async.mbarrier.arrive), so the producer never waits on its own
//     loads.  int8 rows (and their f32 scales, zero for dead slots) land in
//     a staging ring first; the producer converts each tile to A into the
//     swizzled tile while the next two tiles' copies fly.  Consumers free a
//     stage on its `empty` mbarrier;
//   - S = Q K^T runs as wgmma m64n{kKeys}k16 with K as K-major B and Q from
//     registers (up to D = 128; from shared memory at D = 256); the online
//     softmax stays in registers in base 2 (the softmax scale folded into
//     log2 e); an int8 tile's K scale multiplies its score column before the
//     softcap; P is rounded to A in registers (times the V scale for an
//     int8 tile; the row sums take P unscaled) and is the register A operand
//     of O += P V, wgmma m64n{D}k16 with V as MN-major B;
//   - the two products of neighbouring tiles overlap: tile i's S is issued
//     with tile i - 1's P V, and tile i's softmax runs while that P V
//     finishes (one S and one P register set).
//
// What a block computes is its schedule (Sched), an object both roles hold
// and walk in the same order:
//   n_tiles, tile(it)          the K/V tiles: a prefix tile of one row's
//                              cached positions, or a tile of fresh keys;
//   head, fresh_base,          the KV head, the element offset of the
//   fresh_live(key)            block's fresh K/V, and which fresh keys live;
//   active(it, t, wgi)         whether consumer warpgroup wgi computes tile
//                              it (else it only waits on it and frees it);
//   masked(it, t, wgi)         whether it must mask the tile (only tiles
//                              that cross a row's start, the diagonal or a
//                              row boundary do);
//   thread_row(r)              which keys block row r sees: a prefix tile
//                              of its own row below that row's start, and
//                              fresh keys lo .. tok;
//   row_offset(r), row_live(r) where row r's query and output lie (-1: no
//                              row), and whether it is stored as computed
//                              or as 0;
//   kPrefill, n_active(wgi)    (compile time) the paged prefill walk, in
//                              place of active(): every block row belongs
//                              to one row, and each warpgroup computes
//                              exactly the first n_active(wgi) tiles.  The consumer then runs
//                              one counted loop with the row's own masks
//                              (start, diagonal), and addresses the Q and
//                              output rows from the block's row, tokens and
//                              S directly (row_offset without a sentinel,
//                              no row_live): through the general
//                              row_offset / row_live, B2 ran 4% slower
//                              (PERF.md §6).
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {

// Launch geometry from launch_geometry.cuh, which the wrappers' planners read.
namespace wg {
constexpr int kRows = DYN_B2_ROWS;        // query rows per block
constexpr int kThreads = DYN_B2_THREADS;  // two consumer warpgroups, then one producer warpgroup
constexpr int kStages = DYN_B2_STAGES;
static_assert(kRows == 128 && kThreads == 384, "the warpgroup roles and row mappings below are written for these");

template <int D>
struct Geometry {
  static constexpr int kKeys =                        // keys per K/V tile
      D == 64 ? DYN_B2_KEYS_D64 : D == 128 ? DYN_B2_KEYS_D128 : DYN_B2_KEYS_D256;
  static constexpr bool kQRegs = D <= 128;            // Q held in registers as the A operand
  static constexpr int kPanels = D / 64;              // 64-wide head-dim panels
  static constexpr int kQPanel = kRows * 128;         // bytes of one Q panel
  static constexpr int kKvPanel = kKeys * 128;        // bytes of one K or V panel
  static constexpr int kTile = kPanels * kKvPanel;    // bytes of K (or V) of one tile
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kRing = kStages * 2 * kTile;   // bytes of the K/V ring (2-byte values)
  static constexpr int kStage8 = 2 * kKeys * D;       // bytes of one tile's int8 K and V rows
  static constexpr int kStage8Ring = kStages * kStage8;  // an int8 cache's staging slots
  static constexpr int kScaleBytes = 2 * kStages * 2 * kKeys * 4;  // f32 K and V scales: tiles, then staging
  // the paged prefill kernel's dynamic shared memory: alignment, Q, the ring, 2 x kStages mbarriers
  static constexpr size_t kSmem = D == 64 ? DYN_B2_SMEM_D64 : D == 128 ? DYN_B2_SMEM_D128 : DYN_B2_SMEM_D256;
  static_assert(1024 + kQBytes + (size_t)kRing + 2 * kStages * sizeof(uint64_t) == kSmem,
                "DYN_B2_SMEM_D* must be the shared memory this layout takes");
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64, 128 and 256");
  static_assert(kKeys == 32 || kKeys == 64, "the S product is wgmma m64n32 or m64n64");
};

// setmaxnreg split of the kernels over an int8 cache (B4b, B4c), 128 x
// producer + 256 x consumer <= 384 x 168: the producer converts, the D = 256
// consumer holds 128 accumulators.  Chosen for B4c from a same-call sweep of
// six splits.
template <int D>
struct Q8Regs {
  static constexpr int kProducer = D == 64 ? 72 : D == 128 ? 80 : 64;
  static constexpr int kConsumer = D == 256 ? 216 : 208;
  static_assert(128 * kProducer + 256 * kConsumer <= 384 * 168, "registers the block does not hold");
};

// Byte offset of 16-byte chunk `part` (of D / 8) of row `row` in a
// panelled SW128 tile whose panels hold `panel_bytes`.
__device__ __forceinline__ int sw_off(int row, int part, int panel_bytes) {
  return (part >> 3) * panel_bytes + row * 128 + (((part & 7) ^ (row & 7)) << 4);
}
}  // namespace wg

// One K/V tile of a block's schedule.
struct KvTile {
  int t0;     // first key: a cache position (prefix tile) or a fresh-key index
  int row;    // prefix tile: the row whose cached prefix it reads; -1: fresh keys
  int start;  // prefix tile: that row's start, the first dead position
  int entry;  // prefix tile: the schedule's own index of that row
};

// Which keys one block row sees: prefix tiles of row `own` (-1: none), and
// the fresh keys lo .. tok.
struct ThreadRow {
  int own, lo, tok;
};

// Producer warpgroup over a float cache of A: thread `pl` copies the fixed
// 16-byte column `part` of every (128 / kParts)-th key row of each tile,
// K and V.
template <int D, class A, class Sched>
__device__ __forceinline__ void produce(const Sched& sched, uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        const A* __restrict__ k_new, const A* __restrict__ v_new,
                                        const A* __restrict__ cache,
                                        const int* __restrict__ block_tables, int Hk, int N, int Bs, int M,
                                        int layer, int pl) {
  using namespace hopper;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys, kParts = D / 8, kRowStep = 128 / kParts, kIters = kKeys / kRowStep;
  const int part = pl % kParts, row0 = pl / kParts, hkd = Hk * D;
  const size_t col = (size_t)sched.head * D + part * 8;
  const A* fresh_k = k_new + sched.fresh_base + col;
  const A* fresh_v = v_new + sched.fresh_base + col;
  for (int it = 0; it < sched.n_tiles; ++it) {
    const int s = it % wg::kStages;
    mbar_wait(&empty[s], ((it / wg::kStages) & 1) ^ 1);
    uint8_t* ks = ring + s * 2 * G::kTile;
    const KvTile t = sched.tile(it);
    const int* table = block_tables + (size_t)max(t.row, 0) * M;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int j = row0 + i * kRowStep, pos = t.t0 + j;
      const A* kr = k_new;
      const A* vr = k_new;
      bool live;
      if (t.row >= 0) {
        live = pos < t.start;
        if (live) {
          const int bid = min(max(table[min(pos / Bs, M - 1)], 0), N - 1);
          kr = cache + ((((size_t)layer * N + bid) * 2) * Bs + pos % Bs) * hkd + col;
          vr = kr + (size_t)Bs * hkd;  // a block's V follows its K
        }
      } else {
        live = sched.fresh_live(pos);
        if (live) {
          kr = fresh_k + (size_t)pos * hkd;
          vr = fresh_v + (size_t)pos * hkd;
        }
      }
      const int dst = wg::sw_off(j, part, G::kKvPanel);
      cp_async_16(smem_u32(ks + dst), kr, live ? 16 : 0);
      cp_async_16(smem_u32(ks + G::kTile + dst), vr, live ? 16 : 0);
    }
    cp_async_mbar_arrive(&full[s]);
  }
  cp_async_wait<0>();
}

// Producer warpgroup over an int8 cache (payload [L, N, 2, Bs, Hk*D], f32
// scales [L, N, 2, Hp, Sp]).  A prefix tile's int8 rows and its K and V
// scales (zero for dead slots) land in the stage's staging slot (thread
// `pl` copies the 16-byte column `part8` of every (128 / kParts8)-th key
// row); the same thread then converts exactly the bytes it copied into the
// swizzled tile of A and moves its scale beside the tile (`scales` holds
// kStages slots beside the tiles, then kStages staging slots), so it waits
// only on its own copies.  Tile
// it's copies are issued before tile it - 2 is converted.  Fresh tiles are
// of A and copied as produce() does.
template <int D, class A, class Sched>
__device__ __forceinline__ void produce_q8(const Sched& sched, uint8_t* ring, int8_t* stage8, float* scales,
                                           uint64_t* full, uint64_t* empty, const A* __restrict__ k_new,
                                           const A* __restrict__ v_new,
                                           const int8_t* __restrict__ cache, const float* __restrict__ scale,
                                           const int* __restrict__ block_tables, int Hk, int N, int Bs, int M,
                                           int layer, int Hp, int Sp, int pl) {
  using namespace hopper;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys;
  constexpr int kParts = D / 8, kRowStep = 128 / kParts, kIters = kKeys / kRowStep;          // rows of A
  constexpr int kParts8 = D / 16, kRowStep8 = 128 / kParts8, kIters8 = kKeys / kRowStep8;  // int8 rows
  static_assert(2 * kKeys <= 128, "one scale per producer thread");
  const int hkd = Hk * D, head = sched.head;
  const int part = pl % kParts, row0 = pl / kParts;
  const int part8 = pl % kParts8, row08 = pl / kParts8;
  float* staged_scales = scales + wg::kStages * 2 * kKeys;  // the copies' landing slots
  const size_t col = (size_t)head * D + part * 8;
  const A* fresh_k = k_new + sched.fresh_base + col;
  const A* fresh_v = v_new + sched.fresh_base + col;

  // a prefix tile's int8 rows and scales into its staging slot
  auto issue_prefix = [&](int it, const KvTile& t) {
    const int s = it % wg::kStages;
    int8_t* st8 = stage8 + s * G::kStage8;
    const int* table = block_tables + (size_t)t.row * M;
#pragma unroll
    for (int i = 0; i < kIters8; ++i) {
      const int j = row08 + i * kRowStep8, pos = t.t0 + j;
      const bool live = pos < t.start;
      const int8_t* kr = cache;
      if (live) {
        const int bid = min(max(table[min(pos / Bs, M - 1)], 0), N - 1);
        kr = cache + ((((size_t)layer * N + bid) * 2) * Bs + pos % Bs) * hkd + (size_t)head * D + part8 * 16;
      }
      const uint32_t dst = smem_u32(st8 + j * D + part8 * 16);
      cp_async_16(dst, kr, live ? 16 : 0);
      cp_async_16(dst + kKeys * D, live ? kr + (size_t)Bs * hkd : cache, live ? 16 : 0);
    }
    if (pl < 2 * kKeys) {  // scale of key j, K (pl < kKeys) or V
      const int j = pl % kKeys, kv = pl / kKeys, pos = t.t0 + j;
      const bool live = pos < t.start;
      const float* src = scale;
      if (live) {
        const int bid = min(max(table[min(pos / Bs, M - 1)], 0), N - 1);
        src = scale + ((((size_t)layer * N + bid) * 2 + kv) * Hp + head) * Sp + pos % Bs;
      }
      cp_async_4(smem_u32(staged_scales + s * 2 * kKeys + pl), src, live ? 4 : 0);
    }
    cp_async_commit();
  };
  // a prefix tile whose copies by this thread have landed: once its stage
  // is free, its rows as A into the swizzled tile
  auto convert = [&](int it) {
    const int s = it % wg::kStages;
    mbar_wait(&empty[s], ((it / wg::kStages) & 1) ^ 1);
    const int8_t* st8 = stage8 + s * G::kStage8;
    uint8_t* ks = ring + s * 2 * G::kTile;
#pragma unroll
    for (int i = 0; i < kIters8; ++i) {
      const int j = row08 + i * kRowStep8;
#pragma unroll
      for (int kv = 0; kv < 2; ++kv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(st8 + kv * kKeys * D + j * D + part8 * 16);
        const uint4 lo = make_uint4(
            i8x2_to_x2<A>(__byte_perm(raw.x, 0, 0x4140)), i8x2_to_x2<A>(__byte_perm(raw.x, 0, 0x4342)),
            i8x2_to_x2<A>(__byte_perm(raw.y, 0, 0x4140)), i8x2_to_x2<A>(__byte_perm(raw.y, 0, 0x4342)));
        const uint4 hi = make_uint4(
            i8x2_to_x2<A>(__byte_perm(raw.z, 0, 0x4140)), i8x2_to_x2<A>(__byte_perm(raw.z, 0, 0x4342)),
            i8x2_to_x2<A>(__byte_perm(raw.w, 0, 0x4140)), i8x2_to_x2<A>(__byte_perm(raw.w, 0, 0x4342)));
        uint8_t* dst = ks + kv * G::kTile;
        *reinterpret_cast<uint4*>(dst + wg::sw_off(j, 2 * part8, G::kKvPanel)) = lo;
        *reinterpret_cast<uint4*>(dst + wg::sw_off(j, 2 * part8 + 1, G::kKvPanel)) = hi;
      }
    }
    // the scales move beside the tile only now: the staging slot is
    // refilled before the consumers are done with this stage
    if (pl < 2 * kKeys) scales[s * 2 * kKeys + pl] = staged_scales[s * 2 * kKeys + pl];
    fence_async_smem();  // the tile is read by wgmma (the async proxy)
    mbar_arrive(&full[s]);
  };

  // Prefix tiles are converted kLag behind their copies, so kLag tiles'
  // loads fly while one converts; the staging slot of tile it is free once
  // tile it - kStages is converted.  A conversion waits for its stage: a
  // consumer frees tile j after waiting for tile j + 1, which by then is
  // converted.  A fresh tile copies straight into its stage once every
  // earlier tile is converted (its stage needs tile it - kStages freed),
  // and arrives as its copies land.
  constexpr int kLag = wg::kStages - 1;
  const int n = sched.n_tiles;
  int conv = 0;  // the next tile to convert
  for (int it = 0; it < n; ++it) {
    const KvTile t = sched.tile(it);
    if (t.row >= 0) {
      issue_prefix(it, t);
      if (it - conv >= kLag) {
        cp_async_wait<kLag>();
        convert(conv++);
      }
      continue;
    }
    cp_async_wait<0>();
    for (; conv < it; ++conv) convert(conv);
    conv = it + 1;
    const int s = it % wg::kStages;
    mbar_wait(&empty[s], ((it / wg::kStages) & 1) ^ 1);
    uint8_t* ks = ring + s * 2 * G::kTile;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int j = row0 + i * kRowStep, pos = t.t0 + j;
      const bool live = sched.fresh_live(pos);
      const int dst = wg::sw_off(j, part, G::kKvPanel);
      cp_async_16(smem_u32(ks + dst), live ? fresh_k + (size_t)pos * hkd : k_new, live ? 16 : 0);
      cp_async_16(smem_u32(ks + G::kTile + dst), live ? fresh_v + (size_t)pos * hkd : k_new, live ? 16 : 0);
    }
    cp_async_mbar_arrive(&full[s]);
  }
  cp_async_wait<0>();
  for (; conv < n; ++conv) convert(conv);
}

// Consumer warpgroups: Q once, then every K/V tile of the schedule in
// order, computing the active ones; thread rows ra and ra + 8 of the block.
// Returns the unnormalised output rows `o`, their softmax sums `l` (summed
// over the quad) and running maxima `m` (base 2).  kScaled: prefix tiles
// are int8, with their K and V scales at `scales` (2 * kKeys floats per
// stage).  Q, K, V and P are of A.
template <int D, class A, bool kScaled, class Sched>
__device__ __forceinline__ void consume(const Sched& sched, uint8_t* qs, uint8_t* ring, const float* scales,
                                        uint64_t* full, uint64_t* empty, const A* __restrict__ q,
                                        float sm_scale, float logit_cap, float (&o)[D / 2], float (&l)[2],
                                        float (&m)[2]) {
  using namespace hopper;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys, kParts = D / 8;
  const int tid = threadIdx.x, wgi = tid >> 7, t4 = tid & 3;
  const int ra = wgi * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);

  for (int c = tid; c < wg::kRows * kParts; c += 256) {
    const int r = c / kParts, part = c % kParts;
    if constexpr (Sched::kPrefill) {  // rows past S are 0
      const int tok = sched.i0 + r / sched.group;
      const bool live = r < sched.rows && tok < sched.S;
      const A* src = q + sched.row_offset(r) + part * 8;
      cp_async_16(smem_u32(qs + wg::sw_off(r, part, G::kQPanel)), live ? src : q, live ? 16 : 0);
    } else {
      const long off = sched.row_offset(r);
      const bool live = off >= 0 && sched.row_live(r);
      cp_async_16(smem_u32(qs + wg::sw_off(r, part, G::kQPanel)), live ? q + off + part * 8 : q, live ? 16 : 0);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();
  named_sync(1, 256);

  // Up to D = 128, Q stays in registers as the A operand of S = Q K^T (the
  // m16n8k16 A fragment of each warp's 16 rows, per 16-wide head-dim slice),
  // so the products read only K and V from shared memory.
  uint32_t qf[G::kQRegs ? D / 16 : 1][4];
  if constexpr (G::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = 2 * (kk & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h;
        const uint8_t* row = qs + (kk >> 2) * G::kQPanel + r * 128 + 4 * t4;
        qf[kk][h] = *reinterpret_cast<const uint32_t*>(row + ((c ^ (r & 7)) << 4));
        qf[kk][2 + h] = *reinterpret_cast<const uint32_t*>(row + (((c + 1) ^ (r & 7)) << 4));
      }
    }
  }
  const ThreadRow tr[2] = {sched.thread_row(ra), sched.thread_row(ra + 8)};

  constexpr float kLog2e = 1.4426950408889634f;
  const bool cap = logit_cap > 0.f;
  const float qk_scale = cap ? sm_scale / logit_cap : sm_scale * kLog2e;
  const float cap_scale = logit_cap * kLog2e;
  m[0] = m[1] = -INFINITY;
  const uint32_t q_base = smem_u32(qs) + wgi * 64 * 128;
  auto k_addr = [&](int it) { return smem_u32(ring + (it % wg::kStages) * 2 * G::kTile); };
  // key column of S register i
  auto key_col = [&](int i) { return 8 * (i >> 2) + 2 * t4 + (i & 1); };

  // S = Q K^T of tile `it` into sc, issued and committed (not waited)
  float sc[kKeys / 2];
  auto scores = [&](int it) {
    mbar_wait(&full[it % wg::kStages], (it / wg::kStages) & 1);
    const uint32_t k_base = k_addr(it);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t panel = kk >> 2, col = (kk & 3) * 32;
      const uint64_t kd = sw128_desc(k_base + panel * G::kKvPanel + col, 16, 1024);
      if constexpr (G::kQRegs)
        Wgmma<kKeys, 0, 0, A>::rs(sc, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], kd, kk > 0 ? 1 : 0);
      else
        Wgmma<kKeys, 0, 0, A>::ss(sc, sw128_desc(q_base + panel * G::kQPanel + col, 16, 1024), kd, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
  };
  // masks, the online softmax in place on sc (probabilities in f32), the
  // row sums; returns the factors the output rows must be rescaled by
  auto softmax = [&](int it, const KvTile& t, bool mask, float (&alpha)[2]) {
    const bool prefix = t.row >= 0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      float s = sc[i];
      if constexpr (kScaled) {
        if (prefix) s *= scales[(it % wg::kStages) * 2 * kKeys + key_col(i)];
      }
      float x = cap ? cap_scale * tanhf(s * qk_scale) : s * qk_scale;
      if (mask) {
        const int key = t.t0 + key_col(i);
        const ThreadRow& w = tr[(i >> 1) & 1];
        bool dead;
        if constexpr (Sched::kPrefill)  // one row: its start, and the diagonal
          dead = prefix ? key >= t.start : key > w.tok;
        else
          dead = prefix ? (w.own != t.row || key >= t.start) : (key < w.lo || key > w.tok);
        if (dead) x = -INFINITY;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row that has seen nothing keeps m = -inf, p = 0 and alpha = 1
      alpha[h] = m_new == -INFINITY ? 1.f : exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int h = (i >> 1) & 1;
      const float p = m[h] == -INFINITY ? 0.f : exp2f(sc[i] - m[h]);
      sc[i] = p;
      sum[h] += p;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
  };
  // P of the last softmax in A (times the V scale on an int8 tile): key
  // slice j is the A fragment {p 8j .. 8j + 7}
  uint32_t pf[kKeys / 16][4];
  auto rescale_and_pack = [&](int it, const KvTile& t, const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    if constexpr (kScaled) {
      if (t.row >= 0) {
        const float* sv = scales + (it % wg::kStages) * 2 * kKeys + kKeys;
#pragma unroll
        for (int i = 0; i < kKeys / 2; ++i) sc[i] *= sv[key_col(i)];
      }
    }
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[j][r] = pack_x2<A>(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
  };
  // O += P V of tile `it`, issued and committed
  auto pv = [&](int it) {
    const uint32_t v_base = k_addr(it) + G::kTile;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      Wgmma<D, 1, 0, A>::rs(o, pf[j][0], pf[j][1], pf[j][2], pf[j][3], sw128_desc(v_base + j * 2048, G::kKvPanel, 1024), 1);
    wgmma_commit();
  };
  auto release = [&](int it) { mbar_arrive(&empty[it % wg::kStages]); };
  auto skip = [&](int it) {  // a tile this warpgroup does not compute
    mbar_wait(&full[it % wg::kStages], (it / wg::kStages) & 1);
    release(it);
  };

  // One run of consecutive active tiles [first, end).  Tile it's S runs on
  // the tensor cores while tile it - 1's P V does, and tile it's softmax
  // while that P V finishes.  The run ends with its last P V done and its
  // stage freed.
  float alpha[2];
  auto run = [&](int first, int end) {
    KvTile t = sched.tile(first);
    scores(first);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(first, t, sched.masked(first, t, wgi), alpha);
    rescale_and_pack(first, t, alpha);
    for (int it = first + 1; it < end; ++it) {
      scores(it);
      pv(it - 1);
      wgmma_wait<1>();  // S of tile it is done
      reg_fence(sc);
      t = sched.tile(it);
      softmax(it, t, sched.masked(it, t, wgi), alpha);
      wgmma_wait<0>();  // P V of tile it - 1 is done: its stage, o and pf are free
      reg_fence(o);
      reg_fence(pf);
      release(it - 1);
      rescale_and_pack(it, t, alpha);
    }
    pv(end - 1);
    wgmma_wait<0>();
    reg_fence(o);
    reg_fence(pf);
    release(end - 1);
  };

  const int n = sched.n_tiles;
  if constexpr (Sched::kPrefill) {
    const int n_act = sched.n_active(wgi);
    if (n_act > 0) run(0, n_act);
    for (int it = n_act; it < n; ++it) skip(it);
  } else {
    // The active tiles come in runs.  A run ends before the tiles up to the
    // next one are waited on and freed (their stages may need the run's).
    // Each run's length is found first, so its loop is counted.
    auto next_active = [&](int from) {  // the first active tile at or after `from` (n if none)
      int j = from;
      while (j < n && !sched.active(j, sched.tile(j), wgi)) ++j;
      return j;
    };
    int done = 0;  // the tiles this warpgroup has freed
    for (int first = next_active(0); first < n; first = next_active(done)) {
      int end = first + 1;
      while (end < n && sched.active(end, sched.tile(end), wgi)) ++end;
      for (; done < first; ++done) skip(done);
      run(first, end);
      done = end;
    }
    for (; done < n; ++done) skip(done);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// Store consumer thread rows ra and ra + 8: live rows o / l, other rows
// that have an output row (and every row when `o` is all zeros and l = 0)
// exactly 0, rounded to A.
template <int D, class A, class Sched>
__device__ __forceinline__ void store_rows(const Sched& sched, A* __restrict__ out,
                                           const float (&o)[D / 2], const float (&l)[2]) {
  const int tid = threadIdx.x, wgi = tid >> 7, t4 = tid & 3;
  const int ra = wgi * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    A* dst;
    bool live;
    if constexpr (Sched::kPrefill) {
      const int tok = sched.i0 + r / sched.group;
      if (r >= sched.rows || tok >= sched.S) continue;
      dst = out + sched.row_offset(r) + 2 * t4;
      live = tok < sched.fresh;
    } else {
      const long off = sched.row_offset(r);
      if (off < 0) continue;
      dst = out + off + 2 * t4;
      live = sched.row_live(r);
    }
    const float inv = 1.f / fmaxf(l[h], 1e-9f);
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int e = i + 2 * h;  // the pair (e, e + 1): columns 8 (i / 4) + 2 t4 + {0, 1}
      *reinterpret_cast<uint32_t*>(dst + 8 * (i >> 2)) =
          hopper::pack_x2<A>(live ? o[e] * inv : 0.f, live ? o[e + 1] * inv : 0.f);
    }
  }
}

// The paged prefill kernels' schedule: block (KV head, row b, query tile
// z) holds tokens i0 .. i0 + TQ - 1 of row b; its tiles are the row's
// cached prefix [0, start), then its fresh keys up to the block's last live
// token.
template <int D>
struct PrefillSched {
  static constexpr bool kPrefill = true;
  static constexpr int kKeys = wg::Geometry<D>::kKeys;
  int b, head, i0, group, rows, start, fresh, key_end, n_pre, n_tiles, S, H;
  int tok_lo[2], tok_hi[2];  // each warpgroup's live tokens (none when tok_hi < tok_lo)
  size_t fresh_base;

  __device__ KvTile tile(int it) const {
    return it < n_pre ? KvTile{it * kKeys, b, start, 0} : KvTile{(it - n_pre) * kKeys, -1, 0, 0};
  }
  __device__ bool fresh_live(int key) const { return key < key_end; }
  __device__ void set_warpgroups() {
    for (int w = 0; w < 2; ++w) {
      tok_lo[w] = i0 + w * 64 / group;
      tok_hi[w] = w * 64 > rows - 1 ? -1 : min(i0 + min(w * 64 + 63, rows - 1) / group, fresh - 1);
    }
  }
  // every prefix tile, and the fresh tiles that start at or before the
  // warpgroup's last live token: the first n_active(wgi) tiles
  __device__ int n_active(int wgi) const {
    const int lo = wgi ? tok_lo[1] : tok_lo[0], hi = wgi ? tok_hi[1] : tok_hi[0];
    return hi < lo ? 0 : n_pre + min(n_tiles - n_pre, hi / kKeys + 1);
  }
  __device__ bool masked(int, const KvTile& t, int wgi) const {
    return t.row >= 0 ? t.t0 + kKeys > start : t.t0 + kKeys - 1 > (wgi ? tok_lo[1] : tok_lo[0]);
  }
  __device__ ThreadRow thread_row(int r) const { return ThreadRow{b, 0, i0 + r / group}; }
  // block row r's query and output, for r < rows and a token below S
  __device__ size_t row_offset(int r) const {
    return (((size_t)b * S + i0 + r / group) * H + (size_t)head * group + r % group) * D;
  }
};

// The paged prefill kernels' dynamic shared memory: alignment, Q, the ring,
// over an int8 cache its staging slots and scales, then 2 x kStages mbarriers.
template <int D, bool kQuant>
struct PrefillSmem {
  using G = wg::Geometry<D>;
  static constexpr size_t kBytes =
      kQuant ? (D == 64 ? DYN_B2_Q8_SMEM_D64 : D == 128 ? DYN_B2_Q8_SMEM_D128 : DYN_B2_Q8_SMEM_D256) : G::kSmem;
  static_assert(1024 + (size_t)G::kQBytes + G::kRing + (kQuant ? G::kStage8Ring + G::kScaleBytes : 0) +
                        2 * wg::kStages * sizeof(uint64_t) == kBytes,
                "DYN_B2_*SMEM_D* must be the shared memory this layout takes");
};

// E is the cache's element type: A (B2), or int8_t (B4b) with `scale` the
// int8 cache's scale pool [L, N, 2, Hp, Sp] (unused for a float cache); A
// is the type of q, the fresh K/V and out: __nv_bfloat16, or __half.
template <int D, class E, class A>
__global__ void __launch_bounds__(wg::kThreads, 1)
wgmma_prefill_kernel(const A* __restrict__ q, const A* __restrict__ k_new, const A* __restrict__ v_new,
                     const E* __restrict__ cache, const float* __restrict__ scale,
                     const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                     const int* __restrict__ starts, A* __restrict__ out,
                     int S, int H, int Hk, int N, int Bs, int M, int layer, int Hp, int Sp, int TQ, float sm_scale,
                     float logit_cap) {
  using namespace hopper;
  constexpr bool kQuant = std::is_same<E, int8_t>::value;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys;
  // setmaxnreg: a float cache 128 x 40 + 256 x 232 <= 384 x 168; int8 as B4c
  constexpr int kProducerRegs = kQuant ? wg::Q8Regs<D>::kProducer : 40;
  constexpr int kConsumerRegs = kQuant ? wg::Q8Regs<D>::kConsumer : 232;

  PrefillSched<D> ps;
  ps.head = blockIdx.x;
  ps.b = blockIdx.y;
  ps.i0 = (gridDim.z - 1 - blockIdx.z) * TQ;  // the longest causal tiles launch first
  ps.group = H / Hk;
  ps.rows = TQ * ps.group;
  ps.start = starts[ps.b];
  ps.fresh = seq_lens[ps.b] - ps.start;
  ps.S = S;
  ps.H = H;
  ps.fresh_base = (size_t)ps.b * S * Hk * D;
  const int tid = threadIdx.x;

  if (ps.i0 >= ps.fresh) {  // only padding rows: zeros, nothing to read
    if (tid < 256) {
      const float zo[D / 2] = {}, zl[2] = {};
      store_rows<D, A>(ps, out, zo, zl);
    }
    return;
  }
  ps.key_end = min(ps.fresh, ps.i0 + TQ);  // fresh keys any live row of the block sees
  ps.n_pre = (ps.start + kKeys - 1) / kKeys;
  ps.n_tiles = ps.n_pre + (ps.key_end + kKeys - 1) / kKeys;
  ps.set_warpgroups();

  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ring = smem + G::kQBytes;
  int8_t* stage8 = reinterpret_cast<int8_t*>(ring + G::kRing);
  float* scales = reinterpret_cast<float*>(ring + G::kRing + (kQuant ? G::kStage8Ring : 0));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + G::kRing + (kQuant ? G::kStage8Ring + G::kScaleBytes : 0));
  uint64_t* empty = full + wg::kStages;
  if (tid == 0) {
    for (int s = 0; s < wg::kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    regs_dealloc<kProducerRegs>();
    if constexpr (kQuant)
      produce_q8<D, A>(ps, ring, stage8, scales, full, empty, k_new, v_new, cache, scale, block_tables, Hk, N, Bs, M,
                    layer, Hp, Sp, tid - 256);
    else
      produce<D, A>(ps, ring, full, empty, k_new, v_new, cache, block_tables, Hk, N, Bs, M, layer, tid - 256);
  } else {
    regs_alloc<kConsumerRegs>();
    float o[D / 2], l[2] = {0.f, 0.f}, m[2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    consume<D, A, kQuant>(ps, qs, ring, scales, full, empty, q, sm_scale, logit_cap, o, l, m);
    store_rows<D, A>(ps, out, o, l);
  }
}

}  // namespace
}  // namespace dynamo
