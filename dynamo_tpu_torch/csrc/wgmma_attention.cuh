// Warpgroup (wgmma) flash-attention tile for the bf16 paged prefill kernel
// (prefill_attention.cu, dynamo_prefill_attention).  See that file for the
// design; the int8 and ragged kernels still use mma_attention.cuh.
//
// A block holds 128 query rows, (token, query head of the KV head's group)
// pairs, in two consumer warpgroups of 64 rows, plus one producer warp:
//   - the consumers load Q once (cp.async, 128-byte swizzled K-major
//     panels of 64 head dims);
//   - a producer warpgroup (registers handed to the consumers with
//     setmaxnreg) streams K/V tiles of kKeys keys through a ring of kStages
//     stages with 16-byte cp.async.  Dead keys (at or past `start` in the
//     prefix, past the block's last live token in the fresh chunk) are
//     zero-filled instead of read, so NaN in the pool or in padding K/V
//     never reaches shared memory.  The copies arrive on the stage's `full`
//     mbarrier by themselves as they land (cp.async.mbarrier.arrive), so the
//     producer never waits on its own loads; consumers free a stage on its
//     `empty` mbarrier;
//   - S = Q K^T runs as wgmma m64n{kKeys}k16 with K as K-major B and Q from
//     registers (up to D = 128; from shared memory at D = 256); the online
//     softmax stays in registers in base 2 (the softmax scale folded into
//     log2 e); masks are applied only on tiles that cross `start` or the
//     causal diagonal; P is rounded to bf16 in registers and is the register
//     A operand of O += P V, wgmma m64n{D}k16 with V as MN-major B;
//   - the two products of neighbouring tiles overlap: tile i's S is issued
//     with tile i - 1's P V, and tile i's softmax runs while that P V
//     finishes (one S and one P register set).
#pragma once

#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {

// Launch geometry from launch_geometry.cuh, which the wrapper's planner reads.
namespace wg {
constexpr int kRows = DYN_B2_ROWS;        // query rows per block
constexpr int kThreads = DYN_B2_THREADS;  // two consumer warpgroups, then one producer warpgroup
constexpr int kStages = DYN_B2_STAGES;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232 <= 65536
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
  static constexpr size_t kSmem = D == 64 ? DYN_B2_SMEM_D64 : D == 128 ? DYN_B2_SMEM_D128 : DYN_B2_SMEM_D256;
  static_assert(D == 64 || D == 128 || D == 256, "head dims 64, 128 and 256");
  static_assert(kKeys == 32 || kKeys == 64, "the S product is wgmma m64n32 or m64n64");
  static_assert(1024 + kQBytes + (size_t)kStages * 2 * kTile + 2 * kStages * sizeof(uint64_t) == kSmem,
                "DYN_B2_SMEM_D* must be the shared memory this layout takes");
};

// Byte offset of 16-byte chunk `part` (of D / 8) of row `row` in a
// panelled SW128 tile whose panels hold `panel_bytes`.
__device__ __forceinline__ int sw_off(int row, int part, int panel_bytes) {
  return (part >> 3) * panel_bytes + row * 128 + (((part & 7) ^ (row & 7)) << 4);
}
}  // namespace wg

// The scalars both roles read.
struct PrefillBlock {
  int b, head, i0, group, rows, start, fresh, key_end, n_pre, n_tiles;
};

// Producer warpgroup: thread `pl` copies the fixed 16-byte column `part`
// of every (128 / kParts)-th key row of each tile, K and V.
template <int D>
__device__ __forceinline__ void produce(const PrefillBlock& pb, uint8_t* ring, uint64_t* full, uint64_t* empty,
                                        const __nv_bfloat16* __restrict__ k_new,
                                        const __nv_bfloat16* __restrict__ v_new,
                                        const __nv_bfloat16* __restrict__ cache,
                                        const int* __restrict__ block_tables, int S, int Hk, int N, int Bs, int M,
                                        int layer, int pl) {
  using namespace hopper;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys, kParts = D / 8, kRowStep = 128 / kParts, kIters = kKeys / kRowStep;
  const int part = pl % kParts, row0 = pl / kParts, hkd = Hk * D;
  const int* table = block_tables + (size_t)pb.b * M;
  const size_t col = (size_t)pb.head * D + part * 8;
  const __nv_bfloat16* fresh_k = k_new + (size_t)pb.b * S * hkd + col;
  const __nv_bfloat16* fresh_v = v_new + (size_t)pb.b * S * hkd + col;
  for (int it = 0; it < pb.n_tiles; ++it) {
    const int s = it % wg::kStages;
    mbar_wait(&empty[s], ((it / wg::kStages) & 1) ^ 1);
    uint8_t* ks = ring + s * 2 * G::kTile;
    const bool prefix = it < pb.n_pre;
    const int t0 = (prefix ? it : it - pb.n_pre) * kKeys;
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int j = row0 + i * kRowStep, pos = t0 + j;
      const __nv_bfloat16* kr = k_new;
      const __nv_bfloat16* vr = k_new;
      bool live;
      if (prefix) {
        live = pos < pb.start;
        if (live) {
          const int bid = min(max(table[min(pos / Bs, M - 1)], 0), N - 1);
          kr = cache + ((((size_t)layer * N + bid) * 2) * Bs + pos % Bs) * hkd + col;
          vr = kr + (size_t)Bs * hkd;  // a block's V follows its K
        }
      } else {
        live = pos < pb.key_end;
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

// Consumer warpgroups: Q once, then every K/V tile in order; thread rows
// ra and ra + 8 of the block.  Returns the unnormalised output rows `o`
// and their softmax sums `l` (summed over the quad).
template <int D>
__device__ __forceinline__ void consume(const PrefillBlock& pb, uint8_t* qs, uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, const __nv_bfloat16* __restrict__ q, int S, int H,
                                        float sm_scale, float logit_cap, float (&o)[D / 2], float (&l)[2]) {
  using namespace hopper;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys, kParts = D / 8;
  const int tid = threadIdx.x, wgi = tid >> 7, t4 = tid & 3;
  const int ra = wgi * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
  const int group = pb.group;

  for (int c = tid; c < wg::kRows * kParts; c += 256) {
    const int r = c / kParts, part = c % kParts, tok = pb.i0 + r / group;
    const bool live = r < pb.rows && tok < S;
    const __nv_bfloat16* src = q + (((size_t)pb.b * S + tok) * H + (size_t)pb.head * group + r % group) * D + part * 8;
    cp_async_16(smem_u32(qs + wg::sw_off(r, part, G::kQPanel)), live ? src : q, live ? 16 : 0);
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

  // this warpgroup's live token range [tok_lo, tok_hi]; dead when empty
  const int r_hi = min(wgi * 64 + 63, pb.rows - 1);
  const int tok_lo = pb.i0 + wgi * 64 / group, tok_hi = min(pb.i0 + r_hi / group, pb.fresh - 1);
  const bool wg_dead = wgi * 64 > r_hi || tok_lo >= pb.fresh;
  const int tok[2] = {pb.i0 + ra / group, pb.i0 + (ra + 8) / group};

  constexpr float kLog2e = 1.4426950408889634f;
  const bool cap = logit_cap > 0.f;
  const float qk_scale = cap ? sm_scale / logit_cap : sm_scale * kLog2e;
  const float cap_scale = logit_cap * kLog2e;
  float m[2] = {-INFINITY, -INFINITY};
  const uint32_t q_base = smem_u32(qs) + wgi * 64 * 128;

  // Tiles this warpgroup computes: every prefix tile, and the fresh tiles
  // that start at or before its last live token; the rest it only frees.
  const int n_fresh_act = wg_dead ? 0 : min(pb.n_tiles - pb.n_pre, tok_hi / kKeys + 1);
  const int n_act = wg_dead ? 0 : pb.n_pre + n_fresh_act;
  auto tile_t0 = [&](int it) { return (it < pb.n_pre ? it : it - pb.n_pre) * kKeys; };
  auto k_addr = [&](int it) { return smem_u32(ring + (it % wg::kStages) * 2 * G::kTile); };

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
        Wgmma<kKeys, 0>::rs(sc, qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], kd, kk > 0 ? 1 : 0);
      else
        Wgmma<kKeys, 0>::ss(sc, sw128_desc(q_base + panel * G::kQPanel + col, 16, 1024), kd, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
  };
  // masks, the online softmax in place on sc (probabilities in f32), the
  // row sums; returns the factors the output rows must be rescaled by
  auto softmax = [&](int it, float (&alpha)[2]) {
    const bool prefix = it < pb.n_pre;
    const int t0 = tile_t0(it);
    const bool mask = prefix ? t0 + kKeys > pb.start : t0 + kKeys - 1 > tok_lo;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      float x = cap ? cap_scale * tanhf(sc[i] * qk_scale) : sc[i] * qk_scale;
      if (mask) {
        const int key = t0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (prefix ? key >= pb.start : key > tok[(i >> 1) & 1]) x = -INFINITY;
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
  // P of the last softmax in bf16: key slice j is the A fragment {p 8j .. 8j + 7}
  uint32_t pf[kKeys / 16][4];
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) pf[j][r] = pack_bf16x2(sc[8 * j + 2 * r], sc[8 * j + 2 * r + 1]);
  };
  // O += P V of tile `it`, issued and committed
  auto pv = [&](int it) {
    const uint32_t v_base = k_addr(it) + G::kTile;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
      Wgmma<D, 1>::rs(o, pf[j][0], pf[j][1], pf[j][2], pf[j][3], sw128_desc(v_base + j * 2048, G::kKvPanel, 1024), 1);
    wgmma_commit();
  };

  // Tile it's S runs on the tensor cores while tile it - 1's P V does, and
  // tile it's softmax while that P V finishes.
  if (n_act > 0) {
    float alpha[2];
    scores(0);
    wgmma_wait<0>();
    reg_fence(sc);
    softmax(0, alpha);
    rescale_and_pack(alpha);
    for (int it = 1; it < n_act; ++it) {
      scores(it);
      pv(it - 1);
      wgmma_wait<1>();  // S of tile it is done
      reg_fence(sc);
      softmax(it, alpha);
      wgmma_wait<0>();  // P V of tile it - 1 is done: its stage, o and pf are free
      reg_fence(o);
      reg_fence(pf);
      mbar_arrive(&empty[(it - 1) % wg::kStages]);
      rescale_and_pack(alpha);
    }
    pv(n_act - 1);
    wgmma_wait<0>();
    reg_fence(o);
    mbar_arrive(&empty[(n_act - 1) % wg::kStages]);
  }
  for (int it = n_act; it < pb.n_tiles; ++it) {  // tiles past this warpgroup's rows
    mbar_wait(&full[it % wg::kStages], (it / wg::kStages) & 1);
    mbar_arrive(&empty[it % wg::kStages]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
}

// Store consumer thread rows ra and ra + 8: live rows o / l, padding rows
// (and every row when `o` is all zeros and l = 0) exactly 0.
template <int D>
__device__ __forceinline__ void store_rows(const PrefillBlock& pb, __nv_bfloat16* __restrict__ out, int S, int H,
                                           const float (&o)[D / 2], const float (&l)[2]) {
  const int tid = threadIdx.x, wgi = tid >> 7, t4 = tid & 3;
  const int ra = wgi * 64 + ((tid & 127) >> 5) * 16 + ((tid & 31) >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h, tok = pb.i0 + r / pb.group;
    if (r >= pb.rows || tok >= S) continue;
    __nv_bfloat16* dst =
        out + (((size_t)pb.b * S + tok) * H + (size_t)pb.head * pb.group + r % pb.group) * D + 2 * t4;
    const bool live = tok < pb.fresh;
    const float inv = 1.f / fmaxf(l[h], 1e-9f);
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int e = i + 2 * h;  // the pair (e, e + 1): columns 8 (i / 4) + 2 t4 + {0, 1}
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * (i >> 2)) =
          __floats2bfloat162_rn(live ? o[e] * inv : 0.f, live ? o[e + 1] * inv : 0.f);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
wgmma_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
                     const __nv_bfloat16* __restrict__ v_new, const __nv_bfloat16* __restrict__ cache,
                     const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                     const int* __restrict__ starts, __nv_bfloat16* __restrict__ out, int S, int H, int Hk, int N,
                     int Bs, int M, int layer, int TQ, float sm_scale, float logit_cap) {
  using namespace hopper;
  using G = wg::Geometry<D>;
  constexpr int kKeys = G::kKeys;

  PrefillBlock pb;
  pb.head = blockIdx.x;
  pb.b = blockIdx.y;
  pb.i0 = (gridDim.z - 1 - blockIdx.z) * TQ;  // the longest causal tiles launch first
  pb.group = H / Hk;
  pb.rows = TQ * pb.group;
  pb.start = starts[pb.b];
  pb.fresh = seq_lens[pb.b] - pb.start;
  const int tid = threadIdx.x;

  if (pb.i0 >= pb.fresh) {  // only padding rows: zeros, nothing to read
    if (tid < 256) {
      const float zo[D / 2] = {}, zl[2] = {};
      store_rows<D>(pb, out, S, H, zo, zl);
    }
    return;
  }
  pb.key_end = min(pb.fresh, pb.i0 + TQ);  // fresh keys any live row of the block sees
  pb.n_pre = (pb.start + kKeys - 1) / kKeys;
  pb.n_tiles = pb.n_pre + (pb.key_end + kKeys - 1) / kKeys;

  extern __shared__ uint4 smem_raw[];  // the declaration mma_attention.cuh's kernels share
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ring = smem + G::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + wg::kStages * 2 * G::kTile);
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
    regs_dealloc<wg::kProducerRegs>();
    produce<D>(pb, ring, full, empty, k_new, v_new, cache, block_tables, S, Hk, N, Bs, M, layer, tid - 256);
  } else {
    regs_alloc<wg::kConsumerRegs>();
    float o[D / 2], l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    consume<D>(pb, qs, ring, full, empty, q, S, H, sm_scale, logit_cap, o, l);
    store_rows<D>(pb, out, S, H, o, l);
  }
}

}  // namespace
}  // namespace dynamo
