// Grouped expert matrix product for Hopper (sm_90a): the mixture-of-experts
// MLP's three projections, each one launch over every expert.
//
// Replaces the grouped product the JAX package leaves to XLA,
// jax.lax.ragged_dot in dynamo_tpu/models/llama.py, grouped_expert_dispatch
// (E1 over bf16 experts, E2 over int8 experts with per-output-channel
// scales, which the JAX path dequantises at the operand so its weight reads
// stay int8).  It is not a Pallas kernel; eager PyTorch has no counterpart
// that keeps the group sizes on the device.
//
// What it computes.  out[r, :] = xs[r, :] @ W[e(r)], for xs [R, K] bf16
// whose rows are sorted by expert, offsets [E + 1] int32 the device prefix
// sum of the group sizes (rows offsets[e] .. offsets[e + 1] - 1 belong to
// expert e), W [E, K, N] bf16 (E1) or int8 with an f32 scale [E, 1, N]
// applied to the f32 accumulator per output channel (E2, as the W8A16
// kernel int8_matmul.cu does), and out [R, N] bf16, rounded once.
//
// What bounds it on this card.  At decode (Qwen3-30B-A3B: 8 tokens x top-8
// = 64 rows over about 55 of the 128 experts, one or two rows each) the
// weight bytes of the experts the rows route to: about 55 x 2048 x 768 per
// gate or up projection, 86 MB in int8 (26 us at 3.35 TB/s), twice that in
// bf16.  At a 1,504-token prefill (12,032 rows, about 94 per expert) every
// expert is read: 1.21 GB of bf16 per layer's three launches (0.36 ms)
// against 113.5 GFLOP (0.115 ms), so E1 is bytes-bound; E2 reads half the
// bytes (0.18 ms) and sits near the ridge, where the tensor-core rate and
// the int8 -> bf16 convert count too.
//
// Design.
//   - Operands swapped, as in B5: out^T = W^T xs^T on wgmma.  The weight's
//     output channels are the M side (two consumer warpgroups of 64 channels
//     make a 128-channel column tile) and a group's rows the N side: a tile
//     of ROWS = 8 rows at decode (wgmma m64n8k16: a group's one or two rows
//     pad to 8, not to mma.sync's 16 A rows), 32 in between and 128 at
//     prefill, picked by the wrapper from the mean group R / E.  So one work
//     item streams its expert's [K, 128] weight slice once for up to 128
//     rows: at a 1,504-token prefill nearly every expert is one row tile.
//   - E1 reads its weight tile as the A operand straight from shared memory:
//     the [64, 128] tile as it lies in memory (channels contiguous) is
//     MN-major A, two 128-byte-swizzled panels of 64 channels, one per
//     consumer warpgroup.  E2 lands the int8 tile raw (half the bytes) and
//     each consumer thread builds its A fragments from it in registers (2-byte
//     shared loads, the exact integer convert of i8x2_to_bf16x2), as B5's
//     prefill consumers do: no bf16 copy of the weight is written and a
//     stage has no barrier but its two mbarriers.  The x rows are the
//     K-major B operand in the 128-byte swizzle.
//   - One producer thread streams each 64-deep sub-tile with TMA (the
//     weight box of the item's expert, channels and depth, and the x box of
//     its rows; the hardware zero-fills past N, K and R and swizzles as
//     wgmma reads) into a ring of stages of one or two sub-tiles, arriving
//     on the stage's `full` mbarrier with the bytes to expect; a consumer
//     warpgroup frees the stage on its `empty` mbarrier once the wgmma
//     groups that read it have retired.  With per-thread cp.async the copy
//     instructions were a bottleneck: on an H100, one copying warp in place
//     of four ran E1 3.4x slower at decode.
//   - No empty blocks and no host read: a persistent grid of a few blocks
//     per SM (3 for E2 and 2 for E1 at 8 rows, 2 at 32, 1 at 128; fewer if
//     fewer items can exist).  Each block reads the device offsets once
//     into shared memory and one warp scans them into the first row tile of
//     each expert; the block then walks work items blockIdx.x, + gridDim.x,
//     ..., item = (row tile, column tile) with the column tiles of one row
//     tile adjacent (the blocks in flight share their x rows in L2), each
//     found by a binary search of that table.  The producer runs ahead
//     across items, so the next item's loads overlap this one's epilogue.
//     At decode one block's chain of stages (wait, convert, wgmma, release)
//     cannot carry its SM's share of the weight stream, and a gate launch's
//     324 items leave a third of the SMs one item more, so several blocks
//     share each SM.
//   - The epilogue scales (E2) and rounds once to bf16: E2's two A rows of a
//     thread are adjacent channels, stored as a pair; E1's are 8 apart.
// Deterministic: every output element is summed by one thread of one block
// in a fixed depth order; no atomics and no split of K, so no scratch.
// Not yet: a split of K or 64-channel items at decode (a gate launch's
// items still leave some SMs a third more weight to stream than others),
// and a 256-channel item at prefill (half the x rows' re-reads from L2).
#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {

using namespace hopper;

constexpr int kBN = DYN_GMM_CHANNELS, kBK = DYN_GMM_BK, kThreads = DYN_GMM_THREADS;
constexpr int kMaxExperts = DYN_GMM_MAX_EXPERTS;
static_assert(kBN == 128 && kBK == 64 && kThreads == 288, "the roles and fragment mappings below are written for these");

// Shared memory of one instantiation: the ring (each stage kSubs sub-tiles,
// each the weight tile, then the x rows), the full and empty mbarriers, the
// offset and tile tables.
template <int ROWS, bool Q8>
struct Layout {
  static constexpr int kWBytes = kBK * kBN * (Q8 ? 1 : 2);  // the weight tile [64, 128] as copied
  static constexpr int kXBytes = ROWS * kBK * 2;            // x rows [ROWS, 64] bf16, 128 bytes a row
  static constexpr int kSubBytes = kWBytes + kXBytes;       // both 1024-byte multiples: every tile on an atom
  static constexpr int kSubs =                              // 64-deep sub-tiles a stage
      Q8 ? (ROWS == 8 ? DYN_GMM_SUBS_Q8_R8 : ROWS == 32 ? DYN_GMM_SUBS_Q8_R32 : DYN_GMM_SUBS_Q8_R128)
         : (ROWS == 8 ? DYN_GMM_SUBS_BF16_R8 : ROWS == 32 ? DYN_GMM_SUBS_BF16_R32 : DYN_GMM_SUBS_BF16_R128);
  static constexpr int kStageBytes = kSubs * kSubBytes;
  static constexpr int kStages =
      Q8 ? (ROWS == 8 ? DYN_GMM_STAGES_Q8_R8 : ROWS == 32 ? DYN_GMM_STAGES_Q8_R32 : DYN_GMM_STAGES_Q8_R128)
         : (ROWS == 8 ? DYN_GMM_STAGES_BF16_R8 : ROWS == 32 ? DYN_GMM_STAGES_BF16_R32 : DYN_GMM_STAGES_BF16_R128);
  static constexpr size_t kSmem = Q8 ? (ROWS == 8 ? DYN_GMM_SMEM_Q8_R8 : ROWS == 32 ? DYN_GMM_SMEM_Q8_R32
                                                                                    : DYN_GMM_SMEM_Q8_R128)
                                     : (ROWS == 8 ? DYN_GMM_SMEM_BF16_R8 : ROWS == 32 ? DYN_GMM_SMEM_BF16_R32
                                                                                      : DYN_GMM_SMEM_BF16_R128);
  static constexpr int kBlocksPerSm =
      Q8 ? (ROWS == 8 ? DYN_GMM_BLOCKS_PER_SM_Q8_R8 : ROWS == 32 ? DYN_GMM_BLOCKS_PER_SM_Q8_R32
                                                                 : DYN_GMM_BLOCKS_PER_SM_Q8_R128)
         : (ROWS == 8 ? DYN_GMM_BLOCKS_PER_SM_BF16_R8 : ROWS == 32 ? DYN_GMM_BLOCKS_PER_SM_BF16_R32
                                                                   : DYN_GMM_BLOCKS_PER_SM_BF16_R128);
  static_assert(kStageBytes % 1024 == 0, "stages on 1024-byte atoms");
  static_assert(kBlocksPerSm * (kSmem + 1024) <= 233472, "DYN_GMM_BLOCKS_PER_SM_*: the SM's shared memory");
  static_assert(1024 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + 8 * (kMaxExperts + 1) ==
                    kSmem,
                "DYN_GMM_SMEM_* must be the shared memory this layout takes");
};

// Bytes (a, b) of the eight in (lo, hi), selected as __byte_perm does, as bf16x2.
template <int A, int B>
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint32_t lo, uint32_t hi) {
  return i8x2_to_bf16x2(__byte_perm(lo, hi, A | (B << 8)));
}

// One work item: expert e's rows row0 .. row0 + rows - 1 by channels n0 .. n0 + 127.
struct Item {
  int e, row0, rows, n0;
};

// Item `item` of the block's walk, from the tables: s_off[e] expert e's
// first row, s_first[e] its first row tile (s_first[E] the tile count).
template <int ROWS>
__device__ __forceinline__ Item locate(int item, int grid_n, int E, const int* s_off, const int* s_first) {
  const int rt = item / grid_n;
  int lo = 0, hi = E;  // s_first[lo] <= rt < s_first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_first[mid] <= rt)
      lo = mid;
    else
      hi = mid;
  }
  const int row0 = s_off[lo] + (rt - s_first[lo]) * ROWS;
  return {lo, row0, min(ROWS, s_off[lo + 1] - row0), (item - rt * grid_n) * kBN};
}

// ROWS: rows per tile (the wgmma N extent); Q8: the weight is int8 with
// scale [E, N].  tm_x: x [R, K] in boxes of [ROWS, 64]; tm_w: w [E, K, N]
// in boxes of [1, 64, 128] (int8) or [1, 64, 64] (bf16, two a stage);
// both 128-byte swizzled.
template <int ROWS, bool Q8>
__global__ void __launch_bounds__(kThreads, Layout<ROWS, Q8>::kBlocksPerSm)
grouped_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                     const float* __restrict__ scale, const int* __restrict__ offsets,
                     __nv_bfloat16* __restrict__ out, int R, int N, int K, int E, int grid_n) {
  using L = Layout<ROWS, Q8>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * L::kStageBytes);
  uint64_t* empty = full + S;
  int* s_off = reinterpret_cast<int*>(empty + S);
  int* s_first = s_off + kMaxExperts + 1;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, then the stage's TMA bytes
      mbar_init(&empty[s], 2);  // one thread of each consumer warpgroup
    }
    mbar_fence_init();
  }
  for (int i = tid; i <= E; i += kThreads) s_off[i] = min(max(__ldg(offsets + i), 0), R);
  __syncthreads();
  if (tid < 32) {  // s_first: an exclusive scan of each expert's row tiles, 32 experts a pass
    int carry = 0;
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      const int tiles = e < E ? (max(s_off[e + 1] - s_off[e], 0) + ROWS - 1) / ROWS : 0;
      int incl = tiles;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
      }
      if (e < E) s_first[e] = carry + incl - tiles;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_first[E] = carry;
  }
  __syncthreads();
  const int items = s_first[E] * grid_n;
  constexpr int kSubs = L::kSubs;
  const int n_stages = (K + kSubs * kBK - 1) / (kSubs * kBK);  // an item's stages
  const int nk = n_stages * kSubs;  // and its 64-deep steps (past K: zeros)

  if (tid >= 256) {  // producer: one thread issues each stage's TMA loads
    if (tid != 256) return;
    int it = 0;  // the block's stage counter, across items
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Item t = locate<ROWS>(item, grid_n, E, s_off, s_first);
      for (int j = 0; j < n_stages; ++j, ++it) {
        const int s = it % S;
        mbar_wait(&empty[s], ((it / S) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], L::kStageBytes);
#pragma unroll
        for (int sub = 0; sub < kSubs; ++sub) {
          const uint32_t st = smem_u32(smem + s * L::kStageBytes + sub * L::kSubBytes);
          const int k0 = (j * kSubs + sub) * kBK;
          if constexpr (Q8) {  // [64 depth rows of 128 channels], 128 bytes a row
            tma_load_3d(st, &tm_w, t.n0, k0, t.e, &full[s]);
          } else {  // two panels of 64 channels, 128 bytes a depth row
            tma_load_3d(st, &tm_w, t.n0, k0, t.e, &full[s]);
            tma_load_3d(st + 8192, &tm_w, t.n0 + 64, k0, t.e, &full[s]);
          }
          tma_load_2d(st + L::kWBytes, &tm_x, k0, t.row0, &full[s]);  // x rows: the K-major B operand
        }
      }
    }
    return;
  }

  // consumer warpgroups: wg's 64 channels of the item's 128
  const int wg = tid >> 7, wi = (tid & 127) >> 5, g = lane >> 2, t4 = lane & 3;
  // E2: this thread's two A rows are the adjacent channels cbase, cbase + 1
  const int cbase = wg * 64 + wi * 16 + 2 * g;
  float acc[ROWS / 2];
#pragma unroll
  for (int i = 0; i < ROWS / 2; ++i) acc[i] = 0.f;
  uint32_t af[2][4][4];  // E2's A fragments of two stages in flight: [stage parity][k16 step][reg]
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item t = locate<ROWS>(item, grid_n, E, s_off, s_first);
    // 64-deep step kt of this item: wait for its stage if it starts one,
    // issue its four k16 steps, retire the previous step's group and free
    // that step's stage if it ended one
    auto step = [&](int kt, uint32_t(&a)[4][4]) {
      const int s = (it + kt / kSubs) % S;
      if (kt % kSubs == 0) mbar_wait(&full[s], ((it + kt / kSubs) / S) & 1);
      const uint8_t* st = smem + s * L::kStageBytes + (kt % kSubs) * L::kSubBytes;
      const uint32_t xb = smem_u32(st + L::kWBytes);
      if constexpr (Q8) {
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // bytes cbase, cbase + 1 of depth row kr
            const int kr = 16 * kk + 2 * t4 + (j & 1) + 8 * (j >> 1);
            v[j] = *reinterpret_cast<const uint16_t*>(st + kr * 128 + (((cbase >> 4) ^ (kr & 7)) << 4) +
                                                      (cbase & 15));
          }
          a[kk][0] = bytes_to_bf16x2<0, 4>(v[0], v[1]);
          a[kk][1] = bytes_to_bf16x2<1, 5>(v[0], v[1]);
          a[kk][2] = bytes_to_bf16x2<0, 4>(v[2], v[3]);
          a[kk][3] = bytes_to_bf16x2<1, 5>(v[2], v[3]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Wgmma<ROWS, 0>::rs(acc, a[kk][0], a[kk][1], a[kk][2], a[kk][3], sw128_desc(xb + kk * 32, 16, 1024),
                             (kt > 0 || kk > 0) ? 1 : 0);
      } else {
        const uint32_t wb = smem_u32(st) + wg * 8192;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Wgmma<ROWS, 0, 1>::ss(acc, sw128_desc(wb + kk * 2048, 8192, 1024), sw128_desc(xb + kk * 32, 16, 1024),
                                (kt > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // step kt - 1's group has retired: its A registers, and its stage if it ended one, are free
      if (kt > 0 && kt % kSubs == 0 && (tid & 127) == 0) mbar_arrive(&empty[(it + kt / kSubs - 1) % S]);
    };
    // A registers stay live until the wait that retires the group reading them
    int kt = 0;
    for (; kt + 1 < nk; kt += 2) {
      step(kt, af[0]);
      if constexpr (Q8) reg_fence(af[1]);
      step(kt + 1, af[1]);
      if constexpr (Q8) reg_fence(af[0]);
    }
    if (kt < nk) step(kt, af[0]);
    wgmma_wait<0>();
    reg_fence(acc);
    if ((tid & 127) == 0) mbar_arrive(&empty[(it + n_stages - 1) % S]);
    it += n_stages;

    // accumulator i: A row half h = (i / 2) % 2, token row 8 (i / 4) + 2 t4 + i % 2
    if constexpr (Q8) {  // channels cbase + h: one paired store
      const int n = t.n0 + cbase;
      if (n < N) {  // N is a multiple of 16: the pair is whole or out
        const float s0 = __ldg(scale + (size_t)t.e * N + n), s1 = __ldg(scale + (size_t)t.e * N + n + 1);
#pragma unroll
        for (int i = 0; i < ROWS / 2; i += 4)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = 8 * (i >> 2) + 2 * t4 + c;
            if (r < t.rows)
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(t.row0 + r) * N + n) =
                  __floats2bfloat162_rn(acc[i + c] * s0, acc[i + c + 2] * s1);
          }
      }
    } else {  // channel wg 64 + 16 wi + g + 8 h
#pragma unroll
      for (int i = 0; i < ROWS / 2; ++i) {
        const int n = t.n0 + wg * 64 + wi * 16 + g + 8 * ((i >> 1) & 1), r = 8 * (i >> 2) + 2 * t4 + (i & 1);
        if (r < t.rows && n < N) out[(size_t)(t.row0 + r) * N + n] = __float2bfloat16(acc[i]);
      }
    }
  }
}

template <auto Kernel>
cudaError_t launch(int blocks, size_t smem, cudaStream_t stream, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                   const void* scale, const void* offsets, void* out, int R, int N, int K, int E, int grid_n) {
  static const cudaError_t attr = allow_smem(Kernel, smem);
  if (attr != cudaSuccess) return attr;
  Kernel<<<blocks, kThreads, smem, stream>>>(tm_x, tm_w, static_cast<const float*>(scale),
                                             static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out), R,
                                             N, K, E, grid_n);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t dispatch(bool quant, int blocks, cudaStream_t st, const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                     const void* scale, const void* offsets, void* out, int R, int N, int K, int E, int grid_n) {
  if (quant)
    return launch<grouped_wgmma_kernel<ROWS, true>>(blocks, Layout<ROWS, true>::kSmem, st, tm_x, tm_w, scale,
                                                    offsets, out, R, N, K, E, grid_n);
  return launch<grouped_wgmma_kernel<ROWS, false>>(blocks, Layout<ROWS, false>::kSmem, st, tm_x, tm_w, scale,
                                                   offsets, out, R, N, K, E, grid_n);
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 128-byte-swizzled tiled map of a row-major tensor: dims and box
// innermost first, strides in bytes of dims 1 .. rank - 1.
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, const void* base, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace dynamo

// x [R, K] bf16, rows sorted by expert; w [E, K, N] bf16 (quant = 0) or
// int8 (quant = 1, with scale [E, N] f32); offsets [E + 1] int32 on the
// device, 0 = offsets[0] <= ... <= offsets[E] = R (read only by the kernel;
// rows past R are never touched); out [R, N] bf16; all contiguous, x, w
// and out 16-byte aligned, K a multiple of 8 and N of 8 (bf16) or 16 (int8).
// The launch is the caller's plan (launch_geometry.cuh): `rows` per tile
// (8, 32 or 128), grid_n column tiles of 128 channels covering N once, and
// `blocks` persistent blocks (any count from 1 computes every item; the
// plan takes one per SM, or the most items any grouping can make).
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for a
// plan or shape the kernel does not take.
extern "C" int dynamo_grouped_matmul(const void* x, const void* w, const void* scale, const void* offsets, void* out,
                                     int R, int N, int K, int E, int quant, int rows, int grid_n, int blocks,
                                     void* stream) {
  using namespace dynamo;
  if (R < 1 || N < 1 || K < 1 || E < 1 || E > kMaxExperts || K % 8 != 0 || N % (quant ? 16 : 8) != 0)
    return cudaErrorInvalidValue;
  if ((quant != 0) != (scale != nullptr) || offsets == nullptr || blocks < 1) return cudaErrorInvalidValue;
  if ((long long)grid_n * kBN < N || (long long)(grid_n - 1) * kBN >= N) return cudaErrorInvalidValue;
  const void* aligned[] = {x, w, out};
  for (const void* p : aligned)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  if (rows != DYN_GMM_ROWS_DECODE && rows != DYN_GMM_ROWS_MID && rows != DYN_GMM_ROWS_PREFILL)
    return cudaErrorInvalidValue;
  // x [R, K] in boxes of [rows, 64]; w [E, K, N] in boxes of [1, 64, 128 int8 or 64 bf16]
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)R}, x_strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t x_box[2] = {(cuuint32_t)kBK, (cuuint32_t)rows};
  const int wb = quant ? 1 : 2;
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_strides[2] = {(cuuint64_t)N * wb, (cuuint64_t)N * K * wb};
  const cuuint32_t w_box[3] = {(cuuint32_t)(128 / wb), (cuuint32_t)kBK, 1};
  if (!tile_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, x_dims, x_strides, x_box) ||
      !tile_map(&tm_w, quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, w_dims,
                w_strides, w_box))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool q = quant != 0;
  switch (rows) {
    case DYN_GMM_ROWS_DECODE:
      return dispatch<DYN_GMM_ROWS_DECODE>(q, blocks, st, tm_x, tm_w, scale, offsets, out, R, N, K, E, grid_n);
    case DYN_GMM_ROWS_MID:
      return dispatch<DYN_GMM_ROWS_MID>(q, blocks, st, tm_x, tm_w, scale, offsets, out, R, N, K, E, grid_n);
    case DYN_GMM_ROWS_PREFILL:
      return dispatch<DYN_GMM_ROWS_PREFILL>(q, blocks, st, tm_x, tm_w, scale, offsets, out, R, N, K, E, grid_n);
    default:
      return cudaErrorInvalidValue;
  }
}
