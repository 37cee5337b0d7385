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
// No host sync.  The launch never needs the group sizes: its grid is a
// fixed upper bound of row tiles, ceil(R / rows) + E, times the column
// tiles (a group of n rows takes ceil(n / rows) <= n / rows + 1 tiles).
// Each block reads the device offsets, finds by a block-wide integer scan
// which expert's tile its index is and at which row that tile starts, and
// a block past the last tile exits.  An expert with no rows takes no tile
// and costs nothing but that scan.
//
// Deterministic: every output element is summed by one thread of one block
// in a fixed depth order; no atomics and no split of K.
//
// What bounds it on this card.  At decode (Qwen3-30B-A3B: 8 tokens x top-8
// = 64 rows over about 50 of the 128 experts) the weight bytes of the
// experts the rows route to: about 50 x 2048 x 768 x 2 bytes per gate or
// up projection in bf16, 47 us at 3.35 TB/s.  At a 1,504-token prefill
// (12,032 rows) every expert is read, 1.21 GB per layer's three launches
// (0.36 ms) against 113.5 GFLOP (0.115 ms): bytes too.
//
// Design: a simple kernel that is right, on the warp-level tensor cores.
//   - A block owns one expert's tile of ROWS rows (16 while groups are
//     sparse, 64 once they average 32 rows; the wrapper picks by R / E)
//     by 128 output channels; 4 warps each compute all the rows for 32
//     channels with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   - The x rows and the weight tile stream through a 3-stage cp.async
//     ring of 64-deep stages, zero-filled past the group, N and K.  The
//     weight tile [64, 128] lies as in memory (N contiguous), its 16-byte
//     chunks XOR-swizzled by depth row, so ldmatrix.trans reads the B
//     fragments free of bank conflicts; x rows [rows, 64] likewise for
//     ldmatrix.
//   - E2 copies the int8 tile raw (half the bytes) and converts it once per
//     stage into one bf16 tile outside the ring (exact: |v| <= 127), which
//     the warps then read as E1 reads its weight.
//   - The epilogue scales (E2) and rounds once to bf16, two channels per
//     store.
// Not yet: wgmma and TMA, a persistent schedule, and splitting K for the
// sparse decode shapes (a later redesign).
#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {

using namespace hopper;

constexpr int kBN = DYN_GMM_CHANNELS, kBK = DYN_GMM_BK, kStages = DYN_GMM_STAGES;
constexpr int kThreads = DYN_GMM_THREADS, kMaxExperts = DYN_GMM_MAX_EXPERTS;
constexpr int kWBytes = kBK * kBN * 2;  // a bf16 weight tile: 64 depth rows of 256 bytes
static_assert(kBN == 128 && kBK == 64 && kThreads == 128, "the copy and fragment mappings below are written for these");

// Shared memory of one instantiation: the ring, then (E2) the bf16 copy.
template <int ROWS, bool Q8>
struct Layout {
  static constexpr int kXBytes = ROWS * kBK * 2;             // x rows [ROWS, 64] bf16, 128 bytes a row
  static constexpr int kRawBytes = Q8 ? kBK * kBN : kWBytes;  // the weight tile as copied
  static constexpr int kStageBytes = kXBytes + kRawBytes;
  static constexpr int kSmem = kStages * kStageBytes + (Q8 ? kWBytes : 0);
};
static_assert(Layout<DYN_GMM_ROWS_SMALL, false>::kSmem == DYN_GMM_SMEM_BF16_R16, "DYN_GMM_SMEM_BF16_R16");
static_assert(Layout<DYN_GMM_ROWS_LARGE, false>::kSmem == DYN_GMM_SMEM_BF16_R64, "DYN_GMM_SMEM_BF16_R64");
static_assert(Layout<DYN_GMM_ROWS_SMALL, true>::kSmem == DYN_GMM_SMEM_Q8_R16, "DYN_GMM_SMEM_Q8_R16");
static_assert(Layout<DYN_GMM_ROWS_LARGE, true>::kSmem == DYN_GMM_SMEM_Q8_R64, "DYN_GMM_SMEM_Q8_R64");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offsets of 16-byte chunk c of row r: x rows are 128 bytes (8
// chunks), weight rows 256 bytes (16 chunks); the XOR of the row's low three
// bits spreads the 8 rows one ldmatrix reads over all banks.
__device__ __forceinline__ int x_at(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }
__device__ __forceinline__ int w_at(int r, int c) { return r * 256 + ((c ^ (r & 7)) << 4); }

// This block's tile: which expert, its first row and its row count, from
// the device offsets.  Tiles are numbered expert by expert, ceil(n_e /
// ROWS) for expert e; a block-wide integer scan of those counts (128
// experts a pass) places index `tile`.  Returns false past the last tile.
template <int ROWS>
__device__ bool find_tile(const int* __restrict__ offsets, int E, int R, int tile, int* s_warp, int* s_tile) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile[0] = -1;
  int carry = 0;
  for (int base = 0; base < E; base += kThreads) {
    const int e = base + tid;
    const int lo = e < E ? min(__ldg(offsets + e), R) : 0, hi = e < E ? min(__ldg(offsets + e + 1), R) : 0;
    const int n = max(hi - lo, 0), tiles = (n + ROWS - 1) / ROWS;
    int incl = tiles;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    __syncthreads();  // the last pass's warp totals are read
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = carry;
    for (int w = 0; w < warp; ++w) before += s_warp[w];
    const int first = before + incl - tiles;
    if (tiles > 0 && tile >= first && tile < first + tiles) {
      const int row0 = lo + (tile - first) * ROWS;
      s_tile[0] = e;
      s_tile[1] = row0;
      s_tile[2] = min(ROWS, hi - row0);
    }
    for (int w = 0; w < kThreads / 32; ++w) carry += s_warp[w];
  }
  __syncthreads();
  return s_tile[0] >= 0;
}

// Q8: the weight is int8 with scale [E, N]; ROWS: 16 or 64 rows a tile.
template <int ROWS, bool Q8>
__global__ void __launch_bounds__(kThreads)
grouped_matmul_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ w,
                      const float* __restrict__ scale, const int* __restrict__ offsets,
                      __nv_bfloat16* __restrict__ out, int R, int N, int K, int E) {
  using L = Layout<ROWS, Q8>;
  constexpr int MF = ROWS / 16;  // 16-row A fragments
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_warp[kThreads / 32], s_tile[3];
  if (!find_tile<ROWS>(offsets, E, R, blockIdx.y, s_warp, s_tile)) return;
  const int e = s_tile[0], row0 = s_tile[1], rows = s_tile[2];
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nk = (K + kBK - 1) / kBK;
  const size_t w_off = (size_t)e * K * N;

  auto issue = [&](int it) {
    uint8_t* st = smem + (it % kStages) * L::kStageBytes;
    const int k0 = it * kBK;
#pragma unroll
    for (int i = 0; i < MF; ++i) {  // x: ROWS rows x 8 chunks of 8 bf16
      const int c = tid + kThreads * i, r = c >> 3, q = c & 7, gk = k0 + 8 * q;
      const bool ok = r < rows && gk < K;
      cp_async_16(smem_u32(st + x_at(r, q)), ok ? static_cast<const void*>(x + (size_t)(row0 + r) * K + gk) : x,
                  ok ? 16 : 0);
    }
    uint8_t* wt = st + L::kXBytes;
    if constexpr (Q8) {  // 64 depth rows x 8 chunks of 16 int8 channels, as they lie
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = tid + kThreads * i, kr = c >> 3, q = c & 7, gk = k0 + kr, gn = n0 + 16 * q;
        const bool ok = gk < K && gn < N;
        const int8_t* src = static_cast<const int8_t*>(w) + w_off + (size_t)gk * N + gn;
        cp_async_16(smem_u32(wt + kr * 128 + 16 * q), ok ? static_cast<const void*>(src) : w, ok ? 16 : 0);
      }
    } else {  // 64 depth rows x 16 chunks of 8 bf16 channels, swizzled
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = tid + kThreads * i, kr = c >> 4, q = c & 15, gk = k0 + kr, gn = n0 + 8 * q;
        const bool ok = gk < K && gn < N;
        const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(w) + w_off + (size_t)gk * N + gn;
        cp_async_16(smem_u32(wt + w_at(kr, q)), ok ? static_cast<const void*>(src) : w, ok ? 16 : 0);
      }
    }
  };

  float acc[MF][4][4];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < nk) issue(it);
    cp_async_commit();
  }
  uint8_t* wconv = smem + kStages * L::kStageBytes;  // E2's bf16 copy
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 (and the bf16 copy) is free
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (kt % kStages) * L::kStageBytes;
    const uint8_t* wt = st + L::kXBytes;
    if constexpr (Q8) {  // each thread converts 4 chunks of 16 codes into 4 pairs of bf16 chunks
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = tid + kThreads * i, kr = c >> 3, q = c & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(wt + kr * 128 + 16 * q);
        const uint32_t word[4] = {v.x, v.y, v.z, v.w};
        uint32_t h[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          h[2 * j] = i8x2_to_bf16x2(__byte_perm(word[j], 0, 0x4140));      // bytes 0, 1
          h[2 * j + 1] = i8x2_to_bf16x2(__byte_perm(word[j], 0, 0x4342));  // bytes 2, 3
        }
        *reinterpret_cast<uint4*>(wconv + w_at(kr, 2 * q)) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(wconv + w_at(kr, 2 * q + 1)) = make_uint4(h[4], h[5], h[6], h[7]);
      }
      __syncthreads();
      wt = wconv;
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[MF][4];
#pragma unroll
      for (int m = 0; m < MF; ++m) {  // lanes 0-15: rows at depth 16 kk, lanes 16-31: at 16 kk + 8
        const int r = 16 * m + (lane & 15);
        ldmatrix_x4(a[m], smem_u32(st + x_at(r, 2 * kk + (lane >> 4))));
      }
      uint32_t b[4][2];
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {  // fragments 2 jp and 2 jp + 1, depth 0-7 and 8-15 of each
        const int mi = lane >> 3, kr = 16 * kk + 8 * (mi & 1) + (lane & 7);
        uint32_t v[4];
        ldmatrix_x4_trans(v, smem_u32(wt + w_at(kr, 4 * warp + 2 * jp + (mi >> 1))));
        b[2 * jp][0] = v[0];
        b[2 * jp][1] = v[1];
        b[2 * jp + 1][0] = v[2];
        b[2 * jp + 1][1] = v[3];
      }
#pragma unroll
      for (int m = 0; m < MF; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[m][j], a[m][0], a[m][1], a[m][2], a[m][3], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // acc[m][j][i]: row 16 m + g + 8 (i / 2), channel 32 warp + 8 j + 2 t + i % 2
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 32 * warp + 8 * j + 2 * t;
    if (n >= N) continue;  // N is a multiple of 8: the pair is whole or out
    float s0 = 1.f, s1 = 1.f;
    if constexpr (Q8) {
      s0 = __ldg(scale + (size_t)e * N + n);
      s1 = __ldg(scale + (size_t)e * N + n + 1);
    }
#pragma unroll
    for (int m = 0; m < MF; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * m + g + 8 * h;
        if (r < rows)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r) * N + n) =
              __floats2bfloat162_rn(acc[m][j][2 * h] * s0, acc[m][j][2 * h + 1] * s1);
      }
  }
}

template <auto Kernel>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t stream, const void* x, const void* w, const void* scale,
                   const void* offsets, void* out, int R, int N, int K, int E) {
  static const cudaError_t attr = allow_smem(Kernel, smem);
  if (attr != cudaSuccess) return attr;
  Kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(x), w, static_cast<const float*>(scale),
                                          static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out), R, N,
                                          K, E);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dynamo

// x [R, K] bf16, rows sorted by expert; w [E, K, N] bf16 (quant = 0) or
// int8 (quant = 1, with scale [E, N] f32); offsets [E + 1] int32 on the
// device, 0 = offsets[0] <= ... <= offsets[E] = R (read only by the kernel;
// rows past R are never touched); out [R, N] bf16; all contiguous, x, w
// and out 16-byte aligned, K a multiple of 8 and N of 8 (bf16) or 16 (int8).  The
// launch is the caller's plan (launch_geometry.cuh): `rows` per tile (16 or
// 64), grid_n column tiles of 128 channels covering N once, and grid_m =
// ceil(R / rows) + E row tiles, the bound every grouping of R rows fits.
// Returns the launch's cudaGetLastError(), or cudaErrorInvalidValue for a
// plan or shape the kernel does not take.
extern "C" int dynamo_grouped_matmul(const void* x, const void* w, const void* scale, const void* offsets, void* out,
                                     int R, int N, int K, int E, int quant, int rows, int grid_n, int grid_m,
                                     void* stream) {
  using namespace dynamo;
  if (R < 1 || N < 1 || K < 1 || E < 1 || E > kMaxExperts || K % 8 != 0 || N % (quant ? 16 : 8) != 0)
    return cudaErrorInvalidValue;
  if ((rows != DYN_GMM_ROWS_SMALL && rows != DYN_GMM_ROWS_LARGE) || (quant != 0) != (scale != nullptr))
    return cudaErrorInvalidValue;
  if ((long long)grid_n * kBN < N || (long long)(grid_n - 1) * kBN >= N || grid_m != (R + rows - 1) / rows + E ||
      grid_m > 65535)
    return cudaErrorInvalidValue;
  if (offsets == nullptr) return cudaErrorInvalidValue;
  const void* aligned[] = {x, w, out};
  for (const void* p : aligned)
    if (p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 != 0) return cudaErrorInvalidValue;
  const dim3 grid(grid_n, grid_m);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quant)
    return rows == DYN_GMM_ROWS_SMALL
               ? launch<grouped_matmul_kernel<DYN_GMM_ROWS_SMALL, true>>(grid, DYN_GMM_SMEM_Q8_R16, st, x, w, scale,
                                                                         offsets, out, R, N, K, E)
               : launch<grouped_matmul_kernel<DYN_GMM_ROWS_LARGE, true>>(grid, DYN_GMM_SMEM_Q8_R64, st, x, w, scale,
                                                                         offsets, out, R, N, K, E);
  return rows == DYN_GMM_ROWS_SMALL
             ? launch<grouped_matmul_kernel<DYN_GMM_ROWS_SMALL, false>>(grid, DYN_GMM_SMEM_BF16_R16, st, x, w, scale,
                                                                        offsets, out, R, N, K, E)
             : launch<grouped_matmul_kernel<DYN_GMM_ROWS_LARGE, false>>(grid, DYN_GMM_SMEM_BF16_R64, st, x, w, scale,
                                                                        offsets, out, R, N, K, E);
}
