// W8A16 matrix product for Hopper (sm_90a): out = (x @ wq) * scale.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/int8_matmul.py,
// int8_matmul (_kernel): x [M, K] bf16 times an int8 weight with one f32
// scale per output channel, the int8 -> bf16 convert inside the kernel,
// f32 accumulation and the scale in the epilogue.  The weight is [K, N]
// row-major (a projection) or [N, K] row-major (its transpose: the tied
// embedding [V, Dm] used as the lm_head), so the tied product never copies
// the vocabulary matrix.  Out is bf16 or f32 (logits).  M, N and K may be
// any size: ragged tile edges are masked, and there is no fallback.
//
// What bounds it on this card: at decode (M = 8 rows) the weight bytes,
// K * N int8 read once, over 3.35 TB/s; a 4096 x 14336 projection is 59 MB,
// about 18 us.  At prefill (M in the thousands) the tensor-core flops,
// 2 * M * K * N / 989 TFLOP/s (bf16).
//
// What the design does about that: the weight crosses device memory as
// int8 and only as int8, the point of int8 serving; it is staged in shared
// memory as it is and converted to bf16 while the mma.sync m16n8k16 B
// fragments are built (exact: |v| <= 127 fits bf16's significand).  A block
// of 4 warps computes a BM x 64 output tile, walking K in steps of 64; BM
// is 16, 32 or 64 by M, so a decode step spends one 16-row tile (half of it
// idle at M = 8) and a prefill 64-row tiles.  Where the output tiles alone
// cannot fill the card's SMs (decode: N / 64 tiles), K is split over up to
// 16 blocks that write f32 partials, and a second small kernel sums them,
// applies the scale and rounds once.  Otherwise the scale is applied to the
// f32 accumulator in the epilogue before the one rounding to the output
// dtype.
//
// Not yet done (later work): cp.async/TMA multi-stage loads, wgmma with
// 64-row warpgroup tiles, a decode tile that does not idle half its rows.
#include "mma_attention.cuh"

namespace dynamo {
namespace {

constexpr int kBN = 64;  // output columns per block
constexpr int kBK = 64;  // contracted depth per step
constexpr int kMmThreads = 128;

template <int BM, bool NK>
struct MmTile {
  static constexpr int kWarpsM = BM / 16;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kWarpCols = kBN / kWarpsN;
  static constexpr int kFrags = kWarpCols / 8;  // n fragments per warp
  static constexpr int kXStride = kBK + 8;      // bf16 per x row in shared memory
  // int8 weight tile as stored: [BK][BN] for [K, N] weights, [BN][BK] for [N, K]
  static constexpr int kWRows = NK ? kBN : kBK;
  static constexpr int kWStride = (NK ? kBK : kBN) + 16;  // bytes per weight row
};

__device__ inline __nv_bfloat16 i8_to_bf16(int8_t v) { return __float2bfloat16((float)v); }

// grid (ceil(N / 64), ceil(M / BM), splits); block `split` covers K steps
// [split * k_steps, (split + 1) * k_steps).  With `partial` non-null it
// writes its f32 sums there ([splits, M, N]); otherwise the scaled result.
template <int BM, bool NK>
__global__ void __launch_bounds__(kMmThreads)
w8a16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, void* __restrict__ out, float* __restrict__ partial, int M,
             int N, int K, int k_steps, int out_f32, int vec_x, int vec_w) {
  using T = MmTile<BM, NK>;
  __shared__ __align__(16) __nv_bfloat16 xs[BM * T::kXStride];
  __shared__ __align__(16) int8_t ws[T::kWRows * T::kWStride];

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_steps * kBK;
  const int k_end = min(K, k_begin + k_steps * kBK);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;

  float acc[T::kFrags][4];
#pragma unroll
  for (int f = 0; f < T::kFrags; ++f) acc[f][0] = acc[f][1] = acc[f][2] = acc[f][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // x tile [BM][BK]: 8 bf16 per chunk; rows past M and depth past k_end are 0
    for (int c = threadIdx.x; c < BM * (kBK / 8); c += kMmThreads) {
      const int r = c / (kBK / 8), gm = m0 + r, gk = k0 + (c % (kBK / 8)) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gm < M) {
        const __nv_bfloat16* src = x + (size_t)gm * K + gk;
        if (vec_x && gk + 8 <= k_end) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
          for (int i = 0; i < 8 && gk + i < k_end; ++i) e[i] = src[i];
        }
      }
      *reinterpret_cast<uint4*>(xs + r * T::kXStride + (c % (kBK / 8)) * 8) = v;
    }
    // weight tile: 16 int8 per chunk along the weight's contiguous axis
    for (int c = threadIdx.x; c < kBK * kBN / 16; c += kMmThreads) {
      constexpr int kPerRow = (NK ? kBK : kBN) / 16;
      const int r = c / kPerRow, col = (c % kPerRow) * 16;
      // NK: row r is output channel n0 + r, col the depth; KN: row r is depth k0 + r
      const int outer = NK ? n0 + r : k0 + r;
      const int inner = NK ? k0 + col : n0 + col;
      const bool row_ok = NK ? outer < N : outer < k_end;
      const int inner_end = NK ? k_end : N;
      const int ld = NK ? K : N;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row_ok) {
        const int8_t* src = w + (size_t)outer * ld + inner;
        if (vec_w && inner + 16 <= inner_end) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          int8_t* e = reinterpret_cast<int8_t*>(&v);
          for (int i = 0; i < 16 && inner + i < inner_end; ++i) e[i] = src[i];
        }
      }
      *reinterpret_cast<uint4*>(ws + r * T::kWStride + col) = v;
    }
    __syncthreads();

    const __nv_bfloat16* xa = xs + (wm * 16 + g) * T::kXStride + 2 * t;
    const __nv_bfloat16* xb = xa + 8 * T::kXStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const uint32_t a0 = ld32(xa + kk), a1 = ld32(xb + kk), a2 = ld32(xa + kk + 8), a3 = ld32(xb + kk + 8);
#pragma unroll
      for (int f = 0; f < T::kFrags; ++f) {
        const int n = wn * T::kWarpCols + f * 8 + g, k = kk + 2 * t;
        // B fragment: (k, n), (k + 1, n) and (k + 8, n), (k + 9, n)
        auto wv = [&](int kr) -> __nv_bfloat16 {
          return i8_to_bf16(NK ? ws[n * T::kWStride + kr] : ws[kr * T::kWStride + n]);
        };
        mma_bf16(acc[f], a0, a1, a2, a3, pack(wv(k), wv(k + 1)), pack(wv(k + 8), wv(k + 9)));
      }
    }
    __syncthreads();
  }

  // accumulator fragment e of f: row g + 8 * (e / 2), column 2t + (e & 1)
#pragma unroll
  for (int f = 0; f < T::kFrags; ++f) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm * 16 + g + 8 * (e / 2);
      const int n = n0 + wn * T::kWarpCols + f * 8 + 2 * t + (e & 1);
      if (m >= M || n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (partial != nullptr) {
        partial[(size_t)blockIdx.z * M * N + o] = acc[f][e];
      } else {
        const float y = acc[f][e] * __ldg(scale + n);
        if (out_f32)
          static_cast<float*>(out)[o] = y;
        else
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(y);
      }
    }
  }
}

// out[m, n] = scale[n] * sum over splits of partial[s, m, n], rounded once.
__global__ void splitk_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ scale,
                                     void* __restrict__ out, int M, int N, int splits, int out_f32) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += partial[s * mn + i];
  const float y = a * __ldg(scale + i % N);
  if (out_f32)
    static_cast<float*>(out)[i] = y;
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(y);
}

template <int BM, bool NK>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* partial, int M, int N,
                   int K, int out_f32, int k_steps, int splits, cudaStream_t stream) {
  const int vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = (NK ? K : N) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  w8a16_kernel<BM, NK><<<grid, kMmThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      out, part, M, N, K, k_steps, out_f32, vec_x, vec_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, static_cast<const float*>(scale), out, M, N, splits, out_f32);
  return cudaGetLastError();
}

template <bool NK>
cudaError_t launch_m(const void* x, const void* w, const void* scale, void* out, void* partial, int M, int N,
                     int K, int out_f32, int k_steps, int splits, cudaStream_t stream) {
  if (M <= 16) return launch<16, NK>(x, w, scale, out, partial, M, N, K, out_f32, k_steps, splits, stream);
  if (M <= 32) return launch<32, NK>(x, w, scale, out, partial, M, N, K, out_f32, k_steps, splits, stream);
  return launch<64, NK>(x, w, scale, out, partial, M, N, K, out_f32, k_steps, splits, stream);
}

}  // namespace
}  // namespace dynamo

// x [M, K] bf16; w int8 [K, N] row-major (w_nk = 0) or [N, K] row-major
// (w_nk = 1); scale [N] f32; out [M, N] bf16 (out_f32 = 0) or f32.  The
// block tile is 16, 32 or 64 rows (M <= 16, <= 32, larger) by 64 columns.
// K is walked in `splits` ranges of `k_steps` 64-deep steps; with splits
// > 1, `partial` holds splits * M * N floats.  M, N, K >= 1.  Returns
// cudaGetLastError() after the launches.
extern "C" int dynamo_int8_matmul(const void* x, const void* w, const void* scale, void* out, void* partial,
                                  int M, int N, int K, int w_nk, int out_f32, int k_steps, int splits,
                                  void* stream) {
  using namespace dynamo;
  if (M < 1 || N < 1 || K < 1 || k_steps < 1 || splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  if ((long long)(splits - 1) * k_steps * kBK >= K) return cudaErrorInvalidValue;  // an empty split
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_nk) return launch_m<true>(x, w, scale, out, partial, M, N, K, out_f32, k_steps, splits, st);
  return launch_m<false>(x, w, scale, out, partial, M, N, K, out_f32, k_steps, splits, st);
}
