// Paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py,
// paged_prefill_attention (bf16 body _kernel -> _kernel_impl): flash
// prefill.  Each batch row has S fresh queries starting at the block-aligned
// position `start`.  They attend the cached prefix [0, start) in full,
// streamed from the paged cache [L, N, 2, Bs, Hk*D] at a runtime layer
// index, and their own fresh K/V causally, masked at seq_len - start.
// Padding query rows (index >= seq_len - start) come out exactly 0.
// GQA, optional tanh softcap.
//
// What bounds it on this card: at long S, tensor-core flops.  A block's
// query tile reuses every K/V byte it reads 64 times (its 64 query rows),
// so past a few hundred tokens the least time is
// (4 * H * D * visible (query, key) pairs) / 989 TFLOP/s (bf16); at short S
// it is the bytes of q, K/V and the prefix.
//
// What the design does about that: both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate), FlashAttention-2 style.
// One block of 4 warps owns (row b, a tile of TQ = 64 / G query tokens,
// KV head k): its 64 query rows are the G query heads of k for each token,
// so the G heads that share a KV head share each K/V tile read.  Each warp
// owns 16 rows; scores, the online softmax and the output stay in
// registers, and the probabilities feed the PV product straight from the
// score fragments.  K/V tiles of 64 keys (32 at D = 256) are staged in
// shared memory with rows padded by 8 bf16, which makes every fragment load
// bank-conflict free.  The causal walk stops at the tile's last query, and
// tiles made only of padding rows write zeros and stop.  Dead keys (past
// `start` in the prefix, past seq_len - start in the fresh chunk) are
// staged as zeros, so NaN in the pool or in padding K/V never reaches a
// live lane.
//
// Not yet done (later work): cp.async/TMA double buffering of the K/V
// tiles, ldmatrix fragment loads, wgmma with 64-row warpgroup tiles.
#include "attention_common.cuh"

namespace dynamo {
namespace {

constexpr int kWarps = 4;
constexpr int kRows = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Tile {
  static constexpr int kKeys = D > 128 ? 32 : 64;  // keys per K/V tile
  static constexpr int kStride = D + 8;            // bf16 row stride in shared memory
  static size_t smem_bytes() { return sizeof(__nv_bfloat16) * (size_t)(kRows + 2 * kKeys) * kStride; }
};

__device__ inline void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ inline uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ inline uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ inline uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `n_live` K and V rows of a tile (row_ptr(j, &k, &v) points at key
// j's bf16 rows) into shared memory; rows past n_live are zeros.
template <int D, class RowPtr>
__device__ void stage_kv(__nv_bfloat16* ks, __nv_bfloat16* vs, int n_live, RowPtr row_ptr) {
  using T = Tile<D>;
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < T::kKeys * kChunks; c += kThreads) {
    const int j = c / kChunks, part = c % kChunks;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (j < n_live) {
      const __nv_bfloat16* kr;
      const __nv_bfloat16* vr;
      row_ptr(j, &kr, &vr);
      kv = __ldg(reinterpret_cast<const uint4*>(kr) + part);
      vv = __ldg(reinterpret_cast<const uint4*>(vr) + part);
    }
    *reinterpret_cast<uint4*>(ks + j * T::kStride + part * 8) = kv;
    *reinterpret_cast<uint4*>(vs + j * T::kStride + part * 8) = vv;
  }
}

// Per-warp flash state: 16 query rows; this thread holds rows g and g + 8
// of the warp (g = lane / 4) and, of every 8-column fragment, columns
// 2 * (lane % 4) + {0, 1}.
template <int D>
struct WarpState {
  float o[D / 8][4];
  float m[2];
  float l[2];  // this thread's partial row sums (summed over the quad at the end)
};

// One K/V tile already staged: scores, mask, online softmax, PV.
// visible(half, key) says whether this thread's row g + 8 * half sees tile
// key `key` (0 .. kKeys-1).
template <int D, class Visible>
__device__ void attend(WarpState<D>& st, const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                       const __nv_bfloat16* vs, float sm_scale, float logit_cap, Visible visible) {
  using T = Tile<D>;
  constexpr int kN = T::kKeys / 8;  // score fragments per row block
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qa = qs + (warp * 16 + g) * T::kStride + 2 * t;
  const __nv_bfloat16* qb = qa + 8 * T::kStride;

  float s[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    const uint32_t a0 = ld32(qa + k0), a1 = ld32(qb + k0), a2 = ld32(qa + k0 + 8), a3 = ld32(qb + k0 + 8);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const __nv_bfloat16* kr = ks + (n * 8 + g) * T::kStride + k0 + 2 * t;
      mma_bf16(s[n], a0, a1, a2, a3, ld32(kr), ld32(kr + 8));
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[n][e] * sm_scale;
      if (logit_cap > 0.f) x = tanhf(x / logit_cap) * logit_cap;
      x = visible(e / 2, n * 8 + 2 * t + (e & 1)) ? x : -INFINITY;
      s[n][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    // a row that has seen nothing keeps m = -inf, p = 0 and alpha = 1
    alpha[h] = m_new == -INFINITY ? 1.f : expf(st.m[h] - m_new);
    st.m[h] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float m = st.m[e / 2];
      const float p = m == -INFINITY ? 0.f : expf(s[n][e] - m);
      s[n][e] = p;
      sum[e / 2] += p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // PV: the score fragments of keys 16kk .. 16kk+15 are the A fragment
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    const uint32_t a0 = pack(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t a1 = pack(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t a2 = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t a3 = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const __nv_bfloat16* v0 = vs + (16 * kk + 2 * t) * T::kStride + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* vr = v0 + n * 8;
      const uint32_t b0 = pack(vr[0], vr[T::kStride]);
      const uint32_t b1 = pack(vr[8 * T::kStride], vr[9 * T::kStride]);
      mma_bf16(st.o[n], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
               const __nv_bfloat16* __restrict__ v_new, const __nv_bfloat16* __restrict__ cache,
               const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
               const int* __restrict__ starts, __nv_bfloat16* __restrict__ out, int S, int H, int Hk,
               int N, int Bs, int M, int layer, int TQ, float sm_scale, float logit_cap) {
  using T = Tile<D>;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * T::kStride;
  __nv_bfloat16* vs = ks + T::kKeys * T::kStride;

  const int b = blockIdx.x, i0 = blockIdx.y * TQ, head = blockIdx.z;
  const int group = H / Hk, rows = TQ * group;
  const int start = starts[b];
  const int fresh = seq_lens[b] - start;
  const int hkd = Hk * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;

  // block row r = (token i0 + r / group, query head head * group + r % group)
  auto row_off = [&](int r) -> size_t {
    return (((size_t)b * S + i0 + r / group) * H + (size_t)head * group + r % group) * D;
  };
  auto row_token = [&](int r) { return r < rows ? i0 + r / group : 0x7fffffff; };

  WarpState<D> st;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) st.o[n][0] = st.o[n][1] = st.o[n][2] = st.o[n][3] = 0.f;
  st.m[0] = st.m[1] = -INFINITY;
  st.l[0] = st.l[1] = 0.f;

  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const int tok[2] = {row_token(ra), row_token(rb)};

  if (i0 < fresh) {
    // queries of the tile into shared memory (rows past the input are 0)
    for (int c = threadIdx.x; c < kRows * (D / 8); c += kThreads) {
      const int r = c / (D / 8), part = c % (D / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < rows && i0 + r / group < S) v = __ldg(reinterpret_cast<const uint4*>(q + row_off(r)) + part);
      *reinterpret_cast<uint4*>(qs + r * T::kStride + part * 8) = v;
    }

    // phase 1: the cached prefix, every slot below `start` visible to live rows
    const int* table = block_tables + (size_t)b * M;
    for (int t0 = 0; t0 < start; t0 += T::kKeys) {
      __syncthreads();  // the previous tile's readers are done
      stage_kv<D>(ks, vs, min(T::kKeys, start - t0), [&](int j, const __nv_bfloat16** kr, const __nv_bfloat16** vr) {
        const int pos = t0 + j;
        const int bid = min(max(table[min(pos / Bs, M - 1)], 0), N - 1);
        *kr = cache_row(cache, layer, N, Bs, hkd, bid, 0, pos % Bs, head, D);
        *vr = cache_row(cache, layer, N, Bs, hkd, bid, 1, pos % Bs, head, D);
      });
      __syncthreads();
      attend<D>(st, qs, ks, vs, sm_scale, logit_cap,
                [&](int h, int key) { return t0 + key < start && tok[h] < fresh; });
    }

    // phase 2: fresh keys, causal by chunk index, up to the tile's last query
    const int key_end = min(fresh, i0 + TQ);
    for (int t0 = 0; t0 < key_end; t0 += T::kKeys) {
      __syncthreads();
      stage_kv<D>(ks, vs, min(T::kKeys, key_end - t0), [&](int j, const __nv_bfloat16** kr, const __nv_bfloat16** vr) {
        const size_t off = (((size_t)b * S + t0 + j) * Hk + head) * D;
        *kr = k_new + off;
        *vr = v_new + off;
      });
      __syncthreads();
      attend<D>(st, qs, ks, vs, sm_scale, logit_cap, [&](int h, int key) {
        const int j = t0 + key;
        return j < key_end && j <= tok[h] && tok[h] < fresh;
      });
    }
  }

  // final division and bf16 store (rows that saw nothing: l = 0 -> exactly 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = h == 0 ? ra : rb;
    if (r >= rows || i0 + r / group >= S) continue;
    const float inv = 1.f / fmaxf(l, 1e-9f);
    __nv_bfloat16* dst = out + row_off(r) + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(st.o[n][2 * h] * inv, st.o[n][2 * h + 1] * inv);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* bt,
                   const void* lens, const void* starts, void* out, int B, int S, int H, int Hk, int N,
                   int Bs, int M, int layer, float sm_scale, float logit_cap, cudaStream_t stream) {
  const int group = H / Hk;
  if (group > kRows) return cudaErrorInvalidValue;
  const int tq = kRows / group;
  auto kernel = prefill_kernel<D>;
  const size_t smem = Tile<D>::smem_bytes();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, (S + tq - 1) / tq, Hk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const __nv_bfloat16*>(cache),
      static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(starts),
      static_cast<__nv_bfloat16*>(out), S, H, Hk, N, Bs, M, layer, tq, sm_scale, logit_cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dynamo

// q [B, S, H, D], k_new, v_new [B, S, Hk, D] bf16; cache [L, N, 2, Bs, Hk*D]
// bf16; block_tables [B, M] int32 (the prefix blocks lead the table);
// seq_lens, start [B] int32; out [B, S, H, D] bf16.  logit_cap <= 0 turns
// the softcap off.  Returns the launch's cudaGetLastError().
extern "C" int dynamo_prefill_attention(const void* q, const void* k_new, const void* v_new,
                                        const void* cache, const void* block_tables, const void* seq_lens,
                                        const void* start, void* out, int B, int S, int H, int Hk, int D,
                                        int N, int Bs, int M, int layer, float sm_scale, float logit_cap,
                                        void* stream) {
  using namespace dynamo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k_new, v_new, cache, block_tables, seq_lens, start, out, B, S, H, Hk, N, Bs, M,
                        layer, sm_scale, logit_cap, st);
    case 128:
      return launch<128>(q, k_new, v_new, cache, block_tables, seq_lens, start, out, B, S, H, Hk, N, Bs, M,
                         layer, sm_scale, logit_cap, st);
    case 256:
      return launch<256>(q, k_new, v_new, cache, block_tables, seq_lens, start, out, B, S, H, Hk, N, Bs, M,
                         layer, sm_scale, logit_cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
