// Tensor-core flash-attention building blocks shared by the paged prefill
// and the ragged prefill kernels: a block of 4 warps owns 64 query rows
// (16 per warp), K/V tiles are staged in shared memory as bf16, and both
// products run on mma.sync m16n8k16 (bf16 in, f32 accumulate) with the
// online softmax kept in registers.  See prefill_attention.cu for the
// design.  A tile read from an int8 cache is staged as bf16 (exact) with
// its per-key K and V scales beside it in f32; attend<D, true> applies
// them as the TPU kernel does: the K scale multiplies the key's score
// column before the softcap, and the V scale multiplies the key's
// probability in the PV product only (the softmax max and sum see the
// unscaled probabilities).
#pragma once

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

__device__ inline uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) { return pack_bf16(lo, hi); }

__device__ inline uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage the K and V rows of a tile (row_ptr(j, &k, &v) points at key j's
// rows, bf16 or int8) into shared memory as bf16; keys for which live(j) is
// false are zeros and are never read from memory.
template <int D, class E, class Live, class RowPtr>
__device__ void stage_kv_if(__nv_bfloat16* ks, __nv_bfloat16* vs, Live live, RowPtr row_ptr) {
  using T = Tile<D>;
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < T::kKeys * kChunks; c += kThreads) {
    const int j = c / kChunks, part = c % kChunks;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
    if (live(j)) {
      const E* kr;
      const E* vr;
      row_ptr(j, &kr, &vr);
      kv = load8_bf16(kr, part);
      vv = load8_bf16(vr, part);
    }
    *reinterpret_cast<uint4*>(ks + j * T::kStride + part * 8) = kv;
    *reinterpret_cast<uint4*>(vs + j * T::kStride + part * 8) = vv;
  }
}

// The first n_live keys of a tile live, the rest zeros.
template <int D, class E, class RowPtr>
__device__ void stage_kv(__nv_bfloat16* ks, __nv_bfloat16* vs, int n_live, RowPtr row_ptr) {
  stage_kv_if<D, E>(ks, vs, [&](int j) { return j < n_live; }, row_ptr);
}

// The per-key K and V scales of an int8 tile (scale(j, &k, &v)); dead keys
// get 0, so a NaN in a dead slot's scale never reaches the PV product.
template <int D, class Scale>
__device__ void stage_scales(float* sck, float* scv, int n_live, Scale scale) {
  for (int j = threadIdx.x; j < Tile<D>::kKeys; j += kThreads) {
    float k = 0.f, v = 0.f;
    if (j < n_live) scale(j, &k, &v);
    sck[j] = k;
    scv[j] = v;
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

  __device__ void init() {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }
};

// One K/V tile already staged: scores, mask, online softmax, PV.
// visible(half, key) says whether this thread's row g + 8 * half sees tile
// key `key` (0 .. kKeys-1).  With kScaled, sck and scv are the tile's
// per-key K and V scales (an int8 tile); otherwise they are not read.
template <int D, bool kScaled, class Visible>
__device__ void attend(WarpState<D>& st, const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                       const __nv_bfloat16* vs, const float* sck, const float* scv, float sm_scale,
                       float logit_cap, Visible visible) {
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
      if constexpr (kScaled) x *= sck[n * 8 + 2 * t + (e & 1)];
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

  // PV: the score fragments of keys 16kk .. 16kk+15 are the A fragment,
  // each probability times its key's V scale for an int8 tile
  auto pv = [&](int n, int e) {
    float p = s[n][e];
    if constexpr (kScaled) p *= scv[n * 8 + 2 * t + (e & 1)];
    return p;
  };
#pragma unroll
  for (int kk = 0; kk < kN / 2; ++kk) {
    const uint32_t a0 = pack(pv(2 * kk, 0), pv(2 * kk, 1));
    const uint32_t a1 = pack(pv(2 * kk, 2), pv(2 * kk, 3));
    const uint32_t a2 = pack(pv(2 * kk + 1, 0), pv(2 * kk + 1, 1));
    const uint32_t a3 = pack(pv(2 * kk + 1, 2), pv(2 * kk + 1, 3));
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

// Final division and bf16 store of this thread's two rows: row_dst(r)
// gives block row r's output row, or nullptr for a row that is not stored.
// Rows that saw nothing have l = 0 and come out exactly 0.
template <int D, class RowDst>
__device__ void store_rows(const WarpState<D>& st, RowDst row_dst) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    __nv_bfloat16* dst = row_dst(warp * 16 + g + 8 * h);
    if (dst == nullptr) continue;
    const float inv = 1.f / fmaxf(l, 1e-9f);
    dst += 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(st.o[n][2 * h] * inv, st.o[n][2 * h + 1] * inv);
    }
  }
}

}  // namespace
}  // namespace dynamo
