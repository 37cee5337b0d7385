// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/decode_attention.py,
// paged_decode_attention_mq (bf16 body _kernel -> _kernel_impl): flash
// decoding over the paged KV cache [L, N, 2, Bs, Hk*D] at a runtime layer
// index.  Each batch row has S trailing queries at positions q0 .. q0+S-1;
// query s sees cache slots [0, seq_len) of the row's block table with
// slot <= q0 + s.  GQA, optional tanh softcap.  Rows with seq_len == 0
// come out exactly 0.
//
// What bounds it on this card: the bytes of K/V read from device memory.
// At decode a row does ~4*G*S flops per byte of KV it reads, far below the
// H100's ~295 bf16 flops per byte, so the least time is
// (KV bytes of the live context) / 3.35 TB/s.
//
// What the design does about that: every byte of a row's context is read
// once.  The context is split into chunks of `split` tokens (flash-decoding
// split-K), one thread block per (row, KV head, chunk), so a batch of a few
// long rows still puts hundreds of blocks on the 132 SMs; a second small
// kernel merges the chunks' softmax partials.  A block holds all G*S query
// rows of its KV head, so the G query heads sharing a KV head share one
// read.  Blocks read their own row's block-table entries and walk only
// slots below seq_len; chunks that start past it exit at once.  A KV head's
// row is D contiguous bf16 values (256 bytes at D = 128), loaded as 16-byte
// vectors by neighbouring threads.  Dead slots are staged as zeros, so NaN
// left in the pool never reaches the PV product.  The TPU kernel's
// block-diagonal query expansion and its grouping of sequences per grid
// step were answers to the MXU and to a sequential grid; here blocks run in
// parallel and the scores are f32 dot products from shared memory.
//
// Not yet done (later work): cp.async/TMA double buffering of the K/V
// tiles, tensor-core scores for the S > 1 shapes.
#include "attention_common.cuh"

namespace dynamo {
namespace {

constexpr int kMaxRows = 64;  // S * G query rows one block holds

template <int D>
struct Geometry {
  static constexpr int kStride = D + 4;      // padded f32 row in shared memory
  static constexpr int kChunks = D / 8;      // 16-byte bf16 vectors per row
  static constexpr int kTile = D > 128 ? 32 : 64;  // keys per tile
  static constexpr int kThreads = D;         // one thread per output column

  // shared memory for `rows` query rows: q, K tile, V tile, P, m, l, alpha
  static size_t smem_bytes(int rows) {
    return sizeof(float) * ((size_t)rows * kStride + 2 * (size_t)kTile * kStride +
                            (size_t)rows * kTile + 3 * (size_t)rows);
  }
};

template <int D>
struct Smem {
  float* q;      // [rows][kStride], pre-scaled
  float* k;      // [kTile][kStride]
  float* v;      // [kTile][kStride]
  float* p;      // [rows][kTile], scores then probabilities
  float* m;      // [rows] running max
  float* l;      // [rows] running sum
  float* alpha;  // [rows] rescale factor of the current tile

  __device__ Smem(float* base, int rows) {
    using G = Geometry<D>;
    q = base;
    k = q + (size_t)rows * G::kStride;
    v = k + (size_t)G::kTile * G::kStride;
    p = v + (size_t)G::kTile * G::kStride;
    m = p + (size_t)rows * G::kTile;
    l = m + rows;
    alpha = l + rows;
  }
};

__device__ inline void store_bf16x8(const uint4& raw, float scale, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x * scale;
    f[2 * i + 1] = x.y * scale;
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ inline void store_zero8(float* dst) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  reinterpret_cast<float4*>(dst)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// One tile of keys t0 .. t0+kTile-1 (the first n_live of them live) folded
// into the block's rows: load (dead keys as zeros), scores with mask and
// softcap, online softmax (one warp per row), PV with thread d owning
// output column d of every row in registers.
template <int D, int RMAX, class KvPtr>
__device__ void attend_tile(const Smem<D>& sm, int rows, int group, int t0, int n_live, int q0,
                            float logit_cap, KvPtr kv_ptr, float (&acc)[RMAX]) {
  using G = Geometry<D>;
  for (int c = threadIdx.x; c < G::kTile * G::kChunks; c += G::kThreads) {
    const int j = c / G::kChunks, part = c % G::kChunks;
    float* kd = sm.k + (size_t)j * G::kStride + part * 8;
    float* vd = sm.v + (size_t)j * G::kStride + part * 8;
    if (j < n_live) {
      const __nv_bfloat16* kr;
      const __nv_bfloat16* vr;
      kv_ptr(t0 + j, &kr, &vr);
      store_bf16x8(__ldg(reinterpret_cast<const uint4*>(kr) + part), 1.f, kd);
      store_bf16x8(__ldg(reinterpret_cast<const uint4*>(vr) + part), 1.f, vd);
    } else {
      store_zero8(kd);
      store_zero8(vd);
    }
  }
  __syncthreads();

  // scores: row r is query token q0 + r / group; key j is visible when it is
  // live and not after that token
  for (int e = threadIdx.x; e < rows * G::kTile; e += G::kThreads) {
    const int r = e / G::kTile, j = e % G::kTile;
    float s = -INFINITY;
    if (j < n_live && t0 + j <= q0 + r / group) {
      const float4* qr = reinterpret_cast<const float4*>(sm.q + (size_t)r * G::kStride);
      const float4* kr = reinterpret_cast<const float4*>(sm.k + (size_t)j * G::kStride);
      float a = 0.f;
#pragma unroll 8
      for (int i = 0; i < D / 4; ++i) {
        const float4 x = qr[i], y = kr[i];
        a = fmaf(x.x, y.x, a);
        a = fmaf(x.y, y.y, a);
        a = fmaf(x.z, y.z, a);
        a = fmaf(x.w, y.w, a);
      }
      s = logit_cap > 0.f ? tanhf(a / logit_cap) * logit_cap : a;
    }
    sm.p[(size_t)r * G::kTile + j] = s;
  }
  __syncthreads();

  constexpr int kWarps = G::kThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float* row = sm.p + (size_t)r * G::kTile;
    float mx = -INFINITY;
    for (int j = lane; j < G::kTile; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, mx);
    float alpha = 1.f, sum = 0.f;
    if (m_new == -INFINITY) {  // nothing seen yet: p = 0, state unchanged
      for (int j = lane; j < G::kTile; j += 32) row[j] = 0.f;
    } else {
      alpha = expf(m_old - m_new);  // 0 while m_old is still -inf
      for (int j = lane; j < G::kTile; j += 32) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();
    if (lane == 0) {
      sm.m[r] = m_new;
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.alpha[r] = alpha;
    }
  }
  __syncthreads();

  const int d = threadIdx.x;
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < rows) acc[r] *= sm.alpha[r];
  for (int j = 0; j < G::kTile; ++j) {
    const float v = sm.v[(size_t)j * G::kStride + d];
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < rows) acc[r] = fmaf(sm.p[(size_t)r * G::kTile + j], v, acc[r]);
  }
  __syncthreads();
}

// Pass 1: block (b, head, chunk) attends slots [chunk * split, (chunk + 1) *
// split) of row b and writes its unnormalised partials: acc [rows][D], m and
// l [rows], at (b, head, chunk) of the workspace.
template <int D, int RMAX>
__global__ void __launch_bounds__(D)
decode_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ cache,
                    const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                    const int* __restrict__ q0_pos, float* __restrict__ ws_acc,
                    float* __restrict__ ws_ml, int S, int H, int Hk, int N, int Bs, int M, int layer,
                    int split, float sm_scale, float logit_cap) {
  using G = Geometry<D>;
  extern __shared__ float4 smem_raw[];
  const int b = blockIdx.x, head = blockIdx.y, chunk = blockIdx.z, n_chunks = gridDim.z;
  const int group = H / Hk, rows = S * group;
  const int seq_len = seq_lens[b];
  const int c0 = chunk * split, c1 = min(c0 + split, seq_len);
  const size_t part = ((size_t)b * Hk + head) * n_chunks + chunk;
  float* m_out = ws_ml + part * 2 * rows;
  float* l_out = m_out + rows;
  if (c0 >= c1) {  // chunk past the row's end: an empty partial
    for (int r = threadIdx.x; r < rows; r += G::kThreads) {
      m_out[r] = -INFINITY;
      l_out[r] = 0.f;
    }
    return;
  }

  const Smem<D> sm(reinterpret_cast<float*>(smem_raw), rows);
  // row r = (query s, grouped head g): s = r / group, head index head*group + g
  for (int c = threadIdx.x; c < rows * G::kChunks; c += G::kThreads) {
    const int r = c / G::kChunks, piece = c % G::kChunks;
    const __nv_bfloat16* src = q + (((size_t)b * S + r / group) * H + (size_t)head * group + r % group) * D;
    store_bf16x8(__ldg(reinterpret_cast<const uint4*>(src) + piece), sm_scale,
                 sm.q + (size_t)r * G::kStride + piece * 8);
  }
  for (int r = threadIdx.x; r < rows; r += G::kThreads) {
    sm.m[r] = -INFINITY;
    sm.l[r] = 0.f;
  }
  float acc[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) acc[r] = 0.f;
  __syncthreads();

  const int* table = block_tables + (size_t)b * M;
  const int last_block = min((seq_len - 1) / Bs, M - 1);
  const int hkd = Hk * D;
  auto kv = [&](int pos, const __nv_bfloat16** kr, const __nv_bfloat16** vr) {
    const int bid = min(max(table[min(pos / Bs, last_block)], 0), N - 1);
    *kr = cache_row(cache, layer, N, Bs, hkd, bid, 0, pos % Bs, head, D);
    *vr = cache_row(cache, layer, N, Bs, hkd, bid, 1, pos % Bs, head, D);
  };
  const int q0 = q0_pos[b];
  for (int t0 = c0; t0 < c1; t0 += G::kTile)
    attend_tile<D, RMAX>(sm, rows, group, t0, min(G::kTile, c1 - t0), q0, logit_cap, kv, acc);

  float* acc_out = ws_acc + part * rows * D;
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < rows) acc_out[(size_t)r * D + threadIdx.x] = acc[r];
  for (int r = threadIdx.x; r < rows; r += G::kThreads) {
    m_out[r] = sm.m[r];
    l_out[r] = sm.l[r];
  }
}

// Pass 2: block (b, head) merges the chunks' partials of its rows and
// writes bf16 out.  Rows that saw nothing (every chunk empty or masked)
// come out exactly 0.
template <int D>
__global__ void __launch_bounds__(D)
decode_merge_kernel(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                    __nv_bfloat16* __restrict__ out, int S, int H, int Hk, int n_chunks) {
  const int b = blockIdx.x, head = blockIdx.y, d = threadIdx.x;
  const int group = H / Hk, rows = S * group;
  const size_t part0 = ((size_t)b * Hk + head) * n_chunks;
  for (int r = 0; r < rows; ++r) {
    float m = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, ws_ml[(part0 + c) * 2 * rows + r]);
    float l = 0.f, a = 0.f;
    if (m != -INFINITY) {
      for (int c = 0; c < n_chunks; ++c) {
        const float mc = ws_ml[(part0 + c) * 2 * rows + r];
        if (mc == -INFINITY) continue;  // an empty chunk wrote no acc
        const float w = expf(mc - m);
        l += w * ws_ml[(part0 + c) * 2 * rows + rows + r];
        a += w * ws_acc[((part0 + c) * rows + r) * D + d];
      }
    }
    out[(((size_t)b * S + r / group) * H + (size_t)head * group + r % group) * D + d] =
        __float2bfloat16(a / fmaxf(l, 1e-9f));
  }
}

template <int D, int RMAX>
cudaError_t launch(const void* q, const void* cache, const void* bt, const void* lens, const void* q0,
                   void* out, void* ws, int B, int S, int H, int Hk, int N, int Bs, int M, int layer,
                   int split, float sm_scale, float logit_cap, cudaStream_t stream) {
  auto kernel = decode_split_kernel<D, RMAX>;
  const int rows = S * (H / Hk);
  const size_t smem = Geometry<D>::smem_bytes(rows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (M * Bs + split - 1) / split;
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)B * Hk * n_chunks * rows * D;
  kernel<<<dim3(B, Hk, n_chunks), Geometry<D>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache),
      static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(q0), ws_acc,
      ws_ml, S, H, Hk, N, Bs, M, layer, split, sm_scale, logit_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<D><<<dim3(B, Hk), D, 0, stream>>>(ws_acc, ws_ml, static_cast<__nv_bfloat16*>(out),
                                                        S, H, Hk, n_chunks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(const void* q, const void* cache, const void* bt, const void* lens, const void* q0,
                        void* out, void* ws, int B, int S, int H, int Hk, int N, int Bs, int M, int layer,
                        int split, float sm_scale, float logit_cap, cudaStream_t stream) {
  const int rows = S * (H / Hk);
  if (split <= 0 || split % Geometry<D>::kTile) return cudaErrorInvalidValue;
  if (rows <= 8)
    return launch<D, 8>(q, cache, bt, lens, q0, out, ws, B, S, H, Hk, N, Bs, M, layer, split, sm_scale,
                        logit_cap, stream);
  if (rows <= 16)
    return launch<D, 16>(q, cache, bt, lens, q0, out, ws, B, S, H, Hk, N, Bs, M, layer, split, sm_scale,
                         logit_cap, stream);
  if (rows <= 32)
    return launch<D, 32>(q, cache, bt, lens, q0, out, ws, B, S, H, Hk, N, Bs, M, layer, split, sm_scale,
                         logit_cap, stream);
  if (rows <= kMaxRows)
    return launch<D, kMaxRows>(q, cache, bt, lens, q0, out, ws, B, S, H, Hk, N, Bs, M, layer, split,
                               sm_scale, logit_cap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dynamo

// q [B, S, H, D] bf16; cache [L, N, 2, Bs, Hk*D] bf16; block_tables [B, M]
// int32; seq_lens, q0_pos [B] int32; out [B, S, H, D] bf16; workspace f32
// of B * Hk * ceil(M * Bs / split) * S * (H / Hk) * (D + 2) floats.  `split`
// (tokens per chunk) is a multiple of the key tile (64, or 32 at D = 256).
// logit_cap <= 0 turns the softcap off.  Returns cudaGetLastError() after
// the launches.
extern "C" int dynamo_decode_attention(const void* q, const void* cache, const void* block_tables,
                                       const void* seq_lens, const void* q0_pos, void* out, void* workspace,
                                       int B, int S, int H, int Hk, int D, int N, int Bs, int M, int layer,
                                       int split, float sm_scale, float logit_cap, void* stream) {
  using namespace dynamo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_rows<64>(q, cache, block_tables, seq_lens, q0_pos, out, workspace, B, S, H, Hk, N, Bs,
                             M, layer, split, sm_scale, logit_cap, st);
    case 128:
      return launch_rows<128>(q, cache, block_tables, seq_lens, q0_pos, out, workspace, B, S, H, Hk, N,
                              Bs, M, layer, split, sm_scale, logit_cap, st);
    case 256:
      return launch_rows<256>(q, cache, block_tables, seq_lens, q0_pos, out, workspace, B, S, H, Hk, N,
                              Bs, M, layer, split, sm_scale, logit_cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
