// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/decode_attention.py,
// paged_decode_attention_mq, both of its bodies: bf16 (_kernel ->
// _kernel_impl, B1) and int8 (_kernel_quant, B4a, over a QuantKvCache: int8
// payload [L, N, 2, Bs, Hk*D] plus per-(token, KV head) f32 scales
// [L, N, 2, Hp, Sp]).  Flash decoding over the paged KV cache
// [L, N, 2, Bs, Hk*D] at a runtime layer index.  Each batch row has S
// trailing queries at positions q0 .. q0+S-1; query s sees cache slots
// [0, seq_len) of the row's block table with slot <= q0 + s.  GQA, optional
// tanh softcap.  Rows with seq_len == 0 come out exactly 0.
//
// What bounds it on this card: the bytes of K/V read from device memory.
// At decode a row does ~4*G*S flops per byte of KV it reads, far below the
// H100's ~295 bf16 flops per byte, so the least time is
// (KV bytes of the live context) / 3.35 TB/s; over an int8 cache the
// payload plus the scales of the live context, half the bf16 bytes.  At the
// serving shapes that is a few microseconds, so what a call costs is its
// latency: the dependent loads of a block's walk and the launches.
//
// The int8 kernel (B4a) is built for that latency; the bf16 kernel (B1)
// keeps its first design and moves onto B4a's in the next change.
//
// B4a, one launch.  The context is split into chunks of `chunk` tokens (the
// caller's plan: a multiple of 64, the shortest that keeps a full table's
// grid within about two waves of blocks and a row at DYN_B4A_MAX_CHUNKS
// chunks), one block per (KV head, group of query rows, row, chunk), so a
// few rows of a few thousand tokens still put hundreds of blocks to work.
// The chunk is the grid's slowest axis: every row's first chunks are
// dispatched first, and the blocks past a row's context, dispatched last,
// exit at once.  A block's four warps each own
// every 4th 16-key tile of the chunk and keep their own online softmax (a
// 64-token chunk is one tile per warp, all four in flight at once); each
// warp streams its tiles through its own 3-stage ring of raw int8 rows and
// their scales with 16-byte cp.async (K rows swizzled so the score reads
// are conflict-free), so it needs only __syncwarp, never a block barrier,
// until its chunk is done.  Warps rather than mma.sync: at S = 1 a KV
// head's G query rows are a quarter of an m16 tile, the f32 products of a
// 64-key chunk are a few hundred FMAs a thread, and the warps' partials
// merge in shared memory once.  In a tile, lane (key j, half h) computes
// key j's scores over half the head dims for every query row from f32 Q in
// shared memory (int8 -> f32 exactly, one PRMT and one FADD a value), the
// two halves meet in one shuffle, the K scale multiplies the score before
// the softcap, the softmax runs in base 2 over the 16 keys by shuffles, and
// P times the V scale goes through shared memory to the P V product, where
// each lane owns D / 32 output columns (the row sums take P unscaled).
// Dead keys (past seq_len, or past a query's position) are masked; their
// rows and scales are zero-filled by the copies, never read, so NaN in a
// dead slot, its scale or a pad lane never reaches the output.
//
// The four warps' states merge in shared memory; a row's only chunk stores
// the output.  Otherwise each chunk stores its unnormalised partial (o, m,
// l) in the workspace and takes a ticket of its (row, KV head, row group);
// the last of the row's ceil(seq_len / chunk) chunks merges the partials
// in chunk order (the same bits on every run) and resets the ticket, so the
// tickets stay zeroed between launches: no memset, and the launch can be
// captured in a CUDA graph as it is.
//
// B1: the context is split into chunks of `split` tokens (flash-decoding
// split-K), one thread block per (row, KV head, chunk); a second small
// kernel merges the chunks' softmax partials.  A block holds all G*S query
// rows of its KV head, stages each 64-key tile in f32 shared memory and
// computes f32 dot products.  Dead slots are staged as zeros.
#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {

// ------------------------------------------------------------------- B1
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
// kv_ptr(pos, &k_row, &v_row) gives key pos's rows.
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
      store_bf16x8(load8_bf16(kr, part), 1.f, kd);
      store_bf16x8(load8_bf16(vr, part), 1.f, vd);
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
                    const int* __restrict__ q0_pos, float* __restrict__ ws_acc, float* __restrict__ ws_ml, int S,
                    int H, int Hk, int N, int Bs, int M, int layer, int split, float sm_scale, float logit_cap) {
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
cudaError_t launch(const void* q, const void* cache, const void* bt, const void* lens, const void* q0, void* out,
                   void* ws, int B, int S, int H, int Hk, int N, int Bs, int M, int layer, int split,
                   float sm_scale, float logit_cap, cudaStream_t stream) {
  auto kernel = decode_split_kernel<D, RMAX>;
  const int rows = S * (H / Hk);
  const size_t smem = Geometry<D>::smem_bytes(rows);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_chunks = (M * Bs + split - 1) / split;
  float* ws_acc = static_cast<float*>(ws);
  float* ws_ml = ws_acc + (size_t)B * Hk * n_chunks * rows * D;
  kernel<<<dim3(B, Hk, n_chunks), Geometry<D>::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(cache), static_cast<const int*>(bt),
      static_cast<const int*>(lens), static_cast<const int*>(q0), ws_acc, ws_ml, S, H, Hk, N, Bs, M, layer, split,
      sm_scale, logit_cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<D><<<dim3(B, Hk), D, 0, stream>>>(ws_acc, ws_ml, static_cast<__nv_bfloat16*>(out),
                                                        S, H, Hk, n_chunks);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rows(const void* q, const void* cache, const void* bt, const void* lens, const void* q0,
                        void* out, void* ws, int B, int S, int H, int Hk, int N, int Bs, int M, int layer, int split,
                        float sm_scale, float logit_cap, cudaStream_t stream) {
  const int rows = S * (H / Hk);
  if (split <= 0 || split % Geometry<D>::kTile) return cudaErrorInvalidValue;
#define DYNAMO_DECODE_LAUNCH(RMAX) \
  return launch<D, RMAX>(q, cache, bt, lens, q0, out, ws, B, S, H, Hk, N, Bs, M, layer, split, sm_scale, logit_cap, stream)
  if (rows <= 8) DYNAMO_DECODE_LAUNCH(8);
  if (rows <= 16) DYNAMO_DECODE_LAUNCH(16);
  if (rows <= 32) DYNAMO_DECODE_LAUNCH(32);
  if (rows <= kMaxRows) DYNAMO_DECODE_LAUNCH(kMaxRows);
#undef DYNAMO_DECODE_LAUNCH
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ B4a
namespace q8 {
constexpr int kThreads = DYN_B4A_THREADS, kWarps = kThreads / 32;
constexpr int kKeys = DYN_B4A_KEYS, kStages = DYN_B4A_STAGES, kMaxChunks = DYN_B4A_MAX_CHUNKS;
static_assert(kThreads == 128 && kKeys == 16 && DYN_B4A_CHUNK == kWarps * kKeys,
              "the lane roles below are written for 4 warps of 16-key tiles, one tile each per shortest chunk");

template <int D>
constexpr int kRowsOf = D == 64 ? DYN_B4A_ROWS_D64 : D == 128 ? DYN_B4A_ROWS_D128 : DYN_B4A_ROWS_D256;

// A block of R query rows at head dim D.
template <int D, int R>
struct Geometry {
  static constexpr int kPieces = D / 16;                       // 16-byte pieces of an int8 row
  static constexpr int kSwizzle = (kPieces < 8 ? kPieces : 8) - 1;
  static constexpr int kStage = 2 * kKeys * D;                 // a tile's int8 K rows, then its V rows
  static constexpr int kWarpRing = kStages * kStage;
  static constexpr int kQBytes = R * D * 4;                    // f32 Q rows
  static constexpr int kRingBytes = kWarps * kWarpRing;
  static constexpr int kScaleBytes = kWarps * kStages * 2 * kKeys * 4;  // f32 K then V scales per stage
  static constexpr int kPBytes = kWarps * R * kKeys * 4;       // each warp's P times the V scale
  static constexpr int kMergeBytes = (2 * kMaxChunks + 1) * R * 4;  // the chunks' m (then weights) and l, 1 / l
  static constexpr size_t kSmem =
      D == 64 ? (R == 4 ? DYN_B4A_SMEM_D64_R4 : R == 8 ? DYN_B4A_SMEM_D64_R8 : DYN_B4A_SMEM_D64_R16)
      : D == 128 ? (R == 4 ? DYN_B4A_SMEM_D128_R4 : R == 8 ? DYN_B4A_SMEM_D128_R8 : DYN_B4A_SMEM_D128_R16)
                 : (R == 4 ? DYN_B4A_SMEM_D256_R4 : DYN_B4A_SMEM_D256_R8);
  static_assert(R <= kRowsOf<D> && (R == 4 || R == 8 || R == 16), "4, 8 or 16 rows, at most DYN_B4A_ROWS_D<D>");
  static_assert((size_t)kQBytes + kRingBytes + kScaleBytes + kPBytes + kMergeBytes + 16 == kSmem,
                "DYN_B4A_SMEM_D*_R* must be the shared memory this layout takes");
  static_assert(R * (D + 2) * 4 <= kWarpRing, "a warp's partial must fit its ring");
  static_assert(R * D % kThreads == 0, "the merge gives each thread whole output elements");
};

// Byte K of w ^ 0x80808080 as an exact f32 (-128 .. 127): 2^23 + 128 + v
// assembled in the bits, then the offset subtracted.
template <int K>
__device__ __forceinline__ float i8_to_f32(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | K)) - 8388736.f;
}

__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = i8_to_f32<0>(x);
  f[1] = i8_to_f32<1>(x);
  f[2] = i8_to_f32<2>(x);
  f[3] = i8_to_f32<3>(x);
}

// N = D / 32 int8 values at p (2-, 4- or 8-byte aligned) as f32.
template <int N>
__device__ __forceinline__ void load_i8(const int8_t* p, float (&f)[N]) {
  if constexpr (N == 2) {
    const uint32_t x = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    f[0] = i8_to_f32<0>(x);
    f[1] = i8_to_f32<1>(x);
  } else if constexpr (N == 4) {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
  } else {
    static_assert(N == 8, "D / 32 values per lane");
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f32(w.x, f);
    i8x4_to_f32(w.y, f + 4);
  }
}
}  // namespace q8

// Block (KV head x row group, row b, chunk c) of the int8 decode kernel:
// query rows r0 .. r0 + R - 1 of the row's S * G (R = 4, 8 or 16; the
// plan's row groups cover them), keys [c * chunk, (c + 1) * chunk) of its
// context.  `ws` holds a partial of R * (D + 2) floats per (row, KV head,
// row group, chunk); `tickets` one zeroed int per (row, KV head, row group).
template <int D, int R>
__global__ void __launch_bounds__(q8::kThreads)
decode_q8_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ cache,
                 const float* __restrict__ scale, const int* __restrict__ block_tables,
                 const int* __restrict__ seq_lens, const int* __restrict__ q0_pos, __nv_bfloat16* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ tickets, int S, int H, int Hk, int N, int Bs, int M,
                 int layer, int Hp, int Sp, int chunk, int row_groups, float sm_scale, float logit_cap) {
  using namespace hopper;
  using G = q8::Geometry<D, R>;
  using q8::kKeys;
  using q8::kStages;
  using q8::kThreads;
  using q8::kWarps;
  constexpr int kCols = D / 32;  // output columns per lane
  constexpr int kPart = R * (D + 2);
  const int c = blockIdx.z, n_chunks = gridDim.z;
  const int head = blockIdx.x / row_groups, rg = blockIdx.x % row_groups, b = blockIdx.y;
  const int group = H / Hk, r0 = rg * R, nr = min(R, S * group - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // block row r: query r0 + r of the row = (token s, group head g)
  auto row_off = [&](int r) {
    const int x = r0 + r;
    return (((size_t)b * S + x / group) * H + (size_t)head * group + x % group) * D;
  };
  const int ctx = min(seq_lens[b], M * Bs);  // the table's slots below seq_len
  const int n_live = ctx > 0 ? (ctx + chunk - 1) / chunk : 0;
  if (n_live == 0) {  // an empty row is exactly 0, written by its first chunk
    if (c == 0)
      for (int e = tid; e < nr * (D / 8); e += kThreads)
        *reinterpret_cast<uint4*>(out + row_off(e / (D / 8)) + (e % (D / 8)) * 8) = make_uint4(0, 0, 0, 0);
    return;
  }
  if (c >= n_live) return;  // past the row's context

  extern __shared__ float4 smem_raw[];  // the declaration B1's kernel shares
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_raw);
  float* qs = reinterpret_cast<float*>(base);  // [R][D], times the score scale
  int8_t* ring = reinterpret_cast<int8_t*>(base + G::kQBytes) + warp * G::kWarpRing;  // this warp's
  float* scl = reinterpret_cast<float*>(base + G::kQBytes + G::kRingBytes) + warp * kStages * 2 * kKeys;
  float* pw = reinterpret_cast<float*>(base + G::kQBytes + G::kRingBytes + G::kScaleBytes) + warp * R * kKeys;
  float* merge = reinterpret_cast<float*>(base + G::kQBytes + G::kRingBytes + G::kScaleBytes + G::kPBytes);
  int* flag = reinterpret_cast<int*>(merge + (2 * q8::kMaxChunks + 1) * R);

  const int c0 = c * chunk, c1 = min(c0 + chunk, ctx);
  const int n_tiles = (c1 - c0 + kKeys - 1) / kKeys;
  const int n_mine = warp < n_tiles ? (n_tiles - 1 - warp) / kWarps + 1 : 0;  // tiles warp, warp + 4, ...
  const int* table = block_tables + (size_t)b * M;
  const int last_block = (ctx - 1) / Bs, hkd = Hk * D;
  auto block_of = [&](int pos) { return min(max(table[min(pos / Bs, last_block)], 0), N - 1); };

  // this warp's k-th tile into stage k % kStages: lane copies 16-byte
  // pieces of the K rows (piece p of key j at slot p ^ (j & kSwizzle)) and
  // V rows, then key (lane % 16)'s K (lane < 16) or V scale; dead keys
  // (past the chunk's context) are zero-filled, not read
  auto issue = [&](int k) {
    const int t0 = c0 + (warp + k * kWarps) * kKeys;
    int8_t* st = ring + (k % kStages) * G::kStage;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const int pc = lane + 32 * i, kv = pc / D, j = (pc % D) / G::kPieces, p = pc % G::kPieces;
      const int pos = t0 + j;
      const bool live = pos < c1;
      const int8_t* src = cache;
      if (live)
        src = cache + ((((size_t)layer * N + block_of(pos)) * 2 + kv) * Bs + pos % Bs) * hkd + (size_t)head * D +
              p * 16;
      const int dst = kv ? kKeys * D + j * D + p * 16 : j * D + ((p ^ (j & G::kSwizzle)) << 4);
      cp_async_16(smem_u32(st + dst), src, live ? 16 : 0);
    }
    const int j = lane & 15, kv = lane >> 4, pos = t0 + j;
    const bool live = pos < c1;
    const float* src = scale;
    if (live) src = scale + ((((size_t)layer * N + block_of(pos)) * 2 + kv) * Hp + head) * Sp + pos % Bs;
    cp_async_4(smem_u32(scl + (k % kStages) * 2 * kKeys + lane), src, live ? 4 : 0);
  };
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_mine) issue(k);
    cp_async_commit();
  }

  // Q rows in f32 times the score scale (base 2), while the copies fly;
  // rows past the row's queries are 0
  constexpr float kLog2e = 1.4426950408889634f;
  const bool cap = logit_cap > 0.f;
  const float qk_scale = cap ? sm_scale / logit_cap : sm_scale * kLog2e;
  const float cap_scale = logit_cap * kLog2e;
  for (int e = tid; e < R * (D / 8); e += kThreads) {
    const int r = e / (D / 8), part = e % (D / 8);
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < nr) raw = __ldg(reinterpret_cast<const uint4*>(q + row_off(r)) + part);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h2[i]);
      f[2 * i] = x.x * qk_scale;
      f[2 * i + 1] = x.y * qk_scale;
    }
    float4* dst = reinterpret_cast<float4*>(qs + r * D + part * 8);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
  __syncthreads();

  const int q0 = q0_pos[b];
  const int j = lane & 15, hf = lane >> 4;  // the score phase's key and half of the head dims
  float m[R], l[R], o[R][kCols];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) o[r][e] = 0.f;
  }
  for (int k = 0; k < n_mine; ++k) {
    if (k + kStages - 1 < n_mine) issue(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();  // every lane's copies of tile k have landed
    const int8_t* sk = ring + (k % kStages) * G::kStage;
    const int8_t* sv = sk + kKeys * D;
    const float* ss = scl + (k % kStages) * 2 * kKeys;
    const int t = c0 + (warp + k * kWarps) * kKeys + j;  // this lane's key

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) {
      const int p = hf * (D / 32) + i;
      const uint4 raw = *reinterpret_cast<const uint4*>(sk + j * D + ((p ^ (j & G::kSwizzle)) << 4));
      float kf[16];
      q8::i8x4_to_f32(raw.x, kf);
      q8::i8x4_to_f32(raw.y, kf + 4);
      q8::i8x4_to_f32(raw.z, kf + 8);
      q8::i8x4_to_f32(raw.w, kf + 12);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * D + p * 16);
        float a = s[r];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 x = qr[v];
          a = fmaf(x.x, kf[4 * v], a);
          a = fmaf(x.y, kf[4 * v + 1], a);
          a = fmaf(x.z, kf[4 * v + 2], a);
          a = fmaf(x.w, kf[4 * v + 3], a);
        }
        s[r] = a;
      }
    }
    const float ks = ss[j], vs = ss[kKeys + j];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = (s[r] + __shfl_xor_sync(0xffffffffu, s[r], 16)) * ks;  // the K scale before the softcap
      if (cap) x = cap_scale * tanhf(x);
      const bool visible = r < nr && t < c1 && t <= q0 + (r0 + r) / group;
      x = visible ? x : -INFINITY;
      float mx = x;
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      // a row that has seen nothing keeps m = -inf, p = 0 and alpha = 1
      const float alpha = m_new == -INFINITY ? 1.f : exp2f(m[r] - m_new);
      const float pr = m_new == -INFINITY ? 0.f : exp2f(x - m_new);
      float sum = pr;
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) o[r][e] *= alpha;
      if (hf == 0) pw[r * kKeys + j] = pr * vs;  // the V scale on P only
    }
    __syncwarp();
    // O += P V: lane owns columns lane * kCols .. + kCols - 1 of every row
#pragma unroll
    for (int jj = 0; jj < kKeys; jj += 4) {
      float vf[4][kCols];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) q8::load_i8<kCols>(sv + (jj + kk) * D + lane * kCols, vf[kk]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(pw + r * kKeys + jj);
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          o[r][e] = fmaf(pr.w, vf[3][e], fmaf(pr.z, vf[2][e], fmaf(pr.y, vf[1][e], fmaf(pr.x, vf[0][e], o[r][e]))));
      }
    }
    __syncwarp();  // the stage and P are refilled next
  }
  cp_async_wait<0>();
  __syncwarp();

  // the warp's state into its own ring: o [R][D], then m [R] and l [R]
  float* mine = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < kCols; ++e) mine[r * D + lane * kCols + e] = o[r][e];
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mine[R * D + r] = m[r];
      mine[R * D + R + r] = l[r];
    }
  __syncthreads();

  // the chunk's state from the four warps', in warp order
  float* part = ws + (((size_t)(b * Hk + head) * row_groups + rg) * n_chunks + c) * kPart;
  for (int e = tid; e < R * D; e += kThreads) {
    const int r = e / D;
    const float* w0 = reinterpret_cast<const float*>(base + G::kQBytes);
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, w0[w * G::kWarpRing / 4 + R * D + r]);
    float acc = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* wp = w0 + w * G::kWarpRing / 4;
      const float mw = wp[R * D + r];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mm);
      acc += wt * wp[e];
      ll += wt * wp[R * D + R + r];
    }
    if (n_live == 1) {  // the row's only chunk: the output
      if (r < nr) out[row_off(r) + e % D] = __float2bfloat16(acc / fmaxf(ll, 1e-9f));
    } else {
      part[e] = acc;
      if (e % D == 0) {
        part[R * D + r] = mm;
        part[R * D + R + r] = ll;
      }
    }
  }
  if (n_live == 1) return;

  // the last of the row's chunks to arrive merges the partials in chunk order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* ticket = tickets + (b * Hk + head) * row_groups + rg;
    *flag = atomicAdd(ticket, 1) == n_live - 1;
    if (*flag) *ticket = 0;  // every chunk has arrived: no one else touches it
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* parts = ws + ((size_t)(b * Hk + head) * row_groups + rg) * n_chunks * kPart;
  // every chunk's m and l at once; then each row's chunk weights (in place
  // of m) and 1 / l from shared memory
  float* mc = merge;                   // [n_live][R]
  float* lc = merge + q8::kMaxChunks * R;
  float* inv = lc + q8::kMaxChunks * R;  // [R]
  for (int i = tid; i < n_live * R; i += kThreads) {
    const float* p = parts + (size_t)(i / R) * kPart + R * D + i % R;
    mc[i] = __ldcg(p);
    lc[i] = __ldcg(p + R);
  }
  __syncthreads();
  if (tid < R) {
    float mm = -INFINITY;
    for (int cc = 0; cc < n_live; ++cc) mm = fmaxf(mm, mc[cc * R + tid]);
    float ll = 0.f;
    for (int cc = 0; cc < n_live; ++cc) {
      const float mw = mc[cc * R + tid];
      const float w = mw == -INFINITY ? 0.f : exp2f(mw - mm);
      mc[cc * R + tid] = w;
      ll += w * lc[cc * R + tid];
    }
    inv[tid] = 1.f / fmaxf(ll, 1e-9f);
  }
  __syncthreads();
  // each thread's kE output elements, summed in chunk order with kU
  // chunks' loads in flight
  constexpr int kE = R * D / kThreads, kU = kE >= 8 ? 4 : 8;
  float acc[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) acc[k] = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += kU) {
    float v[kU][kE];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < kE; ++k)
        v[u][k] = c0 + u < n_live ? __ldcg(parts + (size_t)(c0 + u) * kPart + tid + k * kThreads) : 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (c0 + u < n_live)
#pragma unroll
        for (int k = 0; k < kE; ++k) acc[k] = fmaf(mc[(c0 + u) * R + (tid + k * kThreads) / D], v[u][k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int e = tid + k * kThreads, r = e / D;
    if (r < nr) out[row_off(r) + e % D] = __float2bfloat16(acc[k] * inv[r]);
  }
}

template <int D, int R>
int launch_q8(const void* q, const void* cache, const void* scale, const void* bt, const void* lens,
              const void* q0, void* out, void* ws, void* tickets, int B, int S, int H, int Hk, int N, int Bs, int M,
              int layer, int Hp, int Sp, int chunk, int n_chunks, int row_groups, float sm_scale, float logit_cap,
              cudaStream_t stream) {
  if constexpr (R > q8::kRowsOf<D>) {
    return cudaErrorInvalidValue;
  } else {
    constexpr size_t kSmem = q8::Geometry<D, R>::kSmem;
    static const cudaError_t attr = allow_smem(decode_q8_kernel<D, R>, kSmem);  // once
    if (attr != cudaSuccess) return attr;
    decode_q8_kernel<D, R><<<dim3(Hk * row_groups, B, n_chunks), q8::kThreads, kSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(cache), static_cast<const float*>(scale),
        static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(q0),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(tickets), S, H, Hk, N, Bs, M,
        layer, Hp, Sp, chunk, row_groups, sm_scale, logit_cap);
    return cudaGetLastError();
  }
}

template <int D>
int launch_q8_rows(int rows, const void* q, const void* cache, const void* scale, const void* bt, const void* lens,
                   const void* q0, void* out, void* ws, void* tickets, int B, int S, int H, int Hk, int N, int Bs,
                   int M, int layer, int Hp, int Sp, int chunk, int n_chunks, int row_groups, float sm_scale,
                   float logit_cap, cudaStream_t stream) {
#define DYNAMO_DECODE_Q8_LAUNCH(R)                                                                                \
  return launch_q8<D, R>(q, cache, scale, bt, lens, q0, out, ws, tickets, B, S, H, Hk, N, Bs, M, layer, Hp, Sp, \
                         chunk, n_chunks, row_groups, sm_scale, logit_cap, stream)
  switch (rows) {
    case 4:
      DYNAMO_DECODE_Q8_LAUNCH(4);
    case 8:
      DYNAMO_DECODE_Q8_LAUNCH(8);
    case 16:
      DYNAMO_DECODE_Q8_LAUNCH(16);
    default:
      return cudaErrorInvalidValue;
  }
#undef DYNAMO_DECODE_Q8_LAUNCH
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
      return launch_rows<64>(q, cache, block_tables, seq_lens, q0_pos, out, workspace, B, S, H, Hk, N, Bs, M, layer,
                             split, sm_scale, logit_cap, st);
    case 128:
      return launch_rows<128>(q, cache, block_tables, seq_lens, q0_pos, out, workspace, B, S, H, Hk, N, Bs, M,
                              layer, split, sm_scale, logit_cap, st);
    case 256:
      return launch_rows<256>(q, cache, block_tables, seq_lens, q0_pos, out, workspace, B, S, H, Hk, N, Bs, M,
                              layer, split, sm_scale, logit_cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same over an int8 cache, in one launch: cache [L, N, 2, Bs, Hk*D]
// int8 and scale [L, N, 2, Hp, Sp] f32 (token-minor, tile-padded; the valid
// region is [:Hk, :Bs]).  The launch is the caller's plan
// (launch_geometry.cuh): `n_chunks` chunks of `chunk` tokens covering the
// table's M * Bs slots once (chunk a multiple of DYN_B4A_CHUNK, at most
// DYN_B4A_MAX_CHUNKS of them), and `row_groups` groups of `rows` (4, 8 or
// 16; at most DYN_B4A_ROWS_D<D>) covering the S * H / Hk query rows of a KV
// head once.  `workspace` holds B * Hk * row_groups * n_chunks * rows *
// (D + 2) floats and `tickets` B * Hk * row_groups zeroed ints, which the
// launch leaves zeroed.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not fit the shapes.
extern "C" int dynamo_decode_attention_q8(const void* q, const void* cache, const void* scale,
                                          const void* block_tables, const void* seq_lens, const void* q0_pos,
                                          void* out, void* workspace, void* tickets, int B, int S, int H, int Hk,
                                          int D, int N, int Bs, int M, int layer, int Hp, int Sp, int chunk,
                                          int n_chunks, int rows, int row_groups, float sm_scale, float logit_cap,
                                          void* stream) {
  using namespace dynamo;
  const long long width = (long long)M * Bs, q_rows = Hk > 0 ? (long long)S * (H / Hk) : 0;
  if (B < 1 || B > 65535 || S < 1 || Hk < 1 || H % Hk || M < 1 || Bs < 1 || chunk < DYN_B4A_CHUNK ||
      chunk % DYN_B4A_CHUNK || n_chunks < 1 || n_chunks > DYN_B4A_MAX_CHUNKS || (long long)n_chunks * chunk < width ||
      (long long)(n_chunks - 1) * chunk >= width || rows < 1 || row_groups < 1 ||
      (long long)row_groups * rows < q_rows || (long long)(row_groups - 1) * rows >= q_rows ||
      workspace == nullptr || tickets == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYNAMO_DECODE_Q8_DIM(DIM)                                                                                    \
  return launch_q8_rows<DIM>(rows, q, cache, scale, block_tables, seq_lens, q0_pos, out, workspace, tickets, B, S, H, \
                             Hk, N, Bs, M, layer, Hp, Sp, chunk, n_chunks, row_groups, sm_scale, logit_cap, st)
  switch (D) {
    case 64:
      DYNAMO_DECODE_Q8_DIM(64);
    case 128:
      DYNAMO_DECODE_Q8_DIM(128);
    case 256:
      DYNAMO_DECODE_Q8_DIM(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef DYNAMO_DECODE_Q8_DIM
}
