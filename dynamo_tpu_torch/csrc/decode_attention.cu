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
// One kernel serves both caches, a template over the cache's element type
// (decode_kernel<E, D, R>: E = __nv_bfloat16 for B1, int8_t for B4a), in
// one launch.  The context is split into chunks of `chunk` tokens (the
// caller's plan: a multiple of 64, the shortest that keeps a full table's
// grid within about two waves of blocks and a row at DYN_B4A_MAX_CHUNKS
// chunks), one block per (KV head, group of query rows, row, chunk), so a
// few rows of a few thousand tokens still put hundreds of blocks to work.
// The chunk is the grid's slowest axis: every row's first chunks are
// dispatched first, and the blocks past a row's context, dispatched last,
// exit at once.  A block's four warps each own
// every 4th 16-key tile of the chunk and keep their own online softmax (a
// 64-token chunk is one tile per warp, all four in flight at once); each
// warp streams its tiles through its own ring of raw cache rows (over an
// int8 cache, and their scales) with 16-byte cp.async (K rows swizzled so
// the score reads are conflict-free), so it needs only __syncwarp, never a
// block barrier, until its chunk is done.  Warps rather than mma.sync: at
// S = 1 a KV head's G query rows are a quarter of an m16 tile, the f32
// products of a 64-key chunk are a few hundred FMAs a thread, and the
// warps' partials merge in shared memory once.  In a tile, lane (key j,
// half h) computes key j's scores over half the head dims for every query
// row from f32 Q in shared memory (bf16 -> f32 is a shift; int8 -> f32
// exact, one PRMT and one FADD a value), the two halves meet in one
// shuffle, the softmax runs in base 2 over the 16 keys by shuffles, and P
// goes through shared memory to the P V product, where each lane owns
// D / 32 output columns.  Over an int8 cache the K scale multiplies the
// score before the softcap and P takes the V scale on its way to the
// product (the row sums take P unscaled).  Dead keys (past seq_len, or past
// a query's position) are masked; their rows (and scales) are zero-filled
// by the copies, never read, so NaN in a dead slot, its scale or a pad
// lane never reaches the output.
//
// The four warps' states merge in shared memory; a row's only chunk stores
// the output.  Otherwise each chunk stores its unnormalised partial (o, m,
// l) in the workspace and takes a ticket of its (row, KV head, row group);
// the last of the row's ceil(seq_len / chunk) chunks merges the partials
// in chunk order (the same bits on every run) and resets the ticket, so the
// tickets stay zeroed between launches: no memset, and the launch can be
// captured in a CUDA graph as it is.
#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {
namespace dec {
constexpr int kThreads = DYN_B4A_THREADS, kWarps = kThreads / 32;
constexpr int kKeys = DYN_B4A_KEYS, kMaxChunks = DYN_B4A_MAX_CHUNKS;
static_assert(kThreads == 128 && kKeys == 16 && DYN_B4A_CHUNK == kWarps * kKeys,
              "the lane roles below are written for 4 warps of 16-key tiles, one tile each per shortest chunk");

template <class E>
constexpr bool kQuant = std::is_same<E, int8_t>::value;

// query rows a block holds at most, by cache and head dim
template <class E, int D>
constexpr int kRowsOf = kQuant<E> ? (D == 64 ? DYN_B4A_ROWS_D64 : D == 128 ? DYN_B4A_ROWS_D128 : DYN_B4A_ROWS_D256)
                                  : (D == 64 ? DYN_B1_ROWS_D64 : D == 128 ? DYN_B1_ROWS_D128 : DYN_B1_ROWS_D256);

// A block of R query rows at head dim D over a cache of E.
template <class E, int D, int R>
struct Geometry {
  static constexpr int kStages = kQuant<E> ? DYN_B4A_STAGES : DYN_B1_STAGES;
  static constexpr int kRowBytes = D * (int)sizeof(E);         // a K or V row of one KV head
  static constexpr int kPieces = kRowBytes / 16;                // its 16-byte pieces
  static constexpr int kValues = 16 / (int)sizeof(E);           // values in a piece
  static constexpr int kSwizzle = (kPieces < 8 ? kPieces : 8) - 1;
  static constexpr int kStage = 2 * kKeys * kRowBytes;         // a tile's K rows, then its V rows
  static constexpr int kWarpRing = kStages * kStage;
  static constexpr int kQBytes = R * D * 4;                    // f32 Q rows
  static constexpr int kRingBytes = kWarps * kWarpRing;
  static constexpr int kScaleBytes = kQuant<E> ? kWarps * kStages * 2 * kKeys * 4 : 0;  // f32 K then V scales
  static constexpr int kPBytes = kWarps * R * kKeys * 4;       // each warp's P (times the V scale)
  static constexpr int kMergeBytes = (2 * kMaxChunks + 1) * R * 4;  // the chunks' m (then weights) and l, 1 / l
  static constexpr size_t kSmem =
      kQuant<E>
          ? (D == 64 ? (R == 4 ? DYN_B4A_SMEM_D64_R4 : R == 8 ? DYN_B4A_SMEM_D64_R8 : DYN_B4A_SMEM_D64_R16)
             : D == 128 ? (R == 4 ? DYN_B4A_SMEM_D128_R4 : R == 8 ? DYN_B4A_SMEM_D128_R8 : DYN_B4A_SMEM_D128_R16)
                        : (R == 4 ? DYN_B4A_SMEM_D256_R4 : DYN_B4A_SMEM_D256_R8))
          : (D == 64 ? (R == 4 ? DYN_B1_SMEM_D64_R4 : R == 8 ? DYN_B1_SMEM_D64_R8 : DYN_B1_SMEM_D64_R16)
             : D == 128 ? (R == 4 ? DYN_B1_SMEM_D128_R4 : R == 8 ? DYN_B1_SMEM_D128_R8 : DYN_B1_SMEM_D128_R16)
                        : (R == 4 ? DYN_B1_SMEM_D256_R4 : DYN_B1_SMEM_D256_R8));
  static_assert(R <= kRowsOf<E, D> && (R == 4 || R == 8 || R == 16), "4, 8 or 16 rows, at most DYN_B*_ROWS_D<D>");
  static_assert((size_t)kQBytes + kRingBytes + kScaleBytes + kPBytes + kMergeBytes + 16 == kSmem,
                "DYN_B4A_SMEM_D*_R* / DYN_B1_SMEM_D*_R* must be the shared memory this layout takes");
  static_assert(R * (D + 2) * 4 <= kWarpRing, "a warp's partial must fit its ring");
  static_assert(R * D % kThreads == 0, "the merge gives each thread whole output elements");
  static_assert(kPieces >= 4 && kPieces % 2 == 0, "each half of a lane pair reads whole pieces");
};

// Byte K of w ^ 0x80808080 as an exact f32 (-128 .. 127): 2^23 + 128 + v
// assembled in the bits, then the offset subtracted.
template <int K>
__device__ __forceinline__ float i8_to_f32(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | K)) - 8388736.f;
}

// The 32-bit word w of E values as f32: four int8 or two bf16 (a bf16 is
// the top half of its f32).
template <class E>
__device__ __forceinline__ void word_to_f32(uint32_t w, float* f) {
  if constexpr (kQuant<E>) {
    const uint32_t x = w ^ 0x80808080u;
    f[0] = i8_to_f32<0>(x);
    f[1] = i8_to_f32<1>(x);
    f[2] = i8_to_f32<2>(x);
    f[3] = i8_to_f32<3>(x);
  } else {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  }
}

// N values of E at p (N * sizeof(E) bytes, so aligned) as f32.
template <class E, int N>
__device__ __forceinline__ void load_f32(const uint8_t* p, float (&f)[N]) {
  constexpr int kBytes = N * (int)sizeof(E), kPerWord = 4 / (int)sizeof(E);
  if constexpr (kBytes == 2) {  // two int8
    const uint32_t x = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
    f[0] = i8_to_f32<0>(x);
    f[1] = i8_to_f32<1>(x);
  } else if constexpr (kBytes == 4) {
    word_to_f32<E>(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    word_to_f32<E>(w.x, f);
    word_to_f32<E>(w.y, f + kPerWord);
  } else {
    static_assert(kBytes == 16, "2 to 16 bytes");
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    word_to_f32<E>(w.x, f);
    word_to_f32<E>(w.y, f + kPerWord);
    word_to_f32<E>(w.z, f + 2 * kPerWord);
    word_to_f32<E>(w.w, f + 3 * kPerWord);
  }
}
}  // namespace dec

// Block (KV head x row group, row b, chunk c) of the decode kernel: query
// rows r0 .. r0 + R - 1 of the row's S * G (R = 4, 8 or 16; the plan's row
// groups cover them), keys [c * chunk, (c + 1) * chunk) of its context.
// `ws` holds a partial of R * (D + 2) floats per (row, KV head, row group,
// chunk); `tickets` one zeroed int per (row, KV head, row group).  `scale`,
// Hp and Sp are read over an int8 cache only.
template <class E, int D, int R>
__global__ void __launch_bounds__(dec::kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q, const E* __restrict__ cache, const float* __restrict__ scale,
              const int* __restrict__ block_tables, const int* __restrict__ seq_lens, const int* __restrict__ q0_pos,
              __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int* __restrict__ tickets, int S, int H,
              int Hk, int N, int Bs, int M, int layer, int Hp, int Sp, int chunk, int row_groups, float sm_scale,
              float logit_cap) {
  using namespace hopper;
  using G = dec::Geometry<E, D, R>;
  using dec::kKeys;
  using dec::kThreads;
  using dec::kWarps;
  constexpr bool kQuant = dec::kQuant<E>;
  constexpr int kStages = G::kStages;
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

  extern __shared__ float4 smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(smem_raw);
  float* qs = reinterpret_cast<float*>(base);  // [R][D], times the score scale
  uint8_t* ring = base + G::kQBytes + warp * G::kWarpRing;  // this warp's
  float* scl = reinterpret_cast<float*>(base + G::kQBytes + G::kRingBytes) + warp * kStages * 2 * kKeys;
  float* pw = reinterpret_cast<float*>(base + G::kQBytes + G::kRingBytes + G::kScaleBytes) + warp * R * kKeys;
  float* merge = reinterpret_cast<float*>(base + G::kQBytes + G::kRingBytes + G::kScaleBytes + G::kPBytes);
  int* flag = reinterpret_cast<int*>(merge + (2 * dec::kMaxChunks + 1) * R);

  const int c0 = c * chunk, c1 = min(c0 + chunk, ctx);
  const int n_tiles = (c1 - c0 + kKeys - 1) / kKeys;
  const int n_mine = warp < n_tiles ? (n_tiles - 1 - warp) / kWarps + 1 : 0;  // tiles warp, warp + 4, ...
  const int* table = block_tables + (size_t)b * M;
  const int last_block = (ctx - 1) / Bs, hkd = Hk * D;
  const long long v_off = (long long)Bs * hkd;  // a slot's V row after its K row

  // this warp's k-th tile into stage k % kStages.  Lane l finds key
  // (l % 16)'s block once; the copies take each key's K row offset from
  // its lane by a shuffle.  Lanes copy 16-byte pieces of the K rows (piece
  // p of key j at slot p ^ (j & kSwizzle)) and V rows, then, over an int8
  // cache, key (l % 16)'s K (l < 16) or V scale; dead keys (past the
  // chunk's context) are zero-filled, not read
  auto issue = [&](int k) {
    const int t0 = c0 + (warp + k * kWarps) * kKeys;
    uint8_t* st = ring + (k % kStages) * G::kStage;
    const int pos = t0 + (lane & 15);
    const bool live = pos < c1;
    const int bid = live ? min(max(table[min(pos / Bs, last_block)], 0), N - 1) : 0, slot = pos % Bs;
    const long long k_row = live ? (((long long)layer * N + bid) * 2 * Bs + slot) * hkd + (long long)head * D : -1;
#pragma unroll
    for (int i = 0; i < G::kPieces; ++i) {  // 2 * kKeys * kPieces pieces, 32 a round
      const int pc = lane + 32 * i, kv = pc / (kKeys * G::kPieces), j = pc / G::kPieces % kKeys;
      const int p = pc % G::kPieces;
      const long long row = __shfl_sync(0xffffffffu, k_row, j);
      const E* src = row >= 0 ? cache + row + (kv ? v_off : 0) + p * G::kValues : cache;
      const int dst = kv ? (kKeys + j) * G::kRowBytes + p * 16 : j * G::kRowBytes + ((p ^ (j & G::kSwizzle)) << 4);
      cp_async_16(smem_u32(st + dst), src, row >= 0 ? 16 : 0);
    }
    if constexpr (kQuant) {
      const float* src = scale;
      if (live) src = scale + ((((size_t)layer * N + bid) * 2 + (lane >> 4)) * Hp + head) * Sp + slot;
      cp_async_4(smem_u32(scl + (k % kStages) * 2 * kKeys + lane), src, live ? 4 : 0);
    }
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
    float f[8];
    dec::word_to_f32<__nv_bfloat16>(raw.x, f);
    dec::word_to_f32<__nv_bfloat16>(raw.y, f + 2);
    dec::word_to_f32<__nv_bfloat16>(raw.z, f + 4);
    dec::word_to_f32<__nv_bfloat16>(raw.w, f + 6);
    float4* dst = reinterpret_cast<float4*>(qs + r * D + part * 8);
    dst[0] = make_float4(f[0] * qk_scale, f[1] * qk_scale, f[2] * qk_scale, f[3] * qk_scale);
    dst[1] = make_float4(f[4] * qk_scale, f[5] * qk_scale, f[6] * qk_scale, f[7] * qk_scale);
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
    const uint8_t* sk = ring + (k % kStages) * G::kStage;
    const uint8_t* sv = sk + kKeys * G::kRowBytes;
    const int t = c0 + (warp + k * kWarps) * kKeys + j;  // this lane's key

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < G::kPieces / 2; ++i) {
      const int p = hf * (G::kPieces / 2) + i;
      float kf[G::kValues];
      dec::load_f32<E>(sk + j * G::kRowBytes + ((p ^ (j & G::kSwizzle)) << 4), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(qs + r * D + p * G::kValues);
        float a = s[r];
#pragma unroll
        for (int v = 0; v < G::kValues / 4; ++v) {
          const float4 x = qr[v];
          a = fmaf(x.x, kf[4 * v], a);
          a = fmaf(x.y, kf[4 * v + 1], a);
          a = fmaf(x.z, kf[4 * v + 2], a);
          a = fmaf(x.w, kf[4 * v + 3], a);
        }
        s[r] = a;
      }
    }
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      const float* ss = scl + (k % kStages) * 2 * kKeys;
      ks = ss[j];
      vs = ss[kKeys + j];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = s[r] + __shfl_xor_sync(0xffffffffu, s[r], 16);
      if constexpr (kQuant) x *= ks;  // the K scale before the softcap
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
      if (hf == 0) pw[r * kKeys + j] = kQuant ? pr * vs : pr;  // the V scale on P only
    }
    __syncwarp();
    // O += P V: lane owns columns lane * kCols .. + kCols - 1 of every row
#pragma unroll
    for (int jj = 0; jj < kKeys; jj += 4) {
      float vf[4][kCols];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        dec::load_f32<E>(sv + (jj + kk) * G::kRowBytes + lane * kCols * (int)sizeof(E), vf[kk]);
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
  float* mc = merge;  // [n_live][R]
  float* lc = merge + dec::kMaxChunks * R;
  float* inv = lc + dec::kMaxChunks * R;  // [R]
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
  for (int cb = 0; cb < n_live; cb += kU) {
    float v[kU][kE];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int k = 0; k < kE; ++k)
        v[u][k] = cb + u < n_live ? __ldcg(parts + (size_t)(cb + u) * kPart + tid + k * kThreads) : 0.f;
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (cb + u < n_live)
#pragma unroll
        for (int k = 0; k < kE; ++k) acc[k] = fmaf(mc[(cb + u) * R + (tid + k * kThreads) / D], v[u][k], acc[k]);
  }
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int e = tid + k * kThreads, r = e / D;
    if (r < nr) out[row_off(r) + e % D] = __float2bfloat16(acc[k] * inv[r]);
  }
}

template <class E, int D, int R>
int launch(const void* q, const void* cache, const void* scale, const void* bt, const void* lens, const void* q0,
           void* out, void* ws, void* tickets, int B, int S, int H, int Hk, int N, int Bs, int M, int layer, int Hp,
           int Sp, int chunk, int n_chunks, int row_groups, float sm_scale, float logit_cap, cudaStream_t stream) {
  if constexpr (R > dec::kRowsOf<E, D>) {
    return cudaErrorInvalidValue;
  } else {
    constexpr size_t kSmem = dec::Geometry<E, D, R>::kSmem;
    static const cudaError_t attr = allow_smem(decode_kernel<E, D, R>, kSmem);  // once
    if (attr != cudaSuccess) return attr;
    decode_kernel<E, D, R><<<dim3(Hk * row_groups, B, n_chunks), dec::kThreads, kSmem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const E*>(cache), static_cast<const float*>(scale),
        static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(q0),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(tickets), S, H, Hk, N, Bs, M,
        layer, Hp, Sp, chunk, row_groups, sm_scale, logit_cap);
    return cudaGetLastError();
  }
}

// The plan's launch over a cache of E, after checking that it fits the
// shapes (see dynamo_decode_attention below).
template <class E>
int launch_plan(const void* q, const void* cache, const void* scale, const void* bt, const void* lens,
                const void* q0, void* out, void* ws, void* tickets, int B, int S, int H, int Hk, int D, int N, int Bs,
                int M, int layer, int Hp, int Sp, int chunk, int n_chunks, int rows, int row_groups, float sm_scale,
                float logit_cap, void* stream) {
  const long long width = (long long)M * Bs, q_rows = Hk > 0 ? (long long)S * (H / Hk) : 0;
  if (B < 1 || B > 65535 || S < 1 || Hk < 1 || H % Hk || M < 1 || Bs < 1 || chunk < DYN_B4A_CHUNK ||
      chunk % DYN_B4A_CHUNK || n_chunks < 1 || n_chunks > DYN_B4A_MAX_CHUNKS || (long long)n_chunks * chunk < width ||
      (long long)(n_chunks - 1) * chunk >= width || rows < 1 || row_groups < 1 ||
      (long long)row_groups * rows < q_rows || (long long)(row_groups - 1) * rows >= q_rows ||
      ws == nullptr || tickets == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYNAMO_DECODE_LAUNCH(DIM, R)                                                                              \
  return launch<E, DIM, R>(q, cache, scale, bt, lens, q0, out, ws, tickets, B, S, H, Hk, N, Bs, M, layer, Hp, Sp, \
                           chunk, n_chunks, row_groups, sm_scale, logit_cap, st)
#define DYNAMO_DECODE_ROWS(DIM)     \
  switch (rows) {                   \
    case 4:                         \
      DYNAMO_DECODE_LAUNCH(DIM, 4); \
    case 8:                         \
      DYNAMO_DECODE_LAUNCH(DIM, 8); \
    case 16:                        \
      DYNAMO_DECODE_LAUNCH(DIM, 16); \
    default:                        \
      return cudaErrorInvalidValue; \
  }
  switch (D) {
    case 64:
      DYNAMO_DECODE_ROWS(64);
    case 128:
      DYNAMO_DECODE_ROWS(128);
    case 256:
      DYNAMO_DECODE_ROWS(256);
    default:
      return cudaErrorInvalidValue;
  }
#undef DYNAMO_DECODE_ROWS
#undef DYNAMO_DECODE_LAUNCH
}

}  // namespace
}  // namespace dynamo

// q [B, S, H, D] bf16; cache [L, N, 2, Bs, Hk*D] bf16; block_tables [B, M]
// int32; seq_lens, q0_pos [B] int32; out [B, S, H, D] bf16.  The launch is
// the caller's plan (launch_geometry.cuh): `n_chunks` chunks of `chunk`
// tokens covering the table's M * Bs slots once (chunk a multiple of
// DYN_B4A_CHUNK, at most DYN_B4A_MAX_CHUNKS of them), and `row_groups`
// groups of `rows` (4, 8 or 16; at most DYN_B1_ROWS_D<D>) covering the
// S * H / Hk query rows of a KV head once.  `workspace` holds B * Hk *
// row_groups * n_chunks * rows * (D + 2) floats and `tickets` B * Hk *
// row_groups zeroed ints, which the launch leaves zeroed.  logit_cap <= 0
// turns the softcap off.  Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for a plan that does not fit the shapes.
extern "C" int dynamo_decode_attention(const void* q, const void* cache, const void* block_tables,
                                       const void* seq_lens, const void* q0_pos, void* out, void* workspace,
                                       void* tickets, int B, int S, int H, int Hk, int D, int N, int Bs, int M,
                                       int layer, int chunk, int n_chunks, int rows, int row_groups, float sm_scale,
                                       float logit_cap, void* stream) {
  return dynamo::launch_plan<__nv_bfloat16>(q, cache, nullptr, block_tables, seq_lens, q0_pos, out, workspace,
                                            tickets, B, S, H, Hk, D, N, Bs, M, layer, 0, 0, chunk, n_chunks, rows,
                                            row_groups, sm_scale, logit_cap, stream);
}

// The same over an int8 cache: cache [L, N, 2, Bs, Hk*D] int8 and scale
// [L, N, 2, Hp, Sp] f32 (token-minor, tile-padded; the valid region is
// [:Hk, :Bs]); at most DYN_B4A_ROWS_D<D> rows a group.
extern "C" int dynamo_decode_attention_q8(const void* q, const void* cache, const void* scale,
                                          const void* block_tables, const void* seq_lens, const void* q0_pos,
                                          void* out, void* workspace, void* tickets, int B, int S, int H, int Hk,
                                          int D, int N, int Bs, int M, int layer, int Hp, int Sp, int chunk,
                                          int n_chunks, int rows, int row_groups, float sm_scale, float logit_cap,
                                          void* stream) {
  return dynamo::launch_plan<int8_t>(q, cache, scale, block_tables, seq_lens, q0_pos, out, workspace, tickets, B, S,
                                     H, Hk, D, N, Bs, M, layer, Hp, Sp, chunk, n_chunks, rows, row_groups, sm_scale,
                                     logit_cap, stream);
}
