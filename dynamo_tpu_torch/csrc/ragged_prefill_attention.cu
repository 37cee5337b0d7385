// Ragged (token-budget) paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py,
// ragged_paged_prefill_attention, both of its bodies: bf16 (_ragged_kernel
// -> _ragged_kernel_impl) and int8 (_ragged_kernel_quant, over a
// QuantKvCache: int8 prefix payload plus per-(token, KV head) f32 scales,
// fresh K/V bf16, a decode row's own token included).  One flat axis of T
// tokens packs R rows; row r owns the real tokens [row_offsets[r],
// row_offsets[r] + seq_lens[r] - starts[r]).  A row is a prefill span or a
// 1-token decode row whose start (context - 1) need not be block-aligned.
// Each token attends its own row's cached prefix [0, starts[r]), streamed
// from the paged cache [L, N, 2, Bs, Hk*D] at a runtime layer index, and its
// own row's fresh tokens causally by flat index.  It never sees another row.
// Tokens in no span (padding) and rows with an empty span come out exactly
// 0.  GQA, optional tanh softcap.
//
// What bounds it on this card: a prefill span of a few hundred tokens is
// bound by tensor-core flops, 4 * H * D * (visible (query, key) pairs) /
// 989 TFLOP/s (bf16); decode rows are bound by the bytes of their prefix.
//
// What the design does about that: B2's warpgroup tile
// (wgmma_attention.cuh: wgmma for both products, Q and P in registers, a
// producer warpgroup feeding a 3-stage cp.async ring on mbarriers, masks
// only on tiles that cross a boundary), with a schedule per block instead
// of B2's prefix-then-fresh walk.  One launch holds two kinds of block:
//   - span blocks, one per (KV head, flat tile of TQ = 128 / G tokens),
//     the last tiles first.  A block finds the rows its tokens overlap from
//     the span table once, in shared memory (RaggedTable), and walks, for
//     each overlapping span row with a cached prefix, that row's prefix
//     tiles, then the fresh keys from the earliest overlapping span's first
//     token to the block's last live token.  Each consumer thread row
//     carries its own row: a prefix tile is masked to that row below its
//     start, a fresh tile to the same row and causal.  A warpgroup with no
//     query row in a prefix tile's row, or wholly before a fresh tile, only
//     waits on the tile and frees it; a tile needs no mask when one row
//     covers all of the warpgroup's tokens and the tile crosses neither its
//     start nor the diagonal.  Decode rows' tokens are in no span block's
//     schedule: their keys are dead there and their outputs are not written;
//   - decode-row blocks, one per (KV head, row), launched first.  A block
//     whose row has exactly one fresh token computes that row's G query rows
//     (in both consumer warpgroups) over its prefix and its own token; the
//     two warpgroups take the tiles in turn and merge their softmax states
//     through shared memory, so the row's prefix is read once, by a block
//     that computes only its G rows.  Other rows' decode blocks exit.
// Dead keys (past a row's start in the prefix, padding, decode tokens and
// keys past the block in the fresh axis) are zero-filled by the copies, so
// NaN in the pool or in padding K/V never reaches a live lane; each row's
// table walk reads only its own blocks, below its start.  Over an int8
// cache the producer copies the int8 rows and their scales (zero for dead
// slots) and converts the rows to bf16 into the swizzled tile; the scores
// take the K scale before the softcap and P V the V scale (the row sums do
// not).
#include <limits.h>

#include <type_traits>

#include "wgmma_attention.cuh"

namespace dynamo {
namespace {

// A span block's row table, built once in shared memory.
struct RaggedTable {
  int ov_row[wg::kRows], ov_off[wg::kRows], ov_len[wg::kRows], ov_start[wg::kRows];  // overlapping rows
  int tok_row[wg::kRows];  // each block token's overlapping row: >= 0 a span row, -1 padding, -2 a decode row
  int pre_k[wg::kRows];    // the span rows with a cached prefix, in schedule order (indices into ov_*)
  int pre_end[wg::kRows];  // one past each one's last prefix tile
  int n_ov, n_pre, lo, key_end, n_tiles;
  // per consumer warpgroup: its first and last token, its last live token
  // (-1 none), the first live token's row start, the row covering all its
  // tokens (an ov_* index; -1 none)
  int wg_tok0[2], wg_tok1[2], wg_last[2], wg_lo[2], wg_cover[2];
};
static_assert(sizeof(RaggedTable) == DYN_B3_TABLE, "DYN_B3_TABLE must be the row table's size");

template <int D, bool kQuant>
struct RaggedGeometry {
  using G = wg::Geometry<D>;
  static constexpr int kStage8 = kQuant ? wg::kStages * G::kStage8 : 0;       // int8 K/V staging
  static constexpr int kScales = kQuant ? 2 * wg::kStages * 2 * G::kKeys * 4 : 0;  // f32 scales, two rings
  static constexpr int kBarriers = 2 * wg::kStages * 8;
  static constexpr size_t kSmem =
      kQuant ? (D == 64 ? DYN_B3_Q8_SMEM_D64 : D == 128 ? DYN_B3_Q8_SMEM_D128 : DYN_B3_Q8_SMEM_D256)
             : (D == 64 ? DYN_B3_SMEM_D64 : D == 128 ? DYN_B3_SMEM_D128 : DYN_B3_SMEM_D256);
  static_assert(DYN_B3_ROWS == wg::kRows && DYN_B3_THREADS == wg::kThreads && DYN_B3_STAGES == wg::kStages &&
                    G::kKeys == (D == 64 ? DYN_B3_KEYS_D64 : D == 128 ? DYN_B3_KEYS_D128 : DYN_B3_KEYS_D256),
                "the ragged kernel runs on B2's tile: DYN_B3_* must match it");
  static_assert(DYN_B3_DECODE_ROWS == wg::kRows / 2, "a decode-row block holds G <= 64 rows per warpgroup");
  static_assert(1024 + (size_t)G::kQBytes + G::kRing + kStage8 + kScales + kBarriers + sizeof(RaggedTable) == kSmem,
                "DYN_B3_*SMEM_D* must be the shared memory this layout takes");
};

// A block's schedule (see wgmma_attention.cuh): a span block's, read from
// its RaggedTable, or a decode-row block's.
template <int D>
struct RaggedSched {
  static constexpr int kKeys = wg::Geometry<D>::kKeys;
  static constexpr int kWgRows = DYN_B3_DECODE_ROWS;  // a decode block's G rows sit in each warpgroup
  const RaggedTable* tb;
  bool decode;
  int head, group, H, T, n_tiles;
  size_t fresh_base;
  int i0, rows;            // span block: its first token and its rows (tq * group)
  int r, start, off, n_pre;  // decode block: the row, its start, its token, its prefix tiles

  __device__ KvTile tile(int it) const {
    if (decode) return it < n_pre ? KvTile{it * kKeys, r, start, 0} : KvTile{off, -1, 0, 0};
    int k = 0;
    while (k < tb->n_pre && it >= tb->pre_end[k]) ++k;
    if (k < tb->n_pre) {
      const int e = tb->pre_k[k];
      return KvTile{(it - (k ? tb->pre_end[k - 1] : 0)) * kKeys, tb->ov_row[e], tb->ov_start[e], e};
    }
    return KvTile{tb->lo + (it - (tb->n_pre ? tb->pre_end[tb->n_pre - 1] : 0)) * kKeys, -1, 0, 0};
  }
  // fresh keys are live up to the block's last live token, and only span
  // rows' tokens (keys before the block are the earliest span's)
  __device__ bool fresh_live(int key) const {
    if (decode) return key == off;
    return key < tb->key_end && (key < i0 || tb->tok_row[key - i0] >= 0);
  }
  __device__ bool active(int it, const KvTile& t, int wgi) const {
    if (decode) return (it & 1) == wgi;
    if (tb->wg_last[wgi] < 0) return false;
    if (t.row >= 0)  // the row has a token among the warpgroup's
      return tb->ov_off[t.entry] <= tb->wg_tok1[wgi] && tb->ov_off[t.entry] + tb->ov_len[t.entry] > tb->wg_tok0[wgi];
    return t.t0 <= tb->wg_last[wgi] && t.t0 + kKeys > tb->wg_lo[wgi];
  }
  __device__ bool masked(int, const KvTile& t, int wgi) const {
    if (decode) return t.row < 0 || t.t0 + kKeys > t.start;
    const int c = tb->wg_cover[wgi];
    if (t.row >= 0) return t.t0 + kKeys > t.start || c < 0 || tb->ov_row[c] != t.row;
    return c < 0 || t.t0 < tb->ov_off[c] || t.t0 + kKeys - 1 > tb->wg_tok0[wgi];
  }
  __device__ ThreadRow thread_row(int row) const {
    if (decode) return row % kWgRows < group ? ThreadRow{r, off, off} : ThreadRow{-1, INT_MAX, -1};
    const int x = row / group;
    const int e = row < rows && i0 + x < T ? tb->tok_row[x] : -1;
    return e >= 0 ? ThreadRow{tb->ov_row[e], tb->ov_off[e], i0 + x} : ThreadRow{-1, INT_MAX, -1};
  }
  // block row `row` = (token, query head head * group + row % group); a
  // decode block's two warpgroups hold the same G rows
  __device__ long row_offset(int row) const {
    if (decode) return row % kWgRows < group ? ((long)off * H + (long)head * group + row % kWgRows) * D : -1;
    const int tok = i0 + row / group;
    if (row >= rows || tok >= T || tb->tok_row[row / group] == -2) return -1;
    return ((long)tok * H + (long)head * group + row % group) * D;
  }
  __device__ bool row_live(int row) const { return decode || tb->tok_row[row / group] >= 0; }
};

// The span block's row table and schedule, by all threads.
__device__ void build_table(RaggedTable* tb, int i0, int tq, int group, int rows, int T, int R, int keys,
                            const int* __restrict__ seq_lens, const int* __restrict__ starts,
                            const int* __restrict__ row_offsets) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int blk_end = min(i0 + tq, T);
  if (tid < 32) {  // the rows whose tokens overlap the block, 32 at a time
    int n = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      int st = 0, off = 0, len = 0;
      if (r < R) {
        st = starts[r];
        off = row_offsets[r];
        len = seq_lens[r] - st;
      }
      const bool ov = r < R && len > 0 && off < blk_end && off + len > i0;
      const unsigned bal = __ballot_sync(0xffffffffu, ov);
      const int k = n + __popc(bal & ((1u << lane) - 1));
      if (ov && k < wg::kRows) {
        tb->ov_row[k] = r;
        tb->ov_off[k] = off;
        tb->ov_len[k] = len;
        tb->ov_start[k] = st;
      }
      n += __popc(bal);
    }
    if (lane == 0) tb->n_ov = min(n, wg::kRows);
  }
  __syncthreads();
  const int n_ov = tb->n_ov;
  for (int x = tid; x < tq; x += blockDim.x) {
    const int tok = i0 + x;
    int e = -1;
    for (int k = 0; k < n_ov; ++k)
      if (tok >= tb->ov_off[k] && tok < tb->ov_off[k] + tb->ov_len[k]) e = tb->ov_len[k] > 1 ? k : -2;
    tb->tok_row[x] = e;
  }
  if (tid == 0) {  // each span row's prefix tiles, then the fresh tiles
    int lo = blk_end, key_end = 0, n_pre = 0, tiles = 0;
    for (int k = 0; k < n_ov; ++k) {
      if (tb->ov_len[k] < 2) continue;
      lo = min(lo, tb->ov_off[k]);
      key_end = max(key_end, min(tb->ov_off[k] + tb->ov_len[k], blk_end));
      if (tb->ov_start[k] > 0) {
        tiles += (tb->ov_start[k] + keys - 1) / keys;
        tb->pre_k[n_pre] = k;
        tb->pre_end[n_pre++] = tiles;
      }
    }
    tb->n_pre = n_pre;
    tb->lo = lo;
    tb->key_end = key_end;
    tb->n_tiles = key_end > lo ? tiles + (key_end - lo + keys - 1) / keys : 0;
  }
  __syncthreads();
  if (tid < 2) {  // warpgroup tid's tokens x0 .. x1 of the block
    const int r1 = min(tid * 64 + 63, rows - 1);
    const int x0 = tid * 64 / group, x1 = tid * 64 > r1 ? x0 - 1 : min(r1 / group, blk_end - 1 - i0);
    int last = -1, lo = 0;
    for (int x = x0; x <= x1; ++x) {
      if (tb->tok_row[x] < 0) continue;
      if (last < 0) lo = tb->ov_off[tb->tok_row[x]];
      last = i0 + x;
    }
    tb->wg_tok0[tid] = i0 + x0;
    tb->wg_tok1[tid] = i0 + x1;
    tb->wg_last[tid] = last;
    tb->wg_lo[tid] = lo;
    // spans are contiguous: one row at both ends holds every token between
    tb->wg_cover[tid] = x1 >= x0 && tb->tok_row[x0] >= 0 && tb->tok_row[x0] == tb->tok_row[x1] ? tb->tok_row[x0] : -1;
  }
  __syncthreads();
}

// E is the cache's element type: __nv_bfloat16, or int8_t with `scale` the
// int8 cache's scale pool [L, N, 2, Hp, Sp] (unused for bf16).  Grid
// (Hk, R + span blocks): y < R is row y's decode-row block, the rest span
// blocks, the last flat tile first.
template <int D, class E>
__global__ void __launch_bounds__(wg::kThreads, 1)
ragged_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
              const __nv_bfloat16* __restrict__ v_new, const E* __restrict__ cache, const float* __restrict__ scale,
              const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
              const int* __restrict__ starts, const int* __restrict__ row_offsets, __nv_bfloat16* __restrict__ out,
              int T, int H, int Hk, int N, int Bs, int M, int R, int layer, int Hp, int Sp, int tq, float sm_scale,
              float logit_cap) {
  using namespace hopper;
  constexpr bool kQuant = !std::is_same<E, __nv_bfloat16>::value;
  using G = wg::Geometry<D>;
  using RG = RaggedGeometry<D, kQuant>;
  // setmaxnreg, 128 x producer + 256 x consumer <= 384 x 168: the int8
  // producer converts, and the D = 256 consumer holds 128 accumulators
  constexpr int kProducerRegs = kQuant ? (D == 64 ? 72 : D == 128 ? 80 : 64) : (D == 256 ? 48 : 64);
  constexpr int kConsumerRegs = kQuant ? (D == 256 ? 216 : 208) : (D == 256 ? 224 : 216);
  static_assert(128 * kProducerRegs + 256 * kConsumerRegs <= 384 * 168, "registers the block does not hold");

  extern __shared__ uint4 smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = smem;
  uint8_t* ring = qs + G::kQBytes;
  int8_t* stage8 = reinterpret_cast<int8_t*>(ring + G::kRing);
  float* scales = reinterpret_cast<float*>(ring + G::kRing + RG::kStage8);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::kRing + RG::kStage8 + RG::kScales);
  uint64_t* empty = full + wg::kStages;
  RaggedTable* tb = reinterpret_cast<RaggedTable*>(empty + wg::kStages);

  const int tid = threadIdx.x, y = blockIdx.y;
  RaggedSched<D> rs;
  rs.tb = tb;
  rs.head = blockIdx.x;
  rs.group = H / Hk;
  rs.H = H;
  rs.T = T;
  rs.fresh_base = 0;
  if (y < R) {
    rs.decode = true;
    rs.r = y;
    rs.start = starts[y];
    rs.off = row_offsets[y];
    if (seq_lens[y] - rs.start != 1) return;  // not a decode row
    rs.n_pre = (rs.start + G::kKeys - 1) / G::kKeys;
    rs.n_tiles = rs.n_pre + 1;
  } else {
    rs.decode = false;
    rs.i0 = (gridDim.y - 1 - y) * tq;
    rs.rows = tq * rs.group;
    build_table(tb, rs.i0, tq, rs.group, rs.rows, T, R, G::kKeys, seq_lens, starts, row_offsets);
    rs.n_tiles = tb->n_tiles;
    if (rs.n_tiles == 0) {  // no span row: padding tokens are 0, nothing to read
      if (tid < 256) {
        const float zo[D / 2] = {}, zl[2] = {};
        store_rows<D>(rs, out, zo, zl);
      }
      return;
    }
  }

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
      produce_q8<D>(rs, ring, stage8, scales, full, empty, k_new, v_new, cache, scale, block_tables, Hk, N, Bs, M,
                    layer, Hp, Sp, tid - 256);
    else
      produce<D>(rs, ring, full, empty, k_new, v_new, cache, block_tables, Hk, N, Bs, M, layer, tid - 256);
    return;
  }
  regs_alloc<kConsumerRegs>();
  float o[D / 2], l[2] = {0.f, 0.f}, m[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  consume<D, kQuant>(rs, qs, ring, scales, full, empty, q, sm_scale, logit_cap, o, l, m);
  if (rs.decode) {
    // warpgroup 1 hands its state to the thread of warpgroup 0 that holds
    // the same rows and columns, through the ring (both are done with it)
    float* xch = reinterpret_cast<float*>(ring) + (tid & 127) * (D / 2 + 4);
    named_sync(2, 256);
    if (tid >= 128) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xch[i] = o[i];
      xch[D / 2] = m[0];
      xch[D / 2 + 1] = m[1];
      xch[D / 2 + 2] = l[0];
      xch[D / 2 + 3] = l[1];
    }
    named_sync(3, 256);
    if (tid >= 128) return;
    float a[2], b[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = xch[D / 2 + h], mm = fmaxf(m[h], m1);
      a[h] = m[h] == -INFINITY ? 0.f : exp2f(m[h] - mm);
      b[h] = m1 == -INFINITY ? 0.f : exp2f(m1 - mm);
      l[h] = l[h] * a[h] + xch[D / 2 + 2 + h] * b[h];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = o[i] * a[(i >> 1) & 1] + xch[i] * b[(i >> 1) & 1];
  }
  store_rows<D>(rs, out, o, l);
}

template <int D, class E>
int launch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* scale, const void* bt,
           const void* lens, const void* starts, const void* roff, void* out, int T, int H, int Hk, int N, int Bs,
           int M, int R, int layer, int Hp, int Sp, int tq, int span_blocks, float sm_scale, float logit_cap,
           cudaStream_t stream) {
  constexpr size_t kSmem = RaggedGeometry<D, !std::is_same<E, __nv_bfloat16>::value>::kSmem;
  static const cudaError_t attr = allow_smem(ragged_kernel<D, E>, kSmem);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  ragged_kernel<D, E><<<dim3(Hk, R + span_blocks), wg::kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const E*>(cache), static_cast<const float*>(scale),
      static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(starts),
      static_cast<const int*>(roff), static_cast<__nv_bfloat16*>(out), T, H, Hk, N, Bs, M, R, layer, Hp, Sp, tq,
      sm_scale, logit_cap);
  return cudaGetLastError();
}

template <class E>
int dispatch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* scale,
             const void* bt, const void* lens, const void* starts, const void* roff, void* out, int T, int H, int Hk,
             int D, int N, int Bs, int M, int R, int layer, int Hp, int Sp, int tq, int span_blocks, float sm_scale,
             float logit_cap, void* stream) {
  // the plan must fit a block's rows, cover the T tokens once and fit the grid
  if (T < 1 || Hk < 1 || H % Hk || H / Hk > DYN_B3_DECODE_ROWS || R < 1 || tq < 1 ||
      (long long)tq * (H / Hk) > wg::kRows ||
      (long long)span_blocks * tq < T || (long long)(span_blocks - 1) * tq >= T || R + span_blocks > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64, E>(q, k_new, v_new, cache, scale, bt, lens, starts, roff, out, T, H, Hk, N, Bs, M, R, layer,
                           Hp, Sp, tq, span_blocks, sm_scale, logit_cap, st);
    case 128:
      return launch<128, E>(q, k_new, v_new, cache, scale, bt, lens, starts, roff, out, T, H, Hk, N, Bs, M, R, layer,
                            Hp, Sp, tq, span_blocks, sm_scale, logit_cap, st);
    case 256:
      return launch<256, E>(q, k_new, v_new, cache, scale, bt, lens, starts, roff, out, T, H, Hk, N, Bs, M, R, layer,
                            Hp, Sp, tq, span_blocks, sm_scale, logit_cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dynamo

// q [1, T, H, D], k_new, v_new [1, T, Hk, D] bf16; cache [L, N, 2, Bs, Hk*D]
// bf16; block_tables [R, M], seq_lens, starts, row_offsets [R] int32;
// out [1, T, H, D] bf16.  All 16-byte aligned.  logit_cap <= 0 turns the
// softcap off.  The launch is the caller's plan (launch_geometry.cuh): `tq`
// flat tokens per span block (times the H / Hk query heads of its KV head,
// which must fit a block's rows) and `span_blocks` of them covering T once,
// beside one decode-row block per row.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not fit
// the shapes.
extern "C" int dynamo_ragged_prefill_attention(const void* q, const void* k_new, const void* v_new,
                                               const void* cache, const void* block_tables,
                                               const void* seq_lens, const void* starts,
                                               const void* row_offsets, void* out, int T, int H, int Hk,
                                               int D, int N, int Bs, int M, int R, int layer, int tq,
                                               int span_blocks, float sm_scale, float logit_cap, void* stream) {
  return dynamo::dispatch<__nv_bfloat16>(q, k_new, v_new, cache, nullptr, block_tables, seq_lens, starts,
                                         row_offsets, out, T, H, Hk, D, N, Bs, M, R, layer, 0, 0, tq, span_blocks,
                                         sm_scale, logit_cap, stream);
}

// The same over an int8 cache: cache [L, N, 2, Bs, Hk*D] int8 and scale
// [L, N, 2, Hp, Sp] f32 (token-minor, tile-padded; the valid region is
// [:Hk, :Bs]).  The other arguments as above.
extern "C" int dynamo_ragged_prefill_attention_q8(const void* q, const void* k_new, const void* v_new,
                                                  const void* cache, const void* scale, const void* block_tables,
                                                  const void* seq_lens, const void* starts,
                                                  const void* row_offsets, void* out, int T, int H, int Hk,
                                                  int D, int N, int Bs, int M, int R, int layer, int Hp, int Sp,
                                                  int tq, int span_blocks, float sm_scale, float logit_cap,
                                                  void* stream) {
  return dynamo::dispatch<int8_t>(q, k_new, v_new, cache, scale, block_tables, seq_lens, starts, row_offsets, out, T,
                                  H, Hk, D, N, Bs, M, R, layer, Hp, Sp, tq, span_blocks, sm_scale, logit_cap, stream);
}
