// Ragged (token-budget) paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py,
// ragged_paged_prefill_attention (bf16 body _ragged_kernel ->
// _ragged_kernel_impl).  One flat axis of T tokens packs R rows; row r owns
// the real tokens [row_offsets[r], row_offsets[r] + seq_lens[r] - starts[r]).
// A row is a prefill span or a 1-token decode row whose start (context - 1)
// need not be block-aligned.  Each token attends its own row's cached
// prefix [0, starts[r]), streamed from the paged cache [L, N, 2, Bs, Hk*D]
// at a runtime layer index, and its own row's fresh tokens causally by flat
// index.  It never sees another row.  Tokens in no span (padding) and rows
// with an empty span come out exactly 0.  GQA, optional tanh softcap.
//
// What bounds it on this card: a prefill span of a few hundred tokens is
// bound by tensor-core flops, 4 * H * D * (visible (query, key) pairs) /
// 989 TFLOP/s (bf16); decode rows are bound by the bytes of their prefix.
//
// What the design does about that: the tensor-core flash tile of
// prefill_attention.cu (mma_attention.cuh).  A block of 4 warps owns one
// flat tile of TQ = 64 / G tokens and one KV head, so the G query heads of
// that KV head share each K/V tile read.  The block finds the rows its tile
// overlaps from the span table (a scan over R, which is small).  For each
// overlapping row with a cached prefix it streams that row's prefix blocks,
// masked to that row's queries; then it walks the fresh keys from the first
// overlapping row's span start to the tile's end, masked to the same row and
// causal.  A tile may straddle rows: the unified layout's leading decode
// region puts up to max_batch_size 1-token rows in one tile, and G = 1 or 8
// tiles straddle span ends.  Then every row's prefix streams through the
// whole 64-row tile with only that row's queries live; for decode rows that
// is 1 / TQ of the tile's rows (the cost is in PERF.md, not optimised here).
// Dead keys (past a row's start in the prefix, padding in the fresh axis)
// are staged as zeros, so NaN in the pool or in padding K/V never reaches a
// live lane, and a row's table walk stops at its own last prefix block.
//
// Not yet done (later work): cp.async/TMA double buffering, wgmma, and a
// decode-row path that does not spend a 64-row tile on one token.
#include "mma_attention.cuh"

namespace dynamo {
namespace {

template <int D>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
              const __nv_bfloat16* __restrict__ v_new, const __nv_bfloat16* __restrict__ cache,
              const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
              const int* __restrict__ starts, const int* __restrict__ row_offsets,
              __nv_bfloat16* __restrict__ out, int T, int H, int Hk, int N, int Bs, int M, int R,
              int layer, int TQ, float sm_scale, float logit_cap) {
  using Tl = Tile<D>;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * Tl::kStride;
  __nv_bfloat16* vs = ks + Tl::kKeys * Tl::kStride;
  __shared__ int tok_row[kRows];      // row of each token of the tile, -1 = none
  __shared__ int key_row[Tl::kKeys];  // row of each staged fresh key, -1 = none

  const int i0 = blockIdx.x * TQ, head = blockIdx.y;
  const int tile_end = min(i0 + TQ, T);
  const int group = H / Hk, rows = TQ * group;
  const int hkd = Hk * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4;

  auto span_end = [&](int r) { return row_offsets[r] + seq_lens[r] - starts[r]; };
  auto overlaps = [&](int r) {
    const int ro = row_offsets[r], re = span_end(r);
    return re > ro && ro < tile_end && re > i0;
  };

  // each token's row, from the span table (spans are disjoint)
  for (int x = threadIdx.x; x < TQ; x += kThreads) {
    const int tok = i0 + x;
    int row = -1;
    for (int r = 0; r < R && tok < T; ++r) {
      if (tok >= row_offsets[r] && tok < span_end(r)) row = r;
    }
    tok_row[x] = row;
  }
  // the overlapping row whose span starts first: every fresh key the tile
  // needs lies in [its span start, tile end), and the keys before the tile
  // are all its own (every thread computes the same value)
  int lo = tile_end, row_lo = -1;
  for (int r = 0; r < R; ++r) {
    if (overlaps(r) && row_offsets[r] < lo) {
      lo = row_offsets[r];
      row_lo = r;
    }
  }
  __syncthreads();  // tok_row is ready

  // block row r = (token i0 + r / group, query head head * group + r % group)
  auto row_off = [&](int r) -> size_t { return (((size_t)i0 + r / group) * H + (size_t)head * group + r % group) * D; };
  auto row_live = [&](int r) { return r < rows && i0 + r / group < T; };
  const int ra = warp * 16 + g, rb = ra + 8;  // this thread's two rows
  const int tok[2] = {i0 + ra / group, i0 + rb / group};
  const int own[2] = {row_live(ra) ? tok_row[ra / group] : -1, row_live(rb) ? tok_row[rb / group] : -1};

  WarpState<D> st;
  st.init();

  if (row_lo >= 0) {
    // queries of the tile into shared memory (rows past the input are 0)
    for (int c = threadIdx.x; c < kRows * (D / 8); c += kThreads) {
      const int r = c / (D / 8), part = c % (D / 8);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row_live(r)) v = __ldg(reinterpret_cast<const uint4*>(q + row_off(r)) + part);
      *reinterpret_cast<uint4*>(qs + r * Tl::kStride + part * 8) = v;
    }

    // phase 1: each overlapping row's cached prefix, seen by that row's queries
    for (int r = 0; r < R; ++r) {
      const int start = starts[r];
      if (start <= 0 || !overlaps(r)) continue;
      const int* table = block_tables + (size_t)r * M;
      for (int t0 = 0; t0 < start; t0 += Tl::kKeys) {
        __syncthreads();  // the previous tile's readers are done
        stage_kv<D>(ks, vs, min(Tl::kKeys, start - t0),
                    [&](int j, const __nv_bfloat16** kr, const __nv_bfloat16** vr) {
                      const int pos = t0 + j;
                      const int bid = min(max(table[min(pos / Bs, M - 1)], 0), N - 1);
                      *kr = cache_row(cache, layer, N, Bs, hkd, bid, 0, pos % Bs, head, D);
                      *vr = cache_row(cache, layer, N, Bs, hkd, bid, 1, pos % Bs, head, D);
                    });
        __syncthreads();
        attend<D>(st, qs, ks, vs, sm_scale, logit_cap,
                  [&](int h, int key) { return t0 + key < start && own[h] == r; });
      }
    }

    // phase 2: fresh keys [lo, tile end), same row, causal by flat index
    for (int t0 = lo; t0 < tile_end; t0 += Tl::kKeys) {
      __syncthreads();
      for (int j = threadIdx.x; j < Tl::kKeys; j += kThreads) {
        const int key = t0 + j;
        key_row[j] = key >= tile_end ? -1 : key < i0 ? row_lo : tok_row[key - i0];
      }
      __syncthreads();
      stage_kv_if<D>(ks, vs, [&](int j) { return key_row[j] >= 0; },
                     [&](int j, const __nv_bfloat16** kr, const __nv_bfloat16** vr) {
                       const size_t off = ((size_t)(t0 + j) * Hk + head) * D;
                       *kr = k_new + off;
                       *vr = v_new + off;
                     });
      __syncthreads();
      attend<D>(st, qs, ks, vs, sm_scale, logit_cap, [&](int h, int key) {
        return own[h] >= 0 && key_row[key] == own[h] && t0 + key <= tok[h];
      });
    }
  }

  store_rows<D>(st, [&](int r) -> __nv_bfloat16* { return row_live(r) ? out + row_off(r) : nullptr; });
}

template <int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* bt,
                   const void* lens, const void* starts, const void* roff, void* out, int T, int H, int Hk,
                   int N, int Bs, int M, int R, int layer, float sm_scale, float logit_cap,
                   cudaStream_t stream) {
  const int group = H / Hk;
  if (group > kRows || T <= 0) return cudaErrorInvalidValue;
  const int tq = kRows / group;
  auto kernel = ragged_kernel<D>;
  const size_t smem = Tile<D>::smem_bytes();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + tq - 1) / tq, Hk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const __nv_bfloat16*>(cache),
      static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(starts),
      static_cast<const int*>(roff), static_cast<__nv_bfloat16*>(out), T, H, Hk, N, Bs, M, R, layer, tq,
      sm_scale, logit_cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dynamo

// q [1, T, H, D], k_new, v_new [1, T, Hk, D] bf16; cache [L, N, 2, Bs, Hk*D]
// bf16; block_tables [R, M], seq_lens, starts, row_offsets [R] int32;
// out [1, T, H, D] bf16.  logit_cap <= 0 turns the softcap off.  Returns
// the launch's cudaGetLastError().
extern "C" int dynamo_ragged_prefill_attention(const void* q, const void* k_new, const void* v_new,
                                               const void* cache, const void* block_tables,
                                               const void* seq_lens, const void* starts,
                                               const void* row_offsets, void* out, int T, int H, int Hk,
                                               int D, int N, int Bs, int M, int R, int layer, float sm_scale,
                                               float logit_cap, void* stream) {
  using namespace dynamo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k_new, v_new, cache, block_tables, seq_lens, starts, row_offsets, out, T, H, Hk, N,
                        Bs, M, R, layer, sm_scale, logit_cap, st);
    case 128:
      return launch<128>(q, k_new, v_new, cache, block_tables, seq_lens, starts, row_offsets, out, T, H, Hk,
                         N, Bs, M, R, layer, sm_scale, logit_cap, st);
    case 256:
      return launch<256>(q, k_new, v_new, cache, block_tables, seq_lens, starts, row_offsets, out, T, H, Hk,
                         N, Bs, M, R, layer, sm_scale, logit_cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}
