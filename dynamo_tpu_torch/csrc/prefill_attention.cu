// Paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py,
// paged_prefill_attention, both of its bodies: bf16 (_kernel ->
// _kernel_impl) and int8 (_kernel_quant, over a QuantKvCache).  Flash
// prefill.  Each batch row has S fresh queries starting at the block-aligned
// position `start`.  They attend the cached prefix [0, start) in full,
// streamed from the paged cache [L, N, 2, Bs, Hk*D] at a runtime layer
// index, and their own fresh K/V causally, masked at seq_len - start.
// Padding query rows (index >= seq_len - start) come out exactly 0.
// GQA, optional tanh softcap.  Over an int8 cache the prefix is int8
// payload plus per-(token, KV head) f32 scales; the fresh K/V stay bf16.
//
// What bounds it on this card: at long S, tensor-core flops.  A block's
// query tile reuses every K/V byte it reads once per query row, so past a
// few hundred tokens the least time is (4 * H * D * visible (query, key)
// pairs) / 989 TFLOP/s (bf16); at short S it is the bytes of q, K/V and
// the prefix.
//
// The bf16 kernel (wgmma_attention.cuh) is built for Hopper's tensor-core
// rate: one block owns (row b, TQ = 128 / G query tokens, KV head k), 128
// query rows in two consumer warpgroups that run both products as wgmma,
// so the G heads that share a KV head share each K/V tile read.  S = Q K^T
// takes Q from registers (up to D = 128) and K by descriptor from shared
// memory; O += P V takes P from registers and V from shared memory.  A
// producer warpgroup streams K/V tiles (64 keys; 32 at D = 256, where the
// O accumulator alone takes 128 registers) through a 3-stage cp.async ring
// with mbarriers, so loads overlap the products; dead keys are zero-filled
// rather than read, which keeps NaN in the pool or in padding K/V out of
// both products.  Each warpgroup runs tile i's S while tile i - 1's P V is
// on the tensor cores, and tile i's softmax while that P V finishes.  The
// softmax runs in base 2, masks only the tiles that cross `start` or the
// diagonal, and skips a warpgroup's tiles past its last token.  The grid
// walks the causal tiles longest first.  The shared-memory opt-in is set
// once per instantiation, not per launch.
//
// The int8 kernel keeps the earlier mma.sync body (mma_attention.cuh):
// 64-row tiles, K/V staged through registers, int8 rows converted to bf16
// as they are staged (exact) with their K and V scales beside them (zero
// for dead slots); the scores take the K scale before the softcap and the
// PV product takes the V scale on the probabilities.  It moves to the
// wgmma tile in a later change.
#include "mma_attention.cuh"
#include "wgmma_attention.cuh"

namespace dynamo {
namespace {

// Over an int8 cache: `scale` is its scale pool [L, N, 2, Hp, Sp].
template <int D>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
               const __nv_bfloat16* __restrict__ v_new, const int8_t* __restrict__ cache,
               const float* __restrict__ scale, const int* __restrict__ block_tables,
               const int* __restrict__ seq_lens, const int* __restrict__ starts,
               __nv_bfloat16* __restrict__ out, int S, int H, int Hk, int N, int Bs, int M, int layer,
               int Hp, int Sp, int TQ, float sm_scale, float logit_cap) {
  using T = Tile<D>;
  extern __shared__ uint4 smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kRows * T::kStride;
  __nv_bfloat16* vs = ks + T::kKeys * T::kStride;
  __shared__ float sck[T::kKeys], scv[T::kKeys];

  const int b = blockIdx.x, i0 = blockIdx.y * TQ, head = blockIdx.z;
  const int group = H / Hk, rows = TQ * group;
  const int start = starts[b];
  const int fresh = seq_lens[b] - start;
  const int hkd = Hk * D;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4;

  // block row r = (token i0 + r / group, query head head * group + r % group)
  auto row_off = [&](int r) -> size_t {
    return (((size_t)b * S + i0 + r / group) * H + (size_t)head * group + r % group) * D;
  };
  auto row_token = [&](int r) { return r < rows ? i0 + r / group : 0x7fffffff; };

  WarpState<D> st;
  st.init();

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
    auto block_of = [&](int pos) { return min(max(table[min(pos / Bs, M - 1)], 0), N - 1); };
    for (int t0 = 0; t0 < start; t0 += T::kKeys) {
      const int n_live = min(T::kKeys, start - t0);
      __syncthreads();  // the previous tile's readers are done
      stage_kv<D, int8_t>(ks, vs, n_live, [&](int j, const int8_t** kr, const int8_t** vr) {
        const int pos = t0 + j, bid = block_of(pos);
        *kr = cache_row(cache, layer, N, Bs, hkd, bid, 0, pos % Bs, head, D);
        *vr = cache_row(cache, layer, N, Bs, hkd, bid, 1, pos % Bs, head, D);
      });
      stage_scales<D>(sck, scv, n_live, [&](int j, float* k, float* v) {
        const int pos = t0 + j, bid = block_of(pos);
        *k = cache_scale(scale, layer, N, Hp, Sp, bid, 0, head, pos % Bs);
        *v = cache_scale(scale, layer, N, Hp, Sp, bid, 1, head, pos % Bs);
      });
      __syncthreads();
      attend<D, true>(st, qs, ks, vs, sck, scv, sm_scale, logit_cap,
                        [&](int h, int key) { return t0 + key < start && tok[h] < fresh; });
    }

    // phase 2: fresh keys, causal by chunk index, up to the tile's last query
    const int key_end = min(fresh, i0 + TQ);
    for (int t0 = 0; t0 < key_end; t0 += T::kKeys) {
      __syncthreads();
      stage_kv<D, __nv_bfloat16>(ks, vs, min(T::kKeys, key_end - t0),
                                 [&](int j, const __nv_bfloat16** kr, const __nv_bfloat16** vr) {
                                   const size_t off = (((size_t)b * S + t0 + j) * Hk + head) * D;
                                   *kr = k_new + off;
                                   *vr = v_new + off;
                                 });
      __syncthreads();
      attend<D, false>(st, qs, ks, vs, nullptr, nullptr, sm_scale, logit_cap, [&](int h, int key) {
        const int j = t0 + key;
        return j < key_end && j <= tok[h] && tok[h] < fresh;
      });
    }
  }

  // final division and bf16 store (rows that saw nothing: l = 0 -> exactly 0)
  store_rows<D>(st, [&](int r) -> __nv_bfloat16* {
    return r < rows && i0 + r / group < S ? out + row_off(r) : nullptr;
  });
}

template <int D>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* scale,
                   const void* bt, const void* lens, const void* starts, void* out, int B, int S, int H,
                   int Hk, int N, int Bs, int M, int layer, int Hp, int Sp, float sm_scale, float logit_cap,
                   cudaStream_t stream) {
  const int group = H / Hk;
  if (group > kRows) return cudaErrorInvalidValue;
  const int tq = kRows / group;
  auto kernel = prefill_kernel<D>;
  const size_t smem = Tile<D>::smem_bytes();
  static const cudaError_t attr = allow_smem(kernel, smem);  // once per instantiation
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B, (S + tq - 1) / tq, Hk);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new), static_cast<const int8_t*>(cache), static_cast<const float*>(scale),
      static_cast<const int*>(bt), static_cast<const int*>(lens), static_cast<const int*>(starts),
      static_cast<__nv_bfloat16*>(out), S, H, Hk, N, Bs, M, layer, Hp, Sp, tq, sm_scale, logit_cap);
  return cudaGetLastError();
}

int dispatch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* scale,
             const void* bt, const void* lens, const void* start, void* out, int B, int S, int H, int Hk, int D,
             int N, int Bs, int M, int layer, int Hp, int Sp, float sm_scale, float logit_cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k_new, v_new, cache, scale, bt, lens, start, out, B, S, H, Hk, N, Bs, M, layer,
                           Hp, Sp, sm_scale, logit_cap, st);
    case 128:
      return launch<128>(q, k_new, v_new, cache, scale, bt, lens, start, out, B, S, H, Hk, N, Bs, M, layer,
                            Hp, Sp, sm_scale, logit_cap, st);
    case 256:
      return launch<256>(q, k_new, v_new, cache, scale, bt, lens, start, out, B, S, H, Hk, N, Bs, M, layer,
                            Hp, Sp, sm_scale, logit_cap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dynamo

// q [B, S, H, D], k_new, v_new [B, S, Hk, D] bf16; cache [L, N, 2, Bs, Hk*D]
// bf16; block_tables [B, M] int32 (the prefix blocks lead the table);
// seq_lens, start [B] int32; out [B, S, H, D] bf16.  All 16-byte aligned.
// logit_cap <= 0 turns the softcap off.  The launch is the caller's plan
// (launch_geometry.cuh): a grid of (Hk, B, tiles) blocks, each holding `tq`
// query tokens times the H / Hk query heads of its KV head, which must fit
// a block's rows and cover S once.  Returns the launch's
// cudaGetLastError(), or cudaErrorInvalidValue for a plan that does not fit
// the shapes.
extern "C" int dynamo_prefill_attention(const void* q, const void* k_new, const void* v_new,
                                        const void* cache, const void* block_tables, const void* seq_lens,
                                        const void* start, void* out, int B, int S, int H, int Hk, int D,
                                        int N, int Bs, int M, int layer, int tq, int tiles, float sm_scale,
                                        float logit_cap, void* stream) {
  using namespace dynamo;
  if (B < 1 || S < 1 || Hk < 1 || H % Hk || tq < 1 || (long long)tq * (H / Hk) > wg::kRows ||
      (long long)tiles * tq < S || (long long)(tiles - 1) * tq >= S)
    return cudaErrorInvalidValue;
  const dim3 grid(Hk, B, tiles);
  auto go = [&](auto kernel, size_t bytes) -> int {
    kernel<<<grid, wg::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), static_cast<const __nv_bfloat16*>(cache),
        static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens), static_cast<const int*>(start),
        static_cast<__nv_bfloat16*>(out), S, H, Hk, N, Bs, M, layer, tq, sm_scale, logit_cap);
    return cudaGetLastError();
  };
  // the opt-in above 48 KB, once per instantiation
  static const cudaError_t attr64 = allow_smem(wgmma_prefill_kernel<64>, wg::Geometry<64>::kSmem);
  static const cudaError_t attr128 = allow_smem(wgmma_prefill_kernel<128>, wg::Geometry<128>::kSmem);
  static const cudaError_t attr256 = allow_smem(wgmma_prefill_kernel<256>, wg::Geometry<256>::kSmem);
  switch (D) {
    case 64:
      return attr64 != cudaSuccess ? attr64 : go(wgmma_prefill_kernel<64>, wg::Geometry<64>::kSmem);
    case 128:
      return attr128 != cudaSuccess ? attr128 : go(wgmma_prefill_kernel<128>, wg::Geometry<128>::kSmem);
    case 256:
      return attr256 != cudaSuccess ? attr256 : go(wgmma_prefill_kernel<256>, wg::Geometry<256>::kSmem);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same over an int8 cache: cache [L, N, 2, Bs, Hk*D] int8 and scale
// [L, N, 2, Hp, Sp] f32 (token-minor, tile-padded; the valid region is
// [:Hk, :Bs]).  q, k_new, v_new and out as above.
extern "C" int dynamo_prefill_attention_q8(const void* q, const void* k_new, const void* v_new,
                                           const void* cache, const void* scale, const void* block_tables,
                                           const void* seq_lens, const void* start, void* out, int B, int S,
                                           int H, int Hk, int D, int N, int Bs, int M, int layer, int Hp, int Sp,
                                           float sm_scale, float logit_cap, void* stream) {
  return dynamo::dispatch(q, k_new, v_new, cache, scale, block_tables, seq_lens, start, out, B, S, H,
                                  Hk, D, N, Bs, M, layer, Hp, Sp, sm_scale, logit_cap, stream);
}
