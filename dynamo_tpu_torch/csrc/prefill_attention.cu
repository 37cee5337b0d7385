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
#include "mma_attention.cuh"

namespace dynamo {
namespace {

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
  store_rows<D>(st, [&](int r) -> __nv_bfloat16* {
    return r < rows && i0 + r / group < S ? out + row_off(r) : nullptr;
  });
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
