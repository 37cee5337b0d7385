// Paged prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/prefill_attention.py,
// paged_prefill_attention, both of its bodies: bf16 (_kernel ->
// _kernel_impl, B2) and int8 (_kernel_quant, over a QuantKvCache, B4b).
// Flash prefill.  Each batch row has S fresh queries starting at the
// block-aligned position `start`.  They attend the cached prefix [0, start)
// in full, streamed from the paged cache [L, N, 2, Bs, Hk*D] at a runtime
// layer index, and their own fresh K/V causally, masked at seq_len - start.
// Padding query rows (index >= seq_len - start) come out exactly 0.  GQA,
// optional tanh softcap.  Over an int8 cache the prefix is int8 payload plus
// per-(token, KV head) f32 scales; the fresh K/V stay bf16.
//
// What bounds it on this card: at long S, tensor-core flops.  A block's
// query tile reuses every K/V byte it reads once per query row, so past a
// few hundred tokens the least time is (4 * H * D * visible (query, key)
// pairs) / 989 TFLOP/s (bf16); at short S it is the bytes of q, K/V and
// the prefix.
//
// Both kernels are one template on the warpgroup tile (wgmma_attention.cuh),
// built for Hopper's tensor-core rate: one block owns (row b, TQ = 128 / G
// query tokens, KV head k), 128 query rows in two consumer warpgroups that
// run both products as wgmma, so the G heads that share a KV head share
// each K/V tile read.  S = Q K^T takes Q from registers (up to D = 128) and
// K by descriptor from shared memory; O += P V takes P from registers and V
// from shared memory.  A producer warpgroup streams K/V tiles (64 keys; 32
// at D = 256, where the O accumulator alone takes 128 registers) through a
// 3-stage cp.async ring with mbarriers, so loads overlap the products; dead
// keys are zero-filled rather than read, which keeps NaN in the pool or in
// padding K/V out of both products.  Each warpgroup runs tile i's S while
// tile i - 1's P V is on the tensor cores, and tile i's softmax while that
// P V finishes.  The softmax runs in base 2, masks only the tiles that
// cross `start` or the diagonal, and skips a warpgroup's tiles past its last
// token.  The grid walks the causal tiles longest first.  The shared-memory
// opt-in is set once per instantiation, not per launch.
//
// Over an int8 cache (B4b) the producer copies a prefix tile's int8 rows and
// their K and V scales (zero for dead slots, whose scales are never read)
// into a staging ring two tiles ahead and converts the rows to bf16 into the
// swizzled tile while the next copies fly (exact: |v| <= 127); the scales
// move beside the tile at conversion.  The scores take the K scale before
// the softcap, P V takes the V scale on P, and the row sums take P unscaled,
// as the TPU kernel associates them.  Fresh tiles are bf16 and copied as B2
// copies them.
#include "wgmma_attention.cuh"

namespace dynamo {
namespace {

// The caller's plan (launch_geometry.cuh) must fit a block's rows and cover
// S once; then one launch of wgmma_prefill_kernel<D, E>.
template <class E>
int launch(const void* q, const void* k_new, const void* v_new, const void* cache, const void* scale,
           const void* block_tables, const void* seq_lens, const void* start, void* out, int B, int S, int H, int Hk,
           int D, int N, int Bs, int M, int layer, int Hp, int Sp, int tq, int tiles, float sm_scale, float logit_cap,
           void* stream) {
  constexpr bool kQuant = !std::is_same<E, __nv_bfloat16>::value;
  if (B < 1 || S < 1 || Hk < 1 || H % Hk || tq < 1 || (long long)tq * (H / Hk) > wg::kRows ||
      (long long)tiles * tq < S || (long long)(tiles - 1) * tq >= S)
    return cudaErrorInvalidValue;
  const dim3 grid(Hk, B, tiles);
  auto go = [&](auto kernel, size_t bytes) -> int {
    kernel<<<grid, wg::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new), static_cast<const E*>(cache), static_cast<const float*>(scale),
        static_cast<const int*>(block_tables), static_cast<const int*>(seq_lens), static_cast<const int*>(start),
        static_cast<__nv_bfloat16*>(out), S, H, Hk, N, Bs, M, layer, Hp, Sp, tq, sm_scale, logit_cap);
    return cudaGetLastError();
  };
  // the opt-in above 48 KB, once per instantiation
  static const cudaError_t attr64 = allow_smem(wgmma_prefill_kernel<64, E>, PrefillSmem<64, kQuant>::kBytes);
  static const cudaError_t attr128 = allow_smem(wgmma_prefill_kernel<128, E>, PrefillSmem<128, kQuant>::kBytes);
  static const cudaError_t attr256 = allow_smem(wgmma_prefill_kernel<256, E>, PrefillSmem<256, kQuant>::kBytes);
  switch (D) {
    case 64:
      return attr64 != cudaSuccess ? attr64 : go(wgmma_prefill_kernel<64, E>, PrefillSmem<64, kQuant>::kBytes);
    case 128:
      return attr128 != cudaSuccess ? attr128 : go(wgmma_prefill_kernel<128, E>, PrefillSmem<128, kQuant>::kBytes);
    case 256:
      return attr256 != cudaSuccess ? attr256 : go(wgmma_prefill_kernel<256, E>, PrefillSmem<256, kQuant>::kBytes);
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
  return dynamo::launch<__nv_bfloat16>(q, k_new, v_new, cache, nullptr, block_tables, seq_lens, start, out, B, S, H,
                                       Hk, D, N, Bs, M, layer, 0, 0, tq, tiles, sm_scale, logit_cap, stream);
}

// The same over an int8 cache, with the same plan: cache [L, N, 2, Bs,
// Hk*D] int8 and scale [L, N, 2, Hp, Sp] f32 (token-minor, tile-padded; the
// valid region is [:Hk, :Bs]).  The other arguments as above.
extern "C" int dynamo_prefill_attention_q8(const void* q, const void* k_new, const void* v_new,
                                           const void* cache, const void* scale, const void* block_tables,
                                           const void* seq_lens, const void* start, void* out, int B, int S,
                                           int H, int Hk, int D, int N, int Bs, int M, int layer, int Hp, int Sp,
                                           int tq, int tiles, float sm_scale, float logit_cap, void* stream) {
  return dynamo::launch<int8_t>(q, k_new, v_new, cache, scale, block_tables, seq_lens, start, out, B, S, H, Hk, D,
                                N, Bs, M, layer, Hp, Sp, tq, tiles, sm_scale, logit_cap, stream);
}
