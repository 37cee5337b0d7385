// W8A16 matrix product for Hopper (sm_90a): out = (x @ wq) * scale.
//
// Replaces the TPU kernel dynamo_tpu/ops/pallas/int8_matmul.py,
// int8_matmul (_kernel): x [M, K] bf16 times an int8 weight with one f32
// scale per output channel, the int8 -> bf16 convert inside the kernel,
// f32 accumulation and the scale in the epilogue.  The weight is [K, N]
// row-major (a projection) or [N, K] row-major (its transpose: the tied
// embedding [V, Dm] used as the lm_head), read as it lies, never copied.
// Out is bf16 or f32 (logits).  The fp16 body (dynamo_int8_matmul_f16)
// is the same kernels for x [M, K] float16 and out float16 or f32: the int8
// codes convert exactly to fp16 (|v| <= 127; 0x6400 | u minus 1152, see
// hopper.cuh), the products run as mma.sync / wgmma .f16 with f32
// accumulation, and x is multiplied as it is: the TPU kernel rounds x to
// bf16 first (int8_matmul.py:48), which an fp16 model has no reason to
// copy.  M, N and K may be any size: tile edges are
// zero-filled on load and masked on store.  Rows whose length is a
// multiple of 16 bytes (and 16-byte aligned pointers) are copied with
// 16-byte cp.async; otherwise (a vocabulary of 32002, say) each 16-byte
// chunk is loaded element by element, correct but slower: each kernel is
// instantiated for both copies (VEC), so the fast one carries no branch.  One C entry
// point; the kernel is chosen by M, and there is no fallback.  The launch
// geometry is in launch_geometry.cuh, which the wrapper's planner reads.
//
// What bounds it on this card.  At decode (M = 8 rows) the weight bytes,
// K * N int8 read once over 3.35 TB/s: a 4096 x 14336 projection is 59 MB,
// about 18 us.  At prefill (M in the hundreds or thousands) the tensor-core
// rate, 2 * M * K * N / 989 TFLOP/s (bf16): one Llama-3-8B layer's seven
// projections at M = 1504 take at least 0.66 ms.
//
// Prefill regime (M > kDecodeMaxM): warp-specialised wgmma, weight as A.
//   - A block computes a 128-channel x 128-token output tile as
//     out^T = W^T x^T with three warpgroups: two consumers, each issuing
//     wgmma.mma_async m64n128k16 (bf16 in, f32 accumulate) for 64 of the
//     channels, and one producer.
//   - The producer keeps a ring of kStages = 6 stages in flight with 16-byte
//     cp.async (zero fill past M, N and the K range): the x tile [128, 64]
//     lands in the 128-byte-swizzled K-major layout wgmma reads as its B
//     operand; the int8 weight tile [64, 128] lands raw, XOR-swizzled.  The
//     copies arrive on the stage's `full` mbarrier as they land
//     (cp.async.mbarrier.arrive), so the producer never waits on them.
//   - Each consumer thread builds its A fragments straight from the int8
//     tile: 2-byte shared loads (free of bank conflicts), each element
//     converted to bf16 once, in registers (exact: |v| <= 127 fits bf16's
//     significand; integer ops, see i8x2_to_bf16x2).  No bf16 copy of the
//     weight is ever written, which keeps shared-memory traffic to the two
//     tiles' copies and the operand reads.  For a [K, N] weight a thread's
//     two fragment rows are adjacent channels, so one load serves both and
//     the epilogue stores channel pairs; for the [N, K] lm_head they are
//     channels g and g + 8.  The next stage's fragments are built while
//     the tensor cores run this one (two register sets); a stage is freed
//     on its `empty` mbarrier as soon as the wgmma group that read it has
//     retired.
//   - The epilogue multiplies the f32 accumulator by the f32 scale and rounds
//     once to the output type, as the plain version does.
// Decode regime (M <= kDecodeMaxM = 16): bounded by weight bytes.
//   - Operands are swapped here too, on mma.sync m16n8k16: the 16-row A
//     operand holds output channels and the 8-column B operand the token
//     rows, so no lane idles at M <= 8; two n fragments cover M <= 16.  The
//     crossover at 16 is where a third fragment would be needed; it was
//     set by the fragment count, not by timing M = 17-32 in both regimes.
//   - A block of 4 warps owns 128 channels; each warp's lanes read 4
//     consecutive weight bytes per load (the k order inside a 16-deep step is
//     a free permutation shared by A and B), and the weight streams through
//     a 5-stage cp.async ring of 10 KB stages (the weight tile and the x
//     rows), XOR-swizzled so the fragment reads are free of bank conflicts.
//   - K is split so every Llama-3-8B shape puts at least four blocks on each
//     of the 132 SMs (the wrapper's plan; four fit by shared memory), which
//     keeps about 128 KB of weight in flight per SM.
// Split K (either regime, when the output tiles alone cannot fill the
// card), finished in the same launch and deterministic: every split stores
// its f32 sums into its own slice of a scratch [splits, M, N]; the block
// that takes the tile's last ticket sums the slices in split order (8
// loads in flight per thread), scales and rounds once.  The result does
// not depend on which block finishes last, so it is the same on every run.
// The slices are a per-call scratch from the caching allocator (stream-
// ordered); the per-tile tickets are one small buffer per stream, which
// each launch's finishing blocks leave zeroed.  A cluster reduction in distributed shared memory was not taken:
// clusters hold at most 8 (16 non-portable) blocks, and the decode shapes
// split K up to 64 ways.
#include <tuple>

#include "attention_common.cuh"
#include "hopper.cuh"
#include "launch_geometry.cuh"

namespace dynamo {
namespace {

using namespace hopper;

constexpr int kBK = DYN_B5_BK;                    // contracted depth per stage, both regimes
constexpr int kDecodeMaxM = DYN_B5_DECODE_MAX_M;  // crossover: M at or below runs the decode regime
static_assert(kBK == 64 && kDecodeMaxM == 16, "the copy and fragment mappings below are written for these");

// Bytes (a, b) of the eight in (lo, hi), selected as __byte_perm does, as
// a pair of T (bf16 or fp16).
template <class T, int A, int B>
__device__ __forceinline__ uint32_t bytes_to_x2(uint32_t lo, uint32_t hi) {
  return i8x2_to_x2<T>(__byte_perm(lo, hi, A | (B << 8)));
}

// y into element o of out: f32, or rounded to T.
template <class T>
__device__ __forceinline__ void store_out(void* out, size_t o, float y, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[o] = y;
  else
    static_cast<T*>(out)[o] = from_f32<T>(y);
}

// One 16-byte chunk of a row into shared memory at `dst`: the first `valid`
// elements of T (uint16_t for bf16, uint8_t for int8) from `src`, zeros
// after; `base` is the tensor's start, a readable address for a chunk that
// reads nothing.  VEC: the chunk is whole or wholly out (valid >= 16 bytes
// or <= 0) and 16-byte aligned, and goes by cp.async; otherwise it is
// loaded element by element and stored.
template <bool VEC, class T>
__device__ __forceinline__ void copy_chunk(uint8_t* dst, const T* src, int valid, const void* base) {
  constexpr int kN = 16 / sizeof(T), kBits = 8 * sizeof(T);
  if constexpr (VEC) {
    cp_async_16(smem_u32(dst), valid > 0 ? static_cast<const void*>(src) : base, valid > 0 ? 16 : 0);
  } else {
    uint32_t word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < kN; ++i)
      if (i < valid) word[i * kBits / 32] |= static_cast<uint32_t>(src[i]) << (i * kBits % 32);
    *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// Split-K finish for the `nthreads` threads of a block (ids `tid`) that
// hold the tile's sums: rows [m0, m0 + rows) x channels [n0, n0 + cols).
// This split's sums are already in its slice of `partials` [splits, M, np]
// (np = N rounded up to 4).  The block that takes the tile's last ticket
// adds the slices in split order, scales and rounds once, and zeroes the
// ticket for the next launch on the stream; sync() synchronises the
// participating threads.  Each thread sums two float4 columns at once, so
// 16 loads are in flight.  A non-f32 out is of T.
template <class T, class Sync>
__device__ void finish_split(Sync sync, const float* __restrict__ partials, int* __restrict__ ticket,
                             const float* __restrict__ scale, void* __restrict__ out, int M, int N, int m0, int rows,
                             int n0, int cols, int splits, int out_f32, int tid, int nthreads, int* s_last) {
  __threadfence();
  sync();
  if (tid == 0) {
    *s_last = atomicAdd(ticket, 1) == splits - 1;
    if (*s_last) *ticket = 0;  // every split has arrived: no one else touches it
  }
  sync();
  if (!*s_last) return;
  __threadfence();
  const int np = (N + 3) & ~3, c4 = cols / 4, total = rows * c4;
  const size_t slice = (size_t)M * np;
  for (int c0 = tid; c0 < total; c0 += 2 * nthreads) {
    int m[2], n[2];
    bool ok[2];
    const float* p[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * nthreads;
      m[h] = m0 + c / c4;
      n[h] = n0 + 4 * (c % c4);
      ok[h] = c < total && m[h] < M && n[h] < N;
      p[h] = partials + (ok[h] ? (size_t)m[h] * np + n[h] : 0);  // a dead column reads slice 0's start
    }
    float4 s[2] = {__ldcg(reinterpret_cast<const float4*>(p[0])), __ldcg(reinterpret_cast<const float4*>(p[1]))};
#pragma unroll 8
    for (int z = 1; z < splits; ++z) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(p[h] + z * slice));
        s[h].x += v.x;
        s[h].y += v.y;
        s[h].z += v.z;
        s[h].w += v.w;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
      const float y[4] = {s[h].x, s[h].y, s[h].z, s[h].w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n[h] + e < N) store_out<T>(out, (size_t)m[h] * N + n[h] + e, y[e] * __ldg(scale + n[h] + e), out_f32);
    }
  }
}

// ------------------------------------------------------------- prefill regime
namespace pf {
constexpr int kBC = DYN_B5_PF_CHANNELS, kBT = DYN_B5_PF_TOKENS;  // channels (2 warpgroups x 64) x token rows
constexpr int kStages = DYN_B5_PF_STAGES;
constexpr int kThreads = DYN_B5_PF_THREADS;
constexpr int kRawBytes = kBC * kBK;       // int8 weight tile as copied
constexpr int kXBytes = kBT * kBK * 2;     // x tile (bf16 or fp16), K-major SW128 (the B operand)
constexpr int kStageBytes = kXBytes + kRawBytes;
constexpr size_t kSmem = DYN_B5_PF_SMEM;
static_assert(kBC == 128 && kBT == 128 && kThreads == 384, "the copy and fragment mappings below are written for these");
static_assert(1024 + (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) == kSmem,
              "DYN_B5_PF_SMEM must be the shared memory this layout takes");
}  // namespace pf

// out^T = W^T x^T on wgmma: the A operand (64 channels of a warpgroup x 16
// deep) is built in registers straight from the int8 tile, B is the x tile.
// T: the type of x (and of a non-f32 out), __nv_bfloat16 or __half.
// VEC: every copy is a whole aligned 16 bytes (copy_chunk).
template <class T, bool NK, bool VEC>
__global__ void __launch_bounds__(pf::kThreads, 1)
w8a16_wgmma_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, void* __restrict__ out, float* __restrict__ partials,
                   int* __restrict__ tickets, int M, int N, int K, int k_steps, int out_f32) {
  using namespace pf;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  __shared__ int s_last;

  const int n0 = blockIdx.x * kBC, m0 = blockIdx.y * kBT;
  const int k_begin = blockIdx.z * k_steps * kBK;
  const int k_end = min(K, k_begin + k_steps * kBK);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {
    const int p = tid - 256;
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      uint8_t* st = smem + s * kStageBytes;
      const int k0 = k_begin + it * kBK;
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // x: 128 token rows x 8 chunks of 8 bf16
        const int c = p + 128 * i, r = c >> 3, q = c & 7;
        const int gm = m0 + r, gk = k0 + 8 * q;
        copy_chunk<VEC>(st + r * 128 + ((q ^ (r & 7)) << 4), reinterpret_cast<const uint16_t*>(x) + (size_t)gm * K + gk,
                   gm < M ? k_end - gk : 0, x);
      }
      uint8_t* raw = st + kXBytes;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = p + 128 * i;
        if (NK) {  // [N, K]: 128 channel rows of 64 bytes, chunk kc at kc ^ ((row / 2) % 4)
          const int nr = c >> 2, kc = c & 3, gn = n0 + nr, gk = k0 + 16 * kc;
          copy_chunk<VEC>(raw + nr * 64 + ((kc ^ ((nr >> 1) & 3)) << 4),
                     reinterpret_cast<const uint8_t*>(w) + (size_t)gn * K + gk, gn < N ? k_end - gk : 0, w);
        } else {   // [K, N]: 64 depth rows of 128 bytes, chunk nc at nc ^ ((row / 2) % 4)
          const int kr = c >> 3, nc = c & 7, gk = k0 + kr, gn = n0 + 16 * nc;
          copy_chunk<VEC>(raw + kr * 128 + ((nc ^ ((kr >> 1) & 3)) << 4),
                     reinterpret_cast<const uint8_t*>(w) + (size_t)gk * N + gn, gk < k_end ? N - gn : 0, w);
        }
      }
      if (VEC) {
        cp_async_mbar_arrive(&full[s]);
      } else {  // stored by this thread: visible to wgmma's reads, then published
        fence_async_smem();
        mbar_arrive(&full[s]);
      }
    }
    cp_async_wait<0>();
  } else {
    const int wg = tid >> 7, wi = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    // this thread's two A rows: channels c + {0, 1} ([K, N]: adjacent) or c + {0, 8} ([N, K])
    const int cbase = wg * 64 + wi * 16 + (NK ? g : 2 * g);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t af[2][4][4];  // A fragments of two stages in flight: [stage parity][k16 step][reg]
    auto step = [&](int kt, uint32_t(&a)[4][4]) {
      const int s = kt % kStages;
      mbar_wait(&full[s], (kt / kStages) & 1);
      const uint8_t* raw = smem + s * kStageBytes + kXBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (NK) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = cbase + 8 * h;
            const uint8_t* row = raw + r * 64 + 2 * t;
            const uint32_t lo = *reinterpret_cast<const uint16_t*>(row + ((kk ^ ((r >> 1) & 3)) << 4));
            const uint32_t hi = *reinterpret_cast<const uint16_t*>(row + ((kk ^ ((r >> 1) & 3)) << 4) + 8);
            a[kk][h] = bytes_to_x2<T, 0, 1>(lo, 0);
            a[kk][2 + h] = bytes_to_x2<T, 0, 1>(hi, 0);
          }
        } else {
          uint32_t v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kr = 16 * kk + 2 * t + (j & 1) + 8 * (j >> 1);
            const int col = cbase;  // bytes col, col + 1 of depth row kr
            v[j] = *reinterpret_cast<const uint16_t*>(raw + kr * 128 + (((col >> 4) ^ ((kr >> 1) & 3)) << 4) +
                                                      (col & 15));
          }
          a[kk][0] = bytes_to_x2<T, 0, 4>(v[0], v[1]);
          a[kk][1] = bytes_to_x2<T, 1, 5>(v[0], v[1]);
          a[kk][2] = bytes_to_x2<T, 0, 4>(v[2], v[3]);
          a[kk][3] = bytes_to_x2<T, 1, 5>(v[2], v[3]);
        }
      }
      const uint32_t xb = smem_u32(smem + s * kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Wgmma<128, 0, 0, T>::rs(acc, a[kk][0], a[kk][1], a[kk][2], a[kk][3], sw128_desc(xb + kk * 32, 16, 1024),
                          (kt > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();  // stage kt - 1's group has retired: its slot and A registers are free
      if (kt > 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    };
    // A registers stay live until the wait that retires the group reading them
    int kt = 0;
    for (; kt + 1 < nk; kt += 2) {
      step(kt, af[0]);
      reg_fence(af[1]);
      step(kt + 1, af[1]);
      reg_fence(af[0]);
    }
    if (kt < nk) step(kt, af[0]);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(af[0]);
    reg_fence(af[1]);

    // accumulator i: channel row half (i / 2) % 2, token column 8 (i / 4) + 2 t + i % 2
    auto chan = [&](int half) { return n0 + cbase + (NK ? 8 : 1) * half; };
    auto for_each = [&](auto&& fn) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1), n = chan((i >> 1) & 1);
        if (m < M && n < N) fn(i, m, n);
      }
    };
    if (partials != nullptr) {
      const int np = (N + 3) & ~3;
      float* part = partials + blockIdx.z * (size_t)M * np;
      for_each([&](int i, int m, int n) { part[(size_t)m * np + n] = acc[i]; });
      finish_split<T>([] { named_sync(1, 256); }, partials, tickets + blockIdx.y * gridDim.x + blockIdx.x, scale,
                   out, M, N, m0, kBT, n0, kBC, gridDim.z, out_f32, tid, 256, &s_last);
    } else if (!NK && VEC) {  // channels 2g, 2g + 1 of one token are adjacent (N even): one paired store
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if ((i >> 1) & 1) continue;
        const int m = m0 + 8 * (i >> 2) + 2 * t + (i & 1), n = chan(0);
        if (m >= M || n >= N) continue;
        const float y0 = acc[i] * __ldg(scale + n), y1 = acc[i + 2] * __ldg(scale + n + 1);
        const size_t o = (size_t)m * N + n;
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<T*>(out) + o) = pack_x2<T>(y0, y1);
      }
    } else {
      for_each([&](int i, int m, int n) { store_out<T>(out, (size_t)m * N + n, acc[i] * __ldg(scale + n), out_f32); });
    }
  }
}

// -------------------------------------------------------------- decode regime
namespace dc {
constexpr int kBN = DYN_B5_DC_CHANNELS;        // channels per block: 4 warps x 32
constexpr int kStages = DYN_B5_DC_STAGES;
constexpr int kThreads = DYN_B5_DC_THREADS;
constexpr int kWBytes = kBN * kBK;             // 8 KB of int8 weight
constexpr int kStageBytes = kWBytes + kDecodeMaxM * kBK * 2;  // + the x rows [16, 64] (bf16 or fp16)
constexpr size_t kSmem = DYN_B5_DC_SMEM;
static_assert(kBN == 128 && kThreads == 128, "the copy and fragment mappings below are written for these");
static_assert((size_t)kStages * kStageBytes == kSmem, "DYN_B5_DC_SMEM must be the shared memory this layout takes");
}  // namespace dc

// NT fragments of 8 token rows (M <= 8 * NT); T the type of x (and of a
// non-f32 out); VEC: every copy is a whole aligned 16 bytes (copy_chunk).
template <class T, bool NK, int NT, bool VEC>
__global__ void __launch_bounds__(dc::kThreads)
w8a16_decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, void* __restrict__ out, float* __restrict__ partials,
                    int* __restrict__ tickets, int M, int N, int K, int k_steps, int out_f32) {
  using namespace dc;
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int s_last;
  const int n0 = blockIdx.x * kBN;
  const int k_begin = blockIdx.z * k_steps * kBK;
  const int k_end = min(K, k_begin + k_steps * kBK);
  const int nk = (k_end - k_begin + kBK - 1) / kBK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // One stage: 512 chunks of 16 weight bytes, 4 per thread.  [N, K]: 128
  // channel rows of 64 bytes, chunk kc at kc ^ ((row / 2) % 4).  [K, N]: 64
  // depth rows of 128 bytes, chunk nc at nc ^ 2 ((row / 4) % 4).  Then the
  // x rows [16, 64] of T, one chunk per thread, chunk c of row r at c ^ (r % 8)
  // (rows past M zero-filled).  Every fragment read is free of bank conflicts.
  auto issue = [&](int it) {
    uint8_t* st = ring + (it % kStages) * kStageBytes;
    const int k0 = k_begin + it * kBK;
    {
      const int r = tid >> 3, c = tid & 7, gk = k0 + 8 * c;
      copy_chunk<VEC>(st + kWBytes + r * 128 + ((c ^ (r & 7)) << 4),
                 reinterpret_cast<const uint16_t*>(x) + (size_t)r * K + gk, r < M ? k_end - gk : 0, x);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + 128 * i;
      if (NK) {
        const int nr = c >> 2, kc = c & 3, gn = n0 + nr, gk = k0 + 16 * kc;
        copy_chunk<VEC>(st + nr * 64 + ((kc ^ ((nr >> 1) & 3)) << 4),
                   reinterpret_cast<const uint8_t*>(w) + (size_t)gn * K + gk, gn < N ? k_end - gk : 0, w);
      } else {
        const int kr = c >> 3, nc = c & 7, gk = k0 + kr, gn = n0 + 16 * nc;
        copy_chunk<VEC>(st + kr * 128 + ((nc ^ (((kr >> 2) & 3) << 1)) << 4),
                   reinterpret_cast<const uint8_t*>(w) + (size_t)gk * N + gn, gk < k_end ? N - gn : 0, w);
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[f][j][0] = acc[f][j][1] = acc[f][j][2] = acc[f][j][3] = 0.f;

#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < nk) issue(it);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed for every thread; stage kt - 1 is free
    if (kt + kStages - 1 < nk) issue(kt + kStages - 1);
    cp_async_commit();
    const uint8_t* st = ring + (kt % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // mma k slots 2t, 2t + 1, 2t + 8, 2t + 9 hold depth 16 kk + 4t + {0, 1, 2, 3}
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int tok = 8 * j + g, c = 2 * kk + (t >> 1);
        const uint2 v =
            *reinterpret_cast<const uint2*>(st + kWBytes + tok * 128 + ((c ^ (tok & 7)) << 4) + 8 * (t & 1));
        b[j][0] = v.x;
        b[j][1] = v.y;
      }
      uint32_t a[2][4];
      if (NK) {  // fragment f, row g (+8): channel 32 warp + 16 f + g (+8)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 32 * warp + 16 * f + g + 8 * h;
            const uint32_t wv =
                *reinterpret_cast<const uint32_t*>(st + r * 64 + ((kk ^ ((r >> 1) & 3)) << 4) + 4 * t);
            a[f][h] = bytes_to_x2<T, 0, 1>(wv, 0);
            a[f][2 + h] = bytes_to_x2<T, 2, 3>(wv, 0);
          }
        }
      } else {   // fragment f, row g (+8): channel 32 warp + 4 g + 2 f (+1)
        uint32_t wv[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kr = 16 * kk + 4 * t + jj;
          const int chunk = 2 * warp + (g >> 2);
          wv[jj] = *reinterpret_cast<const uint32_t*>(st + kr * 128 + ((chunk ^ (((kr >> 2) & 3) << 1)) << 4) +
                                                      4 * (g & 3));
        }
        a[0][0] = bytes_to_x2<T, 0, 4>(wv[0], wv[1]);
        a[0][1] = bytes_to_x2<T, 1, 5>(wv[0], wv[1]);
        a[0][2] = bytes_to_x2<T, 0, 4>(wv[2], wv[3]);
        a[0][3] = bytes_to_x2<T, 1, 5>(wv[2], wv[3]);
        a[1][0] = bytes_to_x2<T, 2, 6>(wv[0], wv[1]);
        a[1][1] = bytes_to_x2<T, 3, 7>(wv[0], wv[1]);
        a[1][2] = bytes_to_x2<T, 2, 6>(wv[2], wv[3]);
        a[1][3] = bytes_to_x2<T, 3, 7>(wv[2], wv[3]);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_16816<T>(acc[f][j], a[f][0], a[f][1], a[f][2], a[f][3], b[j][0], b[j][1]);
    }
  }

  // acc[f][j][e]: channel row g + 8 (e / 2) of fragment f, token 8 j + 2 t + e % 2
  auto for_each = [&](auto&& fn) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + 32 * warp + (NK ? 16 * f + g + 8 * (e >> 1) : 4 * g + 2 * f + (e >> 1));
          const int m = 8 * j + 2 * t + (e & 1);
          if (m < M && n < N) fn(acc[f][j][e], m, n);
        }
  };
  if (partials == nullptr) {
    for_each([&](float v, int m, int n) { store_out<T>(out, (size_t)m * N + n, v * __ldg(scale + n), out_f32); });
    return;
  }
  const int np = (N + 3) & ~3;
  float* part = partials + blockIdx.z * (size_t)M * np;
  for_each([&](float v, int m, int n) { part[(size_t)m * np + n] = v; });
  finish_split<T>([] { __syncthreads(); }, partials, tickets + blockIdx.x, scale, out, M, N, 0, M, n0, kBN,
               gridDim.z, out_f32, tid, dc::kThreads, &s_last);
}

// One launch of `Kernel` on x of T; the opt-in for its dynamic shared
// memory is set once per kernel (a static per instantiation of this template).
template <class T, auto Kernel>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream, const void* x, const void* w,
                   const void* scale, void* out, float* partials, int* tickets, int M, int N, int K, int k_steps,
                   int out_f32) {
  static const cudaError_t attr = allow_smem(Kernel, smem);
  if (attr != cudaSuccess) return attr;
  Kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<const int8_t*>(w),
                                          static_cast<const float*>(scale), out, partials, tickets, M, N, K,
                                          k_steps, out_f32);
  return cudaGetLastError();
}

// The kernel for x of T, the regime (M), the token fragments (decode) and
// the copy.
template <class T, bool NK, bool VEC, class Args>
cudaError_t dispatch(int M, const Args& decode_args, const Args& wgmma_args) {
  if (M > kDecodeMaxM) return std::apply(launch<T, w8a16_wgmma_kernel<T, NK, VEC>>, wgmma_args);
  return M <= 8 ? std::apply(launch<T, w8a16_decode_kernel<T, NK, 1, VEC>>, decode_args)
                : std::apply(launch<T, w8a16_decode_kernel<T, NK, 2, VEC>>, decode_args);
}

// The plan's launch for x of T, after checking that it fits the shapes (see
// dynamo_int8_matmul below).
template <class T>
int matmul(const void* x, const void* w, const void* scale, void* out, void* partials, void* tickets, int M, int N,
           int K, int w_nk, int out_f32, int grid_n, int grid_m, int splits, int k_steps, void* stream) {
  if (M < 1 || N < 1 || K < 1 || grid_n < 1 || grid_m < 1 || grid_m > 65535 || splits < 1 || splits > 65535 ||
      k_steps < 1)
    return cudaErrorInvalidValue;
  const bool decode = M <= kDecodeMaxM;
  const long long tile_n = decode ? dc::kBN : pf::kBC, tile_m = decode ? kDecodeMaxM : pf::kBT;
  const long long span = (long long)k_steps * kBK;
  if (grid_n * tile_n < N || (grid_n - 1) * tile_n >= N || grid_m * tile_m < M || (grid_m - 1) * tile_m >= M ||
      splits * span < K || (splits - 1) * span >= K)
    return cudaErrorInvalidValue;
  if (splits > 1 && (partials == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  float* part = splits > 1 ? static_cast<float*>(partials) : nullptr;
  int* tick = splits > 1 ? static_cast<int*>(tickets) : nullptr;
  const dim3 grid(grid_n, grid_m, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto decode_args =
      std::make_tuple(grid, dc::kThreads, dc::kSmem, st, x, w, scale, out, part, tick, M, N, K, k_steps, out_f32);
  const auto wgmma_args =
      std::make_tuple(grid, pf::kThreads, pf::kSmem, st, x, w, scale, out, part, tick, M, N, K, k_steps, out_f32);
  // 16-byte copies: rows of x (2K bytes) and of the weight (K or N bytes)
  // whole 16-byte multiples, both pointers aligned
  const bool vec = (K % 8 == 0) && (w_nk ? K % 16 == 0 : N % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (w_nk)
    return vec ? dispatch<T, true, true>(M, decode_args, wgmma_args)
               : dispatch<T, true, false>(M, decode_args, wgmma_args);
  return vec ? dispatch<T, false, true>(M, decode_args, wgmma_args)
             : dispatch<T, false, false>(M, decode_args, wgmma_args);
}

}  // namespace
}  // namespace dynamo

// x [M, K] bf16; w int8 [K, N] row-major (w_nk = 0) or [N, K] row-major
// (w_nk = 1); scale [N] f32; out [M, N] bf16 (out_f32 = 0) or f32; all
// contiguous.  The launch is the caller's plan (launch_geometry.cuh): a
// grid of grid_n x grid_m output tiles (128 channels; 128 token rows above
// M = 16, every row at or below) times `splits` ranges of `k_steps` 64-deep
// steps, which must cover N, M and K once with no empty split.  With
// splits > 1, `partials` holds splits * M * round_up(N, 4) floats and
// `tickets` grid_n * grid_m zeroed ints, which the launch leaves zeroed
// (one ticket buffer per stream serves every launch on it).  Returns the
// launch's cudaGetLastError(), or cudaErrorInvalidValue for a plan that
// does not fit the shapes.
extern "C" int dynamo_int8_matmul(const void* x, const void* w, const void* scale, void* out, void* partials,
                                  void* tickets, int M, int N, int K, int w_nk, int out_f32, int grid_n, int grid_m,
                                  int splits, int k_steps, void* stream) {
  return dynamo::matmul<__nv_bfloat16>(x, w, scale, out, partials, tickets, M, N, K, w_nk, out_f32, grid_n, grid_m,
                                       splits, k_steps, stream);
}

// The fp16 body: x [M, K] float16, out [M, N] float16 (out_f32 = 0) or
// f32, the other arguments as above.
extern "C" int dynamo_int8_matmul_f16(const void* x, const void* w, const void* scale, void* out, void* partials,
                                      void* tickets, int M, int N, int K, int w_nk, int out_f32, int grid_n,
                                      int grid_m, int splits, int k_steps, void* stream) {
  return dynamo::matmul<__half>(x, w, scale, out, partials, tickets, M, N, K, w_nk, out_f32, grid_n, grid_m, splits,
                                k_steps, stream);
}
