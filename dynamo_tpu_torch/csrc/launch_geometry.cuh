// Launch geometry of the W8A16 matmul (int8_matmul.cu), the paged prefill
// attention and the ragged prefill attention (wgmma_attention.cuh,
// prefill_attention.cu, ragged_prefill_attention.cu) and the paged decode
// attention (decode_attention.cu) and the grouped expert matmul
// (grouped_matmul.cu), written once.  The kernels
// compile with these numbers and the Python wrappers read this file
// (ops/kernels/build.py, geometry()) to plan their launches and size their
// scratch, so a launch and its kernel cannot disagree.  The kernels
// static_assert the shared memory they lay out against the *_SMEM values.
// Format, for the reader in Python: one `#define DYN_<NAME> <integer>` per
// line, nothing computed.
#pragma once

// W8A16 matmul (B5)
#define DYN_B5_BK 64                // contracted depth per pipeline stage, both regimes
#define DYN_B5_DECODE_MAX_M 16      // M at or below runs the decode regime (two 8-row fragments)
// prefill regime (wgmma): a block computes 128 channels x 128 token rows
#define DYN_B5_PF_CHANNELS 128
#define DYN_B5_PF_TOKENS 128
#define DYN_B5_PF_STAGES 6
#define DYN_B5_PF_THREADS 384       // two consumer warpgroups and a producer warpgroup
#define DYN_B5_PF_BLOCKS_PER_SM 1   // what fits by shared memory
#define DYN_B5_PF_SMEM 148576       // 1024 (alignment) + 6 stages x (16 KB x + 8 KB weight) + 12 mbarriers
// decode regime (mma.sync, operands swapped): a block owns 128 channels
#define DYN_B5_DC_CHANNELS 128
#define DYN_B5_DC_STAGES 5
#define DYN_B5_DC_THREADS 128
#define DYN_B5_DC_BLOCKS_PER_SM 4   // what fits by shared memory
#define DYN_B5_DC_SMEM 51200        // 5 stages x (8 KB weight + 2 KB x rows)

// paged prefill attention (B2 bf16, B4b int8): a block holds 128 query rows
#define DYN_B2_ROWS 128
#define DYN_B2_THREADS 384          // two consumer warpgroups and a producer warpgroup
#define DYN_B2_STAGES 3             // K/V tiles in the ring
#define DYN_B2_KEYS_D64 64          // keys per K/V tile, by head dim
#define DYN_B2_KEYS_D128 64
#define DYN_B2_KEYS_D256 32         // the O accumulator alone takes 128 registers
#define DYN_B2_SMEM_D64 66608       // 1024 (alignment) + Q + 3 stages of K and V + 6 mbarriers
#define DYN_B2_SMEM_D128 132144
#define DYN_B2_SMEM_D256 164912
// int8 (B4b): adds 3 staging slots of int8 K and V rows, and the K and V
// scales of 3 tiles beside them and of 3 in their staging slots
#define DYN_B2_Q8_SMEM_D64 94256
#define DYN_B2_Q8_SMEM_D128 184368
#define DYN_B2_Q8_SMEM_D256 215600

// ragged paged prefill attention (B3 bf16, B4c int8), on B2's tile: a span
// block holds 128 query rows (128 / G flat tokens x the G query heads of one
// KV head), K/V streamed through the same ring; a decode-row block holds one
// 1-token row's G query rows in each consumer warpgroup, which take the
// row's key tiles in turn and merge at the end
#define DYN_B3_ROWS 128
#define DYN_B3_THREADS 384          // two consumer warpgroups and a producer warpgroup
#define DYN_B3_STAGES 3
#define DYN_B3_KEYS_D64 64
#define DYN_B3_KEYS_D128 64
#define DYN_B3_KEYS_D256 32
#define DYN_B3_DECODE_ROWS 64       // a decode-row block's query rows per warpgroup: G <= 64
#define DYN_B3_TABLE 3644           // the block's row table (RaggedTable) in shared memory
// bf16: 1024 (alignment) + Q + 3 stages of K and V + 6 mbarriers + the row table
#define DYN_B3_SMEM_D64 70252
#define DYN_B3_SMEM_D128 135788
#define DYN_B3_SMEM_D256 168556
// int8 (B4c): adds 3 staging slots of int8 K and V rows, and the K and V
// scales of 3 tiles beside them and of 3 in their staging slots
#define DYN_B3_Q8_SMEM_D64 97900
#define DYN_B3_Q8_SMEM_D128 188012
#define DYN_B3_Q8_SMEM_D256 219244

// paged decode attention (B4a int8, B1 bf16; one kernel over either
// cache): a block of 4 warps computes one chunk of one row's context for up
// to ROWS query rows of one KV head; each warp walks every 4th 16-key tile
// of the chunk through its own STAGES-stage cp.async ring, so a 64-token
// chunk is one tile per warp.  Chunks are a multiple of CHUNK tokens: the
// fewest that keep a full table's grid within BLOCKS_PER_SM blocks per SM
// and a row at MAX_CHUNKS chunks.  THREADS, KEYS, CHUNK and MAX_CHUNKS
// hold for both caches.
#define DYN_B4A_THREADS 128
#define DYN_B4A_KEYS 16             // keys per warp tile
#define DYN_B4A_STAGES 3            // tiles in each warp's ring
#define DYN_B4A_CHUNK 64            // the shortest chunk: one tile per warp
#define DYN_B4A_MAX_CHUNKS 32       // partials the last chunk of a row merges, at most
#define DYN_B4A_BLOCKS_PER_SM 8     // a full table's grid, at most: two waves of the 4 that fit at D = 128
#define DYN_B4A_ROWS_D64 16         // query rows per block, by head dim (the warps' outputs live in registers)
#define DYN_B4A_ROWS_D128 16
#define DYN_B4A_ROWS_D256 8
// by head dim and the block's query rows (4, 8 or 16): f32 Q rows + 4 warps
// x 3 stages of int8 K and V + their f32 scales + each warp's f32
// probabilities + the m and l of MAX_CHUNKS partials and 1 / l + a flag
#define DYN_B4A_SMEM_D64_R4 29216
#define DYN_B4A_SMEM_D64_R8 32304
#define DYN_B4A_SMEM_D64_R16 38480
#define DYN_B4A_SMEM_D128_R4 54816
#define DYN_B4A_SMEM_D128_R8 58928
#define DYN_B4A_SMEM_D128_R16 67152
#define DYN_B4A_SMEM_D256_R4 106016
#define DYN_B4A_SMEM_D256_R8 112176
// bf16 (B1): a bf16 row is twice an int8 one, so a ring of B4a's 3 stages
// would fit only 2 blocks on an SM at D = 128; 2 stages fit 3
#define DYN_B1_STAGES 2
#define DYN_B1_BLOCKS_PER_SM 12     // a full table's grid, at most: four waves of the 3 that fit at D = 128
#define DYN_B1_ROWS_D64 16
#define DYN_B1_ROWS_D128 16
#define DYN_B1_ROWS_D256 8
// f32 Q rows + 4 warps x 2 stages of bf16 K and V + each warp's f32
// probabilities + the m and l of MAX_CHUNKS partials and 1 / l + a flag
#define DYN_B1_SMEM_D64_R4 35872
#define DYN_B1_SMEM_D64_R8 38960
#define DYN_B1_SMEM_D64_R16 45136
#define DYN_B1_SMEM_D128_R4 69664
#define DYN_B1_SMEM_D128_R8 73776
#define DYN_B1_SMEM_D128_R16 82000
#define DYN_B1_SMEM_D256_R4 137248
#define DYN_B1_SMEM_D256_R8 143408
// grouped expert matmul (E1 bf16 experts, E2 int8 experts): a persistent
// grid of blocks, each two consumer warpgroups (64 output channels each)
// and a producer warp, walking work items of one expert's tile of ROWS
// rows (the wgmma N extent) by CHANNELS output channels over the whole
// depth
#define DYN_GMM_CHANNELS 128
#define DYN_GMM_BK 64               // contracted depth per sub-tile
#define DYN_GMM_THREADS 288         // two consumer warpgroups and a producer warp
#define DYN_GMM_MAX_EXPERTS 1024    // the block's offset and tile tables in shared memory hold E + 1 each
#define DYN_GMM_ROWS_DECODE 8       // rows per tile, by the mean group R / E: below MID_FROM
#define DYN_GMM_ROWS_MID 32         // from MID_FROM
#define DYN_GMM_ROWS_PREFILL 128    // from PREFILL_FROM
#define DYN_GMM_MID_FROM 4
#define DYN_GMM_PREFILL_FROM 32
// blocks per SM (what fits by shared memory and registers) and stages of
// each block's ring (a stage: SUBS sub-tiles, each the weight tile [64,
// 128], bf16 or int8, and the x rows [ROWS, 64] bf16), by weight type and
// row tile.  At 8 and 32
// rows one block's pipeline cannot keep its SM's share of the weight
// stream moving (E2 least: its consumers convert every weight), so several
// blocks run side by side; E1 at 8 rows runs two blocks of 6 stages (three
// of 3 stages were no faster and less steady on an H100, PERF.md)
#define DYN_GMM_BLOCKS_PER_SM_BF16_R8 2
#define DYN_GMM_BLOCKS_PER_SM_BF16_R32 2
#define DYN_GMM_BLOCKS_PER_SM_BF16_R128 1
#define DYN_GMM_BLOCKS_PER_SM_Q8_R8 3
#define DYN_GMM_BLOCKS_PER_SM_Q8_R32 2
#define DYN_GMM_BLOCKS_PER_SM_Q8_R128 1
#define DYN_GMM_STAGES_BF16_R8 6
#define DYN_GMM_STAGES_BF16_R32 5
#define DYN_GMM_STAGES_BF16_R128 6
#define DYN_GMM_STAGES_Q8_R8 3
#define DYN_GMM_STAGES_Q8_R32 8
#define DYN_GMM_STAGES_Q8_R128 8
// 64-deep sub-tiles a stage holds: one mbarrier round trip a stage, so E2
// at 8 rows, whose 8 KB sub-tiles pass quickest, takes two a stage (4.6%
// faster than one on an H100, PERF.md)
#define DYN_GMM_SUBS_BF16_R8 1
#define DYN_GMM_SUBS_BF16_R32 1
#define DYN_GMM_SUBS_BF16_R128 1
#define DYN_GMM_SUBS_Q8_R8 2
#define DYN_GMM_SUBS_Q8_R32 1
#define DYN_GMM_SUBS_Q8_R128 1
// shared memory per block: 1024 (alignment) + the ring + 2 mbarriers a
// stage + the two tables (8 x (MAX_EXPERTS + 1))
#define DYN_GMM_SMEM_BF16_R8 113768
#define DYN_GMM_SMEM_BF16_R32 111704
#define DYN_GMM_SMEM_BF16_R128 205928
#define DYN_GMM_SMEM_Q8_R8 64568
#define DYN_GMM_SMEM_Q8_R32 107656
#define DYN_GMM_SMEM_Q8_R128 205960
