// Launch geometry of the W8A16 matmul (int8_matmul.cu), the bf16 paged
// prefill attention and the ragged prefill attention (wgmma_attention.cuh,
// ragged_prefill_attention.cu), written once.  The kernels
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

// bf16 paged prefill attention (B2): a block holds 128 query rows
#define DYN_B2_ROWS 128
#define DYN_B2_THREADS 384          // two consumer warpgroups and a producer warpgroup
#define DYN_B2_STAGES 3             // K/V tiles in the ring
#define DYN_B2_KEYS_D64 64          // keys per K/V tile, by head dim
#define DYN_B2_KEYS_D128 64
#define DYN_B2_KEYS_D256 32         // the O accumulator alone takes 128 registers
#define DYN_B2_SMEM_D64 66608       // 1024 (alignment) + Q + 3 stages of K and V + 6 mbarriers
#define DYN_B2_SMEM_D128 132144
#define DYN_B2_SMEM_D256 164912

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
