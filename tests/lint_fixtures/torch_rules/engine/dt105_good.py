"""DT105 good: the serving code calls the wrapper."""

from kernels import decode_attention


def attention(q, cache, block_tables, seq_lens, positions):
    return decode_attention.paged_decode_attention(q, cache, 0, block_tables, seq_lens, positions)
