"""DT105 bad: a kernel launched around its wrapper, with literal geometry."""

from kernels import build


def attention(q, out, blocks_per_chunk=4):
    lib = build.library()
    return lib.dynamo_decode_attention(q.data_ptr(), out.data_ptr(), 128, 8, blocks_per_chunk)
