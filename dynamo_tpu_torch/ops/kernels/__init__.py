"""The hand-written kernels' wrappers.  Each wrapper's ``launches`` counts
the calls that launched its kernel in this process; :func:`launch_counts`
reads them all, so that a process serving a model can report which kernels
its requests ran."""


def wrappers() -> dict:
    """Every kernel wrapper by its short name."""
    from . import decode_attention as dec
    from . import grouped_matmul as gmm
    from . import int8_matmul as mm
    from . import prefill_attention as pre
    from . import ragged_prefill_attention as rag

    return {"decode": dec.paged_decode_attention, "prefill": pre.paged_prefill_attention,
            "ragged": rag.ragged_paged_prefill_attention,
            "decode_q8": dec.paged_decode_attention_q8, "prefill_q8": pre.paged_prefill_attention_q8,
            "ragged_q8": rag.ragged_paged_prefill_attention_q8, "matmul": mm.int8_matmul,
            "moe": gmm.grouped_matmul, "moe_q8": gmm.grouped_matmul_q8}


def launch_counts() -> dict[str, int]:
    """Each wrapper's ``launches`` by its short name."""
    return {name: fn.launches for name, fn in wrappers().items()}
