"""Versioned hardware constants of the card the port serves on.

The counterpart of ``dynamo_tpu/obs/topology.py``, with the same names and
functions, but the figures of one NVIDIA H100 SXM instead of a TPU's:

- ``obs/perfmodel.py`` prices a dispatch as
  ``max(FLOPs / peak_flops, bytes / hbm_bw)`` (plus collective terms, which
  are 0 on one card);
- ``obs/costs.py`` seeds never-observed (src, dst, path) transfer edges
  with a derated rate so transfer-aware routing has a cost before the
  first measured transfer replaces it.

The compute and memory peaks are NVIDIA's published H100 SXM datasheet
figures (dense bf16 tensor cores, HBM3), the ones every bound the port
records uses.  ``"ici"`` names the colocated handoff, which on one card is
an on-card copy: each byte read and written once, so half the HBM rate.
``"dcn"`` assumes a 25 Gbps NIC and ``"persist"`` a 1 GB/s shared-store
read.  ``"nvlink"`` is the link between two cards of one H100 SXM host:
NVIDIA's datasheet gives 900 GB/s of NVLink bandwidth per GPU, both
directions together, so 450 GB/s each way; its 2 us hop latency is an
assumption.  Only the peaks and the NVLink rate are datasheet figures;
the other link and store rates are assumptions, replaced by the first
measurement on each edge.

:func:`collective_cost_s` prices ring collectives over the mesh axes
(``utils/mesh.py``): over NVLink within a host, over ``"dcn"`` across
hosts.  A link that is not in the table raises: two ranks that share one
card and talk through gloo's host buffers (``DYN_MH_BACKEND=gloo``) move
their bytes through host memory, at no rate this table states.
"""

from __future__ import annotations

__all__ = [
    "AXIS_DATA",
    "AXIS_MODEL",
    "AXIS_SP",
    "CONSTANTS_VERSION",
    "DEFAULT_TOPOLOGY",
    "MESH_AXES",
    "TOPOLOGIES",
    "collective_cost_s",
    "path_prior_bw",
    "prior_cost_s",
]

# Bump on any numeric change below.
CONSTANTS_VERSION = "h100-sxm-2026.10.1"

# Canonical mesh axis names, as in the JAX package; utils/mesh.py builds
# the (data, model) rank mesh from them.
AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SP = "sp"
MESH_AXES = (AXIS_DATA, AXIS_MODEL)

DEFAULT_TOPOLOGY = "h100"

_HBM_BW = 3.35e12  # H100 SXM datasheet: HBM3 bytes/s

TOPOLOGIES: dict[str, dict] = {
    "h100": {
        # peak compute by input dtype, FLOP/s (datasheet, dense)
        "peak_flops": {
            "bfloat16": 989e12,
            "float16": 989e12,
            "float32": 67e12,    # outside the tensor cores
            "int8": 1979e12,
        },
        "default_flops": 989e12,
        "hbm_bytes": 80 * 10**9,
        "hbm_bw": _HBM_BW,
        # the colocated handoff: an on-card copy reads and writes each byte
        "ici_bw": _HBM_BW / 2,
        "ici_latency_s": 10e-6,
        # NVLink 4 between two cards of one host: the datasheet's 900 GB/s
        # per GPU counts both directions; the hop latency is assumed
        "nvlink_bw": 450e9,
        "nvlink_latency_s": 2e-6,
        # an assumed 25 Gbps NIC, plus a TCP hop
        "dcn_bw": 3.125e9,
        "dcn_latency_s": 50e-6,
        # an assumed shared-store read + restore through the host
        "persist_bw": 1e9,
        "persist_latency_s": 1e-3,
    },
}

# Derate applied to priors for never-measured transfer edges: real
# transfers pay serialization and host hops a link rate ignores, so the
# prior under-promises until a measurement lands.
_PRIOR_EFFICIENCY = 0.6

# transfer-path name (obs/costs.py vocabulary) -> constants keys
_PATH_KEYS = {
    "ici": ("ici_bw", "ici_latency_s"),
    "nvlink": ("nvlink_bw", "nvlink_latency_s"),
    "dcn": ("dcn_bw", "dcn_latency_s"),
    "persist": ("persist_bw", "persist_latency_s"),
}


def path_prior_bw(path: str, topology: str = DEFAULT_TOPOLOGY) -> float:
    """Derated bytes/s prior for a transfer path; unknown paths get the
    slowest (persist) prior so they are never free."""
    topo = TOPOLOGIES[topology]
    bw_key, _ = _PATH_KEYS.get(path, _PATH_KEYS["persist"])
    return topo[bw_key] * _PRIOR_EFFICIENCY


def prior_cost_s(path: str, nbytes: int,
                 topology: str = DEFAULT_TOPOLOGY) -> float:
    """Heuristic seconds to move ``nbytes`` over a never-measured path:
    latency floor + derated-rate term."""
    topo = TOPOLOGIES[topology]
    bw_key, lat_key = _PATH_KEYS.get(path, _PATH_KEYS["persist"])
    return topo[lat_key] + nbytes / (topo[bw_key] * _PRIOR_EFFICIENCY)


def collective_cost_s(op: str, axis_size: int, payload_bytes: int,
                      topology: str = DEFAULT_TOPOLOGY,
                      link: str = "nvlink") -> float:
    """Cost of one collective over a ring of ``axis_size`` cards moving
    ``payload_bytes`` (the per-rank payload), as the JAX package prices it:
    an all-reduce moves 2(n-1)/n of the payload over the slowest link, an
    all-gather, reduce-scatter or all-to-all (n-1)/n, a ring shift
    (``ppermute``, ``send_recv``) the payload once; each ring step pays one
    hop of latency.  0 on one card.  A ``link`` the table has no rate for
    (``"gloo"``: two ranks through host buffers) raises rather than price
    the collective with a made-up rate."""
    if axis_size <= 1:
        return 0.0
    if link not in _PATH_KEYS or link == "persist":
        raise NotImplementedError(
            f"{op} over {axis_size} ranks on link {link!r}: the {topology} table has no rate "
            f"for it (priced links: nvlink, dcn)")
    topo = TOPOLOGIES[topology]
    bw_key, lat_key = _PATH_KEYS[link]
    bw, lat = topo[bw_key], topo[lat_key]
    n = axis_size
    if op in ("all_gather", "reduce_scatter", "all_to_all"):
        traffic, hops = (n - 1) / n * payload_bytes, n - 1
    elif op in ("ppermute", "send_recv"):
        traffic, hops = float(payload_bytes), 1
    else:  # all_reduce, and an unknown collective is charged as one
        traffic, hops = 2.0 * (n - 1) / n * payload_bytes, 2 * (n - 1)
    return traffic / bw + hops * lat
