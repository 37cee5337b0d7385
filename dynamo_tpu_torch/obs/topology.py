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
read.  Only the peaks are datasheet figures; the link and store rates are
assumptions, replaced by the first measurement on each edge.

The port runs on one card: link rates between cards (NVLink, the network
of a multi-card mesh) are not in the table, so a collective over an axis
of more than one card cannot be priced and raises.
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

# Canonical mesh axis names, as in the JAX package (the port has no mesh
# yet: every axis has size 1).
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
                      link: str = "ici") -> float:
    """Cost of one collective over ``axis_size`` cards: 0 on one card.
    The table holds no link rates between cards, so a larger axis raises
    rather than price the collective with a made-up rate."""
    if axis_size <= 1:
        return 0.0
    raise NotImplementedError(
        f"{op} over {axis_size} cards: the {topology} table has no link rates "
        "between cards (the port serves on one card)")
