"""Runtime reconciliation of a roofline model (predicted vs measured
dispatch latency).

The counterpart of ``dynamo_tpu/obs/perfmodel.py``, with its interface
(``wants``, ``offer``, ``predicted``, ``predicted_ms``, ``reconcile``,
``reset``) and its ``/metrics`` rows.  The JAX package prices a dispatch by
tracing its jaxpr through its static perf plane; the port prices it from
the shapes the dispatch site offers, with the bound every kernel row of
the port's records uses: the larger of

    bytes / HBM rate      each weight read once per step of the dispatch,
                          each cached key/value token read once, each
                          fresh one written once
    FLOPs / peak rate     2·M·K·N over the weight matrices a token passes
                          (the lm_head only for the sampled rows, a
                          routed expert for top_k of E tokens) plus
                          2·H·(D_qk + D_v) per visible (query, key) pair
                          and layer (4·H·D when the two head dims agree)

with the rates of ``obs/topology.py`` (the H100 SXM datasheet peaks).  A
kind is priced at its first offer, as in the JAX package.  The basis is
the whole model on every layout: on a rank mesh, rank 0 prices the whole
model's weights, heads and KV bytes (what one card would move), as the
JAX package's trace of the global shapes does, not its own slice.

``reconcile(timeline)`` joins the predictions with a step timeline's
per-kind measured dispatch seconds into the rows ``/metrics`` renders as
the perf family.  The measured side is the timeline's dispatch phase: in
eager PyTorch that is the host enqueuing the forward's kernels, so the
ratio reads the launch cost against the card's bound, not the card's own
time.  The static side, the JAX package's ``predicted_step_ms``, is the
port's perf plane (``analysis/perfcheck.py``): ``/metrics`` reads it from
the committed ``analysis/perf_manifest.json``.

Each ``EngineCore`` owns a ``PerfModel``; the module-level ``perf_model``
stays for code written against the JAX package's global.  Never raises into
the engine: a pricing failure is recorded as None.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.obs.topology import DEFAULT_TOPOLOGY, TOPOLOGIES

__all__ = ["ModelShapes", "PerfModel", "model_shapes", "perf_model", "visible_pairs"]


@dataclass(frozen=True)
class ModelShapes:
    """What the roofline needs of a model: matmul weights per token
    (``body_params``: K·N summed over every layer; ``expert_params`` the
    routed experts' stack, of which a token passes ``top_k / experts``),
    the lm_head's K·N, the bytes of every weight (the routed experts'
    apart), the attention geometry, the KV bytes of one token (all layers,
    K and V) and the compute dtype."""

    body_params: int
    head_params: int
    expert_params: int
    experts: int
    top_k: int
    weight_bytes: int
    expert_bytes: int
    layers: int
    heads: int
    qk_dim: int
    v_dim: int
    kv_bytes_per_token: int
    dtype: str


def model_shapes(model, kv_bytes_per_token: int) -> ModelShapes:
    """Read :class:`ModelShapes` off a port model's weights and config.
    Weight matrices are the stacked per-layer tensors (``[L, K, N]``), the
    routed experts' ``[L, E, K, N]``; the embedding is a gather, not read
    whole, unless it doubles as the lm_head.

    Every term is the whole model's, as the JAX package traces the global
    shapes: each parameter's size is read off the model's whole shapes
    (``full_shapes``; a mesh rank holds slices of them), beside the whole
    model's heads and ``kv_bytes_per_token`` (every kv head).  Buffers
    (``inv_freq``) are not in ``full_shapes`` and are read as they are."""
    cfg = model.config
    named = dict(model.named_parameters())
    named.update(dict(model.named_buffers()))
    full = model.full_shapes()
    head_name = "lm_head" if "lm_head" in named else "embed"
    body = head = expert = 0
    wbytes = ebytes = 0
    experts = 0
    for name, t in named.items():
        shape = full.get(name, tuple(t.shape))
        numel = math.prod(shape)
        nbytes = numel * t.element_size()
        base = name.rsplit(".", 1)[-1].removesuffix("_scale")
        if base == head_name:
            wbytes += nbytes
            if not name.endswith("_scale"):
                head = numel
            continue
        if base in ("embed", "inv_freq"):
            continue
        if len(shape) == 4:  # [L, E, K, N]: routed experts
            ebytes += nbytes
            if not name.endswith("_scale"):
                expert += numel
                experts = shape[1]
            continue
        wbytes += nbytes
        if len(shape) == 3 and not name.endswith("_scale"):
            body += numel
    qk = getattr(cfg, "head_dim", None) or (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    v = getattr(cfg, "v_head_dim", None) or qk
    return ModelShapes(
        body_params=body, head_params=head, expert_params=expert, experts=experts,
        top_k=int(getattr(cfg, "num_experts_per_tok", 0) or 0) if experts else 0,
        weight_bytes=wbytes, expert_bytes=ebytes, layers=cfg.num_layers,
        heads=cfg.num_heads, qk_dim=qk, v_dim=v, kv_bytes_per_token=kv_bytes_per_token,
        dtype=str(cfg.dtype))


def visible_pairs(starts, lens) -> int:
    """Visible (query, key) pairs of rows whose fresh tokens run from
    ``start`` to ``len``: each sees the row's cached prefix and its own
    fresh tokens causally."""
    return sum((n - s) * s + (n - s) * (n - s + 1) // 2 for s, n in zip(starts, lens))


def price(shapes: ModelShapes, *, tokens: int, sampled: int, pairs: int, kv_tokens: int,
          steps: int = 1) -> dict:
    """The roofline of one dispatch: ``tokens`` computed and ``sampled``
    rows through the lm_head over all ``steps``, ``pairs`` visible pairs
    and ``kv_tokens`` cached tokens read (both summed over the steps)."""
    topo = TOPOLOGIES[DEFAULT_TOPOLOGY]
    peak = topo["peak_flops"].get(shapes.dtype, topo["default_flops"])
    flops = 2 * (tokens * shapes.body_params + sampled * shapes.head_params)
    nbytes = steps * shapes.weight_bytes + shapes.kv_bytes_per_token * (kv_tokens + tokens)
    if shapes.experts:
        routed = tokens * shapes.top_k / shapes.experts
        flops += 2 * routed * shapes.expert_params
        # each step reads the experts its rows route to, at most all of them
        per_step = min(1.0, routed / steps)
        nbytes += steps * per_step * shapes.expert_bytes
    flops += 2 * shapes.heads * (shapes.qk_dim + shapes.v_dim) * pairs * shapes.layers
    t_ops, t_bytes = flops / peak, nbytes / topo["hbm_bw"]
    return {"flops": flops, "bytes": nbytes, "bound": "compute" if t_ops >= t_bytes else "memory",
            "predicted": {"total_ms": 1e3 * max(t_ops, t_bytes)}}


class PerfModel:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Test isolation hook."""
        self.enabled = True
        # kind -> the priced estimate (None if pricing failed)
        self._entries: dict[str, Optional[dict]] = {}

    # ------------------------------------------------------------ hot path
    def wants(self, kind: str) -> bool:
        """True until a dispatch of this kind has been offered — the
        per-dispatch cost afterwards is this one dict lookup."""
        return self.enabled and kind not in self._entries

    def offer(self, kind: str, shapes: ModelShapes, **work) -> None:
        """Price one dispatch of ``kind`` from the model's shapes and the
        dispatch's work (:func:`price`'s keywords); later offers of the
        same kind are ignored."""
        if not self.wants(kind):
            return
        try:
            est = price(shapes, **work)
        except Exception:
            est = None  # monitoring must never break the dispatch
        with self._lock:
            self._entries.setdefault(kind, est)

    # ------------------------------------------------------------- readers
    def kinds(self) -> list[str]:
        return sorted(self._entries)

    def predicted(self, kind: str) -> Optional[dict]:
        """The roofline estimate of an offered kind (None if never offered
        or the pricing failed)."""
        return self._entries.get(kind)

    def predicted_ms(self, kind: str) -> Optional[float]:
        est = self.predicted(kind)
        if est is None:
            return None
        return est["predicted"]["total_ms"]

    def reconcile(self, timeline=None) -> list[dict]:
        """Predicted-vs-measured rows per dispatch kind, joining the
        predictions with ``timeline``'s per-kind measured dispatch seconds
        (default: the module-level ``step_timeline``)."""
        if timeline is None:
            from dynamo_tpu_torch.obs.timeline import step_timeline as timeline

        measured = timeline.snapshot().get("dispatch_kinds", {})
        rows: list[dict] = []
        for kind in sorted(set(self.kinds()) | set(measured)):
            m = measured.get(kind, {})
            n = m.get("count", 0)
            meas_ms = (round(m.get("seconds", 0.0) / n * 1e3, 6)
                       if n else None)
            pred_ms = self.predicted_ms(kind)
            rows.append({
                "kind": kind,
                "predicted_ms": pred_ms,
                "measured_ms": meas_ms,
                "dispatches": n,
                # 4 significant digits, not 4 decimals: a predicted ms can be
                # orders of magnitude under the measured one
                "error_ratio": (
                    float(f"{pred_ms / meas_ms:.4g}")
                    if pred_ms is not None and meas_ms else None
                ),
            })
        return rows


perf_model = PerfModel()
