"""DT102 bad: a host read per loop iteration on the hot path."""

import torch


def decode(model, toks, steps):
    out = []
    for _ in range(steps):
        toks = model(toks).argmax(-1)
        out.append(toks.item())
    return out


def drain(results):
    rows = []
    while results:
        rows.append(results.pop().cpu().numpy())
    return rows


def wait_each(outs):
    for o in outs:
        torch.cuda.synchronize()
    return outs
