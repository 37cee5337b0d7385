"""DT102 good: the turns stay on the device, one read after the loop."""

import torch


def decode(model, toks, steps):
    out = []
    for _ in range(steps):
        toks = model(toks).argmax(-1)
        out.append(toks)
    return torch.stack(out).cpu().numpy()
