"""DT103 bad: the KV cache rebuilt out of place."""

import torch


class Engine:
    def append(self, rows):
        self.cache = torch.cat([self.cache, rows], dim=1)

    def move(self, device):
        self.cache = self.cache.to(device)


@torch.no_grad()
def decode_step(model, cache, toks):
    logits = model(toks, cache)
    return logits, cache.clone()
