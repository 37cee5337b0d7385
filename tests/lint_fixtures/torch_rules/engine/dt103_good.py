"""DT103 good: the KV cache is written in place and returned as it is."""

import torch


class Engine:
    def __init__(self, model):
        self.cache = model.init_kv_cache(64, 16)

    def append(self, slots, rows):
        self.cache.index_copy_(1, slots, rows)


@torch.no_grad()
def decode_step(model, cache, toks):
    logits = model(toks, cache)
    return torch.stack([logits, logits]), cache
