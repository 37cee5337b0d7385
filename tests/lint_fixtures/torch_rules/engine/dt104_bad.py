"""DT104 bad: a step function keeps a tensor on self."""

import torch


class Proposer:
    @torch.no_grad()
    def _impl(self, tokens):
        self.last_hidden = self.model(tokens)
        return self.last_hidden.argmax(-1)


class Model:
    @torch.no_grad()
    def forward(self, tokens):
        self.scratch = tokens * 2
        return self.scratch
