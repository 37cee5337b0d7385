"""DT104 good: the step returns what it made; the caller keeps it."""

import torch


class Proposer:
    @torch.no_grad()
    def _impl(self, tokens):
        hidden = self.model(tokens)
        return hidden.argmax(-1), hidden

    def propose(self, tokens):
        props, self.last_hidden = self._impl(tokens)
        self.dispatches += 1
        return props
