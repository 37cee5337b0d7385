"""ModelDeploymentCard — the model manifest.

Everything a frontend needs to know about a served model without loading
its weights: tokenizer, chat template, context length, special tokens,
checksum.  The counterpart of ``dynamo_tpu/llm/model_card.py``, with the
same fields, dict form and checksum, so one card serves either package.
Cards are built from HuggingFace directories; GGUF files and
sentencepiece-only directories are not read yet (such a directory's card
carries no tokenizer).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

__all__ = ["ModelDeploymentCard"]


@dataclass
class ModelDeploymentCard:
    name: str
    model_path: Optional[str] = None        # local HF dir (workers only)
    tokenizer_path: Optional[str] = None    # tokenizer.json
    context_length: int = 4096
    eos_token_ids: list[int] = field(default_factory=list)
    bos_token_id: Optional[int] = None
    # token STRINGS for chat-template rendering: real templates (Llama-3,
    # Mistral) reference {{ bos_token }}/{{ eos_token }} — without these
    # every chat prompt silently loses its BOS marker
    bos_token: Optional[str] = None
    eos_token: Optional[str] = None
    chat_template: Optional[str] = None     # jinja source
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def mdcsum(self) -> str:
        """Stable checksum of the card."""
        payload = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.blake2s(payload, digest_size=8).hexdigest()

    # ------------------------------------------------------------- serde
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "model_path": self.model_path,
            "tokenizer_path": self.tokenizer_path,
            "context_length": self.context_length,
            "eos_token_ids": self.eos_token_ids,
            "bos_token_id": self.bos_token_id,
            "bos_token": self.bos_token,
            "eos_token": self.eos_token,
            "chat_template": self.chat_template,
            "extra": self.extra,
        }

    # -------------------------------------------------------------- loading
    @classmethod
    def from_hf_dir(cls, model_dir: str | Path, name: Optional[str] = None) -> "ModelDeploymentCard":
        """Build a card from a local HuggingFace model directory."""
        d = Path(model_dir)
        cfg = json.loads((d / "config.json").read_text()) if (d / "config.json").exists() else {}

        eos = cfg.get("eos_token_id", [])
        if isinstance(eos, int):
            eos = [eos]
        bos = cfg.get("bos_token_id")

        def _tok_str(v) -> Optional[str]:
            # tokenizer_config.json stores special tokens as plain strings
            # or AddedToken dicts ({"content": "<s>", ...})
            if isinstance(v, str):
                return v
            if isinstance(v, dict) and isinstance(v.get("content"), str):
                return v["content"]
            return None

        chat_template = None
        bos_str = eos_str = None
        tk_cfg_path = d / "tokenizer_config.json"
        if tk_cfg_path.exists():
            tk_cfg = json.loads(tk_cfg_path.read_text())
            chat_template = tk_cfg.get("chat_template")
            bos_str = _tok_str(tk_cfg.get("bos_token"))
            eos_str = _tok_str(tk_cfg.get("eos_token"))
        sep = d / "chat_template.jinja"
        if chat_template is None and sep.exists():
            chat_template = sep.read_text()

        tok = d / "tokenizer.json"
        if not eos and eos_str and tok.exists():
            # config.json had no eos_token_id but tokenizer_config names
            # the token: resolve it here or the engine never receives an
            # EOS stop id (every generation would run to max_tokens)
            try:
                from tokenizers import Tokenizer

                tid = Tokenizer.from_file(str(tok)).token_to_id(eos_str)
                if tid is not None:
                    eos = [tid]
            except Exception:
                pass  # an unreadable tokenizer leaves the card without EOS
        return cls(
            name=name or d.name,
            model_path=str(d),
            tokenizer_path=str(tok) if tok.exists() else None,
            context_length=cfg.get("max_position_embeddings", 4096),
            eos_token_ids=list(eos),
            bos_token_id=bos,
            bos_token=bos_str,
            eos_token=eos_str,
            chat_template=chat_template,
        )
