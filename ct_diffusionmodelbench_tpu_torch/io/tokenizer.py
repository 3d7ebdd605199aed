"""Tokenizer wrapper, chat templating, and mask-id resolution.

The port's own copy of ``io/tokenizer.py``, unchanged in behaviour.  Wraps
HF ``transformers.AutoTokenizer`` (tokenization only) when a tokenizer is
available on disk, with a self-contained byte-level fallback so the port
runs where ``transformers`` is missing and in offline/test environments.

Mask-id resolution reproduces the reference chain exactly
(Inference/Llada_MoE/test_simple.py:10-33 ``resolve_mask_id`` +
chat_finetuned.py:147-152): model-config ``mask_token_id`` → tokenizer
``mask_token_id`` → token-string probes ['<|mask|>', '<mask>', '[MASK]',
'<MASK>'] → family defaults (LLaDA-MoE 156895, LLaDA-8B-Instruct 126336).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

MASK_TOKEN_CANDIDATES = ["<|mask|>", "<mask>", "[MASK]", "<MASK>"]
DEFAULT_MOE_MASK_ID = 156895      # Pre-Trained/bench_models/llada.py:45
DEFAULT_INSTRUCT_MASK_ID = 126336  # train_fast_save.py:75


def resolve_mask_id(
    config_mask_id: Optional[int] = None,
    tokenizer=None,
    vocab_size: Optional[int] = None,
    override: Optional[int] = None,
    default: int = DEFAULT_MOE_MASK_ID,
) -> int:
    """The reference's resolution chain, CLI override first."""
    if override is not None:
        return override
    if config_mask_id is not None:
        return config_mask_id
    if tokenizer is not None:
        tid = getattr(tokenizer, "mask_token_id", None)
        if tid is not None and (vocab_size is None or tid < vocab_size):
            return tid
        unk = getattr(tokenizer, "unk_token_id", None)
        for cand in MASK_TOKEN_CANDIDATES:
            try:
                cid = tokenizer.convert_tokens_to_ids(cand)
            except Exception:
                continue
            if cid is not None and cid != unk and (vocab_size is None or cid < vocab_size):
                return cid
    return default


# Default chat template matching the Llama-3-style headers the reference
# hand-rolls when no template ships with the model
# (Training/Training_0to1k/Llada_MoE/train_fast_save.py:55-61).
_FALLBACK_TEMPLATE_BOS = "<|begin_of_text|>"


class Tokenizer:
    """Uniform tokenizer facade.

    ``Tokenizer.from_pretrained(dir)`` loads an HF tokenizer from disk;
    ``Tokenizer.byte_fallback(vocab_size)`` gives a deterministic offline
    tokenizer (bytes shifted past the special ids) for tests and dry runs.
    """

    def __init__(self, backend, kind: str, vocab_size: int,
                 eos_token_id: Optional[int], pad_token_id: Optional[int],
                 eos_token: str = ""):
        self._backend = backend
        self.kind = kind
        self.vocab_size = vocab_size
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id if pad_token_id is not None else eos_token_id
        self.eos_token = eos_token

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_pretrained(cls, model_dir: str | Path) -> "Tokenizer":
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(str(model_dir), trust_remote_code=False)
        return cls(
            tok, "hf",
            vocab_size=len(tok),
            eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id,
            eos_token=tok.eos_token or "",
        )

    @classmethod
    def byte_fallback(cls, vocab_size: int = 512, eos_token_id: int = 2,
                      pad_token_id: int = 0) -> "Tokenizer":
        return cls(None, "byte", vocab_size, eos_token_id, pad_token_id,
                   eos_token="</s>")

    # -- core API -----------------------------------------------------------

    _BYTE_OFFSET = 16  # reserve low ids for specials in byte mode

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        if self.kind == "hf":
            ids = self._backend.encode(text, truncation=max_length is not None,
                                       max_length=max_length)
        else:
            ids = [b + self._BYTE_OFFSET for b in text.encode("utf-8")]
            if max_length is not None:
                ids = ids[:max_length]
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        ids = [int(i) for i in ids]
        if self.kind == "hf":
            return self._backend.decode(ids, skip_special_tokens=skip_special_tokens)
        bs = bytes(i - self._BYTE_OFFSET for i in ids
                   if self._BYTE_OFFSET <= i < self._BYTE_OFFSET + 256)
        return bs.decode("utf-8", errors="replace")

    def convert_tokens_to_ids(self, token: str):
        if self.kind == "hf":
            return self._backend.convert_tokens_to_ids(token)
        return None

    @property
    def mask_token_id(self):
        if self.kind == "hf":
            return getattr(self._backend, "mask_token_id", None)
        return None

    @property
    def unk_token_id(self):
        if self.kind == "hf":
            return getattr(self._backend, "unk_token_id", None)
        return None

    def save_pretrained(self, out_dir: str | Path) -> None:
        """The HF tokenizer's files, or the byte fallback's
        ``tokenizer_config.json``."""
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        if self.kind == "hf":
            self._backend.save_pretrained(str(out_dir))
        else:
            with open(out_dir / "tokenizer_config.json", "w") as f:
                json.dump({"tokenizer_class": "CtdbByteFallback",
                           "vocab_size": self.vocab_size,
                           "eos_token_id": self.eos_token_id}, f)

    # -- chat templating ----------------------------------------------------

    def apply_chat_template(
        self,
        messages: List[Dict[str, str]],
        add_generation_prompt: bool = True,
    ) -> str:
        """Render a chat transcript to a prompt string.

        Uses the model's own template when present (reference:
        ``tokenizer.apply_chat_template(..., add_generation_prompt=True,
        tokenize=False)``, chat_finetuned.py:118); otherwise the Llama-3
        header format the reference hand-rolls (train_fast_save.py:55-61).
        """
        if self.kind == "hf" and getattr(self._backend, "chat_template", None):
            return self._backend.apply_chat_template(
                messages, add_generation_prompt=add_generation_prompt,
                tokenize=False)
        parts = [_FALLBACK_TEMPLATE_BOS]
        for m in messages:
            parts.append(
                f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n"
                f"{m['content']}<|eot_id|>")
        if add_generation_prompt:
            parts.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
        return "".join(parts)
