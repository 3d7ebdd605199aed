"""Autoregressive baseline chat CLI.

Counterpart of ``cli/chat_base.py``: interactive chat with cache-less AR
decoding (``sampling/simple.py::ar_generate``) over the causal, unshifted
form of a model, the sanity baseline for a base model.  Keeps the
10-message history cap; the sampling noise comes from a ``torch.Generator``
seeded from ``--seed``; ``--device`` picks where it runs (the card by
default).

    python -m ct_diffusionmodelbench_tpu_torch.cli.chat_base --preset llada-tiny \\
        --device cpu --prompt "hello"
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.cli.common import add_device_flag
from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.models.transformer import make_forward_fn
from ct_diffusionmodelbench_tpu_torch.sampling.simple import ar_generate

HISTORY_CAP = 10  # the reference keeps the last 10 messages


def build_parser():
    p = argparse.ArgumentParser(description="Chat with an AR baseline model")
    p.add_argument("--model-dir", type=str, default=None)
    p.add_argument("--preset", type=str, default=None)
    p.add_argument("--prompt", type=str, default=None, help="One-shot prompt")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--max-length", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    add_device_flag(p)
    return p


def as_causal(runner: ModelRunner) -> ModelRunner:
    """AR baseline semantics: a causal mask and no diffusion logit shift
    (``ar_generate`` reads logits[:, pos - 1] itself; a shifted
    Dream/DiffuCoder forward would sample from pos - 2).  The forward is
    rebuilt on the runner's device."""
    runner.cfg = runner.cfg.replace(causal=True, logit_shift=False)
    runner.forward_fn = make_forward_fn(runner.cfg, device=runner.device)
    return runner


def _respond(runner, messages, args) -> str:
    prompt = runner.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
    ids = np.asarray(runner.tokenizer.encode(prompt, max_length=args.max_length),
                     np.int64)
    gen = torch.Generator(device=runner.device)
    gen.manual_seed(args.seed)
    out = ar_generate(
        runner.forward_fn, runner.params,
        torch.from_numpy(ids)[None].to(runner.device),
        max_new_tokens=args.max_new_tokens,
        temperature=args.temperature, top_p=args.top_p,
        eos_token_id=runner.eos_token_id,
        pad_token_id=runner.tokenizer.pad_token_id or 0,
        generator=gen)
    cont = out[0, len(ids):].cpu().numpy()
    if runner.eos_token_id is not None:
        hits = np.nonzero(cont == runner.eos_token_id)[0]
        if hits.size:
            cont = cont[: int(hits[0])]
    return runner.tokenizer.decode(cont, skip_special_tokens=True)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.preset:
        runner = ModelRunner.random_init(args.preset, device=args.device)
    elif args.model_dir:
        runner = ModelRunner.from_dir(args.model_dir, device=args.device)
    else:
        raise SystemExit("need --model-dir or --preset")
    as_causal(runner)

    messages = [{"role": "system",
                 "content": "You are a helpful, general-purpose AI assistant."}]

    if args.prompt is not None:
        messages.append({"role": "user", "content": args.prompt})
        print(_respond(runner, messages, args))
        return

    print("\nAR baseline chat. Commands: /exit, /reset\n")
    while True:
        try:
            user_text = input("You: ").strip()
        except (EOFError, KeyboardInterrupt):
            print("\nExiting.")
            break
        if not user_text:
            continue
        if user_text.lower() == "/exit":
            break
        if user_text.lower() == "/reset":
            messages = messages[:1]
            print("History cleared.")
            continue
        messages.append({"role": "user", "content": user_text})
        if len(messages) > HISTORY_CAP:
            messages = [messages[0]] + messages[-(HISTORY_CAP - 1):]
        reply = _respond(runner, messages, args)
        print(f"Assistant:\n{reply}\n")
        messages.append({"role": "assistant", "content": reply})


if __name__ == "__main__":
    main()
