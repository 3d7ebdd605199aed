"""Diffusion chat CLI, one-shot and interactive.

Counterpart of ``cli/chat.py``, flag for flag, with the `/exit` and
`/reset` REPL over a chat-template history and the Lean-only system-prompt
toggle; ``--device`` picks where it runs (the card by default).  Under
``--dp``/``--tp`` (one process per rank, ``torchrun``) rank 0 reads the
interactive input and hands each line to the other ranks; only rank 0
prints.

    python -m ct_diffusionmodelbench_tpu_torch.cli.chat --preset llada-moe-tiny \\
        --device cpu --prompt "Prove that 1 + 1 = 2."
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional

import torch.distributed as dist

from ct_diffusionmodelbench_tpu_torch.cli.common import (
    add_parallel_flags, rank_zero_output, runner_from_args)
from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.utils.logging import log

BASE_SYSTEM = "You are a helpful, general-purpose AI assistant."
LEAN_SUFFIX = (" Respond only with Lean code (import Mathlib, theorem, proof)."
               " Do not include explanations or natural language.")


def build_system(lean_only: bool, system_message: Optional[str] = None) -> str:
    sys_content = system_message or BASE_SYSTEM
    if lean_only:
        sys_content += LEAN_SUFFIX
    return sys_content


def _load_runner(args) -> ModelRunner:
    if not args.preset:
        log(f"Loading tokenizer/model from: {args.model_dir}")
    return runner_from_args(args)


def run_chat(runner: ModelRunner, prompt_text: str, args) -> Dict:
    messages = [
        {"role": "system", "content": build_system(not args.no_lean_only,
                                                   args.system_message)},
        {"role": "user", "content": prompt_text},
    ]
    prompt = runner.tokenizer.apply_chat_template(messages, add_generation_prompt=True)
    t0 = time.time()
    res = runner.generate(
        prompt, max_length=args.max_length,
        gen_length=args.gen_length, steps=args.steps,
        block_length=args.block_length, temperature=args.temperature,
        cfg_scale=args.cfg_scale, remasking="low_confidence",
        avoid_eos=not args.no_avoid_eos,
        truncate_at_eos=not args.no_truncate_at_eos,
    )
    return {
        "prompt": prompt,
        "generated": res.text,
        "latency_sec": round(time.time() - t0, 3),
        "mask_id": runner.mask_id,
    }


def _read_line(prompt: str) -> Optional[str]:
    """One line of user input (None at end of input), read on rank 0 and
    shared with every rank of a process group."""
    line = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        try:
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            line = None
    if dist.is_initialized():
        box = [line]
        dist.broadcast_object_list(box, src=0)
        line = box[0]
    return line


def interactive_chat(runner: ModelRunner, args) -> None:
    sys_content = build_system(not args.no_lean_only, args.system_message)
    messages: List[Dict[str, str]] = [{"role": "system", "content": sys_content}]

    print("\nInteractive chat started. Commands: /exit, /reset")
    print("Ask me anything. Press Enter to submit.\n")
    while True:
        user_text = _read_line("You: ")
        if user_text is None:
            print("\nExiting.")
            break
        user_text = user_text.strip()
        if not user_text:
            continue
        if user_text.lower() == "/exit":
            print("Goodbye.")
            break
        if user_text.lower() == "/reset":
            messages = [{"role": "system", "content": sys_content}]
            print("History cleared.")
            continue

        messages.append({"role": "user", "content": user_text})
        prompt = runner.tokenizer.apply_chat_template(messages,
                                                      add_generation_prompt=True)
        res = runner.generate(
            prompt, max_length=args.max_length,
            gen_length=args.gen_length, steps=args.steps,
            block_length=args.block_length, temperature=args.temperature,
            cfg_scale=args.cfg_scale,
            avoid_eos=not args.no_avoid_eos,
            truncate_at_eos=not args.no_truncate_at_eos,
        )
        print(f"Assistant:\n{res.text}\n")
        messages.append({"role": "assistant", "content": res.text})


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Chat with a finetuned LLaDA/LLaDA-MoE model using "
                    "diffusion-style generation (PyTorch/CUDA)")
    parser.add_argument("--model-dir", type=str,
                        default=os.environ.get("FAST_OUTPUT_DIR",
                                               "./llada-numina-1kto21k"))
    parser.add_argument("--preset", type=str, default=None,
                        help="Random-init a named preset instead of loading "
                             "--model-dir (offline/dev mode)")
    parser.add_argument("--prompt", type=str, default=None,
                        help="One-shot user prompt (omit or use --interactive for chat)")
    parser.add_argument("--max-length", type=int, default=2048)
    parser.add_argument("--gen-length", type=int, default=128)
    parser.add_argument("--steps", type=int, default=128)
    parser.add_argument("--block-length", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--cfg-scale", type=float, default=0.0)
    parser.add_argument("--no-avoid-eos", action="store_true",
                        help="Allow EOS during generation (discouraged by default)")
    parser.add_argument("--no-truncate-at-eos", action="store_true",
                        help="Do not cut continuation at first EOS")
    parser.add_argument("--no-lean-only", action="store_true",
                        help="Do not force Lean-only system instruction")
    parser.add_argument("--mask-id", type=int, default=None,
                        help="Override mask token id")
    parser.add_argument("--interactive", action="store_true",
                        help="Start an interactive terminal chat session")
    parser.add_argument("--system-message", type=str, default=None,
                        help="Custom system instruction for the assistant")
    add_parallel_flags(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    runner = _load_runner(args)
    with rank_zero_output(args):
        if args.interactive or args.prompt is None:
            interactive_chat(runner, args)
        else:
            result = run_chat(runner, args.prompt, args)
            print("\n=== Generation Result ===")
            print(f"Latency: {result['latency_sec']}s | mask_id={result['mask_id']}")
            print("\nGenerated continuation:\n")
            print(result["generated"])


if __name__ == "__main__":
    main()
