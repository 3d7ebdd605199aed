"""MiniF2F (Lean 4) pass@1 evaluation with ``lake build`` verification.

Counterpart of ``eval/minif2f.py``: the training-matched prompt (Lean-only
system message + header‖formal_statement), diffusion generation with
``avoid_eos`` and EOS truncation, markdown / ``by`` / ``:= by`` prefix
stripping, lake-project verification, the aggregated pass rate and the same
timestamped result-JSON schema.  Generation on the card and Lean
verification (a CPU subprocess) are pipelined through
:class:`~ct_diffusionmodelbench_tpu_torch.eval.lean.AsyncVerifier`, so the
build of problem i runs while problem i+1 is denoising; ``batch_size`` > 1
decodes a chunk of problems in one left-padded batch.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

from ct_diffusionmodelbench_tpu_torch.eval.lean import AsyncVerifier, LakeProjectVerifier
from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.io.datasets_io import load_minif2f
from ct_diffusionmodelbench_tpu_torch.utils.logging import log

MINIF2F_SYSTEM_PROMPT = (
    "You are a helpful, general-purpose AI assistant.  Respond only with Lean "
    "code (import Mathlib, theorem, proof).  Do not include explanations or "
    "natural language. ")


def extract_lean_code(text: str) -> str:
    """Strip markdown code fences (benchmark_finetuned.py:123-139)."""
    text = text.strip()
    if "```lean" in text:
        parts = text.split("```lean")
        if len(parts) > 1:
            return parts[1].split("```")[0].strip()
    elif "```" in text:
        parts = text.split("```")
        if len(parts) >= 3:
            return parts[1].strip()
    return text


def strip_proof_prefix(proof: str) -> str:
    """The formal_statement already ends with ``by`` — drop a leading
    ``by`` / ``:= by`` / ``:=`` the model may emit (:299-311)."""
    proof = proof.strip()
    if proof.lower().startswith(":= by"):
        return proof[5:].strip()
    if proof.lower().startswith(":="):
        rest = proof[2:].strip()
        return rest[2:].strip() if rest.lower().startswith("by") else rest
    if proof.lower().startswith("by"):
        return proof[2:].strip()
    return proof


def build_minif2f_prompt(runner: ModelRunner, problem: Dict) -> str:
    """Training-matched prompt: Lean source (header + statement) as the user
    message under the Lean-only system prompt (benchmark_finetuned.py:253-265)."""
    header = problem["header"].strip()
    formal_stmt = problem["formal_statement"].strip()
    lean_source = f"{header}\n{formal_stmt}"
    messages = [
        {"role": "system", "content": MINIF2F_SYSTEM_PROMPT},
        {"role": "user", "content": lean_source},
    ]
    return runner.tokenizer.apply_chat_template(messages, add_generation_prompt=True)


def generate_proof(runner: ModelRunner, problem: Dict, *, gen_length: int,
                   steps: int, block_length: int, temperature: float,
                   cfg_scale: float, max_length: int = 2048,
                   seed: int = 0) -> str:
    prompt = build_minif2f_prompt(runner, problem)
    res = runner.generate(
        prompt, max_length=max_length,
        gen_length=gen_length, steps=steps, block_length=block_length,
        temperature=temperature, cfg_scale=cfg_scale,
        avoid_eos=True, truncate_at_eos=True, seed=seed)
    return strip_proof_prefix(extract_lean_code(res.text)), res.latency_sec


def run_minif2f_evaluation(
    runner: ModelRunner,
    json_path: str | Path,
    output_dir: str | Path = "eval_results",
    split: str = "test",
    gen_length: int = 512,
    steps: int = 128,
    block_length: int = 32,
    temperature: float = 0.0,
    cfg_scale: float = 0.0,
    num_samples: Optional[int] = None,
    verify_proofs: bool = True,
    verification_timeout: int = 60,
    reuse_work_dir: bool = False,
    verifier=None,
    pipeline_verification: bool = True,
    batch_size: int = 1,
) -> Dict:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    problems = load_minif2f(json_path, split, num_samples)
    log(f"Using mask_id: {runner.mask_id}")

    if verify_proofs and verifier is None:
        work_dir = output_dir / "lean4_workspace" if reuse_work_dir else None
        verifier = LakeProjectVerifier(work_dir=work_dir,
                                       timeout=verification_timeout)
    async_verifier = (AsyncVerifier(verifier)
                      if verify_proofs and pipeline_verification else None)

    results: List[Dict] = []
    pending: List[tuple] = []  # (result dict, future)
    stats = defaultdict(int)

    def settle(result, verified, message, verify_time):
        result["verified"] = bool(verified)
        result["verification_message"] = message
        result["verification_time_sec"] = round(verify_time, 3)
        if verified:
            stats["verified"] += 1
            log(f"✓ {result['name']} - PASS")
        else:
            log(f"✗ {result['name']} - FAIL: {result['generated_proof'][:100]}...")

    def generated_stream():
        """Yield (problem, proof | exception, gen_time).  batch_size > 1 runs
        the data-parallel left-padded path (BASELINE config 5); each row's
        positions/attention match its single-prompt run.  Per-problem errors
        are yielded, not raised, so one bad problem never kills the sweep
        (benchmark_finetuned.py:426-435)."""
        if batch_size <= 1:
            for problem in problems:
                try:
                    proof, gen_time = generate_proof(
                        runner, problem, gen_length=gen_length, steps=steps,
                        block_length=block_length, temperature=temperature,
                        cfg_scale=cfg_scale)
                    yield problem, proof, gen_time
                except Exception as e:
                    yield problem, e, 0.0
            return
        for lo in range(0, len(problems), batch_size):
            chunk = problems[lo: lo + batch_size]
            try:
                prompts = [build_minif2f_prompt(runner, p) for p in chunk]
                rs = runner.generate_batch(
                    prompts, gen_length=gen_length, steps=steps,
                    block_length=block_length, temperature=temperature,
                    cfg_scale=cfg_scale, avoid_eos=True, truncate_at_eos=True)
                for problem, res in zip(chunk, rs):
                    yield (problem,
                           strip_proof_prefix(extract_lean_code(res.text)),
                           res.latency_sec)
            except Exception as e:
                for problem in chunk:
                    yield problem, e, 0.0

    for problem, proof, gen_time in generated_stream():
        if isinstance(proof, Exception):
            log(f"Error on problem {problem['name']}: {proof}")
            results.append({"name": problem["name"], "error": str(proof),
                            "verified": False, "split": split})
            stats["total"] += 1
            stats["errors"] += 1
            continue
        try:
            result = {
                "name": problem["name"],
                "formal_statement": problem["formal_statement"],
                "informal_statement": problem.get("informal_statement", ""),
                "generated_proof": proof,
                "verified": False,
                "verification_message": "Verification skipped",
                "generation_time_sec": round(gen_time, 3),
                "verification_time_sec": 0,
                "split": split,
            }
            results.append(result)
            stats["total"] += 1

            if verify_proofs:
                if async_verifier is not None:
                    fut = async_verifier.submit(
                        problem["header"], problem["formal_statement"], proof)
                    pending.append((result, fut, time.time()))
                else:
                    t1 = time.time()
                    ok, msg = verifier.verify_proof(
                        problem["header"], problem["formal_statement"], proof)
                    settle(result, ok, msg, time.time() - t1)
        except Exception as e:
            log(f"Error on problem {problem['name']}: {e}")
            results.append({"name": problem["name"], "error": str(e),
                            "verified": False, "split": split})
            stats["total"] += 1
            stats["errors"] += 1

    for result, fut, _t_submit in pending:
        try:
            ok, msg, build_time = fut.result()
        except Exception as e:
            ok, msg, build_time = False, f"Verification exception: {e}", 0.0
        settle(result, ok, msg, build_time)
    if async_verifier is not None:
        async_verifier.shutdown()

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    results_file = output_dir / f"minif2f_lean4_results_{split}_{timestamp}.json"
    output_data = {
        "model_dir": runner.cfg.name,
        "split": split,
        "config": {
            "gen_length": gen_length, "steps": steps,
            "block_length": block_length, "temperature": temperature,
            "cfg_scale": cfg_scale, "mask_id": runner.mask_id,
            "verification_timeout": verification_timeout,
        },
        "stats": {
            "total": stats["total"],
            "verified": stats["verified"],
            "errors": stats["errors"],
            "pass_rate": round(stats["verified"] / stats["total"] * 100, 2)
            if stats["total"] else 0.0,
        },
        "results": results,
        "timestamp": timestamp,
    }
    with open(results_file, "w") as f:
        json.dump(output_data, f, indent=2)

    log(f"\nResults saved to {results_file}")
    log("=" * 60)
    log("EVALUATION SUMMARY")
    log("=" * 60)
    log(f"Total problems: {stats['total']}")
    log(f"Verified proofs: {stats['verified']}")
    log(f"Errors: {stats['errors']}")
    log(f"Pass rate: {output_data['stats']['pass_rate']:.2f}%")
    log("=" * 60)
    return output_data
