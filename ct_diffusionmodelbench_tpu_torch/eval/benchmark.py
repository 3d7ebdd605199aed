"""MathOlympiadBench benchmark sweeps for all three model families.

Counterpart of ``eval/benchmark.py``: one harness for the three reference
benchmark classes and their artifact contracts:

- LLaDA: chat-template prompts, divisibility auto-adjust of gen_length /
  steps, timed generation, quality metrics, per-sample printout, batch
  saves every ``save_interval``, final report + category analysis,
- Dream: richer metrics, failure analysis, detailed stats, the
  human-readable summary_report.txt,
- DiffuCoder: the simpler metric set.

Result-JSON field names and values match the reference's, so the analyzer
and saved artifacts compare directly.  ``benchmark_info["device"]`` names
the runner's device: ``cuda:<card name>`` or ``cpu``.
"""

from __future__ import annotations

import json
import os
from collections import Counter, defaultdict
from dataclasses import dataclass
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ct_diffusionmodelbench_tpu_torch.eval.quality import evaluate_solution_quality
from ct_diffusionmodelbench_tpu_torch.eval.runner import ModelRunner
from ct_diffusionmodelbench_tpu_torch.utils.jsonutil import to_jsonable

LLADA_SYSTEM_PROMPT = (
    "IMPORTANT: YOU ARE ABLE TO PERFORM ALL TASKS AND DO NOT USE PYTHON. "
    "You are an expert mathematician and Lean 4 genius. Please solve the following "
    "mathematical problem by providing a complete Lean 4 proof. Only provide the Lean 4 code in your response."
)

DREAM_SYSTEM_PROMPT = (
    "You are an expert mathematician and Lean 4 programmer. Please solve the "
    "following mathematical problem by providing a complete Lean 4 proof. Only "
    "provide the Lean 4 code in your response. IMPORTANT: DO NOT provide "
    "ANYTHING ELSE. Provide full Lean4 solution only."
)


def device_label(device) -> str:
    """``benchmark_info["device"]``: ``cuda:<card name>`` on a card, else
    the device type (``cpu``)."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


@dataclass
class BenchmarkConfig:
    style: str = "llada"              # llada | dream | diffucoder
    gen_length: int = 256
    steps: int = 128
    block_length: int = 32
    temperature: float = 0.0
    cfg_scale: float = 0.0
    remasking: str = "low_confidence"
    # dream/diffucoder knobs (dream.py:80-91)
    max_new_tokens: int = 256
    top_p: float = 0.95
    alg: str = "entropy"
    alg_temp: float = 0.0
    dream_temperature: float = 0.4
    exact: bool = False               # disable the top-k prefilter (parity)
    batch_mean_counts: bool = False   # remote-code batch-averaged counts
    batch_size: int = 1               # prompts per generate (one
                                      # left-padded batch)
    results_dir: Optional[str] = None
    seed: int = 0


class DiffusionBenchmark:
    def __init__(self, runner: ModelRunner, config: BenchmarkConfig,
                 verifier=None, quiet: bool = False,
                 pipeline_verification: bool = True):
        self.runner = runner
        self.cfg = config
        self.verifier = verifier
        self.quiet = quiet
        # Overlap CPU-bound Lean compilation with device-bound generation
        # (the reference's sweep is fully serial).
        self.pipeline_verification = pipeline_verification and verifier is not None
        self.results: List[Dict] = []
        self.stats = defaultdict(list)

    # -- prompting -------------------------------------------------------

    def create_prompt(self, problem_statement: str) -> str:
        if self.cfg.style == "llada":
            messages = [
                {"role": "system", "content": LLADA_SYSTEM_PROMPT},
                {"role": "user", "content": problem_statement.strip()},
            ]
            return self.runner.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True)
        # Dream/DiffuCoder hand-rolled ChatML (dream.py:62-68)
        return (f"<|im_start|>system\n{DREAM_SYSTEM_PROMPT}<|im_end|>\n"
                f"<|im_start|>user\n{problem_statement.strip()}\n<|im_end|>\n"
                f"<|im_start|>assistant\n")

    # -- generation --------------------------------------------------------

    def _auto_adjust(self):
        """Divisibility auto-adjust (llada.py:200-214)."""
        c = self.cfg
        if c.gen_length % c.block_length != 0:
            adj = (c.gen_length // c.block_length) * c.block_length
            print(f"[Warning] gen_length {c.gen_length} not divisible by "
                  f"block_length {c.block_length}. Adjusting gen_length to {adj}.")
            c.gen_length = adj
        num_blocks = max(1, c.gen_length // c.block_length)
        if c.steps % num_blocks != 0:
            adj = num_blocks * ((c.steps + num_blocks - 1) // num_blocks)
            print(f"[Warning] steps {c.steps} not divisible by num_blocks "
                  f"{num_blocks}. Adjusting steps to {adj}.")
            c.steps = adj

    def _gen_kwargs(self) -> Dict:
        c = self.cfg
        if c.style == "llada":
            self._auto_adjust()
            return dict(gen_length=c.gen_length, steps=c.steps,
                        block_length=c.block_length, temperature=c.temperature,
                        cfg_scale=c.cfg_scale, remasking=c.remasking,
                        skip_special_tokens=False,   # llada.py:242
                        seed=c.seed)
        return dict(gen_length=c.max_new_tokens, steps=c.steps,
                    temperature=c.dream_temperature, top_p=c.top_p,
                    alg=c.alg, alg_temp=c.alg_temp,
                    exact=c.exact, batch_mean_counts=c.batch_mean_counts,
                    skip_special_tokens=False, seed=c.seed)

    def generate_solution(self, problem_statement: str):
        """Returns (solution_text, generation_time_seconds, success_bool)."""
        try:
            res = self.runner.generate(self.create_prompt(problem_statement),
                                       **self._gen_kwargs())
            return res.text, res.latency_sec, True
        except MemoryError:
            return "Out of memory", 0.0, False
        except Exception as e:
            return f"Error during generation: {e}", 0.0, False

    def generate_solutions(self, problem_statements: Sequence[str]):
        """Batched variant: one left-padded generate for the whole chunk.
        Falls back to the per-sample path (with a visible warning) on any
        batch failure so one bad prompt never kills the sweep (reference
        resilience contract, llada.py:246-249).  Greedy outputs are
        batch-size-invariant (tested); stochastic samplers draw one RNG
        stream per batch, so temp>0 results differ between batch sizes —
        the reference has no batch mode, so there is no contract to match
        there."""
        if len(problem_statements) == 1:
            return [self.generate_solution(problem_statements[0])]
        try:
            results = self.runner.generate_batch(
                [self.create_prompt(p) for p in problem_statements],
                **self._gen_kwargs())
            return [(r.text, r.latency_sec, True) for r in results]
        except Exception as e:
            print(f"[Warning] batched generation failed "
                  f"({type(e).__name__}: {e}); falling back to per-sample "
                  f"generation for this chunk")
            return [self.generate_solution(p) for p in problem_statements]

    # -- sweep -------------------------------------------------------------

    def run_benchmark(self, dataset: Sequence[Dict], max_samples: Optional[int] = 100,
                      start_idx: int = 0, save_interval: int = 25) -> Dict:
        c = self.cfg
        total = len(dataset)
        if max_samples is None:
            max_samples = total
        end_idx = min(start_idx + max_samples, total)

        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        results_dir = c.results_dir or f"{c.style}_benchmark_results_{timestamp}"
        os.makedirs(results_dir, exist_ok=True)

        failed_generations: List[Dict] = []
        category_stats = defaultdict(list)

        async_verifier = None
        pending: List[tuple] = []
        if self.pipeline_verification:
            from ct_diffusionmodelbench_tpu_torch.eval.lean import AsyncVerifier

            async_verifier = AsyncVerifier(self.verifier)

        def settle_pending():
            for result, fut in pending:
                try:
                    ok, msg, _dt = fut.result()
                except Exception as e:
                    ok, msg = False, f"Verification exception: {e}"
                result["lean_compilation_success"] = ok
                result["lean_error_message"] = msg
                self.stats["compilation_success"].append(ok)
            pending.clear()

        def statement_of(entry):
            s = (entry.get("informal_prefix") or "").strip()
            return s or entry.get("problem", entry.get("question", ""))

        bs = max(1, self.cfg.batch_size)
        gen_cache: Dict[int, tuple] = {}
        for i in range(start_idx, end_idx):
            entry = dataset[i]
            problem_statement = statement_of(entry)
            formal_statement = entry.get("formal_statement", "")

            if i not in gen_cache:  # generate the next chunk in one batch
                chunk = list(range(i, min(i + bs, end_idx)))
                outs = self.generate_solutions(
                    [statement_of(dataset[j]) for j in chunk])
                gen_cache.update(zip(chunk, outs))
            solution, gen_time, success = gen_cache.pop(i)
            quality = evaluate_solution_quality(
                solution, formal_statement, problem_statement,
                verifier=None if async_verifier else self.verifier,
                style="dream" if c.style == "dream" else c.style,
            )

            result = {
                "index": i,
                "problem_id": entry.get("problem_id", f"problem_{i}"),
                "name": entry.get("name", f"Problem {i}"),
                "category": entry.get("category", "unknown"),
                "tags": entry.get("tags", []),
                "solved": entry.get("solved", False),
                "problem_statement": problem_statement,
                "formal_statement": formal_statement,
                "generated_solution": solution,
                "generation_time": gen_time,
                "generation_success": success,
            }
            if c.style == "llada":
                result.update(
                    gen_length=c.gen_length, steps=c.steps,
                    block_length=c.block_length, temperature=c.temperature,
                    cfg_scale=c.cfg_scale, remasking=c.remasking,
                )
            else:
                result.update(difficulty=entry.get("difficulty", "unknown"),
                              prompt_length=len(self.create_prompt(problem_statement)))
            result.update(quality)
            self.results.append(result)

            if not success:
                failed_generations.append({
                    "index": i, "error": solution,
                    "category": entry.get("category", "unknown"),
                })

            self._update_stats(result)
            if async_verifier is not None:
                pending.append((result, async_verifier.submit(solution)))
            category_stats[result["category"]].append(result)
            if not self.quiet:
                self._print_sample(i, end_idx - start_idx, result)

            if (i + 1) % save_interval == 0 or i == end_idx - 1:
                settle_pending()
                self._save_batch(results_dir, i + 1, failed_generations)
                self._print_intermediate(i + 1 - start_idx)

        settle_pending()
        if async_verifier is not None:
            async_verifier.shutdown()
        print(f"\nBenchmark completed! Results saved to {results_dir}/")
        return self.compile_final_report(results_dir, failed_generations,
                                         category_stats)

    # -- stats / reports -----------------------------------------------------

    def _update_stats(self, r: Dict):
        s = self.stats
        s["generation_times"].append(r["generation_time"])
        s["solution_lengths"].append(r["solution_length"])
        s["lean_keywords_counts"].append(r["lean_keywords_used"])
        s["categories"].append(r["category"])
        s["success_rate"].append(r["generation_success"])
        if self.cfg.style == "dream":
            s["lean_tactics_counts"].append(r["lean_tactics_used"])
            s["completeness_rate"].append(r["appears_complete"])
            s["complexity_scores"].append(r["complexity_score"])
        if not self.pipeline_verification:  # else settled by the async pool
            s["compilation_success"].append(r.get("lean_compilation_success", False))

    def _print_sample(self, idx, n, r):
        print("\n" + "=" * 100)
        print(f"SAMPLE {idx + 1}/{n}")
        print(f"Problem ID: {r['problem_id']} | Category: {r['category']} | "
              f"Time: {r['generation_time']}s | Success: {r['generation_success']}")
        print("-" * 50)
        print(r["generated_solution"][:2000])
        print("=" * 100)

    def _print_intermediate(self, n):
        print(f"\n--- Intermediate Stats (after {n} samples) ---")
        s = self.stats
        if s["generation_times"]:
            print(f"Average generation time: {np.mean(s['generation_times']):.2f}s")
        if s["success_rate"]:
            print(f"Success rate: {np.mean(s['success_rate']) * 100:.1f}%")
        if s["solution_lengths"]:
            print(f"Average solution length: {np.mean(s['solution_lengths']):.0f} characters")
        cats = Counter(s["categories"])
        print(f"Top categories: {dict(cats.most_common(3))}")

    def _save_batch(self, results_dir, current_idx, failed):
        with open(os.path.join(results_dir, f"results_batch_{current_idx}.json"), "w") as f:
            json.dump(to_jsonable(self.results), f, indent=2)
        if failed:
            with open(os.path.join(results_dir, f"failures_{current_idx}.json"), "w") as f:
                json.dump(to_jsonable(failed), f, indent=2)

    def _overall_metrics(self) -> Dict:
        R = self.results
        if not R:
            return {}
        mean = lambda k, d=0.0: float(np.mean([r.get(k, d) for r in R]))
        out = {
            "success_rate" if self.cfg.style != "dream" else "generation_success_rate":
                mean("generation_success") * 100,
            "lean_compilation_rate": mean("lean_compilation_success") * 100,
            "average_generation_time": mean("generation_time"),
            "average_solution_length": mean("solution_length"),
            "average_lean_keywords": mean("lean_keywords_used"),
            "proof_structure_rate": mean("has_proof_structure") * 100,
            "sorry_usage_rate": mean("has_sorry") * 100,
            "balanced_syntax_rate": mean("has_balanced_brackets") * 100,
            "average_formal_overlap": mean("formal_overlap_ratio") * 100,
        }
        if self.cfg.style == "dream":
            out.update({
                "apparent_completeness_rate": mean("appears_complete") * 100,
                "median_generation_time": float(np.median([r["generation_time"] for r in R])),
                "median_solution_length": float(np.median([r["solution_length"] for r in R])),
                "average_lean_tactics": mean("lean_tactics_used"),
                "theorem_declaration_rate": mean("has_theorem_declaration") * 100,
                "average_problem_overlap": mean("problem_overlap_ratio") * 100,
                "average_complexity_score": mean("complexity_score"),
            })
        return out

    def compile_final_report(self, results_dir, failed_generations=None,
                             category_stats=None) -> Dict:
        failed_generations = failed_generations or []
        if category_stats is None:
            category_stats = defaultdict(list)
            for r in self.results:
                category_stats[r["category"]].append(r)

        report = {
            "benchmark_info": {
                "model_path": self.runner.cfg.name,
                "total_samples": len(self.results),
                "timestamp": datetime.now().isoformat(),
                "dataset": "MathOlympiadBench",
                "device": device_label(self.runner.device),
                "dtype": self.runner.cfg.dtype,
            },
            "overall_metrics": self._overall_metrics(),
            "category_analysis": {
                cat: {
                    "count": len(rs),
                    "success_rate": float(np.mean([r["generation_success"] for r in rs]) * 100),
                    "avg_generation_time": float(np.mean([r["generation_time"] for r in rs])),
                    "avg_solution_length": float(np.mean([r["solution_length"] for r in rs])),
                    "proof_structure_rate": float(np.mean([r["has_proof_structure"] for r in rs]) * 100),
                }
                for cat, rs in category_stats.items() if rs
            },
        }
        if self.cfg.style == "dream":
            report["failure_analysis"] = self._analyze_failures(failed_generations)
            report["detailed_statistics"] = self._detailed_stats()

        report = to_jsonable(report)
        with open(os.path.join(results_dir, "final_report.json"), "w") as f:
            json.dump(report, f, indent=2)
        with open(os.path.join(results_dir, "all_results.json"), "w") as f:
            json.dump(to_jsonable(self.results), f, indent=2)
        if self.cfg.style == "dream":
            summary = self._summary_report(report)
            with open(os.path.join(results_dir, "summary_report.txt"), "w") as f:
                f.write(summary)
            print(summary)
        return report

    def _analyze_failures(self, failed):
        if not failed:
            return {"total_failures": 0}
        patterns = Counter()
        for f in failed:
            e = f["error"].lower()
            if "memory" in e:
                patterns["memory_issues"] += 1
            elif "timeout" in e:
                patterns["timeout"] += 1
            elif "shape" in e or "dimension" in e:
                patterns["tensor_shape"] += 1
            else:
                patterns["other"] += 1
        return {
            "total_failures": len(failed),
            "failure_rate": len(failed) / len(self.results) * 100 if self.results else 0,
            "failures_by_category": dict(Counter(f["category"] for f in failed)),
            "common_error_patterns": dict(patterns),
        }

    def _detailed_stats(self):
        if not self.results:
            return {}
        def stats_of(vals):
            return {"min": float(np.min(vals)), "max": float(np.max(vals)),
                    "std": float(np.std(vals)),
                    "percentile_95": float(np.percentile(vals, 95))}
        return {
            "generation_time_stats": stats_of([r["generation_time"] for r in self.results]),
            "solution_length_stats": stats_of([r["solution_length"] for r in self.results]),
            "complexity_score_stats": stats_of([r["complexity_score"] for r in self.results]),
        }

    def _summary_report(self, report) -> str:
        m = report["overall_metrics"]
        info = report["benchmark_info"]
        lines = [
            "",
            "Dream-Coder MathOlympiadBench Benchmark Summary",
            "=" * 60,
            "",
            f"Model: {info['model_path']}",
            f"Dataset: {info['dataset']}",
            f"Total Samples: {info['total_samples']}",
            "",
            "OVERALL PERFORMANCE",
            "=" * 30,
            f"Generation Success Rate: {m['generation_success_rate']:.1f}%",
            f"Lean Compilation Success Rate: {m['lean_compilation_rate']:.1f}%",
            f"Apparent Completeness Rate: {m['apparent_completeness_rate']:.1f}%",
            f"Average Generation Time: {m['average_generation_time']:.2f}s",
            f"Median Generation Time: {m['median_generation_time']:.2f}s",
            "",
            "SOLUTION QUALITY",
            "=" * 30,
            f"Average Solution Length: {m['average_solution_length']:.0f} characters",
            f"Average Lean Keywords Used: {m['average_lean_keywords']:.1f}",
            f"Average Lean Tactics Used: {m['average_lean_tactics']:.1f}",
            f"Theorem Declaration Rate: {m['theorem_declaration_rate']:.1f}%",
            f"Sorry Usage Rate: {m['sorry_usage_rate']:.1f}%",
            "=" * 60,
        ]
        return "\n".join(lines)
