"""Cross-model results analyzer.

Counterpart of ``eval/analyzer.py``: reads each model's
``results_batch_*.json``, re-validates Lean syntax with the syntax oracle,
and writes the comparison table as csv / markdown / json (xlsx too when
openpyxl is importable; the table itself is built without pandas).  Column
names match ``model_performance.{md,csv,json}``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ct_diffusionmodelbench_tpu_torch.eval.lean import is_valid_lean

DEFAULT_SPECS = {
    "diffucoder": {"size": "7B", "denoising_steps": 256},
    "dream": {"size": "7B", "denoising_steps": 256},
    "llada": {"size": "7B", "denoising_steps": 128},
}

COLUMNS = [
    "model", "size", "denoising_steps", "total_solutions",
    "successful_generations", "compilation_success_rate",
    "valid_lean_syntax_rate", "proof_structure_usage", "avg_generation_time",
    "avg_lean_keywords_used", "theorems_used",
]


def strip_markdown_fence(code: str) -> str:
    clean = code.strip()
    for fence in ("```lean", "```"):
        if clean.startswith(fence):
            lines = clean.split("\n")
            if len(lines) > 1:
                clean = "\n".join(lines[1:])
                if clean.endswith("```"):
                    clean = clean[:-3].strip()
            break
    return clean


class ModelAnalyzer:
    def __init__(self, results_paths: Dict[str, str],
                 model_specs: Optional[Dict[str, Dict]] = None,
                 syntax_checker: Optional[Callable[[str], bool]] = None,
                 output_dir: str = "processing"):
        self.results_paths = results_paths
        self.model_specs = model_specs or DEFAULT_SPECS
        self.syntax_checker = syntax_checker or self._default_checker
        self.output_dir = output_dir

    @staticmethod
    def _default_checker(code: str) -> bool:
        if not code.strip() or len(code) > 10000:
            return False
        return is_valid_lean(strip_markdown_fence(code))

    def analyze_model(self, model_name: str) -> Dict:
        print(f"Analyzing {model_name}...")
        with open(self.results_paths[model_name]) as f:
            results = json.load(f)

        total = len(results)
        spec = self.model_specs.get(model_name, {"size": "?", "denoising_steps": 0})
        successful = sum(1 for r in results if r.get("generated_solution"))
        compiled = sum(1 for r in results if r.get("lean_compilation_success"))
        valid_syntax = sum(1 for r in results
                           if self.syntax_checker(r.get("generated_solution", "")))
        proof_structure = sum(1 for r in results if r.get("has_proof_structure"))
        avg_time = (sum(r.get("generation_time", 0) for r in results) / total
                    if total else 0)
        keywords = sum(r.get("lean_keywords_used", 0) for r in results)
        theorems = sum(1 for r in results if r.get("has_theorem_declaration"))

        pct = lambda n: (n / total) * 100 if total else 0
        return {
            "model": model_name,
            "size": spec["size"],
            "denoising_steps": spec["denoising_steps"],
            "total_solutions": total,
            "successful_generations": successful,
            "compilation_success_rate": pct(compiled),
            "valid_lean_syntax_rate": pct(valid_syntax),
            "proof_structure_usage": pct(proof_structure),
            "avg_generation_time": avg_time,
            "avg_lean_keywords_used": keywords / total if total else 0,
            "theorems_used": theorems,
        }

    # -- table rendering (no pandas dependency) -----------------------------

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, float):
            return f"{v:g}"
        return str(v)

    def to_markdown(self, rows: List[Dict]) -> str:
        header = "| " + " | ".join(COLUMNS) + " |"
        sep = "|" + "|".join("---" for _ in COLUMNS) + "|"
        body = ["| " + " | ".join(self._fmt(r[c]) for c in COLUMNS) + " |"
                for r in rows]
        return "\n".join([header, sep] + body)

    def to_csv(self, rows: List[Dict]) -> str:
        lines = [",".join(COLUMNS)]
        for r in rows:
            lines.append(",".join(self._fmt(r[c]) for c in COLUMNS))
        return "\n".join(lines) + "\n"

    def run_analysis(self) -> List[Dict]:
        rows = [self.analyze_model(name) for name in self.results_paths]

        print("\n--- Performance Summary ---")
        print(self.to_markdown(rows))

        out = Path(self.output_dir)
        out.mkdir(parents=True, exist_ok=True)
        (out / "model_performance.csv").write_text(self.to_csv(rows))
        (out / "model_performance.md").write_text(self.to_markdown(rows))
        with open(out / "model_performance.json", "w") as f:
            json.dump(rows, f, indent=4)
        try:  # xlsx only when openpyxl is around (reference uses pandas.to_excel)
            import openpyxl

            wb = openpyxl.Workbook()
            ws = wb.active
            ws.append(COLUMNS)
            for r in rows:
                ws.append([r[c] for c in COLUMNS])
            wb.save(out / "model_performance.xlsx")
        except ImportError:
            pass

        print(f"\nResults saved to {out}")
        return rows
