"""Solution-quality metrics for generated Lean proofs.

Counterpart of ``eval/quality.py``: the per-family metric sets key for key,
so the port's result JSONs compare directly with the reference's:

- ``style="llada"``      — the LLaDA benchmark's set,
- ``style="dream"``      — the richest: tactics, math symbols, a
                           completeness heuristic, a complexity score,
- ``style="diffucoder"`` — the simpler DiffuCoder set.
"""

from __future__ import annotations

import re
from typing import Dict

LEAN_KEYWORDS_BASIC = [
    "theorem", "lemma", "def", "by", "have", "show", "exact",
    "apply", "rw", "simp", "intro", "cases", "induction", "sorry",
]

LEAN_KEYWORDS_RICH = LEAN_KEYWORDS_BASIC + [
    "qed", "calc", "obtain", "use", "refine", "constructor", "left", "right",
    "exists", "forall", "fun", "let", "where", "match", "with",
]

LEAN_TACTICS = [
    "simp", "rw", "apply", "exact", "intro", "cases", "induction",
    "constructor", "left", "right", "split", "use", "existsi",
    "refine", "calc", "ring", "field_simp", "norm_num", "linarith",
]

MATH_SYMBOLS = ["∀", "∃", "→", "↔", "∧", "∨", "¬", "≤", "≥", "≠", "∈", "⊆", "∪", "∩"]


def _overlap_ratio(reference: str, solution_lower: str) -> tuple[float, int]:
    ref_words = set(re.findall(r"\w+", reference.lower()))
    sol_words = set(re.findall(r"\w+", solution_lower))
    if not ref_words:
        return 0.0, 0
    return len(ref_words & sol_words) / len(ref_words), len(ref_words - sol_words)


def evaluate_solution_quality(
    generated_solution: str,
    formal_statement: str = "",
    problem_statement: str = "",
    verifier=None,
    style: str = "dream",
) -> Dict:
    """Compute the per-family metric dict; ``verifier`` (eval/lean.py) runs
    the Lean compilation check when provided, else compilation fields are
    False/"Lean verifier unavailable"."""
    metrics: Dict = {}
    lower = generated_solution.lower()

    metrics["solution_length"] = len(generated_solution)
    metrics["solution_words"] = len(generated_solution.split())
    if style == "dream":
        metrics["solution_lines"] = len(generated_solution.split("\n"))

    keywords = LEAN_KEYWORDS_RICH if style == "dream" else LEAN_KEYWORDS_BASIC
    metrics["lean_keywords_used"] = sum(1 for kw in keywords if kw in lower)
    if style == "dream":
        metrics["lean_tactics_used"] = sum(1 for t in LEAN_TACTICS if t in lower)
        metrics["has_theorem_declaration"] = any(
            w in lower for w in ["theorem", "lemma"])
        metrics["has_proof_structure"] = any(
            w in lower for w in ["by", "proof", ":="])
        metrics["has_qed"] = any(w in lower for w in ["qed", "done"])
    else:
        metrics["has_proof_structure"] = any(
            w in lower for w in ["theorem", "lemma", "proof", "by"])
    metrics["has_sorry"] = "sorry" in lower

    if verifier is not None:
        ok, err = verifier.verify(generated_solution)
    else:
        ok, err = False, "Lean verifier unavailable"
    metrics["lean_compilation_success"] = ok
    metrics["lean_error_message"] = err

    if style == "dream":
        metrics["math_symbols_count"] = sum(lower.count(s.lower()) for s in MATH_SYMBOLS)
        metrics["has_imports"] = "import" in lower
        metrics["has_variables"] = "variable" in lower or "var" in lower

    metrics["has_balanced_brackets"] = (
        generated_solution.count("(") == generated_solution.count(")")
        and generated_solution.count("{") == generated_solution.count("}")
        and generated_solution.count("[") == generated_solution.count("]")
    )

    ratio, unique = _overlap_ratio(formal_statement or "", lower)
    metrics["formal_overlap_ratio"] = ratio if formal_statement else 0
    if style == "dream":
        metrics["formal_unique_words"] = unique if formal_statement else 0
        p_ratio, _ = _overlap_ratio(problem_statement or "", lower)
        metrics["problem_overlap_ratio"] = p_ratio if problem_statement else 0

        metrics["appears_complete"] = (
            metrics["has_theorem_declaration"]
            and metrics["has_proof_structure"]
            and not metrics["has_sorry"]
            and metrics["solution_length"] > 50
        )
        metrics["complexity_score"] = (
            metrics["lean_tactics_used"] * 2
            + metrics["math_symbols_count"]
            + metrics["solution_lines"] * 0.5
        )
    return metrics
