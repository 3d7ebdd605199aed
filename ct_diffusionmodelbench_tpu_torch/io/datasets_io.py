"""Dataset loading, instruction formatting, and split construction.

Counterpart of ``io/datasets_io.py``, function for function:

- MiniF2F problems from the local JSON (fields ``name, split,
  informal_statement, formal_statement, header``),
- ``Goedel-LM/MathOlympiadBench`` split selection test → train → first,
- ``AI-MO/NuminaMath-LEAN`` instruction formatting, two variants:
  A) formal_statement → formal_ground_truth with the model chat template,
  B) problem(+formal_statement) → formal_proof | answer,
- the seeded 80/10/10 split built with ``datasets.train_test_split(seed=42)``
  twice, so indices equal the reference's.

``datasets`` is imported inside :func:`load_hub_or_local` only, so every
other function (and every module that imports this one) works on a machine
without it.  Every loader accepts a local path (json/jsonl or a saved
``datasets`` dir), so nothing needs the network.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from ct_diffusionmodelbench_tpu_torch.utils.logging import log

NUMINA_DATASET = "AI-MO/NuminaMath-LEAN"
MATH_OLYMPIAD_DATASET = "Goedel-LM/MathOlympiadBench"


# ---------------------------------------------------------------------------
# MiniF2F
# ---------------------------------------------------------------------------

def load_minif2f(json_path: str | Path, split: str = "test",
                 num_samples: Optional[int] = None) -> List[Dict]:
    """Filter the MiniF2F JSON by split, optionally truncate."""
    with open(json_path) as f:
        data = json.load(f)
    problems = [p for p in data if p.get("split") == split]
    if num_samples:
        problems = problems[:num_samples]
    log(f"Loaded {len(problems)} problems from {split} split")
    return problems


# ---------------------------------------------------------------------------
# Generic hub-or-local loading
# ---------------------------------------------------------------------------

def load_hub_or_local(name_or_path: str, split: Optional[str] = "train"):
    """Load a ``datasets`` dataset from the hub, a save_to_disk dir, or a
    json/jsonl file."""
    import datasets  # lazy: heavy import

    p = Path(name_or_path)
    if p.exists():
        if p.is_dir():
            ds = datasets.load_from_disk(str(p))
            # DatasetDict → pick the requested split (or the only one).
            if isinstance(ds, datasets.DatasetDict):
                if split and split in ds:
                    return ds[split]
                return ds[next(iter(ds))]
            return ds
        ds = datasets.load_dataset("json", data_files=str(p), split="train")
        return ds
    ds = datasets.load_dataset(name_or_path)
    if split and split in ds:
        return ds[split]
    return ds


def pick_bench_split(ds):
    """test → train → first available (llada.py:155-167)."""
    if hasattr(ds, "keys"):
        for name in ("test", "train"):
            if name in ds:
                return ds[name], name
        name = list(ds.keys())[0]
        return ds[name], name
    return ds, "train"


# ---------------------------------------------------------------------------
# NuminaMath-LEAN instruction formatting
# ---------------------------------------------------------------------------

def format_instruction_lean_sft(example: Dict, tokenizer) -> Dict:
    """Variant A (train.py:63-88): formal_statement → formal_ground_truth."""
    formal_statement = example.get("formal_statement", "") or ""
    formal_ground_truth = example.get("formal_ground_truth", "") or ""
    if not formal_statement or not formal_ground_truth:
        return {"text": "", "prompt": ""}
    messages = [
        {"role": "system",
         "content": "You are a helpful AI assistant specialized in Lean theorem proving."},
        {"role": "user", "content": formal_statement},
    ]
    prompt = tokenizer.apply_chat_template(messages, add_generation_prompt=True)
    full_text = prompt + formal_ground_truth + tokenizer.eos_token
    return {"text": full_text, "prompt": prompt}


def format_instruction_problem(example: Dict, tokenizer,
                               extra_system: str = "") -> Dict:
    """Variant B (train_fast_save.py:40-65 / run_inference_numina.py:18-43):
    problem(+formal_statement) → formal_proof | answer."""
    problem = example.get("problem", "") or ""
    formal_statement = example.get("formal_statement", "") or ""
    response = example.get("formal_proof", "") or example.get("answer", "") or ""
    if formal_statement:
        instruction = f"Problem: {problem}\n\nFormal Statement: {formal_statement}"
    else:
        instruction = f"Problem: {problem}"
    if not response:
        return {"text": "", "prompt": "", "reference": ""}
    sys_content = "You are a helpful AI assistant specialized in mathematical reasoning."
    if extra_system:
        sys_content = f"{sys_content} {extra_system}".strip()
    messages = [
        {"role": "system", "content": sys_content},
        {"role": "user", "content": instruction},
    ]
    prompt = tokenizer.apply_chat_template(messages, add_generation_prompt=True)
    return {"text": prompt + response + tokenizer.eos_token,
            "prompt": prompt, "reference": response}


# ---------------------------------------------------------------------------
# Seeded splits
# ---------------------------------------------------------------------------

def split_80_10_10(formatted_ds, seed: int = 42,
                   test_ratio: float = 0.10, val_ratio: float = 0.10):
    """The reference's two-stage seeded split (train.py:152-168): first carve
    out (test+val), then split that into val/test — returns
    (train, val, test) ``datasets.Dataset`` objects with indices identical to
    the reference runs."""
    tv_ratio = test_ratio + val_ratio
    split1 = formatted_ds.train_test_split(test_size=tv_ratio, seed=seed)
    remain, tv = split1["train"], split1["test"]
    split2 = tv.train_test_split(test_size=val_ratio / tv_ratio, seed=seed)
    val_ds, test_ds = split2["train"], split2["test"]
    return remain, val_ds, test_ds


def split_fresh_for_inference(formatted_ds, seed: int = 42,
                              test_ratio: float = 0.10, val_ratio: float = 0.10):
    """run_inference_numina.py:163-181: the fresh 80/10/10 split used by the
    inference driver (note its different carve order: test first, then val
    out of the remainder)."""
    tmp = formatted_ds.train_test_split(test_size=test_ratio, seed=seed)
    test_ds, remain = tmp["test"], tmp["train"]
    remain_val_ratio = val_ratio / (1.0 - test_ratio)
    sp = remain.train_test_split(test_size=remain_val_ratio, seed=seed)
    return sp["train"], sp["test"], test_ds  # train, val, test


def split_val_from_training(formatted_ds, max_samples: int = 100, seed: int = 42):
    """run_inference_numina.py:156-162 'val_from_training': first N samples,
    85/15 split, return the 15%."""
    ds = formatted_ds.select(range(min(max_samples, len(formatted_ds))))
    sp = ds.train_test_split(test_size=0.15, seed=seed)
    return sp["test"]
