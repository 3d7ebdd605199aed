"""Standalone Lean syntax validator CLI.

Counterpart of ``cli/lean_check.py``, with the same usage, messages and
exit codes:

    python -m ct_diffusionmodelbench_tpu_torch.cli.lean_check results.json
    python -m ct_diffusionmodelbench_tpu_torch.cli.lean_check --check_lean_syntax 'code'

The first counts the valid snippets; the second exits 0 iff the snippet is
valid.
"""

from __future__ import annotations

import json
import sys

from ct_diffusionmodelbench_tpu_torch.eval.lean import is_valid_lean


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: ctdb-lean-check path/to/json OR "
              "ctdb-lean-check --check_lean_syntax 'code'")
        sys.exit(1)

    if argv[0] == "--check_lean_syntax":
        if len(argv) < 2:
            print("Error: No code snippet provided")
            sys.exit(1)
        if is_valid_lean(argv[1]):
            print("Valid Lean syntax")
            sys.exit(0)
        print("Invalid Lean syntax")
        sys.exit(1)

    with open(argv[0], encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError("Expected top-level array")
    valid_count = sum(
        1 for item in data if is_valid_lean(str(item.get("generated_solution", ""))))
    print(f"Total items: {len(data)}")
    print(f"Items with syntactically valid Lean4: {valid_count}")


if __name__ == "__main__":
    main()
