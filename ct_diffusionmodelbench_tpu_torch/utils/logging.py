"""Timestamped logging helper.

Counterpart of ``utils/logging.py``: the same ``[YYYY-MM-DD HH:MM:SS] msg``
line format, so log scrapers read both packages' logs.
"""

from __future__ import annotations

import sys
from datetime import datetime


def log_timing(msg: str) -> None:
    print(f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] {msg}")
    sys.stdout.flush()
