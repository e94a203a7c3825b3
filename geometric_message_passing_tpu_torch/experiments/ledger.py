"""Append-only experiment results ledger (port of the JAX package's
``experiments/ledger.py``): a JSON list of records, each the CLI's
arguments plus ``best_val_acc`` / ``test_acc`` / ``train_time`` lists and
``mean`` / ``std``, written with ``indent=4``."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


def append_result(path: str, record: Dict[str, Any]) -> None:
    """Append ``record`` to the JSON list in ``path`` (created if absent)."""
    results = []
    if os.path.isfile(path):
        with open(path, "r") as f:
            results = json.load(f)
    results.append(record)
    with open(path, "w") as f:
        json.dump(results, f, indent=4)
