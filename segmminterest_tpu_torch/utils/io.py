"""Small shared I/O helpers for the task CLIs."""

from __future__ import annotations

import json
import logging

logger = logging.getLogger(__name__)


def dump_logits(logits: dict, json_path: str, pth: bool = False) -> str:
    """Write a logit dict as JSON and, optionally, as a torch-pickle twin.

    The reference exporters dump every dict twice — ``json.dump`` plus
    ``torch.save`` of the same object to ``*.pth``
    (save_logits_for_all_leave_SegMM.py:195-200). Every consumer in the
    tree reads the JSON, so the ``.pth`` twin is opt-in (``pth=True``,
    PARITY S11).
    """
    with open(json_path, "w") as f:
        json.dump(logits, f)
    if pth:
        import torch

        pth_path = json_path[:-len(".json")] + ".pth" \
            if json_path.endswith(".json") else json_path + ".pth"
        torch.save(logits, pth_path)
        logger.info("wrote torch twin %s", pth_path)
    return json_path
