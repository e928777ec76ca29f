"""Host utilities (the JAX package's ``cvr_tpu.utils`` names)."""

from cvr_tpu_torch.utils.timing import Timer, PhaseTimer
from cvr_tpu_torch.utils.report import append_result, append_jsonl

__all__ = ["Timer", "PhaseTimer", "append_result", "append_jsonl"]
