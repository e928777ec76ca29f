"""Host utilities (the JAX package's ``cvr_tpu.utils`` names that are
ported; ``Timer``, ``append_result`` and ``append_jsonl`` are not yet)."""

from cvr_tpu_torch.utils.timing import PhaseTimer

__all__ = ["PhaseTimer"]
