"""Inductive zero-shot CLIP baseline (counterpart of
transductive_clip_tpu/methods/zero_shot/inductive_clip.py): no
transduction, u = the softmax features (or the text similarities),
prediction = argmax (reference: src/methods/zero_shot/inductive_clip.py:85-129).
"""

from __future__ import annotations

import torch

from ..base import TransductiveMethod, init_soft_assignments


class CLIP(TransductiveMethod):
    acc_mode = "direct"

    def _infer(self, task):
        self._log(" ==> Executing inductive CLIP")
        u = init_soft_assignments(task["x_q"], self.args,
                                  task.get("text_features"))
        return u, torch.zeros((1,), dtype=torch.float32, device=u.device)
