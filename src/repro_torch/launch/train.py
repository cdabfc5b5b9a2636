"""Step builders of the LM side.

The port's counterpart of ``repro.launch.train``.  ``make_serve_step`` is
the decode step that ``serve_loop`` drives; training (``make_train_step``,
AdamW, the attention kernel's backward, the driver) is ROADMAP §1 item 12b.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import unported
from repro_torch.models.model_zoo import ModelAPI

__all__ = ["make_train_step", "make_serve_step"]


def make_train_step(model: ModelAPI, opt_cfg=None):
    raise unported("make_train_step (LM training)", "12b")


def make_serve_step(model: ModelAPI):
    def serve_step(params, cache, batch):
        logits, new_cache = model.decode(params, cache, batch)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok, new_cache

    return serve_step
