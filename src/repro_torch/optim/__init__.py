"""Optimizer pieces, as ``repro.optim``: AdamW with the BNN latent clip,
global-norm clipping and the learning-rate schedule, as functions over
the params' tree."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.clip import clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
