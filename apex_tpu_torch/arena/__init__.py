"""apex_tpu_torch.arena — the flat parameter arena of the fused optimizers.

Tensors are laid out flat per dtype so one kernel covers a whole model
(see :mod:`apex_tpu_torch.arena.arena`); the layout is planned in numpy
(:mod:`apex_tpu_torch.arena.native`).
"""

from apex_tpu_torch.arena.arena import (  # noqa: F401
    ArenaSpec, BUFFER_MULTIPLE, DEFAULT_ALIGNMENT, flatten, plan,
    segment_ids, unflatten, valid_mask, zeros,
)
