"""apex_tpu_torch.ckpt — async, crash-safe, elastic checkpointing.

The port of ``apex_tpu.ckpt``; the on-disk format is the JAX package's,
so a checkpoint written by either loads in the other (bf16 and fp8 leaves
included, see :mod:`~apex_tpu_torch.ckpt.format`;
``convert.amp_state_from_jax_checkpoint`` maps a JAX-written training
state onto the port's names and layouts). Four pieces:

- **snapshot** (:mod:`~apex_tpu_torch.ckpt.snapshot`): a grouped device
  copy of the training state (params, optimizer state and ZeRO shards,
  scalers, ``torch.Generator`` states) on the step path, then an
  event-ordered device→host copy on a side stream, off it;
- **format** (:mod:`~apex_tpu_torch.ckpt.format`): one ``npz`` per
  process + a content-hashed manifest, every file temp-then-rename and
  the manifest committed LAST;
- **elastic** (:mod:`~apex_tpu_torch.ckpt.elastic`): restore
  re-partitions ZeRO slot buffers to the target world size, bitwise;
- **escalate** (:mod:`~apex_tpu_torch.ckpt.escalate`): a stall or a
  preemption becomes checkpoint-save → crash-dump → exit 75.

::

    mgr = ckpt.CheckpointManager("ckpts", keep=2)
    mgr.save(step, {"amp": state, "gen": generator})
    tree, manifest = mgr.restore({"amp": fresh_state, "gen": fresh_gen})
"""

from apex_tpu_torch.ckpt.elastic import repartition_flat, zero_layout
from apex_tpu_torch.ckpt.escalate import (ESCALATION_EXIT_CODE,
                                          EscalationPolicy,
                                          PreemptionError)
from apex_tpu_torch.ckpt.format import (CheckpointError, checkpoint_in_use,
                                        checkpoint_is_in_use,
                                        committed_steps, gc_checkpoints,
                                        latest_checkpoint, read_manifest,
                                        step_dir)
from apex_tpu_torch.ckpt.manager import CheckpointManager
from apex_tpu_torch.ckpt.snapshot import (HostSnapshot, ShardChunks,
                                          Snapshotter, device_snapshot,
                                          tree_paths)

__all__ = [
    "CheckpointManager", "Snapshotter", "HostSnapshot", "ShardChunks",
    "device_snapshot", "tree_paths",
    "CheckpointError", "latest_checkpoint", "committed_steps",
    "gc_checkpoints", "read_manifest", "step_dir",
    "checkpoint_in_use", "checkpoint_is_in_use",
    "repartition_flat", "zero_layout",
    "EscalationPolicy", "PreemptionError", "ESCALATION_EXIT_CODE",
]
