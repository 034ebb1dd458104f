"""apex_tpu_torch — the port of apex_tpu to PyTorch and CUDA on Hopper.

A second package beside the JAX one, held against it by the parity tests.
It imports ``torch`` and never ``jax`` nor anything of ``apex_tpu``.

- ``apex_tpu_torch.amp``    — precision policy (O0–O3), functional dynamic
                              loss scaler, ``auto_cast`` and ``Amp``.
- ``apex_tpu_torch.arena``  — the flat per-dtype parameter arena.
- ``apex_tpu_torch.ops``    — hand-written Hopper kernels (Triton LayerNorm,
                              softmax cross-entropy, BN backward sums and
                              dx, the arena's norms, scale/axpby and
                              optimizer updates; CUDA C++ flash attention
                              and the fused MLP) beside their plain
                              versions.
- ``apex_tpu_torch.sparsity`` — 2:4 structured sparsity: masks and ASP.
- ``apex_tpu_torch.optim``  — ``FusedAdam``, ``FusedLAMB``, ``FusedSGD``
                              (arena and tree updates).
- ``apex_tpu_torch.parallel`` — data parallelism over ``torch.distributed``:
                              meshes, DDP and the gradient sync (bucketed,
                              compressed), SyncBatchNorm, LARC.
- ``apex_tpu_torch.models`` — the BERT encoder and its MLM loss, ResNet,
                              DCGAN, and the flax-style layers they share.
- ``apex_tpu_torch.train``  — the BERT MLM, ResNet, MLP and DCGAN
                              training steps.
- ``apex_tpu_torch.ckpt``   — async, crash-safe, elastic checkpoints in
                              the JAX package's on-disk format, and the
                              exit-75 escalation.
- ``apex_tpu_torch.guard``  — in-step anomaly detection (``Amp.step(
                              guard=)``), integrity fingerprints, the
                              skip/repair/rewind/escalate policy, chaos.
- ``apex_tpu_torch.data``   — the ImageFolder loader, the packed uint8
                              cache and the pinned side-stream
                              prefetcher, decoding with the port's own
                              JPEG codec and PIL-exact resampler (C++
                              host stages built at first use).
- ``apex_tpu_torch.cluster`` — generation-fenced membership and
                              coordinated recovery over a shared
                              directory (``ckpt``'s ``fence=``), and
                              ``parallel.elastic_run``'s relaunch.
- ``apex_tpu_torch.trace``  — spans and the per-step timeline, the
                              flight recorder, the hang watchdog, NaN
                              provenance, the straggler tier and the pod
                              view (``parallel.enable_crash_dumps``).
- ``apex_tpu_torch.monitor`` — the ``Metrics`` tuple on the amp state,
                              ``MetricsLogger`` with its sinks and event
                              channels, and the goodput ledger.
- ``apex_tpu_torch.convert`` — weights, statistics, optimizer and ASP
                              state carried over from the JAX package, in
                              memory or from its checkpoints.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every op runs its plain version.
"""

__version__ = "0.1.0"
