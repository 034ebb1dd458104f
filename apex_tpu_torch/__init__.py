"""apex_tpu_torch — the port of apex_tpu to PyTorch and CUDA on Hopper.

A second package beside the JAX one, held against it by the parity tests.
It imports ``torch`` and never ``jax`` nor anything of ``apex_tpu``.

- ``apex_tpu_torch.amp``    — precision policy (O0–O3), functional dynamic
                              loss scaler, ``auto_cast`` and ``Amp``.
- ``apex_tpu_torch.arena``  — the flat per-dtype parameter arena.
- ``apex_tpu_torch.ops``    — hand-written Hopper kernels (Triton LayerNorm,
                              softmax cross-entropy, arena L2 norm and
                              LAMB stages; CUDA C++ flash attention)
                              beside their plain versions.
- ``apex_tpu_torch.optim``  — ``FusedLAMB`` (arena and tree updates).
- ``apex_tpu_torch.models`` — the BERT encoder and its MLM loss.
- ``apex_tpu_torch.train``  — the BERT MLM training step.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every op runs its plain version.
"""

__version__ = "0.1.0"
