from apex_tpu_torch.optim.fused import FusedLAMB, FusedOptState  # noqa: F401
