"""Mixed precision for the port: policy, loss scaler, auto_cast and Amp."""

from apex_tpu_torch.amp.api import Amp, AmpState  # noqa: F401
from apex_tpu_torch.amp.interceptor import auto_cast  # noqa: F401
from apex_tpu_torch.amp.policy import (  # noqa: F401
    Policy, current_policy, policy_scope,
)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaleConfig, LossScaleState, loss_scale_init, loss_scale_update,
    scale_loss, unscale_grads,
)
