"""Mixed precision for the port: policy, loss scalers, auto_cast (with the
O1 functional patch), Amp and initialize, the legacy OptimWrapper and the
per-site scale history."""

from apex_tpu_torch.amp.api import (  # noqa: F401
    Amp, AmpState, float_function, half_function, initialize,
    promote_function,
)
from apex_tpu_torch.amp.interceptor import auto_cast  # noqa: F401
from apex_tpu_torch.amp.lists import (  # noqa: F401
    register_float_module, register_float_op, register_half_module,
    register_half_op, register_promote_op, unregister_op,
)
from apex_tpu_torch.amp.opt import OptimWrapper  # noqa: F401
from apex_tpu_torch.amp.policy import (  # noqa: F401
    Policy, current_policy, policy_scope,
)
from apex_tpu_torch.amp.scale_history import (  # noqa: F401
    ScaleHistoryConfig, ScaleHistoryState, scale_history_init,
    scale_history_update, scale_update_events,
)
from apex_tpu_torch.amp.scaler import (  # noqa: F401
    LossScaleConfig, LossScaleState, loss_scale_init, loss_scale_update,
    scale_loss, select_if_finite, unscale_grads, unscale_grads_with_stashed,
    value_and_scaled_grad,
)
