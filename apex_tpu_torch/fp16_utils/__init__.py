"""apex_tpu_torch.fp16_utils — the pre-amp explicit master-weights API.

The port of ``apex_tpu.fp16_utils``: ``FP16_Optimizer`` (f32 masters, loss
scaling, overflow skipping and gradient clipping as explicit calls), the
``network_to_half`` / ``prep_param_lists`` /
``master_params_to_model_params`` / ``clip_grad_norm`` helpers over
``{name: tensor}`` dicts, and the legacy loss scalers (dynamic init 2**32,
window 1000).
"""

from apex_tpu_torch.fp16_utils.fp16_optimizer import (  # noqa: F401
    FP16_Optimizer, FP16OptState,
)
from apex_tpu_torch.fp16_utils.fp16util import (  # noqa: F401
    FP16Model, MasterParams, clip_grad_norm, convert_network,
    master_params_to_model_params, model_grads_to_master_grads,
    network_to_half, prep_param_lists, to_python_float, tofp16,
)
from apex_tpu_torch.fp16_utils.loss_scaler import (  # noqa: F401
    DynamicLossScaler, LossScaler,
)
