"""The port's fused ops: each hand-written Hopper kernel sits beside a plain
PyTorch version of the same function. A wrapper takes the plain version
only for a tensor on the CPU; on a CUDA tensor it launches its kernel or
raises. Every kernel wrapper counts its launches in ``.launches``."""

from apex_tpu_torch.ops.attention import (  # noqa: F401
    attention_reference, flash_attention, flash_attention_lse,
    flash_bwd_kernel, flash_fwd_kernel, flash_generic_bwd_kernel,
    flash_generic_fwd_kernel, flash_wgmma_bwd_kernel, flash_wgmma_fwd_kernel,
    mask_softmax_dropout,
)
from apex_tpu_torch.ops.bn_act import (  # noqa: F401
    FusedBNAct, bn_act_reference, bn_act_train, bn_add_act_train,
    bn_dx_kernel, bn_sums_kernel, make_cfg,
)
from apex_tpu_torch.ops.group_bn import (  # noqa: F401
    BatchNorm2d_NHWC, bn_group_spec,
)
from apex_tpu_torch.ops.layer_norm import (  # noqa: F401
    FusedLayerNorm, fused_layer_norm, fused_layer_norm_affine,
    layer_norm_reference, ln_bwd_kernel, ln_fwd_kernel,
)
from apex_tpu_torch.ops.mlp import (  # noqa: F401
    MLP, fused_mlp, mlp_fused_reference, mlp_fwd_kernel, mlp_reference,
)
from apex_tpu_torch.ops.multi_tensor import (  # noqa: F401
    axpby_kernel, l2norm_kernel, maxnorm_kernel, multi_tensor_axpby,
    multi_tensor_l2norm, multi_tensor_maxnorm, multi_tensor_scale,
    scale_kernel,
)
from apex_tpu_torch.ops.multihead_attn import (  # noqa: F401
    EncdecMultiheadAttn, SelfMultiheadAttn,
)
from apex_tpu_torch.ops.optim_kernels import (  # noqa: F401
    adagrad_kernel, adagrad_update, adam_kernel, adam_update, lamb_stage1,
    lamb_stage1_kernel, lamb_stage2, lamb_stage2_kernel, novograd_kernel,
    novograd_update, sgd_kernel, sgd_update,
)
from apex_tpu_torch.ops.xentropy import (  # noqa: F401
    softmax_cross_entropy_loss, softmax_cross_entropy_reference,
    xentropy_bwd_kernel, xentropy_fwd_kernel,
)

#: every kernel wrapper of the port, by name
KERNELS = {
    "layer_norm_fwd": ln_fwd_kernel,
    "layer_norm_bwd": ln_bwd_kernel,
    "xentropy_fwd": xentropy_fwd_kernel,
    "xentropy_bwd": xentropy_bwd_kernel,
    "flash_attn_fwd": flash_wgmma_fwd_kernel,
    "flash_attn_bwd": flash_wgmma_bwd_kernel,
    "multi_tensor_l2norm": l2norm_kernel,
    "lamb_stage1": lamb_stage1_kernel,
    "lamb_stage2": lamb_stage2_kernel,
    "bn_sums": bn_sums_kernel,
    "bn_dx": bn_dx_kernel,
    "sgd": sgd_kernel,
    "adam": adam_kernel,
    "multi_tensor_maxnorm": maxnorm_kernel,
    "multi_tensor_scale": scale_kernel,
    "multi_tensor_axpby": axpby_kernel,
    "adagrad": adagrad_kernel,
    "novograd": novograd_kernel,
    "mlp_fwd": mlp_fwd_kernel,
    "flash_generic_fwd": flash_generic_fwd_kernel,
    "flash_generic_bwd": flash_generic_bwd_kernel,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
