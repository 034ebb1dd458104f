from apex_tpu_torch.models.transformer import (  # noqa: F401
    BertEncoder, BertLarge, Dense, Embed, FusedLayerNormModule,
    MultiheadAttention, TransformerLayer, mlm_loss,
)
