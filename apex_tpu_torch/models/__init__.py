from apex_tpu_torch.models.transformer import (  # noqa: F401
    BertEncoder, BertLarge, Dense, Embed, FusedLayerNormModule,
    MultiheadAttention, TransformerLayer, mlm_loss,
)
from apex_tpu_torch.models.layers import (  # noqa: F401
    BatchNorm, Conv, ConvTranspose,
)
from apex_tpu_torch.models.resnet import (  # noqa: F401
    RESNET50_FLOPS_PER_IMAGE, BasicBlock, BottleneckBlock, ResNet, ResNet18,
    ResNet50, ResNet101,
)
from apex_tpu_torch.models.dcgan import Discriminator, Generator  # noqa: F401
from apex_tpu_torch.models import rnn  # noqa: F401
from apex_tpu_torch.models.rnn import (  # noqa: F401
    GRU, LSTM, ReLU, StackedRNN, Tanh, mLSTM,
)
