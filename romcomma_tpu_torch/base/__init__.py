from romcomma_tpu_torch.base import definitions
from romcomma_tpu_torch.base.classes import Frame, Data, Model

__all__ = ['definitions', 'Frame', 'Data', 'Model']
