"""nn.Modules with the reference checkpoints' state-dict names:
DisentangledVAE (serving surface) and the WaveNet vocoder."""

from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE  # noqa: F401
from dvc_tpu_torch.models.wavenet import WaveNet  # noqa: F401
