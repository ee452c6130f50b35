"""vision_transformers_tpu_torch — the PyTorch/CUDA port of vision_transformers_tpu.

Written for an NVIDIA H100 (``sm_90a``); the JAX package beside it is the
reference it is tested against.  It holds the serving path
(``python -m vision_transformers_tpu_torch.predict``) and the f32 training
path (``python -m vision_transformers_tpu_torch.train``) of ViT and Swin,
with hand-written CUDA kernels for the forward and backward of the
attention layer and of the whole transformer layer (ops/).  Imports torch,
never jax.

Importing this package populates the config registry, so ``.conf`` files
resolve their ``arch``, ``optimizer``, ``scheduler`` and ``checker`` tags.
"""

from . import config  # noqa: F401
from .config.schema import ImageNetConfig, load_config  # noqa: F401
from . import models  # noqa: F401
from . import train  # noqa: F401

__version__ = "0.1.0"
