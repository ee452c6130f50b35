"""Training: losses, schedules, optimizer, the train/eval steps, the checker
and the trainer (counterpart of ``vision_transformers_tpu/train/``), and
the command line ``python -m vision_transformers_tpu_torch.train`` (its
``main`` is :func:`.cli.main`).  Importing it registers the ``optimizer``,
``scheduler``, ``checker``, ``storage`` and ``reporter`` config types."""

from . import checker, optim, schedule  # noqa: F401
from .cli import main  # noqa: F401
