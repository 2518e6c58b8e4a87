"""Training: contrastive CLIP fine-tuning, the linear probe, train-state
checkpoints and the epoch loop (the JAX package's ``train``)."""

from mcm_tpu_torch.train.checkpoint import (load_train_state,  # noqa: F401
                                            save_train_state)
from mcm_tpu_torch.train.contrastive import (clip_contrastive_loss,  # noqa: F401
                                             make_train_step)
from mcm_tpu_torch.train.linear_probe import (LinearProbe,  # noqa: F401
                                              make_linear_probe_step)
from mcm_tpu_torch.train.loop import ShuffledView, train_clip  # noqa: F401
