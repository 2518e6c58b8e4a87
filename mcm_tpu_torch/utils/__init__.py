from mcm_tpu_torch.utils.logging import setup_log  # noqa: F401
from mcm_tpu_torch.utils.results import (load_scores, save_as_dataframe,  # noqa: F401
                                         save_scores)
from mcm_tpu_torch.utils.seed import setup_seed  # noqa: F401
from mcm_tpu_torch.utils.telemetry import Telemetry  # noqa: F401
