from mcm_tpu_torch.data.folder import ImageFolder, SubsetView, subset_per_class  # noqa: F401
from mcm_tpu_torch.data.datasets import (Cub2011, Flowers102, Food101,  # noqa: F401
                                         OxfordIIITPet, StanfordCars)
from mcm_tpu_torch.data.labels import get_num_cls, get_test_labels  # noqa: F401
from mcm_tpu_torch.data.loaders import (default_out_datasets, set_ood_loader,  # noqa: F401
                                        set_train_loader, set_val_loader,
                                        validate_out_datasets)
from mcm_tpu_torch.data.pipeline import Batch, DataPipeline, collect_scores  # noqa: F401
from mcm_tpu_torch.data.transforms import (CLIP_MEAN, CLIP_STD,  # noqa: F401
                                           load_image_uint8, normalize_on_device)
