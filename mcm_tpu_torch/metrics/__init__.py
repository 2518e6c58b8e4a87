from mcm_tpu_torch.metrics.ood_metrics import (fpr_at_recall,  # noqa: F401
                                               get_and_print_results,
                                               get_measures, print_measures)
