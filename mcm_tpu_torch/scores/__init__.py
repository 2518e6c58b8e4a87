from mcm_tpu_torch.scores.clip_scores import (CLIP_SCORES,  # noqa: F401
                                              compute_all_scores,
                                              compute_scores,
                                              compute_scores_host,
                                              l2_normalize,
                                              similarity_logits,
                                              zero_shot_predictions)
from mcm_tpu_torch.scores.mahalanobis import (estimate_mean_precision,  # noqa: F401
                                              mahalanobis_score)
