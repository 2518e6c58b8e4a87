from mcm_tpu_torch.scores.clip_scores import (CLIP_SCORES,  # noqa: F401
                                              compute_scores,
                                              compute_scores_host,
                                              l2_normalize,
                                              similarity_logits)
